"""Post-processing scores, top-K compaction and its inverse layout
(counterpart of object_detection_torch2_tpu/ops/scores.py:15-54).

Softmax over all C classes (INCLUDING void), then zero every class except the
argmax — at most one nonzero score per anchor (reference: src/utils.py:43-55).
"""

from __future__ import annotations

import torch


def calc_scores(outputs: torch.Tensor) -> torch.Tensor:
    """outputs: (N, P, 4+C) (only [..., 4:] is read) -> (N, P, C) one-class-kept scores.

    The softmax is written out as jax.nn.softmax computes it (exp(x - max),
    divided by its sum). argmax takes the first index among ties, as JAX does."""
    logits = outputs[..., 4:]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    mask = torch.nn.functional.one_hot(logits.argmax(dim=-1), logits.shape[-1]).to(probs.dtype)
    return probs * mask


def top_k_detections(post: torch.Tensor, k: int, batch_mask: torch.Tensor | None = None):
    """Device-side detection compaction: (N, P, 4+C) post-NMS -> top-K rows.

    Rows are ranked by their one-class-kept score; void-argmax and
    NMS-suppressed rows rank as 0 and are inert. `batch_mask` (N,) zeroes pad
    rows of a ragged final batch. Ties keep the lowest index first, as
    `jax.lax.top_k` does (a stable descending sort, then a slice; `torch.topk`
    promises no tie order), so empty slots pick the same rows as the JAX package.

    Returns (boxes (N, K, 4), class_ids (N, K) incl. void=0 for empty slots,
    scores (N, K)) — score-descending.
    """
    confs = post[..., 4:]
    class_ids = confs.argmax(dim=-1)  # first index among ties
    scores = confs.amax(dim=-1)
    valid = scores * (class_ids != 0)
    if batch_mask is not None:
        valid = valid * batch_mask[:, None]
    top_scores, idx = torch.sort(valid, dim=-1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    boxes = torch.gather(post[..., :4], 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(class_ids, 1, idx) * (top_scores > 0)
    return boxes, classes, top_scores


def expand_detections(boxes: torch.Tensor, class_ids: torch.Tensor, scores: torch.Tensor, num_classes: int):
    """Inverse layout of top_k_detections: (boxes (N, K, 4), class_ids (N, K),
    scores (N, K)) -> (N, K, 4 + num_classes) rows, the boxes and then a
    one-hot of the class times the score, feeding code that consumes the
    reference's post-NMS layout (metrics.assign.detection_matches) at K rows."""
    onehot = torch.nn.functional.one_hot(class_ids.long(), num_classes).to(scores.dtype)
    return torch.cat([boxes, onehot * scores[..., None]], dim=-1)

"""Batched per-class first-claim TP assignment
(counterpart of object_detection_torch2_tpu/metrics/assign.py:26-67).

The reference loops per image and per class in Python, keeps the detections
with score > 0 in score order, lets each claim its best-IoU ground truth if
the IoU is above 0.5, and counts only the FIRST (highest-scored) claimant of a
ground truth (reference: src/evaluate.py:31-42, 134-151). Here that is a few
tensor operations over the whole batch and all classes at once, on the
device the inputs are on: a masked argmax replaces the compaction (the order
of the ground-truth columns cannot change an argmax or a first claim), and
the first-claim rule becomes an argmax over the score-sorted rank axis.

Ties are decided as the JAX package decides them: the score sort is stable
(equal scores keep their index order), and an argmax takes the first maximum
(equal IoUs go to the lowest ground-truth index, the first claimant to the
lowest rank).
"""

from __future__ import annotations

import torch

from object_detection_torch2_tpu_torch.core.boxes import pairwise_iou


def detection_matches(outputs: torch.Tensor, gts: torch.Tensor, num_classes: int = 20) -> dict:
    """outputs: (N, P, 4 + 21) post-NMS rows (decoded boxes + one-class-kept
    scores), gts: (N, G, 4 + 21) zero-padded ground truth.

    Returns, per class c (axis 1):
      correct: (N, C, P) bool  — TP flag per detection, score-descending
      scores:  (N, C, P)       — the class's score column, score-descending
      counts:  (N, C) int32    — number of class-c ground truths per image
                                 (int32, as the JAX package returns it)
    """
    iou = pairwise_iou(outputs[..., :4], gts[..., :4])  # (N, P, G) (reference: evaluate.py:132)
    n, p, g = iou.shape
    scores = outputs[..., 5:5 + num_classes].transpose(1, 2)  # (N, C, P)
    gt_present = gts[..., 5:5 + num_classes].transpose(1, 2) > 0.0  # (N, C, G)

    # score-descending rank order; argsort of the negation, stable, as jnp.argsort(-s)
    order = torch.sort(-scores, dim=-1, stable=True).indices
    scores_sorted = torch.gather(scores, 2, order)
    pred_present = scores_sorted > 0.0
    iou_sorted = torch.gather(iou[:, None].expand(n, num_classes, p, g), 2,
                              order[..., None].expand(-1, -1, -1, g))  # (N, C, P, G)

    # best class ground truth per prediction (masked argmax == argmax over compacted columns)
    masked_iou = torch.where(gt_present[:, :, None, :], iou_sorted, torch.full_like(iou_sorted, -1.0))
    best = masked_iou.argmax(dim=-1)  # (N, C, P), first maximum
    best_iou = torch.gather(masked_iou, 3, best[..., None])[..., 0]
    claim_valid = pred_present & (best_iou > 0.5)

    claims = torch.nn.functional.one_hot(best, g).bool() & claim_valid[..., None]  # (N, C, P, G)
    # first-rank claimant of each ground truth (0 if none): argmax has no bool
    # kernel, and on 0/1 bytes it takes the first 1 as jnp.argmax does on bools
    first = claims.to(torch.uint8).argmax(dim=2)  # (N, C, G)
    any_claim = claims.any(dim=2)
    rank = torch.arange(p, device=outputs.device)[None, None, :, None]
    correct = (claims & any_claim[:, :, None, :] & (first[:, :, None, :] == rank)).any(dim=-1)
    return {"correct": correct, "scores": scores_sorted, "counts": gt_present.sum(dim=-1, dtype=torch.int32)}

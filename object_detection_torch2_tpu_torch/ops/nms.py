"""Batched greedy class-agnostic NMS
(counterpart of object_detection_torch2_tpu/ops/nms.py:44-133, 226-304).

Reproduces the reference `non_maximum_suppression` (reference: src/utils.py:80-116):
the sort key is the max over NON-void scores `output[:, 5:]`; only entries with
key > 0 take part; suppression is class-agnostic at IoU > 0.5 on the decoded
boxes; the 0/1 keep mask multiplies ALL score columns (including void).

- `nms_keep_mask_serial`: the literal one-candidate-per-step loop, the
  semantics oracle of the tests.
- `_blocked_keep_sorted`: the plain version of the sweep kernel — score-sorted
  candidates in 128-wide blocks, an exact triangular fixpoint inside each
  block, every kept pivot suppressing all later candidates, and an early exit
  once nothing is alive at or after the current block.
- `nms_keep_mask`: compacted tiers (128, 1024) with an exact fall-through to the
  full sort. Every sweep — the full one and both tiers — goes through
  `ops.nms_cuda.keep_sorted`: the CUDA kernel for a tensor on the card, the
  plain sweep for a tensor on the CPU. The result is the same function at
  every width.

Ties: candidates are ordered by a stable sort, so among EXACT score ties the
lowest index goes first (and, for exact-duplicate rows, survives), as the JAX
package's stable `argsort` and `lax.top_k` order them.
"""

from __future__ import annotations

import torch

from object_detection_torch2_tpu_torch.core.boxes import pairwise_iou

BLOCK = 128

# a tier applies only when the positive (score > 0) count of EVERY image in the
# batch fits it; otherwise the next tier, and finally the full path, runs
COMPACT_TIERS = (128, 1024)


def _scatter_keep(keep_sorted: torch.Tensor, order: torch.Tensor, p: int) -> torch.Tensor:
    out = torch.zeros(keep_sorted.shape[0], p, dtype=torch.bool, device=keep_sorted.device)
    return out.scatter_(1, order, keep_sorted)


def _take_boxes(boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))


def nms_keep_mask_serial(boxes: torch.Tensor, sort_scores: torch.Tensor, iou_thresh: float = 0.5) -> torch.Tensor:
    """Literal greedy loop (one candidate per step). Semantics reference."""
    n, p, _ = boxes.shape
    order = torch.sort(-sort_scores, dim=-1, stable=True).indices
    sorted_boxes = _take_boxes(boxes, order)
    keep = torch.gather(sort_scores, 1, order) > 0.0
    later = torch.arange(p, device=boxes.device)[None, :]
    for i in range(p):
        iou_row = pairwise_iou(sorted_boxes[:, i:i + 1], sorted_boxes)[:, 0, :]  # (N, P)
        suppress = keep[:, i:i + 1] & (iou_row > iou_thresh) & (later > i)
        keep = keep & ~suppress
    return _scatter_keep(keep, order, p)


def _block_self_suppress(alive: torch.Tensor, iou_tile: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Exact greedy keep mask within one score-sorted block.

    alive: (N, B) candidates not suppressed by earlier blocks; iou_tile: (N, B, B)
    with iou_tile[n, j, i] = IoU(j, i). Iterates k <- alive & ~(any earlier kept
    j with iou(j, i) > t) to its unique fixpoint: the triangular (j < i)
    dependency pins a prefix on each pass, so the loop ends within the
    block's suppression-chain depth."""
    b = iou_tile.shape[-1]
    idx = torch.arange(b, device=iou_tile.device)
    over = (iou_tile > iou_thresh) & (idx[:, None] < idx[None, :])[None]  # over[n, j, i]: j suppresses i
    k = alive
    while True:
        killed = (over & k[:, :, None]).any(dim=1)
        k_new = alive & ~killed
        if torch.equal(k_new, k):
            return k
        k = k_new


def _blocked_keep_sorted(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                         iou_thresh: float) -> torch.Tensor:
    """Blocked greedy sweep over SCORE-SORTED candidates -> keep mask in sorted
    order. sorted_boxes: (N, P, 4) center-form f32; sorted_valid: (N, P) bool.

    The plain version of the CUDA kernel (csrc/nms_keep_sorted.cu). Each kept
    pivot block suppresses only the candidates after the block; the JAX
    package computes the cross IoU over the whole row and masks the earlier
    columns, which decides the same thing."""
    p = sorted_boxes.shape[1]
    keep = sorted_valid.clone()
    for start in range(0, p, BLOCK):
        # early exit (exact): only kept candidates suppress, and candidates are
        # score-sorted, so once nothing is alive at or after this block the
        # remaining blocks change nothing
        if not bool(keep[:, start:].any()):
            break
        stop = min(start + BLOCK, p)
        blk = sorted_boxes[:, start:stop]
        kept_blk = _block_self_suppress(keep[:, start:stop], pairwise_iou(blk, blk), iou_thresh)
        keep[:, start:stop] = kept_blk
        if stop < p:
            hit = pairwise_iou(blk, sorted_boxes[:, stop:]) > iou_thresh  # (N, B, P - stop)
            keep[:, stop:] &= ~(hit & kept_blk[:, :, None]).any(dim=1)
    return keep


def nms_keep_mask(boxes: torch.Tensor, sort_scores: torch.Tensor, iou_thresh: float = 0.5,
                  sweep=None) -> torch.Tensor:
    """Blocked exact greedy keep mask.

    boxes: (N, P, 4) center-form, sort_scores: (N, P) (entries <= 0 never kept)
    -> bool (N, P) in the ORIGINAL anchor order.

    Exact paths, smallest first, chosen on the host from the largest positive
    count of the batch:
    - compacted tiers T in (128, 1024), when every image has <= T positives:
      only score > 0 candidates take part in greedy NMS, so a stable descending
      sort cut to T candidates gives the IDENTICAL keep set at a fraction of the
      sweep width;
    - full: a stable sort of all P candidates (any positive count).

    `sweep(sorted_boxes, sorted_valid, iou_thresh)` computes the keep mask over
    sorted candidates; None means `ops.nms_cuda.keep_sorted`. Passing
    `_blocked_keep_sorted` runs the plain sweep on any device, for comparing
    the kernel with it.
    """
    if sweep is None:
        from object_detection_torch2_tpu_torch.ops.nms_cuda import keep_sorted as sweep
    p = boxes.shape[1]
    max_pos = int((sort_scores > 0.0).sum(dim=-1).max())
    for t in COMPACT_TIERS:
        if t < p and max_pos <= t:
            vals, idx = torch.sort(sort_scores, dim=-1, descending=True, stable=True)
            vals, idx = vals[:, :t].contiguous(), idx[:, :t].contiguous()
            keep_c = sweep(_take_boxes(boxes, idx), vals > 0.0, iou_thresh)
            return _scatter_keep(keep_c, idx, p)
    order = torch.sort(-sort_scores, dim=-1, stable=True).indices
    sorted_valid = torch.gather(sort_scores, 1, order) > 0.0
    return _scatter_keep(sweep(_take_boxes(boxes, order), sorted_valid, iou_thresh), order, p)


def non_maximum_suppression(outputs: torch.Tensor, iou_thresh: float = 0.5, sweep=None) -> torch.Tensor:
    """outputs: (N, P, 4+C) decoded boxes + one-class-kept scores -> same shape,
    with suppressed anchors' scores (all C columns) zeroed."""
    sort_scores = outputs[..., 5:].amax(dim=-1)  # max over non-void classes (utils.py:99)
    keep = nms_keep_mask(outputs[..., :4].contiguous(), sort_scores, iou_thresh, sweep)
    scores = outputs[..., 4:] * keep[..., None].to(outputs.dtype)
    return torch.cat([outputs[..., :4], scores], dim=-1)

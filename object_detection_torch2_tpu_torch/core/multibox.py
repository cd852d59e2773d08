"""MultiBox loss (localization + confidence) with hard-negative mining
(counterpart of object_detection_torch2_tpu/core/multibox.py).

Reproduces the reference `SSD.loss` (reference: src/model/ssd.py:181-328) as
one batched function, step for step as the JAX package computes it:

  1. anchor matching mask (N, P, G) at IoU > 0.25;
  2. localization loss: masked smooth-L1 over the 4 delta coordinates, summed
     over G, computed per coordinate so that no (N, P, G, 4) tensor is made;
  3. positive confidence loss: pairwise softmax-CE masked by the match;
  4. negative confidence loss: CE against the void class where nothing matches;
  5. hard-negative mining at pos:neg = 1:3 (`split_pos_neg`), each side kept
     by strict `>` against its (k+1)-th largest value — positives are also
     top-k selected (the reference's side effect, src/model/ssd.py:222-223);
  6. total = mean over the batch of the per-image sums / pos_k, where pos_k == 0
     gives exactly 0 through the where-reciprocal (src/model/ssd.py:226-227).
"""

from __future__ import annotations

import torch

from object_detection_torch2_tpu_torch.core import boxes as B


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 keys in the same total order as the JAX package's radix
    select: non-negative floats keep their bits, negative floats get their low
    31 bits flipped (so that -0.0 sorts just below +0.0 and NaNs at the ends)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def kth_plus_one_threshold(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row (k+1)-th largest value of x; k == 0 gives the row max.

    x (N, P) float32, k (N,) int -> (N,). Bit-equal to the JAX package's radix
    select: a descending sort of `_order_keys(x)` ranks the values in the radix
    select's order, and the value at rank clip(k, 0, P-1) is read back from x
    by its sort index, with its exact bits. It selects a value, so it carries
    no gradient.
    """
    x = x.detach()
    p = x.shape[-1]
    idx = torch.sort(_order_keys(x), dim=-1, descending=True).indices
    rank = torch.clamp(k, 0, p - 1).to(torch.int64)[:, None]
    return x.gather(-1, idx.gather(-1, rank))[:, 0]


def split_pos_neg(pos_num: torch.Tensor, neg_num: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Enforce pos:neg = 1:3 (reference: src/model/ssd.py:300-311).

    If 3*pos > neg then pos <- neg // 3 (neg unchanged), else neg <- 3*pos.
    (10, 8722) -> (10, 30); (4000, 4732) -> (1577, 4732).
    """
    cond = pos_num * 3 > neg_num
    return (
        torch.where(cond, torch.div(neg_num, 3, rounding_mode="floor"), pos_num),
        torch.where(cond, neg_num, pos_num * 3),
    )


def multibox_loss(
    outputs: torch.Tensor,
    targets: torch.Tensor,
    default_boxes: torch.Tensor,
    alpha: float = 1.0,
    match_threshold: float = 0.25,
) -> torch.Tensor:
    """Scalar MultiBox loss.

    outputs: (N, P, 4+C) raw head outputs (deltas + class logits),
    targets: (N, G, 4+C) center-form GT + one-hot(C) with void at index 0;
             zero-padded rows are inert,
    default_boxes: (P, 4) anchor table,
    alpha: loc-loss weight (reference default a=1, src/model/ssd.py:181).

    The largest intermediates are (N, P, G) float32, 72 MB each at N 32 and
    G 64.
    """
    p = outputs.shape[1]
    loc = outputs[..., :4]
    cls = outputs[..., 4:]
    gt_boxes = targets[..., :4]
    gt_cls = targets[..., 4:]

    is_match = B.match_mask(gt_boxes, default_boxes, match_threshold)  # (N, P, G) bool
    match_f = is_match.to(loc.dtype)

    # localization loss (reference: ssd.py:202-204), one coordinate at a time
    g = gt_boxes[:, None, :, :]  # (N, 1, G, 4)
    d = default_boxes[None, :, None, :]  # (1, P, 1, 4)
    sl1_sum = B.smooth_l1(loc[:, :, None, 0] - (g[..., 0] - d[..., 0]) / d[..., 2])
    sl1_sum = sl1_sum + B.smooth_l1(loc[:, :, None, 1] - (g[..., 1] - d[..., 1]) / d[..., 3])
    sl1_sum = sl1_sum + B.smooth_l1(loc[:, :, None, 2] - B.log_ratio(g[..., 2], d[..., 2]))
    sl1_sum = sl1_sum + B.smooth_l1(loc[:, :, None, 3] - B.log_ratio(g[..., 3], d[..., 3]))
    l_loc = (sl1_sum * match_f).sum(-1)  # (N, P)

    # positive confidence loss (reference: ssd.py:208-209)
    l_conf_pos = (B.pairwise_softmax_ce(cls, gt_cls) * match_f).sum(-1)  # (N, P)

    # negative confidence loss against the void class (reference: ssd.py:212-215)
    any_match = is_match.sum(-1)  # (N, P) int
    l_conf_neg = B.void_softmax_ce(cls) * (any_match == 0).to(loc.dtype)  # (N, P)

    # hard-negative mining (reference: ssd.py:218-223)
    pos_num = (any_match != 0).sum(-1)  # (N,)
    pos_k, neg_k = split_pos_neg(pos_num, p - pos_num)
    pos_valid = l_conf_pos > kth_plus_one_threshold(l_conf_pos, pos_k)[:, None]
    neg_valid = l_conf_neg > kth_plus_one_threshold(l_conf_neg, neg_k)[:, None]

    # reduction (reference: ssd.py:226-227): per-image sum / pos_k, 0 when pos_k == 0
    recip = torch.where(pos_k > 0, 1.0 / torch.clamp(pos_k, min=1).to(loc.dtype), 0.0)
    per_image = ((alpha * l_loc + l_conf_pos) * pos_valid + l_conf_neg * neg_valid).sum(-1)
    return (per_image * recip).mean()

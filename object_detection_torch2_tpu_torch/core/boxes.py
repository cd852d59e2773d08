"""Center-form box math: pairwise IoU, matching, delta encode/decode,
smooth-L1 and the pairwise cross-entropies
(counterpart of object_detection_torch2_tpu/core/boxes.py).

Boxes are center-form [cx, cy, w, h], normalized to [0, 1] image coordinates.
There is NO variance scaling in the encode or the decode (quirk Q6).
"""

from __future__ import annotations

import torch


def pairwise_iou(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between two center-form box sets.

    t: (..., T, 4), s: (..., S, 4) -> (..., T, S).

    The operation order is the JAX package's, step for step: the NMS kernel
    (csrc/nms_keep_sorted.cu) repeats it so that its keep mask is bit-equal to
    the plain sweep. Zero-intersection pairs return exactly 0 via the
    reference's `where(w*h > 0, iou, w*h)` guard, which also keeps all-zero
    padded rows inert (reference: src/utils.py:58-77).
    """
    t = t[..., :, None, :]
    s = s[..., None, :, :]
    w = torch.clamp(
        torch.minimum(t[..., 0] + t[..., 2] / 2, s[..., 0] + s[..., 2] / 2)
        - torch.maximum(t[..., 0] - t[..., 2] / 2, s[..., 0] - s[..., 2] / 2),
        min=0,
    )
    h = torch.clamp(
        torch.minimum(t[..., 1] + t[..., 3] / 2, s[..., 1] + s[..., 3] / 2)
        - torch.maximum(t[..., 1] - t[..., 3] / 2, s[..., 1] - s[..., 3] / 2),
        min=0,
    )
    inter = w * h
    union = t[..., 2] * t[..., 3] + s[..., 2] * s[..., 3] - inter
    return torch.where(inter > 0, inter / union, inter)


def decode_boxes(pr: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Inverse of the delta encoding: predicted deltas -> center-form boxes.

    pr: (N, P, >=4) (only the first 4 channels are read), df: (P, 4) -> (N, P, 4)
    of [d_w*p_cx + d_cx, d_h*p_cy + d_cy, d_w*e^{p_w}, d_h*e^{p_h}]
    (reference: src/utils.py:19-40).
    """
    d = df[None, :, :]
    cx = d[..., 2] * pr[..., 0] + d[..., 0]
    cy = d[..., 3] * pr[..., 1] + d[..., 1]
    w = d[..., 2] * torch.exp(pr[..., 2])
    h = d[..., 3] * torch.exp(pr[..., 3])
    return torch.stack([cx, cy, w, h], dim=-1)


def match_mask(gt: torch.Tensor, df: torch.Tensor, threshold: float = 0.25) -> torch.Tensor:
    """Anchor-to-GT matching mask: gt (N, G, 4), df (P, 4) -> bool (N, P, G).

    `IoU > threshold` with threshold 0.25, not the paper's 0.5 (reference:
    src/model/ssd.py:231-250). Zero-area padded GT rows get IoU 0 through
    `where(g_w*g_h > 0, iou, g_w*g_h)`, so they never match.
    """
    g = gt[:, None, :, :]  # (N, 1, G, 4)
    d = df[None, :, None, :]  # (1, P, 1, 4)
    w = torch.clamp(
        torch.minimum(g[..., 0] + g[..., 2] / 2, d[..., 0] + d[..., 2] / 2)
        - torch.maximum(g[..., 0] - g[..., 2] / 2, d[..., 0] - d[..., 2] / 2),
        min=0,
    )
    h = torch.clamp(
        torch.minimum(g[..., 1] + g[..., 3] / 2, d[..., 1] + d[..., 3] / 2)
        - torch.maximum(g[..., 1] - g[..., 3] / 2, d[..., 1] - d[..., 3] / 2),
        min=0,
    )
    g_area = g[..., 2] * g[..., 3]
    d_area = d[..., 2] * d[..., 3]
    inter = w * h
    iou = torch.where(g_area > 0, inter / (g_area + d_area - inter), g_area)
    return iou > threshold


def log_ratio(g: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """log(g / d) where g > 0, else g: the guard that keeps zero-padded GT
    rows finite (and their gradients too) (reference: src/model/ssd.py:252-272)."""
    return torch.where(g > 0, torch.log(torch.where(g > 0, g, 1.0) / d), g)


def encode_deltas(gt: torch.Tensor, df: torch.Tensor) -> torch.Tensor:
    """Box delta ("g-hat") encoding for every (anchor, GT) pair.

    gt (N, G, 4), df (P, 4) -> (N, P, G, 4) of
    [(g_cx-d_cx)/d_w, (g_cy-d_cy)/d_h, log(g_w/d_w), log(g_h/d_h)]. The loss
    does not call it: it works per coordinate so that no (N, P, G, 4) tensor
    is ever made (core/multibox.py).
    """
    g = gt[:, None, :, :]
    d = df[None, :, None, :]
    cx = (g[..., 0] - d[..., 0]) / d[..., 2]
    cy = (g[..., 1] - d[..., 1]) / d[..., 3]
    return torch.stack([cx, cy, log_ratio(g[..., 2], d[..., 2]), log_ratio(g[..., 3], d[..., 3])], dim=-1)


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Element-wise smooth-L1: 0.5x^2 for |x|<1 else |x|-0.5 (reference: src/model/ssd.py:274-283)."""
    ax = torch.abs(x)
    return torch.where(ax < 1, 0.5 * x * x, ax - 0.5)


def pairwise_softmax_ce(pr: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Pairwise softmax cross-entropy -sum(gt * log_softmax(pr)) over classes.

    pr (N, P, C) logits, gt (N, G, C) one-hot (all-zero padded rows give 0)
    -> (N, P, G), as sum(gt) * logsumexp(pr) - pr @ gt^T (reference:
    src/model/ssd.py:285-298). The product is a float32 matmul, which PyTorch
    runs in full float32 on the card unless TF32 matmuls are switched on.
    """
    lse = torch.logsumexp(pr, dim=-1)  # (N, P)
    gt_sum = gt.sum(dim=-1)  # (N, G); 1 for real rows, 0 for padding
    dot = torch.bmm(pr, gt.transpose(1, 2))
    return gt_sum[:, None, :] * lse[:, :, None] - dot


def void_softmax_ce(pr: torch.Tensor, void_index: int = 0) -> torch.Tensor:
    """Cross-entropy of each anchor against the void one-hot: pr (N, P, C) ->
    (N, P) = logsumexp(pr) - pr[..., void_index] (reference: src/model/ssd.py:212-213)."""
    return torch.logsumexp(pr, dim=-1) - pr[..., void_index]

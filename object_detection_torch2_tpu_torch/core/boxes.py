"""Center-form box math: pairwise IoU and delta decode
(counterpart of object_detection_torch2_tpu/core/boxes.py:18-41, 92-104).

Boxes are center-form [cx, cy, w, h], normalized to [0, 1] image coordinates.
There is NO variance scaling in the decode (quirk Q6). Matching, encoding and
the losses go with the training slice of the port.
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

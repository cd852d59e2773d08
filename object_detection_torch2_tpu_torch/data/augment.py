"""Eval-time image conversion (counterpart of object_detection_torch2_tpu/data/augment.py:222-225).

The training augment chain goes with the data slice of the port."""

from __future__ import annotations

import numpy as np
import torch

# XLA compiles the JAX package's `x / 255.0` into a multiplication by the
# float32 reciprocal; multiplying by the same constant keeps the port bit-equal.
INV_255 = float(np.float32(1.0) / np.float32(255.0))


def to_tensor_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> float32 in [0, 1] (reference ToTensor semantics),
    bit-equal to the JAX package."""
    return images_u8.to(torch.float32) * INV_255

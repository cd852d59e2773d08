"""BatchNorm's batch moments as per-image float64 partial sums: the plain
version, the gradient and the dispatch (no TPU counterpart: the JAX package's
models/bn.py takes jnp.mean over the batch and XLA reduces it).

`bn_moments(x)` is what `models.bn.BatchNorm` runs with batch statistics,
through the custom op `torch.ops.odt.bn_moments` (ops/registry.py):
- on a CPU tensor, the plain version `bn_moments_plain`;
- on a CUDA tensor, the kernel csrc/bn_moments.cu (ops/bn_moments_cuda.py),
  or an exception. Nothing falls back.

x (N, C, H, W) bfloat16, float32 or float64, NCHW or channels_last ->
(N, 2, C) float64; row n is [sum over (H, W) of x[n], sum over (H, W) of
sq(x[n])], sq the square rounded in x's math dtype (float32 for bfloat16 and
float32, float64 for float64). Each image's row comes from its own slice
alone, in an order that does not depend on N, so a batch's rows are those of
its images however the batch is split: one process and the ranks of a mesh
then add the same rows in the same global order (models/bn.py).

The gradient of the rows g (N, 2, C) is dx = g[:, 0] + 2 x g[:, 1],
broadcast over (H, W), in x's math dtype, with plain tensor ops (no atomics:
the same on every run).
"""

from __future__ import annotations

import torch


def math_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of BatchNorm's math for an input of `dtype`: float32, or float64 as it is."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# elements of one image a chunk of rows of the plain version holds: its
# float64 copies stay in the cache, where one copy of a whole activation
# would fault in fresh pages (4-8x slower on the CPU)
PLAIN_CHUNK_ELEMS = 1 << 14


def bn_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version on any device: float64 sums over (2, 3) of x and
    of its square in the math dtype, over chunks of whole rows of H (their
    number set by (C, H, W) alone), the chunks' sums added in row order.
    Within a chunk PyTorch's reduction adds each (image, channel) from its
    own elements in an order set by the chunk's (C, rows, W) and the layout
    (tests/test_torch_bn_moments.py holds the split)."""
    c, h, w = x.shape[1:]
    rows = max(1, PLAIN_CHUNK_ELEMS // max(1, c * w))
    mdt = math_dtype(x.dtype)
    total = None
    for r0 in range(0, h, rows):
        part = x[:, :, r0:r0 + rows]
        sums = torch.stack([torch.sum(part, dim=(2, 3), dtype=torch.float64),
                            torch.sum(part.to(mdt).square(), dim=(2, 3), dtype=torch.float64)], dim=1)
        total = sums if total is None else total + sums
    return total if total is not None else x.new_zeros((x.shape[0], 2, c), dtype=torch.float64)


def bn_moments_setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def bn_moments_backward(ctx, g):
    """dx of the rows' gradient g: g[:, 0] + 2 x g[:, 1] in x's math dtype."""
    (x,) = ctx.saved_tensors
    xm = x.to(math_dtype(x.dtype))
    gm = g.to(xm.dtype)[:, :, :, None, None]
    return (gm[:, 0] + 2.0 * xm * gm[:, 1]).to(x.dtype)


def bn_moments(x: torch.Tensor) -> torch.Tensor:
    """The per-image moments through `torch.ops.odt.bn_moments`: the plain
    version for a CPU tensor, the kernel (or an exception) for a CUDA tensor,
    an error for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no BatchNorm moments for device {x.device}")
    from object_detection_torch2_tpu_torch.ops import registry

    return registry.bn_moments(x)

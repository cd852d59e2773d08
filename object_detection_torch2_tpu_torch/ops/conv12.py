"""conv_1_2 of the SSD trunk: the plain version, the autograd wrapper and the
dispatch (counterpart of object_detection_torch2_tpu/ops/conv12_pallas.py).

`conv12(x, w, b, out_dtype)` is what `SSD(conv12_kernel=True)` runs for layer
1_2 (3x3, stride 1, pad 1, 64 -> 64):
- on a CPU tensor, the plain version `conv12_plain`;
- on a CUDA tensor, the kernel csrc/conv12.cu through `Conv12Function`, or an
  exception. Nothing falls back, and nothing moves the work to the CPU.

Numerics, as the TPU kernel's: the sum in float32 whatever the input type,
the float32 bias added in float32, one cast to `out_dtype` at the end. The
backward is plain PyTorch math (the input and weight gradients of the same
convolution, in true float32 for float32), as the JAX package's custom VJP
delegates to its XLA formulation; the frozen-trunk recipe never calls it.

The TPU's paired-x layout, `pack_conv12_weights`, `pick_tile_h` and the
host-side edge operand are lane tricks of the TPU and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_detection_torch2_tpu_torch import true_float32
from object_detection_torch2_tpu_torch.ops import conv12_cuda


def conv12_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (N, C, H, W), w (C, C, 3, 3), b (C,) -> (N, C, H, W) in `out_dtype`
    (default x's type): F.conv2d in float32 (TF32 off), + b in float32, cast."""
    with true_float32():
        y = F.conv2d(x.float(), w.float(), None, padding=1)
    return (y + b.float()[None, :, None, None]).to(out_dtype or x.dtype)


class Conv12Function(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: plain PyTorch math."""

    @staticmethod
    def forward(ctx, x, w, b, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = b.dtype
        return conv12_cuda.conv12_cuda(x, w, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        gc = g.to(x.dtype)
        with true_float32():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, gc, padding=1)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, gc, padding=1)
        if ctx.needs_input_grad[2]:
            gb = g.float().sum(dim=(0, 2, 3)).to(ctx.bias_dtype)
        return gx, gw, gb, None


def conv12(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """conv_1_2: the plain version for a CPU tensor, the kernel (or an
    exception) for a CUDA tensor, an error for any other device."""
    if x.device.type == "cpu":
        return conv12_plain(x, w, b, out_dtype)
    if x.device.type == "cuda":
        return Conv12Function.apply(x, w, b, out_dtype)
    raise ValueError(f"no conv_1_2 for device {x.device}")

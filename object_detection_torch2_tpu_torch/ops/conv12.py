"""conv_1_2 of the SSD trunk: the plain version, the gradient and the
dispatch (counterpart of object_detection_torch2_tpu/ops/conv12_pallas.py).

`conv12(x, w, b, out_dtype)` is what `SSD(conv12_kernel=True)` runs for layer
1_2 (3x3, stride 1, pad 1, 64 -> 64), through the custom op
`torch.ops.odt.conv12` (ops/registry.py):
- on a CPU tensor, the plain version `conv12_plain`;
- on a CUDA tensor, the kernels of csrc/ (ops/conv12_cuda.py), or an
  exception. Nothing falls back, and nothing moves the work to the CPU.

Numerics, as the TPU kernel's: the sum in float32 whatever the input type,
the float32 bias added in float32, one cast to `out_dtype` at the end. The
gradient (`conv12_backward`, the op's autograd formula on every device) is
plain PyTorch math, the gradient of `conv12_plain` as autograd computes it:
the input and weight gradients of the float32 convolution
(`aten.convolution_backward`, in true float32), cast to the inputs' types, as
the JAX package's custom VJP delegates to its XLA formulation; the
frozen-trunk recipe never calls it.

The TPU's paired-x layout, `pack_conv12_weights`, `pick_tile_h` and the
host-side edge operand are lane tricks of the TPU and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_detection_torch2_tpu_torch import true_float32


def conv12_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x (N, C, H, W), w (C, C, 3, 3), b (C,) -> (N, C, H, W) in `out_dtype`
    (default x's type): F.conv2d in float32 (TF32 off), + b in float32, cast."""
    with true_float32(torch.float32):
        y = F.conv2d(x.float(), w.float(), None, padding=1)
    return (y + b.float()[None, :, None, None]).to(out_dtype or x.dtype)


def conv12_setup_context(ctx, inputs, output):
    x, w, b, _ = inputs
    ctx.save_for_backward(x, w)
    ctx.bias_dtype = b.dtype


def conv12_backward(ctx, g):
    """Gradients (x, w, b, None) of `conv12` for the output gradient g: those
    of `conv12_plain` under autograd, bit for bit on the CPU."""
    x, w = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    gx = gw = gb = None
    gf = g.float()
    if need_x or need_w:
        with true_float32(torch.float32):
            gxf, gwf, _ = torch.ops.aten.convolution_backward(gf, x.float(), w.float(), None, [1, 1], [1, 1], [1, 1],
                                                              False, [0, 0], 1, [need_x, need_w, False])
        gx = gxf.to(x.dtype) if need_x else None
        gw = gwf.to(w.dtype) if need_w else None
    if need_b:
        gb = gf.sum(dim=(0, 2, 3)).to(ctx.bias_dtype)
    return gx, gw, gb, None


def conv12(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """conv_1_2 through `torch.ops.odt.conv12`: the plain version for a CPU
    tensor, the kernel (or an exception) for a CUDA tensor, an error for any
    other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv_1_2 for device {x.device}")
    from object_detection_torch2_tpu_torch.ops import registry

    return registry.conv12(x, w, b, out_dtype)

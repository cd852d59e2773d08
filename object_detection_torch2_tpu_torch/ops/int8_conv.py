"""The s8 x s8 -> s32 convolution of the quantized layers and the activation
quantize that feeds it: the plain versions, the dequantization epilogue and
the dispatch (counterpart of the lax convolution in
object_detection_torch2_tpu/models/quant.py::int8_conv, of its
`quantize_act` and of the dequantization in its models/ssd.py
`_conv_bn_relu_q`, `_head_conv_q`).

`int8_conv(x8, w8, scale, bias, stride, pad, out_dtype)` is what the
quantized layers of `SSD` run, through the custom op `torch.ops.odt.int8_conv`
(ops/registry.py):
- on a CPU tensor, the plain version `int8_conv_plain`;
- on a CUDA tensor, the kernel csrc/int8_conv.cu (ops/int8_conv_cuda.py), or
  an exception. Nothing falls back, and nothing moves the work to the CPU.

Operands: x8 (N, Cin, H, W) int8 in the channels_last memory format (NHWC in
memory), w8 (Cout, kh, kw, Cin) int8 contiguous (K-contiguous rows, the
kernel's layout; `pack_weight` makes it from (Cout, Cin, kh, kw)). Output
(N, Cout, Ho, Wo) channels_last: with `scale` None the raw int32 sums, else
the epilogue `dequantize`: float32(acc) * scale rounded to `out_dtype`, plus
`bias` in `out_dtype`. `scale` is the float32 (Cout,) vector sx * sw that the
caller computes first, as the JAX package writes (y32 * (sx * sw)).

The plain version is exact: a float64 convolution of the int8 values, whose
products (<= 127^2) and sums (< 127^2 * 9 * 1024 < 2^53) round nowhere, cast
to int32. The epilogue's multiply and add are two PyTorch ops, so no FMA
contracts them (the kernel uses __fmul_rn / __fadd_rn to match).

`quantize_act(x, sx, reciprocal)` is the conv input's quantize, through the
custom op `torch.ops.odt.quantize_act`: on a CPU tensor the plain version
`quantize_act_plain` (which models/quant.py exports as `quantize_act`), on a
CUDA tensor the one-pass kernel csrc/quantize_act.cu
(ops/quantize_act_cuda.py) or an exception. x is (N, C, H, W) bfloat16 or
float32 (channels_last on the card), sx a 0-d float32 tensor; the output is
int8 channels_last.

There is no gradient: the ops register no autograd formula. The int8 layers
sit in the frozen trunk, upstream of every trainable parameter, and `Trainer`
refuses the serving-only full-int8 model; `int8_conv` raises when grad mode
is on and its scale or bias requires a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = (torch.float32, torch.bfloat16)


def output_size(h: int, w: int, kh: int, kw: int, stride: int, pad: int) -> tuple[int, int]:
    return (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1


def pack_weight(w8: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) int8 -> (Cout, kh, kw, Cin) contiguous."""
    return w8.permute(0, 2, 3, 1).contiguous()


def dequantize(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
               out_dtype: torch.dtype | None) -> torch.Tensor:
    """The epilogue: (float32(acc) * scale).to(out_dtype) + bias.to(out_dtype),
    per output channel (dim 1)."""
    y = (acc.to(torch.float32) * scale.to(torch.float32)[None, :, None, None]).to(out_dtype or torch.float32)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    return y


def int8_conv_plain(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, stride: int = 1, pad: int = 1,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain version on any device: exact int32 sums by a float64
    convolution, then the epilogue when `scale` is given."""
    acc = F.conv2d(x8.to(torch.float64), w8.permute(0, 3, 1, 2).to(torch.float64), stride=stride, padding=pad)
    acc = acc.to(torch.int32).contiguous(memory_format=torch.channels_last)
    if scale is None:
        return acc
    return dequantize(acc, scale, bias, out_dtype).contiguous(memory_format=torch.channels_last)


def quantize_act_plain(x: torch.Tensor, scale: torch.Tensor, reciprocal: bool = False) -> torch.Tensor:
    """Per-tensor symmetric int8 activation quantization (saturating):
    round(x / scale) half to even, clipped to +-127; with `reciprocal`,
    x * float32(1 / scale), the JAX Trainer's constant-folded form."""
    xf = x.to(torch.float32)
    q = torch.round(xf * (1.0 / scale) if reciprocal else xf / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_act(x: torch.Tensor, sx: torch.Tensor, reciprocal: bool = False) -> torch.Tensor:
    """The activation quantize through `torch.ops.odt.quantize_act`: the plain
    version for a CPU tensor, the kernel (or an exception) for a CUDA tensor,
    an error for any other device. Int8 channels_last out."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no activation quantize for device {x.device}")
    from object_detection_torch2_tpu_torch.ops import registry

    return registry.quantize_act(x, sx, reciprocal)


def int8_conv(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, stride: int = 1, pad: int = 1,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The int8 convolution through `torch.ops.odt.int8_conv`: the plain
    version for a CPU tensor, the kernel (or an exception) for a CUDA tensor,
    an error for any other device, and an error when a gradient is asked
    for."""
    if x8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 convolution for device {x8.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (scale, bias)):
        raise RuntimeError("int8_conv has no gradient: run it under torch.no_grad(), on frozen layers only")
    if scale is not None and out_dtype is None:
        out_dtype = torch.float32
    from object_detection_torch2_tpu_torch.ops import registry

    return registry.int8_conv(x8, w8, scale, bias, stride, pad, out_dtype)

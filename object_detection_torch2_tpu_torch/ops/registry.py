"""The package's kernels as `torch.library` custom ops.

`torch.export` traces through the dispatcher and cannot trace a ctypes call,
so each kernel is registered as an op of the `odt` namespace, with one
implementation for each device and a fake one for tracing:

- `torch.ops.odt.nms_keep_sorted(sorted_boxes, sorted_valid, iou_thresh)`:
  "cuda" runs the sweep kernel (`ops.nms_cuda.nms_keep_sorted_cuda`), "cpu"
  the plain sweep (`ops.nms._blocked_keep_sorted`);
- `torch.ops.odt.conv12(x, w, b, out_dtype)`: "cuda" runs the conv_1_2
  kernels (`ops.conv12_cuda.conv12_cuda`), "cpu" the plain version
  (`ops.conv12.conv12_plain`); its gradient is `ops.conv12.conv12_backward`;
- `torch.ops.odt.int8_conv(x8, w8, scale, bias, stride, pad, out_dtype)`:
  "cuda" runs the int8 convolution kernel (`ops.int8_conv_cuda.int8_conv_cuda`),
  "cpu" the plain version (`ops.int8_conv.int8_conv_plain`); it has no
  gradient (no autograd formula is registered: the int8 layers are frozen);
- `torch.ops.odt.quantize_act(x, sx, reciprocal)`: "cuda" runs the one-pass
  activation quantize (`ops.quantize_act_cuda.quantize_act_cuda`), "cpu" the
  plain version (`ops.int8_conv.quantize_act_plain`, models/quant.py's
  `quantize_act`); no gradient either;
- `torch.ops.odt.bn_moments(x)`: BatchNorm's per-image float64 moments
  (N, 2, C); "cuda" runs csrc/bn_moments.cu (`ops.bn_moments_cuda.bn_moments_cuda`),
  "cpu" the plain version (`ops.bn_moments.bn_moments_plain`); its gradient
  is `ops.bn_moments.bn_moments_backward`.

The op dispatches on its tensors' device. That is no fallback: a CUDA tensor
launches the kernel or raises, and only a CPU tensor takes the plain version.
The kernels' wrappers still count their launches. `ops.nms_cuda.keep_sorted`,
`ops.conv12.conv12`, `ops.int8_conv.int8_conv`, `ops.int8_conv.quantize_act`
and `ops.bn_moments.bn_moments` call these ops; an exported program holds them
as calls of `torch.ops.odt.*`, so loading one needs this module imported and
no model code.

The op signatures are annotated without `from __future__ import
annotations`: `torch.library` infers each op's schema from them.
"""

from typing import Optional

import torch

from object_detection_torch2_tpu_torch.ops import bn_moments as bn_moments_mod
from object_detection_torch2_tpu_torch.ops import (
    bn_moments_cuda,
    conv12_cuda,
    int8_conv_cuda,
    nms_cuda,
    quantize_act_cuda,
)
from object_detection_torch2_tpu_torch.ops import conv12 as conv12_mod
from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv_plain, output_size, quantize_act_plain
from object_detection_torch2_tpu_torch.ops.nms import _blocked_keep_sorted


@torch.library.custom_op("odt::nms_keep_sorted", mutates_args=(), device_types="cpu")
def nms_keep_sorted(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Keep mask (N, P) bool over score-sorted candidates."""
    return _blocked_keep_sorted(sorted_boxes, sorted_valid, iou_thresh)


@nms_keep_sorted.register_kernel("cuda")
def _nms_keep_sorted_cuda(sorted_boxes, sorted_valid, iou_thresh):
    return nms_cuda.nms_keep_sorted_cuda(sorted_boxes, sorted_valid, iou_thresh)


@nms_keep_sorted.register_fake
def _nms_keep_sorted_fake(sorted_boxes, sorted_valid, iou_thresh):
    return torch.empty_like(sorted_valid, memory_format=torch.contiguous_format)


@torch.library.custom_op("odt::conv12", mutates_args=(), device_types="cpu")
def conv12(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """conv_1_2 (3x3, stride 1, pad 1, 64 -> 64) + b, in `out_dtype`."""
    return conv12_mod.conv12_plain(x, w, b, out_dtype)


@conv12.register_kernel("cuda")
def _conv12_cuda(x, w, b, out_dtype):
    return conv12_cuda.conv12_cuda(x, w, b, out_dtype)


@conv12.register_fake
def _conv12_fake(x, w, b, out_dtype):
    return torch.empty_like(x, dtype=out_dtype or x.dtype)


conv12.register_autograd(conv12_mod.conv12_backward, setup_context=conv12_mod.conv12_setup_context)


@torch.library.custom_op("odt::int8_conv", mutates_args=(), device_types="cpu")
def int8_conv(x8: torch.Tensor, w8: torch.Tensor, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              stride: int, pad: int, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """s8 x s8 -> s32 convolution, raw (scale None) or dequantized to `out_dtype` + bias."""
    return int8_conv_plain(x8, w8, scale, bias, stride, pad, out_dtype)


@int8_conv.register_kernel("cuda")
def _int8_conv_cuda(x8, w8, scale, bias, stride, pad, out_dtype):
    return int8_conv_cuda.int8_conv_cuda(x8, w8, scale, bias, stride, pad, out_dtype)


@int8_conv.register_fake
def _int8_conv_fake(x8, w8, scale, bias, stride, pad, out_dtype):
    ho, wo = output_size(x8.shape[2], x8.shape[3], w8.shape[1], w8.shape[2], stride, pad)
    dtype = torch.int32 if scale is None else out_dtype or torch.float32
    return torch.empty((x8.shape[0], w8.shape[0], ho, wo), dtype=dtype, device=x8.device,
                       memory_format=torch.channels_last)


@torch.library.custom_op("odt::quantize_act", mutates_args=(), device_types="cpu")
def quantize_act(x: torch.Tensor, sx: torch.Tensor, reciprocal: bool) -> torch.Tensor:
    """int8 round(x / sx) (with `reciprocal`: x * float32(1 / sx)) clipped to +-127, channels_last."""
    return quantize_act_plain(x, sx, reciprocal).contiguous(memory_format=torch.channels_last)


@quantize_act.register_kernel("cuda")
def _quantize_act_cuda(x, sx, reciprocal):
    return quantize_act_cuda.quantize_act_cuda(x, sx, reciprocal)


@quantize_act.register_fake
def _quantize_act_fake(x, sx, reciprocal):
    return torch.empty(x.shape, dtype=torch.int8, device=x.device, memory_format=torch.channels_last)


@torch.library.custom_op("odt::bn_moments", mutates_args=(), device_types="cpu")
def bn_moments(x: torch.Tensor) -> torch.Tensor:
    """(N, 2, C) float64: each image's sums over (H, W) of x and of its square."""
    return bn_moments_mod.bn_moments_plain(x)


@bn_moments.register_kernel("cuda")
def _bn_moments_cuda(x):
    return bn_moments_cuda.bn_moments_cuda(x)


@bn_moments.register_fake
def _bn_moments_fake(x):
    return x.new_empty((x.shape[0], 2, x.shape[1]), dtype=torch.float64)


bn_moments.register_autograd(bn_moments_mod.bn_moments_backward, setup_context=bn_moments_mod.bn_moments_setup_context)

"""The package's two kernels as `torch.library` custom ops.

`torch.export` traces through the dispatcher and cannot trace a ctypes call,
so each kernel is registered as an op of the `odt` namespace, with one
implementation for each device and a fake one for tracing:

- `torch.ops.odt.nms_keep_sorted(sorted_boxes, sorted_valid, iou_thresh)`:
  "cuda" runs the sweep kernel (`ops.nms_cuda.nms_keep_sorted_cuda`), "cpu"
  the plain sweep (`ops.nms._blocked_keep_sorted`);
- `torch.ops.odt.conv12(x, w, b, out_dtype)`: "cuda" runs the conv_1_2
  kernels (`ops.conv12_cuda.conv12_cuda`), "cpu" the plain version
  (`ops.conv12.conv12_plain`); its gradient is `ops.conv12.conv12_backward`.

The op dispatches on its tensors' device. That is no fallback: a CUDA tensor
launches the kernel or raises, and only a CPU tensor takes the plain version.
The kernels' wrappers still count their launches. `ops.nms_cuda.keep_sorted`
and `ops.conv12.conv12` call these ops; an exported program holds them as
calls of `torch.ops.odt.*`, so loading one needs this module imported and no
model code.

The op signatures are annotated without `from __future__ import
annotations`: `torch.library` infers each op's schema from them.
"""

from typing import Optional

import torch

from object_detection_torch2_tpu_torch.ops import conv12 as conv12_mod
from object_detection_torch2_tpu_torch.ops import conv12_cuda, nms_cuda
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

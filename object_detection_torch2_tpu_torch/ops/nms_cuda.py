"""The NMS sweep on the card: csrc/nms_keep_sorted.cu bound with ctypes
(counterpart of object_detection_torch2_tpu/ops/nms_pallas.py).

`keep_sorted(sorted_boxes, sorted_valid, iou_thresh)` is the sweep that every
NMS path of `ops.nms.nms_keep_mask` runs:
- on a CPU tensor, the plain version `ops.nms._blocked_keep_sorted`;
- on a CUDA tensor, the kernel, or an exception. Nothing falls back, and
  nothing moves the work to the CPU.

`launches` counts the sweeps run on the card: `nms_keep_sorted_cuda` adds one
each time it launches the sweep (a mask kernel and a resolve kernel), and
nothing else touches it but a caller that resets it.

The sweep needs a scratch of n * p * ceil(p / 64) 64-bit words (306 MB at
32 x 8732); `MASK_SCRATCH_CAP_BYTES` bounds it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build
from object_detection_torch2_tpu_torch.ops.nms import _blocked_keep_sorted

launches = 0
TILE = 64
# the largest mask scratch a sweep may allocate: 2 GiB, ~7x the serving path's
# 32 x 8732
MASK_SCRATCH_CAP_BYTES = 2 << 30


@functools.cache
def _lib():
    lib = _build.load("nms_keep_sorted")
    fn = lib.nms_keep_sorted
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mask_scratch_bytes(n: int, p: int) -> int:
    """Bytes of the sweep's mask scratch: a 64-bit word per candidate and
    64-wide column block."""
    return n * p * (-(-p // TILE)) * 8


def nms_keep_sorted_cuda(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor,
                         iou_thresh: float = 0.5) -> torch.Tensor:
    """The kernel: sorted_boxes (N, P, 4) float32, sorted_valid (N, P) bool,
    both contiguous on one CUDA device -> keep (N, P) bool in sorted order.
    Launches on the current stream and raises on anything else it is given."""
    global launches
    if sorted_boxes.device.type != "cuda" or sorted_valid.device != sorted_boxes.device:
        raise ValueError(f"nms_keep_sorted_cuda needs both tensors on one CUDA device, got "
                         f"{sorted_boxes.device} and {sorted_valid.device}")
    if sorted_boxes.dtype != torch.float32 or sorted_valid.dtype != torch.bool:
        raise TypeError(f"expected float32 boxes and bool valid, got {sorted_boxes.dtype} and {sorted_valid.dtype}")
    if sorted_boxes.dim() != 3 or sorted_boxes.shape[2] != 4 or sorted_valid.shape != sorted_boxes.shape[:2]:
        raise ValueError(f"expected boxes (N, P, 4) and valid (N, P), got {tuple(sorted_boxes.shape)} "
                         f"and {tuple(sorted_valid.shape)}")
    if not (sorted_boxes.is_contiguous() and sorted_valid.is_contiguous()):
        raise ValueError("nms_keep_sorted_cuda needs contiguous tensors")
    n, p, _ = sorted_boxes.shape
    scratch = mask_scratch_bytes(n, p)
    if scratch > MASK_SCRATCH_CAP_BYTES:
        raise ValueError(f"{n} x {p} candidates need a {scratch} B mask scratch, above the "
                         f"{MASK_SCRATCH_CAP_BYTES} B cap; sweep fewer images at a time")
    keep = torch.empty((n, p), dtype=torch.uint8, device=sorted_boxes.device)
    mask = torch.empty(scratch // 8, dtype=torch.int64, device=sorted_boxes.device)
    fn = _lib()
    with torch.cuda.device(sorted_boxes.device):
        stream = torch.cuda.current_stream()
        rc = fn(sorted_boxes.data_ptr(), sorted_valid.data_ptr(), mask.data_ptr(), keep.data_ptr(), n, p,
                float(iou_thresh), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms_keep_sorted kernel launch failed: CUDA error {rc}")
    if n and p:
        launches += 1
    return keep.view(torch.bool)


def keep_sorted(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor, iou_thresh: float = 0.5) -> torch.Tensor:
    """Keep mask over SCORE-SORTED candidates: the kernel for CUDA tensors, the
    plain sweep for CPU tensors, an error for any other device."""
    if sorted_boxes.device.type == "cpu":
        return _blocked_keep_sorted(sorted_boxes, sorted_valid, iou_thresh)
    if sorted_boxes.device.type == "cuda":
        return nms_keep_sorted_cuda(sorted_boxes, sorted_valid, iou_thresh)
    raise ValueError(f"no NMS sweep for device {sorted_boxes.device}")

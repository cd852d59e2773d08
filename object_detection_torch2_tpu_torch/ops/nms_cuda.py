"""The NMS sweep on the card: csrc/nms_keep_sorted.cu bound with ctypes
(counterpart of object_detection_torch2_tpu/ops/nms_pallas.py).

`keep_sorted(sorted_boxes, sorted_valid, iou_thresh)` is the sweep that every
NMS path of `ops.nms.nms_keep_mask` runs, through the custom op
`torch.ops.odt.nms_keep_sorted` (ops/registry.py):
- on a CPU tensor, the plain version `ops.nms._blocked_keep_sorted`;
- on a CUDA tensor, the kernel, or an exception. Nothing falls back, and
  nothing moves the work to the CPU.

`launches` counts the sweeps run on the card: `nms_keep_sorted_cuda` adds one
each time it launches the sweep (a mask kernel and a resolve kernel) over a
slice of the batch, and nothing else touches it but a caller that resets it.

The sweep needs a scratch of p * ceil(p / 64) 64-bit words an image (9.57 MB
at P 8732, 306 MB at 32 x 8732); `MASK_SCRATCH_CAP_BYTES` bounds it. A batch
whose scratch is above the cap is swept in slices of at most
`MASK_SCRATCH_CAP_BYTES // mask_scratch_bytes(1, p)` images (224 at P 8732),
each slice a launch of the same kernels into one scratch reused from slice to
slice (the launches are ordered on one stream); `sweep_slices` cuts the
batch. Only an image whose own scratch is above the cap (p above 131,072)
is refused; SSD's P is 8732.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build

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


def sweep_slices(n: int, p: int, cap: int = MASK_SCRATCH_CAP_BYTES) -> list[tuple[int, int]]:
    """[(start, stop)] slices of an n-image batch at width p whose mask
    scratch each fits `cap` bytes: as few as possible, all but the last of
    the same size. Raises when one image's scratch is above the cap."""
    per_image = mask_scratch_bytes(1, p)
    if per_image > cap:
        raise ValueError(f"one image of {p} candidates needs a {per_image} B mask scratch, above the {cap} B cap")
    step = cap // per_image if per_image else max(n, 1)
    return [(start, min(start + step, n)) for start in range(0, n, step)]


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
    keep = torch.empty((n, p), dtype=torch.uint8, device=sorted_boxes.device)
    if n == 0 or p == 0:
        return keep.view(torch.bool)
    slices = sweep_slices(n, p, MASK_SCRATCH_CAP_BYTES)
    most = max(stop - start for start, stop in slices)
    mask = torch.empty(mask_scratch_bytes(most, p) // 8, dtype=torch.int64, device=sorted_boxes.device)
    fn = _lib()
    with torch.cuda.device(sorted_boxes.device):
        stream = torch.cuda.current_stream()
        for start, stop in slices:
            rc = fn(sorted_boxes[start].data_ptr(), sorted_valid[start].data_ptr(), mask.data_ptr(),
                    keep[start].data_ptr(), stop - start, p, float(iou_thresh), stream.cuda_stream)
            if rc != 0:
                raise RuntimeError(f"nms_keep_sorted kernel launch failed: CUDA error {rc}")
            launches += 1
    return keep.view(torch.bool)


def keep_sorted(sorted_boxes: torch.Tensor, sorted_valid: torch.Tensor, iou_thresh: float = 0.5) -> torch.Tensor:
    """Keep mask over SCORE-SORTED candidates through the custom op
    `torch.ops.odt.nms_keep_sorted` (ops/registry.py): the kernel for CUDA
    tensors, the plain sweep for CPU tensors, an error for any other device."""
    if sorted_boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS sweep for device {sorted_boxes.device}")
    from object_detection_torch2_tpu_torch.ops import registry

    return registry.nms_keep_sorted(sorted_boxes, sorted_valid, float(iou_thresh))

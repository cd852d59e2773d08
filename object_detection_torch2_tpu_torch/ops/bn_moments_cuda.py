"""BatchNorm's per-image batch moments on the card, bound with ctypes:
csrc/bn_moments.cu, whose order of summation for one (image, channel)
depends only on (C, H, W, dtype, layout), so a batch's rows equal, bit for
bit, those of its images split in any way.

`kernel_launches` counts the kernel's launches: `bn_moments_cuda` adds one
each time it launches it, and nothing else touches it but a caller that
resets it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
MISALIGNED = 716  # cudaErrorMisalignedAddress
MAX_GRID_YZ = 65535  # images and channels are grid dimensions y and z
kernel_launches = 0


@functools.cache
def _lib():
    lib = _build.load("bn_moments")
    lib.bn_moments_chunks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
    lib.bn_moments_chunks.restype = ctypes.c_longlong
    lib.bn_moments_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.bn_moments_forward.restype = ctypes.c_int
    return lib


def layout_code(x: torch.Tensor) -> int | None:
    """0 for an NCHW-contiguous x (also when it is channels_last as well: then
    both have one memory order), 1 for channels_last, None for neither."""
    if x.is_contiguous():
        return 0
    return 1 if x.is_contiguous(memory_format=torch.channels_last) else None


def bn_moments_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel: x (N, C, H, W) bfloat16, float32 or float64 on a CUDA
    device, NCHW- or channels_last-contiguous -> (N, 2, C) float64, row n
    [sum over (H, W) of x, of x's square rounded in x's math dtype]. Reads x
    in place and launches on the current stream; raises on anything else it
    is given. No launch for an empty x (its sums are zeros)."""
    global kernel_launches
    if x.device.type != "cuda":
        raise ValueError(f"bn_moments_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"bn_moments_cuda takes bfloat16, float32 or float64 x, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"bn_moments_cuda needs an (N, C, H, W) x, got shape {tuple(x.shape)}")
    layout = layout_code(x)
    if layout is None:
        raise ValueError(f"bn_moments_cuda reads an NCHW- or channels_last-contiguous x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    if n > MAX_GRID_YZ or c > MAX_GRID_YZ:
        raise ValueError(f"bn_moments_cuda takes at most {MAX_GRID_YZ} images and channels, got {n} and {c}")
    if x.numel() == 0:
        return torch.zeros((n, 2, c), dtype=torch.float64, device=x.device)
    out = torch.empty((n, 2, c), dtype=torch.float64, device=x.device)
    lib = _lib()
    k = lib.bn_moments_chunks(layout, DTYPE_CODE[x.dtype], c, h * w)
    stage = torch.empty(n * k * 2 * c if k > 1 else 0, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bn_moments_forward(x.data_ptr(), stage.data_ptr() if k > 1 else None, out.data_ptr(), n, c, h * w,
                                    layout, DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream)
    if rc == MISALIGNED:
        raise ValueError("bn_moments_cuda: this shape takes 16-byte loads and x is not 16-byte aligned")
    if rc != 0:
        raise RuntimeError(f"bn_moments kernel launch failed: CUDA error {rc}")
    kernel_launches += 1
    return out

"""The activation quantize of the int8 layers on the card, bound with ctypes:
csrc/quantize_act.cu, one pass from bfloat16 or float32 to int8 (the fusion
of the plain `models.quant.quantize_act`'s five PyTorch passes).

`kernel_launches` counts the kernel's launches: `quantize_act_cuda` adds one
each time it launches it, and nothing else touches it but a caller that
resets it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
kernel_launches = 0


@functools.cache
def _lib():
    fn = _build.load("quantize_act").quantize_act_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_act_cuda(x: torch.Tensor, sx: torch.Tensor, reciprocal: bool = False) -> torch.Tensor:
    """The kernel: x (N, C, H, W) channels_last bfloat16 or float32 and sx a
    0-d float32 scale, both on one CUDA device -> int8 (N, C, H, W)
    channels_last, round(x / sx) (or x * float32(1 / sx) with `reciprocal`)
    half to even, clamped to +-127. sx is read on the card. Launches on the
    current stream and raises on anything else it is given; it copies
    nothing."""
    global kernel_launches
    if x.device.type != "cuda" or sx.device != x.device:
        raise ValueError(f"quantize_act_cuda needs x and sx on one CUDA device, got {x.device} and {sx.device}")
    if x.dtype not in DTYPE_CODE:
        raise TypeError(f"quantize_act_cuda takes bfloat16 or float32 x, got {x.dtype}")
    if sx.dtype != torch.float32 or sx.dim() != 0:
        raise ValueError(f"expected a 0-d float32 sx, got {sx.dtype} {tuple(sx.shape)}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"quantize_act_cuda needs a channels_last-contiguous (N, C, H, W) x, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("quantize_act_cuda needs a 16-byte aligned x")
    y = torch.empty(x.shape, dtype=torch.int8, device=x.device, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    fn = _lib()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), sx.data_ptr(), y.data_ptr(), x.numel(), DTYPE_CODE[x.dtype], int(bool(reciprocal)),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_act kernel launch failed: CUDA error {rc}")
    kernel_launches += 1
    return y

"""conv_1_2 on the card: csrc/conv12.cu bound with ctypes
(counterpart of object_detection_torch2_tpu/ops/conv12_pallas.py::_conv12_pallas).

`launches` counts the kernel's launches: `conv12_cuda` adds one each time it
launches the kernel, and nothing else touches it but a caller that resets it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build

CHANNELS = 64
launches = 0


@functools.cache
def _lib():
    lib = _build.load("conv12")
    fn = lib.conv12_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3) -> (3, 3, ci, co) float32, the layout the kernel stages
    (147,456 bytes for 64 channels). Exact for float32 and bfloat16 weights."""
    return w.permute(2, 3, 1, 0).to(torch.float32).contiguous()


def conv12_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel: x (N, 64, H, W) channels_last float32 or bfloat16, w
    (64, 64, 3, 3) of x's type, b (64,) float32 or of x's type, all on one CUDA
    device -> y like x (channels_last, x's type). Launches on the current
    stream and raises on anything else it is given; it copies no input to
    another layout."""
    global launches
    if x.device.type != "cuda" or w.device != x.device or b.device != x.device:
        raise ValueError(f"conv12_cuda needs x, w and b on one CUDA device, got {x.device}, {w.device}, {b.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv12_cuda takes float32 or bfloat16 input, got {x.dtype}")
    if out_dtype not in (None, x.dtype):
        raise TypeError(f"conv12_cuda writes its input's type {x.dtype}, not {out_dtype}")
    if w.dtype != x.dtype or b.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"expected weights of {x.dtype} and a float32 bias, got {w.dtype} and {b.dtype}")
    c = CHANNELS
    if x.dim() != 4 or x.shape[1] != c or tuple(w.shape) != (c, c, 3, 3) or tuple(b.shape) != (c,):
        raise ValueError(f"expected x (N, {c}, H, W), w ({c}, {c}, 3, 3), b ({c},), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv12_cuda needs a channels_last-contiguous x")
    n, _, h, wd = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    wpk = pack_weights(w)
    bias = b.to(torch.float32).contiguous()
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        rc = fn(x.data_ptr(), wpk.data_ptr(), bias.data_ptr(), y.data_ptr(), n, h, wd,
                int(x.dtype == torch.bfloat16), stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv12 kernel launch failed: CUDA error {rc}")
    launches += 1
    return y

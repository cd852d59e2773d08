"""conv_1_2 on the card, bound with ctypes (counterpart of
object_detection_torch2_tpu/ops/conv12_pallas.py::_conv12_pallas): float32
input runs csrc/conv12.cu on the CUDA cores, bfloat16 input runs
csrc/conv12_bf16.cu on the tensor cores.

`launches` counts the launches of both kernels and `kernel_launches` those of
each, by source name: `conv12_cuda` adds one to both each time it launches a
kernel, and nothing else touches them but a caller that resets them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build

CHANNELS = 64
# the kernel of each input type, by its source's name under csrc/
KERNEL_OF = {torch.float32: "conv12", torch.bfloat16: "conv12_bf16"}
launches = 0
kernel_launches = {name: 0 for name in KERNEL_OF.values()}


@functools.cache
def _lib(name: str):
    fn = getattr(_build.load(name), f"{name}_forward")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3) -> (3, 3, ci, co) float32, the layout the float32 kernel
    stages (147,456 bytes for 64 channels)."""
    return w.permute(2, 3, 1, 0).to(torch.float32).contiguous()


def pack_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3) bfloat16 -> (3, 3, co, ci) bfloat16, the layout the
    tensor-core kernel stages once per block (73,728 bytes for 64 channels):
    row (tap, co) holds operand B's 64 input channels contiguously."""
    if w.dtype != torch.bfloat16:
        raise TypeError(f"pack_weights_bf16 takes bfloat16 weights, got {w.dtype}")
    return w.permute(2, 3, 0, 1).contiguous()


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
    name = KERNEL_OF[x.dtype]
    wpk = pack_weights(w) if x.dtype == torch.float32 else pack_weights_bf16(w)
    bias = b.to(torch.float32).contiguous()
    fn = _lib(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        rc = fn(x.data_ptr(), wpk.data_ptr(), bias.data_ptr(), y.data_ptr(), n, h, wd, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches += 1
    kernel_launches[name] += 1
    return y

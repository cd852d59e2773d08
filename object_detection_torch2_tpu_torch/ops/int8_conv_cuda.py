"""The int8 convolution on the card, bound with ctypes: csrc/int8_conv.cu, an
implicit GEMM on the int8 tensor cores (wgmma s8, fed by TMA and cp.async
through an mbarrier ring) with the dequantization and bias fused into its
epilogue.

`kernel_launches` counts the kernel's launches: `int8_conv_cuda` adds one each
time it launches it, and nothing else touches it but a caller that resets it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from object_detection_torch2_tpu_torch.ops import _build
from object_detection_torch2_tpu_torch.ops.int8_conv import DTYPES, output_size

K_STEP = 32  # bytes of K of one wgmma step: Cin must be a multiple of it
MODE_OF = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
kernel_launches = 0


@functools.cache
def _lib():
    fn = _build.load("int8_conv").int8_conv_forward
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def int8_conv_cuda(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor | None = None,
                   bias: torch.Tensor | None = None, stride: int = 1, pad: int = 1,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The kernel: x8 (N, Cin, H, W) int8 channels_last, w8 (Cout, kh, kw,
    Cin) int8 contiguous, scale None (raw int32 output) or (Cout,) float32,
    bias None or (Cout,) of `out_dtype` (float32 or bfloat16), all on one CUDA
    device -> (N, Cout, Ho, Wo) channels_last. Launches on the current stream
    and raises on anything else it is given; it copies no input to another
    layout."""
    global kernel_launches
    tensors = [t for t in (x8, w8, scale, bias) if t is not None]
    if x8.device.type != "cuda" or any(t.device != x8.device for t in tensors):
        raise ValueError(f"int8_conv_cuda needs every operand on one CUDA device, got {[t.device for t in tensors]}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"int8_conv_cuda takes int8 x and w, got {x8.dtype} and {w8.dtype}")
    if x8.dim() != 4 or w8.dim() != 4 or w8.shape[3] != x8.shape[1]:
        raise ValueError(f"expected x (N, Cin, H, W) and w (Cout, kh, kw, Cin), got {tuple(x8.shape)}, "
                         f"{tuple(w8.shape)}")
    n, cin, h, w = x8.shape
    cout, kh, kw, _ = w8.shape
    if cin % K_STEP:
        raise ValueError(f"int8_conv_cuda needs Cin a multiple of {K_STEP}, got {cin}")
    if not x8.is_contiguous(memory_format=torch.channels_last) or not w8.is_contiguous():
        raise ValueError("int8_conv_cuda needs a channels_last-contiguous x and a contiguous w")
    if x8.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("int8_conv_cuda needs 16-byte aligned x and w")
    if stride < 1 or pad < 0:
        raise ValueError(f"bad stride {stride} or pad {pad}")
    if scale is None:
        if bias is not None or out_dtype not in (None, torch.int32):
            raise ValueError("the raw mode (scale None) writes int32 and takes no bias")
        out_dtype = torch.int32
    else:
        out_dtype = out_dtype or torch.float32
        if out_dtype not in DTYPES:
            raise TypeError(f"int8_conv_cuda writes float32 or bfloat16, not {out_dtype}")
        if scale.dtype != torch.float32 or tuple(scale.shape) != (cout,) or not scale.is_contiguous():
            raise ValueError(f"expected a contiguous float32 scale ({cout},), got {scale.dtype} {tuple(scale.shape)}")
        if bias is not None and (bias.dtype != out_dtype or tuple(bias.shape) != (cout,) or not bias.is_contiguous()):
            raise ValueError(f"expected a contiguous {out_dtype} bias ({cout},), got {bias.dtype} {tuple(bias.shape)}")
        if scale.data_ptr() % 8 or (bias is not None and bias.data_ptr() % 8):
            raise ValueError("int8_conv_cuda needs 8-byte aligned scale and bias (the epilogue reads them in pairs)")
    ho, wo = output_size(h, w, kh, kw, stride, pad)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output: {h}x{w} input, {kh}x{kw} kernel, stride {stride}, pad {pad}")
    y = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=x8.device, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    fn = _lib()
    with torch.cuda.device(x8.device):
        stream = torch.cuda.current_stream()
        rc = fn(x8.data_ptr(), w8.data_ptr(), None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(), n, h, w, cin, cout, kh, kw, stride, pad,
                MODE_OF[out_dtype], stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {rc}")
    kernel_launches += 1
    return y

"""object_detection_torch2_tpu_torch — the PyTorch/CUDA port of the SSD300
detector in `object_detection_torch2_tpu`.

The JAX package stays the reference: every public function here keeps its
counterpart's layouts (images NHWC uint8, boxes center-form [cx, cy, w, h],
head outputs (N, P, 4+C)) so tests compare like with like. This package imports
torch and numpy only — nothing of JAX and nothing of the JAX package.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`); without a card they raise instead of falling back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card. A CUDA device without a card raises RuntimeError:
    a missing GPU is an error, never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU explicitly"
        )
    return dev


# the dtypes whose convolutions `true_float32` runs off cuDNN
FLOAT_POLICY_DTYPES = (torch.float32, torch.float64)


def true_float32(dtype: torch.dtype | None = torch.float32):
    """The context every path of the port runs its convolutions in, by the
    dtype they run in (`dtype`: the model's; None where none runs in a float
    type). The port's one float32 convolution policy lives here.

    float32 and float64: cuDNN off, TF32 off, so PyTorch's own CUDA
    convolutions run (im2col and a cuBLAS GEMM one image at a time, forward
    and backward). Their sums do not depend on how a batch is split, they
    replay bit for bit, and they round about as the CPU's direct sums do.
    cuDNN's true float32 implicit GEMM rounds 2-5x more at a layer, which put
    the VGG16 golden forward 0.061 from the reference's logits (atol 0.05),
    and its backward does not replay bit for bit (PERF.md).

    Any other dtype (bfloat16; an int8 layer's kernels do not use cuDNN):
    cuDNN's TF32 off, its other flags as the caller left them. float32
    matmuls are full float32 unless a caller switched TF32 matmuls on. The
    context sets cuDNN's global flags: a backward that should follow the
    policy runs inside it too (Trainer's does). On the CPU none of these
    flags changes a result."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled and dtype not in FLOAT_POLICY_DTYPES, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)

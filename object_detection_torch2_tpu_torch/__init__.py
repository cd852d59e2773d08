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


def true_float32():
    """A context in which cuDNN runs float32 convolutions (forward and
    backward) in true float32, as the JAX package's `precision=HIGHEST` does,
    instead of its TF32 default. float32 matmuls are already full float32
    unless a caller switched TF32 matmuls on."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)

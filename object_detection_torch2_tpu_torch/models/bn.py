"""BatchNorm with the semantics of the JAX package's `BatchNormTPU`
(object_detection_torch2_tpu/models/bn.py:46-109), plain layout.

Held against the JAX package, not against torch's own BatchNorm2d, so:
- the batch variance is the single-pass max(E[x^2] - E[x]^2, 0) in float32,
  not torch's two-pass variance;
- `mask` (N,), 1 for real rows, excludes the pad rows of a ragged batch from the
  statistics, so real rows come out as from a ragged-size forward;
- the running statistics are updated (only in `training` mode, with batch
  statistics) with torch's unbiased n/max(n-1, 1) correction and momentum 0.1;
- the math runs in float32 (float64 for a float64 input: the tests' exact
  references) and the output is cast to the compute dtype;
- the output is (x - mean) * (rsqrt(var + eps) * weight) + bias, the form of
  torch's own BatchNorm. The JAX package's x * inv + (bias - mean * inv)
  cancels when |mean| >> std and loses low bits that the deep extras layers
  (batch statistics over 4-36 values per channel at imsize 300) amplify into
  flipped ReLU gates; with this form the port's step-0 training loss equals
  the reference run's (tests/test_torch_trajectory.py).

State keys are torch's (`weight`, `bias`, `running_mean`, `running_var`,
`num_batches_tracked`), so the reference's state_dicts load unchanged. The
TPU's paired-lane `fold` layout is not ported.

Under a data-parallel mesh (`set_mesh`; parallel/mesh.py) the batch
statistics are the GLOBAL batch's, as the JAX package's jitted forward
reduces over the batch sharded across every device: without a mask each
rank's means are weighted by its share (the ranks hold equal slices) and
summed over the ranks (`sync_moments`), so over one rank the sum is the
rank's own mean, bit for bit; with a mask the masked sums and the count are
summed and divided once, as one process does. The backward all-reduces the
incoming gradients of the moments, so the extras' gradients flow through the
global statistics. The count of an unmasked batch stays a host number
(n_local x world): a train step makes no host sync for it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from object_detection_torch2_tpu_torch.parallel.mesh import sync_moments


def _math(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype of BatchNorm's math: float32, or float64 as it is."""
    return x if x.dtype == torch.float64 else x.float()


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.mesh = None  # a parallel.mesh.Mesh: the statistics are the global batch's (set_mesh)

    def forward(self, x: torch.Tensor, use_batch_stats: bool, mask: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
        """x: (N, C, H, W) in any memory format -> same shape in `out_dtype`
        (default: x's dtype)."""
        dims = (0, 2, 3)
        if use_batch_stats:
            xf = _math(x)
            mesh = self.mesh
            if mask is None:
                world = 1 if mesh is None else mesh.world
                # the count is a host number: a tensor made from it on the
                # card would be a blocking copy, a host sync per layer
                n = np.float32(x.numel() // x.shape[1] * world)
                mean = xf.mean(dim=dims)
                mean_sq = xf.square().mean(dim=dims)
                if mesh is not None:
                    mean, mean_sq = sync_moments(torch.stack([mean, mean_sq]) * (1.0 / world), mesh).unbind(0)
            else:
                m = mask.float().reshape(-1, 1, 1, 1)
                count = m.sum() * (x.shape[2] * x.shape[3])
                total = (xf * m).sum(dim=dims)
                total_sq = (xf.square() * m).sum(dim=dims)
                if mesh is not None:
                    c = x.shape[1]
                    flat = sync_moments(torch.cat([total, total_sq, count.reshape(1)]), mesh)
                    total, total_sq, count = flat[:c], flat[c:2 * c], flat[2 * c]
                n = torch.clamp(count, min=1.0)
                inv_n = 1.0 / n
                mean = total * inv_n
                mean_sq = total_sq * inv_n
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
            if self.training:
                with torch.no_grad():
                    # n / max(n - 1, 1) in float32, on the host or the device
                    correction = (float(n / max(n - np.float32(1), np.float32(1))) if mask is None
                                  else n / torch.clamp(n - 1, min=1.0))
                    unbiased = var * correction
                    keep = 1.0 - self.momentum
                    self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                    self.running_var.copy_(keep * self.running_var + self.momentum * unbiased)
                    self.num_batches_tracked += 1
        else:
            mean, var = self.running_mean, self.running_var

        inv = torch.rsqrt(var + self.eps) * self.weight
        out = (_math(x) - mean[None, :, None, None]) * inv[None, :, None, None] + self.bias[None, :, None, None]
        return out.to(out_dtype or x.dtype)


def set_mesh(model: nn.Module, mesh) -> nn.Module:
    """Hand `mesh` (a parallel.mesh.Mesh, or None for one process) to every
    BatchNorm of `model` and to `model` itself (a VGG16 draws its dropout
    masks at the global batch's shape under one); returns `model`."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    model.mesh = mesh
    return model

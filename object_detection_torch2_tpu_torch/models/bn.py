"""BatchNorm with the semantics of the JAX package's `BatchNormTPU`
(object_detection_torch2_tpu/models/bn.py:46-109), plain layout.

Held against the JAX package, not against torch's own BatchNorm2d, so:
- the batch variance is the single-pass max(E[x^2] - E[x]^2, 0), not torch's
  two-pass variance, taken in float64 from the float64 moments and rounded
  once (`batch_variance`). With the subtraction in float32 the trajectory
  golden's step-0 gradient of bn_10_1's bias falls on the other side of a
  near-tie than the reference run's did: 5.5e-3 from the golden, past
  tests/test_torch_trajectory.py's 5e-3 pin (bn_probe.py --step0);
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

The batch moments are per-image float64 partial sums (`ops.bn_moments`: the
kernel csrc/bn_moments.cu on the card, the plain version on the CPU): each
image's sums over (H, W) of x and of its square, in an order that depends on
(C, H, W) and the layout alone, never on the batch. A ragged batch's pad rows
are multiplied by its 0/1 mask (exact). The totals are one sum over the
images of the (N, 2, C) rows in global image order; the mean and the
variance are taken from total / n in float64 and rounded once to float32
(kept in float64 for a float64 input).

Under a data-parallel mesh (`set_mesh`; parallel/mesh.py) the batch
statistics are the GLOBAL batch's, as the JAX package's jitted forward
reduces over the batch sharded across every device: each rank's rows (and
the mask) are gathered exactly into the global (N, 2, C) tensor in global
image order (`gather_rows`), and every rank makes the same sum call on it as
one process does on its whole batch, so the statistics are one process's,
bit for bit, however the batch is split. The backward all-reduces the
gradients of the gathered rows, so the extras' gradients flow through the
global statistics. The count of an unmasked batch stays a host number
(n_local x world): a train step makes no host sync for it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from object_detection_torch2_tpu_torch.ops.bn_moments import bn_moments, math_dtype
from object_detection_torch2_tpu_torch.parallel.mesh import gather_rows


def _math(x: torch.Tensor) -> torch.Tensor:
    """x in the dtype of BatchNorm's math: float32, or float64 as it is."""
    return x.to(math_dtype(x.dtype))


def batch_variance(mean64: torch.Tensor, mean_sq64: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """max(E[x^2] - E[x]^2, 0) from the float64 moments, rounded once to
    `dtype` (bn_probe.py --step0 measures the float32 form against it)."""
    return torch.clamp(mean_sq64 - mean64.square(), min=0.0).to(dtype)


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
        if use_batch_stats:
            mesh = self.mesh
            parts = bn_moments(x)  # (n, 2, C) float64: each image's sums of x and of its square
            if mask is None:
                if mesh is not None:
                    parts = gather_rows(parts, mesh)
                # the count is a host number: a tensor made from it on the
                # card would be a blocking copy, a host sync per layer
                n = np.float32(len(parts) * x.shape[2] * x.shape[3])
                moments = parts.sum(dim=0) / float(n)
            else:
                m = mask.to(torch.float64)
                parts = parts * m[:, None, None]
                if mesh is not None:
                    c = x.shape[1]
                    flat = gather_rows(torch.cat([parts.reshape(len(m), 2 * c), m[:, None]], dim=1), mesh)
                    parts, m = flat[:, :2 * c].reshape(-1, 2, c).contiguous(), flat[:, 2 * c]
                n = torch.clamp((m.sum() * (x.shape[2] * x.shape[3])).float(), min=1.0)
                moments = parts.sum(dim=0) / n.double()
            mean64, mean_sq64 = moments.unbind(0)
            mean = mean64.to(math_dtype(x.dtype))
            var = batch_variance(mean64, mean_sq64, mean.dtype)
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

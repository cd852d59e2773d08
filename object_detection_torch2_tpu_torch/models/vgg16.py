"""VGG16-bn classifier as a torch `nn.Module`
(counterpart of object_detection_torch2_tpu/models/vgg16.py:34-159; reference:
src/model/vgg16.py).

- the conv cfg [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M_P', 512, 512,
  512, 'M', 512, 512, 512, 'M_P'], each conv followed by BatchNorm and ReLU,
  named `features.conv_L_S` / `features.bn_L_S` as the SSD's trunk is, so
  that its weights seed an SSD layer for layer; 'M_P' is MaxPool2d(2, 2,
  padding=1), padded with -inf (reference: vgg16.py:25-30);
- the NCHW, C-major flatten of the reference (vgg16.py:96), then two heads of
  three linears with ReLU and dropout between them: the 1000-way
  `classifier_fc1..3` and the `num_classes`-way `classifier2_fc1..3` of
  transfer learning. Both are in the state_dict; `forward` runs only the one
  `transfer_learning` selects (reference: vgg16.py:42-61, 97-100);
- BatchNorm is the port's (models/bn.py: the JAX package's statistics) and
  the image normalization is the SSD's (`models.ssd.normalize_image`).

Dropout draws its masks from an explicit `torch.Generator` (the `generator`
argument of `forward`), so that a training step is a function of its seed and
step (train/trainer.py); it keeps each unit with probability 1 - p and scales
the kept ones by 1 / (1 - p), as flax's `nn.Dropout` does. Its masks are not
the JAX package's: the frameworks' generators differ.

Numerics, as `SSD`'s: convolutions and linears run in `dtype` (float32 in
true float32, TF32 off, as `precision=HIGHEST`), BatchNorm math in float32,
the logits come out in float32. Convolutions and linears run on cuDNN and
cuBLAS on the card: the JAX VGG16 runs no Pallas kernel. Activations are
channels_last on the card, where cuDNN runs that layout natively, and
contiguous NCHW on the CPU, the layout of the reference's torch run, whose
sums oneDNN's NCHW kernels take in the same order: under the golden's
weights the eval logits (up to 2.7e4) differ from it by 0.031 (8 float32
ulps) in NCHW and by 0.066 in channels_last (tests/test_torch_vgg.py).

Quirk Q10: the heads expect a 7x7x512 grid (Linear(512*7*7, 4096)), but with
the padded pools no standard imsize gives 7x7 (300 gives 10x10, 224 gives
8x8). Only an imsize of about 184-215 does; the working size is 200.

`vgg_trainable_predicate` and `cross_entropy` (quirk Q2) are the JAX
package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from object_detection_torch2_tpu_torch import true_float32
from object_detection_torch2_tpu_torch.models.bn import BatchNorm, set_mesh  # noqa: F401
from object_detection_torch2_tpu_torch.models.ssd import DTYPES, normalize_image

VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M_P", 512, 512, 512, "M", 512, 512, 512, "M_P")
HEAD_WIDTHS = (4096, 4096)
GRID = 7  # the heads' input grid: 512 x 7 x 7


def canonical_conv_names(cfg=VGG_CFG):
    """[('conv_L_S', channels) | ('pool_L', pad)] walking the cfg, the names
    the SSD gives the trunk (reference: ssd.py:27-44)."""
    block, sub = 1, 1
    out = []
    for v in cfg:
        if v in ("M", "M_P"):
            out.append((f"pool_{block}", 1 if v == "M_P" else 0))
            block += 1
            sub = 1
        else:
            out.append((f"conv_{block}_{sub}", v))
            sub += 1
    return out


def dropout(x: torch.Tensor, p: float, generator: torch.Generator, total: int | None = None,
            offset: int = 0) -> torch.Tensor:
    """Keep each element with probability 1 - p (a uniform draw of
    `generator` >= p) and scale the kept ones by 1 / (1 - p). total / offset:
    x holds rows [offset, offset + N) of a batch of `total` rows (a rank's
    slice under a data-parallel mesh): the draws are made at the whole
    batch's shape and these rows' are kept, as one process draws them."""
    if p >= 1.0:
        return torch.zeros_like(x)
    if total is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32) >= p
    else:
        keep = torch.rand((total, *x.shape[1:]), generator=generator, device=x.device,
                          dtype=torch.float32)[offset:offset + x.shape[0]] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class VGG16(nn.Module):
    """Input (N, H, W, 3) in [0, 1]; output (N, 1000) or (N, num_classes)
    float32 logits.

    Weights are drawn from `torch.Generator().manual_seed(seed)` on the CPU,
    as torchvision's VGG does: kaiming-normal fan_out convs, normal(0, 0.01)
    linears, zero biases, unit BatchNorm. The JAX package's `PRNGKey` init
    cannot be reproduced in torch, so the two packages' untrained models
    differ."""

    def __init__(self, num_classes: int = 20, transfer_learning: bool = False, dropout_rate: float = 0.5,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        if dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.num_classes = num_classes
        self.transfer_learning = transfer_learning
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.mesh = None  # a parallel.mesh.Mesh (models.bn.set_mesh): dropout drawn at the global batch's shape
        self.layers = canonical_conv_names()
        self.features = nn.ModuleDict()
        cin = 3
        for name, arg in self.layers:
            if name.startswith("conv_"):
                self.features[name] = nn.Conv2d(cin, arg, 3, padding=1)
                self.features[f"bn{name[4:]}"] = BatchNorm(arg)
                cin = arg
        for head, out in (("classifier", 1000), ("classifier2", num_classes)):
            widths = (cin * GRID * GRID, *HEAD_WIDTHS, out)
            for i in range(3):
                self.add_module(f"{head}_fc{i + 1}", nn.Linear(widths[i], widths[i + 1]))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=g)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=g)
                nn.init.zeros_(m.bias)

    def head_names(self, head: str) -> list[str]:
        return [f"{head}_fc{i}" for i in (1, 2, 3)]

    def forward(self, x: torch.Tensor, train: bool = True, use_batch_stats: bool | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """`train` switches dropout on, drawn from `generator` (required then,
        unless dropout_rate is 0); `use_batch_stats` (default: `train`)
        normalizes with batch statistics. Running statistics are updated only
        in `training` mode with batch statistics, as `SSD`'s are."""
        if use_batch_stats is None:
            use_batch_stats = train
        drop = train and self.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError("a training forward with dropout needs a generator")
        with true_float32():
            n = x.shape[0]
            mesh = self.mesh
            rows = () if mesh is None else (n * mesh.world, n * mesh.rank)
            # NHWC -> NCHW: a view with channels_last strides on the card
            x = normalize_image(x).permute(0, 3, 1, 2).to(self.dtype)
            if x.device.type == "cpu":
                x = x.contiguous()
            for name, arg in self.layers:
                if name.startswith("pool_"):
                    x = F.max_pool2d(x, 2, 2, padding=arg)
                    continue
                conv = self.features[name]
                x = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), padding=1)
                x = F.relu(self.features[f"bn{name[4:]}"](x, use_batch_stats, out_dtype=self.dtype))
            x = x.contiguous().reshape(n, -1)  # C-major, as torch flattens NCHW
            head = "classifier2" if self.transfer_learning else "classifier"
            for i, name in enumerate(self.head_names(head)):
                fc = getattr(self, name)
                x = F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype))
                if i < 2:
                    x = F.relu(x)
                    if drop:
                        x = dropout(x, self.dropout_rate, generator, *rows)
        return x.to(torch.float32)


def vgg_trainable_predicate(transfer_learning: bool):
    """Trainable-parameter predicate for classification training: everything
    except the UNSELECTED head. torch's Adam skips a parameter whose grad
    stays None, and the head `forward` does not run never gets one, so the
    reference would never update or decay it; leaving it out of the
    optimizer matches that and allocates no moments for its ~123M weights."""
    dead = "classifier_" if transfer_learning else "classifier2_"

    def is_trainable(name: str) -> bool:
        return not name.startswith(dead)

    return is_trainable


def cross_entropy(outputs: torch.Tensor, targets: torch.Tensor, parity_sign: bool = False) -> torch.Tensor:
    """Softmax cross-entropy, mean over the batch. The reference's VGG16.loss
    is `sum(targets * log_softmax).mean()`, missing the minus sign (quirk Q2,
    reference: vgg16.py:117-129); `parity_sign=True` reproduces that value,
    the default is the proper cross-entropy."""
    ll = torch.sum(targets * torch.log_softmax(outputs, dim=-1), dim=-1).mean()
    return ll if parity_sign else -ll

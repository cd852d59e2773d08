"""Batched train-time augmentation and the eval-time conversion
(counterpart of object_detection_torch2_tpu/data/augment.py:35-225).

The chain is the JAX package's, on the whole uint8 batch on its device:

- RandomColorJitter(p=0.5, brightness/contrast/saturation=0.5, hue=0.5):
  per-sample factors and coin, one random op order per BATCH (reference:
  src/augmentation/random.py:6-14);
- RandomFlip(p=0.5): hflip and the GT reflection cx -> 1 - cx on real rows
  (w * h > 0) only (reference: src/augmentation/random.py:17-30);
- ToTensor scaling to [0, 1] (reference: src/augmentation/to_tensor.py);
- RandomErasing(p=0.5, scale=(0.01, 0.04), ratio=(0.5, 2), max_iter=3),
  1..max_iter rectangles, one `where` over the OR of their masks, GT
  untouched (reference: src/augmentation/random.py:33-42).

It is split in two so that the random values can come from anywhere (the
tests feed the JAX package's own draws):

- `sample_augment_draws` returns every random value the chain uses, drawn
  from an explicit CPU `torch.Generator`. The op order is a host int, so
  choosing the branch never waits on the device;
- `apply_augment` is a deterministic function of the images, the GTs and
  those draws, on the images' device.

`augment_batch` composes them. Numerics follow what XLA compiles the JAX
package's functions into: a division by a float32 constant becomes a
multiplication by its float32 reciprocal (`x / 255`, hue `/ 6`), the uint8
scaling is done in float32 and rounded once to the compute dtype, the
grayscale is a float32 sum of the three channels rounded once, and the
contrast mean is reduced in float32. The chain is plain PyTorch; on the card
it runs as many small elementwise kernels, one after another.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace

import numpy as np
import torch

GRAY_WEIGHTS = (0.2989, 0.587, 0.114)  # torchvision rgb_to_grayscale

PERMS = tuple(itertools.permutations(range(4)))  # 24 jitter-op orders
JITTER_STRENGTH = 0.5  # brightness/contrast/saturation (reference: src/augmentation/random.py:6-14)

# XLA compiles the JAX package's `x / 255.0` and `(h / 6.0)` into
# multiplications by the float32 reciprocal; multiplying by the same
# constants keeps the port bit-equal.
INV_255 = float(np.float32(1.0) / np.float32(255.0))
INV_6 = float(np.float32(1.0) / np.float32(6.0))


def to_tensor_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> float32 in [0, 1] (reference ToTensor semantics),
    bit-equal to the JAX package."""
    return images_u8.to(torch.float32) * INV_255


def to_unit_range(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 -> `dtype` in [0, 1]: x * float32(1/255) rounded once to `dtype`,
    which equals the JAX package's `x.astype(dtype) / dtype(255)` for every
    uint8 value in float32 and in bfloat16."""
    return to_tensor_batch(images_u8).to(dtype)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    v = maxc
    d = maxc - minc
    pos = maxc > 0
    s = torch.where(pos, d / torch.where(pos, maxc, torch.ones_like(maxc)), torch.zeros_like(maxc))
    safe_d = torch.where(d > 0, d, torch.ones_like(d))
    rc = (maxc - r) / safe_d
    gc = (maxc - g) / safe_d
    bc = (maxc - b) / safe_d
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(d > 0, torch.remainder(h * INV_6, 1.0), torch.zeros_like(h))
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)  # a floor modulo, as jnp's
    # jnp.select takes the first condition that holds: the chain of wheres is
    # built from the last case inwards so that case 0 wins over the others
    sel = [i == k for k in range(6)]

    def select(cases):
        out = torch.zeros_like(v)
        for cond, val in reversed(list(zip(sel, cases))):
            out = torch.where(cond, val, out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def grayscale(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) in img's type: the three channels times the weights
    (rounded to img's type) summed in float32, one rounding."""
    w = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype).tolist()
    f = img.float()
    return (f[..., 0] * w[0] + f[..., 1] * w[1] + f[..., 2] * w[2]).to(img.dtype)


def _per_sample(f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return f.to(dtype)[:, None, None, None]


# Batched jitter ops; factor f: (N,) float32, broadcast over (N, H, W, C) and
# cast to the image's type at use, as the JAX package does.
def adjust_brightness(img, f):
    return torch.clamp(img * _per_sample(f, img.dtype), 0.0, 1.0)


def adjust_contrast(img, f):
    # the per-image mean of the grayscale is reduced in float32
    mean = grayscale(img).float().mean(dim=(1, 2))
    add = _per_sample((1.0 - f) * mean, img.dtype)
    return torch.clamp(_per_sample(f, img.dtype) * img + add, 0.0, 1.0)


def adjust_saturation(img, f):
    gray = grayscale(img)[..., None]
    f = _per_sample(f, img.dtype)
    return torch.clamp(f * img + (1.0 - f) * gray, 0.0, 1.0)


def adjust_hue(img, delta):
    hsv = rgb_to_hsv(img)
    h = torch.remainder(hsv[..., 0] + delta.to(img.dtype)[:, None, None], 1.0)
    return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


@dataclass
class AugmentDraws:
    """Every random value of one batch's augment chain. Tensors are (N,) per
    sample, or (max_iter, N) per erase iteration; a part whose probability is
    0 has None there and is skipped.

    jitter: the jitter coin (bool); order: index into `PERMS` (a host int);
    fb, fc, fs: brightness, contrast and saturation factors (float32); dh: hue
    shift (float32); flip: the flip coin (bool); erase: per iteration whether
    the rectangle is erased (bool, the coin and iteration < the sample's
    count); rect: (max_iter, N, 4) int32 rows (top, left, eh, ew)."""

    jitter: torch.Tensor | None = None
    order: int = 0
    fb: torch.Tensor | None = None
    fc: torch.Tensor | None = None
    fs: torch.Tensor | None = None
    dh: torch.Tensor | None = None
    flip: torch.Tensor | None = None
    erase: torch.Tensor | None = None
    rect: torch.Tensor | None = None

    def to(self, device) -> "AugmentDraws":
        """The draws on `device`; host-to-device copies do not wait."""
        moved = {k: getattr(self, k).to(device, non_blocking=True)
                 for k in ("jitter", "fb", "fc", "fs", "dh", "flip", "erase", "rect")
                 if getattr(self, k) is not None}
        return replace(self, **moved)

    def rows(self, lo: int, hi: int) -> "AugmentDraws":
        """The draws of images [lo, hi) of the batch (the batch axis is the
        last per-image axis: axis 0 of the (N,) draws, axis 1 of `erase` and
        `rect`); `order` is the batch's."""
        sliced = {k: getattr(self, k)[lo:hi] for k in ("jitter", "fb", "fc", "fs", "dh", "flip")
                  if getattr(self, k) is not None}
        sliced.update({k: getattr(self, k)[:, lo:hi] for k in ("erase", "rect") if getattr(self, k) is not None})
        return replace(self, **sliced)


def sample_augment_draws(generator: torch.Generator, n: int, h: int, w: int, p_jitter: float = 0.5,
                         p_flip: float = 0.5, p_erase: float = 0.5, max_iter: int = 3,
                         hue: float = 0.5) -> AugmentDraws:
    """The draws of one batch of `n` (h, w) images from `generator` (a CPU
    generator), in the distributions of the JAX package's `augment_batch`:
    brightness, contrast and saturation factors U(1 - 0.5, 1 + 0.5), the hue
    shift U(-hue, hue).
    The erase rectangle follows its arithmetic in float32: area = U(0.01,
    0.04)*h*w, ratio = exp(U(log 0.5, log 2)), eh/ew = clip(round(sqrt(area *
    or / ratio)), 1, h or w), top/left = trunc(U * max(h - eh, 1))."""

    def uniform(lo=0.0, hi=1.0, shape=(n,)):
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return u * (hi - lo) + lo

    draws = AugmentDraws()
    if p_jitter > 0:
        draws.jitter = uniform() < p_jitter
        draws.order = int(torch.randint(len(PERMS), (), generator=generator))
        draws.fb, draws.fc, draws.fs = (uniform(1 - JITTER_STRENGTH, 1 + JITTER_STRENGTH) for _ in range(3))
        draws.dh = uniform(-hue, hue)
    if p_flip > 0:
        draws.flip = uniform() < p_flip
    if p_erase > 0:
        n_iter = torch.randint(1, max_iter + 1, (n,), generator=generator)
        shape = (max_iter, n)
        draws.erase = (uniform(shape=shape) < p_erase) & (torch.arange(max_iter)[:, None] < n_iter[None, :])
        area = uniform(0.01, 0.04, shape) * h * w
        ratio = torch.exp(uniform(float(np.log(0.5)), float(np.log(2.0)), shape))
        eh = torch.clamp(torch.round(torch.sqrt(area * ratio)).to(torch.int32), 1, h)
        ew = torch.clamp(torch.round(torch.sqrt(area / ratio)).to(torch.int32), 1, w)
        top = (uniform(shape=shape) * torch.clamp(h - eh, min=1)).to(torch.int32)
        left = (uniform(shape=shape) * torch.clamp(w - ew, min=1)).to(torch.int32)
        draws.rect = torch.stack([top, left, eh, ew], dim=-1)
    return draws


def _color_jitter(img: torch.Tensor, draws: AugmentDraws) -> torch.Tensor:
    ops = (
        lambda x: adjust_brightness(x, draws.fb),
        lambda x: adjust_contrast(x, draws.fc),
        lambda x: adjust_saturation(x, draws.fs),
        lambda x: adjust_hue(x, draws.dh),
    )
    jittered = img
    for op in PERMS[draws.order]:
        jittered = ops[op](jittered)
    return torch.where(draws.jitter[:, None, None, None], jittered, img)


def _erase_mask(draws: AugmentDraws, h: int, w: int, device) -> torch.Tensor:
    """(N, H, W) bool: the OR of every erased rectangle of each image."""
    rows = torch.arange(h, device=device)[None, :]
    cols = torch.arange(w, device=device)[None, :]
    any_mask = None
    for do, rect in zip(draws.erase, draws.rect):
        top, left, eh, ew = rect.unbind(-1)
        row_mask = (rows >= top[:, None]) & (rows < (top + eh)[:, None]) & do[:, None]  # (N, H)
        col_mask = (cols >= left[:, None]) & (cols < (left + ew)[:, None])  # (N, W)
        mask = row_mask[:, :, None] & col_mask[:, None, :]
        any_mask = mask if any_mask is None else any_mask | mask
    return any_mask


def apply_augment(images_u8: torch.Tensor, gts: torch.Tensor, draws: AugmentDraws,
                  dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """images_u8 (N, H, W, 3) uint8, gts (N, G, 4 + C) or (N, C) float32, draws
    of this batch (on the images' device, or moved there) -> (`dtype` images
    in [0, 1], gts with cx reflected on the flipped images' real rows). Color
    jitter, then flip, then erase, as the JAX package's `augment_batch`."""
    device = images_u8.device
    draws = draws.to(device)
    n, h, w, _ = images_u8.shape
    img = to_unit_range(images_u8, dtype)
    if draws.jitter is not None:
        img = _color_jitter(img, draws)
    if draws.flip is not None:
        img = torch.where(draws.flip[:, None, None, None], img.flip(2), img)
        if gts.dim() == 3:  # detection GT: reflect real (nonzero) rows only
            real = gts[..., 2] * gts[..., 3] > 0
            cx = torch.where(real & draws.flip[:, None], 1.0 - gts[..., 0], gts[..., 0])
            gts = torch.cat([cx[..., None], gts[..., 1:]], dim=-1)
    if draws.erase is not None:
        img = torch.where(_erase_mask(draws, h, w, device)[..., None], torch.zeros((), dtype=dtype, device=device),
                          img)
    return img, gts


def augment_batch(generator: torch.Generator, images_u8: torch.Tensor, gts: torch.Tensor, p_jitter: float = 0.5,
                  p_flip: float = 0.5, p_erase: float = 0.5, max_iter: int = 3, hue: float = 0.5,
                  dtype: torch.dtype = torch.float32, total: int | None = None, offset: int = 0):
    """`apply_augment` of `sample_augment_draws(generator, ...)`: the batched
    train-time augmentation. hue: hue-jitter half-range (reference parity 0.5
    is a full rotation; --train_aug reduced_hue uses 0.05).

    total / offset: the images are rows [offset, offset + N) of a batch of
    `total` (a rank's slice of the global batch under a data-parallel mesh):
    the draws are made for all `total` rows and these rows' are kept, so the
    ranks together draw what one process draws for the whole batch."""
    n, h, w, _ = images_u8.shape
    draws = sample_augment_draws(generator, n if total is None else total, h, w, p_jitter=p_jitter,
                                 p_flip=p_flip, p_erase=p_erase, max_iter=max_iter, hue=hue)
    if total is not None:
        draws = draws.rows(offset, offset + n)
    return apply_augment(images_u8, gts, draws, dtype)

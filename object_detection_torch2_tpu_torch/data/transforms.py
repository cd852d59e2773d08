"""Host-side paired (image, gt) transforms — reference API parity
(copy of object_detection_torch2_tpu/data/transforms.py:1-159; numpy only).

Mirrors the reference's `augmentation` package surface (reference:
src/augmentation/__init__.py, compose.py, random.py, to_tensor.py): `Compose`
chains `t(img, gt)`; `RandomColorJitter`, `RandomFlip`, `ToTensor`,
`RandomErasing` match the reference's defaults and distributions. These numpy
implementations exist for API compatibility and host-side testing; the
training input path applies the same distributions to the whole batch on the
device (data/augment.py). Given the same `np.random.Generator`, each class
gives what the JAX package's does, bit for bit.

Divergence note (quirk Q11, found in this rebuild): the reference's RandomFlip
does `gt[:, 0] = 1 - gt[:, 0]` unconditionally, which CRASHES on the 1-D
classification one-hot gt — classification training with the reference's own
train.py augmentation list is broken. Here the reflection applies only to 2-D
detection GTs.
"""

from __future__ import annotations

import numpy as np

GRAY_WEIGHTS = np.asarray((0.2989, 0.587, 0.114), np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, gt):
        for t in self.transforms:
            img, gt = t(img, gt)
        return img, gt


class ToTensor:
    """uint8 HWC [0,255] -> float32 HWC [0,1] (reference keeps CHW; NHWC is TPU-native)."""

    def __call__(self, img, gt):
        return np.asarray(img, np.float32) / 255.0, gt


class RandomFlip:
    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, gt):
        if self.rng.uniform() < self.p:
            img = np.ascontiguousarray(img[:, ::-1])
            gt = np.array(gt, copy=True)
            if gt.ndim == 2:  # detection GT only (Q11)
                real = gt[:, 2] * gt[:, 3] > 0
                gt[real, 0] = 1.0 - gt[real, 0]
        return img, gt


def _to_float(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0, True
    return img.astype(np.float32), False


def _from_float(img, was_uint8):
    if was_uint8:
        return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)
    return img


class RandomColorJitter:
    """torchvision ColorJitter distributions: uniform factors, random op order
    (reference: src/augmentation/random.py:6-14 with b/c/s/h all 0.5)."""

    def __init__(self, p=0.5, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.5, rng=None):
        self.p = p
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random.default_rng()

    def _gray(self, img):
        return img @ GRAY_WEIGHTS

    def __call__(self, img, gt):
        if self.rng.uniform() >= self.p:
            return img, gt
        img, was_uint8 = _to_float(img)
        ops = list(self.rng.permutation(4))
        fb = self.rng.uniform(1 - self.brightness, 1 + self.brightness)
        fc = self.rng.uniform(1 - self.contrast, 1 + self.contrast)
        fs = self.rng.uniform(1 - self.saturation, 1 + self.saturation)
        dh = self.rng.uniform(-self.hue, self.hue)
        for op in ops:
            if op == 0:
                img = np.clip(img * fb, 0, 1)
            elif op == 1:
                img = np.clip(fc * img + (1 - fc) * self._gray(img).mean(), 0, 1)
            elif op == 2:
                img = np.clip(fs * img + (1 - fs) * self._gray(img)[..., None], 0, 1)
            else:
                img = self._adjust_hue(img, dh)
        return _from_float(img, was_uint8), gt

    @staticmethod
    def _adjust_hue(img, delta):
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        maxc = img.max(-1)
        minc = img.min(-1)
        v = maxc
        d = maxc - minc
        safe_d = np.where(d > 0, d, 1.0)
        s = np.where(maxc > 0, d / np.where(maxc > 0, maxc, 1.0), 0.0)
        # hue sextant from the max channel
        rc = (maxc - r) / safe_d
        gc = (maxc - g) / safe_d
        bc = (maxc - b) / safe_d
        h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
        h = np.where(d > 0, (h / 6.0) % 1.0, 0.0)
        h = (h + delta) % 1.0
        i = np.floor(h * 6.0)
        f = h * 6.0 - i
        p = v * (1.0 - s)
        q = v * (1.0 - s * f)
        t = v * (1.0 - s * (1.0 - f))
        i = i.astype(np.int32) % 6
        r = np.choose(i, [v, q, p, p, t, v])
        g = np.choose(i, [t, v, v, q, p, p])
        b = np.choose(i, [p, p, t, v, v, q])
        return np.stack([r, g, b], axis=-1)


class RandomErasing:
    """Reference defaults: p=0.5, scale=(0.01, 0.04), ratio=(0.5, 2), applied
    1..max_iter times on the tensor, value 0, gt untouched
    (reference: src/augmentation/random.py:33-42)."""

    def __init__(self, p=0.5, scale=(0.01, 0.04), ratio=(0.5, 2.0), max_iter=1, rng=None):
        self.p = p
        self.scale = scale
        self.ratio = ratio
        self.max_iter = max_iter
        self.rng = rng or np.random.default_rng()

    def __call__(self, img, gt):
        img = np.array(img, copy=True)
        h, w = img.shape[0], img.shape[1]
        n_iter = int(self.rng.integers(1, self.max_iter + 1))
        for _ in range(n_iter):
            if self.rng.uniform() >= self.p:
                continue
            area = self.rng.uniform(*self.scale) * h * w
            r = float(np.exp(self.rng.uniform(np.log(self.ratio[0]), np.log(self.ratio[1]))))
            eh = int(np.clip(round(np.sqrt(area * r)), 1, h))
            ew = int(np.clip(round(np.sqrt(area / r)), 1, w))
            top = int(self.rng.integers(0, max(h - eh, 1)))
            left = int(self.rng.integers(0, max(w - ew, 1)))
            img[top : top + eh, left : left + ew] = 0
        return img, gt

"""The port's augment chain (data/augment.py), its copy of data/transforms.py
and the Trainer's augmented steps, against the JAX package on the CPU.

The JAX package's `augment_batch` draws its random values inside; the test
derives the same values from the same key by repeating its key splits
(object_detection_torch2_tpu/data/augment.py:200-205, 110-114, 130, 151-166)
and feeds them to the port's `apply_augment`. Tolerances on pixels: float32
max |d| <= 2e-6 (XLA on the CPU contracts a*b + c into fused multiply-adds,
PyTorch rounds the product, so single values differ by an ulp or two);
bfloat16 within 1 bfloat16 ulp (on the CPU the two agree bit for bit).
Masks and GTs are bit-equal. The augmented Trainer's K-steps equality and
eval_step, port only, are marked `slow`: chip_smoke.py's `phase_moved_training`
holds them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.data import augment as jax_augment
from object_detection_torch2_tpu.data import transforms as jax_transforms
from object_detection_torch2_tpu.utils.testing import synth_targets
from object_detection_torch2_tpu_torch.core import anchors
from object_detection_torch2_tpu_torch.data import augment, transforms
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
from object_detection_torch2_tpu_torch.train.trainer import Trainer, step_generator

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
N, H, W = 4, 40, 56
F32_ATOL = 2e-6


def _images(seed, n=N, h=H, w=W):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _gts(seed, n=N):
    """Detection GTs with zero rows (not real) after the real ones."""
    rng = np.random.default_rng(seed)
    return synth_targets(rng, n, rng.integers(0, 5, n), g_pad=6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_unit(images, jdt):
    """The JAX package's scaling as augment_batch compiles it (under jit)."""
    return jax.jit(lambda u: u.astype(jdt) / jnp.asarray(255.0, jdt))(jnp.asarray(images))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _assert_close(got, want, dtype):
    """float32: max |d| <= 2e-6; bfloat16: within 1 ulp of want's magnitude."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= F32_ATOL, d.max()
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert (d <= ulp).all(), (d / ulp).max()


def jax_draws(key, n, h, w, p_jitter=0.5, p_flip=0.5, p_erase=0.5, max_iter=3, hue=0.5):
    """The random values of the JAX package's augment_batch(key, ...), as the
    port's AugmentDraws."""
    k_jp, k_j, k_fp, k_e = jax.random.split(key, 4)
    d = augment.AugmentDraws()
    if p_jitter > 0:
        d.jitter = _t(jax.random.uniform(k_jp, (n,)) < p_jitter)
        k_order, k_b, k_c, k_s, k_h = jax.random.split(k_j, 5)
        d.fb, d.fc, d.fs = (_t(jax.random.uniform(k, (n,), minval=0.5, maxval=1.5))
                            for k in (k_b, k_c, k_s))
        d.dh = _t(jax.random.uniform(k_h, (n,), minval=-hue, maxval=hue))
        d.order = int(jax.random.randint(k_order, (), 0, len(augment.PERMS)))
    if p_flip > 0:
        d.flip = _t(jax.random.uniform(k_fp, (n,)) < p_flip)
    if p_erase > 0:
        k_iter, k_rest = jax.random.split(k_e)
        n_iter = jax.random.randint(k_iter, (n,), 1, max_iter + 1)
        dos, rects = [], []
        for i in range(max_iter):
            k_p, k_a, k_r, k_t, k_l = jax.random.split(jax.random.fold_in(k_rest, i), 5)
            dos.append((jax.random.uniform(k_p, (n,)) < p_erase) & (i < n_iter))
            area = jax.random.uniform(k_a, (n,), minval=0.01, maxval=0.04) * h * w
            r = jnp.exp(jax.random.uniform(k_r, (n,), minval=jnp.log(0.5), maxval=jnp.log(2.0)))
            eh = jnp.clip(jnp.round(jnp.sqrt(area * r)).astype(jnp.int32), 1, h)
            ew = jnp.clip(jnp.round(jnp.sqrt(area / r)).astype(jnp.int32), 1, w)
            top = (jax.random.uniform(k_t, (n,)) * jnp.maximum(h - eh, 1)).astype(jnp.int32)
            left = (jax.random.uniform(k_l, (n,)) * jnp.maximum(w - ew, 1)).astype(jnp.int32)
            rects.append(jnp.stack([top, left, eh, ew], -1))
        d.erase, d.rect = _t(jnp.stack(dos)), _t(jnp.stack(rects))
    return d


# ------------------------------------------------------------- elementwise ops


@pytest.mark.parametrize("dtype", DTYPES)
def test_scaling_of_every_uint8_value(dtype):
    """x * float32(1/255) rounded once equals the JAX package's compiled
    `x.astype(dtype) / dtype(255)` for all 256 values in both dtypes;
    bfloat16's own product x_bf16 * bf16(1/255) would not."""
    tdt, jdt = DTYPES[dtype]
    values = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = augment.to_unit_range(torch.from_numpy(values), tdt)
    want = _jax_unit(values, jdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(want))
    if dtype == "bfloat16":
        naive = torch.from_numpy(values).to(tdt) * torch.tensor(1 / 255, dtype=tdt)
        assert not torch.equal(naive, got)


def test_hue_uses_the_float32_reciprocal_of_6():
    """XLA compiles the hue's `h / 6.0` into h * float32(1/6): the port's hue
    equals the JAX package's on every one of 49,152 random pixels."""
    rgb = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32))
    got = augment.rgb_to_hsv(rgb)[..., 0].numpy()
    want = np.asarray(jax.jit(jax_augment.rgb_to_hsv)(jnp.asarray(rgb.numpy()))[..., 0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hsv_round_trip_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    images = _images(1)
    ji = _jax_unit(images, jdt)
    ti = augment.to_unit_range(torch.from_numpy(images), tdt)
    hsv = augment.rgb_to_hsv(ti)
    np.testing.assert_array_equal(_f32(hsv), _f32(jax.jit(jax_augment.rgb_to_hsv)(ji)))
    back = augment.hsv_to_rgb(hsv)
    _assert_close(back, jax.jit(lambda x: jax_augment.hsv_to_rgb(jax_augment.rgb_to_hsv(x)))(ji), dtype)
    if dtype == "float32":
        _assert_close(back, ti, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", ["adjust_brightness", "adjust_contrast", "adjust_saturation", "adjust_hue"])
def test_adjust_op_matches_jax(op, dtype):
    tdt, jdt = DTYPES[dtype]
    images = _images(2)
    rng = np.random.default_rng(3)
    arg = (rng.uniform(-0.5, 0.5, N) if op == "adjust_hue" else rng.uniform(0.5, 1.5, N)).astype(np.float32)
    got = getattr(augment, op)(augment.to_unit_range(torch.from_numpy(images), tdt), torch.from_numpy(arg))
    want = jax.jit(getattr(jax_augment, op))(_jax_unit(images, jdt), jnp.asarray(arg))
    assert got.dtype == tdt
    _assert_close(got, want, dtype)


def test_hsv_select_takes_the_first_case():
    """Every hue sextant, its boundaries and h = 1.0 (i = 6 -> 0) map as
    jnp.select does."""
    h = np.concatenate([np.arange(13) / 12.0, [0.999999, 1.0]]).astype(np.float32)
    hsv = np.stack([h, np.full_like(h, 0.7), np.full_like(h, 0.9)], -1)[None]
    got = augment.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    want = np.asarray(jax.jit(jax_augment.hsv_to_rgb)(jnp.asarray(hsv)))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("order", range(24))
def test_op_order_matches_jax(order):
    """Each of the 24 jitter-op orders, every sample jittered, both dtypes."""
    images = _images(10 + order, n=2, h=16, w=24)
    rng = np.random.default_rng(order)
    f = [torch.from_numpy(rng.uniform(0.5, 1.5, 2).astype(np.float32)) for _ in range(3)]
    dh = torch.from_numpy(rng.uniform(-0.5, 0.5, 2).astype(np.float32))
    draws = augment.AugmentDraws(jitter=torch.ones(2, dtype=torch.bool), order=order, fb=f[0], fc=f[1], fs=f[2],
                                 dh=dh)
    jops = (jax_augment.adjust_brightness, jax_augment.adjust_contrast, jax_augment.adjust_saturation,
            jax_augment.adjust_hue)
    jargs = [jnp.asarray(a.numpy()) for a in (*f, dh)]

    def jax_chain(x, jargs):
        for op in augment.PERMS[order]:
            x = jops[op](x, jargs[op])
        return x

    for dtype, (tdt, jdt) in DTYPES.items():
        got = augment._color_jitter(augment.to_unit_range(torch.from_numpy(images), tdt), draws)
        _assert_close(got, jax.jit(jax_chain)(_jax_unit(images, jdt), jargs), dtype)


# ------------------------------------------------------------ the whole chain


# an orthogonal array over (p, hue, dtype): every pair of two factors' values
# is a case, at half the JAX compiles of all eight combinations
@pytest.mark.parametrize("p,hue,dtype", [(1.0, 0.5, "float32"), (1.0, 0.05, "bfloat16"), (0.5, 0.5, "bfloat16"),
                                         (0.5, 0.05, "float32")])
def test_apply_augment_on_jax_draws_matches_augment_batch(p, hue, dtype):
    """Eight keys each: the JAX package's augment_batch(key) against the
    port's apply_augment of the same draws; GTs bit-equal, pixels within
    tolerance (the erase masks: test_erase_and_flip_masks_bit_equal)."""
    tdt, jdt = DTYPES[dtype]
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        images, gts = _images(20 + seed), _gts(20 + seed)
        want_img, want_gts = jax_augment.augment_batch(key, jnp.asarray(images), jnp.asarray(gts), p_jitter=p,
                                                       p_flip=p, p_erase=p, hue=hue, dtype=jdt)
        draws = jax_draws(key, N, H, W, p, p, p, 3, hue)
        got_img, got_gts = augment.apply_augment(torch.from_numpy(images), torch.from_numpy(gts), draws, tdt)
        assert got_img.dtype == tdt and got_gts.dtype == torch.float32
        np.testing.assert_array_equal(got_gts.numpy(), np.asarray(want_gts))
        _assert_close(got_img, want_img, dtype)


def test_erase_and_flip_masks_bit_equal():
    """The OR of the erase rectangles equals the zeros the JAX package's
    _erase_batch leaves in an all-ones image; flip alone is bit-equal."""
    for seed in range(8):
        key = jax.random.PRNGKey(100 + seed)
        k_e = jax.random.split(key, 4)[3]
        ones = jnp.ones((N, H, W, 3), jnp.float32)
        want = np.asarray(jax_augment._erase_batch(k_e, ones, 0.5, 3)) == 0
        draws = jax_draws(key, N, H, W)
        got = augment._erase_mask(draws, H, W, "cpu").numpy()
        np.testing.assert_array_equal(np.broadcast_to(got[..., None], want.shape), want)

        images, gts = _images(seed), _gts(seed)
        want_img, want_gts = jax_augment.augment_batch(key, jnp.asarray(images), jnp.asarray(gts), p_jitter=0.0,
                                                       p_erase=0.0)
        flip_only = augment.AugmentDraws(flip=draws.flip)
        got_img, got_gts = augment.apply_augment(torch.from_numpy(images), torch.from_numpy(gts), flip_only)
        np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
        np.testing.assert_array_equal(got_gts.numpy(), np.asarray(want_gts))


def test_flip_reflects_real_rows_only():
    gts = np.zeros((2, 3, 25), np.float32)
    gts[:, 0, :4] = (0.2, 0.5, 0.1, 0.1)
    gts[:, 1, :4] = (0.3, 0.5, 0.0, 0.1)  # zero width: not a real row
    draws = augment.AugmentDraws(flip=torch.tensor([True, False]))
    _, got = augment.apply_augment(torch.zeros((2, 4, 4, 3), dtype=torch.uint8), torch.from_numpy(gts), draws)
    assert got[0, 0, 0] == np.float32(1.0) - np.float32(0.2) and got[1, 0, 0] == np.float32(0.2)
    assert got[0, 1, 0] == np.float32(0.3)


def test_sample_augment_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = augment.sample_augment_draws(g, 64, 30, 50, hue=0.05)
    assert d.jitter.dtype == d.flip.dtype == d.erase.dtype == torch.bool
    assert isinstance(d.order, int) and 0 <= d.order < 24
    for f in (d.fb, d.fc, d.fs):
        assert f.shape == (64,) and bool(((f >= 0.5) & (f < 1.5)).all())
    assert bool((d.dh.abs() <= 0.05).all())
    assert d.erase.shape == (3, 64) and d.rect.shape == (3, 64, 4) and d.rect.dtype == torch.int32
    top, left, eh, ew = d.rect.unbind(-1)
    assert bool(((eh >= 1) & (eh <= 30) & (ew >= 1) & (ew <= 50) & (top >= 0) & (left >= 0)).all())
    assert bool((top + eh <= 30).all()) and bool((left + ew <= 50).all())
    # iteration i is erased only where i < the sample's count: iteration 0
    # is a coin, later ones never more often than it
    assert d.erase[0].sum() >= d.erase[2].sum()
    none = augment.sample_augment_draws(g, 4, 8, 8, p_jitter=0, p_flip=0, p_erase=0)
    assert none.jitter is none.flip is none.erase is None


def test_augment_batch_is_apply_of_sample():
    images, gts = torch.from_numpy(_images(7)), torch.from_numpy(_gts(7))
    a = augment.augment_batch(torch.Generator().manual_seed(3), images, gts, dtype=torch.bfloat16)
    draws = augment.sample_augment_draws(torch.Generator().manual_seed(3), N, H, W)
    b = augment.apply_augment(images, gts, draws, torch.bfloat16)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_draws_are_a_pure_function_of_seed_and_step():
    def draws(seed, step):
        return augment.sample_augment_draws(step_generator(seed, step), 8, 30, 30)

    a, b, c, d = draws(0, 5), draws(0, 5), draws(0, 6), draws(1, 5)
    for key in ("jitter", "fb", "dh", "flip", "erase", "rect"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert not torch.equal(a.fb, c.fb) and not torch.equal(a.fb, d.fb)
    assert draws(-3, 0).fb.shape == (8,)


# --------------------------------------------------------------- transforms.py


@pytest.mark.parametrize("name", ["RandomFlip", "RandomColorJitter", "RandomErasing", "ToTensor", "Compose"])
def test_transforms_copy_is_bit_equal(name):
    """The port's numpy transforms under one np.random.default_rng give the
    JAX package's classes' outputs bit for bit, over 20 calls."""
    def build(mod, rng):
        if name == "ToTensor":
            return mod.ToTensor()
        if name == "Compose":
            return mod.Compose([mod.RandomColorJitter(p=1.0, rng=rng), mod.RandomFlip(rng=rng), mod.ToTensor(),
                                mod.RandomErasing(p=1.0, max_iter=3, rng=rng)])
        return getattr(mod, name)(rng=rng, **({"p": 1.0, "max_iter": 3} if name == "RandomErasing" else {}))

    ours, theirs = build(transforms, np.random.default_rng(9)), build(jax_transforms, np.random.default_rng(9))
    data = np.random.default_rng(10)
    for _ in range(20):
        img = data.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        gt = np.zeros((3, 25), np.float32)
        gt[:2, :4] = data.uniform(0.1, 0.9, (2, 4))
        got, want = ours(img, gt), theirs(img, gt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- trainer with augment


def _trainer(augment_cfg):
    trainer = Trainer(SSD(num_classes=21, seed=0), default_boxes=anchors.default_boxes(anchors.feature_grids_for(264)),
                      augment=augment_cfg, seed=4, device="cpu")
    return trainer, trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4))


@pytest.mark.slow
def test_augmented_train_steps_equal_single_steps():
    """With augment on, a K = 2 `train_steps` call equals two `train_step`s
    bit for bit (the draws depend on the step only), and the augment changes
    the step (against augment off)."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (2, 2, 264, 264, 3), dtype=np.uint8)
    targets = np.stack([synth_targets(rng, 2, rng.integers(1, 5, 2), 8) for _ in range(2)])
    (t1, s1), (t2, s2), (t3, s3) = _trainer(True), _trainer(True), _trainer(False)
    singles = torch.stack([t1.train_step(s1, images[i], targets[i]) for i in range(2)])
    assert torch.equal(singles, t2.train_steps(s2, images, targets))
    for a, b in zip(s1.model.state_dict().values(), s2.model.state_dict().values()):
        assert torch.equal(a, b)
    assert not torch.equal(singles[0], t3.train_step(s3, images[0], targets[0]))


@pytest.mark.slow
def test_eval_step_augments_only_when_asked():
    """eval_step augments only with augment=True: without it the loss is
    the plain one bit for bit, with it another. Port only: marked slow,
    chip_smoke.py's phase_moved_training holds it on the card."""
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (2, 264, 264, 3), dtype=np.uint8)
    targets = synth_targets(rng, 2, rng.integers(1, 5, 2), 8)
    trainer, state = _trainer({"hue": 0.05})
    plain = trainer.eval_step(state, images, targets)
    again = trainer.eval_step(state, images, targets, rng=torch.Generator().manual_seed(1), augment=False)
    aug = trainer.eval_step(state, images, targets, rng=torch.Generator().manual_seed(1), augment=True)
    assert torch.equal(plain, again) and not torch.equal(plain, aug)

"""The port's serving slice as a whole: its `Predictor` on the CPU against the
JAX package's `Predictor`, on the JAX package's own init weights carried across
by the port's converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.infer import Predictor as JaxPredictor
from object_detection_torch2_tpu.infer import build_detection_pipeline as jax_pipeline
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu_torch.infer import Predictor, build_detection_pipeline, unpack_detections
from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables
from object_detection_torch2_tpu_torch.models.ssd import SSD

torch.set_num_threads(1)

IMSIZE = 264  # the smallest valid SSD pyramid


@pytest.fixture(scope="module")
def both():
    jmodel = JaxSSD(num_classes=21)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMSIZE, IMSIZE, 3)), train=False)
    model = SSD(num_classes=21)
    model.load_state_dict(ssd_state_dict_from_jax_variables(jax.tree.map(np.asarray, variables)))
    images = np.random.default_rng(0).integers(0, 255, (3, IMSIZE, IMSIZE, 3)).astype(np.uint8)
    return jmodel, variables, model, images


def _match_near_ties(got, want, rtol, atol):
    """Index of each `got` row in `want`: the row of the same class within 3
    ranks whose score is within tolerance (two near-equal scores may swap
    ranks when the frameworks' sums round differently)."""
    order, free = [], set(range(len(want.scores)))
    for i in range(len(got.scores)):
        near = sorted((j for j in free if abs(j - i) <= 3), key=lambda j: abs(j - i))
        match = [j for j in near if got.class_ids[i] == want.class_ids[j]
                 and np.allclose(got.scores[i], want.scores[j], rtol=rtol, atol=atol)]
        assert match, f"detection {i} of the port has no counterpart in the JAX package's"
        order.append(match[0])
        free.discard(match[0])
    return np.asarray(order)


# (box rtol, box atol) per BN mode. Running statistics: the JAX package's own
# cross-layout tolerance (tests/test_predictor.py). Batch statistics: the two
# frameworks reduce the statistics in different orders, and the drift grows
# over 35 BN layers to the head-output pin of tests/test_models.py (max 5e-3);
# the decode maps a head-output drift d to |d_cx| <= d_w * d on centers and a
# relative e^d - 1 ~ d on sizes, so boxes are held to 5e-3.
BOX_TOL = {False: (1e-4, 1e-5), True: (5e-3, 5e-3)}


@pytest.mark.parametrize("use_batch_stats", [False, True])
def test_predictor_matches_jax_predictor(both, use_batch_stats):
    """Ragged last batch (3 images at batch size 2), f32: the same number of
    detections per image, identical class ids, scores within rtol 1e-4 / atol
    1e-5 (the JAX package's own cross-layout tolerance, tests/test_predictor.py)
    and boxes within BOX_TOL.

    With running statistics the rows come in the same order. With batch
    statistics (the reference-parity default, quirk Q9) two detections with
    near-equal scores may swap ranks; each row must then match a row within 3
    ranks."""
    jmodel, variables, model, images = both
    kwargs = dict(imsize=IMSIZE, batch_size=2, use_batch_stats=use_batch_stats)
    want = JaxPredictor(jmodel, variables, **kwargs).predict(images)
    got = Predictor(model, device="cpu", **kwargs).predict(images)
    box_rtol, box_atol = BOX_TOL[use_batch_stats]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert len(g.scores) == len(w.scores) > 0
        order = _match_near_ties(g, w, rtol=1e-4, atol=1e-5)
        if not use_batch_stats:
            np.testing.assert_array_equal(order, np.arange(len(order)))
        np.testing.assert_array_equal(g.class_ids, w.class_ids[order])
        np.testing.assert_allclose(g.scores, w.scores[order], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g.boxes, w.boxes[order], rtol=box_rtol, atol=box_atol)
        assert g.class_ids.min() >= 0 and g.class_ids.max() <= 19
        assert (g.scores > 0).all() and (g.scores <= 1).all()


def test_pipeline_running_stats_matches_jax(both):
    """Running-statistics serving: packed rows and n_valid of one padded batch."""
    jmodel, variables, model, images = both
    batch = images  # row 2 stands for a pad row: n_real = 2
    jrun = jax_pipeline(jmodel, use_batch_stats=False, imsize=IMSIZE, max_detections=50)
    want_packed, want_valid = (np.asarray(x) for x in jrun(variables, jnp.asarray(batch), 2))
    run = build_detection_pipeline(model, use_batch_stats=False, imsize=IMSIZE, max_detections=50, device="cpu")
    packed, n_valid = run(batch, 2)
    np.testing.assert_array_equal(n_valid.numpy(), want_valid)
    boxes, classes, scores = unpack_detections(packed.numpy())
    wboxes, wclasses, wscores = unpack_detections(want_packed)
    np.testing.assert_array_equal(classes, wclasses)
    np.testing.assert_allclose(scores, wscores, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(boxes, wboxes, rtol=1e-4, atol=1e-5)
    assert (scores[2] == 0).all() and (classes[2] == 0).all()  # the pad row is zeroed


def test_predictor_without_device_needs_a_card():
    """Entry points run on the card unless asked for the CPU; without a card
    they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is available")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(SSD(num_classes=21), imsize=IMSIZE)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detection_pipeline(SSD(num_classes=21), True, imsize=IMSIZE, device="cuda")


def _f16_ulp(x: np.ndarray) -> np.ndarray:
    """One float16 ulp at each value's magnitude (normals; 2^-24 below)."""
    mag = np.abs(x.astype(np.float32))
    return np.where(mag >= 2.0 ** -14, 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -14))) - 10), 2.0 ** -24)


def test_pipeline_d2h_half_within_one_ulp_of_jax(both):
    """float16 rows (running statistics, a padded batch): the port's cast
    rounds to nearest even as XLA's does, so each value is within one
    float16 ulp of the JAX package's float16 rows (the float32 rows agree to
    ~1e-5 before the cast); class ids exact; the port's float16 rows are its
    float32 rows rounded."""
    jmodel, variables, model, images = both
    jrun = jax_pipeline(jmodel, use_batch_stats=False, imsize=IMSIZE, max_detections=50, d2h_half=True)
    want = np.asarray(jrun(variables, jnp.asarray(images), 2)[0])
    run = build_detection_pipeline(model, use_batch_stats=False, imsize=IMSIZE, max_detections=50, device="cpu",
                                   d2h_half=True)
    packed, _ = run(images, 2)
    full, _ = build_detection_pipeline(model, use_batch_stats=False, imsize=IMSIZE, max_detections=50,
                                       device="cpu")(images, 2)
    assert packed.dtype == torch.float16 and want.dtype == np.float16
    assert torch.equal(packed, full.to(torch.float16))
    got = packed.numpy()
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    d = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert (d <= _f16_ulp(want)).all(), f"max {d.max()} at {np.unravel_index(d.argmax(), d.shape)}"


def test_predictor_batches_per_dispatch_equals_one(both):
    """K = 2 batches a dispatch (5 images at batch 2, batch statistics: one
    K-call, then the leftover batch alone) gives K = 1's detections, bit for
    bit; d2h_half gives them rounded to float16."""
    _, _, model, images = both
    images = np.concatenate([images, images[::-1][:2]])
    kwargs = dict(imsize=IMSIZE, batch_size=2, use_batch_stats=True, device="cpu")
    want = Predictor(model, **kwargs).predict(images)
    got = Predictor(model, batches_per_dispatch=2, **kwargs).predict(images)
    half = Predictor(model, batches_per_dispatch=2, d2h_half=True, **kwargs).predict(images)
    assert len(got) == len(half) == len(want) == 5
    for g, h, w in zip(got, half, want):
        for a, b in ((g.boxes, w.boxes), (g.class_ids, w.class_ids), (g.scores, w.scores)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(h.class_ids, w.class_ids)
        np.testing.assert_array_equal(h.scores, w.scores.astype(np.float16).astype(np.float32))
        np.testing.assert_array_equal(h.boxes, w.boxes.astype(np.float16).astype(np.float32))
    with pytest.raises(ValueError, match="batches_per_dispatch"):
        Predictor(model, batches_per_dispatch=0, **kwargs)

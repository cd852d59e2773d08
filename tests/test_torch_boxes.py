"""Port parity: anchors, box math, image conversion and scores against the JAX
package and the reference goldens, on identical numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.core import anchors as jax_anchors
from object_detection_torch2_tpu.core import boxes as jax_boxes
from object_detection_torch2_tpu.data.augment import to_tensor_batch as jax_to_tensor_batch
from object_detection_torch2_tpu.models.ssd import normalize_image as jax_normalize_image
from object_detection_torch2_tpu.ops import scores as jax_scores
from object_detection_torch2_tpu_torch.core import anchors, boxes
from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
from object_detection_torch2_tpu_torch.models.ssd import normalize_image
from object_detection_torch2_tpu_torch.ops import scores

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_default_boxes_bitwise(goldens):
    ours = anchors.default_boxes()
    np.testing.assert_array_equal(ours, goldens("anchors")["default_bboxes"])
    np.testing.assert_array_equal(ours, jax_anchors.default_boxes())
    assert anchors.NUM_ANCHORS == 8732


@pytest.mark.parametrize("imsize", [264, 300, 384, 512])
def test_feature_grids_and_anchors_match_jax(imsize):
    grids = anchors.feature_grids_for(imsize)
    assert grids == jax_anchors.feature_grids_for(imsize)
    np.testing.assert_array_equal(anchors.default_boxes(grids), jax_anchors.default_boxes(grids))


def test_scales_and_small_imsize():
    assert [anchors.scale(k) for k in range(1, 8)] == [jax_anchors.scale(k) for k in range(1, 8)]
    with pytest.raises(ValueError):
        anchors.feature_grids_for(200)


def test_labelmap_sizes_the_head():
    assert len(LabelMap("PascalVOC")) + 1 == 21
    assert LabelMap("PascalVOC").id2name(0) == "aeroplane"


def test_pairwise_iou(goldens):
    g = goldens("boxmath")
    t, s = g["gts"][..., :4], g["boxes_s"]
    ours = boxes.pairwise_iou(_t(t), _t(s)).numpy()
    np.testing.assert_allclose(ours, g["iou"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours, np.asarray(jax_boxes.pairwise_iou(jnp.asarray(t), jnp.asarray(s))),
                               rtol=1e-6, atol=0)


def test_pairwise_iou_random_clusters_match_jax():
    rng = np.random.default_rng(3)
    b = np.zeros((2, 200, 4), np.float32)
    b[..., :2] = rng.uniform(0.2, 0.8, (2, 200, 2))
    b[..., 2:] = rng.uniform(0.0, 0.4, (2, 200, 2))
    b[:, :5] = 0.0  # zero-area padded rows stay inert
    ours = boxes.pairwise_iou(_t(b), _t(b)).numpy()
    ref = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(b), jnp.asarray(b)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert (ours[:, :5] == 0).all() and (ours[:, :, :5] == 0).all()


def test_decode_boxes(goldens):
    g = goldens("boxmath")
    ours = boxes.decode_boxes(_t(g["pred"]), _t(g["df"])).numpy()
    np.testing.assert_allclose(ours, g["decode"], rtol=1e-6, atol=1e-5)
    ref = np.asarray(jax_boxes.decode_boxes(jnp.asarray(g["pred"]), jnp.asarray(g["df"])))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def test_to_tensor_and_normalize_bitwise():
    """Every uint8 value converts and normalizes to the JAX package's exact
    float32 (XLA multiplies by the reciprocal of a constant divisor)."""
    x = np.arange(256, dtype=np.uint8).reshape(1, 4, 64, 1).repeat(3, axis=-1)
    ours = to_tensor_batch(_t(x))
    ref = jax_to_tensor_batch(jnp.asarray(x))
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(normalize_image(ours).numpy(),
                                  np.asarray(jax.jit(jax_normalize_image)(ref)))


def test_calc_scores(goldens):
    g = goldens("boxmath")
    ours = scores.calc_scores(_t(g["score_in"])).numpy()
    np.testing.assert_allclose(ours, g["score"], rtol=1e-6, atol=1e-6)
    ref = np.asarray(jax_scores.calc_scores(jnp.asarray(g["score_in"])))
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
    np.testing.assert_array_equal(ours > 0, ref > 0)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def _post(rng, n, p, c=21):
    """Post-NMS-shaped rows: boxes + one-class-kept scores, many all-zero rows
    (exact ties) and some void-argmax rows."""
    post = np.zeros((n, p, 4 + c), np.float32)
    post[..., :4] = rng.uniform(0, 1, (n, p, 4))
    cls = rng.integers(0, c, (n, p))
    live = rng.uniform(0, 1, (n, p)) < 0.3
    post[np.arange(n)[:, None], np.arange(p)[None], 4 + cls] = np.where(live, rng.uniform(0.05, 1, (n, p)), 0)
    post[0, 10:14, 4 + 3] = 0.5  # exact score ties
    return post


@pytest.mark.parametrize("masked", [False, True])
def test_top_k_detections_matches_jax(masked):
    rng = np.random.default_rng(5)
    post = _post(rng, 3, 300)
    mask = np.array([1, 1, 0], np.float32) if masked else None
    k = 120  # more than the live rows: empty slots must pick the same rows
    ours = scores.top_k_detections(_t(post), k, None if mask is None else _t(mask))
    ref = jax_scores.top_k_detections(jnp.asarray(post), k, None if mask is None else jnp.asarray(mask))
    b, c, s = (x.numpy() for x in ours)
    rb, rc, rs = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(b, rb)  # same rows, including the empty slots

"""The port's evaluation tail against the JAX package on the CPU:
`ops.scores.expand_detections`, `metrics.assign.detection_matches`,
`metrics.ap` and `utils.report`, on the reference goldens and seeded cases."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.data.labelmap import LabelMap as JaxLabelMap
from object_detection_torch2_tpu.metrics.ap import APAccumulator as JaxAPAccumulator
from object_detection_torch2_tpu.metrics.assign import detection_matches as jax_matches
from object_detection_torch2_tpu.ops import expand_detections as jax_expand
from object_detection_torch2_tpu.ops import top_k_detections as jax_top_k
from object_detection_torch2_tpu.utils.report import write_report as jax_write_report
from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
from object_detection_torch2_tpu_torch.metrics.ap import APAccumulator, average_precision
from object_detection_torch2_tpu_torch.metrics.assign import detection_matches
from object_detection_torch2_tpu_torch.ops.scores import expand_detections, top_k_detections
from object_detection_torch2_tpu_torch.utils.report import write_report

torch.set_num_threads(2)


def _port_matches(outputs, gts):
    m = detection_matches(torch.from_numpy(np.asarray(outputs)), torch.from_numpy(np.asarray(gts)), num_classes=20)
    return {k: v.numpy() for k, v in m.items()}


def _jax_matches(outputs, gts):
    m = jax_matches(jnp.asarray(outputs), jnp.asarray(gts), num_classes=20)
    return {k: np.asarray(v) for k, v in m.items()}


def _assert_matches_equal(got, want):
    """correct and counts equal, scores bit-equal."""
    assert got["correct"].dtype == np.bool_ and got["counts"].dtype == np.int32
    np.testing.assert_array_equal(got["correct"], want["correct"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert got["scores"].dtype == want["scores"].dtype == np.float32
    np.testing.assert_array_equal(got["scores"].view(np.int32), want["scores"].view(np.int32))


def _compaction_case(goldens):
    """tests/test_eval_metrics.py::test_compacted_matches_equal_full_width's
    inputs: the NMS golden's post-NMS rows and seeded GTs, three of them on
    kept detections."""
    post = goldens("nms")["nms_out"]  # (2, 60, 25)
    rng = np.random.default_rng(3)
    gts = np.zeros((2, 5, 25), np.float32)
    gts[..., :2] = rng.uniform(0.2, 0.8, (2, 5, 2))
    gts[..., 2:4] = rng.uniform(0.1, 0.3, (2, 5, 2))
    for i in range(2):
        gts[i, np.arange(5), 4 + rng.integers(1, 21, 5)] = 1.0
    kept = post[..., 5:].max(-1) > 0
    for i in range(2):
        idx = np.nonzero(kept[i])[0][:3]
        gts[i, :3, :4] = post[i, idx, :4]
        gts[i, :3, 4:] = 0
        gts[i, np.arange(3), 4 + np.argmax(post[i, idx, 5:], -1) + 1] = 1.0
    return post, gts


def _seeded_case(seed, ties=False, dup_gt=False, n=3, p=48, g=8):
    """Clustered detections (many claimants per GT), one-class-kept scores
    with every 5th row and all of image 0's last 8 rows zero, GTs on jittered
    detection boxes, zero-padded, image n-1 without any GT. ties: scores on a
    grid of 1/4 (many exact ties, zeros among them). dup_gt: each image's GT 0
    repeated in slot 1 (two GTs at exactly equal IoU to every detection)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, p, 25), np.float32)
    centers = rng.uniform(0.25, 0.75, (n, 4, 2))
    pick = rng.integers(0, 4, (n, p))
    out[..., :2] = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 0.02, (n, p, 2))
    out[..., 2:4] = rng.uniform(0.15, 0.25, (n, p, 2))
    scores = rng.uniform(0.0, 1.0, (n, p)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    scores[:, ::5] = 0.0
    cls = rng.integers(1, 4, (n, p))  # few classes: many claimants per class
    out[np.arange(n)[:, None], np.arange(p)[None, :], 4 + cls] = scores
    out[0, -8:] = 0.0  # all-zero rows
    gts = np.zeros((n, g, 25), np.float32)
    for i in range(n - 1):
        k = int(rng.integers(2, g))
        src = rng.choice(p, k, replace=False)
        gts[i, :k, :4] = out[i, src, :4] + rng.normal(0, 0.01, (k, 4)).astype(np.float32)
        gts[i, np.arange(k), 4 + cls[i, src]] = 1.0
        if dup_gt:
            gts[i, 1] = gts[i, 0]
    return out, gts


def test_detection_matches_eval_golden(goldens):
    g = goldens("eval")
    _assert_matches_equal(_port_matches(g["outputs"], g["gts"]), _jax_matches(g["outputs"], g["gts"]))


def test_expand_and_matches_compaction_case(goldens):
    """The JAX package's compaction case: top-K -> expand_detections ->
    detection_matches in both packages, and the full-width matches."""
    post, gts = _compaction_case(goldens)
    jb, jc, js = jax_top_k(jnp.asarray(post), 60)
    want_compact = np.asarray(jax_expand(jb, jc, js, 21))
    b, c, s = top_k_detections(torch.from_numpy(post), 60)
    compact = expand_detections(b, c, s, 21).numpy()
    np.testing.assert_array_equal(compact, want_compact)
    _assert_matches_equal(_port_matches(compact, gts), _jax_matches(want_compact, gts))
    _assert_matches_equal(_port_matches(post, gts), _jax_matches(post, gts))


@pytest.mark.parametrize("seed,ties,dup_gt", [(0, False, False), (1, True, False), (2, False, True), (3, True, True)])
def test_detection_matches_seeded_cases(seed, ties, dup_gt):
    out, gts = _seeded_case(seed, ties=ties, dup_gt=dup_gt)
    got, want = _port_matches(out, gts), _jax_matches(out, gts)
    _assert_matches_equal(got, want)
    assert got["correct"].any() and (got["scores"] > 0).any()  # the case has claims to decide
    assert (got["counts"][-1] == 0).all()


def test_expand_detections_matches_jax():
    rng = np.random.default_rng(5)
    boxes = rng.uniform(0, 1, (2, 7, 4)).astype(np.float32)
    classes = rng.integers(0, 21, (2, 7)).astype(np.int32)
    scores = rng.uniform(0, 1, (2, 7)).astype(np.float32)
    want = np.asarray(jax_expand(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(scores), 21))
    got = expand_detections(torch.from_numpy(boxes), torch.from_numpy(classes), torch.from_numpy(scores), 21)
    np.testing.assert_array_equal(got.numpy(), want)


def test_average_precision_golden(goldens):
    g = goldens("eval")
    rows = g["ap_rows"]
    ap = average_precision(rows[:, 0], rows[:, 1], int(g["ap_count"]), strict=False)
    np.testing.assert_allclose(ap, float(g["ap_val"]), rtol=1e-6)


def test_accumulator_golden_and_jax(goldens):
    """Per-class AP of the eval golden (atol 1e-5, as the JAX package's test)
    and against the JAX package's accumulator on the same matches, parity
    and strict (atol 1e-6); counts equal."""
    g = goldens("eval")
    acc = APAccumulator(20)
    acc.update(detection_matches(torch.from_numpy(g["outputs"]), torch.from_numpy(g["gts"]), 20))
    np.testing.assert_array_equal(acc.counts, g["counts"])
    aps, _ = acc.result(strict=False)
    mask = np.isfinite(g["aps"])
    np.testing.assert_array_equal(np.isfinite(aps), mask)
    np.testing.assert_allclose(aps[mask], g["aps"][mask], atol=1e-5)

    jacc = JaxAPAccumulator(20)
    jacc.update(jax_matches(jnp.asarray(g["outputs"]), jnp.asarray(g["gts"]), num_classes=20))
    for strict in (False, True):
        (a, m), (ja, jm) = acc.result(strict=strict), jacc.result(strict=strict)
        np.testing.assert_allclose(np.nan_to_num(a, nan=-1), np.nan_to_num(ja, nan=-1), atol=1e-6)
        np.testing.assert_allclose(m, jm, atol=1e-6)


def test_accumulator_seeded_against_jax():
    """Seeded cases with ties and duplicate GTs, accumulated over two updates
    (tensors in the port, numpy into the JAX package's accumulator)."""
    acc, jacc = APAccumulator(20), JaxAPAccumulator(20)
    for seed, ties in ((10, True), (11, False)):
        out, gts = _seeded_case(seed, ties=ties, dup_gt=ties)
        acc.update(detection_matches(torch.from_numpy(out), torch.from_numpy(gts), 20))
        jacc.update(_jax_matches(out, gts))
    np.testing.assert_array_equal(acc.counts, jacc.counts)
    for strict in (False, True):
        (a, m), (ja, jm) = acc.result(strict=strict), jacc.result(strict=strict)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(ja))
        np.testing.assert_allclose(np.nan_to_num(a, nan=-1), np.nan_to_num(ja, nan=-1), atol=1e-6)
        np.testing.assert_allclose(m, jm, atol=1e-6)


def test_batch_split_invariance(goldens):
    g = goldens("eval")
    outputs, gts = torch.from_numpy(g["outputs"]), torch.from_numpy(g["gts"])
    one, two = APAccumulator(20), APAccumulator(20)
    one.update(detection_matches(outputs, gts, 20))
    two.update(detection_matches(outputs[:1], gts[:1], 20))
    two.update(detection_matches(outputs[1:], gts[1:], 20))
    np.testing.assert_array_equal(one.counts, two.counts)
    for strict in (False, True):
        a1, _ = one.result(strict=strict)
        a2, _ = two.result(strict=strict)
        np.testing.assert_allclose(np.nan_to_num(a1, nan=-1), np.nan_to_num(a2, nan=-1), atol=1e-6)


def _without_runtime(text: str) -> str:
    return re.sub(r"## RUNTIME\n```\n.*?\n```\n", "", text, flags=re.S)


def test_write_report_matches_jax(tmp_path):
    """The report's text equals the JAX package's but for the RUNTIME block,
    which names the torch version and the device."""
    aps = np.array([0.5, np.nan] + [0.125] * 18, np.float32)
    args = {"imsize": 300, "batch_size": 32, "dtype": "bfloat16", "strict_ap": True}
    got = write_report(tmp_path / "port", args, aps, 0.25, LabelMap("PascalVOC"), device="cpu").read_text()
    want = jax_write_report(tmp_path / "jax", args, aps, 0.25, JaxLabelMap("PascalVOC")).read_text()
    assert _without_runtime(got) == _without_runtime(want) != got
    assert f"torch {torch.__version__}" in got and "\ncpu\n" in got
    assert "|aeroplane|0.5|" in got and "|bicycle|nan|" in got and "|**mean**|**0.25**|" in got

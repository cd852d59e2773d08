"""The port's CUDA kernels on the card. Every test here carries the `cuda`
marker and skips without a CUDA device. The file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch import true_float32
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.ops import _build, conv12_cuda, nms, nms_cuda
from object_detection_torch2_tpu_torch.ops.conv12 import conv12, conv12_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    logs = _build.build_all()
    for name, log in logs.items():
        print(f"built {name}:\n{log}")
    return torch.device("cuda")


def _sorted_clustered(rng, n, p, dense, device):
    boxes = np.zeros((n, p, 4), np.float32)
    centers = rng.uniform(0.1, 0.9, (n, 6, 2))
    pick = rng.integers(0, 6, (n, p))
    boxes[..., :2] = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 0.04, (n, p, 2))
    boxes[..., 2:] = rng.uniform(0.05, 0.3, (n, p, 2))
    if dense:
        scores = rng.uniform(0.1, 1.0, (n, p)).astype(np.float32)
    else:
        scores = np.zeros((n, p), np.float32)
        for i in range(n):
            idx = rng.choice(p, min(11, p), replace=False)
            scores[i, idx] = rng.uniform(0.1, 1.0, len(idx))
    order = np.argsort(-scores, axis=-1, kind="stable")
    sb = np.take_along_axis(boxes, order[..., None], axis=1)
    sv = np.take_along_axis(scores, order, axis=1) > 0.0
    return torch.from_numpy(sb).to(device), torch.from_numpy(sv).to(device)


@pytest.mark.parametrize("p", [1, 63, 64, 65, 100, 128, 129, 1024, 8732])
@pytest.mark.parametrize("dense", [True, False])
def test_kernel_equals_plain(card, p, dense):
    rng = np.random.default_rng(p + dense)
    sb, sv = _sorted_clustered(rng, 32, p, dense, card)
    before = nms_cuda.launches
    got = nms_cuda.keep_sorted(sb, sv, 0.5)
    torch.cuda.synchronize()
    assert nms_cuda.launches == before + 1
    want = nms._blocked_keep_sorted(sb, sv, 0.5)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("thresh", [0.0, 0.3, 0.7])
@pytest.mark.parametrize("case", ["nan_inf", "ties", "all_invalid", "holes"])
@pytest.mark.parametrize("p", [1, 63, 64, 65, 129, 1024])
def test_kernel_edge_cases_equal_plain(card, p, case, thresh):
    """NaN and inf boxes, exact duplicates, no valid candidate, and valid
    candidates with invalid ones between them, at every threshold."""
    rng = np.random.default_rng(p * 7 + len(case))
    sb, sv = _sorted_clustered(rng, 4, p, True, card)
    if case == "nan_inf":
        sb[:, 5 % p] = float("nan")
        sb[:, 9 % p, 2] = float("inf")
        sb[:, (p - 1), 0] = float("-inf")
    elif case == "ties":
        sb[:, 1::3] = sb[:, 0:1]
    elif case == "all_invalid":
        sv[:] = False
    else:
        sv &= torch.from_numpy(rng.uniform(size=sv.shape) < 0.4).to(card)
    got = nms_cuda.nms_keep_sorted_cuda(sb, sv, thresh)
    assert torch.equal(got, nms._blocked_keep_sorted(sb, sv, thresh))
    if case == "all_invalid":
        assert not got.any()


def test_kernel_raises_above_scratch_cap(card, monkeypatch):
    sb, sv = _sorted_clustered(np.random.default_rng(6), 2, 300, True, card)
    need = nms_cuda.mask_scratch_bytes(2, 300)
    assert need == 2 * 300 * 5 * 8
    # only one image's scratch above the cap raises
    monkeypatch.setattr(nms_cuda, "MASK_SCRATCH_CAP_BYTES", need // 2 - 1)
    before = nms_cuda.launches
    with pytest.raises(ValueError, match="scratch"):
        nms_cuda.nms_keep_sorted_cuda(sb, sv)
    assert nms_cuda.launches == before
    want = nms._blocked_keep_sorted(sb, sv, 0.5)
    # below the batch's scratch: one slice an image
    monkeypatch.setattr(nms_cuda, "MASK_SCRATCH_CAP_BYTES", need - 1)
    assert torch.equal(nms_cuda.nms_keep_sorted_cuda(sb, sv), want)
    assert nms_cuda.launches == before + 2
    monkeypatch.setattr(nms_cuda, "MASK_SCRATCH_CAP_BYTES", need)
    assert torch.equal(nms_cuda.nms_keep_sorted_cuda(sb, sv), want)
    assert nms_cuda.launches == before + 3


@pytest.mark.parametrize("images_per_slice", [1, 3, 7])
def test_kernel_in_slices_equals_plain(card, monkeypatch, images_per_slice):
    """The cap patched small: a batch of 16 swept in at least 3 slices, one
    launch each, into one scratch, keep mask identical to the plain sweep."""
    sb, sv = _sorted_clustered(np.random.default_rng(images_per_slice), 16, 1024, True, card)
    monkeypatch.setattr(nms_cuda, "MASK_SCRATCH_CAP_BYTES", nms_cuda.mask_scratch_bytes(images_per_slice, 1024))
    slices = nms_cuda.sweep_slices(16, 1024, nms_cuda.MASK_SCRATCH_CAP_BYTES)
    assert len(slices) >= 3
    before = nms_cuda.launches
    got = nms_cuda.keep_sorted(sb, sv, 0.5)
    torch.cuda.synchronize()
    assert nms_cuda.launches == before + len(slices)
    assert torch.equal(got, nms._blocked_keep_sorted(sb, sv, 0.5))


def test_kernel_at_batch_256_equals_plain(card):
    """N = 256 at SSD's P = 8732 (above the 224 images one scratch holds): two
    slices, two launches, the plain sweep's keep mask."""
    sb, sv = _sorted_clustered(np.random.default_rng(256), 256, 8732, False, card)
    sv[:4] = True  # four images take the full sweep's worst case
    before = nms_cuda.launches
    got = nms_cuda.nms_keep_sorted_cuda(sb, sv, 0.5)
    torch.cuda.synchronize()
    assert nms_cuda.launches == before + 2 == before + len(nms_cuda.sweep_slices(256, 8732))
    assert torch.equal(got, nms._blocked_keep_sorted(sb, sv, 0.5))


def test_kernel_wrapper_checks(card):
    sb, sv = _sorted_clustered(np.random.default_rng(4), 2, 300, True, card)
    with pytest.raises(TypeError):
        nms_cuda.nms_keep_sorted_cuda(sb.double(), sv)
    with pytest.raises(ValueError):
        nms_cuda.nms_keep_sorted_cuda(sb.transpose(0, 1), sv.t())
    with pytest.raises(ValueError):
        nms_cuda.nms_keep_sorted_cuda(sb[:, ::2], sv[:, ::2])
    with pytest.raises(ValueError):
        nms_cuda.nms_keep_sorted_cuda(sb, sv.cpu())


def test_nms_keep_mask_on_card_uses_kernel_at_every_tier(card):
    rng = np.random.default_rng(5)
    p = 8732
    boxes = torch.from_numpy(rng.uniform(0.05, 0.6, (4, p, 4)).astype(np.float32)).to(card)
    for n_pos in (50, 700, 5000):
        scores = torch.zeros((4, p), device=card)
        scores[:, :n_pos] = torch.rand((4, n_pos), device=card) + 0.01
        before = nms_cuda.launches
        got = nms.nms_keep_mask(boxes, scores)
        assert nms_cuda.launches == before + 1
        want = nms.nms_keep_mask(boxes, scores, sweep=nms._blocked_keep_sorted)
        assert torch.equal(got, want)


def _conv12_case(n, h, w, dtype, device, seed=0):
    """Post-ReLU-scale channels_last input, kaiming fan_out weights, small bias."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.maximum(rng.standard_normal((n, h, w, 64)), 0).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((64, 64, 3, 3)) * np.sqrt(2.0 / 576)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(np.float32))
    return x.permute(0, 3, 1, 2).to(device, dtype), wt.to(device, dtype), b.to(device)


def conv12_within_tolerance(got, want):
    """float32: max |got - want| <= 1e-4 * max |want| (sums of 576 products in
    another order). bfloat16: each element within 2 bfloat16 ulps of want's
    magnitude, or within 1e-5 * max |want| near zero, where the float32 sum
    order alone moves a value by more ulps of itself than it has."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    scale = float(w.abs().max())
    if got.dtype == torch.float32:
        return float(d.max()) <= 1e-4 * scale
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    return bool((d <= torch.maximum(2 * ulp, torch.full_like(ulp, 1e-5 * scale))).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (2, 16, 16), (3, 38, 50), (1, 17, 33), (4, 300, 300), (5, 300, 300)])
def test_conv12_kernel_equals_plain(card, dtype, n, h, w):
    """(5, 300, 300) is 1805 tiles of 16 x 16, not a multiple of the
    bfloat16 kernel's persistent grid (one block per SM)."""
    x, wt, b = _conv12_case(n, h, w, dtype, card, seed=h * w)
    before = conv12_cuda.launches
    got = conv12_cuda.conv12_cuda(x, wt, b)
    torch.cuda.synchronize()
    assert conv12_cuda.launches == before + 1
    want = conv12_plain(x, wt, b)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert conv12_within_tolerance(got, want)


def test_conv12_dispatch_by_dtype(card):
    """float32 runs the CUDA-core kernel csrc/conv12.cu, bfloat16 the
    tensor-core kernel csrc/conv12_bf16.cu, whose machine code holds
    tensor-core instructions."""
    for dtype, name in ((torch.float32, "conv12"), (torch.bfloat16, "conv12_bf16")):
        x, wt, b = _conv12_case(2, 20, 24, dtype, card, seed=9)
        before = dict(conv12_cuda.kernel_launches)
        conv12_cuda.conv12_cuda(x, wt, b)
        after = conv12_cuda.kernel_launches
        assert {k: after[k] - before[k] for k in after} == {k: int(k == name) for k in after}
    assert sum(_build.tensor_core_instructions("conv12_bf16").values()) > 0
    assert sum(_build.tensor_core_instructions("conv12").values()) == 0


def test_conv12_backward_equals_plain_autograd(card):
    """The backward of sum(y * r) for a fixed r, so that both backwards get the
    same cotangent; both in true float32 (cuDNN's TF32 is on by default, and
    a backward runs outside the forward's context)."""
    x, wt, b = _conv12_case(2, 38, 50, torch.float32, card, seed=1)
    r = torch.from_numpy(np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)).to(card)
    grads = []
    for fn in (conv12, conv12_plain):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, wt, b))
        with true_float32():
            (fn(xs, ws, bs) * r).sum().backward()
        grads.append((xs.grad, ws.grad, bs.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_conv12_wrapper_checks(card):
    x, wt, b = _conv12_case(2, 8, 8, torch.float32, card)
    before = conv12_cuda.launches
    with pytest.raises(TypeError):
        conv12_cuda.conv12_cuda(x.half(), wt.half(), b)
    with pytest.raises(TypeError):
        conv12_cuda.conv12_cuda(x, wt, b, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        conv12_cuda.conv12_cuda(x.contiguous(), wt, b)  # NCHW-contiguous, not channels_last
    with pytest.raises(ValueError):
        conv12_cuda.conv12_cuda(x[:, :32].contiguous(memory_format=torch.channels_last), wt[:32, :32], b[:32])
    with pytest.raises(ValueError):
        conv12_cuda.conv12_cuda(x.cpu(), wt.cpu(), b.cpu())
    assert conv12_cuda.launches == before


def test_ssd_with_conv12_kernel_launches_it_once_per_forward(card):
    model = SSD(num_classes=21, conv12_kernel=True).to(card)
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (2, 264, 264, 3)).astype(np.float32)).to(card)
    before = conv12_cuda.launches
    with torch.no_grad():
        got = model.eval()(x, use_batch_stats=True)
    assert conv12_cuda.launches == before + 1
    plain = SSD(num_classes=21).to(card)
    with torch.no_grad():
        want = plain.eval()(x, use_batch_stats=True)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("ties", [False, True])
def test_detection_matches_on_card_equal_cpu(card, ties):
    """The evaluation matcher at the CLI's shapes (32 images, K = 200, G = 64):
    its stable score sort and its first-maximum argmaxes (over IoUs, and over
    0/1 claim bytes) decide ties on the card as on the CPU. Clustered boxes
    give each ground truth many claimants; every GT is repeated once, so two
    GTs sit at exactly equal IoU."""
    from object_detection_torch2_tpu_torch.metrics.assign import detection_matches

    rng = np.random.default_rng(40 + ties)
    n, k, g = 32, 200, 64
    out = np.zeros((n, k, 25), np.float32)
    centers = rng.uniform(0.25, 0.75, (n, 8, 2))
    out[..., :2] = np.take_along_axis(centers, rng.integers(0, 8, (n, k))[..., None], axis=1) \
        + rng.normal(0, 0.02, (n, k, 2))
    out[..., 2:4] = rng.uniform(0.15, 0.25, (n, k, 2))
    scores = rng.uniform(0, 1, (n, k)).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    cls = rng.integers(1, 5, (n, k))
    out[np.arange(n)[:, None], np.arange(k)[None, :], 4 + cls] = scores
    gts = np.zeros((n, g, 25), np.float32)
    src = rng.integers(0, k, (n, g // 2))
    half = np.take_along_axis(out[..., :4], src[..., None], axis=1) + rng.normal(0, 0.01, (n, g // 2, 4))
    gts[:, 0::2, :4] = gts[:, 1::2, :4] = half
    onehot = np.eye(21, dtype=np.float32)[np.take_along_axis(cls, src, axis=1)]
    gts[:, 0::2, 4:] = gts[:, 1::2, 4:] = onehot
    want = detection_matches(torch.from_numpy(out), torch.from_numpy(gts), 20)
    got = detection_matches(torch.from_numpy(out).to(card), torch.from_numpy(gts).to(card), 20)
    assert int(want["correct"].sum()) > n  # many claims to decide
    for key in want:
        assert got[key].device.type == "cuda" and got[key].dtype == want[key].dtype
        assert torch.equal(got[key].cpu(), want[key]), key


def _augment_case(n, h, w, seed):
    """Seeded uint8 images, GTs with real and zero rows, and one draw set."""
    from object_detection_torch2_tpu_torch.data import augment

    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))
    gts = np.zeros((n, 8, 25), np.float32)
    gts[:, :5, :4] = rng.uniform(0.1, 0.9, (n, 5, 4))
    gts[:, :5, 5] = 1.0
    draws = augment.sample_augment_draws(torch.Generator().manual_seed(seed), n, h, w, p_jitter=1.0)
    return images, torch.from_numpy(gts), draws


def augment_within_tolerance(got, want):
    """float32: max |d| <= 2e-6; bfloat16: each element within 1 bfloat16
    ulp of want's magnitude (the CPU tests' tolerances against the JAX
    package)."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(d.max()) <= 2e-6
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
    return bool((d <= ulp).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("order", [0, 7, 23])
def test_augment_on_card_equals_cpu(card, dtype, order):
    """The same draws on the same images: GTs and erased pixels equal, the
    pixels within the CPU tests' tolerance."""
    from object_detection_torch2_tpu_torch.data import augment

    images, gts, draws = _augment_case(4, 64, 80, seed=order)
    draws.order = order
    want_img, want_gts = augment.apply_augment(images, gts, draws, dtype)
    got_img, got_gts = augment.apply_augment(images.to(card), gts.to(card), draws, dtype)
    assert got_img.device.type == "cuda" and got_img.dtype == dtype
    assert torch.equal(got_gts.cpu(), want_gts)
    assert bool((got_img.cpu()[augment._erase_mask(draws, 64, 80, "cpu")] == 0).all())
    assert augment_within_tolerance(got_img.cpu(), want_img)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_augmented_train_step_on_card(card, dtype):
    """Trainer(augment=True) on the card: each step launches the dtype's
    conv12 kernel once and waits on the card nowhere (sync debug mode
    "error" around the steps after the first)."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    trainer = Trainer(SSD(num_classes=21, dtype=dtype, conv12_kernel=True),
                      default_boxes=default_boxes(feature_grids_for(264)), augment=True, device=card)
    state = trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4))
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (3, 2, 264, 264, 3), dtype=np.uint8)
    targets = np.zeros((3, 2, 8, 25), np.float32)
    targets[..., :2, :4] = rng.uniform(0.2, 0.6, (3, 2, 2, 4))
    targets[..., :2, 7] = 1.0
    before = dict(conv12_cuda.kernel_launches)
    losses = [trainer.train_step(state, images[0], targets[0])]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses += [trainer.train_step(state, images[i], targets[i]) for i in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    name = conv12_cuda.KERNEL_OF[dtype]
    assert conv12_cuda.kernel_launches[name] - before[name] == 3
    assert all(bool(torch.isfinite(l)) for l in losses) and state.step == 3


def test_render_of_card_pipeline_detections(card, tmp_path):
    """cli.inference on the card over numpy-written records: each PNG equals
    the render of the card pipeline's detections for that image."""
    import json

    from PIL import Image

    from object_detection_torch2_tpu_torch.cli import common, inference
    from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
    from object_detection_torch2_tpu_torch.infer import build_detection_pipeline, unpack_detections
    from object_detection_torch2_tpu_torch.utils.render import render_detections_compact

    images = np.random.default_rng(4).integers(0, 256, (3, 264, 264, 3), dtype=np.uint8)
    rec = tmp_path / "rec"
    rec.mkdir()
    np.save(rec / "images.npy", images)
    np.save(rec / "gts.npy", np.zeros((3, 4, 25), np.float32))
    (rec / "meta.json").write_text(json.dumps({"imsize": 264, "max_gt": 4, "count": 3, "purpose": "detection"}))
    before = nms_cuda.launches
    out = inference.main(["--records_dir", str(rec), "--result_dir", str(tmp_path / "res"), "--imsize", "264",
                          "--batch_size", "2", "--dtype", "float32"])
    assert nms_cuda.launches - before == 2 and len(out["paths"]) == 3
    run = build_detection_pipeline(SSD(num_classes=21, seed=0), True, 264, device=card)
    labelmap = LabelMap("PascalVOC")
    for start in (0, 2):
        chunk = images[start:start + 2]
        packed, _ = run(common.pad_rows(chunk, 2), len(chunk))
        boxes, classes, scores = unpack_detections(packed.cpu().numpy())
        for i in range(len(chunk)):
            want = render_detections_compact(chunk[i], boxes[i], classes[i], scores[i], labelmap, 264)
            got = Image.open(out["paths"][start + i]).convert("RGB")
            assert np.array_equal(np.asarray(got), np.asarray(want)), start + i


# ---------------------------------------------------------------- serving plumbing


def test_custom_ops_launch_the_kernels(card):
    """torch.ops.odt.* on CUDA tensors launch the kernels (the counters
    count) and equal the plain versions; the ops pass torch.library's checks."""
    from torch.library import opcheck

    from object_detection_torch2_tpu_torch.ops import registry

    sb, sv = _sorted_clustered(np.random.default_rng(31), 4, 300, True, card)
    before = nms_cuda.launches
    got = torch.ops.odt.nms_keep_sorted(sb, sv, 0.5)
    torch.cuda.synchronize()
    assert nms_cuda.launches == before + 1 and torch.equal(got, nms._blocked_keep_sorted(sb, sv, 0.5))
    opcheck(registry.nms_keep_sorted, (sb, sv, 0.5))
    rng = np.random.default_rng(32)
    x = torch.from_numpy(np.maximum(rng.standard_normal((2, 20, 24, 64), dtype=np.float32), 0)).to(card)
    x = x.permute(0, 3, 1, 2)
    w = torch.from_numpy((0.06 * rng.standard_normal((64, 64, 3, 3))).astype(np.float32)).to(card)
    b = torch.from_numpy((0.1 * rng.standard_normal(64)).astype(np.float32)).to(card)
    before = conv12_cuda.launches
    y = torch.ops.odt.conv12(x, w, b, None)
    torch.cuda.synchronize()
    assert conv12_cuda.launches == before + 1
    torch.testing.assert_close(y, conv12_plain(x, w, b), rtol=1e-4, atol=1e-4)
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with true_float32():
        (registry.conv12(xs, ws, b, None) ** 2).sum().backward()
    assert xs.grad is not None and ws.grad is not None


def test_fetch_pipeline_over_cuda_tensors(card):
    """CUDA leaves come back `depth` pushes later as pinned host tensors with
    the right values; buffers are reused from depth + 1 slots."""
    from object_detection_torch2_tpu_torch.utils.hostsync import FetchPipeline

    pipe = FetchPipeline(2)
    got = []
    for i in range(7):
        x = torch.full((32, 200, 6), float(i), device=card)
        out = pipe.push({"x": x * 2, "n": torch.arange(4, device=card) + i, "i": i})
        if out is not None:
            got.append(out)
            assert out["x"].device.type == "cpu" and out["x"].is_pinned()
            assert bool((out["x"] == 2 * out["i"]).all()) and out["n"].tolist() == [out["i"] + k for k in range(4)]
    got += list(pipe.flush())
    assert [g["i"] for g in got] == list(range(7))
    ptrs = {g["x"].data_ptr() for g in got}
    assert len(ptrs) == 3


def test_device_cache_on_the_card(card, tmp_path):
    """The records upload to the card (in several chunks) and gathers there
    equal the records' rows; DataLoader(device_cache=True) yields CUDA
    batches equal to streaming."""
    import json

    from object_detection_torch2_tpu_torch.data import device_cache
    from object_detection_torch2_tpu_torch.data.loader import DataLoader
    from object_detection_torch2_tpu_torch.data.records import RecordDataset

    rng = np.random.default_rng(33)
    tmp_path.mkdir(exist_ok=True)
    np.save(tmp_path / "images.npy", rng.integers(0, 256, (9, 64, 64, 3), dtype=np.uint8))
    np.save(tmp_path / "gts.npy", rng.uniform(size=(9, 4, 25)).astype(np.float32))
    (tmp_path / "meta.json").write_text(json.dumps({"count": 9, "purpose": "detection"}))
    ds = RecordDataset(tmp_path)
    old = device_cache.UPLOAD_CHUNK_BYTES
    device_cache.UPLOAD_CHUNK_BYTES = 2 * 64 * 64 * 3
    try:
        cache = device_cache.DeviceCache(ds, verbose=False)
    finally:
        device_cache.UPLOAD_CHUNK_BYTES = old
    assert cache.images.device.type == "cuda"
    images, gts = cache.gather(np.array([[8, 1], [3, 3]]))
    assert images.device.type == "cuda" and images.shape == (2, 2, 64, 64, 3)
    np.testing.assert_array_equal(images[0, 0].cpu().numpy(), ds.images[8])
    np.testing.assert_array_equal(gts[1, 1].cpu().numpy(), ds.gts[3])
    stream = DataLoader(ds, 2, shuffle=True, seed=5, max_gt=4)
    cached = DataLoader(ds, 2, shuffle=True, seed=5, max_gt=4, device_cache=True)
    for (ia, ga), (ib, gb) in zip(stream, cached, strict=True):
        assert ib.device.type == "cuda"
        np.testing.assert_array_equal(ia, ib.cpu().numpy())
        np.testing.assert_array_equal(ga, gb.cpu().numpy())


# ------------------------------------------------------------ int8 conv

# (n, cin, h, w, cout, kernel, stride, pad): each kind of quantized layer, at
# small sizes, with ragged M and Cout
INT8_CASES = [
    (3, 64, 19, 23, 128, 3, 1, 1),
    (2, 128, 10, 10, 100, 3, 1, 1),
    (2, 256, 5, 7, 150, 3, 1, 1),
    (3, 1024, 19, 19, 256, 1, 1, 0),
    (2, 256, 19, 19, 512, 3, 2, 1),
    (5, 128, 5, 5, 256, 3, 1, 0),
    (4, 128, 3, 3, 256, 3, 1, 0),
    (1, 32, 1, 1, 8, 1, 1, 0),
    # the K tail and the ragged N together: K = 288 and 576 are not multiples
    # of a 128-byte stage, Cout 150 half-fills the second 128-wide N half
    (2, 32, 1, 1, 150, 3, 1, 1),
    (3, 64, 10, 10, 150, 3, 1, 1),
]


def _int8_case(rng, n, cin, h, w, cout, k, device):
    x8 = torch.from_numpy(rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8)).to(device).permute(0, 3, 1, 2)
    w8 = torch.from_numpy(rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)).to(device)
    scale = torch.from_numpy((rng.uniform(0.5, 2.0, cout) * 1e-4).astype(np.float32)).to(device)
    bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32)).to(device)
    return x8, w8, scale, bias


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_conv_kernel_equals_plain(card, case):
    """The raw int32 sums and both epilogues bit-equal to int8_conv_plain on
    the card, one launch each, at full-scale int8 operands."""
    from object_detection_torch2_tpu_torch.ops import int8_conv_cuda
    from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv_plain

    n, cin, h, w, cout, k, stride, pad = case
    x8, w8, scale, bias = _int8_case(np.random.default_rng(sum(case)), n, cin, h, w, cout, k, card)
    for sc, b, dtype in ((None, None, None), (scale, bias, torch.float32), (scale, bias.bfloat16(), torch.bfloat16),
                         (scale, None, torch.bfloat16)):
        before = int8_conv_cuda.kernel_launches
        got = int8_conv_cuda.int8_conv_cuda(x8, w8, sc, b, stride, pad, dtype)
        torch.cuda.synchronize()
        assert int8_conv_cuda.kernel_launches == before + 1
        want = int8_conv_plain(x8, w8, sc, b, stride, pad, dtype)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want), (case, dtype, float((got.double() - want.double()).abs().max()))


def test_int8_conv_wrapper_refusals(card):
    from object_detection_torch2_tpu_torch.ops import int8_conv_cuda

    x8, w8, scale, bias = _int8_case(np.random.default_rng(0), 2, 64, 8, 8, 16, 3, card)
    with pytest.raises(ValueError, match="multiple of 32"):
        int8_conv_cuda.int8_conv_cuda(x8[:, :48].contiguous(memory_format=torch.channels_last),
                                      w8[..., :48].contiguous())
    with pytest.raises(ValueError, match="channels_last"):
        int8_conv_cuda.int8_conv_cuda(x8.contiguous(), w8)
    with pytest.raises(ValueError, match="bias"):
        int8_conv_cuda.int8_conv_cuda(x8, w8, scale, bias.bfloat16(), 1, 1, torch.float32)
    with pytest.raises(ValueError, match="8-byte aligned"):
        int8_conv_cuda.int8_conv_cuda(x8, w8, torch.cat([scale[:1], scale])[1:], bias, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        int8_conv_cuda.int8_conv_cuda(x8.cpu(), w8)
    with pytest.raises(TypeError, match="int8"):
        int8_conv_cuda.int8_conv_cuda(x8.float(), w8)


def test_int8_library_has_tensor_core_instructions(card):
    """The int8 conv is the wgmma kernel: IGMMA in its machine code."""
    counts = _build.tensor_core_instructions("int8_conv")
    assert counts["IGMMA"] > 0, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_quantize_act_kernel_equals_plain(card, dtype, reciprocal):
    """The one-pass quantize bit-equal to models/quant.py's quantize_act on
    the card, one launch a call, on exact ties (k + 0.5) * sx, values beyond
    +-127 sx and -0.0, at a ragged element count (a scalar tail) and at a
    layer's shape; a contiguous NCHW input is refused, not copied."""
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.ops import quantize_act_cuda

    rng = np.random.default_rng(3 + reciprocal)
    for shape, sx in (((2, 32, 7, 5), np.float32(2.0 ** -5)), ((3, 256, 75, 75), np.float32(0.0371)),
                      ((1, 48, 1, 3), np.float32(0.11))):
        x = ((rng.integers(-140, 140, shape) + 0.5) * sx).astype(np.float32)
        x.reshape(-1)[: x.size // 2] = rng.uniform(-200 * sx, 200 * sx, x.size // 2)
        x.reshape(-1)[:3] = (-0.0, 1e30, -np.inf)
        xt = torch.from_numpy(x).to(card).to(dtype).contiguous(memory_format=torch.channels_last)
        s = torch.tensor(sx, device=card)
        before = quantize_act_cuda.kernel_launches
        got = quantize_act_cuda.quantize_act_cuda(xt, s, reciprocal)
        torch.cuda.synchronize()
        assert quantize_act_cuda.kernel_launches == before + 1
        want = quant.quantize_act(xt, s, reciprocal)
        assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want), (shape, int((got != want).sum()))
    with pytest.raises(ValueError, match="channels_last"):
        quantize_act_cuda.quantize_act_cuda(xt.contiguous(), s)
    with pytest.raises(ValueError, match="0-d float32"):
        quantize_act_cuda.quantize_act_cuda(xt, s.double())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_ssd_on_the_card_equals_the_plain_conv(card, dtype, monkeypatch):
    """SSD(full_int8) at 264 on the card: its calibration, 27 int8 conv and
    27 quantize launches a forward, and the output identical to the same
    forward with the plain int8 conv and the plain quantize in place of the
    kernels."""
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.models import ssd as ssd_mod
    from object_detection_torch2_tpu_torch.ops import int8_conv_cuda, quantize_act_cuda
    from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv_plain

    model = SSD(num_classes=21, dtype=dtype, seed=0).to(card)
    x = torch.from_numpy(np.random.default_rng(7).random((2, 264, 264, 3)).astype(np.float32)).to(card)
    qd = quant.calibrate_full(model, [x])
    model.set_quant(qd)
    model.full_int8 = True
    before = int8_conv_cuda.kernel_launches, quantize_act_cuda.kernel_launches
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert (int8_conv_cuda.kernel_launches, quantize_act_cuda.kernel_launches) == (before[0] + 27, before[1] + 27)
    monkeypatch.setattr(ssd_mod, "int8_conv", int8_conv_plain)
    monkeypatch.setattr(ssd_mod, "quantize_act", lambda x, sx, reciprocal: quant.quantize_act(x, sx, reciprocal))
    with torch.no_grad():
        want = model(x)
    assert torch.equal(got, want)


# ------------------------------------------------------------ data parallelism


def _dp_step(mesh, images, targets, dtype=torch.float32):
    """One SGD step of a seeded SSD at imsize 264 on this rank's rows (all
    rows without a mesh), cuDNN deterministic: the loss, the trained
    parameters on the host and the conv12 launches."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.parallel.mesh import local_rows
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.deterministic = True
    trainer = Trainer(SSD(num_classes=21, dtype=dtype, conv12_kernel=True),
                      default_boxes=default_boxes(feature_grids_for(264)), mesh=mesh,
                      device=None if mesh is not None else "cuda")
    state = trainer.init_state(lambda ps: torch.optim.SGD(ps, lr=1e-3))
    before = conv12_cuda.kernel_launches[conv12_cuda.KERNEL_OF[dtype]]
    loss = trainer.train_step(state, local_rows(images, mesh), local_rows(targets, mesh))
    torch.cuda.synchronize()
    return {"loss": float(loss), "params": {k: p.detach().cpu() for k, p in state.trainable.items()},
            "launches": conv12_cuda.kernel_launches[conv12_cuda.KERNEL_OF[dtype]] - before}


def _dp_batch():
    rng = np.random.default_rng(12)
    images = rng.integers(0, 256, (4, 264, 264, 3), dtype=np.uint8)
    targets = np.zeros((4, 8, 25), np.float32)
    targets[:, :2, :4] = rng.uniform(0.2, 0.6, (4, 2, 4))
    targets[:, :2, 9] = 1.0
    return images, targets


def test_nccl_world_one_trainer_equals_plain_without_host_syncs(card, tmp_path):
    """A mesh of one NCCL rank: `Trainer(mesh=)` takes the plain Trainer's
    augmented bfloat16 Adam steps bit for bit (the synced statistics and the
    gradient all-reduce over one rank are identities), launches the conv12
    kernel once a step, and waits on the card nowhere."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.parallel import mesh as mesh_lib
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    mesh = mesh_lib.init_process(0, 1, tmp_path / "store", backend="nccl")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        images, targets = _dp_batch()
        runs = {}
        for name, m in (("plain", None), ("mesh", mesh)):
            trainer = Trainer(SSD(num_classes=21, dtype=torch.bfloat16, conv12_kernel=True),
                              default_boxes=default_boxes(feature_grids_for(264)), augment=True, mesh=m,
                              device=card)
            state = trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4))
            losses = [trainer.train_step(state, images, targets)]
            torch.cuda.synchronize()
            before = conv12_cuda.kernel_launches["conv12_bf16"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                losses += [trainer.train_step(state, images, targets) for _ in range(2)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert conv12_cuda.kernel_launches["conv12_bf16"] - before == 2
            runs[name] = (torch.stack(losses).cpu(), {k: v.cpu() for k, v in state.model.state_dict().items()})
        assert torch.equal(runs["mesh"][0], runs["plain"][0])
        for key, value in runs["plain"][1].items():
            assert torch.equal(runs["mesh"][1][key], value), key
    finally:
        torch.backends.cudnn.deterministic = deterministic
        mesh_lib.shutdown()


def test_gloo_two_ranks_on_one_card_equal_one_process(card):
    """2 gloo ranks on the one card (NCCL refuses two ranks on one GPU), 2
    images each: a float32 SGD step against one process over the 4 images,
    at the CPU tests' tolerances; both ranks bit-identical; the conv12
    kernel launched once on each rank."""
    from object_detection_torch2_tpu_torch.parallel.mesh import launch

    images, targets = _dp_batch()
    ranks = launch(_dp_step, 2, (images, targets), backend="gloo", devices=["cuda:0", "cuda:0"], timeout=300)
    one = _dp_step(None, images, targets)
    assert [r["launches"] for r in ranks] == [1, 1]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], rtol=1e-5)
    for key, value in one["params"].items():
        assert torch.equal(ranks[0]["params"][key], ranks[1]["params"][key]), key
        np.testing.assert_allclose(ranks[0]["params"][key].numpy(), value.numpy(), rtol=1e-4, atol=4e-6, err_msg=key)


@pytest.fixture(scope="module")
def vgg_golden(card):
    """(golden, its images NHWC on the card, the port's float32 VGG16 on the
    golden's weights on the card): tests/test_torch_vgg.py's golden forward,
    its weights drawn with chip_smoke.py's copy of the recipe (this file
    imports nothing of the JAX package)."""
    from pathlib import Path

    import chip_smoke
    from object_detection_torch2_tpu_torch.models.convert import (
        vgg16_state_dict_from_jax_variables,
        vgg16_variables_from_torch,
    )
    from object_detection_torch2_tpu_torch.models.vgg16 import VGG16

    g = np.load(Path(__file__).parent / "goldens" / "vgg_forward.npz")
    sd = chip_smoke.synth_state_dict(chip_smoke.unpack_manifest(g["manifest_keys"], g["manifest_shapes"]),
                                     chip_smoke.synth_array)
    model = VGG16(num_classes=20)
    model.load_state_dict(vgg16_state_dict_from_jax_variables(vgg16_variables_from_torch(sd)))
    x = torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1))).to(card)
    return g, x, model.to(card).eval()


@pytest.mark.parametrize("transfer,use_batch_stats,key,atol", [
    (False, False, "out_eval", 5e-2),
    (True, False, "out_transfer", 5e-2),
    (False, True, "out_bn_batch", 5e-3),
])
def test_vgg16_forward_matches_golden_on_the_card(vgg_golden, transfer, use_batch_stats, key, atol):
    """tests/test_torch_vgg.py::test_forward_matches_golden on the card, at
    its atols: the float32 policy of `true_float32` (no cuDNN) rounds as the
    reference's direct sums do."""
    g, x, model = vgg_golden
    model.transfer_learning = transfer
    with torch.no_grad():
        out = model(x, train=False, use_batch_stats=use_batch_stats)
    assert out.shape == (2, 20 if transfer else 1000) and out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(), g[key], atol=atol)


def test_float32_ssd_rows_do_not_depend_on_the_batch_split(card):
    """float32, running statistics: each image's SSD outputs at batch 4 are
    bit-equal to its outputs in two batch-2 calls (what 2 serving ranks
    compute), and the forward ran no cuDNN kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = SSD(num_classes=21, seed=0).to(card).eval()
    images = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 300, 300, 3), dtype=np.uint8))
    x = images.to(card).float() / 255.0
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        whole = model(x, use_batch_stats=False)
        halves = torch.cat([model(x[:2], use_batch_stats=False), model(x[2:], use_batch_stats=False)])
        torch.cuda.synchronize()
    assert torch.equal(whole, halves)
    kernels = {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}
    cudnn = [k for k in kernels if any(m in k.lower() for m in ("cudnn", "fprop", "convolve", "fft", "winograd"))]
    assert kernels and not cudnn, sorted(kernels)


BN_SHAPES = ((5, 64, 21, 19), (5, 3, 7, 9), (5, 256, 3, 3), (5, 256, 1, 1), (5, 1024, 19, 19), (5, 64, 150, 150))


def _bn_bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64])
def test_bn_moments_kernel_equals_plain(card, dtype):
    """csrc/bn_moments.cu against `bn_moments_plain` on the card, NCHW and
    channels_last (the extras' 1 x 1 and 3 x 3 maps, an odd channel count,
    a chunked 150 x 150 map): each float64 sum within 1e-12 of its
    magnitude; the rows of a batch of 5 bit-equal to those of its splits
    (1 + 4, 2 + 3, 5 single images) and of a second call; one launch a
    call."""
    from object_detection_torch2_tpu_torch.ops import bn_moments_cuda
    from object_detection_torch2_tpu_torch.ops.bn_moments import bn_moments_plain

    g = torch.Generator(device=card).manual_seed(7)
    for shape in BN_SHAPES:
        base = (torch.randn(shape, generator=g, device=card, dtype=torch.float64) * 3.0 + 1.5).to(dtype)
        for x in (base, base.contiguous(memory_format=torch.channels_last)):
            before = bn_moments_cuda.kernel_launches
            got = bn_moments_cuda.bn_moments_cuda(x)
            torch.cuda.synchronize()
            assert bn_moments_cuda.kernel_launches == before + 1
            want = bn_moments_plain(x)
            assert got.shape == (shape[0], 2, shape[1]) and got.dtype == torch.float64
            mag = torch.stack([x.abs().sum(dim=(2, 3), dtype=torch.float64), want[:, 1]], dim=1)
            assert bool(((got - want).abs() <= 1e-12 * mag).all()), (shape, x.stride())
            for split in ([1, 4], [2, 3], [1] * 5):
                parts = torch.cat([bn_moments_cuda.bn_moments_cuda(p) for p in x.split(split)])
                assert torch.equal(_bn_bits(parts), _bn_bits(got)), (shape, x.stride(), split)
            assert torch.equal(_bn_bits(bn_moments_cuda.bn_moments_cuda(x)), _bn_bits(got))


def test_bn_moments_wrapper_refusals(card):
    """The kernel's wrapper raises on what the kernel does not take, and
    copies nothing: a CPU tensor, float16, a layout that is neither NCHW nor
    channels_last, a view that is not 16-byte aligned where the shape takes
    16-byte loads; through its custom op it passes torch.library's checks
    on the card."""
    from torch.library import opcheck

    from object_detection_torch2_tpu_torch.ops import bn_moments_cuda, registry

    x = torch.randn(2, 8, 4, 4, device=card)
    opcheck(registry.bn_moments, (x.clone().requires_grad_(True),))
    with pytest.raises(ValueError, match="CUDA"):
        bn_moments_cuda.bn_moments_cuda(x.cpu())
    with pytest.raises(TypeError, match="float64"):
        bn_moments_cuda.bn_moments_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        bn_moments_cuda.bn_moments_cuda(x[:, :, ::2])
    flat = torch.randn(1 + 2 * 8 * 4 * 4, device=card)
    with pytest.raises(ValueError, match="aligned"):
        bn_moments_cuda.bn_moments_cuda(flat[1:].view(2, 8, 4, 4))


def test_ssd_with_batch_statistics_launches_the_moments_kernel(card):
    """A training-mode SSD300 forward with batch statistics at batch 2 on
    the card launches the moments kernel once a BatchNorm (23), and its
    float32 output and gradients are bit-equal over two runs."""
    from object_detection_torch2_tpu_torch.ops import bn_moments_cuda

    model = SSD(num_classes=21, seed=0).to(card).train()
    x = torch.from_numpy(np.random.default_rng(5).random((2, 300, 300, 3), dtype=np.float32)).to(card)
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        before = bn_moments_cuda.kernel_launches
        out = model(x, use_batch_stats=True)
        assert bn_moments_cuda.kernel_launches == before + 23
        out.square().mean().backward()
        runs.append([out.detach()] + [p.grad.clone() for p in model.parameters() if p.grad is not None])
    assert len(runs[0]) > 1 and all(torch.equal(a, b) for a, b in zip(*runs))

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

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
    monkeypatch.setattr(nms_cuda, "MASK_SCRATCH_CAP_BYTES", need - 1)
    before = nms_cuda.launches
    with pytest.raises(ValueError, match="scratch"):
        nms_cuda.nms_keep_sorted_cuda(sb, sv)
    assert nms_cuda.launches == before
    monkeypatch.setattr(nms_cuda, "MASK_SCRATCH_CAP_BYTES", need)
    assert torch.equal(nms_cuda.nms_keep_sorted_cuda(sb, sv), nms._blocked_keep_sorted(sb, sv, 0.5))


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

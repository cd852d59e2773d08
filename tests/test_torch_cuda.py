"""The port's CUDA kernels on the card. Every test here carries the `cuda`
marker and skips without a CUDA device. The file imports no JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch.ops import _build, nms, nms_cuda

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


@pytest.mark.parametrize("p", [1, 100, 128, 129, 1024, 8732])
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


def test_kernel_other_thresholds_and_nan(card):
    rng = np.random.default_rng(3)
    sb, sv = _sorted_clustered(rng, 4, 700, True, card)
    sb[:, 5] = float("nan")
    sb[:, 9, 2] = float("inf")
    for thresh in (0.0, 0.3, 0.7):
        assert torch.equal(nms_cuda.nms_keep_sorted_cuda(sb, sv, thresh), nms._blocked_keep_sorted(sb, sv, thresh))


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

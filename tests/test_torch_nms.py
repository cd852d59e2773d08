"""Port parity for the NMS module that holds the CUDA kernel (ops/nms.py,
ops/nms_cuda.py). On identical float32 inputs the port's keep masks must be
EXACTLY equal to the JAX package's serial loop, its blocked-XLA sweep and its
Pallas kernel (run in interpret mode, as tests/test_nms_pallas.py runs it).

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py holds
it against the plain sweep there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.ops import nms as jax_nms
from object_detection_torch2_tpu.ops.nms_pallas import nms_keep_mask_pallas
from object_detection_torch2_tpu_torch.ops import _build, nms, nms_cuda

torch.set_num_threads(1)


def _with_interpret(fn):
    from jax.experimental.pallas import tpu as pltpu

    def run(*args, **kwargs):
        with pltpu.force_tpu_interpret_mode():
            return fn(*args, **kwargs)

    return run


def _clustered(rng, n, p, clusters=6, spread=0.04):
    boxes = np.zeros((n, p, 4), np.float32)
    centers = rng.uniform(0.1, 0.9, (n, clusters, 2))
    pick = rng.integers(0, clusters, (n, p))
    boxes[..., :2] = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, spread, (n, p, 2))
    boxes[..., 2:] = rng.uniform(0.05, 0.35, (n, p, 2))
    return boxes


def _tied(rng, n, p):
    """Exact duplicate boxes with exactly tied scores, and tied scores on
    disjoint boxes."""
    boxes = _clustered(rng, n, p)
    boxes[:, 1::7] = boxes[:, 0:1]
    scores = np.round(rng.uniform(-0.2, 1.0, (n, p)), 1).astype(np.float32)
    scores[:, 1::7] = scores[:, 0:1]
    return boxes, scores


def _scores_with_positives(rng, n, p, n_pos):
    scores = np.zeros((n, p), np.float32)
    for i in range(n):
        idx = rng.choice(p, n_pos, replace=False)
        scores[i, idx] = rng.uniform(0.05, 1.0, n_pos)
    return scores


def _sorted(boxes, scores):
    order = np.argsort(-scores, axis=-1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], axis=1),
            np.take_along_axis(scores, order, axis=1) > 0.0)


def _port_masks(boxes, scores, thresh):
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    sb, sv = _sorted(boxes, scores)
    return {
        "serial": nms.nms_keep_mask_serial(b, s, thresh).numpy(),
        "nms_keep_mask": nms.nms_keep_mask(b, s, thresh).numpy(),
        "blocked_sorted": nms._blocked_keep_sorted(torch.from_numpy(sb), torch.from_numpy(sv), thresh).numpy(),
        "keep_sorted_cpu": nms_cuda.keep_sorted(torch.from_numpy(sb), torch.from_numpy(sv), thresh).numpy(),
    }


def _jax_masks(boxes, scores, thresh, pallas):
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    sb, sv = _sorted(boxes, scores)
    out = {
        "serial": np.asarray(jax_nms.nms_keep_mask_serial(jb, js, thresh)),
        "xla": np.asarray(jax_nms.nms_keep_mask(jb, js, thresh, dense_backend="xla")),
        "blocked_sorted": np.asarray(jax_nms._blocked_keep_sorted(jnp.asarray(sb), jnp.asarray(sv), thresh)),
    }
    if pallas:
        out["pallas"] = np.asarray(_with_interpret(nms_keep_mask_pallas)(jb, js, thresh))
    return out


def _assert_all_equal(boxes, scores, thresh=0.5, pallas=False):
    port = _port_masks(boxes, scores, thresh)
    ref = _jax_masks(boxes, scores, thresh, pallas)
    for name in ("serial", "nms_keep_mask"):
        np.testing.assert_array_equal(port[name], ref["serial"], err_msg=name)
        np.testing.assert_array_equal(port[name], ref["xla"], err_msg=name)
        if pallas:
            np.testing.assert_array_equal(port[name], ref["pallas"], err_msg=name)
    for name in ("blocked_sorted", "keep_sorted_cpu"):
        np.testing.assert_array_equal(port[name], ref["blocked_sorted"], err_msg=name)
    return port["serial"]


@pytest.mark.parametrize("p", [130, 300])
@pytest.mark.parametrize("case", ["clustered", "tied"])
def test_keep_masks_equal_jax_and_pallas(p, case):
    rng = np.random.default_rng(7 + p)
    if case == "clustered":
        boxes = _clustered(rng, 2, p)
        scores = rng.uniform(-0.2, 1.0, (2, p)).astype(np.float32)
    else:
        boxes, scores = _tied(rng, 2, p)
    keep = _assert_all_equal(boxes, scores, pallas=True)
    assert keep.any() and not keep.all()


@pytest.mark.parametrize("thresh", [0.3, 0.7])
def test_keep_masks_equal_jax_other_thresholds(thresh):
    rng = np.random.default_rng(11)
    boxes = _clustered(rng, 3, 300, spread=0.03)
    scores = rng.uniform(-0.2, 1.0, (3, 300)).astype(np.float32)
    _assert_all_equal(boxes, scores, thresh)


@pytest.mark.parametrize("n_pos,path", [(100, 128), (128, 128), (129, 1024), (1024, 1024), (1025, "full")])
def test_tiers_and_full_path_equal_jax(n_pos, path):
    """Positive counts that select the 128 tier, the 1024 tier and the full
    sweep at p = 1200; the sweep width seen by `keep_sorted` proves the tier."""
    rng = np.random.default_rng(n_pos)
    p = 1200
    boxes = _clustered(rng, 2, p, clusters=12, spread=0.05)
    scores = _scores_with_positives(rng, 2, p, n_pos)
    widths = []

    def spy(b, v, t):
        widths.append(b.shape[1])
        return nms_cuda.keep_sorted(b, v, t)

    got = nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, sweep=spy).numpy()
    assert widths == [p if path == "full" else path]
    want = np.asarray(jax_nms.nms_keep_mask(jnp.asarray(boxes), jnp.asarray(scores), dense_backend="xla"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_nms.nms_keep_mask_serial(jnp.asarray(boxes),
                                                                               jnp.asarray(scores))))


def test_full_anchor_count_sparse_and_dense_equal_jax():
    rng = np.random.default_rng(12)
    p = 8732
    boxes = np.zeros((2, p, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 1, (2, p, 2))
    boxes[..., 2:] = rng.uniform(0.02, 0.3, (2, p, 2))
    dense = rng.uniform(0, 1, (2, p)).astype(np.float32)
    dense[:, ::3] = 0.0
    sparse = _scores_with_positives(rng, 2, p, 11)
    for scores in (dense, sparse):
        got = nms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores)).numpy()
        want = np.asarray(jax_nms.nms_keep_mask(jnp.asarray(boxes), jnp.asarray(scores), dense_backend="xla"))
        np.testing.assert_array_equal(got, want)


def test_non_maximum_suppression_golden(goldens):
    g = goldens("nms")
    out = nms.non_maximum_suppression(torch.from_numpy(g["nms_in"])).numpy()
    np.testing.assert_allclose(out, g["nms_out"], atol=1e-6)
    np.testing.assert_array_equal(out, np.asarray(jax_nms.non_maximum_suppression(jnp.asarray(g["nms_in"]))))


def test_non_maximum_suppression_ties_golden(goldens):
    """Kept-row multiset equals the executed reference; the stable sort keeps
    the lowest index of an exact-duplicate group, as the JAX package does."""
    g = goldens("nms_ties")
    ours = nms.non_maximum_suppression(torch.from_numpy(g["nms_in"])).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jax_nms.non_maximum_suppression(jnp.asarray(g["nms_in"]))))
    kept = ours[..., 5:].max(-1) > 0
    kept_ref = g["nms_out"][..., 5:].max(-1) > 0
    for i in range(ours.shape[0]):
        rows, rows_ref = ours[i][kept[i]], g["nms_out"][i][kept_ref[i]]
        assert rows.shape == rows_ref.shape
        np.testing.assert_allclose(rows[np.lexsort(rows.T)], rows_ref[np.lexsort(rows_ref.T)], atol=1e-6)


def test_keep_sorted_refuses_other_devices():
    boxes = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        nms_cuda.keep_sorted(boxes, torch.zeros((1, 4), dtype=torch.bool, device="meta"))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper checks its inputs before it loads or builds anything."""
    before = nms_cuda.launches
    with pytest.raises(ValueError):
        nms_cuda.nms_keep_sorted_cuda(torch.zeros((1, 4, 4)), torch.zeros((1, 4), dtype=torch.bool))
    assert nms_cuda.launches == before


def test_build_flags_and_missing_nvcc(monkeypatch, tmp_path):
    """The NMS kernel is built for sm_90a without FMA contraction or fast
    math, both conv_1_2 kernels, the int8 conv and the activation quantize
    (whose float arithmetic uses explicit round-to-nearest intrinsics) with
    FMA contraction; each source has its own build directory, keyed by its
    flags; and a machine without nvcc gets an error that says so."""
    srcs = {s.name: s for s in _build.sources()}
    assert sorted(srcs) == ["conv12.cu", "conv12_bf16.cu", "int8_conv.cu", "nms_keep_sorted.cu", "quantize_act.cu"]
    nms_cmd = _build.nvcc_command("nvcc", srcs["nms_keep_sorted.cu"], tmp_path / "lib.so")
    conv_cmds = [_build.nvcc_command("nvcc", srcs[f], tmp_path / "lib.so")
                 for f in ("conv12.cu", "conv12_bf16.cu", "int8_conv.cu", "quantize_act.cu")]
    for cmd in (nms_cmd, *conv_cmds):
        assert "arch=compute_90a,code=sm_90a" in cmd and "--use_fast_math" not in cmd
    assert "-fmad=false" in nms_cmd and all("-fmad=false" not in cmd for cmd in conv_cmds)
    assert len({_build.build_dir(s.stem) for s in srcs.values()}) == 5
    before = _build.build_dir("conv12")
    monkeypatch.setitem(_build.SOURCE_FLAGS, "conv12", ("-DEXTRA",))
    assert _build.build_dir("conv12") != before
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not list(tmp_path.glob("*/*.so"))


def test_tensor_core_opcode_count():
    """The SASS parser behind chip_smoke.py's tensor-core check: opcodes after
    the address, with or without a predicate guard; encodings, labels and
    other opcodes are not counted."""
    sass = """
        Function : _Z6kernelv
        /*0a40*/                   HMMA.16816.F32.BF16 R24, R4, R20, R24 ;    /* 0x000000140418723c */
                                                                              /* 0x004fe20000041818 */
        /*0a50*/              @!P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0a60*/              @UP1 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0a70*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0a80*/                   FMNMX.NAN R27, R15, R8, !PT ;
        /*0a90*/                   IMMA.16832.S8.S8 R40, R12.ROW, R16.COL, R40 ;
    .L_x_12:
"""
    assert _build.count_tensor_core_opcodes(sass) == {"HMMA": 1, "HGMMA": 2, "IMMA": 1, "IGMMA": 0}
    assert _build.count_tensor_core_opcodes("") == {"HMMA": 0, "HGMMA": 0, "IMMA": 0, "IGMMA": 0}


def _kernel_model_keep_sorted(sorted_boxes, sorted_valid, thresh, tile=64):
    """The CUDA sweep's algorithm (csrc/nms_keep_sorted.cu) in plain PyTorch:
    the mask kernel's words in its bit order, then the resolve kernel's walk
    over 64-wide blocks (a greedy on the diagonal word, then the kept rows'
    words OR-ed into `removed`). Words are Python ints; bit c of word (i, cb)
    is overlaps(i, cb*64 + c) and i < cb*64 + c."""
    n, p, _ = sorted_boxes.shape
    nb = -(-p // tile)
    keep = torch.zeros((n, p), dtype=torch.bool)
    for img in range(n):
        iou = nms.pairwise_iou(sorted_boxes[img], sorted_boxes[img])  # (P, P), earlier candidate first
        idx = torch.arange(p)
        over = (iou > thresh) & (idx[:, None] < idx[None, :])
        words = [[sum(1 << c for c in range(min(tile, p - cb * tile)) if over[i, cb * tile + c])
                  for cb in range(nb)] for i in range(p)]
        valid = [sum(1 << c for c in range(min(tile, p - cb * tile)) if sorted_valid[img, cb * tile + c])
                 for cb in range(nb)]
        removed = [0] * nb
        for cb in range(nb):
            alive = valid[cb] & ~removed[cb]
            for s in range(tile):
                if (alive >> s) & 1:
                    alive &= ~words[cb * tile + s][cb]
            for s in range(tile):
                if (alive >> s) & 1:
                    keep[img, cb * tile + s] = True
                    for w in range(cb + 1, nb):
                        removed[w] |= words[cb * tile + s][w]
            if not any(valid[w] & ~removed[w] for w in range(cb + 1, nb)):
                break
    return keep


@pytest.mark.parametrize("p", [1, 63, 64, 65, 129, 1024])
def test_kernel_algorithm_model_equals_serial_and_jax(p):
    """The bit-mask algorithm of the CUDA sweep, modelled on the CPU, on
    clustered boxes with tied scores, exact duplicates and NaN boxes: equal
    to the port's serial loop and plain sweep and to the JAX package's
    serial loop and its `nms_keep_mask`."""
    rng = np.random.default_rng(100 + p)
    n = 2 if p < 1024 else 1
    boxes, scores = _tied(rng, n, p)
    if p > 3:
        boxes[:, 3] = np.nan
        boxes[:, p // 2, 2] = np.nan
    sb, sv = _sorted(boxes, scores)
    got = _kernel_model_keep_sorted(torch.from_numpy(sb), torch.from_numpy(sv), 0.5).numpy()
    np.testing.assert_array_equal(got, nms._blocked_keep_sorted(torch.from_numpy(sb), torch.from_numpy(sv), 0.5).numpy())
    order = np.argsort(-scores, axis=-1, kind="stable")
    keep = np.zeros_like(got)
    np.put_along_axis(keep, order, got, axis=1)
    np.testing.assert_array_equal(keep, nms.nms_keep_mask_serial(torch.from_numpy(boxes), torch.from_numpy(scores)).numpy())
    jb, js = jnp.asarray(boxes), jnp.asarray(scores)
    np.testing.assert_array_equal(keep, np.asarray(jax_nms.nms_keep_mask_serial(jb, js)))
    np.testing.assert_array_equal(keep, np.asarray(jax_nms.nms_keep_mask(jb, js, dense_backend="xla")))
    if p > 1:
        assert keep.any() and not keep.all()


def test_mask_scratch_bytes():
    """One 64-bit word per candidate and 64-wide column block: 306 MB at the
    serving path's 32 x 8732, under the cap."""
    assert nms_cuda.mask_scratch_bytes(1, 1) == 8
    assert nms_cuda.mask_scratch_bytes(2, 64) == 2 * 64 * 8
    assert nms_cuda.mask_scratch_bytes(2, 65) == 2 * 65 * 2 * 8
    assert nms_cuda.mask_scratch_bytes(32, 8732) == 32 * 8732 * 137 * 8
    assert nms_cuda.mask_scratch_bytes(32, 8732) < nms_cuda.MASK_SCRATCH_CAP_BYTES


@pytest.mark.parametrize("n,p,cap,want", [
    (32, 8732, None, [(0, 32)]),
    (224, 8732, None, [(0, 224)]),
    (225, 8732, None, [(0, 224), (224, 225)]),
    (256, 8732, None, [(0, 224), (224, 256)]),
    (1000, 8732, None, [(0, 224), (224, 448), (448, 672), (672, 896), (896, 1000)]),
    (7, 64, 3 * 64 * 8, [(0, 3), (3, 6), (6, 7)]),
    (6, 64, 3 * 64 * 8, [(0, 3), (3, 6)]),
    (6, 64, 3 * 64 * 8 + 7, [(0, 3), (3, 6)]),
    (5, 65, 65 * 2 * 8, [(i, i + 1) for i in range(5)]),
    (0, 8732, None, []),
])
def test_sweep_slices(n, p, cap, want):
    """A batch's NMS sweep in slices whose mask scratch fits the cap: 224
    images at P 8732 under the 2 GiB cap, as few slices as possible, all but
    the last full."""
    cap = nms_cuda.MASK_SCRATCH_CAP_BYTES if cap is None else cap
    got = nms_cuda.sweep_slices(n, p, cap)
    assert got == want
    assert all(nms_cuda.mask_scratch_bytes(stop - start, p) <= cap for start, stop in got)


def test_sweep_slices_refuses_an_image_above_the_cap():
    assert nms_cuda.MASK_SCRATCH_CAP_BYTES // nms_cuda.mask_scratch_bytes(1, 8732) == 224
    with pytest.raises(ValueError, match="one image"):
        nms_cuda.sweep_slices(2, 65, 65 * 2 * 8 - 1)
    # SSD's P is far from the one-image limit (p = 131,072 fills 2 GiB)
    assert nms_cuda.sweep_slices(1, 131072) == [(0, 1)]
    with pytest.raises(ValueError, match="one image"):
        nms_cuda.sweep_slices(1, 131073)

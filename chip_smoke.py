"""Drives the PyTorch/CUDA port's serving path on one CUDA card and checks it.

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: the card's name and power limit (nvidia-smi) — no card, no run;
2. build: the CUDA kernels from object_detection_torch2_tpu_torch/csrc/, with
   nvcc's register and shared-memory report;
3. reference: the port's SSD forward on the card against the reference
   forward golden (tests/goldens/ssd_forward_pinned.npz) at its pinned
   tolerances, in float32 (which also proves cuDNN's TF32 is off) and bfloat16;
4. kernel vs plain: the NMS sweep kernel against its plain PyTorch version on
   the card, on seeded clustered boxes at batch 32 and widths 128, 1024 and
   8732, dense and sparse: the keep masks must be identical;
5. main path: `Predictor(batch_size=32)` on 70 seeded uint8 images (two full
   batches and a ragged one) at imsize 300 with seeded weights, in float32 and
   bfloat16. The NMS launch count is reset just before and read just after;
   detections must be well-formed; the post-processing of one batch is redone
   with the plain sweep on the same forward output and must give identical
   packed rows; then img/s at batch 32;
6. the kernels line (JSON), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX. Every time printed here was measured on the card in
this run and is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "ssd_forward_pinned.npz"
IOU_THRESH = 0.5
BATCH = 32
N_IMAGES = 70
IMSIZE = 300
DEVICE = torch.device("cuda")

# H100 SXM data-sheet peaks: HBM bytes/s and float32 operations/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# float32 operations in one IoU test of the kernel (csrc/nms_keep_sorted.cu
# `overlaps`): 2 min, 2 max, 2 sub, 2 clamps, inter mul, union add and sub,
# inter > 0, the division, the threshold compare
OPS_PER_IOU_TEST = 14


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, trials: int = 5, warmup: int = 2) -> float:
    """Median over `trials` of the mean CUDA-event time of `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / reps)
    return statistics.median(means)


def synth_array_scaled(key: str, shape: tuple) -> np.ndarray:
    """The deterministic weight recipe behind the pinned forward golden (the
    JAX package's utils/testing.py, which this script may not import):
    kaiming fan_out convs, unit BN, zero-centered running statistics, each
    tensor from a numpy generator seeded by its state_dict key."""
    rng = np.random.default_rng(~zlib.crc32(key.encode()) & 0xFFFFFFFF)
    shape = tuple(int(s) for s in shape)
    if key.endswith("num_batches_tracked"):
        return np.zeros(shape, np.int64)
    if key.endswith("running_var"):
        return (1.0 + 0.1 * np.abs(rng.standard_normal(shape))).astype(np.float32)
    if key.endswith("running_mean"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if key.endswith(".weight") and len(shape) == 4:
        fan_out = shape[0] * shape[2] * shape[3]
        return (np.sqrt(2.0 / fan_out) * rng.standard_normal(shape)).astype(np.float32)
    if key.endswith(".weight") and len(shape) == 1:
        return (1.0 + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    return (0.01 * rng.standard_normal(shape)).astype(np.float32)


def phase_reference(card: str) -> dict:
    from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_torch, ssd_state_shapes
    from object_detection_torch2_tpu_torch.models.ssd import SSD

    g = np.load(GOLDEN)
    sd = ssd_state_dict_from_torch({k: synth_array_scaled(k, s) for k, s in ssd_state_shapes(21).items()})
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(g["x"], (0, 2, 3, 1)))).to(DEVICE)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = SSD(num_classes=21, dtype=dtype)
        model.load_state_dict(sd)
        model.to(DEVICE).eval()
        with torch.inference_mode():
            run = model(x, use_batch_stats=False).cpu().numpy()
            batch = model(x, use_batch_stats=True).cpu().numpy()
        assert run.shape == batch.shape == (2, 8732, 25)
        assert np.isfinite(run).all() and np.isfinite(batch).all()
        d_run, d_batch = np.abs(run - g["out_eval"]), np.abs(batch - g["out_train"])
        name = str(dtype).replace("torch.", "")
        res[name] = {"running_max": float(d_run.max()), "batch_max": float(d_batch.max()),
                     "batch_mean": float(d_batch.mean()), "running_mean": float(d_run.mean())}
        print(f"reference forward {name}: running stats max |d| {d_run.max():.3e} mean {d_run.mean():.3e}, "
              f"batch stats max |d| {d_batch.max():.3e} mean {d_batch.mean():.3e} ({card})")
        if dtype == torch.float32:
            # the JAX package's pins (tests/test_models.py)
            assert d_run.max() < 1e-4, "float32 forward is off the golden (is TF32 on?)"
            assert d_batch.max() < 5e-3 and d_batch.mean() < 1e-4
        else:
            # bfloat16 rounds each conv's output to ~3 significant digits; over
            # 35 layers that must stay well under the head outputs' scale (~1).
            # Batch statistics over this 2-image golden are ill-conditioned in
            # bfloat16 (a deep layer's statistics come from 2 samples), so only
            # their finiteness is checked.
            assert d_run.mean() < 1e-2 and d_run.max() < 0.1
    return res


def clustered_sorted(rng, n, p, dense):
    """Seeded clustered boxes (as tests/test_nms_pallas.py makes them), score-
    sorted as the NMS path sorts them: dense = every candidate positive,
    sparse = ~11 positives per image."""
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
            idx = rng.choice(p, 11, replace=False)
            scores[i, idx] = rng.uniform(0.1, 1.0, 11)
    order = np.argsort(-scores, axis=-1, kind="stable")
    sb = np.take_along_axis(boxes, order[..., None], axis=1)
    sv = np.take_along_axis(scores, order, axis=1) > 0.0
    return torch.from_numpy(sb).to(DEVICE), torch.from_numpy(sv).to(DEVICE)


def compare_sweep(sb, sv) -> dict:
    from object_detection_torch2_tpu_torch.ops import nms, nms_cuda

    got = nms_cuda.nms_keep_sorted_cuda(sb, sv, IOU_THRESH)
    torch.cuda.synchronize()
    want = nms._blocked_keep_sorted(sb, sv, IOU_THRESH)
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel keep mask differs from the plain sweep at {tuple(sb.shape)}: "
                             f"{int((got != want).sum())} entries")
    return {
        "equal": True,
        "max_abs_err": err,
        "kept": int(got.sum()),
        "kernel_ms": time_ms(lambda: nms_cuda.nms_keep_sorted_cuda(sb, sv, IOU_THRESH), reps=20),
        "plain_ms": time_ms(lambda: nms._blocked_keep_sorted(sb, sv, IOU_THRESH), reps=2, trials=3, warmup=1),
    }


def phase_kernel_vs_plain(card: str) -> list:
    rng = np.random.default_rng(1234)
    rows = []
    for p in (128, 1024, 8732):
        for dense in (True, False):
            r = compare_sweep(*clustered_sorted(rng, BATCH, p, dense))
            r.update(p=p, case="dense" if dense else "sparse")
            rows.append(r)
            print(f"nms_keep_sorted bs{BATCH} P={p} {r['case']}: identical to plain, kept {r['kept']}, "
                  f"kernel {r['kernel_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms ({card})")
    return rows


def iou_tests_needed(sb, sv, keep) -> int:
    """IoU tests the exact greedy needs on these inputs: each valid candidate
    is tested against the kept candidates before it, in order, up to and
    including the first that suppresses it (all of them when it is kept)."""
    from object_detection_torch2_tpu_torch.core.boxes import pairwise_iou

    total = 0
    for b, v, k in zip(sb, sv, keep):
        kidx = torch.nonzero(k).squeeze(1)
        if kidx.numel() == 0:
            continue
        kept_before = torch.cumsum(k.long(), 0) - k.long()
        for c0 in range(0, b.shape[0], 2048):
            cols = torch.arange(c0, min(c0 + 2048, b.shape[0]), device=b.device)
            over = (pairwise_iou(b[kidx], b[cols]) > IOU_THRESH) & (kidx[:, None] < cols[None, :])
            hit = over.any(0)
            first = over.float().argmax(0)
            tests = torch.where(hit, first + 1, kept_before[cols]) * v[cols]
            total += int(tests.sum())
    return total


def phase_main_path(card: str) -> dict:
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
    from object_detection_torch2_tpu_torch.infer import Predictor, postprocess
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import nms, nms_cuda

    images = np.random.default_rng(0).integers(0, 256, (N_IMAGES, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    df = torch.from_numpy(default_boxes(feature_grids_for(IMSIZE)).copy()).to(DEVICE)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        model = SSD(num_classes=21, dtype=dtype, seed=0)
        pred = Predictor(model, imsize=IMSIZE, batch_size=BATCH)

        nms_cuda.launches = 0
        dets = pred.predict(images)
        launches = nms_cuda.launches
        if launches == 0:
            raise AssertionError("the main path never launched the NMS kernel")

        assert len(dets) == N_IMAGES
        n_det = [len(d.scores) for d in dets]
        for d in dets:
            assert d.boxes.shape == (len(d.scores), 4) and len(d.class_ids) == len(d.scores)
            assert np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()
            assert len(d.scores) == 0 or (d.class_ids.min() >= 0 and d.class_ids.max() <= 19)
            assert ((d.scores > 0) & (d.scores <= 1)).all()
            assert (np.diff(d.scores) <= 0).all()

        # one batch again: the same forward output post-processed with the
        # kernel and with the plain sweep must give identical packed rows
        captured = {}

        def plain_capture(b, v, t):
            captured["sb"], captured["sv"] = b.clone(), v.clone()
            return nms._blocked_keep_sorted(b, v, t)

        with torch.inference_mode():
            x = to_tensor_batch(torch.from_numpy(images[:BATCH]).to(DEVICE))
            mask = torch.ones(BATCH, device=DEVICE)
            out = model(x, use_batch_stats=True, batch_mask=mask)
            packed_k, valid_k = postprocess(out, df, mask)
            packed_p, valid_p = postprocess(out, df, mask, sweep=plain_capture)
            torch.cuda.synchronize()
            if not (torch.equal(packed_k, packed_p) and torch.equal(valid_k, valid_p)):
                raise AssertionError("kernel and plain sweep give different packed detections")
            positives = (out[..., 4:].argmax(-1) != 0).sum(-1)

            forward_ms = time_ms(lambda: model(x, use_batch_stats=True, batch_mask=mask), reps=3)
            post_ms = time_ms(lambda: postprocess(out, df, mask), reps=3)
            t = []
            for _ in range(3):
                t0 = time.perf_counter()
                pred.predict(images[:2 * BATCH])
                t.append(time.perf_counter() - t0)
        img_s = 2 * BATCH / statistics.median(t)
        res[name] = {"launches": launches, "launches_per_batch": launches / -(-N_IMAGES // BATCH),
                     "img_per_s": img_s, "forward_ms": forward_ms, "post_ms": post_ms,
                     "detections_per_image_min": min(n_det), "detections_per_image_max": max(n_det),
                     "positives_per_image_min": int(positives.min()), "sweep_width": captured["sb"].shape[1]}
        print(f"main path {name} bs{BATCH}: {img_s:.1f} img/s (forward {forward_ms:.2f} ms, post-processing "
              f"{post_ms:.2f} ms per batch), NMS launches {launches} for {N_IMAGES} images, sweep width "
              f"{captured['sb'].shape[1]}, positives/image >= {int(positives.min())}, packed rows identical "
              f"to the plain sweep ({card})")
        if dtype == torch.float32:
            res["sweep_inputs"] = (captured["sb"], captured["sv"])
    return res


def kernel_entry(main: dict, card: str) -> dict:
    """The kernels-line entry at the main path's own sweep inputs (batch 0 of
    the float32 run): times, equality, and the bound from these inputs."""
    from object_detection_torch2_tpu_torch.ops import nms

    sb, sv = main.pop("sweep_inputs")
    r = compare_sweep(sb, sv)
    keep = nms._blocked_keep_sorted(sb, sv, IOU_THRESH)
    n, p, _ = sb.shape
    bytes_moved = n * p * 16 + n * p + n * p  # boxes and valid in, keep out
    ops = OPS_PER_IOU_TEST * iou_tests_needed(sb, sv, keep)
    bytes_ms, ops_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
    print(f"nms_keep_sorted at the main path's sweep inputs (float32 batch 0, {n} x {p}): identical to plain, "
          f"kept {r['kept']}, {ops // OPS_PER_IOU_TEST} IoU tests needed, kernel {r['kernel_ms']:.4f} ms, "
          f"plain {r['plain_ms']:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms ({card})")
    return {
        "name": "nms_keep_sorted",
        "route": "cuda",
        "source": "object_detection_torch2_tpu_torch/csrc/nms_keep_sorted.cu",
        "replaces": "object_detection_torch2_tpu/ops/nms_pallas.py:59",  # _nms_kernel
        "launches": main["float32"]["launches"],
        "equal_to_plain": r["equal"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["kernel_ms"],
        "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes greedy NMS
        "shape": [n, p],
        "kept": r["kept"],
        "bytes": bytes_moved,
        "operations": ops,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    from object_detection_torch2_tpu_torch.ops import _build

    card = card_line()
    print(card)
    print(f"torch device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in [s.stem for s in _build.sources()]:
        _build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s, built {sorted(logs) or 'nothing (cached)'}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    results = {"card": card, "reference": phase_reference(card)}
    results["kernel_vs_plain"] = phase_kernel_vs_plain(card)
    main_path = phase_main_path(card)
    entry = kernel_entry(main_path, card)
    results["main_path"] = main_path
    results["kernels"] = [entry]
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drives the PyTorch/CUDA port's serving, evaluation and training paths and
its training and inference CLIs on one CUDA card, and checks them.

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: the card's name and power limit (nvidia-smi) — no card, no run;
2. build: the CUDA kernels from object_detection_torch2_tpu_torch/csrc/, one
   nvcc per source, all started together, with nvcc's register, spill and
   shared-memory report and each library's count of tensor-core
   instructions (HMMA, HGMMA) in cuobjdump -sass; the bfloat16 conv_1_2
   library must have some;
3. reference: the port's SSD forward on the card against the reference
   forward golden (tests/goldens/ssd_forward_pinned.npz) at its pinned
   tolerances, in float32 (which also proves cuDNN's TF32 is off) and bfloat16;
4. NMS kernel vs plain: the NMS sweep kernel against its plain PyTorch version
   on the card, on seeded clustered boxes at batch 32 and widths 128, 1024 and
   8732, dense and sparse: the keep masks must be identical;
5. serving main path: `Predictor(batch_size=32)` on 70 seeded uint8 images
   (two full batches and a ragged one) at imsize 300 with seeded weights, in
   float32 and bfloat16. The NMS launch count is reset just before and read
   just after; detections must be well-formed; the post-processing of one
   batch is redone with the plain sweep on the same forward output and must
   give identical packed rows; then img/s at batch 32;
6. evaluation main path: `cli.evaluate.main --records_dir --batch_size 32
   --imsize 300 --strict_ap` in float32 and bfloat16, over 70 seeded records
   (written here with numpy) whose ground truth is planted on the model's own
   top-3 detections of each image from a first `Predictor` pass, with the
   seeded weights saved by the port's `save_weights`. The NMS launch count is
   reset just before and read just after (one per batch: 3); the parity mAP
   must be 1.0 within 1e-6; batch 0's matches through the plain sweep must
   equal the pipeline's element for element; the report is written and the
   weights file gives the saved state back bit-equal. Then eval img/s at
   batch 32 and a batch's split into forward, post-processing, matcher and
   D2H + AP accumulation;
7. conv12 kernels vs plain: the conv_1_2 kernels (float32: csrc/conv12.cu on
   the CUDA cores; bfloat16: csrc/conv12_bf16.cu on the tensor cores) against
   `conv12_plain` on the card at the training path's shape (32, 64, 300, 300)
   channels_last and at a ragged (3, 64, 38, 50), from seeded numpy inputs
   (post-ReLU scale, kaiming fan_out weights). Tolerances: float32
   max |kernel - plain| <= 1e-4 * max |plain|; bfloat16 each element within
   2 bfloat16 ulps of the plain value's magnitude, or 1e-5 * max |plain| near
   zero; the autograd backward of sum(y * r) against plain autograd within
   rtol 1e-4.
   Kernel, plain and F.conv2d (cuDNN) times beside the bound;
8. trajectory replay: tests/goldens/train_trajectory.npz (20 steps, batch 4,
   imsize 300) through `Trainer` with `conv12_kernel=True` in float32, to the
   pins of tests/test_trajectory.py: per-step loss drift < 3e-3, step-0 drift
   < 1e-4, final trainable-parameter and BN-statistics fingerprint budgets;
   the frozen trunk bit-unchanged; one conv12 launch per forward;
9. training main path: SSD300 at batch 32 with G = 64 GT rows, seeded
   weights and batches, `conv12_kernel=True`, in float32 and bfloat16: five
   `train_step`s, one `train_steps` call of K = 3 and one `eval_step`. The
   conv12 launch count is reset just before and read just after. Losses
   finite, the trunk bit-unchanged, every running statistic moved, an
   all-void batch's loss exactly 0.0, and one step on the kernel path against
   the same step with conv_1_2 on cuDNN (tolerances in `compare_conv12_paths`).
   Each dtype's forwards must have run that dtype's conv_1_2 kernel.
   ms per step (CUDA events) and img/s, and the step split into forward,
   loss, backward and Adam;
10. augment: `data.augment.apply_augment` on the card against the CPU on one
   seeded set of draws at 32 x 300 x 300 (the default probabilities), in
   float32 and bfloat16: GTs equal, erased pixels zero, pixels within the
   CPU tests' tolerance (float32 max |d| <= 2e-6, bfloat16 1 ulp); its ms
   (CUDA events) beside the bytes bound; then `Trainer(augment=True)` steps
   at batch 32 in bfloat16 under `torch.cuda.set_sync_debug_mode("error")`:
   no step waits on the card;
11. training CLI: `cli.train.main --records_dir --val_records_dir
   --batch_size 32 --steps_per_epoch 4` over 128 + 32 seeded numpy-written
   records (G = 64). bfloat16, with cuDNN's deterministic algorithms: 2
   epochs with the full state, then 1 resumed from it, against 3 straight
   in a fresh directory (train augment on, validation un-augmented):
   epoch 3's losses, the full states and the weights files bit-equal.
   float32: one run of 2 epochs. For each run: one conv12 launch per train
   step and per validation batch of the dtype's kernel, the weights file
   read back bit-equal to the full state of its epoch, params.json, the
   three TensorBoard scalars per epoch (CRCs checked), phase_times.json, the
   train-loop and wall img/s;
12. inference CLI: `cli.inference.main --records_dir --batch_size 32` over
   70 seeded records in bfloat16 and float32: 70 PNGs, 3 NMS launches each,
   PNG k pixel-equal to `render_detections_compact` of
   `Predictor(batch_size=32)`'s detections of image k; img/s and the host's
   render ms per batch;
13. the kernels line (JSON; launches summed over the paths that ran each
   kernel, serving, evaluation and the CLIs included), then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX. Every time printed here was measured on the card in
this run and is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "ssd_forward_pinned.npz"
TRAJECTORY = ROOT / "tests" / "goldens" / "train_trajectory.npz"
IOU_THRESH = 0.5
BATCH = 32
N_IMAGES = 70
IMSIZE = 300
DEVICE = torch.device("cuda")
CONV12_SHAPE = (BATCH, 64, IMSIZE, IMSIZE)  # conv_1_2's input on the training path
G_PAD = 64  # GT rows per image, the CLI's padding (object_detection_torch2_tpu/cli/common.py:44)
TRAIN_STEPS = 5
K_STEPS = 3

# H100 SXM data-sheet peaks: HBM bytes/s and float32 operations/s outside
# the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# dense bfloat16 on the tensor cores
PEAK_BF16_OPS_PER_S = 989e12
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


def unpack_manifest(keys, shapes) -> dict:
    """{key: shape} from a golden's manifest (zero-padded shape rows)."""
    out = {}
    for k, row in zip(keys, shapes):
        shape = [int(v) for v in row]
        while shape and shape[-1] == 0:
            shape.pop()
        out[str(k)] = tuple(shape)
    return out


def synth_targets(rng, n: int, g_real, g_pad: int, num_classes: int = 21) -> np.ndarray:
    """The trajectory golden's GT recipe (the JAX package's utils/testing.py):
    (N, G_pad, 4 + C) center-form boxes + one-hot with void at 0, zero rows
    beyond g_real[i]."""
    gts = np.zeros((n, g_pad, 4 + num_classes), np.float32)
    for i in range(n):
        g = int(g_real[i])
        gts[i, :g, :2] = rng.uniform(0.2, 0.8, (g, 2))
        gts[i, :g, 2:4] = rng.uniform(0.05, 0.45, (g, 2))
        gts[i, np.arange(g), 4 + rng.integers(1, num_classes, g)] = 1.0
    return gts


def synth_trajectory_batch(step: int, n: int = 4, imsize: int = 300, g_pad: int = 8):
    """The trajectory golden's batch recipe: (images NCHW in [0, 1], targets)."""
    rng = np.random.default_rng(0xBA7C4 + 7919 * step)
    images = rng.uniform(0.0, 1.0, (n, 3, imsize, imsize)).astype(np.float32)
    return images, synth_targets(rng, n, rng.integers(1, g_pad + 1, n), g_pad)


def fingerprint_tree(tree: dict, k: int = 8):
    """The golden's parameter fingerprints (the JAX package's utils/testing.py):
    (sorted 'layer/leaf' paths, (n, k + 3) rows of [l2, mean, absmax,
    k seeded unit-direction projections])."""
    keys, rows = [], []
    for layer in sorted(tree):
        for leaf in sorted(tree[layer]):
            path = f"{layer}/{leaf}"
            flat = np.asarray(tree[layer][leaf], np.float64).ravel()
            row = [np.sqrt(np.dot(flat, flat)), flat.mean(), np.abs(flat).max()]
            for j in range(k):
                v = np.random.default_rng(zlib.crc32(f"fp:{path}:{j}".encode()) & 0xFFFFFFFF).standard_normal(flat.size)
                row.append(np.dot(flat, v / np.sqrt(np.dot(v, v))))
            keys.append(path)
            rows.append(row)
    return np.array(keys), np.array(rows, np.float64)


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


def write_records(out_dir: Path, images: np.ndarray, gts: np.ndarray):
    """Packed records in the layout of the port's data/records.py, with numpy only."""
    out_dir.mkdir(parents=True)
    np.save(out_dir / "images.npy", images)
    np.save(out_dir / "gts.npy", gts)
    meta = {"imsize": images.shape[1], "max_gt": gts.shape[1], "count": len(images), "purpose": "detection",
            "seen_max_gt": int((gts[..., 4:].sum(-1) > 0).sum(-1).max()), "sources": [], "list_file": ""}
    (out_dir / "meta.json").write_text(json.dumps(meta, indent=4))


def plant_gts(dets) -> np.ndarray:
    """Ground truth on each image's top-3 detections: the detection's box and
    a one-hot of its class + 1 (void at 0), zero rows up to G_PAD."""
    gts = np.zeros((len(dets), G_PAD, 25), np.float32)
    for i, d in enumerate(dets):
        k = min(3, len(d.scores))
        gts[i, :k, :4] = d.boxes[:k]
        gts[i, np.arange(k), 4 + d.class_ids[:k] + 1] = 1.0
    return gts


def unclaimed_gts(run, images: np.ndarray, gts: np.ndarray) -> list:
    """(image, class, planted count, TPs) wherever the pipeline's matches
    claim fewer planted ground truths than there are."""
    misses = []
    for start in range(0, len(images), BATCH):
        real = min(BATCH, len(images) - start)
        pad = np.arange(start, start + BATCH).clip(max=len(images) - 1)
        matches, _ = run(images[pad], gts[pad], real)
        tp = matches["correct"].sum(-1).cpu().numpy()
        counts = matches["counts"].cpu().numpy()
        for i, c in zip(*np.nonzero(tp[:real] < counts[:real])):
            misses.append((start + int(i), int(c), int(counts[i, c]), int(tp[i, c])))
    return misses


def phase_evaluation(card: str) -> dict:
    """The evaluation main path: `cli.evaluate.main` over 70 seeded records
    at batch 32 whose ground truth is planted on the model's own top-3
    detections, so every planted box is claimed exactly once (NMS keeps no two
    boxes at IoU > 0.5) and the parity mAP (recall, quirk Q5) is 1.0."""
    from object_detection_torch2_tpu_torch.cli import evaluate
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
    from object_detection_torch2_tpu_torch.data.loader import DataLoader
    from object_detection_torch2_tpu_torch.data.records import RecordDataset
    from object_detection_torch2_tpu_torch.infer import Predictor, postprocess
    from object_detection_torch2_tpu_torch.metrics.ap import APAccumulator
    from object_detection_torch2_tpu_torch.metrics.assign import detection_matches
    from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import nms, nms_cuda
    from object_detection_torch2_tpu_torch.ops.scores import expand_detections
    from object_detection_torch2_tpu_torch.train.checkpoint import load_weights, save_weights

    images = np.random.default_rng(3).integers(0, 256, (N_IMAGES, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    df = torch.from_numpy(default_boxes(feature_grids_for(IMSIZE)).copy()).to(DEVICE)
    n_batches = -(-N_IMAGES // BATCH)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        model = SSD(num_classes=21, dtype=dtype, seed=0)
        gts = plant_gts(Predictor(model, imsize=IMSIZE, batch_size=BATCH).predict(images))
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            write_records(tmp / "records", images, gts)
            weights = tmp / "result" / "detection" / "weights.msgpack"
            save_weights(weights, model)
            argv = ["--records_dir", str(tmp / "records"), "--result_dir", str(tmp / "result"),
                    "--batch_size", str(BATCH), "--imsize", str(IMSIZE), "--dtype", name, "--strict_ap"]

            nms_cuda.launches = 0
            t0 = time.perf_counter()
            aps, mean_ap, strict_mean, _ = evaluate.main(argv)
            main_s = time.perf_counter() - t0
            launches = nms_cuda.launches
            if launches != n_batches:
                raise AssertionError(f"the evaluation of {N_IMAGES} images launched the NMS kernel {launches} "
                                     f"times, not once for each of its {n_batches} batches")

            run = evaluate.build_eval_pipeline(model, True, IMSIZE, 20, device=DEVICE)
            if not abs(mean_ap - 1.0) <= 1e-6:
                raise AssertionError(f"parity mAP {mean_ap!r} is not 1.0 on planted ground truth (per class {aps}); "
                                     f"(image, class, planted, claimed): {unclaimed_gts(run, images, gts)}")

            reports = list((tmp / "result" / "detection").glob("report_*.md"))
            if len(reports) != 1 or "|**mean**|**1.0**|" not in reports[0].read_text():
                raise AssertionError(f"no report with mean 1.0 written: {reports}")
            saved = ssd_state_dict_from_jax_variables(load_weights(weights))
            for key, v in model.state_dict().items():
                if not torch.equal(saved[key], v.cpu()):
                    raise AssertionError(f"weights file does not give back {key} bit-equal")

            # batch 0 again: the pipeline's matches (NMS kernel) against the
            # plain sweep's on the same forward
            x_u8, g0 = images[:BATCH], torch.from_numpy(gts[:BATCH]).to(DEVICE)
            mask = torch.ones(BATCH, device=DEVICE)
            got, _ = run(x_u8, gts[:BATCH], BATCH)
            with torch.inference_mode():
                out = model(to_tensor_batch(torch.from_numpy(x_u8).to(DEVICE)), use_batch_stats=True,
                            batch_mask=mask)
                packed, _ = postprocess(out, df, mask, sweep=nms._blocked_keep_sorted)
                want = detection_matches(expand_detections(packed[..., :4], packed[..., 4].long(), packed[..., 5], 21),
                                         g0, num_classes=20)
            for key in want:
                if not torch.equal(got[key], want[key]):
                    raise AssertionError(f"evaluation matches '{key}' differ between the NMS kernel and the plain "
                                         f"sweep: {int((got[key] != want[key]).sum())} entries")

            # eval img/s over the two full batches, after the run above warmed
            # everything up; then where a batch's time goes
            loader = DataLoader(RecordDataset(tmp / "records"), BATCH, drop_last=True)
            t = []
            for _ in range(3):
                t0 = time.perf_counter()
                evaluate.accumulate(run, loader, BATCH, 20, 200)
                t.append(time.perf_counter() - t0)
            batch_s = statistics.median(t) / len(loader)
            with torch.inference_mode():
                x = to_tensor_batch(torch.from_numpy(x_u8).to(DEVICE))
                forward_ms = time_ms(lambda: model(x, use_batch_stats=True, batch_mask=mask), reps=3)
                packed, _ = postprocess(out, df, mask)
                post_ms = time_ms(lambda: postprocess(out, df, mask), reps=3)
                compact = expand_detections(packed[..., :4], packed[..., 4].long(), packed[..., 5], 21)
                matcher_ms = time_ms(lambda: detection_matches(
                    expand_detections(packed[..., :4], packed[..., 4].long(), packed[..., 5], 21), g0, 20), reps=10)
                host = []
                for _ in range(5):
                    m = detection_matches(compact, g0, 20)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    APAccumulator(20).update(m)
                    host.append((time.perf_counter() - t0) * 1e3)
        host_ms = statistics.median(host)
        batch_ms = batch_s * 1e3
        other_ms = batch_ms - forward_ms - post_ms - matcher_ms - host_ms
        res[name] = {"launches": launches, "mean_ap": mean_ap, "strict_mean_ap": strict_mean,
                     "aps": [float(a) for a in aps], "main_s": main_s, "img_per_s": BATCH / batch_s,
                     "batch_ms": batch_ms, "forward_ms": forward_ms, "post_ms": post_ms, "matcher_ms": matcher_ms,
                     "host_d2h_ap_ms": host_ms, "rest_ms": other_ms}
        print(f"evaluation main path {name} bs{BATCH}: parity mAP {mean_ap:.7f} (strict {strict_mean:.4f}) on "
              f"{N_IMAGES} records with planted ground truth, NMS launches {launches} for {N_IMAGES} images, "
              f"batch-0 matches identical to the plain sweep's, weights file round trip bit-equal, report written; "
              f"{BATCH / batch_s:.1f} img/s ({batch_ms:.2f} ms a batch: forward {forward_ms:.2f}, post-processing "
              f"{post_ms:.2f}, matcher {matcher_ms:.3f}, D2H + AP accumulation {host_ms:.2f}, rest {other_ms:.2f}); "
              f"main() {main_s:.1f} s ({card})")
        del model, run
        torch.cuda.empty_cache()
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


def conv12_within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
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


def conv12_case(shape, dtype, seed: int):
    """Seeded conv_1_2 operands: x (N, 64, H, W) channels_last at post-ReLU
    scale, w (64, 64, 3, 3) kaiming fan_out, b (64,) float32."""
    n, c, h, w = shape
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((n, h, w, c), dtype=np.float32), 0)
    wt = (np.sqrt(2.0 / (c * 9)) * rng.standard_normal((c, c, 3, 3))).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    xt = torch.from_numpy(x).to(DEVICE).permute(0, 3, 1, 2).to(dtype)
    return xt, torch.from_numpy(wt).to(DEVICE, dtype), torch.from_numpy(b).to(DEVICE)


def conv12_bound(shape, dtype) -> dict:
    """The least time for conv_1_2 at `shape`: x and w read once, y written
    once, over HBM's rate; 2*N*H*W*9*C*C operations over the peak of the
    input's type (float32 on the CUDA cores, bfloat16 on the tensor cores)."""
    n, c, h, w = shape
    item = torch.empty((), dtype=dtype).element_size()
    bytes_moved = 2 * n * c * h * w * item + 9 * c * c * item + 4 * c
    ops = 2 * n * h * w * 9 * c * c
    peak = PEAK_F32_OPS_PER_S if dtype == torch.float32 else PEAK_BF16_OPS_PER_S
    bytes_ms, ops_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "operations": ops}


def compare_conv12(shape, dtype, seed: int, timed: bool) -> dict:
    from object_detection_torch2_tpu_torch import true_float32
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.ops.conv12 import conv12_plain

    x, w, b = conv12_case(shape, dtype, seed)
    got = conv12_cuda.conv12_cuda(x, w, b)
    torch.cuda.synchronize()
    want = conv12_plain(x, w, b)
    err = float((got.float() - want.float()).abs().max())
    if not conv12_within_tolerance(got, want):
        raise AssertionError(f"conv12 kernel is off its plain version at {shape} {dtype}: max |d| {err:.3e}, "
                             f"max |plain| {float(want.abs().max()):.3e}")
    r = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
         "max_abs_plain": float(want.abs().max()), "within_tolerance": True}
    if timed:
        r["kernel_ms"] = time_ms(lambda: conv12_cuda.conv12_cuda(x, w, b), reps=5)
        r["plain_ms"] = time_ms(lambda: conv12_plain(x, w, b), reps=3)
        bl = b.to(dtype)
        with true_float32():
            r["library_ms"] = time_ms(lambda: F.conv2d(x, w, bl, padding=1), reps=5)
        r.update(conv12_bound(shape, dtype))
    return r


def phase_conv12(card: str) -> dict:
    from object_detection_torch2_tpu_torch import true_float32
    from object_detection_torch2_tpu_torch.ops.conv12 import conv12, conv12_plain

    res = {}
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        r = compare_conv12(CONV12_SHAPE, dtype, seed, timed=True)
        res[r["dtype"]] = r
        print(f"conv12 {r['dtype']} {CONV12_SHAPE}: within tolerance of plain (max |d| {r['max_abs_err']:.3e} of "
              f"max |plain| {r['max_abs_plain']:.3e}), kernel {r['kernel_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"F.conv2d {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) ({card})")
        torch.cuda.empty_cache()
    res["ragged"] = [compare_conv12((3, 64, 38, 50), dtype, 7, timed=False) for dtype in (torch.float32, torch.bfloat16)]

    # a linear loss sum(y * r): both backwards get the same cotangent r, so
    # only their own arithmetic differs
    x, w, b = conv12_case((3, 64, 38, 50), torch.float32, 11)
    r = torch.from_numpy(np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)).to(DEVICE)
    grads = []
    for fn in (conv12, conv12_plain):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        with true_float32():
            (fn(xs, ws, bs) * r).sum().backward()
        grads.append((xs.grad, ws.grad, bs.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    res["backward_rtol_1e-4"] = True
    print(f"conv12 ragged (3, 64, 38, 50) float32 and bfloat16 within tolerance; autograd backward within rtol "
          f"1e-4 of plain autograd ({card})")
    return res


def phase_trajectory(card: str) -> dict:
    """The reference's 20-step training run replayed on the card with the
    conv12 kernel, to the pins of tests/test_trajectory.py."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes
    from object_detection_torch2_tpu_torch.models.convert import jax_tree, ssd_state_dict_from_torch
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    g = np.load(TRAJECTORY)
    steps, spe, bs = int(g["steps"]), int(g["steps_per_epoch"]), int(g["bs"])
    sd = ssd_state_dict_from_torch({k: synth_array_scaled(k, shape) for k, shape in
                                    unpack_manifest(g["manifest_keys"], g["manifest_shapes"]).items()})
    trainer = Trainer(SSD(num_classes=21, conv12_kernel=True), default_boxes=default_boxes())
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), spe)
    state = trainer.init_state(lambda ps: adam_torch(ps, schedule, weight_decay=float(g["weight_decay"])),
                               state_dict=sd)
    frozen0 = {k: v.clone() for k, v in state.frozen.items()}

    conv12_cuda.launches = 0
    losses = []
    for step in range(steps):
        images, targets = synth_trajectory_batch(step, n=bs)
        losses.append(float(trainer.train_step(state, np.ascontiguousarray(images.transpose(0, 2, 3, 1)), targets)))
    launches = conv12_cuda.launches
    if launches != steps:
        raise AssertionError(f"{steps} forwards launched the conv12 kernel {launches} times")

    ref = g["losses"]
    drift = np.abs(np.array(losses) - ref) / np.maximum(np.abs(ref), 1e-9)
    assert drift.max() < 3e-3, f"loss trajectory drift {drift.max():.2e} at step {drift.argmax()}"
    assert drift[0] < 1e-4, f"step-0 loss drift {drift[0]:.2e}"

    keys, fp = fingerprint_tree(jax_tree(state.trainable))
    assert list(keys) == [str(k) for k in g["param_fp_keys"]], "trainable tensor inventory differs from the golden's"
    absd, l2 = np.abs(fp - g["param_fp"]).max(axis=1), g["param_fp"][:, 0]
    param_ratio = absd / (5e-3 * l2 + 1e-2)
    assert (param_ratio <= 1).all(), f"param drift over budget at {keys[param_ratio.argmax()]}"

    keys, fp = fingerprint_tree(jax_tree(state.batch_stats))
    assert list(keys) == [str(k) for k in g["bs_fp_keys"]], "BN statistics inventory differs from the golden's"
    absd, l2 = np.abs(fp - g["bs_fp"]).max(axis=1), g["bs_fp"][:, 0]
    trunk = np.array([int(k.split("_")[1].split("/")[0]) <= 5 for k in keys])
    assert (absd[trunk] <= 1e-4).all(), f"frozen-trunk BN statistics drift {absd[trunk].max():.2e}"
    bs_ratio = absd / (0.1 * l2 + 0.1)
    assert (bs_ratio <= 1).all(), f"BN statistics drift over budget at {keys[bs_ratio.argmax()]}"
    for name, p in state.frozen.items():
        assert torch.equal(p, frozen0[name]), f"frozen {name} changed"

    print(f"trajectory replay float32, conv12 kernel: {steps} steps, conv12 launches {launches}, loss drift max "
          f"{drift.max():.2e} (pin 3e-3), step 0 {drift[0]:.2e} (pin 1e-4), param budget use {param_ratio.max():.3f}, "
          f"BN statistics budget use {bs_ratio.max():.3f}, trunk BN max |d| {absd[trunk].max():.2e} (pin 1e-4), "
          f"trunk bit-unchanged ({card})")
    return {"steps": steps, "conv12_launches": launches, "loss_drift_max": float(drift.max()),
            "loss_drift_step0": float(drift[0]), "param_budget_use": float(param_ratio.max()),
            "bn_budget_use": float(bs_ratio.max()), "trunk_bn_max_abs": float(absd[trunk].max()),
            "losses": losses}


def compare_conv12_paths(start_sd: dict, dtype, df, images, targets) -> dict:
    """One train step from the same state with conv_1_2 on the kernel and on
    cuDNN (the model's default path); each step's loss and applied gradients
    (global L2 of the difference over the other's).

    float32: the two steps agree within 1e-4 on the loss (the trajectory's
    step-0 pin) and 1e-3 on the gradients (sum-order noise through 33
    batch-statistics layers). bfloat16: the two paths round conv_1_2
    differently (the kernel once, after the float32 bias; cuDNN in its own
    way), and 34 more bfloat16 layers amplify either rounding, so each is held
    against the float32 step from the same state instead: the kernel path may
    be no farther from it than the cuDNN path is, within a factor of 2
    (+1e-4 on the loss)."""
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    def one_step(dt, kernel):
        trainer = Trainer(SSD(num_classes=21, dtype=dt, conv12_kernel=kernel), default_boxes=df)
        state = trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4), state_dict=start_sd)
        captured = []
        apply = state.apply_gradients
        state.apply_gradients = lambda grads: (captured.extend(g.float() for g in grads), apply(grads))
        loss = float(trainer.train_step(state, images, targets))
        return loss, captured

    def distance(a, b):
        (la, ga), (lb, gb) = a, b
        return abs(la - lb) / abs(lb), float(torch.sqrt(sum(((x - y) ** 2).sum() for x, y in zip(ga, gb))
                                                        / sum((y ** 2).sum() for y in gb)))

    kernel, cudnn = one_step(dtype, True), one_step(dtype, False)
    if dtype == torch.float32:
        loss_rel, grad_rel = distance(kernel, cudnn)
        if not (loss_rel <= 1e-4 and grad_rel <= 1e-3):
            raise AssertionError(f"float32 kernel and cuDNN conv_1_2 steps differ: loss {loss_rel:.2e} (tol 1e-4), "
                                 f"gradients {grad_rel:.2e} (tol 1e-3)")
        return {"loss_kernel": kernel[0], "loss_cudnn": cudnn[0], "loss_rel": loss_rel, "grad_rel": grad_rel}
    reference = one_step(torch.float32, True)
    k_loss, k_grad = distance(kernel, reference)
    c_loss, c_grad = distance(cudnn, reference)
    if not (k_loss <= 2 * c_loss + 1e-4 and k_grad <= 2 * c_grad):
        raise AssertionError(f"bfloat16 kernel path is farther from float32 than cuDNN's: loss {k_loss:.2e} vs "
                             f"{c_loss:.2e}, gradients {k_grad:.2e} vs {c_grad:.2e}")
    return {"loss_kernel": kernel[0], "loss_cudnn": cudnn[0], "loss_float32": reference[0],
            "kernel_vs_float32": [k_loss, k_grad], "cudnn_vs_float32": [c_loss, c_grad]}


def step_breakdown(state, default_boxes_t, images, targets, reps: int = 3) -> dict:
    """A train step's device time split into forward, loss, backward and
    Adam (CUDA events; median of `reps`). The same calls as
    `Trainer.train_step`, with events between them."""
    from object_detection_torch2_tpu_torch import true_float32
    from object_detection_torch2_tpu_torch.core.multibox import multibox_loss
    from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch

    x = to_tensor_batch(torch.from_numpy(images).to(DEVICE))
    t = torch.from_numpy(targets).to(DEVICE)
    params = list(state.trainable.values())
    phases = {"forward": [], "loss": [], "backward": [], "adam": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        state.model.train()
        with true_float32():
            ev[0].record()
            out = state.model(x, use_batch_stats=True)
            ev[1].record()
            loss = multibox_loss(out, t, default_boxes_t)
            ev[2].record()
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
            ev[3].record()
        state.apply_gradients(grads)
        ev[4].record()
        ev[4].synchronize()
        for i, name in enumerate(phases):
            phases[name].append(ev[i].elapsed_time(ev[i + 1]))
    return {name: statistics.median(v) for name, v in phases.items()}


def phase_training(card: str) -> dict:
    """The training main path at full width: SSD300, batch 32, G = 64, seeded
    weights and uint8 batches, conv12 kernel on, float32 and bfloat16."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    df = default_boxes(feature_grids_for(IMSIZE))
    rng = np.random.default_rng(2024)
    n_batches = TRAIN_STEPS + K_STEPS + 1
    images = rng.integers(0, 256, (n_batches, BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    targets = np.stack([synth_targets(rng, BATCH, rng.integers(1, G_PAD + 1, BATCH), G_PAD) for _ in range(n_batches)])
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        trainer = Trainer(SSD(num_classes=21, dtype=dtype, seed=0, conv12_kernel=True), default_boxes=df)
        state = trainer.init_state(lambda ps: adam_torch(ps, exponential_epoch_schedule(1e-3, 0.7, TRAIN_STEPS),
                                                         weight_decay=5e-4))
        start_sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        frozen0 = {k: v.clone() for k, v in state.frozen.items()}
        stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        conv12_cuda.launches = 0
        conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
        losses, step_ms = [], []
        for i in range(TRAIN_STEPS):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss = trainer.train_step(state, images[i], targets[i])
            e1.record()
            e1.synchronize()
            step_ms.append(e0.elapsed_time(e1))
            losses.append(float(loss))
        k_losses = trainer.train_steps(state, images[TRAIN_STEPS:TRAIN_STEPS + K_STEPS],
                                       targets[TRAIN_STEPS:TRAIN_STEPS + K_STEPS]).tolist()
        eval_loss = float(trainer.eval_step(state, images[-1], targets[-1]))
        torch.cuda.synchronize()
        launches = conv12_cuda.launches
        by_kernel = dict(conv12_cuda.kernel_launches)
        if launches != n_batches or by_kernel[conv12_cuda.KERNEL_OF[dtype]] != n_batches:
            raise AssertionError(f"{n_batches} training forwards launched the conv12 kernels {by_kernel}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        if not np.isfinite(losses + k_losses + [eval_loss]).all():
            raise AssertionError(f"non-finite training loss in {name}: {losses}, {k_losses}, {eval_loss}")
        for key, p in state.frozen.items():
            assert torch.equal(p, frozen0[key]), f"frozen {key} changed"
        assert all(not torch.equal(b, stats0[key]) for key, b in state.batch_stats.items()), "a BN statistic did not move"
        assert state.step == TRAIN_STEPS + K_STEPS
        zero = trainer.eval_step(state, images[0], np.zeros_like(targets[0]))
        assert zero.item() == 0.0, f"all-void batch loss {zero.item()!r}, not 0.0"

        paths = compare_conv12_paths(start_sd, dtype, df, images[0], targets[0])
        split = step_breakdown(state, trainer.default_boxes, images[0], targets[0])
        ms = statistics.median(step_ms[1:])
        res[name] = {"conv12_launches": launches, "conv12_kernel_launches": by_kernel, "losses": losses,
                     "train_steps_losses": k_losses, "eval_loss": eval_loss, "step_ms": step_ms, "median_step_ms": ms, "img_per_s": BATCH / ms * 1e3,
                     "peak_gb": peak_gb, "split_ms": split, "kernel_vs_cudnn_step": paths}
        print(f"training main path {name} bs{BATCH} G{G_PAD}: losses {losses[0]:.4f} -> {k_losses[-1]:.4f}, eval "
              f"{eval_loss:.4f}, all-void 0.0, trunk bit-unchanged, conv12 launches {launches} for {n_batches} "
              f"forwards; {ms:.2f} ms/step, {BATCH / ms * 1e3:.1f} img/s (steps 2-{TRAIN_STEPS}); split forward "
              f"{split['forward']:.2f} / loss {split['loss']:.2f} / backward {split['backward']:.2f} / adam "
              f"{split['adam']:.2f} ms; peak {peak_gb:.1f} GB; conv_1_2 kernel vs cuDNN step: {paths} ({card})")
        del trainer, state
        torch.cuda.empty_cache()
    return res


AUG_F32_ATOL = 2e-6  # tests/test_torch_augment.py's float32 tolerance against the JAX package
TRAIN_RECORDS, VAL_RECORDS, CLI_STEPS = 128, 32, 4


def augment_within_tolerance(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst error in units of the tolerance (<= 1 passes): float32
    |d| / 2e-6; bfloat16 |d| / (1 ulp of want's magnitude)."""
    d = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return float(d.max()) / AUG_F32_ATOL
    ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0 ** -126))) - 7)
    return float((d / ulp).max())


def phase_augment(card: str) -> dict:
    """The augment chain on the card against the CPU, its time, and
    augmented train steps that never wait on the card."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.data import augment
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(77)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8))
    gts = torch.from_numpy(synth_targets(rng, BATCH, rng.integers(1, G_PAD + 1, BATCH), G_PAD))
    draws = augment.sample_augment_draws(torch.Generator().manual_seed(77), BATCH, IMSIZE, IMSIZE)
    erased = augment._erase_mask(draws, IMSIZE, IMSIZE, "cpu")
    images_d, gts_d, draws_d = images.to(DEVICE), gts.to(DEVICE), draws.to(DEVICE)
    res = {"jittered": int(draws.jitter.sum()), "flipped": int(draws.flip.sum()), "order": draws.order}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        want_img, want_gts = augment.apply_augment(images, gts, draws, dtype)
        got_img, got_gts = augment.apply_augment(images_d, gts_d, draws_d, dtype)
        got_img, got_gts = got_img.cpu(), got_gts.cpu()
        if not torch.equal(got_gts, want_gts):
            raise AssertionError(f"augment {name}: GTs on the card differ from the CPU's")
        if not bool((got_img[erased] == 0).all()):
            raise AssertionError(f"augment {name}: an erased pixel is not zero on the card")
        worst = augment_within_tolerance(got_img, want_img)
        if worst > 1:
            raise AssertionError(f"augment {name}: card pixels off the CPU's by {worst:.2f} x the tolerance")
        ms = time_ms(lambda: augment.apply_augment(images_d, gts_d, draws_d, dtype), reps=10)
        item = torch.empty((), dtype=dtype).element_size()
        bytes_moved = images.numel() + images.numel() * item + 2 * gts.numel() * 4
        res[name] = {"ms": ms, "max_err_in_tolerances": worst,
                     "max_abs_err": float((got_img.float() - want_img.float()).abs().max()),
                     "bytes": bytes_moved, "bytes_bound_ms": bytes_moved / PEAK_BYTES_PER_S * 1e3}
        print(f"augment {name} {BATCH}x{IMSIZE}x{IMSIZE}: card vs CPU on the same draws: GTs equal, erased pixels "
              f"zero, max error {worst:.3f} of the tolerance; {ms:.3f} ms (CUDA events; bytes bound "
              f"{res[name]['bytes_bound_ms']:.4f} ms) ({card})")

    # augmented train steps never wait on the card
    trainer = Trainer(SSD(num_classes=21, dtype=torch.bfloat16, seed=0, conv12_kernel=True),
                      default_boxes=default_boxes(feature_grids_for(IMSIZE)), augment=True)
    state = trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4))
    batch_u8 = images.numpy()
    trainer.train_step(state, batch_u8, gts.numpy())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [trainer.train_step(state, batch_u8, gts.numpy()) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not all(bool(torch.isfinite(l)) for l in losses):
        raise AssertionError("non-finite augmented training loss")
    res["train_step_host_syncs"] = 0
    print(f"augmented train steps bfloat16 bs{BATCH}: no host sync in 2 steps (sync debug mode 'error') ({card})")
    del trainer, state
    torch.cuda.empty_cache()
    return res


def read_scalars(log_dir: Path) -> list:
    """(tag, value, step) of every scalar in the event files of `log_dir`,
    in name order, each record's length and payload checked against its
    masked crc32c (the TFRecord framing of utils/tb.py)."""
    from object_detection_torch2_tpu_torch.utils.tb import _masked_crc

    def varint(buf, i):
        shift = value = 0
        while True:
            value |= (buf[i] & 0x7F) << shift
            i, shift = i + 1, shift + 7
            if not buf[i - 1] & 0x80:
                return value, i

    def fields(buf):
        i, out = 0, {}
        while i < len(buf):
            key, i = varint(buf, i)
            wire = key & 7
            if wire == 0:
                out[key >> 3], i = varint(buf, i)
            elif wire in (1, 5):
                width = 8 if wire == 1 else 4
                out[key >> 3], i = buf[i:i + width], i + width
            else:
                n, i = varint(buf, i)
                out[key >> 3], i = buf[i:i + n], i + n
        return out

    scalars = []
    for path in sorted(log_dir.glob("events.out.tfevents.*")):
        data, pos = path.read_bytes(), 0
        while pos < len(data):
            header = data[pos:pos + 8]
            (n,) = struct.unpack("<Q", header)
            payload = data[pos + 12:pos + 12 + n]
            if (struct.unpack("<I", data[pos + 8:pos + 12])[0] != _masked_crc(header)
                    or struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] != _masked_crc(payload)):
                raise AssertionError(f"{path}: a record's CRC does not match")
            pos += 16 + n
            event = fields(payload)
            if 5 in event:
                value = fields(fields(event[5])[1])
                scalars.append((value[1].decode(), struct.unpack("<f", value[2])[0], event[2]))
    return scalars


def train_cli_run(tmp: Path, records: Path, dtype: str, epochs: int) -> dict:
    """One `cli.train.main` run over the records in `tmp`; the conv12 launch
    counts are reset just before it and read just after."""
    from object_detection_torch2_tpu_torch.cli import train
    from object_detection_torch2_tpu_torch.ops import conv12_cuda

    argv = ["--records_dir", str(records / "train"), "--val_records_dir", str(records / "val"),
            "--batch_size", str(BATCH), "--steps_per_epoch", str(CLI_STEPS), "--imsize", str(IMSIZE),
            "--dtype", dtype, "--epochs", str(epochs), "--result_dir", str(tmp / "result"),
            "--log_dir", str(tmp / "logs"), "--orbax_dir", str(tmp / "state"), "--val_aug", "none"]
    conv12_cuda.launches = 0
    conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
    t0 = time.perf_counter()
    out = train.main(argv)
    out["main_s"] = time.perf_counter() - t0
    out["conv12_kernel_launches"] = dict(conv12_cuda.kernel_launches)
    return out


def check_train_cli_run(tmp: Path, out: dict, dtype, epochs_before: int, epochs: int, card: str) -> dict:
    """The run's conv12 launches, weights file, params.json, scalars and
    phase_times.json."""
    from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.train.checkpoint import STATE_FILE, load_weights

    name = str(dtype).replace("torch.", "")
    kernel = conv12_cuda.KERNEL_OF[dtype]
    want = epochs * (CLI_STEPS + VAL_RECORDS // BATCH)
    got = out["conv12_kernel_launches"]
    if got[kernel] != want or sum(got.values()) != want:
        raise AssertionError(f"training CLI {name}: conv12 launches {got}, expected {want} of {kernel}")
    params = json.loads((tmp / "result" / "detection" / "params.json").read_text())
    if params["base_lr"] != 0.001 or params["steps_per_epoch"] != CLI_STEPS or not np.isfinite(params["min_loss"]):
        raise AssertionError(f"training CLI {name}: params.json {params}")
    state = torch.load(tmp / "state" / str(CLI_STEPS * params["last_epoch"]) / STATE_FILE, map_location="cpu",
                       weights_only=True)
    saved = ssd_state_dict_from_jax_variables(load_weights(tmp / "result" / "detection" / "weights.msgpack"))
    for key, v in state["model"].items():
        if not key.endswith("num_batches_tracked") and not torch.equal(saved[key], v):
            raise AssertionError(f"training CLI {name}: weights.msgpack does not give back {key} bit-equal")
    last = epochs_before + epochs
    scalars = [(t, s) for t, _, s in read_scalars(tmp / "logs") if epochs_before < s <= last]
    want_scalars = [(t, e) for e in range(epochs_before + 1, last + 1) for t in ("loss/train", "loss/validation", "lr")]
    if scalars != want_scalars:
        raise AssertionError(f"training CLI {name}: scalars {scalars}")
    rows = json.loads((tmp / "logs" / "phase_times.json").read_text())
    if [r["epoch"] for r in rows] != list(range(epochs_before + 1, last + 1)):
        raise AssertionError(f"training CLI {name}: phase_times.json {rows}")
    losses = torch.cat(out["losses"]).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"training CLI {name}: non-finite loss {losses.tolist()}")
    row = rows[-1]
    print(f"training CLI {name} bs{BATCH} epochs {epochs_before + 1}-{last}: conv12 launches {got[kernel]} "
          f"({kernel}), weights file bit-equal to the full state of epoch {params['last_epoch']}, params.json, "
          f"3 scalars an epoch, phase_times.json; last epoch train loop {row['img_per_s_train_loop']} img/s, wall "
          f"{row['img_per_s_wall']} img/s (train {row['train_s']} s, val {row['val_s']} s, save {row['save_s']} s); "
          f"main() {out['main_s']:.1f} s ({card})")
    return {"conv12_kernel_launches": got, "losses": losses.tolist(), "val_losses": out["val_losses"],
            "phase_times": rows, "main_s": out["main_s"], "params": params}


def phase_train_cli(card: str) -> dict:
    """The training CLI on numpy-written records at batch 32: the bfloat16
    resume check, then a float32 run."""
    from object_detection_torch2_tpu_torch.train.checkpoint import STATE_FILE

    rng = np.random.default_rng(55)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for split, n in (("train", TRAIN_RECORDS), ("val", VAL_RECORDS)):
            write_records(tmp / "records" / split, rng.integers(0, 256, (n, IMSIZE, IMSIZE, 3), dtype=np.uint8),
                          synth_targets(rng, n, rng.integers(1, G_PAD + 1, n), G_PAD))
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            a, b = tmp / "resumed", tmp / "straight"
            first = train_cli_run(a, tmp / "records", "bfloat16", 2)
            runs = {"first": check_train_cli_run(a, first, torch.bfloat16, 0, 2, card)}
            resumed = train_cli_run(a, tmp / "records", "bfloat16", 1)
            runs["resumed"] = check_train_cli_run(a, resumed, torch.bfloat16, 2, 1, card)
            straight = train_cli_run(b, tmp / "records", "bfloat16", 3)
            runs["straight"] = check_train_cli_run(b, straight, torch.bfloat16, 0, 3, card)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        step = 3 * CLI_STEPS
        sa = torch.load(a / "state" / str(step) / STATE_FILE, map_location="cpu", weights_only=True)
        sb = torch.load(b / "state" / str(step) / STATE_FILE, map_location="cpu", weights_only=True)
        diffs = {k: float((v.float() - sb["model"][k].float()).abs().max()) for k, v in sa["model"].items()
                 if not torch.equal(v, sb["model"][k])}
        for i, st in sa["optimizer"]["state"].items():
            for key in ("exp_avg", "exp_avg_sq", "step"):
                if not torch.equal(st[key], sb["optimizer"]["state"][i][key]):
                    diffs[f"adam {i} {key}"] = float((st[key] - sb["optimizer"]["state"][i][key]).abs().max())
        same_losses = torch.equal(torch.cat(resumed["losses"]).cpu(), straight["losses"][2].cpu())
        same_weights = ((a / "result" / "detection" / "weights.msgpack").read_bytes()
                        == (b / "result" / "detection" / "weights.msgpack").read_bytes())
        if diffs or not same_losses or not same_weights or sa["step"] != sb["step"]:
            raise AssertionError(f"resumed bfloat16 run differs from the straight one: losses equal {same_losses}, "
                                 f"weights files equal {same_weights}, state max |d| {diffs}")
        res["bfloat16"] = {**runs, "resume_bit_equal": True, "cudnn_deterministic": True}
        print(f"training CLI bfloat16: 2 epochs + 1 resumed from the full state bit-equal to 3 straight (epoch-3 "
              f"losses, weights, BN statistics, Adam moments and step, weights files), cuDNN deterministic ({card})")

        c = tmp / "float32"
        out = train_cli_run(c, tmp / "records", "float32", 2)
        res["float32"] = check_train_cli_run(c, out, torch.float32, 0, 2, card)
    torch.cuda.empty_cache()
    return res


def phase_inference_cli(card: str) -> dict:
    """The inference CLI on 70 numpy-written records at batch 32: its PNGs
    against the render of `Predictor`'s detections."""
    from object_detection_torch2_tpu_torch.cli import inference
    from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
    from object_detection_torch2_tpu_torch.infer import Predictor
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import nms_cuda
    from object_detection_torch2_tpu_torch.utils.render import render_detections_compact, require_pil

    Image, _ = require_pil()
    images = np.random.default_rng(9).integers(0, 256, (N_IMAGES, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    n_batches = -(-N_IMAGES // BATCH)
    labelmap = LabelMap("PascalVOC")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_records(tmp / "records", images, np.zeros((N_IMAGES, G_PAD, 25), np.float32))
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            argv = ["--records_dir", str(tmp / "records"), "--result_dir", str(tmp / name), "--batch_size",
                    str(BATCH), "--imsize", str(IMSIZE), "--dtype", name]
            nms_cuda.launches = 0
            t0 = time.perf_counter()
            out = inference.main(argv)
            main_s = time.perf_counter() - t0
            launches = nms_cuda.launches
            if launches != n_batches:
                raise AssertionError(f"inference CLI {name}: {launches} NMS launches for {n_batches} batches")
            pngs = sorted((tmp / name / "detection").glob("*.png"))
            if [p.name for p in pngs] != [f"{i:06}.png" for i in range(1, N_IMAGES + 1)]:
                raise AssertionError(f"inference CLI {name}: {len(pngs)} PNGs, not 1..{N_IMAGES}")
            dets = Predictor(SSD(num_classes=21, dtype=dtype, seed=0), imsize=IMSIZE, batch_size=BATCH).predict(images)
            draw_s = 0.0
            for k, (path, d) in enumerate(zip(pngs, dets)):
                t0 = time.perf_counter()
                want = render_detections_compact(images[k], d.boxes, d.class_ids + 1, d.scores, labelmap, IMSIZE)
                draw_s += time.perf_counter() - t0
                if not np.array_equal(np.asarray(Image.open(path).convert("RGB")), np.asarray(want)):
                    raise AssertionError(f"inference CLI {name}: PNG {path.name} differs from the render of "
                                         f"Predictor's detections")
            batch_ms = out["batch_s"][1] * 1e3  # the second full batch: the first warms up
            render_ms = statistics.median(out["render_s"][:N_IMAGES // BATCH]) * 1e3
            img_s = N_IMAGES / main_s
            draw_ms = draw_s / N_IMAGES * BATCH * 1e3
            drawn = int(np.mean([(d.scores > 0).sum() for d in dets]))
            res[name] = {"launches": launches, "main_s": main_s, "img_per_s": img_s, "batch_ms": batch_ms,
                         "render_ms_per_batch": render_ms, "draw_ms_per_batch": draw_ms, "boxes_per_image": drawn,
                         "batch_s": out["batch_s"], "render_s": out["render_s"]}
            print(f"inference CLI {name} bs{BATCH}: {N_IMAGES} PNGs, NMS launches {launches}, every PNG pixel-equal "
                  f"to the render of Predictor's detections; main() {main_s:.2f} s = {img_s:.1f} img/s; a full "
                  f"batch {batch_ms:.2f} ms to its rows on the host, render + save {render_ms:.1f} ms on the host "
                  f"(drawing alone {draw_ms:.1f} ms, {drawn} boxes an image) ({card})")
    return res


def conv12_entry(conv: dict, training: dict, train_cli: dict) -> dict:
    """The kernels-line entry of conv12: the float32 kernel at the training
    path's shape in the top-level keys, the bfloat16 kernel (its own source)
    beside them; each one's launches summed over the training main path and
    the training CLI's runs."""
    def keys(r, dtype):
        name = "conv12" if dtype == "float32" else "conv12_bf16"
        runs = ([train_cli[dtype][k] for k in ("first", "resumed", "straight")] if dtype == "bfloat16"
                else [train_cli[dtype]])
        by_path = {"training": training[dtype]["conv12_kernel_launches"][name],
                   "train_cli": sum(run["conv12_kernel_launches"][name] for run in runs)}
        return {"route": "cuda", "source": f"object_detection_torch2_tpu_torch/csrc/{name}.cu",
                "replaces": "object_detection_torch2_tpu/ops/conv12_pallas.py:103",  # _kernel
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": r["max_abs_err"], "within_tolerance": r["within_tolerance"],
                "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "bytes": r["bytes"], "operations": r["operations"]}

    entry = {"name": "conv12", **keys(conv["float32"], "float32"), "shape": conv["float32"]["shape"],
             "dtype": "float32"}
    entry["bfloat16"] = keys(conv["bfloat16"], "bfloat16")
    entry["library"] = "F.conv2d (cuDNN; TF32 off in float32)"
    return entry


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
    sass = {name: _build.tensor_core_instructions(name) for name in [s.stem for s in _build.sources()]}
    for name, counts in sass.items():
        print(f"  {name}: tensor-core instructions in SASS {counts}")
    if sum(sass["conv12_bf16"].values()) == 0:
        raise AssertionError("csrc/conv12_bf16.cu's machine code has no tensor-core instruction")

    results = {"card": card, "sass_tensor_core": sass, "reference": phase_reference(card)}
    results["kernel_vs_plain"] = phase_kernel_vs_plain(card)
    main_path = phase_main_path(card)
    entries = [kernel_entry(main_path, card)]
    results["main_path"] = main_path
    results["evaluation"] = phase_evaluation(card)
    results["inference_cli"] = phase_inference_cli(card)
    nms_paths = {path: sum(results[key][d]["launches"] for d in ("float32", "bfloat16"))
                 for path, key in (("serving", "main_path"), ("evaluation", "evaluation"),
                                   ("inference_cli", "inference_cli"))}
    entries[0].update(launches=sum(nms_paths.values()), launches_by_path=nms_paths)
    results["conv12_vs_plain"] = phase_conv12(card)
    results["trajectory"] = phase_trajectory(card)
    results["training"] = phase_training(card)
    results["augment"] = phase_augment(card)
    results["train_cli"] = phase_train_cli(card)
    entries.append(conv12_entry(results["conv12_vs_plain"], results["training"], results["train_cli"]))
    results["kernels"] = entries
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))

    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drives the PyTorch/CUDA port's serving, evaluation and training paths, its
training (both purposes), inference and evaluation CLIs, its serving
plumbing, its exported pipeline, its int8 paths and its data parallelism on
one CUDA card, and checks them.

    python3 chip_smoke.py [--out results.json]

Phases (any failure raises and exits non-zero; nothing is caught):
1. device: the card's name and power limit (nvidia-smi) — no card, no run;
2. build: the CUDA kernels from object_detection_torch2_tpu_torch/csrc/, one
   nvcc per source, all started together, with nvcc's register, spill and
   shared-memory report and each library's count of tensor-core
   instructions (HMMA, HGMMA, IMMA, IGMMA) in cuobjdump -sass; the bfloat16
   conv_1_2 library must have some, and the int8 conv library (the wgmma
   kernel) some IGMMA;
3. reference: the port's SSD forward on the card against the reference
   forward golden (tests/goldens/ssd_forward_pinned.npz) at its pinned
   tolerances, in float32 (which also proves cuDNN's TF32 is off) and bfloat16;
4. NMS kernel vs plain: the NMS sweep kernel against its plain PyTorch version
   on the card, on seeded clustered boxes at batch 32 and widths 128, 1024 and
   8732, dense and sparse: the keep masks must be identical; then at N = 256,
   P = 8732 through `keep_sorted` (the custom op): two slices of one mask
   scratch, two launches, the plain sweep's keep mask;
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
   weights file gives the saved state back bit-equal; again with
   `--batches_per_dispatch 2 --d2h_half`: parity mAP 1.0, 3 NMS launches.
   Then eval img/s at batch 32 over 8 batches with the fetch pipeline at
   depth 2 and depth 0 in turns, the host syncs of a batch, and a batch's
   split into forward, post-processing, matcher, D2H + AP accumulation and
   the rest at each depth;
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
   the frozen trunk bit-unchanged; one conv12 launch per forward. In
   bfloat16 (the wgmma kernel) to the JAX package's budget: loss drift < 0.02,
   eval-forward max |d| < 0.6 and mean < 0.1. The 100-step golden in both
   dtypes, to `TRAJECTORY_100_PINS`;
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
   records (G = 64). bfloat16, with no flag set here (the CLI runs cuDNN's
   deterministic algorithms under --orbax_dir): 2 epochs with the full
   state, then 1 resumed from it, against 3 straight in a fresh directory
   (train augment on, validation un-augmented): epoch 3's losses, the full
   states and the weights files bit-equal.
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
13. serving plumbing (after the inference CLI): `Predictor` with
   `batches_per_dispatch=2` identical to K = 1 and `d2h_half` the float32 rows
   rounded to float16; the pipeline exported for cuda and cpu, reloaded, its
   rows on the card identical to the live pipeline's with one NMS launch
   through the registered op, and its ms at batch 32 against the live one's;
14. classification CLI: `cli.train.main --purpose classification` at full
   VGG16 width, imsize 200, batch 32, 4 steps, over 128 + 32 seeded
   classification records, bfloat16 and float32: finite losses, the dead head
   bit-unchanged, its weights file seeding `build_ssd`'s trunk bit for bit;
15. device cache: the training CLI with `--device_cache` against streaming
   (bfloat16, 2 epochs, --orbax_dir): losses and weights file bit-equal; H2D
   bytes a step and img/s;
16. int8: the int8 conv kernel (csrc/int8_conv.cu, wgmma) against
   `int8_conv_plain` on the card at every quantizable layer of SSD300 at
   batch 32, 300x300 (conv_1_2, blocks 2-5, extras 6-11, the six heads), at
   a ragged shape and at two K-tail / ragged-N shapes (Cin 32 on a 1x1 map,
   Cin 64 with Cout 150), from seeded numpy operands: the raw int32 sums and
   the float32 and bfloat16 epilogues bit-equal; per layer the kernel's ms
   (bfloat16 epilogue) beside its bound, cuDNN's bfloat16 conv and
   torch._int_mm on the im2col'd operands (the GEMM alone). The activation
   quantize kernel (csrc/quantize_act.cu) against `quant.quantize_act` at
   the input of each of the 27 layers, bfloat16 and float32, true division
   and reciprocal, on exact ties, saturating values and -0.0: bit-equal; its
   ms beside its bytes bound and the plain chain's. Then, each with both
   kernels' launch counts reset just before and read just after:
   `Trainer(quant=)` at batch 32, G = 64, both dtypes (11 int8 conv, 11
   quantize and the dtype's conv12 launch a forward, trunk bit-unchanged, ms
   per step against the float step in turns); `cli.train --trunk_int8` in
   bfloat16, 2 epochs (quant.json with 12 layers); `cli.evaluate
   --trunk_int8` and `--full_int8` in bfloat16 over 70 records with ground
   truth planted on the int8 Predictor's own top-3 detections (parity mAP
   1.0, 3 NMS launches, 11 or 27 launches of each int8 kernel a batch; the
   full run writes quant_full.json equal to the calibration and a second run
   loads it with the same APs; batch 0's matches through the plain int8 conv
   and plain sweep identical); `cli.inference --export_pipeline
   --trunk_int8` for cuda (11 int8_conv and 11 quantize_act op calls in the
   graph, the live int8 pipeline's rows); accuracy against float with
   random weights, float32:
   the JAX package's thresholds at its tests' sizes (trunk at 5_3, 64x64:
   cosine > 0.97; full int8, 264x264: > 0.95), and at 300x300 both above
   0.95;
17. data parallelism (parallel/mesh.py): NCCL at world size 1 (torchrun's
   environment set here; the card has no second device and NCCL refuses two
   ranks on one GPU): `Trainer(mesh=)` against the plain Trainer, bfloat16,
   batch 32, G = 64, augment and Adam, steps in turns (CUDA events and host
   enqueue ms), bit-equal after the same steps, 2 mesh steps under
   `torch.cuda.set_sync_debug_mode("error")`, the gradient all-reduce alone;
   `cli.train --distributed` (4 steps, --orbax_dir) against the
   single-process CLI: losses and weights file bit-equal, 4 conv12 launches.
   Then 2 gloo ranks on the one card: `Trainer(mesh=)` at global batch 32
   (16 a rank), 3 SGD steps in float32 and bfloat16 against one process (the
   CPU tests' tolerances in float32, the trajectory budget in bfloat16), the
   ranks bit-identical, conv12 launches per rank; `cli.evaluate
   --distributed --dist_backend gloo` as 2 processes with torchrun's
   environment over 70 records at batch 32 (rank 1's last slice empty),
   float32 with batch statistics and `--trunk_int8` in bfloat16 with running
   statistics, each on ground truth planted on that model's own detections:
   parity mAP 1.0 on both ranks as in one process, 3 NMS launches a rank and
   33 of each int8 kernel a rank with --trunk_int8;
18. the kernels line (JSON; launches summed over the paths that ran each
   kernel, by path, the data-parallel paths' summed over ranks), then the last line
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
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "ssd_forward_pinned.npz"
TRAJECTORY = ROOT / "tests" / "goldens" / "train_trajectory.npz"
TRAJECTORY_100 = ROOT / "tests" / "goldens" / "train_trajectory_100.npz"
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


def phase_nms_batch256(card: str) -> dict:
    """The NMS sweep at N = 256, P = 8732 (above the 224 images one mask
    scratch holds) through `keep_sorted`: two slices, two launches, the
    plain sweep's keep mask."""
    from object_detection_torch2_tpu_torch.ops import nms, nms_cuda

    n = 256
    sb, sv = clustered_sorted(np.random.default_rng(256), n, 8732, dense=True)
    slices = nms_cuda.sweep_slices(n, 8732)
    nms_cuda.launches = 0
    got = nms_cuda.keep_sorted(sb, sv, IOU_THRESH)
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    want = nms._blocked_keep_sorted(sb, sv, IOU_THRESH)
    if launches != 2 or len(slices) != 2 or not torch.equal(got, want):
        raise AssertionError(f"NMS at N = {n}: {launches} launches for slices {slices}, keep masks equal "
                             f"{torch.equal(got, want)}")
    ms = time_ms(lambda: nms_cuda.nms_keep_sorted_cuda(sb, sv, IOU_THRESH), reps=5)
    print(f"nms_keep_sorted N={n} P=8732 dense: slices {slices}, {launches} launches, keep mask identical to the "
          f"plain sweep, kept {int(got.sum())}, {ms:.3f} ms ({card})")
    return {"n": n, "slices": slices, "launches": launches, "equal": True, "kept": int(got.sum()), "ms": ms}


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
    """Packed records in the layout of the port's data/records.py, with numpy
    only: detection GT (N, G, 25), or classification one-hots (N, 20)."""
    out_dir.mkdir(parents=True)
    np.save(out_dir / "images.npy", images)
    np.save(out_dir / "gts.npy", gts)
    detection = gts.ndim == 3
    meta = {"imsize": images.shape[1], "max_gt": gts.shape[1] if detection else 0, "count": len(images),
            "purpose": "detection" if detection else "classification",
            "seen_max_gt": int((gts[..., 4:].sum(-1) > 0).sum(-1).max()) if detection else 0, "sources": [],
            "list_file": ""}
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

            # both serving flags: K = 2 batches a call and float16 scores
            nms_cuda.launches = 0
            flagged = evaluate.main(argv + ["--batches_per_dispatch", "2", "--d2h_half", "--result_dir",
                                            str(tmp / "flagged")])
            flagged_launches = nms_cuda.launches
            if flagged_launches != n_batches or not abs(flagged[1] - 1.0) <= 1e-6:
                raise AssertionError(f"evaluation with --batches_per_dispatch 2 --d2h_half: parity mAP "
                                     f"{flagged[1]!r}, {flagged_launches} NMS launches")

            # eval img/s over the two full batches four times over, after the
            # run above warmed everything up, with the fetch pipeline at depth
            # 0 and 2 in turns; the host syncs of one batch; then where a
            # batch's time goes
            batches = [(np.asarray(i), np.asarray(g)) for i, g in
                       DataLoader(RecordDataset(tmp / "records"), BATCH, drop_last=True)] * 4
            times = {0: [], 2: []}
            for depth in (0, 2, 2, 0, 0, 2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                evaluate.accumulate(run, batches, BATCH, 20, 200, fetch_depth=depth)
                times[depth].append(time.perf_counter() - t0)
            batch_ms = {d: statistics.median(t) / len(batches) * 1e3 for d, t in times.items()}
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    run(x_u8, gts[:BATCH], BATCH)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            host_syncs = sum("synchroniz" in str(w.message).lower() for w in caught)
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
        rest_ms = {d: batch_ms[d] - forward_ms - post_ms - matcher_ms - host_ms for d in batch_ms}
        res[name] = {"launches": launches, "mean_ap": mean_ap, "strict_mean_ap": strict_mean,
                     "flagged_launches": flagged_launches, "flagged_mean_ap": flagged[1],
                     "aps": [float(a) for a in aps], "main_s": main_s, "img_per_s": BATCH / batch_ms[2] * 1e3,
                     "img_per_s_fetch_depth_0": BATCH / batch_ms[0] * 1e3, "batch_ms_by_fetch_depth": batch_ms,
                     "forward_ms": forward_ms, "post_ms": post_ms, "matcher_ms": matcher_ms,
                     "host_d2h_ap_ms": host_ms, "rest_ms_by_fetch_depth": rest_ms, "host_syncs_a_batch": host_syncs}
        print(f"evaluation main path {name} bs{BATCH}: parity mAP {mean_ap:.7f} (strict {strict_mean:.4f}) on "
              f"{N_IMAGES} records with planted ground truth, NMS launches {launches} for {N_IMAGES} images, "
              f"batch-0 matches identical to the plain sweep's, weights file round trip bit-equal, report written; "
              f"fetch depth 2 {BATCH / batch_ms[2] * 1e3:.1f} img/s ({batch_ms[2]:.2f} ms a batch, rest "
              f"{rest_ms[2]:.2f}), depth 0 {BATCH / batch_ms[0] * 1e3:.1f} img/s ({batch_ms[0]:.2f} ms, rest "
              f"{rest_ms[0]:.2f}) in turns over 8 batches; split forward {forward_ms:.2f}, post-processing "
              f"{post_ms:.2f}, matcher {matcher_ms:.3f}, D2H + AP accumulation {host_ms:.2f}; {host_syncs} host "
              f"syncs in a batch (sync debug mode 'warn'); main() {main_s:.1f} s; with --batches_per_dispatch 2 "
              f"--d2h_half parity mAP {flagged[1]:.7f}, NMS launches {flagged_launches} ({card})")
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
        "custom_op": "odt::nms_keep_sorted (ops/registry.py)",
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


# the JAX package's bfloat16 budget for the 20-step replay
# (tests/test_bf16_budget.py:28-30): loss drift, eval-forward max and mean |d|
BF16_BUDGET = (0.02, 0.6, 0.1)
# the 100-step replays' pins, about 5x what an H100 measured (PERF.md §6), as
# the JAX package pins its bfloat16 budget at ~5x its measurement
TRAJECTORY_100_PINS = {"float32": (8e-3, 0.2, 0.015), "bfloat16": (0.015, 1.5, 0.3)}


def replay_trajectory(golden: Path, dtype) -> dict:
    """A trajectory golden's training run replayed on the card through
    `Trainer` with `conv12_kernel=True` in `dtype` (float32 parameters):
    per-step relative loss drift, the post-training eval forward's |d| on
    the first 128 anchors, fingerprint budget use, conv12 launches."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes
    from object_detection_torch2_tpu_torch.models.convert import jax_tree, ssd_state_dict_from_torch
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    g = np.load(golden)
    steps, spe, bs = int(g["steps"]), int(g["steps_per_epoch"]), int(g["bs"])
    sd = ssd_state_dict_from_torch({k: synth_array_scaled(k, shape) for k, shape in
                                    unpack_manifest(g["manifest_keys"], g["manifest_shapes"]).items()})
    trainer = Trainer(SSD(num_classes=21, dtype=dtype, conv12_kernel=True), default_boxes=default_boxes())
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
    for name, p in state.frozen.items():
        assert torch.equal(p, frozen0[name]), f"frozen {name} changed"
    ref = g["losses"]
    drift = np.abs(np.array(losses) - ref) / np.maximum(np.abs(ref), 1e-9)
    images0, _ = synth_trajectory_batch(0, n=bs)
    with torch.no_grad():
        out = state.model.eval()(torch.from_numpy(np.ascontiguousarray(images0.transpose(0, 2, 3, 1))).to(DEVICE),
                                 use_batch_stats=False)
    ev = np.abs(out[:, :128, :].float().cpu().numpy() - g["out_eval_after"])

    keys, fp = fingerprint_tree(jax_tree(state.trainable))
    assert list(keys) == [str(k) for k in g["param_fp_keys"]], "trainable tensor inventory differs from the golden's"
    param_ratio = np.abs(fp - g["param_fp"]).max(axis=1) / (5e-3 * g["param_fp"][:, 0] + 1e-2)
    keys, fp = fingerprint_tree(jax_tree(state.batch_stats))
    assert list(keys) == [str(k) for k in g["bs_fp_keys"]], "BN statistics inventory differs from the golden's"
    absd, l2 = np.abs(fp - g["bs_fp"]).max(axis=1), g["bs_fp"][:, 0]
    trunk = np.array([int(k.split("_")[1].split("/")[0]) <= 5 for k in keys])
    return {"steps": steps, "conv12_launches": launches, "loss_drift_max": float(drift.max()),
            "loss_drift_argmax": int(drift.argmax()), "loss_drift_step0": float(drift[0]),
            "eval_fwd_maxabs": float(ev.max()), "eval_fwd_mean": float(ev.mean()),
            "param_budget_use": float(param_ratio.max()), "bn_budget_use": float((absd / (0.1 * l2 + 0.1)).max()),
            "trunk_bn_max_abs": float(absd[trunk].max()), "losses": losses}


def phase_trajectory(card: str) -> dict:
    """The reference's training runs replayed on the card with the conv12
    kernels: the 20-step golden in float32 to the pins of
    tests/test_trajectory.py and in bfloat16 to the JAX package's bfloat16
    budget; the 100-step golden in both dtypes to pins set from this card's
    measurement."""
    res = {}
    r = replay_trajectory(TRAJECTORY, torch.float32)
    assert r["loss_drift_max"] < 3e-3, f"loss trajectory drift {r['loss_drift_max']:.2e} at step {r['loss_drift_argmax']}"
    assert r["loss_drift_step0"] < 1e-4, f"step-0 loss drift {r['loss_drift_step0']:.2e}"
    assert r["param_budget_use"] <= 1, f"param drift over budget: {r['param_budget_use']:.3f}"
    assert r["trunk_bn_max_abs"] <= 1e-4, f"frozen-trunk BN statistics drift {r['trunk_bn_max_abs']:.2e}"
    assert r["bn_budget_use"] <= 1, f"BN statistics drift over budget: {r['bn_budget_use']:.3f}"
    res["float32"] = r
    print(f"trajectory replay float32, conv12 kernel: {r['steps']} steps, conv12 launches {r['conv12_launches']}, "
          f"loss drift max {r['loss_drift_max']:.2e} (pin 3e-3), step 0 {r['loss_drift_step0']:.2e} (pin 1e-4), "
          f"param budget use {r['param_budget_use']:.3f}, BN statistics budget use {r['bn_budget_use']:.3f}, trunk BN "
          f"max |d| {r['trunk_bn_max_abs']:.2e} (pin 1e-4), trunk bit-unchanged ({card})")
    r = replay_trajectory(TRAJECTORY, torch.bfloat16)
    drift_pin, max_pin, mean_pin = BF16_BUDGET
    if not (np.isfinite(r["losses"]).all() and r["loss_drift_max"] < drift_pin and r["eval_fwd_maxabs"] < max_pin
            and r["eval_fwd_mean"] < mean_pin):
        raise AssertionError(f"bfloat16 trajectory off its budget {BF16_BUDGET}: loss drift {r['loss_drift_max']:.3e}, "
                             f"eval forward max {r['eval_fwd_maxabs']:.3f} mean {r['eval_fwd_mean']:.4f}")
    res["bfloat16"] = r
    print(f"trajectory replay bfloat16, conv12_bf16 kernel: {r['steps']} steps, conv12 launches "
          f"{r['conv12_launches']}, loss drift max {r['loss_drift_max']:.3e} (pin {drift_pin}), eval forward max |d| "
          f"{r['eval_fwd_maxabs']:.3f} (pin {max_pin}) mean {r['eval_fwd_mean']:.4f} (pin {mean_pin}) ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        r = replay_trajectory(TRAJECTORY_100, dtype)
        drift_pin, max_pin, mean_pin = TRAJECTORY_100_PINS[name]
        print(f"trajectory replay 100 steps {name}: conv12 launches {r['conv12_launches']}, loss drift max "
              f"{r['loss_drift_max']:.3e} at step {r['loss_drift_argmax'] + 1} (pin {drift_pin}), eval forward max "
              f"|d| {r['eval_fwd_maxabs']:.3f} (pin {max_pin}) mean {r['eval_fwd_mean']:.4f} (pin {mean_pin}) ({card})")
        if not (np.isfinite(r["losses"]).all() and r["loss_drift_max"] < drift_pin and r["eval_fwd_maxabs"] < max_pin
                and r["eval_fwd_mean"] < mean_pin):
            raise AssertionError(f"100-step {name} trajectory off its pins {TRAJECTORY_100_PINS[name]}")
        res[f"{name}_100"] = r
    return res


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
        # no flag set here: with --orbax_dir the CLI runs cuDNN's
        # deterministic algorithms itself and restores the setting after
        assert not torch.backends.cudnn.deterministic
        a, b = tmp / "resumed", tmp / "straight"
        first = train_cli_run(a, tmp / "records", "bfloat16", 2)
        runs = {"first": check_train_cli_run(a, first, torch.bfloat16, 0, 2, card)}
        resumed = train_cli_run(a, tmp / "records", "bfloat16", 1)
        runs["resumed"] = check_train_cli_run(a, resumed, torch.bfloat16, 2, 1, card)
        straight = train_cli_run(b, tmp / "records", "bfloat16", 3)
        runs["straight"] = check_train_cli_run(b, straight, torch.bfloat16, 0, 3, card)
        assert not torch.backends.cudnn.deterministic, "the training CLI left cuDNN deterministic on"
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
        res["bfloat16"] = {**runs, "resume_bit_equal": True, "cudnn_deterministic_set_by": "cli.train --orbax_dir"}
        print(f"training CLI bfloat16: 2 epochs + 1 resumed from the full state bit-equal to 3 straight (epoch-3 "
              f"losses, weights, BN statistics, Adam moments and step, weights files), no flag set by the caller "
              f"({card})")

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
            # host seconds outside rendering, dispatches and waits summed over
            # the run (the fetch pipeline overlaps them with the rendering)
            batch_ms = sum(out["batch_s"]) / n_batches * 1e3
            render_ms = statistics.median(out["render_s"][:N_IMAGES // BATCH]) * 1e3
            img_s = N_IMAGES / main_s
            draw_ms = draw_s / N_IMAGES * BATCH * 1e3
            drawn = int(np.mean([(d.scores > 0).sum() for d in dets]))
            res[name] = {"launches": launches, "main_s": main_s, "img_per_s": img_s, "batch_ms": batch_ms,
                         "render_ms_per_batch": render_ms, "draw_ms_per_batch": draw_ms, "boxes_per_image": drawn,
                         "batch_s": out["batch_s"], "render_s": out["render_s"]}
            print(f"inference CLI {name} bs{BATCH}: {N_IMAGES} PNGs, NMS launches {launches}, every PNG pixel-equal "
                  f"to the render of Predictor's detections; main() {main_s:.2f} s = {img_s:.1f} img/s; a batch "
                  f"{batch_ms:.2f} ms of host time outside rendering, render + save {render_ms:.1f} ms on the host "
                  f"(drawing alone {draw_ms:.1f} ms, {drawn} boxes an image) ({card})")
    return res


CLS_IMSIZE = 200  # VGG16's working size: its heads need a 7 x 7 grid (quirk Q10)


def phase_classification_cli(card: str) -> dict:
    """The classification purpose of the training CLI at full VGG16 width:
    128 + 32 seeded numpy-written classification records at imsize 200,
    batch 32, 2 epochs of 4 steps (one weights file, at the end), in bfloat16
    and float32; finite losses, the
    dead 1000-way head bit-unchanged, and the weights file then seeds
    `build_ssd`'s trunk bit for bit."""
    from object_detection_torch2_tpu_torch.cli import common, train
    from object_detection_torch2_tpu_torch.models.vgg16 import VGG16

    rng = np.random.default_rng(66)
    init = VGG16(num_classes=20, transfer_learning=True).state_dict()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for split, n in (("train", TRAIN_RECORDS), ("val", VAL_RECORDS)):
            write_records(tmp / "records" / split,
                          rng.integers(0, 256, (n, CLS_IMSIZE, CLS_IMSIZE, 3), dtype=np.uint8),
                          np.eye(20, dtype=np.float32)[rng.integers(0, 20, n)])
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).replace("torch.", "")
            result = tmp / name / "result"
            argv = ["--purpose", "classification", "--records_dir", str(tmp / "records" / "train"),
                    "--val_records_dir", str(tmp / "records" / "val"), "--batch_size", str(BATCH),
                    "--steps_per_epoch", str(CLI_STEPS), "--imsize", str(CLS_IMSIZE), "--dtype", name,
                    "--epochs", "2", "--save_interval", "2", "--result_dir", str(result), "--log_dir",
                    str(tmp / name / "logs")]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = train.main(argv)
            main_s = time.perf_counter() - t0
            state = out["state"]
            losses = torch.cat(out["losses"]).float().cpu()
            if not (bool(torch.isfinite(losses).all()) and np.isfinite(out["val_losses"]).all()):
                raise AssertionError(f"classification CLI {name}: losses {losses.tolist()}, {out['val_losses']}")
            for key, p in state.frozen.items():
                if not (key.startswith("classifier_fc") and torch.equal(p.cpu(), init[key])):
                    raise AssertionError(f"classification CLI {name}: frozen {key} changed or is not the dead head")
            if set(state.optimizer.state) != set(state.trainable.values()) or len(state.frozen) != 6:
                raise AssertionError(f"classification CLI {name}: Adam holds moments outside the trainable set")
            ssd_args = train.parse_args(["--result_dir", str(result), "--dtype", name])
            ssd, _ = common.build_ssd(ssd_args, result / "detection" / "weights.msgpack")
            ssd_sd, vgg_sd = ssd.state_dict(), state.model.state_dict()
            trunk = [k for k in vgg_sd if k.startswith("features.") and not k.endswith("num_batches_tracked")]
            if len(trunk) != 78 or not all(torch.equal(ssd_sd[k], vgg_sd[k].cpu()) for k in trunk):
                raise AssertionError(f"classification CLI {name}: build_ssd's trunk is not the VGG16's")
            row = out["phase_times"][-1]
            res[name] = {"losses": losses.tolist(), "val_losses": out["val_losses"], "main_s": main_s,
                         "phase_times": out["phase_times"], "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            print(f"classification CLI {name} VGG16 imsize {CLS_IMSIZE} bs{BATCH}: losses {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, val {out['val_losses'][-1]:.4f}, dead 1000-way head bit-unchanged, the "
                  f"weights file seeds build_ssd's trunk bit for bit (78 tensors); epoch 2 train loop "
                  f"{row['img_per_s_train_loop']} img/s, wall {row['img_per_s_wall']} img/s (save {row['save_s']} s); "
                  f"peak {res[name]['peak_gb']:.1f} GB; main() {main_s:.1f} s ({card})")
            del out, state, ssd
            torch.cuda.empty_cache()
    return res


def phase_device_cache_cli(card: str) -> dict:
    """The training CLI with --device_cache against the streaming run, over
    128 + 32 seeded records at batch 32, bfloat16, 2 epochs of 4 steps, both
    with --orbax_dir (so cuDNN's deterministic algorithms): the same losses
    and weights file bit for bit; the H2D bytes a step; img/s."""
    from object_detection_torch2_tpu_torch.cli import train
    from object_detection_torch2_tpu_torch.ops import conv12_cuda

    rng = np.random.default_rng(57)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for split, n in (("train", TRAIN_RECORDS), ("val", VAL_RECORDS)):
            write_records(tmp / "records" / split, rng.integers(0, 256, (n, IMSIZE, IMSIZE, 3), dtype=np.uint8),
                          synth_targets(rng, n, rng.integers(1, G_PAD + 1, n), G_PAD))
        for name, flags in (("stream", []), ("cached", ["--device_cache"])):
            argv = ["--records_dir", str(tmp / "records" / "train"), "--val_records_dir",
                    str(tmp / "records" / "val"), "--batch_size", str(BATCH), "--steps_per_epoch", str(CLI_STEPS),
                    "--imsize", str(IMSIZE), "--dtype", "bfloat16", "--epochs", "2", "--val_aug", "none",
                    "--result_dir", str(tmp / name / "result"), "--log_dir", str(tmp / name / "logs"),
                    "--orbax_dir", str(tmp / name / "state")] + flags
            conv12_cuda.launches = 0
            conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
            out = train.main(argv)
            res[name] = {"losses": torch.cat(out["losses"]).cpu(), "phase_times": out["phase_times"],
                         "conv12_kernel_launches": dict(conv12_cuda.kernel_launches)}
        same_losses = torch.equal(res["stream"]["losses"], res["cached"]["losses"])
        same_weights = ((tmp / "stream" / "result" / "detection" / "weights.msgpack").read_bytes()
                        == (tmp / "cached" / "result" / "detection" / "weights.msgpack").read_bytes())
    if not (same_losses and same_weights):
        raise AssertionError(f"--device_cache run differs from the streaming run: losses equal {same_losses}, "
                             f"weights files equal {same_weights}")
    want = 2 * (CLI_STEPS + VAL_RECORDS // BATCH)
    for name in res:
        if res[name]["conv12_kernel_launches"]["conv12_bf16"] != want:
            raise AssertionError(f"{name} run: conv12 launches {res[name]['conv12_kernel_launches']}, expected {want}")
        res[name]["losses"] = res[name]["losses"].tolist()
    h2d = {"stream": BATCH * IMSIZE * IMSIZE * 3 + BATCH * G_PAD * 25 * 4, "cached": BATCH * 8}
    rows = {name: res[name]["phase_times"][-1] for name in res}
    print(f"training CLI --device_cache bfloat16 bs{BATCH}: losses and weights file bit-equal to the streaming run; "
          f"H2D a step {h2d['cached']} B (indices) against {h2d['stream']} B; train loop "
          f"{rows['cached']['img_per_s_train_loop']} img/s cached, {rows['stream']['img_per_s_train_loop']} img/s "
          f"streaming (epoch 2) ({card})")
    return {**res, "h2d_bytes_per_step": h2d, "bit_equal": True}


def phase_serving_plumbing(card: str) -> dict:
    """Predictor with K = 2 batches a dispatch and float16 rows; the pipeline
    exported for cuda and cpu, reloaded, and run on the card through the
    registered NMS op, against the live pipeline."""
    from object_detection_torch2_tpu_torch.infer import Predictor, build_detection_pipeline
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import nms_cuda
    from object_detection_torch2_tpu_torch.serving import export_detection_pipeline, load_detection_pipeline

    images = np.random.default_rng(11).integers(0, 256, (N_IMAGES, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    model = SSD(num_classes=21, dtype=torch.bfloat16, seed=0)
    res = {}
    nms_cuda.launches = 0
    want = Predictor(model, imsize=IMSIZE, batch_size=BATCH).predict(images)
    got = Predictor(model, imsize=IMSIZE, batch_size=BATCH, batches_per_dispatch=2).predict(images)
    half = Predictor(model, imsize=IMSIZE, batch_size=BATCH, batches_per_dispatch=2, d2h_half=True).predict(images)
    res["predictor_launches"] = nms_cuda.launches
    n_batches = -(-N_IMAGES // BATCH)
    if res["predictor_launches"] != 3 * n_batches:
        raise AssertionError(f"three Predictor runs launched the NMS kernel {res['predictor_launches']} times")
    for g, h, w in zip(got, half, want, strict=True):
        for field in ("boxes", "class_ids", "scores"):
            if not np.array_equal(getattr(g, field), getattr(w, field)):
                raise AssertionError(f"Predictor(batches_per_dispatch=2) {field} differ from K = 1's")
        if not (np.array_equal(h.class_ids, w.class_ids)
                and np.array_equal(h.scores, w.scores.astype(np.float16).astype(np.float32))
                and np.array_equal(h.boxes, w.boxes.astype(np.float16).astype(np.float32))):
            raise AssertionError("d2h_half rows are not the float32 rows rounded to float16")
    print(f"Predictor bfloat16 bs{BATCH}: batches_per_dispatch=2 detections identical to K = 1, d2h_half the float32 "
          f"rows rounded to float16 (within 1 float16 ulp); NMS launches {res['predictor_launches']} for three runs "
          f"of {N_IMAGES} images ({card})")

    x_u8 = images[:BATCH]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        path = tmp / "pipeline.bin"
        t0 = time.perf_counter()
        meta = export_detection_pipeline(model, path, batch_size=BATCH, use_batch_stats=True, imsize=IMSIZE,
                                         platforms=("cuda", "cpu"))
        export_s = time.perf_counter() - t0
        exported, _ = load_detection_pipeline(path)
        live = build_detection_pipeline(model, True, IMSIZE, device=DEVICE)
        nms_cuda.launches = 0
        packed_x, valid_x = exported(x_u8, BATCH)
        torch.cuda.synchronize()
        res["export_launches"] = nms_cuda.launches
        packed_l, valid_l = live(x_u8, BATCH)
        if res["export_launches"] != 1 or not (torch.equal(packed_x, packed_l) and torch.equal(valid_x, valid_l)):
            raise AssertionError(f"exported pipeline: {res['export_launches']} NMS launches, rows equal to the live "
                                 f"pipeline's {torch.equal(packed_x, packed_l)}")
        cpu_run, _ = load_detection_pipeline(path, device="cpu")
        x_dev = torch.from_numpy(x_u8).to(DEVICE)
        res["export"] = {"meta": meta, "export_s": export_s, "bit_equal_to_live": True,
                         "exported_ms": time_ms(lambda: exported(x_dev, BATCH), reps=3),
                         "live_ms": time_ms(lambda: live(x_dev, BATCH), reps=3), "cpu_program_loads": cpu_run is not None}
        print(f"exported pipeline bfloat16 bs{BATCH} (cuda, cpu; {meta['bytes'] / 1e6:.1f} MB, {export_s:.1f} s): "
              f"reloaded on the card, packed rows and n_valid identical to the live pipeline's, NMS launches "
              f"{res['export_launches']} through the registered op; a batch {res['export']['exported_ms']:.2f} ms "
              f"exported (NMS tiers as torch.cond) against {res['export']['live_ms']:.2f} ms live ({card})")
    del model, live, exported
    torch.cuda.empty_cache()
    return res


# dense int8 on the tensor cores
PEAK_INT8_OPS_PER_S = 1979e12
INT8_RAGGED = (3, 128, 37, 50, 100, 3, 1, 1)  # odd N, Ho != Wo, a head's Cout
# the K tail and the ragged N together (K = 288 and 576 leave a part-filled
# last 128-byte stage; Cout 100 and 150 part-fill the last N tile)
INT8_TAIL_CASES = (("cin32_1x1", (5, 32, 1, 1, 100, 3, 1, 1)), ("cin64_cout150", (3, 64, 38, 50, 150, 3, 1, 1)))


def int8_layer_shapes() -> list:
    """(layer, N, Cin, H, W, Cout, kernel, stride, pad) of every quantizable
    conv of SSD300 at BATCH and IMSIZE (conv_1_2, blocks 2-5, extras 6-11,
    the six heads), from the port's layer table."""
    from object_detection_torch2_tpu_torch.models.ssd import DETECTOR_TAPS, LAYER_SPECS

    batch, rows, h, out_hw = BATCH, [], IMSIZE, {}
    for suffix, cin, cout, k, s, p, pool in LAYER_SPECS:
        if suffix != "1_1":
            rows.append((suffix, batch, cin, h, h, cout, k, s, p))
        h = (h + 2 * p - k) // s + 1
        out_hw[suffix] = (h, cout)
        if pool is not None:
            h = (h + (2 if pool == "M_P" else 0)) // 2
    for suffix, a in DETECTOR_TAPS:
        hw, cin = out_hw[suffix]
        rows.append((f"det_{suffix}", batch, cin, hw, hw, a * 25, 3, 1, 1))
    return rows


def int8_bound(shape) -> dict:
    """The least time of one int8 conv with the bfloat16 epilogue: 2*M*Cout*K
    operations at the dense int8 rate, or x, w and the scale and bias read
    once and y (bfloat16) written once at HBM's rate."""
    _, n, cin, h, w, cout, k, s, p = shape
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * ho * wo, k * k * cin
    ops = 2 * m * cout * kk
    bytes_moved = n * h * w * cin + cout * kk + 4 * cout + 2 * cout + 2 * m * cout
    bytes_ms, ops_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3, ops / PEAK_INT8_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": bytes_moved, "operations": ops}


def int8_case(shape, seed: int):
    """Seeded operands of one int8 conv: x8 at post-ReLU scale (0..127, about
    half zeros) channels_last, w8 over the full int8 range (Cout, kh, kw,
    Cin), the dequant scale sx * sw of a 4.0 amax and 0.05-amax weights, a
    bias of 0.1 scale."""
    _, n, cin, h, w, cout, k, _, _ = shape
    rng = np.random.default_rng(seed)
    x8 = np.maximum(rng.integers(-127, 128, (n, h, w, cin), dtype=np.int8), 0)
    w8 = rng.integers(-127, 128, (cout, k, k, cin), dtype=np.int8)
    scale = (np.float32(4.0 / 127) * rng.uniform(0.5, 1.0, cout) * np.float32(0.05 / 127)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return (torch.from_numpy(x8).to(DEVICE).permute(0, 3, 1, 2), torch.from_numpy(w8).to(DEVICE),
            torch.from_numpy(scale).to(DEVICE), torch.from_numpy(bias).to(DEVICE))


def im2col_int8(x8: torch.Tensor, k: int, stride: int, pad: int) -> torch.Tensor:
    """(M, K) int8 rows of the conv's implicit GEMM, K ordered (Cin, kh, kw)
    as w.reshape(Cout, -1): through a float16 unfold (int8 values are exact
    in float16)."""
    n, cin = x8.shape[:2]
    if k == 1 and stride == 1 and pad == 0:
        return x8.permute(0, 2, 3, 1).reshape(-1, cin)
    cols = F.unfold(x8.to(torch.float16), k, padding=pad, stride=stride)  # (N, Cin*k*k, L)
    return cols.transpose(1, 2).reshape(-1, cin * k * k).to(torch.int8).contiguous()


def compare_int8(shape, seed: int, timed: bool) -> dict:
    """The kernel against int8_conv_plain on the card at one shape: the raw
    int32 sums and the float32 and bfloat16 epilogues bit-equal. Timed: the
    kernel (bfloat16 epilogue), the plain version, F.conv2d in bfloat16
    (cuDNN) on the same shape, and torch._int_mm on the im2col'd operands
    (the library GEMM alone: no im2col, no epilogue; Cout padded to a
    multiple of 8 where it is not one)."""
    from object_detection_torch2_tpu_torch.ops import int8_conv_cuda
    from object_detection_torch2_tpu_torch.ops.int8_conv import dequantize, int8_conv_plain

    name, _, cin, _, _, cout, k, s, p = shape
    x8, w8, scale, bias = int8_case(shape, seed)
    acc = int8_conv_plain(x8, w8, None, None, s, p)
    r = {"layer": name, "shape": list(shape[1:])}
    for mode, sc, b, dtype in (("int32", None, None, None), ("float32", scale, bias, torch.float32),
                               ("bfloat16", scale, bias.bfloat16(), torch.bfloat16)):
        got = int8_conv_cuda.int8_conv_cuda(x8, w8, sc, b, s, p, dtype)
        want = acc if sc is None else dequantize(acc, sc, b, dtype)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            err = float((got.double() - want.double()).abs().max()) if got.shape == want.shape else float("inf")
            raise AssertionError(f"int8 conv kernel differs from its plain version at {name} {shape[1:]} ({mode} "
                                 f"output): max |d| {err}")
    r["bit_equal"] = True
    if timed:
        bb = bias.bfloat16()
        r["kernel_ms"] = time_ms(lambda: int8_conv_cuda.int8_conv_cuda(x8, w8, scale, bb, s, p, torch.bfloat16),
                                 reps=5)
        r["plain_ms"] = time_ms(lambda: int8_conv_plain(x8, w8, scale, bb, s, p, torch.bfloat16), reps=1, trials=3,
                                warmup=1)
        xb, wb = x8.to(torch.bfloat16), w8.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous()
        r["cudnn_bf16_ms"] = time_ms(lambda: F.conv2d(xb, wb, bb, stride=s, padding=p), reps=5)
        a = im2col_int8(x8, k, s, p)
        wm = w8.permute(0, 3, 1, 2).reshape(cout, -1)
        npad = -(-cout // 8) * 8
        if npad != cout:
            wm = torch.cat([wm, torch.zeros((npad - cout, wm.shape[1]), dtype=torch.int8, device=DEVICE)])
        bmat = wm.t()  # (K, N), column-major
        try:
            r["int_mm_ms"] = time_ms(lambda: torch._int_mm(a, bmat), reps=5) if a.shape[0] > 16 else None
        except RuntimeError as e:  # a yardstick only: the library's shape rules vary across versions
            r["int_mm_ms"], r["int_mm_error"] = None, str(e).splitlines()[0]
        r["int_mm_cout"] = npad
        r.update(int8_bound(shape))
        del xb, wb, a
    del x8, acc
    torch.cuda.empty_cache()
    return r


def int8_layer_table(card: str, timed: bool = True) -> dict:
    """compare_int8 at every quantizable layer of SSD300 at batch 32 and
    300x300 (conv_1_2, the 11 trunk layers, 10 extras, 6 heads) and at a
    ragged shape; the sums over blocks 2-5 (the --trunk_int8 main path) and
    over the 27 layers of --full_int8."""
    from object_detection_torch2_tpu_torch.models.quant import FULL_QUANT_LAYERS, QUANT_LAYERS

    rows = [compare_int8(shape, i, timed) for i, shape in enumerate(int8_layer_shapes())]
    ragged = compare_int8(("ragged",) + INT8_RAGGED, 99, timed=False)
    tails = [compare_int8((name,) + shape, 100 + i, timed=False) for i, (name, shape) in enumerate(INT8_TAIL_CASES)]
    res = {"layers": rows, "ragged": ragged, "tails": tails}
    if timed:
        for key, names in (("trunk", QUANT_LAYERS[1:]), ("full", FULL_QUANT_LAYERS[1:])):
            sel = [r for r in rows if r["layer"] in names]
            sums = {f: sum(r[f] for r in sel) for f in ("kernel_ms", "plain_ms", "cudnn_bf16_ms", "bound_ms",
                                                        "operations", "bytes")}
            sums["int_mm_ms"] = (sum(r["int_mm_ms"] for r in sel) if all(r["int_mm_ms"] is not None for r in sel)
                                 else None)
            res[key] = {**sums, "layers": len(sel)}
        for r in rows:
            print(f"  int8 {r['layer']:>8} {r['shape']}: kernel {r['kernel_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                  f"({r['bound_by']}), cuDNN bf16 {r['cudnn_bf16_ms']:.4f}, _int_mm (GEMM alone) "
                  f"{r['int_mm_ms'] if r['int_mm_ms'] is None else round(r['int_mm_ms'], 4)}, plain "
                  f"{r['plain_ms']:.3f} ({card})")
    return res


def quantize_case(shape, dtype, pow2: bool, seed: int):
    """A seeded conv input (N, C, H, W) channels_last in `dtype` on the card
    and its scale: a third exact ties (k + 0.5) * sx (exact at the
    power-of-two sx; at the calibrated-like one, rounded to the dtype), the
    rest uniform over +-200 sx (beyond +-127 sx saturates), -0.0 at a
    thousand places."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    sx = 2.0 ** -5 if pow2 else float(np.float32(4.0 / 127 * np.random.default_rng(seed).uniform(0.5, 1.5)))
    n = int(np.prod(shape))
    x = (torch.rand(n, generator=g, device=DEVICE) * 400 - 200) * sx
    ties = torch.randint(-140, 140, (n // 3,), generator=g, device=DEVICE).float()
    x[:n // 3] = (ties + 0.5) * sx
    x[torch.randint(0, n, (1000,), generator=g, device=DEVICE)] = -0.0
    x = x.reshape(shape[0], shape[2], shape[3], shape[1]).permute(0, 3, 1, 2).to(dtype)
    return x, torch.tensor(sx, dtype=torch.float32, device=DEVICE)


def quantize_bound(n_elements: int, dtype) -> dict:
    """Each element read once (2 or 4 bytes) and written once (1 byte) at HBM's rate."""
    bytes_moved = n_elements * (torch.finfo(dtype).bits // 8 + 1)
    return {"bound_ms": bytes_moved / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes", "bytes": bytes_moved}


def quantize_table(card: str) -> dict:
    """The activation quantize kernel (csrc/quantize_act.cu) against the
    plain quant.quantize_act on the card at the input of each of the 27
    --full_int8 layers of SSD300 at batch 32, 300x300, in bfloat16 and
    float32, in both division contexts (true division; the reciprocal),
    at a power-of-two and a calibrated-like scale: bit-equal. Timed
    (true division, each dtype): kernel, plain chain, bound per layer; sums
    over blocks 2-5 and the 27 layers."""
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.models.quant import FULL_QUANT_LAYERS, QUANT_LAYERS
    from object_detection_torch2_tpu_torch.ops import quantize_act_cuda

    rows = []
    for i, (name, n, cin, h, w, *_) in enumerate(int8_layer_shapes()):
        if name not in FULL_QUANT_LAYERS[1:]:
            continue
        r = {"layer": name, "shape": [n, cin, h, w]}
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).replace("torch.", "")
            for pow2 in (True, False):
                x, sx = quantize_case((n, cin, h, w), dtype, pow2, 1000 * i + 2 * pow2 + (dtype == torch.float32))
                for reciprocal in (False, True):
                    got = quantize_act_cuda.quantize_act_cuda(x, sx, reciprocal)
                    want = quant.quantize_act(x, sx, reciprocal)
                    torch.cuda.synchronize()
                    if not (got.is_contiguous(memory_format=torch.channels_last) and torch.equal(got, want)):
                        raise AssertionError(f"quantize kernel differs from quant.quantize_act at {name} {r['shape']} "
                                             f"{dname} reciprocal={reciprocal} pow2={pow2}: "
                                             f"{int((got != want).sum())} elements")
            r[f"{dname}_kernel_ms"] = time_ms(lambda: quantize_act_cuda.quantize_act_cuda(x, sx, False), reps=10)
            r[f"{dname}_plain_ms"] = time_ms(lambda: quant.quantize_act(x, sx, False), reps=5)
            r[f"{dname}_bound_ms"] = quantize_bound(x.numel(), dtype)["bound_ms"]
            del x
        r["bit_equal"] = True
        r.update(quantize_bound(n * cin * h * w, torch.bfloat16))
        rows.append(r)
    torch.cuda.empty_cache()
    res = {"layers": rows}
    for key, names in (("trunk", QUANT_LAYERS[1:]), ("full", FULL_QUANT_LAYERS[1:])):
        sel = [r for r in rows if r["layer"] in names]
        res[key] = {f: sum(r[f] for r in sel) for f in ("bfloat16_kernel_ms", "bfloat16_plain_ms", "bfloat16_bound_ms",
                                                        "float32_kernel_ms", "float32_plain_ms", "float32_bound_ms",
                                                        "bytes")}
        res[key]["layers"] = len(sel)
    for r in rows:
        print(f"  quantize {r['layer']:>8} {r['shape']}: bfloat16 kernel {r['bfloat16_kernel_ms']:.4f} ms, bound "
              f"{r['bfloat16_bound_ms']:.4f} (bytes), plain {r['bfloat16_plain_ms']:.4f}; float32 kernel "
              f"{r['float32_kernel_ms']:.4f}, bound {r['float32_bound_ms']:.4f}, plain {r['float32_plain_ms']:.4f} "
              f"({card})")
    return res


def int8_launches(fn) -> tuple:
    """(fn's result, the int8 conv kernel's launches during it, the quantize
    kernel's): both counts are set to 0 just before and read just after."""
    from object_detection_torch2_tpu_torch.ops import int8_conv_cuda, quantize_act_cuda

    int8_conv_cuda.kernel_launches = 0
    quantize_act_cuda.kernel_launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, int8_conv_cuda.kernel_launches, quantize_act_cuda.kernel_launches


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-12))


def int8_trainer_check(card: str) -> dict:
    """Trainer(quant=) at batch 32, G = 64 with the conv12 kernel, in both
    dtypes: 11 int8 conv launches, 11 quantize launches and one conv12 launch
    of the dtype's kernel a forward, the trunk bit-unchanged, finite losses,
    ms per step against the float trainer's in turns (float, int8, int8,
    float)."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.models.quant import calibrate_trunk
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    df = default_boxes(feature_grids_for(IMSIZE))
    rng = np.random.default_rng(77)
    images = rng.integers(0, 256, (4, BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    targets = np.stack([synth_targets(rng, BATCH, rng.integers(1, G_PAD + 1, BATCH), G_PAD) for _ in range(4)])
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        float_model = SSD(num_classes=21, dtype=dtype, seed=0, conv12_kernel=True).to(DEVICE)
        qd = calibrate_trunk(float_model, [images[0]], margin=1.25)
        trainers = {}
        for kind in ("float", "int8"):
            model = SSD(num_classes=21, dtype=dtype, seed=0, conv12_kernel=True, trunk_int8=kind == "int8")
            tr = Trainer(model, default_boxes=df, quant=qd if kind == "int8" else None)
            st = tr.init_state(lambda ps: adam_torch(ps, exponential_epoch_schedule(1e-3, 0.7, 4), weight_decay=5e-4))
            trainers[kind] = (tr, st)
        tr, st = trainers["int8"]
        frozen0 = {k: v.clone() for k, v in st.frozen.items()}
        conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
        losses, launches, quant_launches = int8_launches(
            lambda: [float(tr.train_step(st, images[i], targets[i])) for i in range(3)])
        conv12_launches = conv12_cuda.kernel_launches[conv12_cuda.KERNEL_OF[dtype]]
        if launches != 3 * 11 or quant_launches != 3 * 11 or conv12_launches != 3:
            raise AssertionError(f"int8 Trainer {name}: {launches} int8 conv, {quant_launches} quantize and "
                                 f"{conv12_launches} conv12 launches in 3 steps, not 33, 33 and 3")
        if not np.isfinite(losses).all():
            raise AssertionError(f"int8 Trainer {name}: non-finite losses {losses}")
        for key, p in st.frozen.items():
            if not torch.equal(p, frozen0[key]):
                raise AssertionError(f"int8 Trainer {name}: frozen {key} changed")
        times = {"float": [], "int8": []}
        for kind in ("float", "int8", "int8", "float"):
            t, s = trainers[kind]
            for i in range(4):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                t.train_step(s, images[i], targets[i])
                e1.record()
                e1.synchronize()
                times[kind].append(e0.elapsed_time(e1))
        ms = {k: statistics.median(v) for k, v in times.items()}
        res[name] = {"int8_launches": launches, "quantize_launches": quant_launches,
                     "conv12_launches": conv12_launches, "losses": losses,
                     "step_ms_float": ms["float"], "step_ms_int8": ms["int8"], "scales": qd}
        print(f"int8 Trainer {name} bs{BATCH} G{G_PAD}: 3 steps, int8 conv launches {launches}, quantize "
              f"{quant_launches}, conv12 "
              f"({conv12_cuda.KERNEL_OF[dtype]}) launches {conv12_launches}, losses {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, trunk bit-unchanged; {ms['int8']:.2f} ms/step against {ms['float']:.2f} float "
              f"(in turns, CUDA events) ({card})")
        del trainers, tr, st, float_model
        torch.cuda.empty_cache()
    return res


def int8_train_cli_check(card: str, records: Path, tmp: Path) -> dict:
    """cli.train --trunk_int8 in bfloat16, 2 epochs of 4 steps and a
    validation batch: calibration (the float path, whose conv_1_2 is the
    bfloat16 conv12 kernel) over the first batches writes quant.json (the 12
    layers), then every forward (train steps and validation) launches the
    int8 conv kernel and the quantize kernel 11 times each and the conv12
    kernel once."""
    from object_detection_torch2_tpu_torch.cli import train
    from object_detection_torch2_tpu_torch.models.quant import QUANT_LAYERS
    from object_detection_torch2_tpu_torch.ops import conv12_cuda

    argv = ["--records_dir", str(records / "train"), "--val_records_dir", str(records / "val"), "--batch_size",
            str(BATCH), "--steps_per_epoch", str(CLI_STEPS), "--imsize", str(IMSIZE), "--dtype", "bfloat16",
            "--epochs", "2", "--result_dir", str(tmp / "result"), "--log_dir", str(tmp / "logs"), "--val_aug", "none",
            "--trunk_int8"]
    conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
    t0 = time.perf_counter()
    out, launches, quant_launches = int8_launches(lambda: train.main(argv))
    main_s = time.perf_counter() - t0
    forwards = 2 * (CLI_STEPS + VAL_RECORDS // BATCH)
    calib = min(8, -(-TRAIN_RECORDS // BATCH))  # --calib_batches 8
    qd = json.loads((tmp / "result" / "detection" / "quant.json").read_text())
    conv12 = conv12_cuda.kernel_launches["conv12_bf16"]
    if (set(qd) != {f"amax_{layer}" for layer in QUANT_LAYERS} or launches != 11 * forwards
            or quant_launches != 11 * forwards or conv12 != forwards + calib):
        raise AssertionError(f"training CLI --trunk_int8: quant.json keys {sorted(qd)}, {launches} int8 conv, "
                             f"{quant_launches} quantize and {conv12} conv12 launches for {forwards} forwards and "
                             f"{calib} calibration batches")
    losses = torch.cat(out["losses"]).float().cpu()
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"training CLI --trunk_int8: non-finite loss {losses.tolist()}")
    row = out["phase_times"][-1]
    print(f"training CLI --trunk_int8 bfloat16 bs{BATCH}: quant.json with {len(qd)} layers calibrated over {calib} "
          f"batches, 2 epochs, int8 conv launches {launches}, quantize {quant_launches} and conv12 {conv12} for "
          f"{forwards} forwards and the "
          f"calibration; epoch 2 train loop "
          f"{row['img_per_s_train_loop']} img/s, wall {row['img_per_s_wall']}; main() {main_s:.1f} s ({card})")
    return {"launches": launches, "quantize_launches": quant_launches, "conv12_launches": conv12,
            "quant_keys": len(qd), "losses": losses.tolist(),
            "phase_times": out["phase_times"], "main_s": main_s}


def int8_eval_check(card: str, mode: str, tmp: Path) -> dict:
    """cli.evaluate with --trunk_int8 (scales in quant.json) or --full_int8
    (calibrated by the CLI over the records' first batches and written to
    quant_full.json; a second run loads it), bfloat16, over 70 seeded records
    whose ground truth is planted on the int8 Predictor's own top-3
    detections: parity mAP 1.0, one NMS launch a batch, 11 or 27 int8 conv
    and as many quantize launches a batch, batch 0's matches through the
    plain int8 conv and the plain sweep identical to the pipeline's."""
    from object_detection_torch2_tpu_torch.cli import evaluate
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
    from object_detection_torch2_tpu_torch.infer import Predictor, postprocess
    from object_detection_torch2_tpu_torch.metrics.assign import detection_matches
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.models import ssd as ssd_mod
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import nms, nms_cuda
    from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv_plain
    from object_detection_torch2_tpu_torch.ops.scores import expand_detections
    from object_detection_torch2_tpu_torch.train.checkpoint import save_weights

    images = np.random.default_rng(31).integers(0, 256, (N_IMAGES, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    n_batches = -(-N_IMAGES // BATCH)
    per_forward = 11 if mode == "trunk_int8" else 27
    model = SSD(num_classes=21, dtype=torch.bfloat16, seed=0).to(DEVICE)
    result = tmp / mode / "result"
    save_weights(result / "detection" / "weights.msgpack", model)
    calib = [images[i:i + BATCH] for i in range(0, N_IMAGES, BATCH)]  # the CLI's first --calib_batches batches
    if mode == "trunk_int8":
        qd = quant.calibrate_trunk(model, calib, margin=1.25)
        quant.save_quant(result / "detection" / "quant.json", qd)
        model.trunk_int8 = True
    else:
        qd = quant.calibrate_full(model, calib, margin=1.25)
        model.full_int8 = True
    model.set_quant(qd)
    gts = plant_gts(Predictor(model, imsize=IMSIZE, batch_size=BATCH).predict(images))
    write_records(tmp / mode / "records", images, gts)
    argv = ["--records_dir", str(tmp / mode / "records"), "--result_dir", str(result), "--batch_size", str(BATCH),
            "--imsize", str(IMSIZE), "--dtype", "bfloat16", f"--{mode}"]
    runs = []
    for _ in range(1 if mode == "trunk_int8" else 2):
        nms_cuda.launches = 0
        t0 = time.perf_counter()
        (aps, mean_ap, _, _), launches, quant_launches = int8_launches(lambda: evaluate.main(argv))
        runs.append({"mean_ap": mean_ap, "aps": [float(a) for a in aps], "int8_launches": launches,
                     "quantize_launches": quant_launches, "nms_launches": nms_cuda.launches,
                     "main_s": time.perf_counter() - t0})
        if (not abs(mean_ap - 1.0) <= 1e-6 or nms_cuda.launches != n_batches or launches != per_forward * n_batches
                or quant_launches != per_forward * n_batches):
            raise AssertionError(f"evaluate --{mode}: parity mAP {mean_ap!r}, {nms_cuda.launches} NMS, {launches} "
                                 f"int8 conv and {quant_launches} quantize launches for {n_batches} batches")
    if mode == "full_int8":
        written = json.loads((result / "detection" / "quant_full.json").read_text())
        same_aps = np.array_equal(runs[0]["aps"], runs[1]["aps"], equal_nan=True)  # NaN: a class without GT
        if written != qd or not same_aps:
            raise AssertionError(f"evaluate --full_int8: quant_full.json equal to the calibration {written == qd}, "
                                 f"the loading run's APs equal {same_aps}")

    # batch 0: the pipeline's matches (int8 kernel, NMS kernel) against the
    # plain int8 conv and the plain sweep on the same batch
    run = evaluate.build_eval_pipeline(model, True, IMSIZE, 20, device=DEVICE)
    got, _ = run(images[:BATCH], gts[:BATCH], BATCH)
    df = torch.from_numpy(default_boxes(feature_grids_for(IMSIZE)).copy()).to(DEVICE)
    mask = torch.ones(BATCH, device=DEVICE)
    real_conv, ssd_mod.int8_conv = ssd_mod.int8_conv, int8_conv_plain
    try:
        with torch.inference_mode():
            out = model(to_tensor_batch(torch.from_numpy(images[:BATCH]).to(DEVICE)), use_batch_stats=True,
                        batch_mask=mask)
    finally:
        ssd_mod.int8_conv = real_conv
    with torch.inference_mode():
        packed, _ = postprocess(out, df, mask, sweep=nms._blocked_keep_sorted)
        want = detection_matches(expand_detections(packed[..., :4], packed[..., 4].long(), packed[..., 5], 21),
                                 torch.from_numpy(gts[:BATCH]).to(DEVICE), num_classes=20)
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"evaluate --{mode}: batch-0 matches '{key}' differ between the kernels and the "
                                 f"plain int8 conv and sweep")
    print(f"evaluation CLI --{mode} bfloat16 bs{BATCH}: parity mAP {runs[0]['mean_ap']:.7f} on ground truth planted "
          f"on the int8 model's detections, NMS launches {runs[0]['nms_launches']}, int8 conv launches "
          f"{runs[0]['int8_launches']} and quantize {runs[0]['quantize_launches']} for {n_batches} batches"
          + (", quant_full.json written by the first run equal to the calibration and loaded by the second (same "
             "APs)" if mode == "full_int8" else "")
          + f"; batch-0 matches identical through the plain int8 conv and plain sweep; main() "
          f"{runs[0]['main_s']:.1f} s ({card})")
    del model, run
    torch.cuda.empty_cache()
    return {"runs": runs, "launches": sum(r["int8_launches"] for r in runs),
            "quantize_launches": sum(r["quantize_launches"] for r in runs), "scales": qd}


def int8_accuracy_check(card: str) -> dict:
    """Random seeded weights (the worst case for quantization), float32: the
    JAX package's thresholds at its own tests' sizes (tests/test_quant.py):
    the int8 trunk against the float trunk at up_to 5_3 at 64x64, batch 2,
    cosine > 0.97; full int8 against float at the output at 264x264, batch
    2, cosine > 0.95. At the main path's 300x300 (batch 4) both cosines are
    reported and held above 0.95: quantization error grows with the map
    sizes, so the 64x64 trunk floor is not a 300x300 one."""
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.models.ssd import SSD

    model = SSD(num_classes=21, seed=0).to(DEVICE)
    res = {}
    cases = (("trunk_int8", 64, 2, 0.97), ("full_int8", 264, 2, 0.95), ("trunk_int8", IMSIZE, 4, 0.95),
             ("full_int8", IMSIZE, 4, 0.95))
    with torch.no_grad():
        for mode, size, n, floor in cases:
            x = torch.from_numpy(np.random.default_rng(41).random((n, size, size, 3)).astype(np.float32)).to(DEVICE)
            up_to = "5_3" if mode == "trunk_int8" else None
            qd = quant.calibrate_trunk(model, [x]) if mode == "trunk_int8" else quant.calibrate_full(model, [x])
            ref = model(x, up_to=up_to)
            q = SSD(num_classes=21, seed=0, **{mode: True}).to(DEVICE)
            q.set_quant(qd)
            out = q(x, up_to=up_to)
            key = f"{mode}_{size}_bs{n}"
            res[key] = {"cosine": cosine(out, ref), "std_ratio": float(out.double().std() / ref.double().std()),
                        "batch": n, "floor": floor}
            if not res[key]["cosine"] > floor or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{mode} at {size}x{size} against float: cosine {res[key]['cosine']} "
                                     f"(floor {floor})")
    print("int8 accuracy float32 (random weights): " + ", ".join(
        f"{k} bs{v['batch']} cosine {v['cosine']:.5f} (> {v['floor']}; std ratio {v['std_ratio']:.4f})"
        for k, v in res.items()) + f" ({card})")
    return res


def int8_export_check(card: str, tmp: Path) -> dict:
    """cli.inference --export_pipeline --trunk_int8 for cuda: the program holds
    11 calls of torch.ops.odt.int8_conv and 11 of torch.ops.odt.quantize_act,
    reloads, and gives the live int8 pipeline's rows with 11 launches of each
    kernel."""
    import io
    import zipfile

    from object_detection_torch2_tpu_torch.cli import inference
    from object_detection_torch2_tpu_torch.infer import build_detection_pipeline
    from object_detection_torch2_tpu_torch.models.quant import load_quant
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.serving import load_detection_pipeline

    result = tmp / "trunk_int8" / "result"  # the weights and quant.json of int8_eval_check
    path = tmp / "int8_pipeline.bin"
    argv = ["--result_dir", str(result), "--batch_size", str(BATCH), "--imsize", str(IMSIZE), "--dtype", "bfloat16",
            "--trunk_int8", "--export_pipeline", str(path), "--export_platforms", "cuda"]
    t0 = time.perf_counter()
    inference.main(argv)
    export_s = time.perf_counter() - t0
    with zipfile.ZipFile(path) as zf:
        program = torch.export.load(io.BytesIO(zf.read("cuda.pt2")))
    calls = sum(1 for n in program.graph.nodes if n.op == "call_function" and "int8_conv" in str(n.target))
    quant_calls = sum(1 for n in program.graph.nodes if n.op == "call_function" and "quantize_act" in str(n.target))
    exported, _ = load_detection_pipeline(path)
    images = np.random.default_rng(43).integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    (packed_x, valid_x), launches, quant_launches = int8_launches(lambda: exported(images, BATCH))
    model = SSD(num_classes=21, dtype=torch.bfloat16, seed=0, trunk_int8=True)
    model.set_quant(load_quant(result / "detection" / "quant.json"))
    packed_l, valid_l = build_detection_pipeline(model, True, IMSIZE, device=DEVICE)(images, BATCH)
    if (calls != 11 or quant_calls != 11 or launches != 11 or quant_launches != 11
            or not (torch.equal(packed_x, packed_l) and torch.equal(valid_x, valid_l))):
        raise AssertionError(f"exported --trunk_int8 pipeline: {calls} int8_conv and {quant_calls} quantize_act op "
                             f"calls in the graph, {launches} and {quant_launches} launches, rows equal to live "
                             f"{torch.equal(packed_x, packed_l)}")
    print(f"exported pipeline --trunk_int8 bfloat16 bs{BATCH} (cuda, {export_s:.1f} s): {calls} int8_conv and "
          f"{quant_calls} quantize_act calls in the graph, {launches} int8 conv and {quant_launches} quantize "
          f"launches, rows identical to the live int8 pipeline's ({card})")
    del model, exported
    torch.cuda.empty_cache()
    return {"graph_int8_calls": calls, "graph_quantize_calls": quant_calls, "launches": launches,
            "quantize_launches": quant_launches, "export_s": export_s}


def phase_int8(card: str) -> dict:
    """The int8 paths: the conv kernel and the quantize kernel against their
    plain versions at every layer (with the per-layer times), the Trainer,
    the training CLI, the evaluation CLI in both int8 modes, accuracy against
    float, the export."""
    t0 = time.perf_counter()
    res = {"table": int8_layer_table(card)}
    trunk, full = res["table"]["trunk"], res["table"]["full"]
    print(f"int8 conv kernel bit-equal to plain (int32, float32 and bfloat16 epilogues) at all "
          f"{len(res['table']['layers'])} quantizable layers, a ragged {list(INT8_RAGGED[:4])} and the K-tail / "
          f"ragged-N cases {[name for name, _ in INT8_TAIL_CASES]}; blocks 2-5 bs{BATCH}: "
          f"kernel {trunk['kernel_ms']:.3f} ms, bound {trunk['bound_ms']:.4f} ({trunk['operations'] / 1e12:.3f} T "
          f"int8 operations), cuDNN bf16 {trunk['cudnn_bf16_ms']:.3f}, _int_mm {trunk['int_mm_ms']}, plain "
          f"{trunk['plain_ms']:.2f}; all 27 full-int8 layers: kernel {full['kernel_ms']:.3f} ms, bound "
          f"{full['bound_ms']:.4f} ({card})")
    res["quantize"] = quantize_table(card)
    qt, qf = res["quantize"]["trunk"], res["quantize"]["full"]
    print(f"quantize kernel bit-equal to quant.quantize_act at the inputs of all {len(res['quantize']['layers'])} "
          f"--full_int8 layers (bfloat16 and float32, true division and reciprocal, power-of-two and calibrated "
          f"scales); blocks 2-5 bs{BATCH} bfloat16: kernel {qt['bfloat16_kernel_ms']:.4f} ms, bound "
          f"{qt['bfloat16_bound_ms']:.4f} (bytes), plain chain {qt['bfloat16_plain_ms']:.3f}; float32 kernel "
          f"{qt['float32_kernel_ms']:.4f}, bound {qt['float32_bound_ms']:.4f}, plain {qt['float32_plain_ms']:.3f}; "
          f"27 layers bfloat16: kernel {qf['bfloat16_kernel_ms']:.4f}, bound {qf['bfloat16_bound_ms']:.4f} ({card})")
    res["trainer"] = int8_trainer_check(card)
    rng = np.random.default_rng(56)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for split, n in (("train", TRAIN_RECORDS), ("val", VAL_RECORDS)):
            write_records(tmp / "records" / split, rng.integers(0, 256, (n, IMSIZE, IMSIZE, 3), dtype=np.uint8),
                          synth_targets(rng, n, rng.integers(1, G_PAD + 1, n), G_PAD))
        res["train_cli"] = int8_train_cli_check(card, tmp / "records", tmp / "cli")
        res["evaluation_trunk_int8"] = int8_eval_check(card, "trunk_int8", tmp)
        res["evaluation_full_int8"] = int8_eval_check(card, "full_int8", tmp)
        res["export"] = int8_export_check(card, tmp)
    res["accuracy"] = int8_accuracy_check(card)
    res["phase_s"] = time.perf_counter() - t0
    return res


DP_WORLD = 2  # ranks of the gloo runs, both on the one card
DP_STEPS = 3  # SGD steps of the 2-rank Trainer runs
DP_TURNS = 6  # timed step pairs of the NCCL world-1 A/B, in turns
DP_RANK_TIMEOUT = 300  # seconds for a group of ranks to finish


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for `rank` of a one-host group: every rank on
    card 0 (LOCAL_RANK 0: the machine has one), talking over the loopback."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "GLOO_SOCKET_IFNAME": "lo", "NCCL_SOCKET_IFNAME": "lo"}


def dp_trainer_runs(mesh, images, targets) -> dict:
    """`Trainer(mesh=)` at full width, float32 and bfloat16: DP_STEPS SGD
    steps on this rank's rows of each global batch (all rows without a
    mesh), cuDNN deterministic, conv12 kernel on; the conv12 launches of the
    steps (counts reset just before, read just after), the losses, the
    trained parameters and the running statistics on the host."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.parallel.mesh import local_rows
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.deterministic = True
    df = default_boxes(feature_grids_for(IMSIZE))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        trainer = Trainer(SSD(num_classes=21, dtype=dtype, seed=0, conv12_kernel=True), default_boxes=df,
                          mesh=mesh, device=None if mesh is not None else DEVICE)
        state = trainer.init_state(lambda ps: torch.optim.SGD(ps, lr=1e-3))
        torch.cuda.synchronize()
        conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
        losses = [float(trainer.train_step(state, local_rows(images[i], mesh), local_rows(targets[i], mesh)))
                  for i in range(DP_STEPS)]
        torch.cuda.synchronize()
        out[str(dtype).replace("torch.", "")] = {
            "losses": losses, "conv12_launches": conv12_cuda.kernel_launches[conv12_cuda.KERNEL_OF[dtype]],
            "params": {k: v.detach().cpu() for k, v in state.trainable.items()},
            "stats": {k: v.cpu() for k, v in state.batch_stats.items()}}
        del trainer, state
        torch.cuda.empty_cache()
    return out


DP_EVAL_RANK = """
import json, sys
from object_detection_torch2_tpu_torch.cli import evaluate
from object_detection_torch2_tpu_torch.ops import int8_conv_cuda, nms_cuda, quantize_act_cuda
nms_cuda.launches = int8_conv_cuda.kernel_launches = quantize_act_cuda.kernel_launches = 0
aps, mean_ap, strict_ap, _ = evaluate.main(sys.argv[2:])
json.dump({"mean_ap": mean_ap, "strict_ap": strict_ap, "aps": [float(a) for a in aps], "nms": nms_cuda.launches,
           "int8_conv": int8_conv_cuda.kernel_launches, "quantize_act": quantize_act_cuda.kernel_launches},
          open(sys.argv[1], "w"))
"""


def run_ranks(script: str, argv: list, world: int, tmp: Path) -> list:
    """`python -c script <result file> argv...` as `world` processes with
    torchrun's environment (one host, the one card), as torchrun starts
    them; every rank's JSON result. A rank that fails ends the others and
    raises with its error output."""
    import os

    port = free_port()
    procs, logs = [], [tmp / f"rank{rank}.log" for rank in range(world)]
    for rank in range(world):
        with open(logs[rank], "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", script, str(tmp / f"rank{rank}.json"), *argv],
                                          cwd=ROOT, env={**os.environ, **torchrun_env(rank, world, port)},
                                          stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + DP_RANK_TIMEOUT
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"rank(s) {bad} failed, were ended or timed out:\n"
                             + "".join(f"--- rank {r}:\n{logs[r].read_text()[-3000:]}" for r in bad))
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


def dp_nccl_world1(card: str, tmp: Path) -> dict:
    """NCCL at world size 1 (torchrun's environment set here), bfloat16,
    batch 32, G = 64, conv12 kernel: (1) `Trainer(mesh=)` against the plain
    Trainer from the same weights, steps in turns (plain, mesh, mesh,
    plain), CUDA events; both take the same steps on the same batches and
    must end bit-equal; 2 mesh steps under set_sync_debug_mode("error"); the
    gradient all-reduce alone. (2) `cli.train --distributed` (4 steps,
    --orbax_dir, so cuDNN deterministic) against the single-process CLI: the
    losses and the weights file bit-equal; its conv12 launches."""
    import os

    from object_detection_torch2_tpu_torch.cli import train
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import conv12_cuda
    from object_detection_torch2_tpu_torch.parallel import mesh as mesh_lib
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    os.environ.update(torchrun_env(0, 1, free_port()))
    mesh = mesh_lib.init_distributed()
    assert mesh.backend == "nccl" and mesh.world == 1, mesh
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        rng = np.random.default_rng(77)
        images = torch.from_numpy(rng.integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)).to(DEVICE)
        targets = torch.from_numpy(synth_targets(rng, BATCH, rng.integers(1, G_PAD + 1, BATCH), G_PAD)).to(DEVICE)
        df = default_boxes(feature_grids_for(IMSIZE))
        trainers, states = {}, {}
        for name, m in (("plain", None), ("mesh", mesh)):
            trainers[name] = Trainer(SSD(num_classes=21, dtype=torch.bfloat16, seed=0, conv12_kernel=True),
                                     default_boxes=df, augment=True, mesh=m, device=DEVICE)
            states[name] = trainers[name].init_state(
                lambda ps: adam_torch(ps, exponential_epoch_schedule(1e-3, 0.95, 100), weight_decay=5e-4))
        ms, host_ms = {"plain": [], "mesh": []}, {"plain": [], "mesh": []}
        for name in ("plain", "mesh", "plain", "mesh"):  # warm-up, two steps each
            trainers[name].train_step(states[name], images, targets)
        for _ in range(DP_TURNS):
            for name in ("plain", "mesh", "mesh", "plain"):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                trainers[name].train_step(states[name], images, targets)
                e1.record()
                host_ms[name].append((time.perf_counter() - t0) * 1e3)
                e1.synchronize()
                ms[name].append(e0.elapsed_time(e1))
        for name in ("plain", "mesh"):  # as many steps each: 2 + 2 * DP_TURNS
            assert states[name].step == 2 + 2 * DP_TURNS
        for key, v in states["plain"].model.state_dict().items():
            if not torch.equal(v, states["mesh"].model.state_dict()[key]):
                raise AssertionError(f"NCCL world-1 Trainer(mesh=) differs from the plain Trainer at {key}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                trainers["mesh"].train_step(states["mesh"], images, targets)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        grads = [torch.randn_like(p) for p in states["mesh"].trainable.values()]
        n_grad = sum(g.numel() for g in grads)
        allreduce_ms = time_ms(lambda: mesh_lib.all_reduce_mean_(grads, mesh), reps=20)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        mesh_lib.shutdown()
        del trainers, states
        torch.cuda.empty_cache()
    plain_ms, mesh_ms = statistics.median(ms["plain"]), statistics.median(ms["mesh"])
    res = {"plain_step_ms": plain_ms, "mesh_step_ms": mesh_ms, "overhead_ms": mesh_ms - plain_ms,
           "overhead_pct": (mesh_ms - plain_ms) / plain_ms * 100, "plain_ms_all": ms["plain"],
           "mesh_ms_all": ms["mesh"], "plain_host_ms": statistics.median(host_ms["plain"]),
           "mesh_host_ms": statistics.median(host_ms["mesh"]), "host_syncs_per_step": 0,
           "grad_allreduce_ms": allreduce_ms, "grad_floats": n_grad}
    print(f"data parallel, NCCL world 1, bf16 bs{BATCH} G{G_PAD} augmented Adam step: plain {plain_ms:.2f} ms, "
          f"Trainer(mesh=) {mesh_ms:.2f} ms ({res['overhead_pct']:+.2f}%, in turns, medians of {2 * DP_TURNS}; "
          f"host enqueue {res['plain_host_ms']:.2f} / {res['mesh_host_ms']:.2f} ms), bit-equal after "
          f"{2 + 2 * DP_TURNS} steps; 0 host syncs under set_sync_debug_mode('error'); "
          f"all-reduce of the {n_grad} trainable gradients {allreduce_ms:.4f} ms ({card})")

    # the training CLI, single process and --distributed (world 1, NCCL)
    rng = np.random.default_rng(78)
    images = rng.integers(0, 256, (TRAIN_RECORDS, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    write_records(tmp / "train_records", images,
                  synth_targets(rng, TRAIN_RECORDS, rng.integers(1, G_PAD + 1, TRAIN_RECORDS), G_PAD))
    argv = ["--records_dir", str(tmp / "train_records"), "--batch_size", str(BATCH), "--imsize", str(IMSIZE),
            "--dtype", "bfloat16", "--epochs", "1", "--steps_per_epoch", str(CLI_STEPS)]
    outs = {}
    for name, flags in (("single", []), ("distributed", ["--distributed"])):
        d = tmp / f"cli_{name}"
        os.environ.update(torchrun_env(0, 1, free_port()))
        conv12_cuda.kernel_launches.update(dict.fromkeys(conv12_cuda.kernel_launches, 0))
        out = train.main(argv + ["--result_dir", str(d), "--log_dir", str(d / "logs"), "--orbax_dir", str(d / "state"),
                                 *flags])
        outs[name] = {"losses": out["losses"][0].cpu(), "launches": conv12_cuda.kernel_launches["conv12_bf16"],
                      "weights": (d / "detection" / "weights.msgpack").read_bytes()}
    if not torch.equal(outs["single"]["losses"], outs["distributed"]["losses"]):
        raise AssertionError(f"cli.train --distributed (NCCL, world 1) losses {outs['distributed']['losses']} "
                             f"differ from the single-process run's {outs['single']['losses']}")
    if outs["single"]["weights"] != outs["distributed"]["weights"]:
        raise AssertionError("cli.train --distributed (NCCL, world 1) wrote another weights file than one process")
    if outs["distributed"]["launches"] != CLI_STEPS:
        raise AssertionError(f"cli.train --distributed launched conv12_bf16 {outs['distributed']['launches']} times "
                             f"in {CLI_STEPS} steps")
    res["cli"] = {"losses": outs["distributed"]["losses"].tolist(), "conv12_launches": outs["distributed"]["launches"]}
    print(f"data parallel, cli.train --distributed (NCCL, world 1), bf16, {CLI_STEPS} steps: losses and weights file "
          f"bit-equal to one process, {outs['distributed']['launches']} conv12_bf16 launches ({card})")
    return res


def dp_gloo_trainer(card: str) -> dict:
    """2 ranks on the one card over gloo (`launch`, both on cuda:0), global
    batch 32 (16 a rank), G = 64: `Trainer(mesh=)` against one process over
    the whole batch, SGD, float32 at the CPU tests' tolerances (losses rtol
    1e-5, parameters rtol 1e-4 / atol 4e-6, statistics rtol 1e-3 / atol
    1e-5) and bfloat16 to the trajectory budget (losses within 0.02, the
    trained models' eval forwards max |d| < 0.6, mean < 0.1); the ranks
    bit-identical; each rank's conv12 launches."""
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.parallel.mesh import launch

    rng = np.random.default_rng(79)
    images = rng.integers(0, 256, (DP_STEPS, BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    targets = np.stack([synth_targets(rng, BATCH, rng.integers(1, G_PAD + 1, BATCH), G_PAD) for _ in range(DP_STEPS)])
    t0 = time.perf_counter()
    ranks = launch(dp_trainer_runs, DP_WORLD, (images, targets), backend="gloo", devices=["cuda:0"] * DP_WORLD,
                   timeout=DP_RANK_TIMEOUT)
    launch_s = time.perf_counter() - t0
    one = dp_trainer_runs(None, images, targets)
    res = {"launch_s": launch_s}
    for name, r1 in one.items():
        r0, rb = ranks[0][name], ranks[1][name]
        if r0["losses"] != rb["losses"] or any(not torch.equal(r0[part][k], rb[part][k])
                                               for part in ("params", "stats") for k in r0[part]):
            raise AssertionError(f"{name}: the two ranks' losses, parameters or statistics differ")
        launches = [r["conv12_launches"] for r in (r0, rb)]
        if launches != [DP_STEPS] * DP_WORLD:
            raise AssertionError(f"{name}: conv12 launches per rank {launches}, expected {DP_STEPS} each")
        if name == "float32":
            np.testing.assert_allclose(r0["losses"], r1["losses"], rtol=1e-5)
            for part, rtol, atol in (("params", 1e-4, 4e-6), ("stats", 1e-3, 1e-5)):
                for k in r1[part]:
                    np.testing.assert_allclose(r0[part][k].numpy(), r1[part][k].numpy(), rtol=rtol, atol=atol,
                                               err_msg=f"{name} {part} {k}")
            check = "losses, parameters and statistics at the CPU tolerances"
        else:
            drift = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], r1["losses"]))
            if not drift < 0.02:
                raise AssertionError(f"bfloat16 2-rank loss drift {drift} from one process")
            outs = []
            for r in (r0, r1):
                model = SSD(num_classes=21, dtype=torch.bfloat16, seed=0).to(DEVICE)
                model.load_state_dict({**r["params"], **r["stats"]}, strict=False)
                with torch.inference_mode():
                    outs.append(model(torch.from_numpy(images[0]).to(DEVICE).float() / 255.0).float())
            d = (outs[0] - outs[1]).abs()
            if not (float(d.max()) < 0.6 and float(d.mean()) < 0.1):
                raise AssertionError(f"bfloat16 2-rank model's eval forward max |d| {float(d.max())}, mean "
                                     f"{float(d.mean())} from one process's")
            check = f"loss drift {drift:.2e}, eval forward max |d| {float(d.max()):.3f}, mean {float(d.mean()):.4f}"
        res[name] = {"losses": r0["losses"], "one_process_losses": r1["losses"], "conv12_launches": launches}
        print(f"data parallel, 2 gloo ranks on one card, Trainer(mesh=) {name} bs{BATCH} ({BATCH // DP_WORLD} a rank) G{G_PAD}, "
              f"{DP_STEPS} SGD steps against one process: {check}; ranks bit-identical; conv12 launches per rank "
              f"{launches} ({card})")
    return res


def dp_gloo_evaluate(card: str, tmp: Path) -> dict:
    """`cli.evaluate --distributed --dist_backend gloo` as 2 ranks on the
    one card, torchrun's environment set here, over 70 records at batch 32:
    the last batch of 6 leaves rank 1 an empty slice. float32 with batch
    statistics, ground truth planted on `Predictor`'s top-3 detections: parity
    mAP 1.0 in both runs, 3 NMS launches a rank. Then `--trunk_int8`
    (bfloat16, running statistics, scales calibrated here, ground truth
    planted on the int8 Predictor's detections): parity mAP 1.0 in both,
    3 NMS and 33 launches of each int8 kernel a rank."""
    from object_detection_torch2_tpu_torch.cli import evaluate
    from object_detection_torch2_tpu_torch.infer import Predictor
    from object_detection_torch2_tpu_torch.models import quant
    from object_detection_torch2_tpu_torch.models.ssd import SSD

    images = np.random.default_rng(80).integers(0, 256, (N_IMAGES, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    n_batches = -(-N_IMAGES // BATCH)
    res = {}
    for case, dtype, bn_mode, flags in (("float32", "float32", "batch", []),
                                        ("trunk_int8", "bfloat16", "running", ["--trunk_int8"])):
        result = tmp / f"eval_{case}"
        model = SSD(num_classes=21, dtype=getattr(torch, dtype), seed=0)
        if flags:
            scales = quant.calibrate_trunk(model.to(DEVICE), [images[:BATCH]], use_batch_stats=False, margin=1.25)
            (result / "detection").mkdir(parents=True)
            quant.save_quant(result / "detection" / "quant.json", scales)
            model.set_quant(scales)
            model.trunk_int8 = True
        gts = plant_gts(Predictor(model, imsize=IMSIZE, batch_size=BATCH, use_batch_stats=bn_mode == "batch")
                        .predict(images))
        write_records(tmp / f"records_{case}", images, gts)
        argv = ["--records_dir", str(tmp / f"records_{case}"), "--result_dir", str(result), "--batch_size", str(BATCH),
                "--imsize", str(IMSIZE), "--dtype", dtype, "--bn_mode", bn_mode, "--strict_ap", *flags]
        single = evaluate.main(argv)
        t0 = time.perf_counter()
        ranks = run_ranks(DP_EVAL_RANK, argv + ["--distributed", "--dist_backend", "gloo"], DP_WORLD, tmp)
        wall_s = time.perf_counter() - t0
        for r, got in enumerate(ranks):
            if got["mean_ap"] != single[1] or not abs(single[1] - 1.0) <= 1e-6:
                raise AssertionError(f"{case}: rank {r}'s parity mAP {got['mean_ap']!r}, one process's {single[1]!r} "
                                     "(planted ground truth: 1.0)")
            want = {"nms": n_batches, **({"int8_conv": 11 * n_batches, "quantize_act": 11 * n_batches} if flags
                                         else {})}
            if any(got[k] != v for k, v in want.items()):
                raise AssertionError(f"{case}: rank {r}'s launches {got}, expected {want}")
        res[case] = {"mean_ap": ranks[0]["mean_ap"], "strict_ap": ranks[0]["strict_ap"],
                     "single_strict_ap": single[2], "wall_s": wall_s,
                     "launches": [{k: got[k] for k in ("nms", "int8_conv", "quantize_act")} for got in ranks]}
        print(f"data parallel, cli.evaluate --distributed, 2 gloo ranks on one card, {case} ({bn_mode} statistics), "
              f"{N_IMAGES} records at batch {BATCH} (rank 1's last slice empty): parity mAP {ranks[0]['mean_ap']} on "
              f"both ranks = one process's; strict {ranks[0]['strict_ap']:.6f} (one process {single[2]:.6f}); "
              f"launches per rank {res[case]['launches']}; {wall_s:.1f} s with the ranks' start-up ({card})")
    return res


def phase_data_parallel(card: str) -> dict:
    """Data parallelism (parallel/mesh.py) on the one card: NCCL at world
    size 1 (the card has no second device, and NCCL refuses two ranks on one
    GPU), then 2 gloo ranks on the card (gloo's collectives take CUDA
    tensors) for the Trainer and the evaluate CLI."""
    import os

    saved = {k: os.environ.get(k) for k in torchrun_env(0, 1, 0)}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            res = {"nccl_world1": dp_nccl_world1(card, tmp)}
            res["gloo_trainer"] = dp_gloo_trainer(card)
            res["gloo_evaluate"] = dp_gloo_evaluate(card, tmp)
    finally:  # torchrun's variables as they were
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return res


def dp_launches(dp: dict) -> dict:
    """Each kernel's launches on the data-parallel paths, summed over ranks."""
    ev = dp["gloo_evaluate"]
    return {"conv12": sum(dp["gloo_trainer"]["float32"]["conv12_launches"]),
            "conv12_bf16": dp["nccl_world1"]["cli"]["conv12_launches"]
            + sum(dp["gloo_trainer"]["bfloat16"]["conv12_launches"]),
            "nms_keep_sorted": sum(r["nms"] for case in ev.values() for r in case["launches"]),
            "int8_conv": sum(r["int8_conv"] for r in ev["trunk_int8"]["launches"]),
            "quantize_act": sum(r["quantize_act"] for r in ev["trunk_int8"]["launches"])}


def int8_entry(r: dict) -> dict:
    """The kernels-line entry of int8_conv: times summed over the 11 layers
    of blocks 2-5 at batch 32 (the --trunk_int8 main path) in the top-level
    keys, every layer beside them; launches by path."""
    by_path = {"trainer": sum(r["trainer"][d]["int8_launches"] for d in ("float32", "bfloat16")),
               "train_cli": r["train_cli"]["launches"],
               "evaluation_trunk_int8": r["evaluation_trunk_int8"]["launches"],
               "evaluation_full_int8": r["evaluation_full_int8"]["launches"],
               "export": r["export"]["launches"]}
    t = r["table"]["trunk"]
    return {"name": "int8_conv", "route": "cuda", "custom_op": "odt::int8_conv (ops/registry.py)",
            "source": "object_detection_torch2_tpu_torch/csrc/int8_conv.cu",
            "replaces": "object_detection_torch2_tpu/models/quant.py:82 (int8_conv, a lax conv; not a TPU kernel)",
            "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": 0.0,
            "bit_equal_to_plain": True, "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "operations" if t["operations"] / PEAK_INT8_OPS_PER_S
            >= t["bytes"] / PEAK_BYTES_PER_S else "bytes", "library_ms": t["int_mm_ms"],
            "library": "torch._int_mm on the im2col'd operands (the GEMM alone), summed over blocks 2-5",
            "cudnn_bf16_ms": t["cudnn_bf16_ms"], "shape": "blocks 2-5 (11 convs) at batch 32, 300x300",
            "operations": t["operations"], "bytes": t["bytes"], "full_int8_27_layers": r["table"]["full"],
            "layers": r["table"]["layers"]}


def quantize_entry(r: dict) -> dict:
    """The kernels-line entry of quantize_act: bfloat16 times summed over the
    inputs of the 11 layers of blocks 2-5 at batch 32 (the --trunk_int8 main
    path), every layer beside them; launches by path. No single PyTorch call
    computes the same function (torch.quantize_per_tensor clamps to -128 and
    scales by the inverse), so library_ms is null."""
    by_path = {"trainer": sum(r["trainer"][d]["quantize_launches"] for d in ("float32", "bfloat16")),
               "train_cli": r["train_cli"]["quantize_launches"],
               "evaluation_trunk_int8": r["evaluation_trunk_int8"]["quantize_launches"],
               "evaluation_full_int8": r["evaluation_full_int8"]["quantize_launches"],
               "export": r["export"]["quantize_launches"]}
    t = r["quantize"]["trunk"]
    return {"name": "quantize_act", "route": "cuda", "custom_op": "odt::quantize_act (ops/registry.py)",
            "source": "object_detection_torch2_tpu_torch/csrc/quantize_act.cu",
            "replaces": "object_detection_torch2_tpu/models/quant.py:76 (quantize_act, jnp ops fused by XLA; "
                        "not a TPU kernel)",
            "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": 0.0,
            "bit_equal_to_plain": True, "ms": t["bfloat16_kernel_ms"], "plain_ms": t["bfloat16_plain_ms"],
            "bound_ms": t["bfloat16_bound_ms"], "bound_by": "bytes", "library_ms": None,
            "library": "none (torch.quantize_per_tensor is another function)",
            "float32": {"ms": t["float32_kernel_ms"], "plain_ms": t["float32_plain_ms"],
                        "bound_ms": t["float32_bound_ms"]},
            "shape": "the inputs of blocks 2-5 (11 convs) at batch 32, 300x300, bfloat16", "bytes": t["bytes"],
            "full_int8_27_layers": r["quantize"]["full"], "layers": r["quantize"]["layers"]}


def conv12_entry(conv: dict, training: dict, train_cli: dict, trajectory: dict, device_cache: dict) -> dict:
    """The kernels-line entry of conv12: the float32 kernel at the training
    path's shape in the top-level keys, the bfloat16 kernel (its own source)
    beside them; each one's launches summed over the training main path, the
    training CLI's runs, the trajectory replays and the --device_cache
    runs."""
    def keys(r, dtype):
        name = "conv12" if dtype == "float32" else "conv12_bf16"
        runs = ([train_cli[dtype][k] for k in ("first", "resumed", "straight")] if dtype == "bfloat16"
                else [train_cli[dtype]])
        by_path = {"training": training[dtype]["conv12_kernel_launches"][name],
                   "train_cli": sum(run["conv12_kernel_launches"][name] for run in runs),
                   "trajectory": trajectory[dtype]["conv12_launches"] + trajectory[f"{dtype}_100"]["conv12_launches"]}
        if dtype == "bfloat16":
            by_path["device_cache_cli"] = sum(device_cache[run]["conv12_kernel_launches"][name]
                                              for run in ("stream", "cached"))
        return {"route": "cuda", "custom_op": "odt::conv12 (ops/registry.py)",
                "source": f"object_detection_torch2_tpu_torch/csrc/{name}.cu",
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
    if sass["int8_conv"]["IGMMA"] == 0:
        raise AssertionError("csrc/int8_conv.cu's machine code has no int8 wgmma instruction (IGMMA)")

    results = {"card": card, "sass_tensor_core": sass, "reference": phase_reference(card)}
    results["kernel_vs_plain"] = phase_kernel_vs_plain(card)
    results["nms_batch256"] = phase_nms_batch256(card)
    main_path = phase_main_path(card)
    entries = [kernel_entry(main_path, card)]
    results["main_path"] = main_path
    results["evaluation"] = phase_evaluation(card)
    results["inference_cli"] = phase_inference_cli(card)
    results["serving_plumbing"] = phase_serving_plumbing(card)
    nms_paths = {path: sum(results[key][d]["launches"] for d in ("float32", "bfloat16"))
                 for path, key in (("serving", "main_path"), ("evaluation", "evaluation"),
                                   ("inference_cli", "inference_cli"))}
    nms_paths["evaluation_flags"] = sum(results["evaluation"][d]["flagged_launches"] for d in ("float32", "bfloat16"))
    nms_paths["batch256"] = results["nms_batch256"]["launches"]
    nms_paths["serving_plumbing"] = (results["serving_plumbing"]["predictor_launches"]
                                     + results["serving_plumbing"]["export_launches"])
    entries[0].update(launches=sum(nms_paths.values()), launches_by_path=nms_paths)
    results["conv12_vs_plain"] = phase_conv12(card)
    results["trajectory"] = phase_trajectory(card)
    results["training"] = phase_training(card)
    results["augment"] = phase_augment(card)
    results["train_cli"] = phase_train_cli(card)
    results["classification_cli"] = phase_classification_cli(card)
    results["device_cache_cli"] = phase_device_cache_cli(card)
    entries.append(conv12_entry(results["conv12_vs_plain"], results["training"], results["train_cli"],
                                results["trajectory"], results["device_cache_cli"]))
    results["int8"] = phase_int8(card)
    entries.append(int8_entry(results["int8"]))
    entries.append(quantize_entry(results["int8"]))
    results["data_parallel"] = phase_data_parallel(card)
    dp = dp_launches(results["data_parallel"])
    for entry, n in ((entries[0], dp["nms_keep_sorted"]), (entries[1], dp["conv12"]),
                     (entries[1]["bfloat16"], dp["conv12_bf16"]), (entries[2], dp["int8_conv"]),
                     (entries[3], dp["quantize_act"])):
        entry["launches_by_path"]["data_parallel"] = n
        entry["launches"] += n
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

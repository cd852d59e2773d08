"""Times the port's kernels on one CUDA card, for comparing two versions of
the package in one call:

    python3 kernel_times.py [--root DIR] [--label NAME]

imports `object_detection_torch2_tpu_torch` from DIR (default: this
checkout), and prints one JSON line with the card's name and power limit and,
in ms (CUDA events, as chip_smoke.py times them):
- `nms_keep_sorted_cuda` on chip_smoke.py's seeded clustered boxes at batch 32
  and widths 128, 1024 and 8732, dense and sparse, and on the serving main
  path's own sweep inputs (batch 0 of 70 seeded uint8 images through
  SSD(seed=0) in float32 at imsize 300);
- `conv12_cuda` at the training path's (32, 64, 300, 300) in float32 and
  bfloat16.

With --profile it also prints, from a torch.profiler trace of one call
each, the device time of every CUDA kernel that the NMS sweep at the main
path's inputs and conv_1_2 in bfloat16 launch.

With --train_step it also times `Trainer.train_step` at batch 32, G = 64,
imsize 300 with the conv12 kernel and no augment, in float32 and bfloat16:
the median host-clock ms of a step (each step ends in a synchronize) over 8
steps after 2 warm-up steps, and the host syncs a step makes, counted by
`torch.cuda.set_sync_debug_mode("warn")` over 2 more steps; then the same
step with `torch.backends.cudnn.deterministic` off and on, in turns (off,
on, on, off; 8 timed steps each), for the cost of an exact resume.

With --ops it times each kernel through its `torch.library` custom op
(`torch.ops.odt.*`, ops/registry.py) against its direct ctypes wrapper, in
turns (direct, op, op, direct), at the main path's shapes: CUDA-event ms per
call, and the host's µs to enqueue a call (20 calls, no synchronize).

With --fetch it times evaluation (`cli.evaluate.accumulate`, bfloat16 SSD,
batch 32, 8 batches of seeded images with no ground truth) with the fetch
pipeline at depth 0 and depth 2, in turns (0, 2, 2, 0), host clock.

With --int8 it times the int8 conv kernel (csrc/int8_conv.cu, bfloat16
epilogue) at every quantizable layer of SSD300 at batch 32, 300x300, after
holding it bit-equal to its plain version there (chip_smoke.py's
`int8_layer_table`): per layer the kernel's ms, its bound, the plain
version's, cuDNN's bfloat16 conv and torch._int_mm on the im2col'd operands
(the GEMM alone), and the sums over blocks 2-5 and over the 27 layers of
--full_int8; then the activation quantize kernel (csrc/quantize_act.cu) at
each of those layers' inputs, held bit-equal first (chip_smoke.py's
`quantize_table`): its ms in bfloat16 and float32 beside its bytes bound and
the plain chain's; the tables for PERF.md. A checkout from before the
quantize kernel has no `quantize_table` run (its key is absent).

Run versions in separate processes in turn (A, B, B, A) and compare within
one call. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs


def nms_times() -> dict:
    from object_detection_torch2_tpu_torch.ops import nms_cuda

    rng = np.random.default_rng(1234)
    out = {}
    for p in (128, 1024, 8732):
        for dense in (True, False):
            sb, sv = cs.clustered_sorted(rng, cs.BATCH, p, dense)
            out[f"nms_p{p}_{'dense' if dense else 'sparse'}"] = cs.time_ms(
                lambda: nms_cuda.nms_keep_sorted_cuda(sb, sv, cs.IOU_THRESH), reps=20)
    return out


def main_path_sweep_inputs():
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
    from object_detection_torch2_tpu_torch.infer import postprocess
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import nms

    images = np.random.default_rng(0).integers(0, 256, (cs.N_IMAGES, cs.IMSIZE, cs.IMSIZE, 3), dtype=np.uint8)
    df = torch.from_numpy(default_boxes(feature_grids_for(cs.IMSIZE)).copy()).to(cs.DEVICE)
    model = SSD(num_classes=21, dtype=torch.float32, seed=0).to(cs.DEVICE).eval()
    captured = {}

    def capture(b, v, t):
        captured["sb"], captured["sv"] = b.clone(), v.clone()
        return nms._blocked_keep_sorted(b, v, t)

    with torch.inference_mode():
        x = to_tensor_batch(torch.from_numpy(images[:cs.BATCH]).to(cs.DEVICE))
        mask = torch.ones(cs.BATCH, device=cs.DEVICE)
        postprocess(model(x, use_batch_stats=True, batch_mask=mask), df, mask, sweep=capture)
    return captured["sb"], captured["sv"]


def kernel_device_ms(fn) -> dict:
    """{kernel name: device ms} of one call of `fn` (after a warm-up), from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and ev.key.startswith(("nms_", "conv12", "void", "(anonymous")):
            out[ev.key[:80]] = t / 1e3
    return out


def _train_setup(dtype):
    """(trainer, state, images, targets) of the timed train step: SSD300 with
    the conv12 kernel at batch 32, G = 64, imsize 300, seeded."""
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(2024)
    images = rng.integers(0, 256, (cs.BATCH, cs.IMSIZE, cs.IMSIZE, 3), dtype=np.uint8)
    targets = cs.synth_targets(rng, cs.BATCH, rng.integers(1, cs.G_PAD + 1, cs.BATCH), cs.G_PAD)
    trainer = Trainer(SSD(num_classes=21, dtype=dtype, seed=0, conv12_kernel=True),
                      default_boxes=default_boxes(feature_grids_for(cs.IMSIZE)))
    return trainer, trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4)), images, targets


def _step_ms(trainer, state, images, targets, steps: int = 10, warmup: int = 2) -> list:
    """Host-clock ms of each step after `warmup`, each step synchronized."""
    out = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(state, images, targets)
        torch.cuda.synchronize()
        if i >= warmup:
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def train_step_times() -> dict:
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        trainer, state, images, targets = _train_setup(dtype)
        step_ms = _step_ms(trainer, state, images, targets)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(2):
                    trainer.train_step(state, images, targets)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("synchroniz" in str(w.message).lower() and "prototype" not in str(w.message) for w in caught)
        out[f"train_step_{name}_ms"] = statistics.median(step_ms)
        out[f"train_step_{name}_host_syncs"] = syncs / 2
        del trainer, state
        torch.cuda.empty_cache()
    return out


def deterministic_ab() -> dict:
    """The train step with cuDNN's deterministic algorithms off and on, in
    turns, both dtypes: median host-clock ms of 8 steps each."""
    out = {}
    saved = torch.backends.cudnn.deterministic
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        trainer, state, images, targets = _train_setup(dtype)
        times = {False: [], True: []}
        try:
            for det in (False, True, True, False):
                torch.backends.cudnn.deterministic = det
                times[det] += _step_ms(trainer, state, images, targets)
        finally:
            torch.backends.cudnn.deterministic = saved
        off, on = (statistics.median(times[d]) for d in (False, True))
        out[f"train_step_{name}_ms_cudnn_nondeterministic"] = off
        out[f"train_step_{name}_ms_cudnn_deterministic"] = on
        out[f"train_step_{name}_deterministic_cost"] = on / off - 1.0
        del trainer, state
        torch.cuda.empty_cache()
    return out


def ops_ab(sb, sv) -> dict:
    """Each kernel through its custom op against its direct ctypes wrapper, in
    turns: CUDA-event ms a call and the host's µs to enqueue one."""
    from object_detection_torch2_tpu_torch.ops import conv12_cuda, nms_cuda, registry

    def enqueue_us(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    cases = {"nms_main_path": (lambda: nms_cuda.nms_keep_sorted_cuda(sb, sv, cs.IOU_THRESH),
                               lambda: registry.nms_keep_sorted(sb, sv, cs.IOU_THRESH))}
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        x, w, b = cs.conv12_case(cs.CONV12_SHAPE, dtype, seed)
        cases[f"conv12_{str(dtype).replace('torch.', '')}"] = (
            lambda x=x, w=w, b=b: conv12_cuda.conv12_cuda(x, w, b), lambda x=x, w=w, b=b: registry.conv12(x, w, b, None))
    out = {}
    for name, (direct, op) in cases.items():
        ms = {"direct": [], "op": []}
        us = {"direct": [], "op": []}
        for route in ("direct", "op", "op", "direct"):
            fn = direct if route == "direct" else op
            ms[route].append(cs.time_ms(fn, reps=10, trials=3))
            us[route].append(enqueue_us(fn))
        for route in ms:
            out[f"{name}_{route}_ms"] = statistics.mean(ms[route])
            out[f"{name}_{route}_enqueue_us"] = statistics.mean(us[route])
        out[f"{name}_op_overhead_us"] = out[f"{name}_op_enqueue_us"] - out[f"{name}_direct_enqueue_us"]
    return out


def fetch_ab() -> dict:
    """Evaluation with the fetch pipeline at depth 0 and depth 2, in turns:
    img/s (host clock) over 8 batches of 32."""
    from object_detection_torch2_tpu_torch.cli import evaluate
    from object_detection_torch2_tpu_torch.models.ssd import SSD

    rng = np.random.default_rng(12)
    batches = [(rng.integers(0, 256, (cs.BATCH, cs.IMSIZE, cs.IMSIZE, 3), dtype=np.uint8),
                np.zeros((cs.BATCH, cs.G_PAD, 25), np.float32)) for _ in range(8)]
    run = evaluate.build_eval_pipeline(SSD(num_classes=21, dtype=torch.bfloat16, seed=0), True, cs.IMSIZE, 20,
                                       device=cs.DEVICE)
    evaluate.accumulate(run, batches, cs.BATCH, 20, 200)
    times = {0: [], 2: []}
    for depth in (0, 2, 2, 0, 0, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate.accumulate(run, batches, cs.BATCH, 20, 200, fetch_depth=depth)
        times[depth].append(time.perf_counter() - t0)
    return {f"eval_img_per_s_fetch_depth_{d}": len(batches) * cs.BATCH / statistics.median(t)
            for d, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent)
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--train_step", action="store_true")
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--fetch", action="store_true")
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is available")
    sys.path.insert(0, str(args.root.resolve()))
    import object_detection_torch2_tpu_torch as pkg
    from object_detection_torch2_tpu_torch.ops import conv12_cuda, nms_cuda

    res = {"label": args.label, "package": str(Path(pkg.__file__).parent), "card": cs.card_line()}
    res.update(nms_times())
    sb, sv = main_path_sweep_inputs()
    res["nms_main_path"] = cs.time_ms(lambda: nms_cuda.nms_keep_sorted_cuda(sb, sv, cs.IOU_THRESH), reps=20)
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        x, w, b = cs.conv12_case(cs.CONV12_SHAPE, dtype, seed)
        res[f"conv12_{str(dtype).replace('torch.', '')}"] = cs.time_ms(lambda: conv12_cuda.conv12_cuda(x, w, b), reps=5)
    if args.profile:
        res["profile_nms_main_path"] = kernel_device_ms(lambda: nms_cuda.nms_keep_sorted_cuda(sb, sv, cs.IOU_THRESH))
        rng = np.random.default_rng(1234)
        for p in (128, 1024):
            for case in ("dense", "sparse"):
                b4, v4 = cs.clustered_sorted(rng, cs.BATCH, p, case == "dense")
                res[f"profile_nms_p{p}_{case}"] = kernel_device_ms(
                    lambda: nms_cuda.nms_keep_sorted_cuda(b4, v4, cs.IOU_THRESH))
        res["profile_conv12_bfloat16"] = kernel_device_ms(lambda: conv12_cuda.conv12_cuda(x, w, b))
    if args.train_step:
        res.update(train_step_times())
        res.update(deterministic_ab())
    if args.ops:
        res.update(ops_ab(sb, sv))
    if args.fetch:
        res.update(fetch_ab())
    if args.int8:
        res["int8"] = cs.int8_layer_table(res["card"])
        if (Path(pkg.__file__).parent / "ops" / "quantize_act_cuda.py").is_file():
            res["quantize"] = cs.quantize_table(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Probes of BatchNorm's batch moments (models/bn.py, csrc/bn_moments.cu).

    python3 bn_probe.py --step0 [--device cpu]
    python3 bn_probe.py --host [--root DIR] [--label NAME]     # on the card

--step0: the step-0 gradients of the trajectory golden
(tests/goldens/train_trajectory.npz: batch 4, imsize 300, its
manifest-seeded weights, `Trainer` with conv12_kernel=True, batch statistics
in eval mode, as tests/test_torch_trajectory.py::test_step0_gradients takes
them), fingerprinted as the golden is, for three candidates: `float64` (the
SSD in float64, the exact reference), `float32` (the code as it is: the
variance taken in float64 from the float64 moments, `bn.batch_variance`) and
`float32_variance` (the same with the variance's subtraction in float32 from
the two float32-rounded moments). For each: the step-0 loss, and the largest
and the median relative drift of the fingerprints (of max(golden L2, 1e-4)),
with its tensor, against the golden and against the float64 run.

--host: on the card, for the package at DIR (default: this checkout): the
host's µs a call of one training-mode BatchNorm with batch statistics
(tiny tensors, no synchronize: forward, masked forward, forward and
backward), and the bfloat16 `Trainer.train_step` at batch 32, G = 64, with
and without augment: the median CUDA-event ms and host-enqueue ms of 12
steps, and the host ms of one step queued behind 0.17 s of device sleep
(a step that waits for it holds a host sync).

Prints one JSON line. Imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TRAJECTORY = ROOT / "tests" / "goldens" / "train_trajectory.npz"


def step0_fingerprints(device, dtype) -> tuple:
    """(keys, fingerprints, step-0 loss) of the golden's step-0 gradients
    with the SSD in `dtype`."""
    import chip_smoke as cs
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes
    from object_detection_torch2_tpu_torch.models.convert import jax_tree, ssd_state_dict_from_torch
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    g = np.load(TRAJECTORY)
    sd = ssd_state_dict_from_torch(cs.synth_state_dict(cs.unpack_manifest(g["manifest_keys"], g["manifest_shapes"]),
                                                       cs.synth_array_scaled))
    df = default_boxes().astype(np.float64 if dtype == torch.float64 else np.float32)
    trainer = Trainer(SSD(num_classes=21, conv12_kernel=True, dtype=dtype), default_boxes=df, device=device)
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), int(g["steps_per_epoch"]))
    state = trainer.init_state(lambda ps: adam_torch(ps, schedule, weight_decay=float(g["weight_decay"])),
                               state_dict=sd)
    images, targets = cs.synth_trajectory_batch(0, n=int(g["bs"]))
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 2, 3, 1))).to(device)
    state.model.eval()
    loss = trainer._loss(state.model(x, use_batch_stats=True), torch.from_numpy(targets).to(device, dtype))
    grads = torch.autograd.grad(loss, list(state.trainable.values()))
    keys, fp = cs.fingerprint_tree(jax_tree(dict(zip(state.trainable, (t.detach().cpu() for t in grads)))))
    return [str(k) for k in keys], fp, float(loss)


def drift(keys, fp, ref, l2) -> dict:
    rel = np.abs(fp - ref).max(axis=1) / np.maximum(l2, 1e-4)
    return {"max": float(rel.max()), "max_at": keys[int(rel.argmax())], "median": float(np.median(rel))}


def step0(device) -> dict:
    from object_detection_torch2_tpu_torch.models import bn

    g = np.load(TRAJECTORY)
    golden, l2 = g["grad_fp"], g["grad_fp"][:, 0]
    as_coded = bn.batch_variance

    def float32_variance(mean64, mean_sq64, dtype):
        mean, mean_sq = mean64.to(dtype), mean_sq64.to(dtype)
        return torch.clamp(mean_sq - mean.square(), min=0.0)

    runs = {}
    for name, dtype, variance in (("float64", torch.float64, as_coded), ("float32", torch.float32, as_coded),
                                  ("float32_variance", torch.float32, float32_variance)):
        bn.batch_variance = variance
        try:
            runs[name] = step0_fingerprints(device, dtype)
        finally:
            bn.batch_variance = as_coded
    keys, exact, _ = runs["float64"]
    out = {"golden_loss": float(g["losses"][0]), "golden_vs_float64": drift(keys, golden, exact, l2)}
    for name, (k, fp, loss) in runs.items():
        assert k == keys == [str(v) for v in g["grad_fp_keys"]], "gradient inventory differs from the golden's"
        out[name] = {"loss": loss, "vs_golden": drift(keys, fp, golden, l2), "vs_float64": drift(keys, fp, exact, l2)}
    return out


def host(root: Path, label: str) -> dict:
    sys.path.insert(0, str(root))
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
    from object_detection_torch2_tpu_torch.models.bn import BatchNorm
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.ops import _build
    from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("bn_probe --host: no CUDA device is available")
    _build.build_all()
    dev = torch.device("cuda")
    out = {"label": label, "root": str(root), "card": torch.cuda.get_device_name(0)}
    bn = BatchNorm(64).to(dev).train()
    x = torch.randn(4, 64, 8, 8, device=dev).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    m = torch.ones(4, device=dev)
    for name, mask, backward in (("fwd", None, False), ("fwd_masked", m, False), ("fwd_bwd", None, True)):
        def call():
            y = bn(x, True, mask)
            if backward:
                y.sum().backward()
        for _ in range(20):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        out[f"bn_{name}_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (32, 300, 300, 3), dtype=np.uint8)).to(dev)
    targets = torch.zeros(32, 64, 25, device=dev)
    targets[:, 0, :4] = torch.tensor([0.5, 0.5, 0.3, 0.3])
    targets[:, 0, 5] = 1.0
    df = default_boxes(feature_grids_for(300))
    for augment in (False, True):
        trainer = Trainer(SSD(num_classes=21, dtype=torch.bfloat16, seed=0, conv12_kernel=True), default_boxes=df,
                          augment=augment, device=dev)
        state = trainer.init_state(
            lambda ps: adam_torch(ps, exponential_epoch_schedule(1e-3, 0.95, 100), weight_decay=5e-4))
        for _ in range(3):
            trainer.train_step(state, images, targets)
        host_ms, device_ms = [], []
        for _ in range(12):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            trainer.train_step(state, images, targets)
            e1.record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            e1.synchronize()
            device_ms.append(e0.elapsed_time(e1))
        torch.cuda.synchronize()
        torch.cuda._sleep(int(3e8))
        t0 = time.perf_counter()
        trainer.train_step(state, images, targets)
        behind_sleep = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        key = "augment" if augment else "plain"
        out[f"step_{key}_ms"] = statistics.median(device_ms)
        out[f"step_{key}_host_ms"] = statistics.median(host_ms)
        out[f"step_{key}_host_behind_sleep_ms"] = behind_sleep
        del trainer, state
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--step0", action="store_true")
    mode.add_argument("--host", action="store_true")
    ap.add_argument("--device", default="cpu", help="--step0's device")
    ap.add_argument("--root", type=Path, default=ROOT, help="--host's package checkout")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    out = step0(torch.device(args.device)) if args.step0 else host(args.root.resolve(), args.label)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end accuracy proof on the card: `cli.train` -> `cli.evaluate`
closes the loop to an AP number (the port's counterpart of the repo's root
tools/overfit_proof.py: its flags, defaults, recipe and pass rule, plus
`--device`).

On the 4-image fixture VOC tree (tests/fixtures/voc/VOCtest):

  1. `cli.train.main` trains SSD300 (frozen VGG trunk, trainable extras and
     heads, Adam, MultiBox loss; conv_1_2 on the hand-written kernel) on the
     4 images until it has memorized them: augmentations off (`--train_aug
     none`), no lr decay (`--gamma 1.0`, one step an epoch);
  2. `cli.evaluate.main --strict_ap` on the same 4 images with the trained
     weights (the NMS kernel on the card);
  3. pass: the parity-metric mAP (quirk Q5, recall at IoU 0.5) >= --threshold.

Writes proofs_torch/overfit.json (tools/common.py) with the strict mAP, the
seconds and img/s of each stage, the kernels' launches, the card and the
JAX record beside it, and exits non-zero on failure.

    python -m object_detection_torch2_tpu_torch.tools.overfit_proof [--epochs 1500] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

from object_detection_torch2_tpu_torch.cli import evaluate as eval_cli
from object_detection_torch2_tpu_torch.cli import train as train_cli
from object_detection_torch2_tpu_torch.tools import common

JAX_RECORD = "PROOF_OVERFIT.json"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=1500)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--threshold", type=float, default=0.99,
                        help="required parity-metric mAP (recall@0.5, quirk Q5)")
    parser.add_argument("--result_dir", type=str, default=None,
                        help="default: a fresh temp dir (the proof must start from random init)")
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the CLIs; default the CUDA card, 'cpu' for the CPU")
    args = parser.parse_args(argv)

    result_dir = args.result_dir or tempfile.mkdtemp(prefix="overfit_proof_")
    log_dir = str(Path(result_dir) / "logs")
    data = str(common.FIXTURE)
    dev = common.device_flags(args.device)
    stages = common.Stages()

    t0 = time.time()
    with stages.stage("train"):
        out = train_cli.main([
            "--data_dirs", data,
            "--result_dir", result_dir,
            "--log_dir", log_dir,
            "--epochs", str(args.epochs),
            "--batch_size", "4",
            "--lr", str(args.lr),
            "--gamma", "1.0",          # 1 step/epoch here; epoch-wise 0.95 decay would zero the lr
            "--train_aug", "none",     # deterministic inputs: pure memorization test
            "--val_aug", "none",
            "--save_interval", "50",   # 1-step epochs: the ~100 MB weights file otherwise dominates
            "--dtype", args.dtype,
        ] + dev)
    train_s = time.time() - t0

    t1 = time.time()
    with stages.stage("evaluate"):
        aps, mean_ap, strict_map, _ = eval_cli.main([
            "--data_dirs", data,
            "--result_dir", result_dir,
            "--batch_size", "4",
            "--dtype", args.dtype,
            "--strict_ap",
        ] + dev)
    eval_s = time.time() - t1

    record = {
        "fixture_images": 4,
        "epochs": args.epochs,
        "lr": args.lr,
        "dtype": args.dtype,
        "parity_mAP": round(float(mean_ap), 4),
        "strict_mAP": round(float(strict_map), 4) if strict_map is not None else None,
        "per_class_AP": common.clean(aps),
        "threshold": args.threshold,
        "passed": bool(mean_ap >= args.threshold),
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        "train": common.trained_images(out, 4, train_s),
        "entry_points": ["object_detection_torch2_tpu_torch.cli.train", "object_detection_torch2_tpu_torch.cli.evaluate"],
        "kernel_launches": stages.launches(),
        "stages": stages.rows,
        "environment": common.environment(args.device),
        "jax_record": common.jax_record(JAX_RECORD),
    }
    common.write_record("overfit", record)
    if not record["passed"]:
        print(f"FAIL: parity mAP {mean_ap:.4f} < {args.threshold}", file=sys.stderr)
        return 1
    print(f"PASS: cli.train -> cli.evaluate closed loop, parity mAP {mean_ap:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

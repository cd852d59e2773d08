"""Generalization proof on the card: train on synthetic shapes, evaluate on a
held-out split (the port's counterpart of the repo's root
tools/generalization_proof.py: its flags, defaults, recipe and pass rule,
plus `--device`).

  1. `tools.synth_voc.generate` writes disjoint trainval/test splits of
     procedural shape scenes in VOC format (seed 0; the JAX proof's images);
  2. `cli.train.main` trains SSD300 on trainval with the trunk trained too
     (`--train_trunk`: no pretrained VGG16 exists offline; frozen random
     features cap held-out mAP near 0.3), Adam with exponential decay;
     `--use_records` packs both splits first (`data.records.pack_voc`) and
     trains and evaluates from the records, `--device_cache` holds them on
     the card;
  3. `cli.evaluate.main --strict_ap` on the unseen test split;
  4. pass: held-out parity mAP >= --threshold.

The committed run is the JAX record's bfloat16 arm: `--use_records
--train_aug reduced_hue`. Writes proofs_torch/generalization.json
(tools/common.py) and exits non-zero on failure.

    python -m object_detection_torch2_tpu_torch.tools.generalization_proof --use_records --train_aug reduced_hue
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

from object_detection_torch2_tpu_torch.cli import evaluate as eval_cli
from object_detection_torch2_tpu_torch.cli import train as train_cli
from object_detection_torch2_tpu_torch.data import records
from object_detection_torch2_tpu_torch.tools import common
from object_detection_torch2_tpu_torch.tools.synth_voc import generate

JAX_RECORD = "PROOF_GENERALIZATION.json"


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--eval_batch_size", type=int, default=4)
    parser.add_argument("--n_train", type=int, default=640)
    parser.add_argument("--n_test", type=int, default=48)
    parser.add_argument("--train_aug", type=str, default="none",
                        choices=["train", "none", "reduced_hue"],
                        help="default none: the reference's hue jitter (±0.5 = full hue "
                             "rotation) destroys color identity, the synthetic classes' primary "
                             "signal. 'reduced_hue' keeps all augmentations (jitter at ±0.05 hue, "
                             "flip, erase) so the augment path is exercised at accuracy level")
    parser.add_argument("--use_records", action="store_true",
                        help="pack both splits with data/records.py and train/evaluate "
                             "through the --records_dir path")
    parser.add_argument("--device_cache", action="store_true",
                        help="with --use_records: hold both splits resident on the card "
                             "(data/device_cache.py)")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="required parity-metric mAP on the held-out split")
    parser.add_argument("--data_dir", type=str, default=None, help="reuse an existing synth tree")
    parser.add_argument("--result_dir", type=str, default=None)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the CLIs; default the CUDA card, 'cpu' for the CPU")
    args = parser.parse_args(argv)

    if args.data_dir:
        data = args.data_dir
    else:
        data = tempfile.mkdtemp(prefix="synthvoc_")
        generate(Path(data), args.n_train, args.n_test, seed=0)
    result_dir = args.result_dir or tempfile.mkdtemp(prefix="gen_proof_")
    dev = common.device_flags(args.device)
    stages = common.Stages()

    if args.use_records:
        rec_train = str(Path(result_dir) / "rec_train")
        rec_test = str(Path(result_dir) / "rec_test")
        with stages.stage("pack"):
            records.pack_voc([data], "trainval.txt", rec_train, log_every=0, num_workers=args.num_workers)
            records.pack_voc([data], "test.txt", rec_test, log_every=0, num_workers=args.num_workers)
        train_data_flags = ["--records_dir", rec_train, "--val_records_dir", rec_test]
        if args.device_cache:
            train_data_flags.append("--device_cache")
        eval_data_flags = ["--records_dir", rec_test]
    else:
        train_data_flags = ["--data_dirs", data]
        eval_data_flags = ["--data_dirs", data]

    t0 = time.time()
    with stages.stage("train"):
        out = train_cli.main(train_data_flags + [
            "--result_dir", result_dir,
            "--log_dir", str(Path(result_dir) / "logs"),
            "--epochs", str(args.epochs),
            "--batch_size", str(args.batch_size),
            "--num_workers", str(args.num_workers),
            "--lr", str(args.lr),
            "--gamma", str(args.gamma),
            "--val_aug", "none",
            "--train_aug", args.train_aug,
            "--save_interval", "10",
            "--train_trunk",  # no pretrained VGG exists offline; frozen random features cap held-out mAP ~0.3
            "--dtype", args.dtype,
        ] + dev)
    train_s = time.time() - t0

    t1 = time.time()
    with stages.stage("evaluate"):
        aps, mean_ap, strict_map, _ = eval_cli.main(eval_data_flags + [
            "--result_dir", result_dir,
            "--batch_size", str(args.eval_batch_size),
            "--num_workers", str(args.num_workers),
            "--dtype", args.dtype,
            "--strict_ap",
        ] + dev)
    eval_s = time.time() - t1

    record = {
        "train_images": args.n_train,
        "heldout_test_images": args.n_test,
        "epochs": args.epochs,
        "parity_mAP_heldout": round(float(mean_ap), 4),
        "strict_mAP_heldout": round(float(strict_map), 4) if strict_map is not None else None,
        "per_class_AP": common.clean(aps),
        "threshold": args.threshold,
        "passed": bool(mean_ap >= args.threshold),
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        "train": common.trained_images(out, args.batch_size, train_s),
        "train_aug": args.train_aug,
        "use_records": bool(args.use_records),
        "device_cache": bool(args.device_cache),
        "dtype": args.dtype,
        "recipe": "full trunk trained (--train_trunk: no pretrained VGG16 exists offline; frozen random "
                  "features measured 0.31 held-out recall in the JAX package), Adam + exp decay",
        "kernel_launches": stages.launches(),
        "stages": stages.rows,
        "environment": common.environment(args.device),
        "jax_record": common.jax_record(JAX_RECORD),
    }
    common.write_record("generalization", record)
    if not record["passed"]:
        print(f"FAIL: held-out parity mAP {mean_ap:.4f} < {args.threshold}", file=sys.stderr)
        return 1
    print(f"PASS: held-out parity mAP {mean_ap:.4f} (unseen images)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

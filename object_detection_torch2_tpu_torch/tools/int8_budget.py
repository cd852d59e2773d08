"""Int8 accuracy budget on the card: what the int8 paths cost in mAP on
trained weights (the port's counterpart of the repo's root
tools/int8_budget.py: its flags, defaults and measurements, plus `--device`
and a pass rule).

Three measurements, strongest first (a 48-image held-out set carries ~0.05
mAP of trajectory noise between training runs, so the same-weights
comparisons carry the budget):

  1. trunk drift: the trained trunk's block-5 output on held-out images,
     float against int8 (the int8 conv and quantize kernels on the card):
     cosine and relative L2;
  2. same-weights evaluation: one set of trained detection weights
     evaluated with the float model, with `--trunk_int8` at calibration
     margins 1.0 / --calib_margin / 1.5 (per-class strict deltas), and with
     `--full_int8`; saturation rates of every quantized layer on held-out
     and augmented train images at margin 1.0 and --calib_margin;
  3. the trained-with-int8 arm: the frozen-trunk recipe re-run with
     `cli.train --trunk_int8` from the same pretrained trunk and seed,
     evaluated int8 and float.

Setup as tools/pretrained_trunk_proof.py --trunk_source detection: the
trunk is pretrained by full-SSD training on a disjoint synthetic split
(seed 1), laid over a VGG16 variable set and frozen. Measurements 1-2 are
written first (`trained_with_int8_arm: "PENDING"`), then the whole record.
No arm's failure is caught: it fails the run.

Pass (the JAX package's measured spread plus the ~0.05 band of 48-image
noise): trunk-feature cosine >= 0.99; in the same-weights A/B each int8 arm
(`--trunk_int8` at --calib_margin, `--full_int8`) has parity mAP >= float -
0.05 and strict mAP >= float - 0.10. Writes proofs_torch/int8_budget.json
(tools/common.py) and exits non-zero on failure.

    python -m object_detection_torch2_tpu_torch.tools.int8_budget [--pretrain_epochs 100] [--det_epochs 120]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.cli import evaluate as eval_cli
from object_detection_torch2_tpu_torch.cli import train as train_cli
from object_detection_torch2_tpu_torch.cli.common import DTYPES
from object_detection_torch2_tpu_torch.data.augment import augment_batch
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.models import quant as quant_lib
from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.tools import common
from object_detection_torch2_tpu_torch.tools.synth_voc import generate
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

JAX_RECORD = "INT8_BUDGET.json"
COSINE_MIN = 0.99  # trunk-feature cosine, int8 against float
PARITY_DROP_MAX = 0.05  # an int8 arm's parity mAP below float's, at most
STRICT_DROP_MAX = 0.10  # an int8 arm's strict mAP below float's, at most


def images(ds, n: int) -> np.ndarray:
    """The first n (or fewer) images of a dataset, uint8 (N, H, W, 3)."""
    return np.stack([ds[i][0] for i in range(min(n, len(ds)))])


def load_model(weights: Path, dtype: str, device) -> SSD:
    """The trained SSD of a weights file on `device`."""
    model = SSD(num_classes=21, dtype=DTYPES[dtype], seed=0)
    model.load_state_dict(ssd_state_dict_from_jax_variables(ckpt.load_weights(weights)))
    return model.to(device)


def saturation(model, base_scales: dict, margin: float, test_imgs, calib, device) -> dict:
    """Saturation rates of each quantized trunk layer at margin 1.0 and
    `margin`, on held-out images and on augmented train images (the
    harshest distribution the int8 train path quantizes; augment draws
    from a generator seeded 7)."""
    gts = torch.zeros((calib.shape[0], 1, 25), dtype=torch.float32, device=device)
    aug = augment_batch(torch.Generator().manual_seed(7), torch.from_numpy(calib).to(device), gts)[0]

    def sat(scales, batches):
        return {k: round(v, 6) for k, v in quant_lib.saturation_rates(model, scales, batches).items()}

    scaled = {k: v * margin for k, v in base_scales.items()}
    return {"margin_1.0": {"heldout": sat(base_scales, [test_imgs]), "augmented_train": sat(base_scales, [aug])},
            f"margin_{margin}": {"heldout": sat(scaled, [test_imgs]), "augmented_train": sat(scaled, [aug])}}


@torch.no_grad()
def trunk_drift(model, scales: dict, test_imgs, device) -> dict:
    """Block-5 output on `test_imgs` (batch statistics), float against the
    int8 trunk with `scales`: cosine and relative L2 in float64."""
    x = torch.from_numpy(test_imgs).to(device).to(torch.float32) / 255.0
    model.eval()
    feats_f = model(x, up_to="5_3")
    model.set_quant(scales)
    model.trunk_int8 = True
    try:
        feats_q = model(x, up_to="5_3")
    finally:
        model.trunk_int8 = False
    a = feats_f.double().flatten().cpu().numpy()
    b = feats_q.double().flatten().cpu().numpy()
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
    rel = float(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12))
    return {"cosine": round(cos, 6), "rel_l2": round(rel, 6),
            "note": "block-5 output on held-out images, same trained weights"}


def budget(record: dict) -> dict:
    """The pass rule over measurements 1-2: each check and `passed`."""
    ab = record["same_weights_eval_ab"]
    f = ab["float_trunk"]
    checks = {"cosine": record["trunk_feature_drift_int8_vs_float"]["cosine"] >= COSINE_MIN}
    for arm in ("int8_trunk_serving", "full_int8_serving"):
        checks[f"{arm}_parity"] = ab[arm]["parity_mAP"] >= f["parity_mAP"] - PARITY_DROP_MAX
        checks[f"{arm}_strict"] = ab[arm]["strict_mAP"] >= f["strict_mAP"] - STRICT_DROP_MAX
    return {"checks": checks, "passed": all(checks.values()),
            "rule": f"cosine >= {COSINE_MIN}; each int8 arm: parity >= float - {PARITY_DROP_MAX}, "
                    f"strict >= float - {STRICT_DROP_MAX}"}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pretrain_epochs", type=int, default=100)
    parser.add_argument("--det_epochs", type=int, default=120)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--eval_batch_size", type=int, default=4)
    parser.add_argument("--n_train", type=int, default=640)
    parser.add_argument("--n_test", type=int, default=48)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--gamma", type=float, default=0.99)
    parser.add_argument("--train_aug", type=str, default="none",
                        choices=["train", "none", "reduced_hue"])
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--calib_margin", type=float, default=1.25)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--work_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the CLIs and the drift measurement; default the CUDA card, "
                             "'cpu' for the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    work = Path(args.work_dir or tempfile.mkdtemp(prefix="int8_budget_"))
    work.mkdir(parents=True, exist_ok=True)
    if args.data_dir:
        data = args.data_dir
    else:
        data = str(work / "data")
        generate(Path(data), args.n_train, args.n_test, seed=0)
    dev = common.device_flags(args.device)
    stages = common.Stages()

    # ---- stage A: pretrain a trunk on a DISJOINT split (seed 1) -------------
    t0 = time.time()
    pre_data = str(work / "pre_data")
    pre_result = str(work / "pre_result")
    with stages.stage("pretrain"):
        if not (Path(pre_result) / "detection" / "weights.msgpack").exists():
            generate(Path(pre_data), args.n_train, 16, seed=1)
            train_cli.main([
                "--data_dirs", pre_data, "--result_dir", pre_result,
                "--dtype", args.dtype, "--num_workers", str(args.num_workers),
                "--purpose", "detection", "--train_trunk",
                "--log_dir", str(work / "logs_pre"),
                "--epochs", str(args.pretrain_epochs),
                "--batch_size", str(args.batch_size),
                "--lr", str(args.lr), "--gamma", str(args.gamma),
                "--train_aug", "none", "--val_aug", "none",
                "--save_interval", "10",
            ] + dev)
        cls_vars = common.detection_trunk_as_vgg16(
            ckpt.load_weights(Path(pre_result) / "detection" / "weights.msgpack"), common.vgg16_base_variables())
    pretrain_s = time.time() - t0

    def seed_arm(arm_dir: Path):
        ckpt.save_weights(arm_dir / "classification" / "weights.msgpack", cls_vars)

    flags = ["--data_dirs", data, "--dtype", args.dtype, "--num_workers", str(args.num_workers)]

    def train_arm(arm_dir: Path, extra):
        return train_cli.main(flags + [
            "--result_dir", str(arm_dir),
            "--log_dir", str(arm_dir / "logs"),
            "--epochs", str(args.det_epochs),
            "--batch_size", str(args.batch_size),
            "--lr", str(args.lr), "--gamma", str(args.gamma),
            "--train_aug", args.train_aug, "--val_aug", "none",
            "--save_interval", "10",
            # no --train_trunk: trunk seeded from classification/ and frozen
        ] + extra + dev)

    def eval_arm(arm_dir: Path, extra):
        aps, mean_ap, strict, strict_aps = eval_cli.main(flags + [
            "--result_dir", str(arm_dir),
            "--batch_size", str(args.eval_batch_size),
            "--strict_ap",
        ] + extra + dev)
        return round(float(mean_ap), 4), round(float(strict), 4), common.clean(aps), common.clean(strict_aps)

    def deltas(strict_aps, strict_aps_f):
        return [round(q - f, 4) if (q is not None and f is not None) else None
                for q, f in zip(strict_aps, strict_aps_f)]

    # ---- arm F: float trunk (the bf16 recipe as shipped) --------------------
    t1 = time.time()
    arm_f = work / "arm_float"
    seed_arm(arm_f)
    with stages.stage("train_float"):
        out_f = train_arm(arm_f, [])
    float_train_s = time.time() - t1
    with stages.stage("eval_float"):
        map_f, strict_f, aps_f, strict_aps_f = eval_arm(arm_f, [])

    # ---- measurements 1+2 on arm F's weights --------------------------------
    # activation scales calibrated for the trained weights on training images;
    # base scales are pure abs-max (margin 1.0) so the margin sweep scales them
    with stages.stage("drift"):
        model = load_model(arm_f / "detection" / "weights.msgpack", args.dtype, device)
        calib = images(PascalVOCDataset("detection", [data], "trainval.txt", 300), 32)
        base_scales = quant_lib.calibrate_trunk(model, [calib], margin=1.0)
        qd = {k: v * args.calib_margin for k, v in base_scales.items()}
        quant_lib.save_quant(arm_f / "detection" / "quant.json", qd)
        test_imgs = images(PascalVOCDataset("detection", [data], "test.txt", 300), 16)
        saturation_rates = saturation(model, base_scales, args.calib_margin, test_imgs, calib, device)
        print("saturation rates:", saturation_rates, flush=True)
        drift = trunk_drift(model, qd, test_imgs, device)
        full_scales = quant_lib.calibrate_full(model, [calib], margin=args.calib_margin)
        del model

    # same-weights eval A/B, swept over calibration margins: one set of
    # trained weights, int8 serving at margin m against the float eval
    margin_sweep = {}
    with stages.stage("eval_trunk_int8"):
        for m in sorted({1.0, args.calib_margin, 1.5}):
            quant_lib.save_quant(arm_f / "detection" / "quant.json", {k: v * m for k, v in base_scales.items()})
            pm, sm, _, strict_aps_m = eval_arm(arm_f, ["--trunk_int8"])
            margin_sweep[str(m)] = {"parity_mAP": pm, "strict_mAP": sm,
                                    "strict_per_class_delta_vs_float": deltas(strict_aps_m, strict_aps_f)}
            print(f"margin {m}: parity {pm} strict {sm} (float: {map_f}/{strict_f})", flush=True)
    # the production-margin scales back for any later use of arm F
    quant_lib.save_quant(arm_f / "detection" / "quant.json", qd)
    chosen = margin_sweep[str(args.calib_margin)]

    # full-model int8 serving (trunk, extras and heads), calibrated on
    # training images: the same arm-F weights
    quant_lib.save_quant(arm_f / "detection" / "quant_full.json", full_scales)
    with stages.stage("eval_full_int8"):
        map_full, strict_full, _, strict_aps_full = eval_arm(arm_f, ["--full_int8"])
    print(f"full int8: parity {map_full} strict {strict_full} (float: {map_f}/{strict_f})", flush=True)

    # the load-bearing measurements (1+2) on disk before the second long
    # training arm
    partial = {
        "setup": f"detection-pretrained trunk (disjoint split, {args.pretrain_epochs} ep) "
                 f"-> frozen-trunk heads-only training, {args.det_epochs} ep, "
                 f"{args.n_train} train / {args.n_test} held-out, dtype {args.dtype}",
        "trunk_feature_drift_int8_vs_float": drift,
        "same_weights_eval_ab": {
            "float_trunk": {"parity_mAP": map_f, "strict_mAP": strict_f, "per_class": aps_f,
                            "strict_per_class": strict_aps_f},
            "int8_trunk_serving": {"parity_mAP": chosen["parity_mAP"], "strict_mAP": chosen["strict_mAP"]},
            "full_int8_serving": {
                "parity_mAP": map_full, "strict_mAP": strict_full,
                "strict_per_class_delta_vs_float": deltas(strict_aps_full, strict_aps_f),
                "note": "every conv int8 incl. the six heads (no BN/ReLU after a head: quant error lands "
                        f"on raw logits); calibrated on train images, margin {args.calib_margin}"},
            "margin_sweep": margin_sweep,
            "note": "one set of trained weights evaluated each way: pure PTQ cost, no trajectory noise",
        },
        "saturation_rates": saturation_rates,
        "trained_with_int8_arm": "PENDING",
        "calib_margin": args.calib_margin,
        "dtype": args.dtype,
        "float_arm_train": common.trained_images(out_f, args.batch_size, float_train_s),
        "environment": common.environment(args.device),
        "jax_record": common.jax_record(JAX_RECORD),
    }
    partial["budget"] = budget(partial)
    partial["passed"] = partial["budget"]["passed"]
    partial["kernel_launches"] = stages.launches()
    partial["stages"] = stages.rows
    common.write_record("int8_budget", partial)
    print("partial int8_budget.json written (measurements 1+2)", flush=True)

    # ---- arm Q: trained WITH the int8 trunk (same pretrained trunk + seed) --
    t2 = time.time()
    arm_q = work / "arm_int8"
    seed_arm(arm_q)
    with stages.stage("train_int8"):
        out_q = train_arm(arm_q, ["--trunk_int8", "--calib_margin", str(args.calib_margin)])
    int8_train_s = time.time() - t2
    with stages.stage("eval_int8_arm"):
        map_q, strict_q, _, _ = eval_arm(arm_q, ["--trunk_int8"])
        # the int8-trained weights also serve on the float trunk
        map_q_float, strict_q_float, _, _ = eval_arm(arm_q, [])

    record = dict(partial)
    record["trained_with_int8_arm"] = {
        "parity_mAP": map_q, "strict_mAP": strict_q,
        "eval_float_trunk": {"parity_mAP": map_q_float, "strict_mAP": strict_q_float},
        "train_seconds": round(int8_train_s, 1),
        "float_arm_train_seconds": round(float_train_s, 1),
        "train": common.trained_images(out_q, args.batch_size, int8_train_s),
        "note": "same pretrained trunk + seed as the float arm; differences from the float arm's mAP "
                "include 120-epoch trajectory noise (~0.05 band on 48 held-out images)",
    }
    record["pretrain_seconds"] = round(pretrain_s, 1)
    record["kernel_launches"] = stages.launches()
    record["stages"] = stages.rows
    common.write_record("int8_budget", record)
    if not record["passed"]:
        print(f"FAIL: int8 budget {record['budget']['checks']}", file=sys.stderr)
        return 1
    print(f"PASS: int8 budget held ({record['budget']['rule']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

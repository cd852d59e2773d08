"""Shared CLI plumbing for the port's entry points
(counterpart of object_detection_torch2_tpu/cli/common.py:24-241).

The flags and their defaults are the JAX package's. Options whose code is not
ported yet raise NotImplementedError naming their ROADMAP item: multi-process
serving (`--distributed`) and a data-parallel mesh (`--num_devices` above 1)
wait for Queue 1 G2. The JAX package's persistent XLA compile cache has no
counterpart.

Int8 serving (`apply_int8`): `--trunk_int8` reads the scales the training CLI
calibrated, `<result_dir>/detection/quant.json`; `--full_int8` (which takes
precedence) reads `quant_full.json` there when it is complete, else
calibrates over the first `--calib_batches` batches of the run's dataset and
writes it. Both files have the JAX package's format. The calibration batches
are read by index on the host (`calib_image_batches`: the first
`calib_batches x batch_size` images, in order, the ones the JAX package's
unshuffled loader yields first), not through the threaded DataLoader, and a
run calibrates once.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
from object_detection_torch2_tpu_torch.models.convert import (
    jax_variables_from_state_dict,
    merge_variables,
    ssd_state_dict_from_jax_variables,
    ssd_trunk_from_vgg16_variables,
)
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

# reference data roots were hardcoded (reference: train.py:43, 50); here they
# are the defaults of --data_dirs
DEFAULT_TRAIN_DIRS = ["/work/data/VOCdevkit/VOC2007", "/work/data/VOCdevkit/VOC2012"]
DEFAULT_TEST_DIRS = ["/work/data/VOCdevkit/VOC2007"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def add_common_args(parser, batch_size_default: int):
    parser.add_argument("--imsize", type=int, default=300)
    parser.add_argument("--batch_size", type=int, default=batch_size_default)
    parser.add_argument("--num_workers", type=int, default=8,
                        help="decode worker processes for the raw-VOC path (reference "
                             "parity default 8, src/train.py:23); the --records_dir fast "
                             "path is memmap-bound and ignores this")
    parser.add_argument("--result_dir", type=str, default="./result")
    parser.add_argument("--weights", type=str, default="weights.msgpack")
    parser.add_argument("--data_dirs", type=str, nargs="+", default=None)
    parser.add_argument("--records_dir", type=str, default=None, help="packed records (data/records.py)")
    parser.add_argument("--dtype", type=str, choices=list(DTYPES), default="bfloat16")
    parser.add_argument("--max_gt", type=int, default=64)
    parser.add_argument("--num_devices", type=int, default=None,
                        help="data-parallel devices; above 1 is not ported yet (ROADMAP Queue 1 G2)")
    parser.add_argument(
        "--bn_mode",
        choices=["batch", "running"],
        default="batch",
        help="parity default 'batch': the reference never calls .eval() (quirk Q9)",
    )


def add_serving_args(parser):
    """Flags shared by the serving CLIs (inference/evaluate) beyond
    add_common_args; the multi-process one is not ported yet."""
    parser.add_argument("--trunk_int8", action="store_true",
                        help="serve the frozen VGG trunk's blocks 2-5 as int8 convolutions (models/quant.py; "
                             "the int8 kernel on the card); activation scales are read from "
                             "<result_dir>/detection/quant.json (written by cli.train --trunk_int8)")
    parser.add_argument("--full_int8", action="store_true",
                        help="serve the WHOLE model as int8 convolutions (trunk, extras and detector heads); "
                             "scales from <result_dir>/detection/quant_full.json, calibrated over the first "
                             "--calib_batches batches of this run's dataset when absent or stale")
    parser.add_argument("--calib_batches", type=int, default=8,
                        help="batches for --full_int8 auto-calibration")
    parser.add_argument("--calib_margin", type=float, default=1.25,
                        help="headroom factor on --full_int8 calibrated abs-maxes")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process data-parallel serving; not ported yet (ROADMAP Queue 1 G2)")


def init_serving_distributed(args):
    """(process_index, process_count) of a serving run: one process.
    `--distributed` raises until the scale-out slice."""
    if getattr(args, "distributed", False):
        raise NotImplementedError("--distributed: multi-process serving is not ported yet (ROADMAP Queue 1 G2)")
    return 0, 1


def serving_mesh(args):
    """The serving CLIs' data-parallel mesh: none, one device. `--num_devices`
    above 1 raises until the scale-out slice."""
    if args.num_devices is not None and args.num_devices > 1:
        raise NotImplementedError(f"--num_devices {args.num_devices}: data-parallel serving is not ported yet "
                                  "(ROADMAP Queue 1 G2)")
    return None


def calib_image_batches(dataset, n_batches: int, batch_size: int):
    """The first `n_batches` batches of `dataset` by index, in order (the
    last may be short), as uint8 numpy images (N, H, W, 3), for int8
    calibration: read on the host, no DataLoader thread."""
    n = len(dataset)
    for b in range(n_batches):
        lo = b * batch_size
        if lo >= n:
            return
        idx = np.arange(lo, min(lo + batch_size, n))
        if hasattr(dataset, "batch"):  # RecordDataset: one fancy index
            yield np.asarray(dataset.batch(idx)[0])
        else:
            yield np.stack([np.asarray(dataset[i][0]) for i in idx])


def apply_trunk_int8(args, model):
    """Serving-side --trunk_int8: the model on the int8 trunk path with the
    calibrated scales of <result_dir>/detection/quant.json (written by
    cli.train --trunk_int8)."""
    from object_detection_torch2_tpu_torch.models.quant import load_quant

    qp = Path(args.result_dir) / "detection" / "quant.json"
    if not qp.exists():
        raise SystemExit(f"--trunk_int8: {qp} not found — run train.py --trunk_int8 "
                         f"(auto-calibrates and saves it) first")
    model.set_quant(load_quant(qp))
    model.trunk_int8 = True
    return model


def apply_full_int8(args, model, batches, device):
    """Serving-side --full_int8: the model on the full int8 path (trunk,
    extras, heads) with scales read from <result_dir>/detection/
    quant_full.json when it is there and complete, else calibrated over
    `batches` (uint8 image batches of the run's own dataset) on `device`
    and written there. The model ends on `device`."""
    import json

    from object_detection_torch2_tpu_torch.models.quant import (
        FULL_QUANT_LAYERS,
        calibrate_full,
        missing_layers,
        save_quant,
    )

    qp = Path(args.result_dir) / "detection" / "quant_full.json"
    scales = None
    if qp.exists():
        scales = json.loads(qp.read_text())
        stale = missing_layers(scales, FULL_QUANT_LAYERS)
        if stale:
            print(f"quant_full.json is stale (no amax for {stale}) — recalibrating")
            scales = None
        else:
            print("full-int8 scales loaded.")
    model.to(device)
    if scales is None:
        scales = calibrate_full(model, batches, margin=args.calib_margin)
        qp.parent.mkdir(parents=True, exist_ok=True)
        save_quant(qp, scales)
        print(f"full-int8 scales calibrated ({args.calib_batches} batches, margin {args.calib_margin}) -> {qp}")
    model.set_quant(scales)
    model.full_int8 = True
    return model


def apply_int8(args, model, dataset, device):
    """--full_int8 (which takes precedence) or --trunk_int8 on `model`, or
    nothing; `dataset` gives --full_int8's calibration batches."""
    if getattr(args, "full_int8", False):
        return apply_full_int8(args, model, calib_image_batches(dataset, args.calib_batches, args.batch_size),
                               device)
    if getattr(args, "trunk_int8", False):
        return apply_trunk_int8(args, model)
    return model


def build_ssd(args, weights_path: Path, conv12_kernel: bool | None = None):
    """(SSD holding its weights, labelmap), in the reference's auto-load order
    (reference: ssd.py:25, 79-84):

    1. `weights_path` (`<result_dir>/detection/<weights>`) if it exists — a
       weights.msgpack written by either package;
    2. else the seeded init with `<result_dir>/classification/<weights>` (the
       JAX package's VGG16 classification weights) merged into the trunk, if
       that exists;
    3. else the seeded init.

    The seeded init is the port's own (`SSD(seed=0)`, torch's generator):
    the JAX package's `PRNGKey(0)` init cannot be reproduced in torch, so the
    two packages' untrained models differ. `conv12_kernel` is the SSD's
    (True: conv_1_2 on the hand-written kernel on the card).
    """
    labelmap = LabelMap("PascalVOC")
    model = SSD(num_classes=len(labelmap) + 1, dtype=DTYPES[args.dtype], seed=0, conv12_kernel=conv12_kernel)
    if weights_path.exists():
        print("weights loaded.")
        variables = ckpt.load_weights(weights_path)
    else:
        vgg_path = Path(args.result_dir) / "classification" / args.weights
        if not vgg_path.exists():
            return model, labelmap
        print("vgg16 trunk weights loaded.")
        variables = merge_variables(jax_variables_from_state_dict(model.state_dict(), model.num_classes),
                                    ssd_trunk_from_vgg16_variables(ckpt.load_weights(vgg_path)))
    model.load_state_dict(ssd_state_dict_from_jax_variables(variables, model.num_classes))
    return model, labelmap


def batched(iterable_len: int, batch_size: int):
    for start in range(0, iterable_len, batch_size):
        yield start, min(start + batch_size, iterable_len)


def pad_batch(images: np.ndarray, batch_size: int):
    """Pad a short final batch to the static batch size; returns (padded,
    real_count)."""
    n = images.shape[0]
    if n == batch_size:
        return images, n
    pad = np.repeat(images[-1:], batch_size - n, axis=0)
    return np.concatenate([images, pad], axis=0), n


def pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Pad to `rows` rows (repeat-last, or zeros when empty); the pad rows are
    masked out downstream via n_real."""
    n = arr.shape[0]
    if n == rows:
        return arr
    filler = (np.zeros((rows - n, *arr.shape[1:]), arr.dtype) if n == 0
              else np.repeat(arr[-1:], rows - n, axis=0))
    return np.concatenate([arr, filler], axis=0)

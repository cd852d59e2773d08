"""Shared CLI plumbing for the port's entry points
(counterpart of object_detection_torch2_tpu/cli/common.py:24-241).

The flags and their defaults are the JAX package's. The JAX package's
persistent XLA compile cache has no counterpart.

Data parallelism (`run_data_parallel`; parallel/mesh.py), one process a
device: `--distributed` joins the process group torchrun's environment
describes (it raises without it); `--num_devices N` without it starts N local
processes itself, rank r on cuda:r (at most the cards present, with a
printed note) or, with `--device cpu`, N gloo processes on the CPU (the
counterpart of the JAX tests' virtual CPU devices). The default is every
CUDA card, as the JAX package's mesh takes every device, and one process on
the CPU. `--dist_backend gloo` puts the collectives on gloo on the card too
(several ranks on one card, where NCCL refuses a duplicate GPU). A rank that
fails ends the others, and the run raises.

Int8 serving (`apply_int8`): `--trunk_int8` reads the scales the training CLI
calibrated, `<result_dir>/detection/quant.json`; `--full_int8` (which takes
precedence) reads `quant_full.json` there when it is complete, else
calibrates over the first `--calib_batches` batches of the run's dataset and
writes it. Both files have the JAX package's format. The calibration batches
are read by index on the host (`calib_image_batches`: the first
`calib_batches x batch_size` images, in order, the ones the JAX package's
unshuffled loader yields first), not through the threaded DataLoader, and a
run calibrates once: under several processes rank 0 calibrates and writes
the file, and the others wait at a barrier and load it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
from object_detection_torch2_tpu_torch.models.convert import (
    jax_variables_from_state_dict,
    merge_variables,
    ssd_state_dict_from_jax_variables,
    ssd_trunk_from_vgg16_variables,
)
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.parallel.mesh import barrier, init_distributed, launch, shutdown
from object_detection_torch2_tpu_torch.serving import pad_batch  # noqa: F401  (its old home)
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
                        help="data-parallel devices, one process each (rank r on cuda:r; with --device cpu, N "
                             "gloo processes); default every CUDA card, one process on the CPU. Under "
                             "--distributed it must equal the world size")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                        help="collectives' backend: default NCCL on the card, gloo on the CPU; gloo lets "
                             "several ranks share one card")
    parser.add_argument(
        "--bn_mode",
        choices=["batch", "running"],
        default="batch",
        help="parity default 'batch': the reference never calls .eval() (quirk Q9)",
    )


def add_serving_args(parser):
    """Flags shared by the serving CLIs (inference/evaluate) beyond
    add_common_args: the int8 paths and --distributed (multi-process
    serving under torchrun; --num_devices is in add_common_args)."""
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
                        help="multi-process data-parallel serving: join the process group of torchrun's "
                             "environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each "
                             "process loads and runs its slice of every batch; the eval metrics are "
                             "all-gathered at the end (metrics/ap.py merge_accumulators_across_processes)")


def init_serving_distributed(args):
    """`--distributed` (all three CLIs): join torchrun's process group ->
    this process's Mesh (raises without the environment); else None."""
    if not getattr(args, "distributed", False):
        return None
    return init_distributed(args.dist_backend, args.device)


def _devices_present(args) -> int:
    """Devices a run may take: the CUDA cards, or on the CPU as many gloo
    processes as --num_devices asks (default one)."""
    if resolve_device(args.device).type == "cuda":
        return torch.cuda.device_count()
    return args.num_devices or 1


def serving_mesh(args, mesh=None) -> int:
    """The serving CLIs' data-parallel world size, by the JAX package's rules
    (its cli/common.py:81-124).

    --distributed (`mesh` given): the mesh spans every rank: --num_devices
    must equal the world size and --batch_size must divide over it (equal
    per-process slices; no quiet reduction). Otherwise: every device present
    by default, capped by --num_devices, reduced to the largest count that
    divides --batch_size, with a printed note when reduced."""
    if mesh is not None:
        n = args.num_devices or mesh.world
        if n != mesh.world:
            raise ValueError(f"--num_devices {n} unsupported with --distributed (global mesh "
                             f"uses all {mesh.world} devices)")
        if args.batch_size % mesh.world:
            raise ValueError(f"--distributed: batch_size {args.batch_size} must divide over "
                             f"all {mesh.world} global devices")
        return mesh.world
    avail = _devices_present(args)
    n = min(args.num_devices or avail, avail)
    while args.batch_size % n:
        n -= 1
    if n < min(args.num_devices or avail, avail):
        print(f"note: serving on {n} device(s) — batch_size {args.batch_size} "
              f"does not divide over {args.num_devices or avail}")
    return n


def train_world(args, mesh=None) -> int:
    """The training CLI's data-parallel world size: the mesh's under
    --distributed (--num_devices must equal it), else --num_devices (default
    every device present) capped at the devices present, with a printed note,
    as the JAX package's `make_mesh(num_devices)` takes `devices[:n]`. The
    global batch must divide over it (the JAX CLI's check)."""
    if mesh is not None:
        n = args.num_devices or mesh.world
        if n != mesh.world:
            raise ValueError(f"--num_devices {n} unsupported with --distributed (global mesh "
                             f"uses all {mesh.world} devices)")
    else:
        avail = _devices_present(args)
        n = min(args.num_devices or avail, avail)
        if n < (args.num_devices or avail):
            print(f"note: training on {n} device(s) — --num_devices {args.num_devices}, "
                  f"{avail} present")
    if args.batch_size % n:
        raise ValueError(f"batch_size {args.batch_size} must divide over {n} devices")
    return n


def _rank_main(mesh, fn, args, drop):
    """One launched rank: fn(args, mesh), less the keys in `drop` (results
    that do not cross processes)."""
    result = fn(args, mesh)
    if isinstance(result, dict):
        result = {k: v for k, v in result.items() if k not in drop}
    return result


def run_data_parallel(args, fn, world_of, drop=()):
    """fn(args, mesh) as the flags ask: under --distributed once in this
    process with torchrun's mesh (the process group left at the end); with
    a world size (`world_of(args)`) above 1, in that many launched local
    processes, returning rank 0's result less the keys in `drop`; else once
    in this process with no mesh."""
    mesh = init_serving_distributed(args)
    if mesh is not None:
        try:
            world_of(args, mesh)
            return fn(args, mesh)
        finally:
            shutdown()
    world = world_of(args)
    if world == 1:
        return fn(args, None)
    return launch(_rank_main, world, (fn, args, tuple(drop)), device_type=resolve_device(args.device).type,
                  backend=args.dist_backend)[0]


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


def apply_full_int8(args, model, batches, device, mesh=None):
    """Serving-side --full_int8: the model on the full int8 path (trunk,
    extras, heads) with scales read from <result_dir>/detection/
    quant_full.json when it is there and complete, else calibrated over
    `batches` (uint8 image batches of the run's own dataset) on `device`
    and written there. The model ends on `device`. Under a mesh of several
    ranks, rank 0 does that (with its model not yet on the mesh: the
    calibration is one process's) while the others wait at a barrier, then
    load the file."""
    import json

    from object_detection_torch2_tpu_torch.models.quant import (
        FULL_QUANT_LAYERS,
        calibrate_full,
        missing_layers,
        save_quant,
    )

    qp = Path(args.result_dir) / "detection" / "quant_full.json"
    scales = None
    model.to(device)
    if mesh is None or mesh.rank == 0:
        if qp.exists():
            scales = json.loads(qp.read_text())
            stale = missing_layers(scales, FULL_QUANT_LAYERS)
            if stale:
                print(f"quant_full.json is stale (no amax for {stale}) — recalibrating")
                scales = None
            else:
                print("full-int8 scales loaded.")
        if scales is None:
            scales = calibrate_full(model, batches, margin=args.calib_margin)
            qp.parent.mkdir(parents=True, exist_ok=True)
            save_quant(qp, scales)
            print(f"full-int8 scales calibrated ({args.calib_batches} batches, margin {args.calib_margin}) -> {qp}")
    barrier(mesh)
    if scales is None:  # a rank other than 0: rank 0's file
        scales = json.loads(qp.read_text())
    model.set_quant(scales)
    model.full_int8 = True
    return model


def apply_int8(args, model, dataset, device, mesh=None):
    """--full_int8 (which takes precedence) or --trunk_int8 on `model`, or
    nothing; `dataset` gives --full_int8's calibration batches (the global
    batches: rank 0 calibrates under a mesh)."""
    if getattr(args, "full_int8", False):
        return apply_full_int8(args, model, calib_image_batches(dataset, args.calib_batches, args.batch_size),
                               device, mesh)
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


def pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Pad to `rows` rows (repeat-last, or zeros when empty); the pad rows are
    masked out downstream via n_real."""
    n = arr.shape[0]
    if n == rows:
        return arr
    filler = (np.zeros((rows - n, *arr.shape[1:]), arr.dtype) if n == 0
              else np.repeat(arr[-1:], rows - n, axis=0))
    return np.concatenate([arr, filler], axis=0)

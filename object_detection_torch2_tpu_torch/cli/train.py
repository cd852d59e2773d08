"""Training entry point (counterpart of object_detection_torch2_tpu/cli/train.py:39-500;
reference: src/train.py:14-158).

    python -m object_detection_torch2_tpu_torch.cli.train --records_dir <dir> [--val_records_dir <dir>] [--device cpu]

The JAX CLI's flags, defaults, loop and artifacts:

- per step: the uint8 batch and the augment draws go to the card -> the
  augment chain (jitter, flip, erase; data/augment.py) -> SSD300 forward ->
  MultiBox loss -> gradients of the extras and heads -> Adam with the
  per-epoch ExponentialLR. The step's loss stays on the card; the losses are
  read once an epoch (and every PROGRESS_EVERY steps for the progress line,
  one dispatch behind);
- `--steps_per_dispatch K` runs K steps a call through `Trainer.train_steps`
  (the same sequence as K single steps), the epoch's tail step by step;
- the validation pass every `--val_interval` epochs with the train augments
  (`--val_aug train`, quirk Q3), its draws from a generator seeded with
  seed + 1, one draw set per batch, as the JAX CLI's `PRNGKey(seed + 1)`
  split per batch (a resumed run starts it afresh, as the JAX CLI does);
- artifacts: `<result_dir>/detection/weights.msgpack` (flax's layout, which
  the JAX package loads) and `params.json` (with `base_lr` and
  `steps_per_epoch`) when the train loss improves, at `--save_interval`;
  TensorBoard scalars loss/train, loss/validation and lr (utils/tb.py);
  `<log_dir>/phase_times.json`; the full state at `--orbax_interval` in
  `--orbax_dir` (train/checkpoint.py; an exact resume, quirk Q7 fixed). The
  shuffle is anchored to the absolute epoch and the augment and dropout
  draws to the step, so a resumed run trains as an uninterrupted one would.
  On the card that needs cuDNN's deterministic algorithms (its weight
  gradients otherwise sum with atomics, in an order that changes from run to
  run), so the CLI switches them on whenever `--orbax_dir` is given and
  restores the caller's setting when it returns; the cost is in PERF.md §6;
- `--purpose classification` (JAX cli/train.py:302-328): `VGG16(20,
  transfer_learning=True)` (models/vgg16.py) on VOC object crops (or
  classification records), weights from `<result_dir>/classification/`
  when the file exists, the cross-entropy, and the trunk and the 20-way
  head trained (`vgg_trainable_predicate(True)`; the dead 1000-way head
  gets no Adam moments). Its weights file seeds the detection purpose's
  trunk (`cli.common.build_ssd`);
- `--device_cache` (needs `--records_dir`): the train and validation records
  resident on the card, each batch gathered there (data/device_cache.py).

The detection purpose runs conv_1_2 on the hand-written kernel
(`SSD(conv12_kernel=True)`): on the H100 it is faster than cuDNN in both
dtypes (PERF.md §6, row 2) and computes the same function within the
tolerances the kernel is held to. The JAX CLI leaves its Pallas kernel off
because on the TPU XLA's convolution wins. VGG16 has no kernel of its own: the
JAX package runs it on XLA's convolutions.

`--trunk_int8` (detection only, not with `--train_trunk`) runs blocks 2-5
of the frozen trunk as int8 convolutions (models/quant.py; the int8 kernel
on the card) with the scales of `<result_dir>/<purpose>/quant.json`: loaded
when it is there and complete, else (absent or stale) calibrated over the
first `--calib_batches` batches read by index from the training dataset with
the train augment applied (`_quant_scales`), and written for the serving
CLIs.

The run is on the CUDA card unless `--device cpu` is given; without a card it
raises. The JAX CLI's tqdm bar is a progress line here.

Data parallelism (`--distributed` with torchrun's environment, or
`--num_devices N`, which starts N local processes: cli.common's
`run_data_parallel`): each rank reads its contiguous slice of every global
batch of `--batch_size` (which must divide over the ranks), and
`Trainer(mesh=)` takes the global batch's step (global augment draws, sync
BatchNorm, one gradient all-reduce, Adam on every rank). Rank 0 alone
writes the weights file, params.json, the event file, phase_times.json and
the full state, the same bytes as one process's run, while the others wait
at a barrier: ranks on one host share a disk, and two writers of one file
would race (the JAX CLI writes from every process). A resume reads the full
state on every rank. With `--trunk_int8`, rank 0 calibrates (or loads) the
scales and writes quant.json, and the others load it after a barrier.
A launched run returns rank 0's result without its `state`.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.cli import common
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.models.convert import vgg16_state_dict_from_jax_variables
from object_detection_torch2_tpu_torch.models.vgg16 import VGG16, vgg_trainable_predicate
from object_detection_torch2_tpu_torch.parallel.mesh import barrier
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
from object_detection_torch2_tpu_torch.train.trainer import Trainer
from object_detection_torch2_tpu_torch.utils.profiling import ThroughputMeter, enable_debug_nans, maybe_trace
from object_detection_torch2_tpu_torch.utils.tb import SummaryWriter

PROGRESS_EVERY = 10  # steps between progress lines


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--purpose", choices=["detection", "classification"], default="detection",
                        help="'detection' trains the SSD; 'classification' the VGG16 on VOC object crops "
                             "(imsize ~184-215 gives its 7x7 grid, quirk Q10: use 200)")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--lr", type=float, default=None,
                        help="base learning rate (default 0.001). On a full-state resume an "
                             "EXPLICIT --lr overrides the checkpoint's recorded base_lr")
    parser.add_argument("--weight_decay", type=float, default=0.0005)
    parser.add_argument("--gamma", type=float, default=0.95)
    parser.add_argument("--params", type=str, default="params.json")
    common.add_common_args(parser, batch_size_default=4)
    parser.add_argument("--val_records_dir", type=str, default=None)
    parser.add_argument("--val_interval", type=int, default=1,
                        help="run the validation pass every N epochs (and always on the last); "
                             "1 = reference parity (src/train.py:127-139)")
    parser.add_argument("--val_aug", choices=["train", "none"], default="train",
                        help="parity default 'train' (quirk Q3: reference gives val the train augs)")
    parser.add_argument("--train_aug", choices=["train", "none", "reduced_hue"], default="train",
                        help="'none' disables the random train augmentations; 'reduced_hue' keeps "
                             "them all but caps the hue jitter at +-0.05 (the reference's 0.5 is a "
                             "full hue rotation)")
    parser.add_argument("--train_trunk", action="store_true",
                        help="unfreeze the VGG trunk (reference parity freezes it — "
                             "src/model/ssd.py:31-32)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log_dir", type=str, default="./logs")
    parser.add_argument("--orbax_dir", type=str, default=None,
                        help="full-state checkpoints (exact resume), in the port's own format")
    parser.add_argument("--orbax_interval", type=int, default=1,
                        help="write the full state every N epochs (and always on the last)")
    parser.add_argument("--steps_per_epoch", type=int, default=None,
                        help="cap steps (with --steps_per_dispatch K the cap is reached in "
                             "K-step granularity)")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="run K optimizer steps per call (Trainer.train_steps); the same steps, "
                             "draws and losses as K single steps")
    parser.add_argument("--save_interval", type=int, default=1,
                        help="write checkpoints at most every N epochs (and always on the last); "
                             "improvement is tracked every epoch")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-process data-parallel training: join the process group of torchrun's "
                             "environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each "
                             "process loads its slice of every global batch")
    parser.add_argument("--device_cache", action="store_true",
                        help="hold the packed records (train and validation) on the device and gather "
                             "each batch there (data/device_cache.py); needs --records_dir, one process")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the first epoch (trace.json)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="torch anomaly detection, and raise on a non-finite loss (slow)")
    parser.add_argument("--trunk_int8", action="store_true",
                        help="run the frozen VGG trunk's blocks 2-5 as int8 convolutions (models/quant.py; the "
                             "int8 kernel on the card). Activation scales come from "
                             "<result_dir>/<purpose>/quant.json, calibrated over the first --calib_batches "
                             "augmented batches when absent or stale. Detection purpose only; incompatible "
                             "with --train_trunk")
    parser.add_argument("--calib_batches", type=int, default=8,
                        help="batches for int8 activation abs-max calibration")
    parser.add_argument("--calib_margin", type=float, default=1.25,
                        help="headroom factor on calibrated abs-maxes (every quantized input follows "
                             "batch-statistics BN; the margin covers residual drift)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    args = parser.parse_args(argv)
    args.lr_explicit = args.lr is not None
    if args.lr is None:
        args.lr = 0.001  # reference default (train.py:20)
    return args


def resolve_resume(params: dict | None, base_lr: float, will_orbax_resume: bool,
                   lr_explicit: bool = False):
    """(min_loss, schedule_base_lr, start_epoch) for the resume surface
    (copy of object_detection_torch2_tpu/cli/train.py:125-154).

    Reference semantics (train.py:85-95, quirk Q7): params.json re-seeds a
    FRESH optimizer from the saved (already-decayed) lr, so decay restarts
    from there. With an exact full-state resume the restored optimizer step
    count already carries the decay, so the schedule must be seeded from the
    ORIGINAL base lr — params.json's `base_lr` when present; an EXPLICITLY
    passed --lr takes precedence over it, and args.lr is the fallback for
    files written before the field existed."""
    if params is None:
        return None, base_lr, 0
    if will_orbax_resume:
        if lr_explicit and params.get("base_lr") not in (None, base_lr):
            print(f"note: --lr {base_lr} overrides the checkpoint's recorded "
                  f"base_lr {params['base_lr']} (explicit flag wins on resume)")
            lr = base_lr
        else:
            lr = params.get("base_lr", base_lr)
            if "base_lr" not in params and params["lr"] != base_lr:
                print(f"warning: orbax resume without a recorded base_lr — seeding the "
                      f"schedule from --lr {base_lr} (params.json holds decayed lr {params['lr']})")
    else:
        lr = params["lr"]
    return params["min_loss"], lr, params["last_epoch"]


def _aug_config(train_aug: str):
    """--train_aug -> Trainer augment argument: True = reference-parity
    distributions; dict = overrides forwarded to data.augment.augment_batch;
    False = ToTensor only."""
    return {"train": True, "none": False, "reduced_hue": {"hue": 0.05}}[train_aug]


def _quant_scales(args, model, ds_train, device, mesh=None) -> dict:
    """Int8 trunk activation scales: <result_dir>/<purpose>/quant.json when it
    is there and complete, else abs-max calibration of `model` on `device`
    over the first --calib_batches batches read by index from `ds_train` (on
    the host, no DataLoader thread), written there for the serving CLIs. A
    stale file (a layer without a positive amax) is recalibrated in place.

    The calibration batches get the train step's augment (--train_aug, in the
    model's dtype), its draws from a generator seeded with seed ^ 0xCA11B,
    so the abs-maxes cover the distribution the int8 path quantizes; GT
    boxes are zeros (they only ride through the flip).

    Under a mesh of several ranks rank 0 does that (one process's
    calibration, on the global batches) while the others wait at a barrier,
    then every rank reads the file, so all hold the same scales."""
    if mesh is not None and mesh.world > 1:
        if mesh.rank == 0:
            _quant_scales(args, model, ds_train, device)
        barrier(mesh)
        return json.loads((Path(args.result_dir) / args.purpose / "quant.json").read_text())
    from object_detection_torch2_tpu_torch.data.augment import augment_batch
    from object_detection_torch2_tpu_torch.models import quant as quant_lib

    quant_path = Path(args.result_dir) / args.purpose / "quant.json"
    if quant_path.exists():
        scales = json.loads(quant_path.read_text())
        stale = quant_lib.missing_layers(scales)
        if not stale:
            print("quant scales loaded.")
            return scales
        print(f"quant.json is stale (no amax for {stale}) — recalibrating")

    aug_cfg = _aug_config(args.train_aug)
    if aug_cfg is not False:
        aug_cfg = dict(aug_cfg if isinstance(aug_cfg, dict) else {})
        aug_cfg.setdefault("dtype", model.dtype)
    generator = torch.Generator().manual_seed(args.seed ^ 0xCA11B)

    def batches():
        for images in common.calib_image_batches(ds_train, args.calib_batches, args.batch_size):
            if aug_cfg is False:
                yield images
                continue
            images = torch.from_numpy(images).to(device)
            gts = torch.zeros((images.shape[0], 1, 25), dtype=torch.float32, device=device)
            yield augment_batch(generator, images, gts, **aug_cfg)[0]

    scales = quant_lib.calibrate_trunk(model.to(device), batches(), margin=args.calib_margin)
    quant_path.parent.mkdir(parents=True, exist_ok=True)
    quant_lib.save_quant(quant_path, scales)
    kind = "augmented " if aug_cfg is not False else ""
    print(f"quant scales calibrated ({args.calib_batches} {kind}batches, "
          f"margin {args.calib_margin}) -> {quant_path}")
    return scales


def _build_datasets(args):
    if args.records_dir:
        ds_train = RecordDataset(args.records_dir)
        ds_val = RecordDataset(args.val_records_dir) if args.val_records_dir else None
        for ds in (ds_train, ds_val):
            purpose = ds.meta.get("purpose", "detection") if ds is not None else args.purpose
            if purpose != args.purpose:
                raise SystemExit(f"--purpose {args.purpose}, but the records were packed for {purpose}")
    else:
        train_dirs = args.data_dirs or common.DEFAULT_TRAIN_DIRS
        val_dirs = (args.data_dirs or common.DEFAULT_TEST_DIRS)[:1]
        ds_train = PascalVOCDataset(args.purpose, train_dirs, "trainval.txt", args.imsize)
        ds_val = PascalVOCDataset(args.purpose, val_dirs, "test.txt", args.imsize)
    return ds_train, ds_val


def _check_flags(args):
    if args.device_cache and (args.distributed or not args.records_dir):
        raise SystemExit("--device_cache requires --records_dir and is single-process "
                         "(incompatible with --distributed)")
    if args.trunk_int8 and args.train_trunk:
        raise SystemExit("--trunk_int8 requires a frozen trunk (drop --train_trunk)")
    if args.trunk_int8 and args.purpose != "detection":
        raise SystemExit("--trunk_int8 is for the detection purpose")


def main(argv=None) -> dict:
    """Train; returns {"state": the TrainState, "losses": [(steps,) tensor
    of each epoch's step losses], "val_losses": [each epoch's validation
    loss], "phase_times": the rows of phase_times.json} (a launched run:
    rank 0's, without "state")."""
    args = parse_args(argv)
    _check_flags(args)
    return common.run_data_parallel(args, _main, common.train_world, drop=("state",))


def _main(args, mesh) -> dict:
    """The training on one process: the whole run (`mesh` None) or this
    rank's part of it."""
    device = mesh.device if mesh is not None else resolve_device(args.device)
    if args.debug_nans:
        enable_debug_nans()
    ds_train, ds_val = _build_datasets(args)
    cache = {"device_cache": args.device_cache, "device": device}
    dl_train = DataLoader(ds_train, args.batch_size, shuffle=True, seed=args.seed, max_gt=args.max_gt, mesh=mesh,
                          num_workers=args.num_workers, stack_steps=args.steps_per_dispatch, **cache)
    dl_val = (DataLoader(ds_val, args.batch_size, max_gt=args.max_gt, mesh=mesh, num_workers=args.num_workers,
                         **cache) if ds_val else None)
    # an exact resume on the card needs deterministic convolutions: in
    # bfloat16 cuDNN's deterministic algorithms; a float32 step runs off cuDNN
    # (the policy of `true_float32`), where the flag changes nothing
    deterministic = torch.backends.cudnn.deterministic
    if args.orbax_dir:
        torch.backends.cudnn.deterministic = True
    try:
        return _train(args, device, dl_train, dl_val, mesh)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dl_train.close()
        if dl_val is not None:
            dl_val.close()


def _build_trainer(args, device, weights_path: Path, ds_train, mesh=None):
    """(Trainer, is_trainable) of the purpose: the SSD with a frozen trunk
    (or all of it with --train_trunk; blocks 2-5 int8 with --trunk_int8), or
    the VGG16 with its dead head frozen."""
    if args.purpose == "detection":
        model, _ = common.build_ssd(args, weights_path, conv12_kernel=True)
        quant = None
        if args.trunk_int8:
            quant = _quant_scales(args, model, ds_train, device, mesh)
            model.trunk_int8 = True
        trainer = Trainer(model, default_boxes=default_boxes(feature_grids_for(args.imsize)),
                          use_batch_stats=args.bn_mode == "batch", augment=_aug_config(args.train_aug),
                          seed=args.seed, quant=quant, device=device, mesh=mesh)
        # reference parity: the VGG trunk is frozen (src/model/ssd.py:31-32,
        # 160-179); --train_trunk unfreezes it
        return trainer, (lambda name: True) if args.train_trunk else None
    # transfer_learning=True selects the 20-way classifier2 head: the
    # intended behaviour of the reference's classification purpose, which
    # never ran as written (quirk Q12, JAX cli/train.py:302-313)
    model = VGG16(num_classes=20, transfer_learning=True, dtype=common.DTYPES[args.dtype])
    if weights_path.exists():
        print("weights loaded.")
        model.load_state_dict(vgg16_state_dict_from_jax_variables(ckpt.load_weights(weights_path)))
    trainer = Trainer(model, loss_kind="cross_entropy", use_batch_stats=args.bn_mode == "batch",
                      augment=_aug_config(args.train_aug), seed=args.seed, device=device, mesh=mesh)
    return trainer, vgg_trainable_predicate(transfer_learning=True)


class _NoWriter:
    """The event writer of a rank that writes no artifacts."""

    def add_scalar(self, *args):
        pass

    def close(self):
        pass


def _train(args, device, dl_train, dl_val, mesh=None) -> dict:
    weights_path = Path(args.result_dir) / args.purpose / args.weights
    params_path = Path(args.result_dir) / args.purpose / args.params
    # rank 0 alone writes the artifacts and prints; the others wait at barriers
    writes = mesh is None or mesh.rank == 0
    say = print if writes else (lambda *a, **k: None)
    trainer, is_trainable = _build_trainer(args, device, weights_path, dl_train.dataset, mesh)

    # resume surface (reference: train.py:85-95; quirk Q7: fresh optimizer state)
    params = ckpt.load_params_json(params_path)
    will_orbax_resume = bool(args.orbax_dir) and ckpt.latest_orbax_step(args.orbax_dir) is not None
    if params is not None:
        say("Params loaded.")
    min_loss, lr, start_epoch = resolve_resume(params, args.lr, will_orbax_resume, args.lr_explicit)

    steps_per_epoch = args.steps_per_epoch or len(dl_train)
    if steps_per_epoch == 0:
        raise SystemExit(
            f"dataset ({len(dl_train.dataset)} samples) is smaller than batch_size "
            f"{args.batch_size}: no full batch to train on (batches are "
            f"static-shaped with drop_last) — lower --batch_size"
        )
    schedule = exponential_epoch_schedule(lr, args.gamma, steps_per_epoch)
    state = trainer.init_state(lambda ps: adam_torch(ps, schedule, weight_decay=args.weight_decay),
                               is_trainable=is_trainable)
    if args.orbax_dir and ckpt.restore_train_state(args.orbax_dir, state) is not None:
        say("Full state restored (exact optimizer resume).")
        # params.json (written only on improved epochs) can lag the full
        # state, which saves every --orbax_interval: the restored step count
        # numbers the epochs, with the original run's steps_per_epoch
        spe_prev = (params or {}).get("steps_per_epoch", steps_per_epoch)
        if spe_prev != steps_per_epoch:
            say(f"warning: steps_per_epoch changed across resume "
                f"({spe_prev} -> {steps_per_epoch}): epoch numbering uses the "
                f"recorded value; the lr schedule decays at the NEW cadence")
        start_epoch = state.step // spe_prev

    # anchor the shuffle to the ABSOLUTE epoch: a resumed run draws the
    # per-epoch orders an uninterrupted run would have
    dl_train.epoch = start_epoch

    writer = SummaryWriter(log_dir=args.log_dir) if writes else _NoWriter()
    val_rng = torch.Generator().manual_seed(args.seed + 1)
    val_loss = 0.0
    improved_since_save = False
    meter = ThroughputMeter(args.batch_size, 1)
    phase_rows, epoch_losses, val_losses_by_epoch = [], [], []
    last = args.epochs + start_epoch
    for epoch in range(1 + start_epoch, last + 1):
        losses = []
        t_epoch0 = time.perf_counter()
        meter.reset()
        # the lr in effect this epoch, from the optimizer's real step count
        epoch_lr = float(schedule(state.step))
        multi = args.steps_per_dispatch > 1
        with maybe_trace(args.profile_dir if epoch == 1 + start_epoch and writes else None):
            for images, gts in dl_train:
                if multi and images.shape[0] == args.steps_per_dispatch:
                    loss = trainer.train_steps(state, images, gts)
                elif multi:  # epoch tail: fewer than K batches left
                    loss = torch.stack([trainer.train_step(state, images[i], gts[i])
                                        for i in range(images.shape[0])])
                else:
                    loss = trainer.train_step(state, images, gts)[None]
                k = int(loss.shape[0])
                if args.debug_nans and not bool(torch.isfinite(loss).all()):
                    raise FloatingPointError(f"non-finite training loss at step {state.step}: {loss.tolist()}")
                losses.append(loss)
                meter.step(k)
                if len(losses) > 1 and meter.steps // PROGRESS_EVERY != (meter.steps - k) // PROGRESS_EVERY:
                    # one dispatch behind: reading it waits for the previous
                    # call, not for the one just queued
                    shown = torch.cat(losses[:-1])
                    say(f"[{epoch}, {meter.steps}] loss: {float(shown.mean()):.4f}", flush=True)
                if args.steps_per_epoch and meter.steps >= args.steps_per_epoch:
                    break
        step_losses = torch.cat(losses) if losses else torch.zeros(0)
        running_loss = float(step_losses.mean()) if losses else 0.0
        images_per_sec = meter.images_per_sec()
        t_train = time.perf_counter()  # the running_loss read above waited for the card

        if dl_val is not None and ((epoch - start_epoch) % args.val_interval == 0 or epoch == last):
            # Q3 parity: the reference gives the val set the TRAIN augs
            batch_losses = [trainer.eval_step(state, images, gts, rng=val_rng, augment=args.val_aug == "train")
                            for images, gts in dl_val]
            val_loss = float(torch.stack(batch_losses).mean()) if batch_losses else 0.0
        t_val = time.perf_counter()

        say(f"[Epoch {epoch}/{last}] loss: {round(running_loss, 5)}, "
            f"val_loss: {round(val_loss, 5)}, {images_per_sec:.1f} img/s")
        writer.add_scalar("loss/train", running_loss, epoch)
        writer.add_scalar("loss/validation", val_loss, epoch)
        writer.add_scalar("lr", epoch_lr, epoch)

        # min_loss is tracked EVERY epoch; with --save_interval N > 1 a best
        # epoch between checks still triggers a save at the next check
        if (min_loss is None) or (running_loss < min_loss):
            min_loss = running_loss
            improved_since_save = True
        if ((epoch - start_epoch) % args.save_interval == 0 or epoch == last) and improved_since_save:
            improved_since_save = False
            if writes:
                ckpt.save_weights(weights_path, state.model)
                # base_lr = this run's schedule base, so a full-state resume
                # can rebuild the schedule without --lr; steps_per_epoch
                # anchors epoch numbering across resumes
                ckpt.save_params_json(params_path, min_loss, epoch_lr, epoch, base_lr=lr,
                                      steps_per_epoch=steps_per_epoch)
        if (args.orbax_dir and ((epoch - start_epoch) % args.orbax_interval == 0 or epoch == last)
                and writes):
            ckpt.save_train_state(args.orbax_dir, state)
        barrier(mesh)
        t_end = time.perf_counter()
        row = {"epoch": epoch, "train_s": round(t_train - t_epoch0, 2),
               "val_s": round(t_val - t_train, 2), "save_s": round(t_end - t_val, 2),
               "total_s": round(t_end - t_epoch0, 2),
               "img_per_s_train_loop": round(images_per_sec, 1),
               "img_per_s_wall": round(meter.batch_size * meter.steps / max(t_end - t_epoch0, 1e-9), 1)}
        phase_rows.append(row)
        epoch_losses.append(step_losses)
        val_losses_by_epoch.append(val_loss)
        say(f"  phases: train {row['train_s']}s, val {row['val_s']}s, "
            f"save {row['save_s']}s -> {row['img_per_s_wall']} img/s wall")

    say("Finished Training")
    if phase_rows and writes:
        Path(args.log_dir).mkdir(parents=True, exist_ok=True)
        (Path(args.log_dir) / "phase_times.json").write_text(json.dumps(phase_rows, indent=1))
    writer.close()
    return {"state": state, "losses": epoch_losses, "val_losses": val_losses_by_epoch, "phase_times": phase_rows}


if __name__ == "__main__":
    main()

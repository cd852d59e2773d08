"""Weights files, params.json and the full-state resume
(counterpart of object_detection_torch2_tpu/train/checkpoint.py).

- `weights.msgpack`: the JAX package's {"params", "batch_stats"} tree in
  flax's msgpack layout (train/_msgpack.py), so that a checkpoint written by
  either package loads in the other. `save_weights` writes an `SSD`'s or a
  `VGG16`'s state_dict through `models.convert.jax_variables_of`;
  `load_weights` returns the tree with numpy leaves, which
  `models.convert.ssd_state_dict_from_jax_variables` (or
  `vgg16_state_dict_from_jax_variables`) turns into a state_dict.
- `params.json`: the reference's {min_loss, lr, last_epoch} record
  (reference: src/train.py:150-152), with the JAX package's optional
  `base_lr` and `steps_per_epoch`.

Both files are written to a temporary file beside the target and renamed
over it (`os.replace`), so a process killed during a save leaves the
previous file whole: a resumed run reads the weights file before it
restores the full state. The bytes are those of the JAX package's writers.

- the full state (the JAX package's orbax layer, names kept):
  `save_train_state` writes `<dir>/<step>/state.pt` with the model's
  state_dict (parameters and BatchNorm buffers), the optimizer's state_dict
  (Adam's moments and its own `step`, from which `ScheduledAdam` reads the
  schedule, so a restore continues the ExponentialLR decay: the Q7 fix) and
  the step; `restore_train_state` loads the latest into a TrainState;
  `latest_orbax_step` finds it. The format is the port's own: orbax's
  on-disk layout cannot be read without orbax, and a directory that holds
  it raises instead of being ignored.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import torch

from object_detection_torch2_tpu_torch.models.convert import jax_variables_of
from object_detection_torch2_tpu_torch.train import _msgpack


def save_weights(path, model):
    """Write `model`'s (an `SSD` or a `VGG16`) weights as the JAX package's
    weights.msgpack; `model` may also be such a {"params", "batch_stats"}
    tree itself (numpy or tensor leaves), as the JAX package's
    `save_weights` takes it."""
    _write_replacing(path, _msgpack.packb(model if isinstance(model, dict) else jax_variables_of(model)))


def _write_replacing(path, data: bytes):
    """Write `data` as `path` through `<path>.tmp` renamed over it: the old
    file stays whole until the new one is complete."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_weights(path) -> dict:
    """A weights.msgpack written by either package -> its tree of numpy leaves."""
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def save_params_json(path, min_loss: float, lr: float, last_epoch: int, base_lr: float | None = None,
                     steps_per_epoch: int | None = None):
    """Reference params.json semantics (reference: train.py:150-152).

    `base_lr` (the undecayed schedule base; the reference's `lr` field is the
    already-decayed value, quirk Q7) and `steps_per_epoch` are the JAX
    package's extensions; extra keys do not disturb parity readers."""
    record = {"min_loss": float(min_loss), "lr": float(lr), "last_epoch": int(last_epoch)}
    if base_lr is not None:
        record["base_lr"] = float(base_lr)
    if steps_per_epoch is not None:
        record["steps_per_epoch"] = int(steps_per_epoch)
    _write_replacing(path, json.dumps(record, indent=4).encode())


def load_params_json(path) -> dict | None:
    path = Path(path)
    if not path.exists():
        return None
    with open(path, "r") as f:
        return json.load(f)


# ------------------------------------------------------------- full-state layer
STATE_FILE = "state.pt"


def _step_dirs(ckpt_dir: Path) -> dict:
    """{step: directory} of the full states in `ckpt_dir`. A step directory
    without the port's state file raises: it is the JAX package's orbax
    layout, or not a checkpoint at all."""
    steps = {}
    for sub in ckpt_dir.iterdir():
        if not (sub.is_dir() and sub.name.isdigit()):
            continue
        if not (sub / STATE_FILE).exists():
            orbax = (sub / "_CHECKPOINT_METADATA").exists() or (sub / "default").is_dir()
            what = "the JAX package's orbax layout, which the port cannot read" if orbax else "no " + STATE_FILE
            raise ValueError(f"{sub} holds {what}: point --orbax_dir at a directory written by the port")
        steps[int(sub.name)] = sub
    return steps


def latest_orbax_step(ckpt_dir) -> int | None:
    """The latest full-state step in `ckpt_dir`, or None if it is empty or
    absent; lets the CLI know before it builds the schedule whether an exact
    resume will happen."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = _step_dirs(ckpt_dir)
    return max(steps) if steps else None


def save_train_state(ckpt_dir, state, step: int | None = None):
    """Write `state` (a TrainState) as `<ckpt_dir>/<step>/state.pt`, through
    a temporary directory renamed into place."""
    ckpt_dir = Path(ckpt_dir)
    step = int(state.step) if step is None else int(step)
    final, tmp = ckpt_dir / str(step), ckpt_dir / f".{step}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(), "step": step},
               tmp / STATE_FILE)
    shutil.rmtree(final, ignore_errors=True)
    tmp.rename(final)


def restore_train_state(ckpt_dir, state):
    """Load the latest full state of `ckpt_dir` into `state` (a TrainState
    built like the one saved: same model, same trainable partition) in
    place, and return it; None if there is none."""
    step = latest_orbax_step(ckpt_dir)
    if step is None:
        return None
    payload = torch.load(Path(ckpt_dir) / str(step) / STATE_FILE, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state

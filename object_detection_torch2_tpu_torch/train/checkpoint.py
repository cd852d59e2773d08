"""Weights files and params.json
(counterpart of object_detection_torch2_tpu/train/checkpoint.py:26-66).

- `weights.msgpack`: the JAX package's {"params", "batch_stats"} tree in
  flax's msgpack layout (train/_msgpack.py), so that a checkpoint written by
  either package loads in the other. `save_weights` writes an `SSD`'s
  state_dict through `models.convert.jax_variables_from_state_dict`;
  `load_weights` returns the tree with numpy leaves, which
  `models.convert.ssd_state_dict_from_jax_variables` turns into a state_dict.
- `params.json`: the reference's {min_loss, lr, last_epoch} record
  (reference: src/train.py:150-152), with the JAX package's optional
  `base_lr` and `steps_per_epoch`.

The full-state resume layer (the JAX package's orbax checkpoints) goes with
the training CLI's slice.
"""

from __future__ import annotations

import json
from pathlib import Path

from object_detection_torch2_tpu_torch.models.convert import jax_variables_from_state_dict
from object_detection_torch2_tpu_torch.train import _msgpack


def save_weights(path, model):
    """Write `model`'s (an `SSD`) weights as the JAX package's weights.msgpack."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    data = _msgpack.packb(jax_variables_from_state_dict(model.state_dict(), model.num_classes))
    with open(path, "wb") as f:
        f.write(data)


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
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = {"min_loss": float(min_loss), "lr": float(lr), "last_epoch": int(last_epoch)}
    if base_lr is not None:
        record["base_lr"] = float(base_lr)
    if steps_per_epoch is not None:
        record["steps_per_epoch"] = int(steps_per_epoch)
    with open(path, "w") as f:
        json.dump(record, f, indent=4)


def load_params_json(path) -> dict | None:
    path = Path(path)
    if not path.exists():
        return None
    with open(path, "r") as f:
        return json.load(f)

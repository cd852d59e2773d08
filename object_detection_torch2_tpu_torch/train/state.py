"""Train state: the model, its trainable/frozen parameter partition, the
optimizer and the step count (counterpart of object_detection_torch2_tpu/train/state.py).

The reference freezes the VGG trunk doubly — requires_grad=False (reference:
src/model/ssd.py:31-32) and exclusion from `train_params()` (ssd.py:160-179).
Here frozen parameters have requires_grad=False and the optimizer holds state
for the trainable ones only. BatchNorm running statistics are buffers, not
parameters, and keep updating for the frozen trunk in training mode, as in
the JAX package and in torch.

Unlike the JAX package's immutable `TrainState`, this one is updated in place:
the model's parameters and the optimizer's moments are changed where they lie.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn


def partition_params(model: nn.Module, is_trainable: Callable[[str], bool]):
    """{name: parameter} of the trainable and of the frozen parameters, in
    module order."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        (trainable if is_trainable(name) else frozen)[name] = p
    return trainable, frozen


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    trainable: dict
    frozen: dict
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, make_optimizer: Callable, is_trainable=None) -> "TrainState":
        """Partition `model`'s parameters by `is_trainable(name)` (default: the
        model class's `is_trainable`, else everything trains), freeze the
        rest, and build `make_optimizer(trainable parameters)`."""
        if is_trainable is None:
            is_trainable = getattr(type(model), "is_trainable", lambda name: True)
        trainable, frozen = partition_params(model, is_trainable)
        for p in trainable.values():
            p.requires_grad_(True)
        for p in frozen.values():
            p.requires_grad_(False)
        return cls(model=model, optimizer=make_optimizer(list(trainable.values())), trainable=trainable,
                   frozen=frozen)

    @property
    def batch_stats(self) -> dict:
        """{name: buffer} of the BatchNorm running statistics."""
        return {name: b for name, b in self.model.named_buffers()
                if name.endswith("running_mean") or name.endswith("running_var")}

    def apply_gradients(self, grads) -> None:
        """One optimizer step with `grads`, one tensor for each trainable
        parameter in order (zeros where a parameter got no gradient: torch's
        Adam skips a parameter whose grad is None, and the JAX package decays
        every trainable leaf)."""
        params = list(self.trainable.values())
        if len(grads) != len(params) or any(g is None for g in grads):
            raise ValueError("apply_gradients needs one gradient tensor for every trainable parameter")
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

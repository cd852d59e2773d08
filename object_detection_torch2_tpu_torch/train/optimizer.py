"""Adam with the reference's torch semantics and its per-epoch ExponentialLR
(counterpart of object_detection_torch2_tpu/train/optimizer.py).

The reference runs `optim.Adam(net.train_params(), lr, weight_decay)` and steps
`ExponentialLR(gamma)` once per epoch (reference: src/train.py:97-98, 154).
torch's own Adam is the semantics the JAX package emulates with optax: L2 weight
decay folded into the gradient before the moments, eps added after the sqrt.
Here it is that Adam itself, with the learning rate of each step taken from a
step schedule.
"""

from __future__ import annotations

from typing import Callable

import torch


def exponential_epoch_schedule(base_lr: float, gamma: float, steps_per_epoch: int):
    """lr = base_lr * gamma^epoch, stepped per epoch like torch ExponentialLR
    under the reference's per-epoch `scheduler.step()` (reference: train.py:154)."""

    def schedule(step):
        return base_lr * gamma ** (step // steps_per_epoch)

    return schedule


class ScheduledAdam(torch.optim.Adam):
    """torch.optim.Adam whose every step first sets the learning rate to
    `lr_schedule(steps taken so far)`. The count is Adam's own per-parameter
    `step` state, so a state_dict carried in from another run (see
    models/convert.py `adam_state_dict_from_optax`) resumes the schedule too."""

    def __init__(self, params, lr_schedule: Callable[[int], float], weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr_schedule = lr_schedule
        super().__init__(params, lr=float(lr_schedule(0)), betas=(b1, b2), eps=eps, weight_decay=weight_decay)

    def steps_taken(self) -> int:
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p)
                if state and "step" in state:
                    return int(state["step"])
        return 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.lr_schedule(self.steps_taken()))
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def adam_torch(params, lr_schedule, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> torch.optim.Adam:
    """torch.optim.Adam over `params` with the learning rate of each step from
    `lr_schedule` (a step -> lr function, or a constant)."""
    schedule = lr_schedule if callable(lr_schedule) else (lambda step, lr=float(lr_schedule): lr)
    return ScheduledAdam(params, schedule, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)

"""Train and eval steps of the SSD detector with the MultiBox loss
(counterpart of object_detection_torch2_tpu/train/trainer.py, `loss_kind="multibox"`).

A train step: uint8 or float images -> the augment chain (`augment`, on
uint8 batches) or x(1/255) -> SSD forward (the frozen trunk keeps no autograd
graph; BatchNorm updates its running statistics) -> MultiBox loss ->
gradients of the trainable parameters only -> Adam step. PyTorch runs
eagerly, so there is no compiled program per step: `train_steps` is a Python
loop over K single steps and computes the same sequence.

The augment draws of step s come from a CPU generator seeded by a fixed
function of (seed ^ 0x5EED, s) (`step_generator`), the counterpart of the
JAX package's `fold_in(base_key, state.step)`: a step is a pure function of
the state and the batch, so K steps of `train_steps` equal K calls of
`train_step`, and a resumed run draws what an uninterrupted run would. No
step waits on the device: the batch and the draws reach it by copies that do
not block, and the op order is a host int.

Validation parity: the reference's validation pass runs under `torch.no_grad()`
but never calls `net.eval()` (reference: src/train.py:127-139), so BatchNorm
uses batch statistics AND keeps updating its running statistics (quirk Q9).
`eval_step` does exactly that: the model stays in training mode.

float32 convolutions run in true float32 in the forward and the backward
(`true_float32`), as the JAX package's `precision=HIGHEST` does.

Not ported yet (they raise NotImplementedError; ROADMAP.md Queue 1): the
classification loss (`cross_entropy`, item E), the int8 trunk (`quant`,
item F) and data parallelism (`mesh`, item G).
"""

from __future__ import annotations

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device, true_float32
from object_detection_torch2_tpu_torch.core.multibox import multibox_loss
from object_detection_torch2_tpu_torch.data.augment import augment_batch, to_tensor_batch
from object_detection_torch2_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step `step`'s augment draws, seeded by a
    fixed function of (seed ^ 0x5EED, step)."""
    words = [(seed ^ 0x5EED) & 0xFFFFFFFFFFFFFFFF, int(step)]
    return torch.Generator().manual_seed(int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]))


class Trainer:
    """Train and eval steps for one SSD and its anchor table.

    device=None means the CUDA card, and raises without one; pass
    device="cpu" to run on the CPU. The model is moved to `device` in place.
    A TrainState from `init_state` is updated in place by every step.

    augment: True (the reference's distributions), a dict of overrides for
    `data.augment.augment_batch` (e.g. {"hue": 0.05}), or False (x(1/255)
    only). The chain runs on uint8 batches, in the model's compute dtype
    unless the dict gives `dtype`.
    """

    def __init__(self, model, loss_kind: str = "multibox", default_boxes=None, alpha: float = 1.0,
                 mesh=None, use_batch_stats: bool = True, augment=False, seed: int = 0, quant=None,
                 device=None):
        if loss_kind == "cross_entropy":
            raise NotImplementedError("the classification loss is not ported yet (ROADMAP.md Queue 1 item E)")
        if loss_kind != "multibox":
            raise ValueError(f"unknown loss_kind {loss_kind!r}")
        if mesh is not None:
            raise NotImplementedError("data parallelism is not ported yet (ROADMAP.md Queue 1 item G)")
        if quant is not None:
            raise NotImplementedError("the int8 trunk is not ported yet (ROADMAP.md Queue 1 item F)")
        if default_boxes is None:
            raise ValueError("multibox loss requires default_boxes")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.default_boxes = torch.tensor(np.asarray(default_boxes), dtype=torch.float32, device=self.device)
        self.alpha = alpha
        self.use_batch_stats = use_batch_stats
        self.augment_config = ({} if augment is True else dict(augment)) if augment else None
        self.seed = seed

    def init_state(self, make_optimizer, is_trainable=None, state_dict: dict | None = None) -> TrainState:
        """Load `state_dict` into the model if given, then partition its
        parameters (default: `SSD.is_trainable`) and build the optimizer over
        the trainable ones, e.g. `lambda ps: adam_torch(ps, schedule, wd)`."""
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        return TrainState.create(self.model, make_optimizer, is_trainable)

    def _inputs(self, images, targets, generator=None):
        """Host arrays or tensors -> images in [0, 1] and float32 targets on
        the device: a uint8 batch goes through the augment chain when there
        is one and a generator is given, else through x(1/255)."""
        images, targets = (torch.as_tensor(a).to(self.device, non_blocking=True) for a in (images, targets))
        targets = targets.to(torch.float32)
        if images.dtype != torch.uint8:
            return images, targets
        if self.augment_config is not None and generator is not None:
            cfg = dict(self.augment_config)
            cfg.setdefault("dtype", getattr(self.model, "dtype", torch.float32))
            return augment_batch(generator, images, targets, **cfg)
        return to_tensor_batch(images), targets

    def _loss(self, outputs, targets):
        return multibox_loss(outputs, targets, self.default_boxes, self.alpha)

    def train_step(self, state: TrainState, images, targets) -> torch.Tensor:
        """One step on images (N, H, W, 3) uint8 or float in [0, 1] and targets
        (N, G, 4 + C). Updates `state` in place; returns the loss (a 0-d
        tensor on the device, computed before the update)."""
        images, targets = self._inputs(images, targets, step_generator(self.seed, state.step))
        state.model.train()
        params = list(state.trainable.values())
        with true_float32():
            loss = self._loss(state.model(images, use_batch_stats=self.use_batch_stats), targets)
            # zeros, not None, for a parameter the loss does not reach
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        state.apply_gradients(grads)
        return loss.detach()

    def train_steps(self, state: TrainState, images_k, targets_k) -> torch.Tensor:
        """K steps over (K, N, ...) stacks; returns the (K,) losses. The same
        sequence as K calls of `train_step`."""
        return torch.stack([self.train_step(state, images_k[i], targets_k[i]) for i in range(len(images_k))])

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, targets, rng: torch.Generator | None = None,
                  augment: bool = False) -> torch.Tensor:
        """The loss under no_grad with BatchNorm in training mode: batch
        statistics, and the running statistics updated (quirk Q9). With
        `augment` and a generator `rng`, the batch takes the train augments
        (the reference's validation, quirk Q3)."""
        images, targets = self._inputs(images, targets, rng if augment else None)
        state.model.train()
        return self._loss(state.model(images, use_batch_stats=self.use_batch_stats), targets)

"""Train and eval steps of the SSD detector with the MultiBox loss and of the
VGG16 classifier with the cross-entropy
(counterpart of object_detection_torch2_tpu/train/trainer.py).

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
not block, and the op order is a host int. A batch already on the device
(`DataLoader(device_cache=True)`) is used as it is, without a copy.

`loss_kind="cross_entropy"` trains `models.vgg16.VGG16` (the classification
purpose): `cross_entropy` with `ce_parity_sign` (quirk Q2), dropout on in
train steps. Its masks come from `dropout_generator(seed, step, device)`, a
generator on the device seeded by a fixed function of (seed ^ 0xD40F, step),
as the JAX package splits its step key into the augment's and the
dropout's: K steps a call and a resumed run draw what single steps draw.
Validation runs the classifier with dropout off (train=False), as the JAX
package does (its trainer.py:163-172).

Validation parity: the reference's validation pass runs under `torch.no_grad()`
but never calls `net.eval()` (reference: src/train.py:127-139), so BatchNorm
uses batch statistics AND keeps updating its running statistics (quirk Q9).
`eval_step` does exactly that: the model stays in training mode.

float32 convolutions run in true float32 in the forward and the backward
(`true_float32`), as the JAX package's `precision=HIGHEST` does.

Int8 trunk (`quant=`, models/quant.py): an `SSD(trunk_int8=True)` needs its
calibrated scales {amax_<layer>: float}; they are checked
(`quant.check_calibrated`, the JAX package's messages) and copied to the
model's device once (`SSD.set_quant`), and the model quantizes activations
with the reciprocal of each scale, as XLA compiles the JAX Trainer's
closed-over constants (`SSD.quant_reciprocal`). `full_int8` is refused
(serving only: it would quantize the trainable extras and heads), and so is a
trainable quantized trunk layer (`init_state`). The trunk needs no gradient
through the int8 convs: its parameters are frozen and its activations carry
no autograd graph.

Data parallelism (`mesh=`, a parallel.mesh.Mesh): one process a device,
each holding its contiguous slice of every global batch; the step computes
what the JAX package's jitted step computes over the batch sharded across a
`Mesh(('data',))`:
- the augment draws of a step, and a classifier's dropout masks, are made
  for the GLOBAL batch (n_local x world rows) and each rank keeps its own
  rows. The JAX step draws at the global shape inside one program; drawing
  per rank would give each rank the first rows' draws, so 2 ranks x 16
  images would not take the step that 1 rank x 32 takes;
- BatchNorm's statistics are the global batch's (models/bn.py, with the
  mesh handed to every BatchNorm), forward and backward;
- the trainable gradients and the loss go through ONE all-reduce of one
  flattened buffer, then the mean: the MultiBox loss is a mean over images of
  per-image terms, and the cross-entropy a batch mean, so with equal slices
  the global loss is the mean of the ranks' losses and its gradient the mean
  of theirs. Every rank then takes the same Adam step: the parameters and
  running statistics stay bit-identical on every rank without a broadcast,
  and a step returns the global loss, as the JAX step does;
- ranks build the same seeded model (and the same int8 scales); the
  constructor checks that once with a fingerprint all-gather
  (`parallel.mesh.replicate`).
A mesh of one rank computes what `mesh=None` does, bit for bit. On NCCL the
step makes no host sync, as without a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device, true_float32
from object_detection_torch2_tpu_torch.core.multibox import multibox_loss
from object_detection_torch2_tpu_torch.data.augment import augment_batch, to_tensor_batch
from object_detection_torch2_tpu_torch.models.bn import set_mesh
from object_detection_torch2_tpu_torch.models.ssd import output_dtype
from object_detection_torch2_tpu_torch.models.vgg16 import cross_entropy
from object_detection_torch2_tpu_torch.parallel.mesh import all_reduce_mean_, replicate
from object_detection_torch2_tpu_torch.train.state import TrainState


def _step_seed(seed: int, salt: int, step: int) -> int:
    words = [(seed ^ salt) & 0xFFFFFFFFFFFFFFFF, int(step)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step `step`'s augment draws, seeded by a
    fixed function of (seed ^ 0x5EED, step)."""
    return torch.Generator().manual_seed(_step_seed(seed, 0x5EED, step))


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of train step `step`'s dropout masks, on `device`,
    seeded by a fixed function of (seed ^ 0xD40F, step)."""
    return torch.Generator(device=device).manual_seed(_step_seed(seed, 0xD40F, step))


def _trunk_layer(name: str) -> bool:
    """Whether parameter `name` (`features.conv_3_1.weight`) is of a trunk
    layer (blocks 1-5)."""
    part = name.split(".")[1] if "." in name else name
    for prefix in ("conv_", "bn_"):
        if part.startswith(prefix):
            return int(part[len(prefix):].split("_")[0]) <= 5
    return False


class Trainer:
    """Train and eval steps for one SSD and its anchor table.

    device=None means the CUDA card (the mesh's device under a mesh), and
    raises without one; pass device="cpu" to run on the CPU. The model is
    moved to `device` in place. mesh: a parallel.mesh.Mesh for data
    parallelism (see the module docstring); images and targets given to a
    step are then this rank's slice of the global batch.
    A TrainState from `init_state` is updated in place by every step.

    augment: True (the reference's distributions), a dict of overrides for
    `data.augment.augment_batch` (e.g. {"hue": 0.05}), or False (x(1/255)
    only). The chain runs on uint8 batches, in the model's compute dtype
    unless the dict gives `dtype`.
    """

    def __init__(self, model, loss_kind: str = "multibox", default_boxes=None, alpha: float = 1.0,
                 mesh=None, use_batch_stats: bool = True, augment=False, seed: int = 0, quant=None,
                 device=None, ce_parity_sign: bool = False):
        if loss_kind not in ("multibox", "cross_entropy"):
            raise ValueError(f"unknown loss_kind {loss_kind!r}")
        if loss_kind == "multibox" and default_boxes is None:
            raise ValueError("multibox loss requires default_boxes")
        if getattr(model, "full_int8", False):
            # full_int8 quantizes the extras and heads, the TRAINABLE
            # parameters; round and clip would cut their gradients
            raise ValueError("full_int8 is a serving-only path; train with trunk_int8")
        self.quant = None
        if getattr(model, "trunk_int8", False):
            from object_detection_torch2_tpu_torch.models.quant import check_calibrated

            self.quant = dict(check_calibrated(quant))
        if mesh is not None and device is not None:
            dev = resolve_device(device)
            if dev.type != mesh.device.type or dev.index not in (None, mesh.device.index):
                raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.model = set_mesh(model.to(self.device), mesh)
        if self.quant is not None:
            self.model.set_quant(self.quant)
            self.model.quant_reciprocal = True
        replicate(self.model, mesh)
        self.loss_kind = loss_kind
        self.ce_parity_sign = ce_parity_sign
        # the loss runs in the outputs' dtype: float32, float64 for a float64 reference model
        self.loss_dtype = output_dtype(getattr(model, "dtype", torch.float32))
        self.default_boxes = (None if default_boxes is None else
                              torch.tensor(np.asarray(default_boxes), dtype=self.loss_dtype, device=self.device))
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
        if is_trainable is None:
            is_trainable = getattr(type(self.model), "is_trainable", lambda name: True)
        if getattr(self.model, "trunk_int8", False):
            # the int8 trunk is inference-only math: a trainable trunk
            # parameter would get no gradient through round and clip
            quantized = sorted({name.split(".")[1] for name, _ in self.model.named_parameters()
                                if is_trainable(name) and _trunk_layer(name)})
            if quantized:
                raise ValueError(f"trunk_int8 requires a frozen trunk; trainable: {quantized}")
        return TrainState.create(self.model, make_optimizer, is_trainable)

    def _inputs(self, images, targets, generator=None):
        """Host arrays or tensors -> images in [0, 1] and targets in the
        loss's dtype (float32; float64 for a float64 reference model) on the
        device (a tensor already there is not copied): a uint8 batch goes
        through the augment chain when there is one and a generator is given,
        else through x(1/255)."""
        images, targets = (torch.as_tensor(a).to(self.device, non_blocking=True) for a in (images, targets))
        targets = targets.to(self.loss_dtype)
        if images.dtype != torch.uint8:
            return images, targets
        if self.augment_config is not None and generator is not None:
            cfg = dict(self.augment_config)
            cfg.setdefault("dtype", getattr(self.model, "dtype", torch.float32))
            if self.mesh is not None:  # the global batch's draws, this rank's rows
                n = images.shape[0]
                cfg.update(total=n * self.mesh.world, offset=n * self.mesh.rank)
            return augment_batch(generator, images, targets, **cfg)
        return to_tensor_batch(images), targets

    def _loss(self, outputs, targets):
        if self.loss_kind == "multibox":
            return multibox_loss(outputs, targets, self.default_boxes, self.alpha)
        return cross_entropy(outputs, targets, parity_sign=self.ce_parity_sign)

    def _forward(self, model, images, step=None):
        """The model's outputs; a classifier's dropout is on when `step` (the
        train step whose masks to draw) is given."""
        if self.loss_kind == "multibox":
            return model(images, use_batch_stats=self.use_batch_stats)
        if step is None:
            return model(images, train=False, use_batch_stats=self.use_batch_stats)
        return model(images, train=True, use_batch_stats=self.use_batch_stats,
                     generator=dropout_generator(self.seed, step, self.device))

    def train_step(self, state: TrainState, images, targets) -> torch.Tensor:
        """One step on images (N, H, W, 3) uint8 or float in [0, 1] and targets
        (N, G, 4 + C). Updates `state` in place; returns the loss (a 0-d
        tensor on the device, computed before the update; the global batch's
        under a mesh)."""
        images, targets = self._inputs(images, targets, step_generator(self.seed, state.step))
        state.model.train()
        params = list(state.trainable.values())
        with true_float32():
            loss = self._loss(self._forward(state.model, images, state.step), targets)
            # zeros, not None, for a parameter the loss does not reach
            grads = torch.autograd.grad(loss, params, materialize_grads=True)
        loss = loss.detach()
        if self.mesh is not None:
            loss = loss.clone()
            all_reduce_mean_([*grads, loss], self.mesh)
        state.apply_gradients(grads)
        return loss

    def train_steps(self, state: TrainState, images_k, targets_k) -> torch.Tensor:
        """K steps over (K, N, ...) stacks; returns the (K,) losses. The same
        sequence as K calls of `train_step`."""
        return torch.stack([self.train_step(state, images_k[i], targets_k[i]) for i in range(len(images_k))])

    @torch.no_grad()
    def eval_step(self, state: TrainState, images, targets, rng: torch.Generator | None = None,
                  augment: bool = False) -> torch.Tensor:
        """The loss under no_grad with BatchNorm in training mode: batch
        statistics, and the running statistics updated (quirk Q9); a
        classifier's dropout off. With `augment` and a generator `rng`, the
        batch takes the train augments (the reference's validation, quirk
        Q3). Under a mesh: the global batch's loss."""
        images, targets = self._inputs(images, targets, rng if augment else None)
        state.model.train()
        loss = self._loss(self._forward(state.model, images), targets)
        if self.mesh is not None:
            all_reduce_mean_([loss], self.mesh)
        return loss

"""The port's training path against the reference's executed 20-step run
(goldens/train_trajectory.npz: batch 4, imsize 300, Adam lr 1e-3, weight decay
5e-4, ExponentialLR gamma 0.7 every 5 steps), with the pins of
tests/test_trajectory.py, which holds the JAX package to the same golden.

The port runs `SSD(conv12_kernel=True)` (on the CPU: the plain conv_1_2) through
`Trainer` / `TrainState` / `adam_torch`, on the CPU, from the golden's
manifest-seeded weights and batches. Its fingerprints are taken in the JAX
layout (models/convert.py `jax_tree`), so the golden's keys apply as they are.

The replay holds the port against the golden alone, so its tests are marked
`slow` (`python -m pytest -m slow tests/test_torch_trajectory.py` runs them):
chip_smoke.py's `phase_trajectory` replays the same golden on the card and
asserts every one of their checks at the same pins. `test_lr_schedule` needs
no replay and stays in the default run.
"""

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.utils.testing import (
    fingerprint_tree,
    synth_scaled_state_dict_from_manifest,
    synth_trajectory_batch,
)
from object_detection_torch2_tpu_torch.core.anchors import default_boxes
from object_detection_torch2_tpu_torch.models.convert import jax_tree, ssd_state_dict_from_torch
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _nhwc(images_nchw):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(images_nchw, (0, 2, 3, 1))))


@pytest.fixture(scope="module")
def trajectory(goldens):
    """Replay the golden run; return (golden, losses, step-0 grads {name: tensor},
    state, trunk parameters and running statistics before the run)."""
    g = goldens("train_trajectory")
    steps, spe, bs = int(g["steps"]), int(g["steps_per_epoch"]), int(g["bs"])
    sd = ssd_state_dict_from_torch(synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"]))
    trainer = Trainer(SSD(num_classes=21, conv12_kernel=True), default_boxes=default_boxes(), device="cpu")
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), spe)
    state = trainer.init_state(lambda ps: adam_torch(ps, schedule, weight_decay=float(g["weight_decay"])),
                               state_dict=sd)
    before = {k: v.clone() for k, v in {**state.frozen, **state.batch_stats}.items()}

    # step-0 gradients through the same loss; eval mode keeps the batch
    # statistics from updating the running ones
    images0, targets0 = synth_trajectory_batch(0, n=bs)
    state.model.eval()
    loss0 = trainer._loss(state.model(_nhwc(images0), use_batch_stats=True), torch.from_numpy(targets0))
    grads0 = dict(zip(state.trainable, torch.autograd.grad(loss0, list(state.trainable.values()))))

    losses = []
    for step in range(steps):
        images, targets = synth_trajectory_batch(step, n=bs)
        losses.append(float(trainer.train_step(state, _nhwc(images), targets)))
    return g, np.array(losses), grads0, state, before


def _abs_delta(keys_g, fp_g, named):
    keys, fp = fingerprint_tree(jax_tree(named))
    assert list(keys) == list(keys_g), "tensor inventory mismatch"
    return keys, np.abs(fp - fp_g).max(axis=1), fp_g[:, 0]


@pytest.mark.slow
def test_loss_trajectory(trajectory):
    g, losses, *_ = trajectory
    ref = g["losses"]
    drift = np.abs(losses - ref) / np.maximum(np.abs(ref), 1e-9)
    assert drift.max() < 3e-3, f"loss trajectory drift {drift.max():.2e} at step {drift.argmax()}"
    assert drift[0] < 1e-4, f"step-0 loss drift {drift[0]:.2e}"


def test_lr_schedule(goldens):
    """The golden's learning rates at rtol 1e-12, and `adam_torch` taking its
    last step at the last epoch's rate. The replayed Trainer's step count is
    chip_smoke.py `phase_trajectory`'s to check."""
    g = goldens("train_trajectory")
    steps = int(g["steps"])
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), int(g["steps_per_epoch"]))
    np.testing.assert_allclose([schedule(s) for s in range(steps)], g["lrs"], rtol=1e-12)
    p = torch.nn.Parameter(torch.ones(3))
    optimizer = adam_torch([p], schedule, weight_decay=float(g["weight_decay"]))
    for _ in range(steps):
        p.grad = torch.ones(3)
        optimizer.step()
    assert optimizer.steps_taken() == steps
    assert optimizer.param_groups[0]["lr"] == pytest.approx(g["lrs"][-1], rel=1e-12)


@pytest.mark.slow
def test_step0_gradients(trajectory):
    """Relative to max(golden L2, 1e-4): BN-cancelled conv biases carry only
    float32 noise (tests/test_trajectory.py)."""
    g, _, grads0, _, _ = trajectory
    keys, absd, l2 = _abs_delta(g["grad_fp_keys"], g["grad_fp"], grads0)
    rel = absd / np.maximum(l2, 1e-4)
    assert rel.max() < 5e-3, f"grad fingerprint drift {rel.max():.2e} ({keys[rel.argmax()]})"


@pytest.mark.slow
def test_final_params(trajectory):
    """Per tensor |d fingerprint| <= 5e-3 * L2 + 1e-2."""
    g, _, _, state, _ = trajectory
    keys, absd, l2 = _abs_delta(g["param_fp_keys"], g["param_fp"], state.trainable)
    budget = 5e-3 * l2 + 1e-2
    worst = (absd / budget).argmax()
    assert (absd <= budget).all(), f"param drift {absd[worst]:.2e} > {budget[worst]:.2e} ({keys[worst]})"


@pytest.mark.slow
def test_final_batch_stats(trajectory):
    """The frozen trunk's running statistics within 1e-4, the rest within
    0.1 * L2 + 0.1."""
    g, _, _, state, _ = trajectory
    keys, absd, l2 = _abs_delta(g["bs_fp_keys"], g["bs_fp"], state.batch_stats)
    trunk = np.array([int(str(k).split("_")[1].split("/")[0]) <= 5 for k in keys])
    assert (absd[trunk] <= 1e-4).all(), "frozen-trunk BN momentum drift"
    budget = 0.1 * l2 + 0.1
    worst = (absd / budget).argmax()
    assert (absd <= budget).all(), f"batch-stats drift {absd[worst]:.2e} > {budget[worst]:.2e} ({keys[worst]})"


@pytest.mark.slow
def test_frozen_trunk_is_bit_unchanged(trajectory):
    """20 steps leave every frozen parameter bit for bit as it was, while
    every running statistic, trunk included, has moved."""
    _, _, _, state, before = trajectory
    assert len(state.frozen) == 52 and all(not p.requires_grad for p in state.frozen.values())
    for name, p in state.frozen.items():
        assert torch.equal(p, before[name]), name
    for name, b in state.batch_stats.items():
        assert not torch.equal(b, before[name]), name
    assert set(state.optimizer.state) == set(state.trainable.values())


@pytest.mark.slow
def test_eval_forward_after_training(trajectory):
    g, _, _, state, _ = trajectory
    images0, _ = synth_trajectory_batch(0, n=int(g["bs"]))
    with torch.no_grad():
        out = state.model.eval()(_nhwc(images0), use_batch_stats=False)
    d = np.abs(out[:, :128, :].numpy() - g["out_eval_after"])
    assert d.max() < 3e-2, f"eval-after maxabs {d.max():.2e}"
    assert d.mean() < 3e-3, f"eval-after mean {d.mean():.2e}"


# the JAX package's bfloat16 budget (tests/test_bf16_budget.py:28-30)
BF16_MAX_LOSS_DRIFT = 0.02
BF16_EVAL_FWD_MAXABS = 0.6
BF16_EVAL_FWD_MEAN = 0.1


@pytest.mark.slow
def test_bf16_trajectory_within_budget(goldens):
    """The same 20-step replay in bfloat16 (float32 parameters, bfloat16
    compute, conv_1_2 through `conv12_kernel=True`), held to the JAX
    package's budget against the float32 reference: max relative loss drift
    < 0.02, post-training eval forward (first 128 anchors) max |d| < 0.6 and
    mean < 0.1."""
    g = goldens("train_trajectory")
    steps, spe, bs = int(g["steps"]), int(g["steps_per_epoch"]), int(g["bs"])
    sd = ssd_state_dict_from_torch(synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"]))
    trainer = Trainer(SSD(num_classes=21, dtype=torch.bfloat16, conv12_kernel=True), default_boxes=default_boxes(),
                      device="cpu")
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), spe)
    state = trainer.init_state(lambda ps: adam_torch(ps, schedule, weight_decay=float(g["weight_decay"])),
                               state_dict=sd)
    losses = []
    for step in range(steps):
        images, targets = synth_trajectory_batch(step, n=bs)
        losses.append(float(trainer.train_step(state, _nhwc(images), targets)))
    ref = g["losses"]
    drift = np.abs(np.array(losses) - ref) / np.maximum(np.abs(ref), 1e-9)
    assert np.isfinite(losses).all()
    assert drift.max() < BF16_MAX_LOSS_DRIFT, f"bf16 loss drift {drift.max():.2e} at step {drift.argmax()}"
    images0, _ = synth_trajectory_batch(0, n=bs)
    with torch.no_grad():
        out = state.model.eval()(_nhwc(images0), use_batch_stats=False)
    d = np.abs(out[:, :128, :].numpy() - g["out_eval_after"])
    assert d.max() < BF16_EVAL_FWD_MAXABS, f"bf16 eval-after maxabs {d.max():.3f}"
    assert d.mean() < BF16_EVAL_FWD_MEAN, f"bf16 eval-after mean {d.mean():.4f}"

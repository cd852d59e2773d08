"""The port's classification training against the reference's executed
20-step VGG16 run (goldens/vgg_trajectory.npz: batch 4, imsize 200, Adam over
the trunk and the 20-way `classifier2` head, proper-sign cross-entropy,
dropout 0), with the pins of tests/test_trajectory.py, which holds the JAX
package to the same golden.

The port's `VGG16(transfer_learning=True, dropout_rate=0)` goes through
`Trainer(loss_kind="cross_entropy")` / `TrainState` / `adam_torch` on the
CPU, with `vgg_trainable_predicate(True)` (the dead 1000-way head frozen), from
the golden's manifest-seeded weights and batches. Fingerprints are taken in
the JAX layout (models/convert.py `jax_tree`), each seeded direction drawn
once for the gradients and the parameters that share its path. The step-0
gradients are those the first train step applies.

Marked slow: the replay is ~300 CPU-seconds of full-width VGG16 compute on
one thread. chip_smoke.py's `phase_cls_trajectory` replays the same golden
on the card in float32 and holds it to these pins; `pytest -m slow` runs it
here.
"""

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.utils.testing import (
    flatten_tree,
    synth_cls_trajectory_batch,
    synth_scaled_state_dict_from_manifest,
)
from object_detection_torch2_tpu_torch.models.convert import (
    jax_tree,
    vgg16_state_dict_from_jax_variables,
    vgg16_variables_from_torch,
)
from object_detection_torch2_tpu_torch.models.vgg16 import VGG16, vgg_trainable_predicate
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

pytestmark = pytest.mark.slow


def _fingerprints(*named_trees, k: int = 8):
    """The JAX package's `fingerprint_tree` (utils/testing.py) of each
    {port name: tensor} tree, the same arithmetic: each direction v_j of a
    path is drawn once for every tree holding the path (two at a time, each
    normalized in place)."""
    flats = [flatten_tree(jax_tree(named)) for named in named_trees]
    rows = [{} for _ in flats]
    with ThreadPoolExecutor(2) as pool:
        for path in sorted(set().union(*flats)):
            held = [(i, np.asarray(f[path], np.float64).ravel()) for i, f in enumerate(flats) if path in f]

            def project(j, path=path, held=held):
                v = np.random.default_rng(zlib.crc32(f"fp:{path}:{j}".encode()) & 0xFFFFFFFF).standard_normal(
                    held[0][1].size)
                v /= np.sqrt(np.dot(v, v))
                return [np.dot(a, v) for _, a in held]

            projections = list(pool.map(project, range(k)))
            for n, (i, a) in enumerate(held):
                rows[i][path] = [np.sqrt(np.dot(a, a)), a.mean(), np.abs(a).max()] + [p[n] for p in projections]
    return [(np.array(sorted(r)), np.array([r[path] for path in sorted(r)], np.float64)) for r in rows]


def _nhwc(images_nchw):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(images_nchw, (0, 2, 3, 1))))


@pytest.fixture(scope="module")
def cls_trajectory(goldens):
    """Replay the golden run; return (golden, losses, the fingerprints
    {"grads" (step 0), "params", "stats"}, state, the dead head before the
    run)."""
    g = goldens("vgg_trajectory")
    steps, spe, bs, imsize = int(g["steps"]), int(g["steps_per_epoch"]), int(g["bs"]), int(g["imsize"])
    sd = synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    model = VGG16(num_classes=20, transfer_learning=True, dropout_rate=0.0)
    trainer = Trainer(model, loss_kind="cross_entropy", device="cpu")
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), spe)
    state = trainer.init_state(lambda ps: adam_torch(ps, schedule, weight_decay=float(g["weight_decay"])),
                               is_trainable=vgg_trainable_predicate(True),
                               state_dict=vgg16_state_dict_from_jax_variables(vgg16_variables_from_torch(sd)))
    dead0 = {k: v.clone() for k, v in state.frozen.items()}

    grads0 = {}
    apply = state.apply_gradients

    def capture(grads):
        if not grads0:
            grads0.update(zip(state.trainable, (g.clone() for g in grads)))
        apply(grads)

    state.apply_gradients = capture
    losses = []
    for step in range(steps):
        images, targets = synth_cls_trajectory_batch(step, n=bs, imsize=imsize)
        losses.append(float(trainer.train_step(state, _nhwc(images), targets)))
    fps = _fingerprints(grads0, dict(state.model.named_parameters()), state.batch_stats)
    return g, np.array(losses), dict(zip(("grads", "params", "stats"), fps)), state, dead0


def _delta(keys_g, fp_g, fingerprint):
    keys, fp = fingerprint
    assert list(keys) == [str(k) for k in keys_g], "tensor inventory mismatch"
    return keys, np.abs(fp - fp_g).max(axis=1), fp_g[:, 0]


def test_cls_loss_trajectory(cls_trajectory):
    """Per-step relative loss drift < 1e-2, step 0 < 1e-4 (the JAX pins)."""
    g, losses, *_ = cls_trajectory
    ref = g["losses"]
    drift = np.abs(losses - ref) / np.maximum(np.abs(ref), 1e-9)
    assert drift.max() < 1e-2, f"cls loss trajectory drift {drift.max():.2e} at step {drift.argmax()}"
    assert drift[0] < 1e-4, f"step-0 cls loss drift {drift[0]:.2e}"


def test_cls_lr_schedule(cls_trajectory):
    g, _, _, state, _ = cls_trajectory
    schedule = exponential_epoch_schedule(float(g["lr"]), float(g["gamma"]), int(g["steps_per_epoch"]))
    np.testing.assert_allclose([schedule(s) for s in range(int(g["steps"]))], g["lrs"], rtol=1e-12)
    assert state.optimizer.steps_taken() == state.step == int(g["steps"])


def test_cls_step0_gradients(cls_trajectory):
    """Every conv feeds a BatchNorm, so conv bias gradients are pure float32
    noise and left out; every other gradient within 5e-3 of max(L2, 1e-4)."""
    g, _, fps, _, _ = cls_trajectory
    keys, absd, l2 = _delta(g["grad_fp_keys"], g["grad_fp"], fps["grads"])
    carrying = np.array([not (k.startswith("conv_") and k.endswith("/bias")) for k in keys])
    rel = absd / np.maximum(l2, 1e-4)
    worst = np.where(carrying, rel, 0.0).argmax()
    assert rel[carrying].max() < 5e-3, f"cls grad drift {rel[worst]:.2e} ({keys[worst]})"


def test_cls_final_params(cls_trajectory):
    """All parameters, the dead 1000-way head included, within 5e-3 * L2 +
    1e-2; the dead head bit-unchanged, with no Adam moments."""
    g, _, fps, state, dead0 = cls_trajectory
    keys, absd, l2 = _delta(g["param_fp_keys"], g["param_fp"], fps["params"])
    budget = 5e-3 * l2 + 1e-2
    worst = (absd / budget).argmax()
    assert (absd <= budget).all(), f"cls param drift {absd[worst]:.2e} > {budget[worst]:.2e} ({keys[worst]})"
    assert sorted(dead0) == [f"classifier_fc{i}.{leaf}" for i in (1, 2, 3) for leaf in ("bias", "weight")]
    for name, p in state.frozen.items():
        assert torch.equal(p, dead0[name]) and not p.requires_grad, name
    assert set(state.optimizer.state) == set(state.trainable.values())


def test_cls_final_batch_stats(cls_trajectory):
    g, _, fps, _, _ = cls_trajectory
    keys, absd, l2 = _delta(g["bs_fp_keys"], g["bs_fp"], fps["stats"])
    budget = 0.1 * l2 + 0.1
    worst = (absd / budget).argmax()
    assert (absd <= budget).all(), f"cls batch-stats drift {absd[worst]:.2e} > {budget[worst]:.2e} ({keys[worst]})"


def test_cls_eval_forward_after_training(cls_trajectory):
    """Running statistics, no dropout: max |d| < 0.1, mean < 0.04."""
    g, _, _, state, _ = cls_trajectory
    images0, _ = synth_cls_trajectory_batch(0, n=int(g["bs"]), imsize=int(g["imsize"]))
    with torch.no_grad():
        out = state.model.eval()(_nhwc(images0), train=False, use_batch_stats=False)
    d = np.abs(out.numpy() - g["out_eval_after"])
    assert d.max() < 1e-1, f"cls eval-after maxabs {d.max():.2e}"
    assert d.mean() < 4e-2, f"cls eval-after mean {d.mean():.2e}"

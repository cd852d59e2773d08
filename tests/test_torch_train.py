"""Port parity for the training slice: the rest of core/boxes.py, core/multibox.py,
train/optimizer.py, train/state.py, train/trainer.py and the state converters
of models/convert.py, against the reference goldens and the JAX package on the
same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_detection_torch2_tpu.core import boxes as jax_boxes
from object_detection_torch2_tpu.core import multibox as jax_multibox
from object_detection_torch2_tpu.models.convert import ssd_variables_from_torch
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu.train import optimizer as jax_optimizer
from object_detection_torch2_tpu.train.state import merge_params, partition_params
from object_detection_torch2_tpu.utils.testing import synth_targets
from object_detection_torch2_tpu_torch.core import anchors, boxes, multibox
from object_detection_torch2_tpu_torch.data.augment import INV_255
from object_detection_torch2_tpu_torch.models.convert import (
    adam_state_dict_from_optax,
    from_jax_layout,
    jax_path,
    jax_tree,
    ssd_state_dict_from_jax_variables,
)
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
from object_detection_torch2_tpu_torch.train.state import TrainState
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

IMSIZE = 264  # the smallest size the anchor pyramid takes


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ box math


def test_match_mask(goldens):
    g = goldens("boxmath")
    gt, df = g["gts"][..., :4], g["df"]
    ours = boxes.match_mask(_t(gt), _t(df)).numpy()
    np.testing.assert_array_equal(ours, g["match"])
    np.testing.assert_array_equal(ours, np.asarray(jax_boxes.match_mask(jnp.asarray(gt), jnp.asarray(df))))


def test_encode_deltas(goldens):
    """rtol 1e-5; the zero-padded GT rows stay finite."""
    g = goldens("boxmath")
    gt, df = g["gts"][..., :4], g["df"]
    ours = boxes.encode_deltas(_t(gt), _t(df)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, g["delta"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours, np.asarray(jax_boxes.encode_deltas(jnp.asarray(gt), jnp.asarray(df))),
                               rtol=1e-5, atol=1e-6)


def test_smooth_l1_and_cross_entropies(goldens):
    g = goldens("boxmath")
    np.testing.assert_array_equal(boxes.smooth_l1(_t(g["sl1_in"])).numpy(),
                                  np.asarray(jax_boxes.smooth_l1(jnp.asarray(g["sl1_in"]))))
    pr, gt = g["logits"], g["gts"][..., 4:]
    ce = boxes.pairwise_softmax_ce(_t(pr), _t(gt)).numpy()
    np.testing.assert_allclose(ce, g["ce"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ce, np.asarray(jax_boxes.pairwise_softmax_ce(jnp.asarray(pr), jnp.asarray(gt))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(boxes.void_softmax_ce(_t(pr)).numpy(),
                               np.asarray(jax_boxes.void_softmax_ce(jnp.asarray(pr))), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ multibox


def _kth_cases():
    rng = np.random.default_rng(5)
    n, p = 7, 513
    ties = rng.choice(np.float32([-2.5, -1.0, -0.0, 0.0, 1e-30, 3.75, 3.75, 100.0]), (n, p)).astype(np.float32)
    return [rng.standard_normal((n, p)).astype(np.float32) * 10, ties, np.zeros((n, p), np.float32),
            rng.standard_normal((4, 8732)).astype(np.float32)]


@pytest.mark.parametrize("case", range(4))
def test_kth_plus_one_threshold_bitwise(case):
    """Bit-equal to the JAX radix select, ties, +-0, k = 0 and k past the end
    included (compared as raw bits, so -0.0 and +0.0 differ)."""
    x = _kth_cases()[case]
    n, p = x.shape
    rng = np.random.default_rng(case)
    for k in (np.zeros(n, np.int64), np.ones(n, np.int64), np.full(n, p - 1), np.full(n, p + 50),
              rng.integers(0, p, n)):
        ours = multibox.kth_plus_one_threshold(_t(x), _t(k)).numpy()
        ref = np.asarray(jax_multibox.kth_plus_one_threshold(jnp.asarray(x), jnp.asarray(k)))
        np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def test_kth_and_split_goldens(goldens):
    g = goldens("boxmath")
    k = g["kth_k"]
    x = np.tile(g["kth_x"], (len(k), 1))
    np.testing.assert_array_equal(multibox.kth_plus_one_threshold(_t(x), _t(k)).numpy(), g["kth"])
    pos, neg = multibox.split_pos_neg(_t(g["split_pos_in"]), _t(g["split_neg_in"]))
    np.testing.assert_array_equal(pos.numpy(), g["split_pos"])
    np.testing.assert_array_equal(neg.numpy(), g["split_neg"])
    jpos, jneg = jax_multibox.split_pos_neg(jnp.asarray(g["split_pos_in"]), jnp.asarray(g["split_neg_in"]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jneg))


@pytest.mark.parametrize("batch", [("targets", "loss"), ("targets0", "loss0")])
def test_multibox_loss_and_gradient(goldens, batch):
    """Both golden batches (the second has an image without GT): the loss
    within rtol 1e-5 of the reference and of the JAX package, its gradient
    within rtol 1e-5 of the JAX gradient."""
    tkey, lkey = batch
    g = goldens("loss")
    df = anchors.default_boxes()
    out = _t(g["outputs"]).requires_grad_(True)
    loss = multibox.multibox_loss(out, _t(g[tkey]), _t(df))
    loss.backward()
    jloss, jgrad = jax.value_and_grad(jax_multibox.multibox_loss)(jnp.asarray(g["outputs"]),
                                                                   jnp.asarray(g[tkey]), jnp.asarray(df))
    np.testing.assert_allclose(loss.item(), float(g[lkey]), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-9)


def test_multibox_loss_all_void_is_exactly_zero():
    out = torch.zeros((2, 8732, 25), requires_grad=True)
    loss = multibox.multibox_loss(out, torch.zeros((2, 4, 25)), _t(anchors.default_boxes()))
    loss.backward()
    assert loss.item() == 0.0
    assert torch.isfinite(out.grad).all()


def test_multibox_loss_many_gt_rows_matches_jax():
    """G = 64, the CLI's padding (cli/common.py:44), on random outputs."""
    rng = np.random.default_rng(8)
    targets = synth_targets(rng, 3, rng.integers(0, 64, 3), 64)
    outputs = rng.standard_normal((3, 8732, 25)).astype(np.float32)
    df = anchors.default_boxes()
    ours = multibox.multibox_loss(_t(outputs), _t(targets), _t(df))
    ref = jax_multibox.multibox_loss(jnp.asarray(outputs), jnp.asarray(targets), jnp.asarray(df))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


# ------------------------------------------------------------- optimizer state


def test_exponential_schedule_matches_jax():
    ours = exponential_epoch_schedule(1e-3, 0.7, 5)
    ref = jax_optimizer.exponential_epoch_schedule(1e-3, 0.7, 5)
    for step in range(23):
        assert ours(step) == ref(step)


def test_trainable_partition_matches_jax():
    """The port's `SSD.is_trainable` on its parameter names and the JAX
    package's on the mapped layer names agree; frozen parameters take no
    gradient and no optimizer state."""
    model = SSD()
    state = TrainState.create(model, lambda ps: adam_torch(ps, 1e-3))
    for name, _ in model.named_parameters():
        assert SSD.is_trainable(name) == JaxSSD.is_trainable((jax_path(name)[0],)), name
    assert len(state.trainable) == 52 and len(state.frozen) == 52
    assert all(p.requires_grad for p in state.trainable.values())
    assert not any(p.requires_grad for p in state.frozen.values())
    assert [p for g in state.optimizer.param_groups for p in g["params"]] == list(state.trainable.values())
    assert SSD.is_trainable("det_4_3") and SSD.is_trainable("features.bn_11_2.bias")
    assert not SSD.is_trainable("features.conv_5_3.weight")


def _jax_tx():
    return jax_optimizer.adam_torch(jax_optimizer.exponential_epoch_schedule(1e-3, 0.7, 2), weight_decay=5e-4)


def test_adam_state_carries_over_from_optax():
    """Three optax steps on the SSD's trainable tree with seeded gradients,
    then the mid-run state carried into the port's torch Adam: the fourth step
    agrees (params rtol 1e-6), at the schedule's rate for step 3."""
    rng = np.random.default_rng(0)
    sd = {k: v.numpy() for k, v in SSD(seed=3).state_dict().items()}
    variables = ssd_variables_from_torch(sd)
    params, frozen = partition_params(variables["params"], JaxSSD.is_trainable)
    params = jax.tree.map(jnp.asarray, params)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 1e-2, params)
             for _ in range(4)]
    tx = _jax_tx()
    opt = tx.init(params)
    for g in grads[:3]:
        updates, opt = tx.update(jax.tree.map(jnp.asarray, g), opt, params)
        params = optax.apply_updates(params, updates)

    model = SSD()
    model.load_state_dict(ssd_state_dict_from_jax_variables(
        {"params": jax.tree.map(np.asarray, merge_params(params, frozen)), "batch_stats": variables["batch_stats"]}))
    schedule = exponential_epoch_schedule(1e-3, 0.7, 2)
    state = TrainState.create(model, lambda ps: adam_torch(ps, schedule, weight_decay=5e-4))
    adam = next(s for s in opt if isinstance(s, optax.ScaleByAdamState))
    state.optimizer.load_state_dict(adam_state_dict_from_optax(
        adam.count, jax.tree.map(np.asarray, adam.mu), jax.tree.map(np.asarray, adam.nu), list(state.trainable),
        state.optimizer.state_dict()["param_groups"]))
    assert state.optimizer.steps_taken() == 3

    updates, opt = tx.update(jax.tree.map(jnp.asarray, grads[3]), opt, params)
    params = optax.apply_updates(params, updates)
    state.apply_gradients([from_jax_layout(grads[3][jax_path(n)[0]][jax_path(n)[1]]) for n in state.trainable])
    assert state.optimizer.param_groups[0]["lr"] == schedule(3)
    ours = jax_tree(state.trainable)
    for layer, leaves in params.items():
        for leaf, ref in leaves.items():
            np.testing.assert_allclose(ours[layer][leaf], np.asarray(ref), rtol=1e-6, atol=1e-8,
                                       err_msg=f"{layer}/{leaf}")


# ------------------------------------------------------------------- trainer


def _batch(seed, n=2, g_pad=8, uint8=True):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    targets = synth_targets(rng, n, rng.integers(1, g_pad + 1, n), g_pad)
    return (images if uint8 else images.astype(np.float32) / 255.0), targets


def _trainer(seed=0, conv12_kernel=True):
    model = SSD(num_classes=21, seed=seed, conv12_kernel=conv12_kernel)
    trainer = Trainer(model, default_boxes=anchors.default_boxes(anchors.feature_grids_for(IMSIZE)), device="cpu")
    state = trainer.init_state(lambda ps: adam_torch(ps, exponential_epoch_schedule(1e-3, 0.7, 2),
                                                     weight_decay=5e-4))
    return trainer, state


def test_train_steps_equals_single_steps():
    """A K = 3 call computes the same sequence as three single steps, bit for
    bit, and the frozen trunk is bit-unchanged while its statistics move."""
    batches = [_batch(s) for s in range(3)]
    images_k = np.stack([b[0] for b in batches])
    targets_k = np.stack([b[1] for b in batches])
    t1, s1 = _trainer()
    t2, s2 = _trainer()
    trunk0 = {k: v.clone() for k, v in s1.frozen.items()}
    stats0 = {k: v.clone() for k, v in s1.batch_stats.items()}
    singles = torch.stack([t1.train_step(s1, images, targets) for images, targets in batches])
    stacked = t2.train_steps(s2, images_k, targets_k)
    assert stacked.shape == (3,) and torch.isfinite(stacked).all()
    assert torch.equal(singles, stacked)
    assert s1.step == s2.step == 3
    for (name, a), b in zip(s1.model.state_dict().items(), s2.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name, p in s1.frozen.items():
        assert torch.equal(p, trunk0[name]), name
    assert all(not torch.equal(b, stats0[name]) for name, b in s1.batch_stats.items())


def test_zero_gradients_arrive_as_zeros():
    """An all-void batch gives a loss of exactly 0 and zero gradients. They
    reach Adam as zero tensors, not None, so every trainable parameter still
    takes its weight-decay step, as every trainable leaf does in the JAX
    package; the frozen ones do not move."""
    trainer, state = _trainer()
    captured = []
    apply = state.apply_gradients
    state.apply_gradients = lambda grads: (captured.extend(grads), apply(grads))
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    images, _ = _batch(1)
    loss = trainer.train_step(state, images, np.zeros((2, 8, 25), np.float32))
    assert loss.item() == 0.0
    assert len(captured) == 52 and all(g is not None and not g.any() for g in captured)
    assert all(int(s["step"]) == 1 for s in state.optimizer.state.values())
    assert set(state.optimizer.state) == set(state.trainable.values())
    for name, p in state.model.named_parameters():
        moves = name in state.trainable and bool(before[name].any())  # decay moves nonzero weights only
        assert torch.equal(p, before[name]) != moves, name


def test_uint8_and_float_inputs_take_the_same_step():
    """uint8 images are scaled by the float32 reciprocal of 255, as the JAX
    package's `/ 255.0` compiles."""
    t1, s1 = _trainer()
    t2, s2 = _trainer()
    images, targets = _batch(4)
    a = t1.train_step(s1, images, targets)
    b = t2.train_step(s2, torch.from_numpy(images).float() * INV_255, targets)
    assert torch.equal(a, b)


def test_eval_step_updates_running_stats_only():
    """Reference validation (quirk Q9): no gradient, no parameter change,
    batch statistics, running statistics updated; the loss equals the one a
    train step computes on the same state."""
    trainer, state = _trainer()
    images, targets = _batch(2)
    params0 = {k: v.clone() for k, v in state.model.named_parameters()}
    stats0 = {k: v.clone() for k, v in state.batch_stats.items()}
    shadow_trainer, shadow = _trainer()
    loss = trainer.eval_step(state, images, targets)
    assert not loss.requires_grad and state.step == 0
    for name, p in state.model.named_parameters():
        assert torch.equal(p, params0[name]) and p.grad is None, name
    assert all(not torch.equal(b, stats0[name]) for name, b in state.batch_stats.items())
    assert torch.equal(loss, shadow_trainer.train_step(shadow, images, targets))


def test_trainer_refusals():
    model = SSD()
    df = anchors.default_boxes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(model, default_boxes=df)
    # a data-parallel mesh runs on its own device (tests/test_torch_parallel.py)
    from object_detection_torch2_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="mesh's device"):
        Trainer(model, default_boxes=df, device="cpu", mesh=Mesh(0, 1, torch.device("meta")))
    # an int8 trunk needs calibrated scales: the JAX package's check_calibrated
    with pytest.raises(ValueError, match="calibrated activation scales"):
        Trainer(SSD(trunk_int8=True), default_boxes=df, device="cpu", quant={})
    with pytest.raises(ValueError, match="default_boxes"):
        Trainer(model, device="cpu")
    with pytest.raises(ValueError, match="loss_kind"):
        Trainer(model, loss_kind="hinge", device="cpu")

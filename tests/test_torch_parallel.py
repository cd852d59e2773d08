"""The port's data parallelism (parallel/mesh.py) on the CPU: 2 gloo ranks
against 1 rank over the whole batch and against the JAX package's 2-device
mesh (`Trainer(mesh=make_mesh(2))` on the virtual CPU devices of
tests/conftest.py), and a mesh of one rank against no mesh, bit for bit.

One 2-rank cluster serves the module: `_rank_checks` runs every check on
both ranks (BatchNorm, the SSD's gradients and SGD steps from the JAX
package's init, the predictor, the AP merge, the world-1 comparisons) and
returns the results, which the tests compare with the same work done here in one
process. The cluster starts before anything else of the module, so it runs
while this process computes the JAX package's references and its own. The
ranks meet through a FileStore; the cluster has a hard timeout.
This module imports nothing of JAX at its top: the ranks import it.

Tolerances are the JAX package's own for its 1-vs-8-device test
(tests/test_parallel.py:114-143): losses rtol 1e-5; gradients rtol 1e-6 /
atol 1e-8 between the port's runs; parameters rtol 1e-4 / atol 4e-6; batch
statistics rtol 1e-3 / atol 1e-5. The trajectories use SGD: Adam turns
reduction-order ulps into +-lr steps (tests/test_parallel.py:61-69); Adam is
held only where a mesh of one rank must equal no mesh bit for bit.

The full SSD's steps on 2 ranks against 1 rank that the JAX package does not
take part in (the float64 run, an augmented step, an int8-trunk step) hold
the port against itself: their tests are marked `slow` (`python -m pytest -m
slow tests/test_torch_parallel.py` runs them) and share a 2-rank cluster of
their own, and chip_smoke.py's `phase_parallel_ranks` asserts their checks at
the same pins on the card."""

import concurrent.futures
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch import true_float32
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.metrics.ap import APAccumulator, merge_accumulators_across_processes
from object_detection_torch2_tpu_torch.models import quant
from object_detection_torch2_tpu_torch.models.bn import BatchNorm, set_mesh
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.parallel import mesh as mesh_lib
from object_detection_torch2_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, local_rows
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch, exponential_epoch_schedule
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"
IMSIZE = 264  # the smallest SSD pyramid
GLOBAL = 4  # the global batch: 2 rows a rank
WORLD = 2
CLUSTER_TIMEOUT = 400  # seconds
BN_MASKS = {"none": None, "partial": [1, 0, 1, 1], "rank1_empty": [1, 1, 0, 0]}
AP_SPLITS = {"ragged": 4, "empty": 5}  # rank 0 holds images [0, split), rank 1 the rest


# ------------------------------------------------------------ shared inputs


def _ssd_batch():
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (GLOBAL, IMSIZE, IMSIZE, 3)).astype(np.float32)
    targets = np.zeros((GLOBAL, 3, 25), np.float32)
    targets[:, 0, :4] = [0.5, 0.5, 0.4, 0.4]
    targets[:, 0, 10] = 1.0
    targets[:, 1, :4] = [0.25, 0.25, 0.2, 0.3]
    targets[:, 1, 5] = 1.0
    return images, targets


def _fixture_batch():
    """The 4 photographs of tests/fixtures/voc/VOCtest at imsize 264, in
    [0, 1], and their ground truth."""
    from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset, collate

    ds = PascalVOCDataset("detection", [FIXTURE], "test.txt", IMSIZE)
    images, targets = collate([ds[i] for i in range(GLOBAL)], max_gt=8)
    return images.astype(np.float32) / np.float32(255.0), targets


def _u8_batch():
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (GLOBAL, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    return images, _ssd_batch()[1]


def _df():
    return default_boxes(feature_grids_for(IMSIZE))


def _sgd(ps):
    return torch.optim.SGD(ps, lr=1e-3)


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _grads(trainer, state, images, targets) -> dict:
    """The trainable gradients of the loss (the global batch's under a mesh),
    through the synced statistics; the BatchNorm buffers are restored after."""
    buffers = _snapshot(state.model)
    images, targets = trainer._inputs(images, targets)
    state.model.train()
    params = list(state.trainable.values())
    with true_float32():
        loss = trainer._loss(trainer._forward(state.model, images), targets)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
    if trainer.mesh is not None:
        all_reduce_mean_(grads, trainer.mesh)
    state.model.load_state_dict(buffers)
    return dict(zip(state.trainable, grads))


def _result(state, losses) -> dict:
    return {"losses": [float(v) for v in losses],
            "params": {k: p.detach().clone() for k, p in state.trainable.items()},
            "stats": {k: b.clone() for k, b in state.batch_stats.items()}}


# ------------------------------------------------------- one rank's checks


def _bn_run(mesh, mask) -> dict:
    """One training-mode BatchNorm forward and backward of sum(out * r) on
    the mesh's rows (all rows without one)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(GLOBAL, 8, 5, 5, generator=g) * 3 + 1
    r = torch.randn(GLOBAL, 8, 5, 5, generator=g)
    weight, bias = torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g)
    m = None if mask is None else torch.tensor(mask, dtype=torch.float32)
    x, r = local_rows(x, mesh), local_rows(r, mesh)
    m = None if m is None else local_rows(m, mesh)
    bn = set_mesh(BatchNorm(8), mesh)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
    x.requires_grad_(True)
    out = bn(x, True, m)
    (out * r).sum().backward()
    return {"out": out.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def _ssd_run(mesh, state_dict=None, dtype=torch.float32, batch=_ssd_batch) -> dict:
    """The SSD (seeded, or holding `state_dict`) computing in `dtype`: its
    gradients, then 2 SGD steps, on the float images of `batch`."""
    images, targets = (local_rows(a, mesh) for a in batch())
    model = SSD(num_classes=21, dtype=dtype)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    trainer = Trainer(model, default_boxes=_df(), device="cpu", mesh=mesh)
    state = trainer.init_state(_sgd)
    grads = _grads(trainer, state, images, targets)
    losses = [trainer.train_step(state, images, targets) for _ in range(2)]
    return {"grads": grads, **_result(state, losses)}


def _aug_run(mesh) -> dict:
    """One augmented SGD step on uint8 images."""
    images, targets = (local_rows(a, mesh) for a in _u8_batch())
    trainer = Trainer(SSD(num_classes=21), default_boxes=_df(), device="cpu", mesh=mesh, augment=True, seed=3)
    state = trainer.init_state(_sgd)
    return _result(state, [trainer.train_step(state, images, targets)])


def _int8_run(mesh) -> dict:
    """One SGD step of the int8 trunk in running-statistics mode."""
    images, targets = (local_rows(a, mesh) for a in _ssd_batch())
    scales = {f"amax_{layer}": 4.0 for layer in quant.QUANT_LAYERS}
    trainer = Trainer(SSD(num_classes=21, trunk_int8=True), default_boxes=_df(), device="cpu", mesh=mesh,
                      quant=scales, use_batch_stats=False)
    state = trainer.init_state(_sgd)
    return _result(state, [trainer.train_step(state, images, targets)])


def _stack_run(mesh) -> dict:
    """A float64 stack conv(stride 2) -> BatchNorm -> ReLU -> conv 1x1 ->
    BatchNorm -> ReLU -> conv and a mean squared error over the batch: the
    gradients of every weight (the ranks' mean under a mesh)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x = torch.randn(GLOBAL, 6, 9, 9, generator=g, dtype=torch.float64)
    target = torch.randn(GLOBAL, 3, 5, 5, generator=g, dtype=torch.float64)
    w1, w2, w3 = (torch.randn(shape, generator=g, dtype=torch.float64) * 0.3
                  for shape in ((8, 6, 3, 3), (5, 8, 1, 1), (3, 5, 3, 3)))
    x, target = local_rows(x, mesh), local_rows(target, mesh)
    bn1, bn2 = (set_mesh(BatchNorm(c).double(), mesh) for c in (8, 5))
    params = [w.requires_grad_(True) for w in (w1, w2, w3)] + [bn1.weight, bn1.bias, bn2.weight, bn2.bias]
    h = torch.relu(bn1(F.conv2d(x, w1, stride=2, padding=1), True))
    h = torch.relu(bn2(F.conv2d(h, w2), True))
    loss = ((F.conv2d(h, w3, padding=1) - target) ** 2).mean()
    grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        all_reduce_mean_(grads, mesh)
    return {"loss": loss.detach(), "grads": [t.clone() for t in grads]}


def _predict_run(mesh) -> list:
    """`Predictor(mesh=)` over 5 images at batch 4 (rank 1's share of the
    second batch is pad rows only), running statistics: every image's
    detections, on every rank."""
    from object_detection_torch2_tpu_torch.infer import Predictor

    images = np.random.default_rng(13).integers(0, 256, (5, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    predictor = Predictor(SSD(num_classes=21), imsize=IMSIZE, batch_size=GLOBAL, use_batch_stats=False,
                          max_detections=20, device="cpu", mesh=mesh)
    return [(d.boxes, d.class_ids, d.scores) for d in predictor.predict(images)]


def _ap_matches():
    """detection_matches-shaped rows of 5 images, 20 classes, 6 slots."""
    rng = np.random.default_rng(9)
    scores = rng.uniform(0, 1, (5, 20, 6)).astype(np.float32) * (rng.uniform(size=(5, 20, 6)) < 0.4)
    correct = (rng.uniform(size=(5, 20, 6)) < 0.5) & (scores > 0)
    counts = rng.integers(0, 3, (5, 20))
    return {"correct": correct, "scores": scores, "counts": counts}


def _ap_run(mesh, split: int):
    matches = _ap_matches()
    rows = slice(0, split) if mesh.rank == 0 else slice(split, 5)
    acc = APAccumulator(20)
    if rows.stop > rows.start:
        acc.update({k: v[rows] for k, v in matches.items()})
    merged = merge_accumulators_across_processes(acc, mesh)
    return {"parity": merged.result(strict=False), "strict": merged.result(strict=True), "counts": merged.counts}


def _adam_run(mesh) -> dict:
    """2 augmented Adam steps on 2 uint8 images (float32), gradients first."""
    images, targets = (a[:2] for a in _u8_batch())
    trainer = Trainer(SSD(num_classes=21), default_boxes=_df(), device="cpu", mesh=mesh, augment=True, seed=4)
    state = trainer.init_state(lambda ps: adam_torch(ps, exponential_epoch_schedule(1e-3, 0.95, 2), 5e-4))
    grads = _grads(trainer, state, images, targets)
    losses = [trainer.train_step(state, images, targets) for _ in range(2)]
    return {"grads": grads, "losses": losses, "state": _snapshot(state.model)}


def _world1_checks(w1) -> dict:
    """A mesh of one rank against no mesh: {check: names that differ}."""
    differ = {}
    for case, mask in BN_MASKS.items():
        a, b = _bn_run(w1, mask), _bn_run(None, mask)
        differ[f"bn_{case}"] = [k for k in a if not torch.equal(a[k], b[k])]
    a, b = _adam_run(w1), _adam_run(None)
    differ["adam_grads"] = [k for k in a["grads"] if not torch.equal(a["grads"][k], b["grads"][k])]
    differ["adam_losses"] = [i for i, (x, y) in enumerate(zip(a["losses"], b["losses"])) if not torch.equal(x, y)]
    differ["adam_state"] = [k for k in a["state"] if not torch.equal(a["state"][k], b["state"][k])]
    return differ


def _wait_for(path: Path, timeout: float = CLUSTER_TIMEOUT):
    """The object this module's process saves at `path` (atomically, by a
    rename), once it is there."""
    import time

    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written after {timeout} s")
        time.sleep(0.2)
    return torch.load(path, weights_only=True)


def _rank_checks(mesh, handoff: str) -> dict:
    """Everything one rank of the 2-rank cluster computes. The run from the
    JAX package's seeded variables comes last: this module's process writes
    their state_dict to `handoff` while the ranks compute the rest."""
    import torch.distributed as dist

    out = {"bn": {case: _bn_run(mesh, mask) for case, mask in BN_MASKS.items()},
           "ap": {case: _ap_run(mesh, split) for case, split in AP_SPLITS.items()},
           "predict": _predict_run(mesh), "stack": _stack_run(mesh)}
    # models that differ between the ranks are refused
    probe = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(probe.weight, float(mesh.rank))
    try:
        mesh_lib.replicate(probe, mesh)
        out["replicate_refused"] = None
    except RuntimeError as e:
        out["replicate_refused"] = str(e)
    single, _ = dist.new_subgroups(group_size=1)  # collective: a group of one for each rank
    if mesh.rank == 0:
        out["world1"] = _world1_checks(mesh_lib.make_mesh("cpu", group=single))
    out["ssd"] = _ssd_run(mesh, _wait_for(Path(handoff)), batch=_fixture_batch)
    return out


def _slow_rank_checks(mesh) -> dict:
    """One rank of the slow tests' cluster: the float64 SSD's gradients and
    steps, an augmented step, an int8-trunk step."""
    return {"ssd64": _ssd_run(mesh, dtype=torch.float64), "aug": _aug_run(mesh), "int8": _int8_run(mesh)}


def _assert_ranks_bit_identical(ranks, run: str):
    """After the steps both ranks hold the same parameters and running
    statistics, bit for bit, and returned the same (global) losses."""
    a, b = ranks[0][run], ranks[1][run]
    assert a["losses"] == b["losses"], run
    for part in ("params", "stats"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (run, part, k)


# ----------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The 2-rank cluster's results, as a future, and the path where
    `jax_init` hands the ranks their starting state_dict: the cluster starts
    first and runs while this process computes its references."""
    handoff = tmp_path_factory.mktemp("handoff") / "jax_init.pt"
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(mesh_lib.launch, _rank_checks, WORLD, (str(handoff),), device_type="cpu",
                         timeout=CLUSTER_TIMEOUT)
    yield future, handoff
    future.result(timeout=CLUSTER_TIMEOUT)
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_init(cluster):
    """The JAX package's seeded SSD variables (PRNGKey(0)), and the port's
    state_dict holding them, handed to the cluster's ranks too: the full-SSD
    runs start from these, as the port against the JAX package's single
    device does (tests/test_torch_train_cli.py).
    The port's own torch init is not used there: on it the JAX package's BN
    output form, x * inv + (bias - mean * inv), cancels in the deep extras
    (models/bn.py) and the two packages' losses part by ~1%."""
    import jax
    import jax.numpy as jnp

    from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
    from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables

    model = JaxSSD(num_classes=21)
    # one program, compiled at XLA's backend optimization level 1: a third of
    # the default level's compile CPU, the same variables bit for bit
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, IMSIZE, IMSIZE, 3)), train=False))
    key = jax.random.PRNGKey(0)
    variables = init.lower(key).compile(compiler_options={"xla_backend_optimization_level": 1})(key)
    variables = jax.tree.map(np.asarray, {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    state_dict = ssd_state_dict_from_jax_variables(variables)
    handoff = cluster[1]
    torch.save(state_dict, handoff.with_suffix(".part"))
    handoff.with_suffix(".part").rename(handoff)
    return variables, state_dict


@pytest.fixture(scope="module")
def ranks(cluster, jax_init):
    return cluster[0].result(timeout=CLUSTER_TIMEOUT)


@pytest.fixture(scope="module")
def slow_ranks():
    """The slow tests' 2-rank cluster: `_slow_rank_checks` on each rank."""
    return mesh_lib.launch(_slow_rank_checks, WORLD, device_type="cpu", timeout=CLUSTER_TIMEOUT)


@pytest.fixture(scope="module")
def jax_mesh_run(jax_init):
    """The JAX package's Trainer on a 2-device mesh from its seeded SSD: the
    gradients through its synced statistics, then 2 SGD steps."""
    import jax
    import jax.numpy as jnp
    import optax

    from object_detection_torch2_tpu.core.multibox import multibox_loss
    from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
    from object_detection_torch2_tpu.parallel import make_mesh
    from object_detection_torch2_tpu.train.state import merge_params
    from object_detection_torch2_tpu.train.trainer import Trainer as JaxTrainer

    images, targets = _fixture_batch()
    dfj = jnp.asarray(_df())
    model = JaxSSD(num_classes=21)
    trainer = JaxTrainer(model, loss_kind="multibox", default_boxes=dfj, mesh=make_mesh(2))
    state = trainer.init_state(jax.random.PRNGKey(0), jnp.zeros((1, IMSIZE, IMSIZE, 3)), optax.sgd(1e-3),
                               is_trainable=JaxSSD.is_trainable, variables=jax.tree.map(jnp.asarray, jax_init[0]))
    im, tg = trainer.place_batch(images, targets)

    def loss_fn(params, frozen, batch_stats, im, tg, dfj):
        # every array is an argument: closed over, XLA would fold the frozen
        # trunk's convolutions into constants at compile time
        v = {"params": merge_params(params, frozen), "batch_stats": batch_stats}
        out, _ = model.apply(v, im, train=True, use_batch_stats=True, mutable=["batch_stats"])
        return multibox_loss(out, tg, dfj, 1.0)

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params, state.frozen, state.batch_stats, im, tg, dfj))
    losses = []
    for _ in range(2):
        state, loss = trainer.train_step(state, im, tg)
        losses.append(float(loss))
    return {"grads": grads, "losses": losses, "params": jax.device_get(state.params),
            "stats": jax.device_get(state.batch_stats)}


def _close(got: dict, want: dict, rtol: float, atol: float):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol, atol=atol, err_msg=k)


def _as_jax(tree: dict) -> dict:
    """{port name: tensor} -> {port name: the JAX layout}."""
    from object_detection_torch2_tpu_torch.models.convert import to_jax_layout

    return {k: to_jax_layout(v) for k, v in tree.items()}


def _jax_leaf(tree: dict, name: str):
    from object_detection_torch2_tpu_torch.models.convert import jax_path

    layer, leaf = jax_path(name)
    return np.asarray(tree[layer][leaf])


# -------------------------------------------------------------------- tests


def test_full_ssd_two_ranks_match_the_jax_mesh_and_one_rank(cluster, jax_init, jax_mesh_run):
    """The full SSD in float32 from the JAX package's seeded variables, on
    the fixture's 4 photographs (global batch 4), SGD: the 2-rank port
    against the JAX package's `Trainer(mesh=make_mesh(2))` and against the
    port on one process. Losses, parameters after 2 steps and running
    statistics at the JAX package's DP tolerances (against the JAX mesh, the
    statistics as close as the 1-rank port's, within those); the heads' gradients
    within 5% in L2 of the JAX package's (the port's single-device bound on
    the heads' update, tests/test_torch_train_cli.py) and within 1e-4 of the
    1-rank port's. The extras' float32 gradients are held through the
    parameters (see the float64 test for why not elementwise)."""
    one = _ssd_run(None, jax_init[1], batch=_fixture_batch)
    two = cluster[0].result(timeout=CLUSTER_TIMEOUT)[0]["ssd"]
    jx = jax_mesh_run
    heads = [k for k in two["grads"] if k.startswith("detectors.") and one["grads"][k].abs().max() > 0]
    # port against port
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    for k in heads:
        a, b = two["grads"][k], one["grads"][k]
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()), k
    _close(two["params"], one["params"], rtol=1e-4, atol=4e-6)
    _close(two["stats"], one["stats"], rtol=1e-3, atol=1e-5)
    # port against the JAX package's mesh
    np.testing.assert_allclose(two["losses"], jx["losses"], rtol=1e-5)
    grads = _as_jax(two["grads"])
    for k in heads:
        want = _jax_leaf(jx["grads"], k)
        assert np.linalg.norm(grads[k] - want) <= 0.05 * np.linalg.norm(want), k
    for name, p in _as_jax(two["params"]).items():
        np.testing.assert_allclose(p, _jax_leaf(jx["params"], name), rtol=1e-4, atol=4e-6, err_msg=name)
    for name, st in two["stats"].items():
        # the deep extras' statistics of the two packages part by up to 5e-5
        # in one process already (the BN output forms, models/bn.py): the
        # 2-rank port is as close to the JAX mesh as the 1-rank port, within
        # the port-to-port tolerance
        got, want, single = st.numpy(), _jax_leaf(jx["stats"], name), one["stats"][name].numpy()
        assert (np.abs(got - want) <= np.abs(single - want) + 1e-5 + 1e-3 * np.abs(single)).all(), name


@pytest.mark.slow
def test_full_ssd_float64_two_ranks_equal_one_rank(slow_ranks):
    """The full SSD at imsize 264, global batch 4 (the JAX package's DP test
    data), SGD, computing in float64 (`SSD(dtype=torch.float64)`): 2 ranks
    against 1 rank over the whole batch. The gradients through the synced
    BatchNorm at rtol 1e-6 / atol 1e-8, then 2 steps' losses, parameters and
    running statistics at the JAX package's DP tolerances.

    In float32 the extras' gradients are not reproducible to that: reordering
    the batch statistics' sums moves them by up to tens of percent (measured
    on this data: conv_9_2's gradient 23% of its largest element between 1
    and 2 ranks; a row permutation in one process moves conv_7_1's by 2.4%),
    because the extras' BatchNorm backward amplifies float32 differences
    (bn_9_2: a relative difference of 7e-5 in its output's gradient becomes
    0.5% in its input's). The JAX package's 1-vs-8-device gradients are
    bit-equal only because XLA partitions the reduction identically. In
    float64 that amplified noise stays below 1e-8, so the gradients' semantics
    (the moments' all-reduce backward and the one mean of the gradients) are
    held exactly. The two ranks return the same losses and hold the same
    parameters and statistics, bit for bit."""
    _assert_ranks_bit_identical(slow_ranks, "ssd64")
    one = _ssd_run(None, dtype=torch.float64)
    two = slow_ranks[0]["ssd64"]
    _close(two["grads"], one["grads"], rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    _close(two["params"], one["params"], rtol=1e-4, atol=4e-6)
    _close(two["stats"], one["stats"], rtol=1e-3, atol=1e-5)


def test_ranks_hold_bit_identical_state(ranks):
    """After the steps every rank holds the same parameters and running
    statistics, bit for bit, and returned the same (global) losses (the slow
    tests' cluster: each of its tests checks its own run)."""
    _assert_ranks_bit_identical(ranks, "ssd")


@pytest.mark.parametrize("case", list(BN_MASKS))
def test_batchnorm_two_ranks_equal_one_rank(ranks, case):
    """BatchNorm under 2 ranks against 1 rank over the whole batch: the
    outputs, the input gradients of each rank's rows, the weight and bias
    gradients (summed over the ranks: the loss is the sum of theirs) and
    the running statistics; with no mask, with a mask, and with rank 1's
    rows all masked (it still joins every collective)."""
    one = _bn_run(None, BN_MASKS[case])
    a, b = ranks[0]["bn"][case], ranks[1]["bn"][case]
    for key in ("out", "x_grad"):
        np.testing.assert_allclose(torch.cat([a[key], b[key]]).numpy(), one[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    for key in ("weight_grad", "bias_grad"):
        np.testing.assert_allclose((a[key] + b[key]).numpy(), one[key].numpy(), rtol=1e-5, atol=1e-5, err_msg=key)
    for key in ("running_mean", "running_var"):
        assert torch.equal(a[key], b[key]), key
        np.testing.assert_allclose(a[key].numpy(), one[key].numpy(), rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("check", [f"bn_{c}" for c in BN_MASKS] + ["adam_grads", "adam_losses", "adam_state"])
def test_world_one_mesh_is_bit_equal_to_no_mesh(ranks, check):
    """A mesh of one rank (gloo, a group of one) computes what no mesh does,
    bit for bit: BatchNorm's outputs, gradients and running statistics in
    each mask case; the SSD's gradients, and 2 augmented Adam steps' losses,
    parameters and running statistics, float32."""
    assert ranks[0]["world1"][check] == []


@pytest.mark.slow
def test_augmented_step_two_ranks_equal_one_rank(slow_ranks):
    """An augmented step: each rank draws for the global batch and keeps its
    rows, so 2 ranks x 2 images take the step 1 rank x 4 images takes."""
    _assert_ranks_bit_identical(slow_ranks, "aug")
    one = _aug_run(None)
    two = slow_ranks[0]["aug"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    _close(two["params"], one["params"], rtol=1e-4, atol=4e-6)
    _close(two["stats"], one["stats"], rtol=1e-3, atol=1e-5)


@pytest.mark.slow
def test_trunk_int8_step_two_ranks_equal_one_rank(slow_ranks):
    """One --trunk_int8 step in running-statistics mode (as the JAX
    package's test: batch statistics' reduction order flips int8 roundings):
    the heads' gradient all-reduce composes with the int8 trunk."""
    _assert_ranks_bit_identical(slow_ranks, "int8")
    one = _int8_run(None)
    two = slow_ranks[0]["int8"]
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    _close(two["params"], one["params"], rtol=1e-4, atol=4e-6)


@pytest.mark.parametrize("case", list(AP_SPLITS))
def test_merge_accumulators_equals_one_accumulator(ranks, case):
    """merge_accumulators_across_processes over ragged per-rank rows, and
    with rank 1 holding none: on every rank, one accumulator's result over
    all rows (parity and strict), and the JAX package's APAccumulator's."""
    from object_detection_torch2_tpu.metrics.ap import APAccumulator as JaxAPAccumulator

    matches = _ap_matches()
    one, jx = APAccumulator(20), JaxAPAccumulator(20)
    one.update(matches)
    jx.update(matches)
    for r in range(WORLD):
        got = ranks[r]["ap"][case]
        np.testing.assert_array_equal(got["counts"], one.counts)
        for strict, key in ((False, "parity"), (True, "strict")):
            aps, mean = got[key]
            for want_aps, want_mean in (one.result(strict=strict), jx.result(strict=strict)):
                np.testing.assert_array_equal(aps, want_aps)
                assert mean == want_mean


def test_sync_batchnorm_stack_gradients_two_ranks_equal_one_rank(ranks):
    """A float64 stack of two synced BatchNorms between convolutions, with a
    mean loss over the batch: every weight's gradient (the ranks' mean) at
    rtol 1e-6 / atol 1e-8 of one process's, and the global loss."""
    one = _stack_run(None)
    two = ranks[0]["stack"]
    for r in range(WORLD):
        for got, want in zip(ranks[r]["stack"]["grads"], one["grads"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-8)
    # each rank's loss is the mean over its rows: their mean is the global loss
    np.testing.assert_allclose(float(ranks[0]["stack"]["loss"] + ranks[1]["stack"]["loss"]) / 2,
                               float(one["loss"]), rtol=1e-12)
    assert two["grads"][0].dtype == torch.float64


def test_predictor_mesh_returns_every_image_on_every_rank(ranks):
    """`Predictor(mesh=)`: each rank runs its rows of every batch (the NMS
    on its own rows) and gets every image's detections back, as one
    process's `Predictor` gives them (running statistics: no reduction
    crosses the ranks): the same classes, boxes and scores within 1e-5, the
    JAX package's bound for its sharded running-statistics pipeline (a
    convolution over 2 rows may sum in another order than over 4: 1 ulp,
    tests/test_parallel.py). A batch that does not divide over the ranks
    is refused."""
    from object_detection_torch2_tpu_torch.infer import Predictor

    one = _predict_run(None)
    for r in range(WORLD):
        assert len(ranks[r]["predict"]) == len(one) == 5
        for (boxes, classes, scores), (want_boxes, want_classes, want_scores) in zip(ranks[r]["predict"], one):
            np.testing.assert_array_equal(classes, want_classes)
            np.testing.assert_allclose(boxes, want_boxes, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must divide over 2 devices"):
        Predictor(SSD(num_classes=21), imsize=IMSIZE, batch_size=3, device="cpu",
                  mesh=Mesh(0, 2, torch.device("cpu")))


def test_replicate_refuses_ranks_that_differ(ranks):
    for r in range(WORLD):
        assert "differ from rank" in ranks[r]["replicate_refused"]


@pytest.mark.parametrize("procs", [1, 2, 4])
@pytest.mark.parametrize("mode", ["train", "stack_steps", "serving"])
def test_loader_rank_slices_match_jax(loader_records, procs, mode):
    """DataLoader's per-rank slices against the JAX loader's indices and
    batches (its `_num_procs` / `_proc` set on the instance): with a mesh
    (training: shuffled, drop_last, `stack_steps=2` slicing axis 1), and in
    serving mode (no mesh, several processes, drop_last=False) over 10
    images at batch 4, whose final batch of 2 leaves the last ranks a short
    or an empty slice, which is still yielded with its trailing shapes."""
    from object_detection_torch2_tpu.data.loader import DataLoader as JaxDataLoader

    ds = loader_records
    for rank in range(procs):
        if mode == "serving":
            ours = DataLoader(ds, 4, drop_last=False, max_gt=8)
            ours._num_procs, ours._proc = procs, rank
            kw = {"drop_last": False}
        else:
            kw = {"shuffle": True, "seed": 5, "stack_steps": 2 if mode == "stack_steps" else 1}
            ours = DataLoader(ds, 4, mesh=Mesh(rank, procs, torch.device("cpu")), max_gt=8, **kw)
        jx = JaxDataLoader(ds, 4, max_gt=8, **kw)
        jx._num_procs, jx._proc = procs, rank
        for epoch in range(2):
            got_idx, want_idx = list(ours._index_batches()), list(jx._index_batches())
            assert [i.tolist() for i in got_idx] == [i.tolist() for i in want_idx]
            ours.epoch, jx.epoch = epoch, epoch
            got, want = list(ours), list(jx)
            assert len(got) == len(want) > 0
            for (gi, gg), (wi, wg) in zip(got, want):
                np.testing.assert_array_equal(gi, np.asarray(wi))
                np.testing.assert_array_equal(gg, np.asarray(wg))
            if mode == "serving" and rank == procs - 1 and procs == 4:
                assert got[-1][0].shape == (0, 16, 16, 3)  # the empty final slice
            if mode == "stack_steps":
                assert got[0][0].shape[:2] == (2, 4 // procs)


@pytest.fixture(scope="module")
def loader_records(tmp_path_factory):
    """10 seeded records at imsize 16, written with numpy."""
    import json

    from object_detection_torch2_tpu.utils.testing import synth_targets

    out = tmp_path_factory.mktemp("loader_records")
    rng = np.random.default_rng(2)
    np.save(out / "images.npy", rng.integers(0, 256, (10, 16, 16, 3), dtype=np.uint8))
    np.save(out / "gts.npy", synth_targets(rng, 10, rng.integers(1, 9, 10), 8))
    (out / "meta.json").write_text(json.dumps({"imsize": 16, "max_gt": 8, "count": 10, "purpose": "detection",
                                               "sources": [], "list_file": ""}))
    return RecordDataset(out)


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_global_draws_keep_the_rank_rows(rank):
    """A rank's augment draws and dropout masks are the rows of one
    process's draws for the whole batch: `augment_batch(total=, offset=)`
    and `dropout(total=, offset=)` on rows [2 * rank, 2 * rank + 2) of 6
    equal those rows of the 6-row call on the same generator state."""
    from object_detection_torch2_tpu_torch.data.augment import augment_batch
    from object_detection_torch2_tpu_torch.models.vgg16 import dropout

    images, targets = _u8_batch()
    images = torch.from_numpy(np.concatenate([images, images[:2]])[:, :64, :64])
    targets = torch.from_numpy(np.concatenate([targets, targets[:2]]))
    rows = slice(2 * rank, 2 * rank + 2)
    whole = augment_batch(torch.Generator().manual_seed(3), images, targets)
    part = augment_batch(torch.Generator().manual_seed(3), images[rows], targets[rows], total=6, offset=2 * rank)
    for got, want in zip(part, whole):
        assert torch.equal(got, want[rows])
    x = torch.rand(6, 5, 7)
    want = dropout(x, 0.5, torch.Generator().manual_seed(4))[rows]
    assert torch.equal(dropout(x[rows], 0.5, torch.Generator().manual_seed(4), total=6, offset=2 * rank), want)


def _failing_rank(mesh):
    import time

    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(100)  # rank 0 would wait far longer than the launch takes to end it


def test_a_failing_rank_fails_the_launch():
    """A rank that raises ends the others and the launch raises with its
    error, at once: no rank is left running, nothing is hidden."""
    import time

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        mesh_lib.launch(_failing_rank, 2, device_type="cpu", timeout=120)
    assert time.monotonic() - t0 < 60


def test_mesh_refusals(monkeypatch):
    """No fallback: --distributed without torchrun's environment, NCCL for
    the CPU and a mesh without a process group all raise. `local_rows` is
    the rank's contiguous slice."""
    for var in mesh_lib.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh_lib.init_distributed(device="cpu")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        mesh_lib.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.init_process(0, 1, Path("/nonexistent/store"), backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_mesh("cpu")
    rows = np.arange(8)
    assert local_rows(rows, Mesh(1, 4, torch.device("cpu"))).tolist() == [2, 3]
    assert local_rows(rows, None) is rows

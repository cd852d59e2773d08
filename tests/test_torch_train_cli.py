"""The port's training CLI on the CPU, at imsize 264 and batch 2 on the
fixture tree (4 trainval images: 2 steps an epoch; 4 test images: 2
validation batches): its artifacts, its full-state resume against an
uninterrupted run, `--steps_per_dispatch 2` against 1, the Q7 resume from a
JAX-written params.json, and two steps of the slice as a whole against the
JAX package's `Trainer` on the same loader batches from the same JAX-written
weights."""

import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.cli.train import resolve_resume as jax_resolve_resume
from object_detection_torch2_tpu.core.anchors import default_boxes as jax_default_boxes
from object_detection_torch2_tpu.core.anchors import feature_grids_for as jax_grids
from object_detection_torch2_tpu.data.loader import DataLoader as JaxDataLoader
from object_detection_torch2_tpu.data.voc import PascalVOCDataset as JaxVOC
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu.train import Trainer as JaxTrainer
from object_detection_torch2_tpu.train import adam_torch as jax_adam
from object_detection_torch2_tpu.train import checkpoint as jax_ckpt
from object_detection_torch2_tpu.train import exponential_epoch_schedule as jax_schedule
from object_detection_torch2_tpu.utils.testing import fingerprint_tree
from object_detection_torch2_tpu_torch.cli import train
from object_detection_torch2_tpu_torch.models.convert import jax_path, jax_variables_from_state_dict, to_jax_layout
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt
from object_detection_torch2_tpu_torch.utils.tb import _masked_crc

torch.set_num_threads(1)

IMSIZE = 264
FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"
BASE = ["--data_dirs", str(FIXTURE), "--imsize", str(IMSIZE), "--batch_size", "2", "--dtype", "float32",
        "--num_workers", "0", "--device", "cpu"]


def _run(tmp: Path, *flags, orbax=True):
    """cli.train.main with its result, log and full-state directories in tmp."""
    args = BASE + ["--result_dir", str(tmp / "result"), "--log_dir", str(tmp / "logs")] + list(flags)
    if orbax:
        args += ["--orbax_dir", str(tmp / "state")]
    return train.main(args)


def _full_state(tmp: Path, step: int) -> dict:
    return torch.load(tmp / "state" / str(step) / ckpt.STATE_FILE, weights_only=True)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


# --------------------------------------------------------------------- resume


@pytest.mark.parametrize("params,base_lr,orbax,explicit", [
    (None, 0.001, False, False),
    (None, 0.002, True, True),
    ({"min_loss": 3.0, "lr": 0.0009, "last_epoch": 2}, 0.001, False, False),  # Q7: fresh optimizer
    ({"min_loss": 3.0, "lr": 0.0009, "last_epoch": 2, "base_lr": 0.001}, 0.001, True, False),  # exact resume
    ({"min_loss": 3.0, "lr": 0.0009, "last_epoch": 2, "base_lr": 0.001}, 0.005, True, True),  # explicit --lr
    ({"min_loss": 3.0, "lr": 0.0009, "last_epoch": 2, "base_lr": 0.001}, 0.001, True, True),  # explicit, same
    ({"min_loss": 3.0, "lr": 0.0009, "last_epoch": 2}, 0.001, True, False),  # no recorded base_lr
    ({"min_loss": 3.0, "lr": 0.001, "last_epoch": 2}, 0.001, True, False),
    ({"min_loss": 3.0, "lr": 0.0009, "last_epoch": 4, "base_lr": 0.002}, 0.001, False, True),
])
def test_resolve_resume_matches_jax(params, base_lr, orbax, explicit, capsys):
    got = train.resolve_resume(params, base_lr, orbax, explicit)
    ours = capsys.readouterr().out
    assert got == jax_resolve_resume(params, base_lr, orbax, explicit)
    assert ours == capsys.readouterr().out


# ------------------------------------------------------ artifacts and resume


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A: 2 epochs with the full state (train augment on, validation
    un-augmented so that the whole state is comparable), then 1 more resumed
    from it; B: 3 epochs straight in a fresh directory; C: 1 epoch at
    --steps_per_dispatch 2."""
    a, b, c = (tmp_path_factory.mktemp(n) for n in "abc")
    flags = ["--val_aug", "none"]
    first = _run(a, "--epochs", "2", *flags)
    params_after_2 = json.loads((a / "result" / "detection" / "params.json").read_text())
    resumed = _run(a, "--epochs", "1", *flags)
    straight = _run(b, "--epochs", "3", *flags)
    dispatch2 = _run(c, "--epochs", "1", "--steps_per_dispatch", "2", *flags)
    return {"a": a, "b": b, "c": c, "first": first, "params_after_2": params_after_2, "resumed": resumed,
            "straight": straight, "dispatch2": dispatch2}


def read_scalars(log_dir: Path) -> list:
    """(tag, value, step) of every scalar in the event files of log_dir (one
    per run, in name order), each record's length and payload checked
    against its masked crc32c."""
    return [r for path in sorted(log_dir.glob("events.out.tfevents.*")) for r in _read_event_file(path)]


def _read_event_file(path: Path) -> list:
    data, pos, out = path.read_bytes(), 0, []

    def varint(buf, i):
        shift = value = 0
        while True:
            b = buf[i]
            value |= (b & 0x7F) << shift
            i, shift = i + 1, shift + 7
            if not b & 0x80:
                return value, i

    def fields(buf):
        i = 0
        while i < len(buf):
            key, i = varint(buf, i)
            wire = key & 7
            if wire == 0:
                v, i = varint(buf, i)
            elif wire == 1:
                v, i = buf[i:i + 8], i + 8
            elif wire == 5:
                v, i = buf[i:i + 4], i + 4
            else:
                n, i = varint(buf, i)
                v, i = buf[i:i + n], i + n
            yield key >> 3, v

    first = True
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == _masked_crc(header)
        payload = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == _masked_crc(payload)
        pos += 16 + n
        event = dict(fields(payload))
        if first:
            assert event[3] == b"brain.Event:2"
            first = False
            continue
        value = dict(fields(dict(fields(event[5]))[1]))
        out.append((value[1].decode(), struct.unpack("<f", value[2])[0], event[2]))
    return out


def test_artifacts_of_a_run(runs):
    """params.json and phase_times.json of the 2-epoch run; weights.msgpack
    (loaded by the JAX package: the state of the last improved epoch, float32
    leaves) and the full states after the resumed epoch."""
    a, first = runs["a"], runs["first"]
    params = runs["params_after_2"]
    epoch_means = [float(l.mean()) for l in first["losses"]]
    assert [len(l) for l in first["losses"]] == [2, 2]
    assert params["min_loss"] == pytest.approx(min(epoch_means), rel=0, abs=0)
    best = int(np.argmin(epoch_means)) + 1
    assert params["last_epoch"] == best and params["base_lr"] == 0.001 and params["steps_per_epoch"] == 2
    assert params["lr"] == 0.001 * 0.95 ** (best - 1)

    # the resumed third epoch has since written both files again
    assert sorted(int(p.name) for p in (a / "state").iterdir()) == [2, 4, 6]
    last = json.loads((a / "result" / "detection" / "params.json").read_text())["last_epoch"]
    jax_weights = jax_ckpt.load_weights(a / "result" / "detection" / "weights.msgpack")
    want = jax_variables_from_state_dict(_full_state(a, 2 * last)["model"])
    for coll in ("params", "batch_stats"):
        assert jax_weights[coll].keys() == want[coll].keys()
        for layer, leaves in want[coll].items():
            for leaf, v in leaves.items():
                got = np.asarray(jax_weights[coll][layer][leaf])
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, v, err_msg=f"{coll}/{layer}/{leaf}")

    rows = json.loads((a / "logs" / "phase_times.json").read_text())
    assert [r["epoch"] for r in rows] == [3]  # the resumed run rewrote it
    assert [r["epoch"] for r in first["phase_times"]] == [1, 2]
    assert set(rows[0]) == {"epoch", "train_s", "val_s", "save_s", "total_s", "img_per_s_train_loop",
                            "img_per_s_wall"}


def test_event_scalars_per_epoch(runs):
    """loss/train, loss/validation and lr for each epoch, as float32: the
    straight run's three epochs, its lr decaying per epoch."""
    scalars = read_scalars(runs["b"] / "logs")
    straight = runs["straight"]
    want = []
    for epoch in range(1, 4):
        want += [("loss/train", np.float32(float(straight["losses"][epoch - 1].mean())), epoch),
                 ("loss/validation", np.float32(straight["val_losses"][epoch - 1]), epoch),
                 ("lr", np.float32(0.001 * 0.95 ** (epoch - 1)), epoch)]
    assert scalars == want


def test_full_state_resume_is_bit_equal_to_an_uninterrupted_run(runs):
    """2 epochs + 1 resumed from the full state against 3 straight, with the
    train augment on: the third epoch's losses, the full states (weights, BN
    statistics, Adam moments and step) and the weights files bit-equal; the
    resumed epoch's lr continues the decay (the Q7 fix)."""
    resumed, straight = runs["resumed"], runs["straight"]
    assert torch.equal(resumed["losses"][0], straight["losses"][2])
    assert resumed["val_losses"] == straight["val_losses"][2:]
    assert resumed["state"].step == straight["state"].step == 6
    _assert_trees_equal(_full_state(runs["a"], 6), _full_state(runs["b"], 6))
    assert ((runs["a"] / "result" / "detection" / "weights.msgpack").read_bytes()
            == (runs["b"] / "result" / "detection" / "weights.msgpack").read_bytes())
    lrs = [v for tag, v, step in read_scalars(runs["a"] / "logs") if tag == "lr" and step == 3]
    assert lrs == [np.float32(0.001 * 0.95 ** 2)]
    assert not torch.equal(straight["losses"][0], straight["losses"][1])


def test_steps_per_dispatch_2_equals_1(runs):
    """One epoch through train_steps(K = 2) gives the losses and the full
    state of the same epoch taken step by step."""
    assert torch.equal(runs["dispatch2"]["losses"][0], runs["first"]["losses"][0])
    _assert_trees_equal(_full_state(runs["c"], 2), _full_state(runs["a"], 2))


def test_q7_resume_from_a_jax_params_json(tmp_path):
    """A params.json the JAX package wrote, without a full state: the
    reference's resume (quirk Q7) starts a fresh optimizer at the recorded,
    decayed lr and numbers the epochs on from last_epoch."""
    params = tmp_path / "result" / "detection" / "params.json"
    jax_ckpt.save_params_json(params, 1e9, 0.0009025, 2, base_lr=0.001, steps_per_epoch=2)
    out = _run(tmp_path, "--epochs", "1", orbax=False)
    assert out["state"].step == 2
    saved = json.loads(params.read_text())
    assert saved["last_epoch"] == 3 and saved["lr"] == 0.0009025 and saved["base_lr"] == 0.0009025
    assert [(t, s) for t, _, s in read_scalars(tmp_path / "logs")] == [("loss/train", 3), ("loss/validation", 3),
                                                                       ("lr", 3)]
    assert read_scalars(tmp_path / "logs")[2][1] == np.float32(0.0009025)


# ------------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def jax_two_steps(tmp_path_factory):
    """JAX init variables written as a weights.msgpack by the JAX package;
    the port's CLI for 2 steps from them (augment off) and the JAX Trainer's
    2 steps on the same loader batches."""
    tmp = tmp_path_factory.mktemp("vs_jax")
    jmodel = JaxSSD(num_classes=21)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, IMSIZE, IMSIZE, 3)), train=False))(
        jax.random.PRNGKey(0))
    variables = jax.tree.map(np.asarray, variables)
    jax_ckpt.save_weights(tmp / "result" / "detection" / "weights.msgpack", variables)
    jax_ckpt.save_weights(tmp / "w0.msgpack", variables)
    port = _run(tmp, "--train_aug", "none", "--val_aug", "none", "--steps_per_epoch", "2", "--epochs", "1",
                orbax=False)

    trainer = JaxTrainer(jmodel, loss_kind="multibox", default_boxes=jax_default_boxes(jax_grids(IMSIZE)))
    tx = jax_adam(jax_schedule(0.001, 0.95, 2), weight_decay=0.0005)
    state = trainer.init_state(jax.random.PRNGKey(0), jnp.zeros((1, IMSIZE, IMSIZE, 3)), tx,
                               is_trainable=JaxSSD.is_trainable, variables=jax.tree.map(jnp.asarray, variables))
    loader = JaxDataLoader(JaxVOC("detection", [FIXTURE], "trainval.txt", IMSIZE), 2, shuffle=True, seed=0,
                           max_gt=64)
    losses = []
    for images, gts in loader:
        state, loss = trainer.train_step(state, jnp.asarray(images), jnp.asarray(gts))
        losses.append(float(loss))
    return tmp, port, state, losses


def test_two_steps_match_the_jax_trainer(jax_two_steps):
    """Losses within rtol 1e-4 (the trajectory's step-0 pin). Trained
    weights, read back from the port's weights.msgpack: every trainable
    tensor within the trajectory's parameter budget, |d fingerprint| <=
    5e-3 * L2 + 1e-2 (tests/test_trajectory.py::test_final_params). At batch
    2 and imsize 264 the extras' batch statistics come from 2-18 values per
    channel, so f32 reduction-order noise moves their small gradients and
    flips Adam's ~sign(g) * lr first steps (the conv biases before a BN have
    a true gradient of 0: their updates are noise in both frameworks). The
    heads, whose gradients are well conditioned, are held tighter: the L2 of
    the difference of the two updates within 5% of the JAX update's."""
    tmp, port, jstate, jlosses = jax_two_steps
    np.testing.assert_allclose(port["losses"][0].numpy(), jlosses, rtol=1e-4)
    written = ckpt.load_weights(tmp / "result" / "detection" / "weights.msgpack")["params"]
    saved = {layer: written[layer] for layer in jstate.params}
    want = jax.tree.map(np.asarray, jstate.params)
    keys, got_fp = fingerprint_tree(saved)
    want_keys, want_fp = fingerprint_tree(want)
    assert list(keys) == list(want_keys)
    budget = 5e-3 * want_fp[:, 0] + 1e-2
    absd = np.abs(got_fp - want_fp).max(axis=1)
    assert (absd <= budget).all(), keys[(absd / budget).argmax()]

    w0 = jax_ckpt.load_weights(tmp / "w0.msgpack")["params"]
    for layer in (k for k in want if k.startswith("det_")):
        for leaf in want[layer]:
            a, b = saved[layer][leaf] - w0[layer][leaf], want[layer][leaf] - w0[layer][leaf]
            assert np.linalg.norm(a - b) <= 0.05 * np.linalg.norm(b), f"{layer}/{leaf}"
    for name, p in port["state"].trainable.items():
        layer, leaf = jax_path(name)
        np.testing.assert_array_equal(saved[layer][leaf], to_jax_layout(p))


def test_orbax_layout_raises(jax_two_steps, tmp_path):
    """A directory holding the JAX package's orbax checkpoint is refused with
    a clear error, not ignored."""
    _, _, jstate, _ = jax_two_steps
    jax_ckpt.save_train_state(tmp_path / "state", jstate)
    with pytest.raises(ValueError, match="orbax"):
        ckpt.latest_orbax_step(tmp_path / "state")
    with pytest.raises(ValueError, match="orbax"):
        _run(tmp_path, "--epochs", "1")


# ---------------------------------------------------------------- classification


def test_classification_purpose_seeds_the_ssd_trunk(tmp_path):
    """`--purpose classification` trains VGG16 on the fixture's object crops
    at imsize 200 for 2 steps (finite losses, the dead 1000-way head
    unchanged and without Adam moments) and writes
    <result_dir>/classification/weights.msgpack (the JAX package's layout,
    tests/test_torch_vgg.py); `build_ssd` then takes the SSD's trunk from it
    bit for bit."""
    from object_detection_torch2_tpu_torch.cli import common
    from object_detection_torch2_tpu_torch.models.convert import vgg16_state_dict_from_jax_variables
    from object_detection_torch2_tpu_torch.models.vgg16 import VGG16

    args = ["--purpose", "classification", "--data_dirs", str(FIXTURE), "--imsize", "200", "--batch_size", "2",
            "--dtype", "float32", "--num_workers", "0", "--device", "cpu", "--steps_per_epoch", "2",
            "--result_dir", str(tmp_path / "result"), "--log_dir", str(tmp_path / "logs")]
    out = train.main(args)
    state = out["state"]
    assert state.step == 2 and bool(torch.isfinite(out["losses"][0]).all()) and np.isfinite(out["val_losses"][0])
    init = VGG16(num_classes=20, transfer_learning=True).state_dict()
    for name, p in state.frozen.items():
        assert name.startswith("classifier_fc") and torch.equal(p, init[name]), name
    assert set(state.optimizer.state) == set(state.trainable.values()) and len(state.trainable) == 58
    path = tmp_path / "result" / "classification" / "weights.msgpack"
    vgg = vgg16_state_dict_from_jax_variables(ckpt.load_weights(path))
    for name, t in state.model.state_dict().items():
        assert torch.equal(vgg[name], t.cpu()) or name.endswith("num_batches_tracked"), name

    ssd_args = train.parse_args(["--result_dir", str(tmp_path / "result"), "--dtype", "float32"])
    model, _ = common.build_ssd(ssd_args, tmp_path / "result" / "detection" / "weights.msgpack")
    sd = model.state_dict()
    trunk = [k for k in vgg if k.startswith("features.") and not k.endswith("num_batches_tracked")]
    assert len(trunk) == 13 * 6
    for k in trunk:
        assert torch.equal(sd[k], vgg[k]), k
    seeded = type(model)(num_classes=21, seed=0).state_dict()
    assert all(torch.equal(sd[k], seeded[k]) for k in sd if k.startswith("detectors."))
    path.unlink()  # 1.03 GB: not kept in the temporary directory


def test_classification_records_purpose_is_checked(tmp_path):
    """Records packed for detection are refused for --purpose classification."""
    from object_detection_torch2_tpu_torch.data.records import pack_voc

    pack_voc([FIXTURE], "trainval.txt", tmp_path / "rec", imsize=200, max_gt=8, log_every=0)
    with pytest.raises(SystemExit, match="packed for detection"):
        train.main(["--purpose", "classification", "--records_dir", str(tmp_path / "rec"), "--imsize", "200",
                    "--device", "cpu", "--result_dir", str(tmp_path / "r"), "--log_dir", str(tmp_path / "l")])


def test_orbax_dir_sets_cudnn_deterministic_for_the_run(tmp_path, monkeypatch):
    """With --orbax_dir the run trains under cuDNN's deterministic algorithms
    (an exact resume on the card needs them) and restores the caller's
    setting after, even when the run raises; without it the caller's setting
    stands."""
    seen = []

    def spy(*a):
        seen.append(torch.backends.cudnn.deterministic)
        raise RuntimeError("stop")

    monkeypatch.setattr(train, "_train", spy)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    for orbax in (True, False):
        with pytest.raises(RuntimeError, match="stop"):
            _run(tmp_path, "--epochs", "1", orbax=orbax)
    assert seen == [True, False] and torch.backends.cudnn.deterministic is False


# ---------------------------------------------------------------- refusals


@pytest.mark.parametrize("flags,item", [(["--distributed"], "G"), (["--num_devices", "2"], "G")])
def test_unported_flags_raise(tmp_path, flags, item):
    """The flags of ROADMAP Queue 1 item G (data parallelism), ported: the
    refusals that remain. --distributed without torchrun's environment
    raises; --num_devices 2 with a global batch that does not divide over 2
    raises with the JAX CLI's message (tests/test_torch_parallel_cli.py
    trains on 2 processes). Nothing is written."""
    if flags == ["--distributed"]:
        with pytest.raises(RuntimeError, match="torchrun"):
            _run(tmp_path, *flags, orbax=False)
    else:
        with pytest.raises(ValueError, match="batch_size 3 must divide over 2 devices"):
            _run(tmp_path, *flags, "--batch_size", "3", orbax=False)
    assert item == "G" and not (tmp_path / "logs").exists()


@pytest.mark.parametrize("flags", [["--train_trunk"], ["--purpose", "classification"]])
def test_trunk_int8_needs_the_frozen_detection_trunk(tmp_path, flags):
    """--trunk_int8 runs the frozen detection trunk as int8: with
    --train_trunk it exits with the JAX CLI's text, and the classification
    purpose (no frozen trunk) refuses it too."""
    with pytest.raises(SystemExit, match="frozen trunk|detection purpose"):
        _run(tmp_path, "--trunk_int8", *flags, orbax=False)


def test_without_device_needs_a_card(tmp_path):
    """No --device: the CLI runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is available")
    args = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(args + ["--result_dir", str(tmp_path / "r"), "--log_dir", str(tmp_path / "l")])
    assert not (tmp_path / "l").exists()


def test_debug_nans_raises_on_a_non_finite_loss(tmp_path, monkeypatch):
    """With --debug_nans a non-finite step loss stops the run."""
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "train_step", lambda self, state, images, targets: torch.tensor(float("nan")))
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            _run(tmp_path, "--debug_nans", orbax=False)
    finally:
        torch.autograd.set_detect_anomaly(False)

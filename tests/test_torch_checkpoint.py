"""The port's weights files against flax and the JAX package on the CPU:
`train/_msgpack.py` reads what `flax.serialization.msgpack_serialize` writes
and writes the same bytes, `train/checkpoint.py` round-trips weights and
params.json with the JAX package's, `cli.common.build_ssd` loads a JAX
checkpoint into the port's SSD, and a save killed before its rename leaves
the previous file whole (a resumed `cli.train` reads it). The kill-and-resume
CLI test is marked `slow`: chip_smoke.py's `phase_moved_training` holds it on
the card."""

import argparse
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu.train import checkpoint as jax_ckpt
from object_detection_torch2_tpu_torch.cli.common import build_ssd
from object_detection_torch2_tpu_torch.models.convert import (
    jax_variables_from_state_dict,
    ssd_state_dict_from_jax_variables,
)
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train import _msgpack
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

IMSIZE = 264


def _bf16_pair(values):
    """The same bfloat16 bits as a JAX array (flax's side) and a torch tensor (the port's)."""
    t = torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)
    return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16), t


def _cases():
    """name -> (tree for flax, the same tree for the port)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    jb, tb = _bf16_pair([[1.5, -2.25, 3e-3], [0.0, -0.0, 65504.0]])
    jb0, tb0 = _bf16_pair(7.0)
    plain = {
        "float32": {"w": f32},
        "int32": {"i": np.arange(-5, 5, dtype=np.int32)},
        "int64": {"i": np.array([-(1 << 40), 0, 1 << 40], np.int64)},
        "zero_d": {"a": np.array(2.5, np.float32), "b": np.array(-3, np.int64)},
        "np_scalars": {"a": np.float32(1.5), "b": np.int64(-7), "c": np.float64(0.25), "d": np.bool_(True)},
        "empty": {"a": np.zeros((0, 3), np.float32), "b": np.zeros((0,), np.int32)},
        # a (5,) uint8 payload is 16 bytes: a fixext 16 header; float64 and
        # uint16 and bool arrays of other widths land on ext 8/16/32 headers
        "fixext16": {"u": np.arange(5, dtype=np.uint8)},
        "ext_sizes": {"b": np.ones(200, np.bool_), "h": np.arange(300, dtype=np.uint16),
                      "d": np.linspace(0, 1, 9000)},
        "nested_unsorted": {"z": {"y": {"x": f32[0]}, "a": np.ones(2, np.float32)}, "b": {},
                            "m": {f"k{i:02d}": np.int32(i) for i in range(20)}},
        "python": {"ints": [0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32, -1, -32, -33, -128,
                            -129, -32768, -32769, -(1 << 31), -(1 << 31) - 1],
                   "f": 2.5, "s": "x" * 40, "t": True, "n": None, "bin": bytes(range(256)) * 2,
                   "l": list(range(20))},
    }
    cases = {name: (tree, tree) for name, tree in plain.items()}
    cases["bfloat16"] = ({"w": jb, "s": jb0}, {"w": tb, "s": tb0})
    return cases


CASES = _cases()


def _assert_same(got, want):
    """The port's tree `got` equals flax's `want`, leaf bits and dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_reads_flax_bytes(name):
    flax_tree, _ = CASES[name]
    data = serialization.msgpack_serialize(flax_tree)
    _assert_same(_msgpack.unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("name", sorted(CASES))
def test_writes_flax_bytes(name):
    flax_tree, port_tree = CASES[name]
    data = _msgpack.packb(port_tree)
    assert data == serialization.msgpack_serialize(flax_tree)
    _assert_same(_msgpack.unpackb(data), serialization.msgpack_restore(data))


def test_fixext_headers():
    """fixext 1/2/4/8/16 and ext 8/16/32 headers carry their payload length;
    an ext type other than ndarray (1) or numpy scalar (3) is refused with it."""
    for head, n in ((b"\xd4", 1), (b"\xd5", 2), (b"\xd6", 4), (b"\xd7", 8), (b"\xd8", 16),
                    (b"\xc7\x03", 3), (b"\xc8\x00\x05", 5), (b"\xc9\x00\x00\x00\x06", 6)):
        with pytest.raises(ValueError, match=f"ext type 5 \\({n} bytes\\)"):
            _msgpack.unpackb(head + b"\x05" + bytes(n))
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(b"\xd8\x01" + bytes(15))
    with pytest.raises(ValueError, match="trailing"):
        _msgpack.unpackb(b"\xc0\xc0")


def test_chunked_leaf_is_refused():
    data = serialization.msgpack_serialize({"w": serialization._chunk(np.arange(10, dtype=np.float32))})
    with pytest.raises(ValueError, match="chunked"):
        _msgpack.unpackb(data)


@pytest.mark.parametrize("extra", [{}, {"base_lr": 1e-3, "steps_per_epoch": 17}])
def test_params_json_round_trip(tmp_path, extra):
    args = dict(min_loss=1.25, lr=3e-4, last_epoch=4, **extra)
    ckpt.save_params_json(tmp_path / "port.json", **args)
    jax_ckpt.save_params_json(tmp_path / "jax.json", **args)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert ckpt.load_params_json(tmp_path / "jax.json") == jax_ckpt.load_params_json(tmp_path / "port.json")
    assert ckpt.load_params_json(tmp_path / "absent.json") is None


def _args(tmp_path, dtype="float32"):
    return argparse.Namespace(dtype=dtype, result_dir=str(tmp_path), weights="weights.msgpack")


def test_build_ssd_load_order(tmp_path):
    """No weights: the seeded init. VGG16 classification weights only: the
    seeded init with the trunk (blocks 1-5) taken from them."""
    seeded = SSD(seed=0).state_dict()
    model, _ = build_ssd(_args(tmp_path, "bfloat16"), tmp_path / "detection" / "weights.msgpack")
    assert model.dtype == torch.bfloat16
    for k, v in model.state_dict().items():
        assert torch.equal(v, seeded[k]), k

    vgg = jax_variables_from_state_dict(SSD(seed=1).state_dict())
    vgg["params"]["classifier_fc1"] = {"kernel": np.ones((4, 2), np.float32), "bias": np.zeros(2, np.float32)}
    jax_ckpt.save_weights(tmp_path / "classification" / "weights.msgpack", vgg)
    model, _ = build_ssd(_args(tmp_path), tmp_path / "detection" / "weights.msgpack")
    other = SSD(seed=1).state_dict()
    for k, v in model.state_dict().items():
        trunk = not SSD.is_trainable(k)
        assert torch.equal(v, (other if trunk else seeded)[k]), k


class _Killed(BaseException):
    """A kill landing in a save, before its rename."""


def _killed_replace(*args):
    raise _Killed


@pytest.mark.parametrize("what", ["weights", "params"])
def test_an_interrupted_save_leaves_the_old_file(tmp_path, monkeypatch, what):
    """Each save writes the JAX package's bytes (through a temporary file
    renamed over the target); a save killed before its rename leaves the
    previous file whole and readable, and the next save, over the partial
    temporary file it left, writes the new bytes."""
    rng = np.random.default_rng(3)
    trees = [{"params": {"conv": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32)}},
              "batch_stats": {"bn": {"mean": rng.standard_normal(4).astype(np.float32)}}} for _ in range(2)]
    args = [dict(min_loss=1.25, lr=3e-4, last_epoch=4, base_lr=1e-3, steps_per_epoch=17),
            dict(min_loss=0.5, lr=2e-4, last_epoch=6, base_lr=1e-3, steps_per_epoch=17)]
    if what == "weights":
        def port(path, k):
            ckpt.save_weights(path, trees[k])

        def jax_writer(path, k):
            jax_ckpt.save_weights(path, trees[k])
        read = ckpt.load_weights
    else:
        def port(path, k):
            ckpt.save_params_json(path, **args[k])

        def jax_writer(path, k):
            jax_ckpt.save_params_json(path, **args[k])
        read = ckpt.load_params_json
    path = tmp_path / "out" / "file"
    for k in (0, 1):
        jax_writer(tmp_path / f"jax{k}", k)
    port(path, 0)
    assert path.read_bytes() == (tmp_path / "jax0").read_bytes()
    with monkeypatch.context() as m:
        m.setattr(ckpt.os, "replace", _killed_replace)
        with pytest.raises(_Killed):
            port(path, 1)
    assert path.read_bytes() == (tmp_path / "jax0").read_bytes()
    read(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(tmp.read_bytes()[:7])  # a kill mid-write leaves part of it
    port(path, 1)
    assert path.read_bytes() == (tmp_path / "jax1").read_bytes() and not tmp.exists()


@pytest.mark.slow
def test_resume_after_a_kill_in_a_weights_save(tmp_path, monkeypatch, capsys):
    """cli.train killed inside epoch 2's weights save (before the rename) and
    resumed from the full state: the resumed run reads epoch 1's weights
    file, whole, restores the full state of epoch 1 and trains epoch 2."""
    from object_detection_torch2_tpu_torch.cli import train

    fixture = str(Path(__file__).parent / "fixtures" / "voc" / "VOCtest")
    argv = ["--data_dirs", fixture, "--imsize", str(IMSIZE), "--batch_size", "2", "--dtype", "float32",
            "--num_workers", "0", "--device", "cpu", "--steps_per_epoch", "1", "--train_aug", "none",
            "--val_aug", "none", "--result_dir", str(tmp_path / "r"), "--log_dir", str(tmp_path / "logs"),
            "--orbax_dir", str(tmp_path / "state")]
    weights = tmp_path / "r" / "detection" / "weights.msgpack"
    train.main(argv + ["--epochs", "1"])
    epoch1 = weights.read_bytes()
    with monkeypatch.context() as m:
        m.setattr(ckpt.os, "replace", _killed_replace)
        with pytest.raises(_Killed):
            train.main(argv + ["--epochs", "1"])
    assert weights.read_bytes() == epoch1 and sorted(p.name for p in (tmp_path / "state").iterdir()) == ["1"]
    read = []
    real_load = ckpt.load_weights
    monkeypatch.setattr(ckpt, "load_weights", lambda path: read.append(Path(path).read_bytes()) or real_load(path))
    capsys.readouterr()
    out = train.main(argv + ["--epochs", "1"])
    printed = capsys.readouterr().out
    assert read == [epoch1]
    assert "Full state restored (exact optimizer resume)." in printed and "[Epoch 2/2]" in printed
    assert len(out["phase_times"]) == 1 and out["state"].step == 2
    assert weights.read_bytes() != epoch1 and sorted(p.name for p in (tmp_path / "state").iterdir()) == ["1", "2"]


# The tests below take the JAX package's seeded init, a jitted program that
# tests/test_torch_parallel.py, test_torch_evaluate.py and test_torch_train_cli.py
# compile too: placed last, they usually find it in the persistent compile cache.


@pytest.fixture(scope="module")
def jax_init():
    jmodel = JaxSSD(num_classes=21)
    # one program, compiled at XLA's backend optimization level 1: a third of
    # the default level's compile CPU, the same variables bit for bit
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, IMSIZE, IMSIZE, 3)), train=False))
    key = jax.random.PRNGKey(0)
    variables = init.lower(key).compile(compiler_options={"xla_backend_optimization_level": 1})(key)
    return jmodel, jax.tree.map(np.asarray, variables)


def test_jax_weights_file_loads_into_build_ssd(tmp_path, jax_init):
    """The JAX package's init variables, saved by its save_weights, loaded by
    the port's build_ssd: the forward agrees with the JAX forward within
    tests/test_torch_models.py's tolerances (rtol 1e-4, atol 1e-4), and the
    port's save_weights of that model writes the JAX package's file byte for
    byte."""
    jmodel, variables = jax_init
    path = tmp_path / "detection" / "weights.msgpack"
    jax_ckpt.save_weights(path, variables)
    model, labelmap = build_ssd(_args(tmp_path), path)
    assert len(labelmap) == 20 and model.dtype == torch.float32
    x = np.random.default_rng(9).uniform(0, 1, (1, IMSIZE, IMSIZE, 3)).astype(np.float32)
    forward = jax.jit(lambda v, images: jmodel.apply(v, images, train=False, use_batch_stats=False))
    want = np.asarray(forward(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), use_batch_stats=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    ckpt.save_weights(tmp_path / "port.msgpack", model)
    assert (tmp_path / "port.msgpack").read_bytes() == path.read_bytes()
    back = jax_ckpt.load_weights(tmp_path / "port.msgpack")
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables), strict=True):
        np.testing.assert_array_equal(a, b)


def test_state_dict_converters_invert_each_other(jax_init):
    """jax -> state_dict -> jax is the identity bit for bit, and so is
    state_dict -> jax -> state_dict on the port's seeded model."""
    _, variables = jax_init
    back = jax_variables_from_state_dict(ssd_state_dict_from_jax_variables(variables))
    assert sorted(back) == sorted(variables)
    for coll in variables:
        assert sorted(back[coll]) == sorted(variables[coll])
        for layer, leaves in variables[coll].items():
            assert sorted(back[coll][layer]) == sorted(leaves)
            for leaf, v in leaves.items():
                got = back[coll][layer][leaf]
                assert got.dtype == v.dtype and got.flags.c_contiguous
                np.testing.assert_array_equal(got, v)
    sd = SSD(seed=3).state_dict()
    again = ssd_state_dict_from_jax_variables(jax_variables_from_state_dict(sd))
    assert list(again) == list(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_bfloat16_weights_file_loads(tmp_path, jax_init):
    """A weights file whose leaves are bfloat16 (written by the JAX package)
    loads as torch.bfloat16 leaves, and `build_ssd` gives the model those
    values in its float32 parameters."""
    _, variables = jax_init
    half = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), variables)
    path = tmp_path / "detection" / "weights.msgpack"
    jax_ckpt.save_weights(path, half)
    leaf = ckpt.load_weights(path)["params"]["conv_1_1"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    model, _ = build_ssd(_args(tmp_path), path)
    want = half["params"]["det_4_3"]["kernel"].astype(np.float32).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(model.state_dict()["detectors.det_4_3.weight"].numpy(), want)

"""The port's VGG16 (models/vgg16.py), its converters and its weights file
against the reference goldens and the JAX package: the forward golden
(goldens/vgg_forward.npz) at the JAX tests' tolerances, the JAX `VGG16` on the
same seeded inputs, `cross_entropy` against the Q2 golden, the converters and
the weights file bit for bit both ways, and the dropout. The layout and
dropout tests, port only at full width, are marked `slow`: chip_smoke.py's
`phase_moved_training` holds them on the card."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.models import convert as jax_convert
from object_detection_torch2_tpu.models.vgg16 import VGG16 as JaxVGG16
from object_detection_torch2_tpu.models.vgg16 import cross_entropy as jax_cross_entropy
from object_detection_torch2_tpu.models.vgg16 import vgg_trainable_predicate as jax_predicate
from object_detection_torch2_tpu.train import checkpoint as jax_ckpt
from object_detection_torch2_tpu.utils.testing import (
    synth_scaled_state_dict_from_manifest,
    synth_state_dict_from_manifest,
)
from object_detection_torch2_tpu_torch.models import convert
from object_detection_torch2_tpu_torch.models.vgg16 import VGG16, cross_entropy, dropout, vgg_trainable_predicate
from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

torch.set_num_threads(1)


def _nhwc(x_nchw):
    return np.ascontiguousarray(np.transpose(x_nchw, (0, 2, 3, 1)))


def _model(variables, **kwargs) -> VGG16:
    model = VGG16(num_classes=20, **kwargs)
    model.load_state_dict(convert.vgg16_state_dict_from_jax_variables(variables))
    return model.eval()


@pytest.fixture(scope="module")
def golden(goldens):
    """(golden, its reference-layout state_dict, the port's conversion of it,
    the golden's images NHWC, the port's VGG16 on those weights by
    transfer_learning flag: each built once, the golden's cases share it)."""
    g = goldens("vgg_forward")
    sd = synth_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    variables = convert.vgg16_variables_from_torch(sd)
    models = {}

    def model_of(transfer: bool) -> VGG16:
        if transfer not in models:
            models[transfer] = _model(variables, transfer_learning=transfer)
        return models[transfer]

    return g, sd, variables, torch.from_numpy(_nhwc(g["x"])), model_of


@pytest.mark.parametrize("transfer,use_batch_stats,key,atol", [
    (False, False, "out_eval", 5e-2),
    (True, False, "out_transfer", 5e-2),
    (False, True, "out_bn_batch", 5e-3),
])
def test_forward_matches_golden(golden, transfer, use_batch_stats, key, atol):
    """The reference's logits at the JAX tests' tolerances (running statistics
    at atol 5e-2 on logits up to 2.7e4, batch statistics at 5e-3)."""
    g, _, _, x, model_of = golden
    with torch.no_grad():
        out = model_of(transfer)(x, train=False, use_batch_stats=use_batch_stats)
    assert out.shape == (2, 20 if transfer else 1000) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), g[key], atol=atol)


def test_forward_matches_jax_vgg16(goldens):
    """The JAX VGG16 and the port's on the same seeded weights (the
    trajectory golden's kaiming-scaled recipe) and images at imsize 200,
    batch 2, float32, batch statistics: rtol 1e-4, atol 1e-4. The JAX
    forward is one jitted program, its arrays passed as its arguments."""
    g = goldens("vgg_trajectory")
    sd = synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    x = np.random.default_rng(200).uniform(0.0, 1.0, (2, 200, 200, 3)).astype(np.float32)
    jax_vars = jax.tree.map(jnp.asarray, jax_convert.vgg16_variables_from_torch(sd))
    jmodel = JaxVGG16(num_classes=20, transfer_learning=True)
    forward = jax.jit(lambda v, images: jmodel.apply(v, images, train=False, use_batch_stats=True,
                                                     mutable=["batch_stats"])[0])
    want = forward(jax_vars, jnp.asarray(x))
    with torch.no_grad():
        got = _model(convert.vgg16_variables_from_torch(sd), transfer_learning=True)(
            torch.from_numpy(x), train=False, use_batch_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("parity_sign", [True, False])
def test_cross_entropy_q2(goldens, parity_sign):
    """The reference's sign-flipped loss (Q2) with parity_sign, the proper
    cross-entropy without, rtol 1e-5; the same as the JAX package's."""
    g = goldens("vgg_forward")
    logits, onehot = torch.from_numpy(g["loss_logits"]), torch.from_numpy(g["loss_onehot"])
    got = float(cross_entropy(logits, onehot, parity_sign=parity_sign))
    want = float(g["loss"]) if parity_sign else -float(g["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jax_value = float(jax_cross_entropy(jnp.asarray(g["loss_logits"]), jnp.asarray(g["loss_onehot"]),
                                        parity_sign=parity_sign))
    np.testing.assert_allclose(got, jax_value, rtol=1e-6)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def _assert_trees_bit_equal(a, b):
    """Same paths, dtypes, shapes and bytes (a byte compare: the 0.4 GB
    leaves compare in memcmp time; numpy's report only if they differ)."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        if la[k].tobytes() != lb[k].tobytes():
            np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
            raise AssertionError(f"{k}: equal values, other bits (-0.0 or a NaN payload)")


def test_converters_bit_equal_to_jax(golden):
    """`vgg16_sequential_index_map` and `vgg16_variables_from_torch` give the
    JAX package's, bit for bit, on one reference state_dict; the port's
    state_dict round-trips through the JAX layout exactly."""
    _, sd, got, _, _ = golden
    assert convert.vgg16_sequential_index_map() == jax_convert.vgg16_sequential_index_map()
    want = jax_convert.vgg16_variables_from_torch(sd)
    _assert_trees_bit_equal(got, want)
    port_sd = convert.vgg16_state_dict_from_jax_variables(got)
    assert list(port_sd) == list(convert.vgg16_state_shapes())
    back = convert.jax_variables_from_vgg16_state_dict(port_sd)
    _assert_trees_bit_equal(back, want)
    again = convert.vgg16_state_dict_from_jax_variables(back)
    for k, v in port_sd.items():
        assert torch.equal(again[k], v), k
    with pytest.raises(ValueError, match="keys differ"):
        convert.jax_variables_from_vgg16_state_dict({k: v for k, v in port_sd.items() if "classifier2" not in k})


class _MemoryFile(io.BytesIO):
    """`open` for a module under test: files kept in `files`, by path."""

    files: dict = {}

    def __init__(self, path, mode="r", *args, **kwargs):
        self.path, self.mode = str(path), mode
        super().__init__(b"" if "w" in mode else self.files[self.path])

    def close(self):
        if "w" in self.mode and not self.closed:
            self.files[self.path] = self.getvalue()
        super().close()


def test_weights_file_byte_identical_both_ways(tmp_path, monkeypatch):
    """A VGG16's weights file: the port's save_weights writes the bytes the
    JAX package's save_weights writes for the same variables (so the JAX
    package loads it as its own), and the port loads the JAX package's file
    back to the model's state_dict bit for bit. Both packages' save_weights
    and the port's load_weights run whole, their files (1.03 GB each) in
    memory: `open` and the port's rename are replaced in their modules (the
    disk writes themselves are held byte for byte on the SSD's weights by
    tests/test_torch_checkpoint.py)."""
    files = {}
    monkeypatch.setattr(_MemoryFile, "files", files)
    for module in (jax_ckpt, ckpt):
        monkeypatch.setattr(module, "open", _MemoryFile, raising=False)
    monkeypatch.setattr(ckpt.os, "replace", lambda src, dst: files.__setitem__(str(dst), files.pop(str(src))))
    model = VGG16(num_classes=20, seed=3)
    jax_ckpt.save_weights(tmp_path / "jax.msgpack", convert.jax_variables_of(model))
    ckpt.save_weights(tmp_path / "port.msgpack", model)
    assert sorted(files) == [str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")]
    assert files[str(tmp_path / "port.msgpack")] == files[str(tmp_path / "jax.msgpack")]
    back = convert.vgg16_state_dict_from_jax_variables(ckpt.load_weights(tmp_path / "jax.msgpack"))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    assert not any(tmp_path.iterdir())


def test_seeded_init_without_the_default_init_is_bit_equal(monkeypatch):
    """The convolutions and linears are built without torch's default init,
    which the seeded draws overwrite: the state_dict equals the one built
    with the default init first (the oracle, as the model was built before),
    bit for bit, and torch's global generator is left as it was."""
    from object_detection_torch2_tpu_torch.models import vgg16 as vgg_module

    rng = torch.get_rng_state()
    got = VGG16(num_classes=20, seed=5).state_dict()
    assert torch.equal(torch.get_rng_state(), rng)
    monkeypatch.setattr(vgg_module, "skip_init", lambda cls, *args, **kwargs: cls(*args, **kwargs))
    want = VGG16(num_classes=20, seed=5).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.slow
def test_state_dict_layout_and_heads():
    """Both heads are in the state_dict, named as the JAX package's layers;
    only the selected head runs. Port only, at full width: marked slow,
    chip_smoke.py's phase_moved_training holds it on the card."""
    model = VGG16(num_classes=20, transfer_learning=True, dropout_rate=0.0)
    names = list(model.state_dict())
    assert names[:7] == ["features.conv_1_1.weight", "features.conv_1_1.bias", "features.bn_1_1.weight",
                         "features.bn_1_1.bias", "features.bn_1_1.running_mean", "features.bn_1_1.running_var",
                         "features.bn_1_1.num_batches_tracked"]
    assert [n for n in names if n.startswith("classifier")] == [
        f"{h}_fc{i}.{leaf}" for h in ("classifier", "classifier2") for i in (1, 2, 3) for leaf in ("weight", "bias")]
    assert model.classifier_fc1.weight.shape == (4096, 512 * 7 * 7) and model.classifier2_fc3.weight.shape == (20, 4096)
    x = torch.rand(2, 200, 200, 3)
    out = model(x, train=True)
    out.sum().backward()
    assert out.shape == (2, 20)
    assert model.classifier_fc1.weight.grad is None and model.classifier2_fc1.weight.grad is not None


@pytest.mark.parametrize("transfer", [True, False])
def test_trainable_predicate_matches_jax(transfer):
    model = VGG16(num_classes=20)
    got = [name for name, _ in model.named_parameters() if vgg_trainable_predicate(transfer)(name)]
    want = jax_predicate(transfer)
    assert got == [name for name, _ in model.named_parameters() if want((name.split(".")[-2],))]
    dead = "classifier_" if transfer else "classifier2_"
    assert len(got) == 64 - 6 and not any(n.startswith(dead) for n in got)


@pytest.mark.slow
def test_dropout_draws_from_its_generator():
    """Keep with probability 1 - p, kept values scaled by 1 / (1 - p); the
    same generator state gives the same mask; a training forward without a
    generator raises. Port only, at full width: marked slow,
    chip_smoke.py's phase_moved_training holds it on the card."""
    x = torch.ones(64, 4096)
    a = dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = dropout(x, 0.5, torch.Generator().manual_seed(1))
    c = dropout(x, 0.5, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.01
    assert torch.equal(dropout(x, 1.0, torch.Generator()), torch.zeros_like(x))
    model = VGG16(num_classes=20, transfer_learning=True)
    with pytest.raises(ValueError, match="generator"):
        model(torch.rand(1, 200, 200, 3), train=True)
    with torch.no_grad():
        plain = model(torch.rand(1, 200, 200, 3, generator=torch.Generator().manual_seed(0)), train=False)
    assert plain.shape == (1, 20)

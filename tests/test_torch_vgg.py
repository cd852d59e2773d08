"""The port's VGG16 (models/vgg16.py), its converters and its weights file
against the reference goldens and the JAX package: the forward golden
(goldens/vgg_forward.npz) at the JAX tests' tolerances, the JAX `VGG16` on the
same seeded inputs, `cross_entropy` against the Q2 golden, the converters and
the weights file bit for bit both ways, and the dropout."""

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

torch.set_num_threads(2)


def _nhwc(x_nchw):
    return np.ascontiguousarray(np.transpose(x_nchw, (0, 2, 3, 1)))


def _model(variables, **kwargs) -> VGG16:
    model = VGG16(num_classes=20, **kwargs)
    model.load_state_dict(convert.vgg16_state_dict_from_jax_variables(variables))
    return model.eval()


@pytest.fixture(scope="module")
def golden(goldens):
    """(golden, its reference-layout state_dict, the port's conversion of it,
    the golden's images NHWC)."""
    g = goldens("vgg_forward")
    sd = synth_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    return g, sd, convert.vgg16_variables_from_torch(sd), torch.from_numpy(_nhwc(g["x"]))


@pytest.mark.parametrize("transfer,use_batch_stats,key,atol", [
    (False, False, "out_eval", 5e-2),
    (True, False, "out_transfer", 5e-2),
    (False, True, "out_bn_batch", 5e-3),
])
def test_forward_matches_golden(golden, transfer, use_batch_stats, key, atol):
    """The reference's logits at the JAX tests' tolerances (running statistics
    at atol 5e-2 on logits up to 2.7e4, batch statistics at 5e-3)."""
    g, _, variables, x = golden
    with torch.no_grad():
        out = _model(variables, transfer_learning=transfer)(x, train=False, use_batch_stats=use_batch_stats)
    assert out.shape == (2, 20 if transfer else 1000) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), g[key], atol=atol)


def test_forward_matches_jax_vgg16(goldens):
    """The JAX VGG16 and the port's on the same seeded weights (the
    trajectory golden's kaiming-scaled recipe) and images at imsize 200,
    batch 2, float32, batch statistics: rtol 1e-4, atol 1e-4."""
    g = goldens("vgg_trajectory")
    sd = synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    x = np.random.default_rng(200).uniform(0.0, 1.0, (2, 200, 200, 3)).astype(np.float32)
    jax_vars = jax.tree.map(jnp.asarray, jax_convert.vgg16_variables_from_torch(sd))
    want, _ = JaxVGG16(num_classes=20, transfer_learning=True).apply(
        jax_vars, jnp.asarray(x), train=False, use_batch_stats=True, mutable=["batch_stats"])
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
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_converters_bit_equal_to_jax(golden):
    """`vgg16_sequential_index_map` and `vgg16_variables_from_torch` give the
    JAX package's, bit for bit, on one reference state_dict; the port's
    state_dict round-trips through the JAX layout exactly."""
    _, sd, got, _ = golden
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


def test_weights_file_byte_identical_both_ways(tmp_path):
    """A VGG16's weights file: the port's save_weights writes the bytes the
    JAX package's save_weights writes for the same variables (so the JAX
    package loads it as its own), and the port loads the JAX package's file
    back to the model's state_dict bit for bit."""
    model = VGG16(num_classes=20, seed=3)
    jax_ckpt.save_weights(tmp_path / "jax.msgpack", convert.jax_variables_of(model))
    ckpt.save_weights(tmp_path / "port.msgpack", model)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    back = convert.vgg16_state_dict_from_jax_variables(ckpt.load_weights(tmp_path / "jax.msgpack"))
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    for name in ("jax.msgpack", "port.msgpack"):  # 1.03 GB each: not kept in the temporary directory
        (tmp_path / name).unlink()


def test_state_dict_layout_and_heads():
    """Both heads are in the state_dict, named as the JAX package's layers;
    only the selected head runs."""
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


def test_dropout_draws_from_its_generator():
    """Keep with probability 1 - p, kept values scaled by 1 / (1 - p); the
    same generator state gives the same mask; a training forward without a
    generator raises."""
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

"""Port parity for models/bn.py, models/ssd.py and models/convert.py against the
JAX package's BatchNormTPU and SSD and the reference forward goldens (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.models.bn import BatchNormTPU
from object_detection_torch2_tpu.models.convert import ssd_variables_from_torch
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu.utils.testing import synth_scaled_state_dict_from_manifest
from object_detection_torch2_tpu_torch.models.bn import BatchNorm
from object_detection_torch2_tpu_torch.models.convert import (
    ssd_state_dict_from_jax_variables,
    ssd_state_dict_from_torch,
    ssd_state_shapes,
)
from object_detection_torch2_tpu_torch.models.ssd import SSD

torch.set_num_threads(1)


def _bn_case(seed, n=6, h=5, w=7, c=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.5, 2.0, (n, h, w, c)).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.5, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, params, stats


def _port_bn(params, stats):
    bn = BatchNorm(len(params["scale"]))
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]), "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    return bn


@pytest.mark.parametrize("mode", ["batch", "batch_masked", "running"])
def test_batchnorm_matches_jax(mode):
    """Batch statistics (with and without a pad-row mask) and running
    statistics, and the running-stat update, against BatchNormTPU. atol 1e-6."""
    x, params, stats = _bn_case(1)
    x[4:] = 7.0  # poison the rows the mask drops
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32) if mode == "batch_masked" else None
    use_batch = mode != "running"

    ref = BatchNormTPU(use_running_average=not use_batch)
    variables = {"params": params, "batch_stats": stats}
    jmask = None if mask is None else jnp.asarray(mask)
    if use_batch:
        y_ref, upd = ref.apply(variables, jnp.asarray(x), jmask, mutable=["batch_stats"])
    else:
        y_ref, upd = ref.apply(variables, jnp.asarray(x), jmask), {"batch_stats": stats}

    bn = _port_bn(params, stats).train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = bn(xt, use_batch_stats=use_batch, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_ref), atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)
    assert int(bn.num_batches_tracked) == int(use_batch)


def test_batchnorm_eval_mode_keeps_running_stats():
    x, params, stats = _bn_case(2)
    bn = _port_bn(params, stats).eval()
    bn(torch.from_numpy(x).permute(0, 3, 1, 2), use_batch_stats=True)
    np.testing.assert_array_equal(bn.running_mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), stats["var"])


def test_batchnorm_bf16_output():
    x, params, stats = _bn_case(3)
    bn = _port_bn(params, stats).eval()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
    with torch.no_grad():
        y = bn(xt, use_batch_stats=True)
        want = bn(xt.float(), use_batch_stats=True, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, want)  # the math runs in float32 whatever the input type


@pytest.fixture(scope="module")
def pinned(goldens):
    g = goldens("ssd_forward_pinned")
    sd = synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    model = SSD(num_classes=21)
    model.load_state_dict(ssd_state_dict_from_torch(sd))
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(g["x"], (0, 2, 3, 1))))
    return g, model.eval(), x


def test_ssd_forward_pinned_eval(pinned):
    """Running statistics: within the pin the JAX package holds, atol 1e-4."""
    g, model, x = pinned
    with torch.inference_mode():
        out = model(x, use_batch_stats=False)
    assert out.shape == (2, 8732, 25) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), g["out_eval"], atol=1e-4)


def test_ssd_forward_pinned_train(pinned):
    """Batch statistics: max < 5e-3 and mean < 1e-4, the JAX package's pins
    (tests/test_models.py) for reduction-order drift across 35 BN layers."""
    g, model, x = pinned
    with torch.inference_mode():
        out = model(x, use_batch_stats=True)
    diff = np.abs(out.numpy() - g["out_train"])
    assert diff.max() < 5e-3
    assert diff.mean() < 1e-4


def test_state_dict_layout_matches_reference_manifest(goldens):
    g = goldens("ssd_forward_pinned")
    keys = [str(k) for k in g["manifest_keys"]]
    sd = SSD(num_classes=21).state_dict()
    assert list(sd) == keys == list(ssd_state_shapes(21))
    for k, shape in zip(keys, g["manifest_shapes"]):
        assert tuple(sd[k].shape) == tuple(int(s) for s in shape if s)


def test_seeded_init_is_deterministic_kaiming():
    a, b, c = SSD(seed=0).state_dict(), SSD(seed=0).state_dict(), SSD(seed=1).state_dict()
    for k in a:
        assert torch.equal(a[k], b[k])
    w = a["features.conv_5_1.weight"]
    assert not torch.equal(w, c["features.conv_5_1.weight"])
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(float(w.std()) / np.sqrt(2.0 / fan_out) - 1) < 0.02
    assert float(a["features.conv_5_1.bias"].abs().max()) == 0.0
    with pytest.raises(ValueError):
        SSD(dtype=torch.float16)


def test_seeded_init_without_the_default_init_is_bit_equal(monkeypatch):
    """The convolutions are built without torch's default init, which the
    seeded draws overwrite: the state_dict equals the one built with the
    default init first (the oracle, as the model was built before), bit for
    bit, and torch's global generator is left as it was."""
    from object_detection_torch2_tpu_torch.models import ssd as ssd_module

    rng = torch.get_rng_state()
    got = SSD(num_classes=21, seed=5).state_dict()
    assert torch.equal(torch.get_rng_state(), rng)
    monkeypatch.setattr(ssd_module, "skip_init", lambda cls, *args, **kwargs: cls(*args, **kwargs))
    want = SSD(num_classes=21, seed=5).state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_converter_round_trips_with_jax_converter(goldens):
    g = goldens("ssd_forward_pinned")
    sd = synth_scaled_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    variables = ssd_variables_from_torch(sd)
    ours = ssd_state_dict_from_jax_variables(variables)
    assert list(ours) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(ours[k].numpy(), sd[k])
    back = ssd_variables_from_torch({k: v.numpy() for k, v in ours.items()})
    for coll in ("params", "batch_stats"):
        for layer, leaves in variables[coll].items():
            for name, v in leaves.items():
                np.testing.assert_array_equal(back[coll][layer][name], v)


def test_converter_rejects_bad_state_dicts():
    sd = {k: v.numpy() for k, v in SSD().state_dict().items()}
    ssd_state_dict_from_torch(sd)
    with pytest.raises(ValueError, match="missing"):
        ssd_state_dict_from_torch({k: v for k, v in sd.items() if "det_4_3" not in k})
    bad = dict(sd, **{"detectors.det_4_3.bias": np.zeros(99, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        ssd_state_dict_from_torch(bad)
    bad = dict(sd, **{"features.bn_1_1.running_var": np.ones(64, np.int64)})
    with pytest.raises(ValueError, match="dtype"):
        ssd_state_dict_from_torch(bad)


def test_jax_init_weights_forward_matches_jax_at_small_size():
    """The JAX package's own init weights, carried across by the converter,
    give the same head outputs at imsize 264 in both frameworks. The init and
    the forward are each one jitted program, the forward's arrays passed as
    its arguments."""
    jmodel = JaxSSD(num_classes=21)
    # one program, compiled at XLA's backend optimization level 1: a third of
    # the default level's compile CPU, the same variables bit for bit
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 264, 264, 3)), train=False))
    key = jax.random.PRNGKey(0)
    variables = init.lower(key).compile(compiler_options={"xla_backend_optimization_level": 1})(key)
    x = np.random.default_rng(9).uniform(0, 1, (2, 264, 264, 3)).astype(np.float32)
    forward = jax.jit(lambda v, images: jmodel.apply(v, images, train=False, use_batch_stats=False))
    want = np.asarray(forward(variables, jnp.asarray(x)))
    model = SSD(num_classes=21)
    model.load_state_dict(ssd_state_dict_from_jax_variables(jax.tree.map(np.asarray, variables)))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x), use_batch_stats=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_head_gradients_reach_their_convs_aligned(monkeypatch):
    """With one image, the gradient that reaches each convolution's output
    (each detector head's included: a slice of the concatenated outputs'
    gradient) starts on a 16-byte boundary. On the card, cuDNN's backward
    read a head's unaligned one-image slice at a misaligned address (a CUDA
    error in the first step of any training at one image a process)."""
    starts = []
    conv2d = torch.nn.functional.conv2d

    def recording(*args, **kwargs):
        y = conv2d(*args, **kwargs)
        if y.requires_grad:
            y.register_hook(lambda g: starts.append(g.data_ptr() % 16))
        return y

    monkeypatch.setattr(torch.nn.functional, "conv2d", recording)
    model = SSD(num_classes=21, seed=0).train()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 264, 264, 3)).astype(np.float32))
    out = model(x)
    weight = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape).astype(np.float32))
    (out * weight).sum().backward()
    assert len(starts) == 13 + 10 + 6 and not any(starts), starts  # trunk, extras, heads

"""The int8 layers' prologue in the port: the activation quantize as the
custom op `odt::quantize_act` (its CPU path against the JAX package's
`quantize_act` in both of its division contexts) and the int8 weights
quantized once per weight version, not every forward. One module-scoped
seeded SSD with an int8 trunk at 64x64 (the trunk only, up_to 5_3)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.models import quant as jq
from object_detection_torch2_tpu_torch.models import quant as pq
from object_detection_torch2_tpu_torch.models import ssd as ssd_mod
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.ops import quantize_act_cuda, registry
from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv, pack_weight, quantize_act

torch.set_num_threads(1)

IMSIZE = 64
TRUNK = ("2_1", "2_2", "3_1", "3_2", "3_3", "4_1", "4_2", "4_3", "5_1", "5_2", "5_3")


@pytest.fixture(scope="module")
def trunk():
    """An SSD with calibrated scales and two seeded images; the float32
    model runs with trunk_int8 set."""
    model = SSD(num_classes=21, seed=0)
    imgs = torch.from_numpy(np.random.default_rng(12).random((2, IMSIZE, IMSIZE, 3)).astype(np.float32))
    qd = pq.calibrate_trunk(model, [imgs])
    model.set_quant(qd)
    model.trunk_int8 = True
    return model, imgs, qd


def _forward(model, imgs):
    with torch.no_grad():
        return model(imgs, up_to="5_3")


def _conv_int8_every_forward(self, layer, conv, x):
    """The int8 layer as it ran before the op and the cache: the weights
    quantized on every forward, the five-pass plain quantize."""
    sx = pq.act_scale(self.quant_amax[ssd_mod._QUANT_INDEX[layer]])
    sw = pq.weight_scales(conv.weight)
    w8 = pack_weight(pq.quantize_weight(conv.weight, sw))
    x8 = pq.quantize_act(x, sx, reciprocal=self.quant_reciprocal).contiguous(memory_format=torch.channels_last)
    return int8_conv(x8, w8, sx * sw, conv.bias.to(self.dtype), conv.stride[0], conv.padding[0], self.dtype)


def test_repeated_forward_quantizes_no_weight_again(trunk, monkeypatch):
    model, imgs, _ = trunk
    calls = []
    real = pq.quantize_weight
    monkeypatch.setattr(pq, "quantize_weight", lambda w, s: calls.append(1) or real(w, s))
    model._int8_weights.clear()
    first = _forward(model, imgs)
    assert len(calls) == len(TRUNK)
    second = _forward(model, imgs)
    assert len(calls) == len(TRUNK)
    assert torch.equal(first, second)


def test_in_place_weight_edit_recomputes_the_int8_weight(trunk):
    """After an in-place edit of a trunk weight (its version moves), the
    output equals a fresh model's with that weight, bit for bit, and differs
    from the output before the edit."""
    model, imgs, qd = trunk
    edited = copy.deepcopy(model)
    before = _forward(edited, imgs)  # fills the copy's cache
    with torch.no_grad():
        w = edited.features["conv_3_2"].weight
        w.mul_(torch.from_numpy(np.random.default_rng(5).uniform(0.5, 1.5, w.shape[0]).astype(np.float32))[:, None,
                                                                                                        None, None])
    after = _forward(edited, imgs)
    fresh = SSD(num_classes=21, seed=0)
    fresh.load_state_dict(edited.state_dict())
    fresh.set_quant(qd)
    fresh.trunk_int8 = True
    assert torch.equal(after, _forward(fresh, imgs))
    assert not torch.equal(after, before)
    # load_state_dict copies in place too: the edited model takes the seed's weights back
    edited.load_state_dict(model.state_dict())
    assert torch.equal(_forward(edited, imgs), _forward(model, imgs))


def test_export_bypasses_the_weight_cache(trunk, monkeypatch):
    """While torch.export traces, the int8 weights are quantized in the graph
    and the cache is neither read nor written."""
    model, _, _ = trunk
    conv = model.features["conv_4_1"]
    model._int8_weights.clear()
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    w8, sw = model._int8_weight("4_1", conv)
    assert model._int8_weights == {}
    assert torch.equal(w8, pack_weight(pq.quantize_weight(conv.weight, pq.weight_scales(conv.weight))))
    assert torch.equal(sw, pq.weight_scales(conv.weight))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reciprocal", [False, True])
def test_trunk_int8_forward_through_the_op_equals_the_per_forward_path(trunk, dtype, reciprocal, monkeypatch):
    """A --trunk_int8 forward (the quantize op, the cached weights) equals the
    forward that quantizes the weights every time and the activations in
    five plain passes, bit for bit, in both dtypes and both division forms."""
    _, imgs, qd = trunk
    model = SSD(num_classes=21, dtype=dtype, seed=0, trunk_int8=True)
    model.set_quant(qd)
    model.quant_reciprocal = reciprocal
    got = _forward(model, imgs)
    monkeypatch.setattr(SSD, "_conv_int8", _conv_int8_every_forward)
    assert torch.equal(got, _forward(model, imgs))


def _act_case(scale_kind: str, dtype: torch.dtype):
    """Seeded activations (N, C, H, W) channels_last in `dtype` and a float32
    scale: exact ties (k + 0.5) * sx at a power-of-two sx, or a calibrated
    sx with values at which the two division forms round differently (in
    float32); values beyond +-127 sx, and -0.0."""
    rng = np.random.default_rng(21)
    if scale_kind == "pow2":
        sx = np.float32(2.0 ** -5)
        x = ((rng.integers(-135, 135, (2, 32, 6, 5)) + 0.5) * sx).astype(np.float32)
    else:
        x = rng.uniform(-5.0, 5.0, (2, 32, 6, 5)).astype(np.float32)
        pool = torch.from_numpy(rng.uniform(0, 4, 1 << 20).astype(np.float32))
        for amax in rng.uniform(0.5, 5, 64).astype(np.float32):
            sx = pq.act_scale(torch.tensor(amax))
            split = pq.quantize_act(pool, sx) != pq.quantize_act(pool, sx, True)
            if bool(split.any()):  # the values the two forms round apart go into x
                apart = pool[split][:16].numpy()
                x.reshape(-1)[3:3 + apart.size] = apart
                sx = sx.numpy()
                break
        else:
            raise AssertionError("no seeded amax separates the two forms")
    x.reshape(-1)[:3] = (-0.0, 300.0 * sx, -300.0 * sx)
    x = torch.from_numpy(x).to(dtype).float().numpy()  # the values the dtype holds
    xt = torch.from_numpy(x).to(dtype).contiguous(memory_format=torch.channels_last)
    return x, xt, np.float32(sx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale_kind", ["pow2", "calibrated"])
@pytest.mark.parametrize("context", ["serving", "trainer"])
def test_quantize_act_op_matches_jax(dtype, scale_kind, context):
    """torch.ops.odt.quantize_act on the CPU (the plain version) bit-equal to
    the JAX package's quantize_act: the scale as a jit argument (serving, a
    true division) or a closed-over constant (the Trainer, XLA's reciprocal),
    picked by `reciprocal`. The output is int8 channels_last."""
    x, xt, sx = _act_case(scale_kind, dtype)
    jx = jnp.asarray(np.transpose(x, (0, 2, 3, 1))).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    if context == "serving":
        want = jax.jit(jq.quantize_act)(jx, sx)
    else:
        want = jax.jit(lambda v: jq.quantize_act(v, jnp.float32(sx)))(jx)
    got = quantize_act(xt, torch.tensor(sx), context == "trainer")
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))
    assert got.flatten()[:3].tolist() == [0, 127, -127]


def test_quantize_act_op_registration():
    """The op passes torch.library's checks (schema, fake, no aliasing), and
    its CUDA wrapper refuses a CPU tensor instead of taking the plain path."""
    _, xt, sx = _act_case("pow2", torch.bfloat16)
    for reciprocal in (False, True):
        torch.library.opcheck(registry.quantize_act, (xt, torch.tensor(sx), reciprocal))
    with pytest.raises(ValueError, match="CUDA device"):
        quantize_act_cuda.quantize_act_cuda(xt, torch.tensor(sx))
    with pytest.raises(ValueError, match="no activation quantize"):
        quantize_act(xt.to("meta"), torch.tensor(sx))

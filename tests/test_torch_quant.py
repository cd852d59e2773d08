"""Port parity for the int8 paths: models/quant.py, ops/int8_conv.py (the
plain version and the custom op on the CPU) and `SSD(trunk_int8 / full_int8)`
and `Trainer(quant=)` against the JAX package's models/quant.py, SSD and
Trainer, on the same seeded inputs and weights (CPU).

The JAX side runs as tests/test_quant.py runs it. Two contexts of the JAX
arithmetic matter (models/quant.py of the port says why): inside jit, x / 127.0
is a multiplication by float32(1/127); x / sx is a true division when sx is a
jit argument (serving) and a multiplication by the float32 reciprocal when sx
is a closed-over constant (the Trainer)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from object_detection_torch2_tpu.core.anchors import default_boxes as jax_default_boxes
from object_detection_torch2_tpu.core.anchors import feature_grids_for as jax_grids
from object_detection_torch2_tpu.models import quant as jq
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu.train.trainer import Trainer as JaxTrainer
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.models import quant as pq
from object_detection_torch2_tpu_torch.models import ssd as ssd_mod
from object_detection_torch2_tpu_torch.models.convert import (
    jax_quant_collection,
    jax_variables_from_state_dict,
    quant_scales_from_jax_variables,
)
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.ops.int8_conv import chunk_channels, int8_conv, int8_conv_plain, pack_weight
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

IMSIZE = 64  # trunk-only tests (up_to="5_3"); 264 is the smallest full pyramid
FULL_IMSIZE = 264


def _numpy_int8_conv(x8, w8, stride=1, pad=1):
    """Exact s8 x s8 -> s32 conv oracle, NHWC / HWIO, int32 accumulation
    (tests/test_quant.py's `_numpy_int8_conv` with a stride and a pad)."""
    x = np.asarray(x8, np.int32)
    w = np.asarray(w8, np.int32)
    n, h, ww, cin = x.shape
    kh, kw, _, cout = w.shape
    xp = np.zeros((n, h + 2 * pad, ww + 2 * pad, cin), np.int32)
    xp[:, pad:pad + h, pad:pad + ww] = x
    ho, wo = (h + 2 * pad - kh) // stride + 1, (ww + 2 * pad - kw) // stride + 1
    out = np.zeros((n, ho, wo, cout), np.int32)
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride, :]
            out += np.einsum("nhwc,co->nhwo", patch, w[dy, dx], dtype=np.int64).astype(np.int32)
    return out


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor with channels_last strides."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio)).permute(3, 2, 0, 1).contiguous()


# ------------------------------------------------------------ quant math


def test_weight_scales_and_quantize_weight_bitwise():
    """Per-channel scales (XLA's x * float32(1/127)) and int8 weights, bit-equal."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((3, 3, 64, 128)) * 0.05).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes the 1e-12 floor
    js = np.asarray(jax.jit(jq.weight_scales)(w))
    ps = pq.weight_scales(_oihw(w))
    np.testing.assert_array_equal(ps.numpy(), js)
    jw8 = np.asarray(jax.jit(jq.quantize_weight)(w, js))
    pw8 = pq.quantize_weight(_oihw(w), ps).permute(2, 3, 1, 0).numpy()
    assert pw8.dtype == np.int8
    np.testing.assert_array_equal(pw8, jw8)
    np.testing.assert_array_equal(np.abs(pw8).max(axis=(0, 1, 2))[np.arange(128) != 3], 127)


def test_quantize_act_saturates():
    x = np.asarray([-10.0, -1.0, 0.0, 0.5, 10.0], np.float32).reshape(1, 1, 1, 5)
    scale = np.float32(1.0 / 127.0)
    want = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.float32(scale)))
    got = pq.quantize_act(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.ravel(), [-127, -127, 0, 64, 127])


def _division_case():
    """A seeded activation and amax at which x / sx and x * (1 / sx) round
    differently somewhere, so that the two contexts are told apart."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 4, (1, 128, 128, 64)).astype(np.float32)
    xt = torch.from_numpy(x)
    for amax in rng.uniform(0.5, 5, 64).astype(np.float32):
        sx = pq.act_scale(torch.tensor(amax))
        if not torch.equal(pq.quantize_act(xt, sx), pq.quantize_act(xt, sx, reciprocal=True)):
            return x, amax
    raise AssertionError("no seeded amax separates the two forms")


@pytest.mark.parametrize("context", ["serving", "trainer"])
def test_quantize_act_matches_each_jax_context(context):
    """int8 activations bit-equal to the JAX package's: in serving the amax
    is a jit argument (true division), in the Trainer a closed-over constant
    (XLA's reciprocal); the port's `reciprocal` flag picks the form."""
    x, amax = _division_case()
    if context == "serving":
        want = jax.jit(lambda x, a: jq.quantize_act(x, jnp.maximum(a, 1e-12) / 127.0))(x, amax)
    else:
        want = jax.jit(lambda x: jq.quantize_act(x, jnp.maximum(jnp.float32(amax), 1e-12) / 127.0))(x)
    got = pq.quantize_act(torch.from_numpy(x), pq.act_scale(torch.tensor(amax)), reciprocal=context == "trainer")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_calibrated_and_missing_layers():
    """The same verdicts and messages as the JAX package's: None, {}, a zero
    amax, a stale file (no '1_2'), and the full layer set."""
    good = {f"amax_{layer}": 1.0 for layer in pq.QUANT_LAYERS}
    stale = dict(good)
    del stale["amax_1_2"]
    for bad in (None, {}, dict(good, amax_3_2=0.0), stale):
        with pytest.raises(ValueError) as want:
            jq.check_calibrated(bad)
        with pytest.raises(ValueError) as got:
            pq.check_calibrated(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="stale"):
        pq.check_calibrated(stale)
    assert pq.check_calibrated(good) is good
    for quant in (None, good, stale):
        for layers in (pq.QUANT_LAYERS, pq.FULL_QUANT_LAYERS):
            assert pq.missing_layers(quant, layers) == jq.missing_layers(quant, layers)
    assert pq.missing_layers(good, pq.FULL_QUANT_LAYERS) == list(pq.EXTRA_QUANT_LAYERS + pq.HEAD_QUANT_LAYERS)
    assert (pq.QUANT_LAYERS, pq.EXTRA_QUANT_LAYERS, pq.HEAD_QUANT_LAYERS, pq.FULL_QUANT_LAYERS) == (
        jq.QUANT_LAYERS, jq.EXTRA_QUANT_LAYERS, jq.HEAD_QUANT_LAYERS, jq.FULL_QUANT_LAYERS)


def test_quant_json_byte_identical(tmp_path):
    """save_quant writes the JAX package's bytes for the same scales; each
    package loads the other's file."""
    rng = np.random.default_rng(4)
    scales = {f"amax_{layer}": float(np.float32(v)) * 1.25
              for layer, v in zip(pq.FULL_QUANT_LAYERS, rng.uniform(0.1, 9.0, len(pq.FULL_QUANT_LAYERS)))}
    pq.save_quant(tmp_path / "port.json", scales)
    jq.save_quant(tmp_path / "jax.json", scales)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert pq.load_quant(tmp_path / "jax.json") == jq.load_quant(tmp_path / "port.json") == scales
    # the converters carry the JAX "quant" collection across both ways
    jcoll = {k: jnp.float32(v) for k, v in scales.items()}
    back = quant_scales_from_jax_variables({"quant": jcoll})
    assert back == {k: float(np.float32(v)) for k, v in scales.items()}
    assert {k: np.float32(v) for k, v in jax_quant_collection(back).items()} == {
        k: np.float32(v) for k, v in jcoll.items()}


# ------------------------------------------------------------- int8 conv

# (cin, cout, spatial, kernel, stride, pad): every kind of quantized layer
CONV_KINDS = {
    "3x3_s1_p1": (64, 24, 10, 3, 1, 1),
    "1x1_s1_p0": (64, 40, 7, 1, 1, 0),
    "3x3_s2_p1": (32, 24, 9, 3, 2, 1),
    "3x3_s1_p0": (32, 16, 6, 3, 1, 0),
    "cout_100": (32, 100, 5, 3, 1, 1),
    "cout_150": (64, 150, 3, 3, 1, 1),
    "spatial_1x1": (32, 24, 3, 3, 1, 0),
}


@pytest.mark.parametrize("kind", sorted(CONV_KINDS))
def test_int8_conv_plain_exact(kind):
    """int8_conv_plain (and the custom op on the CPU) bit-equal to the JAX
    package's lax int8 conv and to the numpy int32 oracle, at full-scale
    int8 operands (+-127 everywhere: the largest sums)."""
    cin, cout, hw, k, stride, pad = CONV_KINDS[kind]
    rng = np.random.default_rng(sorted(CONV_KINDS).index(kind))
    x8 = rng.integers(-127, 128, (3, hw, hw + 1, cin)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = _numpy_int8_conv(x8, w8, stride, pad)
    np.testing.assert_array_equal(np.asarray(jax.jit(jq.int8_conv, static_argnums=(2, 3))(x8, w8, stride, pad)),
                                  want)
    wpk = pack_weight(_oihw(w8))
    for fn in (int8_conv_plain, int8_conv):
        got = fn(_nchw(x8), wpk, None, None, stride, pad, None)
        assert got.dtype == torch.int32 and got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _float64_int8_conv(x8: torch.Tensor, w8: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """The plain int8 conv's float64 form (its form on the card): one float64
    convolution of the int8 values, exact below 2^53, cast to int32. The
    oracle of the chunked float32 form the CPU runs."""
    return F.conv2d(x8.to(torch.float64), w8.permute(0, 3, 1, 2).to(torch.float64), stride=stride,
                    padding=pad).to(torch.int32)


def _quantized_layer_shapes(imsize: int) -> list:
    """(layer, Cin, H = W, Cout, kernel, stride, pad) of every quantizable
    layer of SSD300 at `imsize` (quant.FULL_QUANT_LAYERS: conv_1_2, blocks
    2-5, extras 6-11, the six heads)."""
    rows, h, out_hw = [], imsize, {}
    for suffix, cin, cout, k, stride, pad, pool in ssd_mod.LAYER_SPECS:
        if suffix in pq.FULL_QUANT_LAYERS:
            rows.append((suffix, cin, h, cout, k, stride, pad))
        h = (h + 2 * pad - k) // stride + 1
        out_hw[suffix] = (h, cout)
        if pool is not None:
            h = (h + (2 if pool == "M_P" else 0)) // 2
    for suffix, anchors in ssd_mod.DETECTOR_TAPS:
        hw, cin = out_hw[suffix]
        rows.append((f"det_{suffix}", cin, hw, anchors * 25, 3, 1, 1))
    return rows


LAYER_SHAPES = {f"{imsize}-{row[0]}": row for imsize in (FULL_IMSIZE, 300) for row in _quantized_layer_shapes(imsize)}


@pytest.mark.parametrize("case", list(LAYER_SHAPES))
def test_chunked_plain_int8_conv_bit_equal_to_float64(case):
    """On a CPU tensor `int8_conv_plain` sums in float32 over chunks of at
    most chunk_channels input channels (113 for 3 x 3, 1,024 for 1 x 1): bit
    for bit the float64 form at every quantizable layer shape of SSD300 at
    imsize 264 and 300 (batch 1), on the worst operands (all -128 against all
    -128: every product 2^14, the largest; all +127 against all -127: every
    product -16,129, odd, so a chunk past 2^24 would round) and on seeded
    random int8 values."""
    _, cin, hw, cout, k, stride, pad = LAYER_SHAPES[case]
    assert (chunk_channels(3, 3), chunk_channels(1, 1)) == (113, 1024)
    g = torch.Generator().manual_seed(list(LAYER_SHAPES).index(case))
    x_shape, w_shape = (1, cin, hw, hw), (cout, k, k, cin)
    operands = {
        "all -128": (torch.full(x_shape, -128, dtype=torch.int8), torch.full(w_shape, -128, dtype=torch.int8)),
        "+127 against -127": (torch.full(x_shape, 127, dtype=torch.int8), torch.full(w_shape, -127, dtype=torch.int8)),
        "random": (torch.randint(-128, 128, x_shape, generator=g, dtype=torch.int8),
                   torch.randint(-128, 128, w_shape, generator=g, dtype=torch.int8)),
    }
    for name, (x8, w8) in operands.items():
        x8 = x8.contiguous(memory_format=torch.channels_last)
        got = int8_conv_plain(x8, w8, None, None, stride, pad, None)
        want = _float64_int8_conv(x8, w8, stride, pad)
        assert got.dtype == torch.int32 and got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want), f"{case} {name}: {int((got != want).sum())} sums differ"


@pytest.mark.parametrize("context", ["serving", "trainer"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_quantized_layer_matches_jax(dtype, context):
    """conv + dequant + bias of one layer, as the JAX package's
    `_conv_bn_relu_q` computes it with the same sx, in both division
    contexts: the int8 activations bit-equal, the output bit-equal in
    bfloat16 and within 1 ulp in float32 (XLA on the CPU may contract
    y * s + b into an FMA; the port rounds the product first)."""
    x, amax = _division_case()
    x = x[:, :40, :40]
    rng = np.random.default_rng(5)
    kernel = (rng.standard_normal((3, 3, 64, 96)) * np.sqrt(2 / (9 * 96))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(96)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    xin = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))  # the activation in the model's dtype

    def layer(x, a, kernel, bias):  # the weights are jit arguments, as the model's params are
        sx = jnp.maximum(a, 1e-12) / 127.0
        sw = jq.weight_scales(kernel)
        x8 = jq.quantize_act(x.astype(jdt), sx)
        y32 = jq.int8_conv(x8, jq.quantize_weight(kernel, sw))
        return x8, (y32.astype(jnp.float32) * (sx * sw)).astype(jdt) + bias.astype(jdt)

    if context == "serving":
        want_x8, want = jax.jit(layer)(xin, amax, kernel, bias)
    else:
        want_x8, want = jax.jit(lambda x, k, b: layer(x, jnp.float32(amax), k, b))(xin, kernel, bias)
    w = _oihw(kernel)
    sx = pq.act_scale(torch.tensor(amax))
    sw = pq.weight_scales(w)
    x8 = pq.quantize_act(_nchw(xin).to(tdt), sx, reciprocal=context == "trainer")
    np.testing.assert_array_equal(x8.permute(0, 2, 3, 1).numpy(), np.asarray(want_x8))
    got = int8_conv(x8, pack_weight(pq.quantize_weight(w, sw)), sx * sw, torch.from_numpy(bias).to(tdt), 1, 1, tdt)
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        # XLA contracts y * s + b into an FMA (one rounding), the port rounds
        # the product first: 1 ulp of the larger of the product and the sum
        # (where the bias cancels the product, 1 ulp of the small sum would
        # not hold)
        acc = int8_conv(x8, pack_weight(pq.quantize_weight(w, sw)), None, None, 1, 1, None)
        product = (acc.double() * (sx * sw).double()[None, :, None, None]).permute(0, 2, 3, 1).numpy()
        ulp = np.spacing(np.maximum(np.abs(product).astype(np.float32), np.abs(want)))
        assert (np.abs(got - want) <= ulp).all()


def test_fake_quant_conv_matches_jax():
    """The float simulation of quantize -> int8 conv -> dequant against the
    JAX package's, within float32 summation noise (rtol 1e-5)."""
    rng = np.random.default_rng(6)
    x = np.maximum(rng.standard_normal((2, 9, 9, 32)), 0).astype(np.float32)
    w = (rng.standard_normal((3, 3, 32, 16)) * 0.1).astype(np.float32)
    scale = np.float32(np.abs(x).max() / 127)
    want = np.asarray(jax.jit(jq.fake_quant_conv)(x, w, scale))
    got = pq.fake_quant_conv(_nchw(x), _oihw(w), scale).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_int8_conv_has_no_gradient():
    x8 = torch.zeros((1, 32, 4, 4), dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    w8 = torch.zeros((8, 3, 3, 32), dtype=torch.int8)
    bias = torch.zeros(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        int8_conv(x8, w8, torch.ones(8), bias, 1, 1, torch.float32)
    with torch.no_grad():
        assert int8_conv(x8, w8, torch.ones(8), bias, 1, 1, torch.float32).shape == (1, 8, 4, 4)


# --------------------------------------------- trunk at 64x64 (up_to 5_3)


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def trunk():
    """The port's seeded SSD, its weights as JAX variables, two seeded
    images at 64x64, the JAX package's calibration and its int8 trunk
    outputs in its paired block-1 layout (the default) and its plain one."""
    model = SSD(num_classes=21, seed=0)
    variables = jax_variables_from_state_dict(model.state_dict())
    imgs = np.random.default_rng(2).random((2, IMSIZE, IMSIZE, 3)).astype(np.float32)
    jqd = jq.calibrate_trunk(JaxSSD(num_classes=21), variables, [imgs])
    jint8 = {paired: np.asarray(JaxSSD(num_classes=21, trunk_int8=True, paired_block1=paired).apply(
        {**variables, "quant": jax_quant_collection(jqd)}, imgs, train=False, up_to="5_3",
        mutable=["batch_stats"])[0]) for paired in (True, False)}
    return model, imgs, jqd, jint8


def test_calibrate_trunk_matches_jax(trunk):
    """The 12 amaxes within rtol 1e-5 of the JAX package's (float forwards
    differ by ~1e-6); `margin` scales them; the running statistics and the
    model's mode are left as they were."""
    model, imgs, jqd, _ = trunk
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    qd = pq.calibrate_trunk(model, [imgs])
    assert set(qd) == set(jqd) == {f"amax_{layer}" for layer in pq.QUANT_LAYERS}
    for k in qd:
        assert np.isclose(qd[k], jqd[k], rtol=1e-5, atol=0), (k, qd[k], jqd[k])
    q2 = pq.calibrate_trunk(model, [imgs, torch.from_numpy(imgs)], margin=1.25)
    assert all(np.isclose(q2[k], 1.25 * qd[k], rtol=1e-6) for k in qd)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in stats.items())
    assert model.training and not model.quant_calibrate and model.quant_observer is None
    with pytest.raises(ValueError, match="at least one batch"):
        pq.calibrate_trunk(model, [])


def test_int8_trunk_matches_jax(trunk):
    """Fed the JAX package's amaxes, the port's int8 trunk output against the
    JAX package's: as close as the JAX package's two layouts of the same
    int8 trunk are to each other (rel-L2 within 1.25x theirs). Float
    reassociation (BN reduction order, XLA's FMAs) flips knife-edge int8
    roundings, and with random weights each flip spreads through the next
    quantized layers: the JAX package's paired and plain block 1 differ by
    rel-L2 ~0.095 here, the port from either by ~0.10, so no tighter bound
    holds for either package. Each
    layer's arithmetic is held bit-equal in `test_one_quantized_layer_matches_jax`.
    The JAX package's thresholds against the float trunk hold: cosine >
    0.97, std ratio in (0.5, 2)."""
    model, imgs, jqd, jint8 = trunk
    x = torch.from_numpy(imgs)
    q = SSD(num_classes=21, trunk_int8=True)
    q.load_state_dict(model.state_dict())
    q.set_quant(jqd)
    assert "quant_amax" not in q.state_dict()
    with torch.no_grad():
        ref = model(x, up_to="5_3").numpy()
        out = q(x, up_to="5_3").numpy()
    assert out.shape == jint8[True].shape == ref.shape == (2, 4, 4, 512) and np.isfinite(out).all()
    jax_spread = _rel_l2(jint8[True], jint8[False])
    for paired in (True, False):
        assert _rel_l2(out, jint8[paired]) <= 1.25 * jax_spread, (paired, _rel_l2(out, jint8[paired]), jax_spread)
    assert _cosine(ref, out) > 0.97
    assert 0.5 < float(np.std(out) / np.std(ref)) < 2.0


def test_conv12_int8_matches_jax(trunk):
    """conv12_int8=True puts conv_1_2 on the int8 path too (12 int8 convs in
    the trunk): block 1's output against the JAX package's plain-layout
    int8 conv_1_2 (its staggered form is bit-identical to that), within its
    own test's bound for block-1 reassociation (tests/test_quant.py: atol
    0.05, mean |d| < 1e-3)."""
    model, imgs, jqd, _ = trunk
    variables = jax_variables_from_state_dict(model.state_dict())
    want = np.asarray(JaxSSD(num_classes=21, trunk_int8=True, conv12_int8=True, paired_block1=False).apply(
        {**variables, "quant": jax_quant_collection(jqd)}, imgs, train=False, up_to="1_2", mutable=["batch_stats"])[0])
    q = SSD(num_classes=21, trunk_int8=True, conv12_int8=True)
    q.load_state_dict(model.state_dict())
    q.set_quant(jqd)
    calls = []
    with torch.no_grad():
        real = ssd_mod.int8_conv
        ssd_mod.int8_conv = lambda *a: calls.append(1) or real(*a)
        try:
            got = q(torch.from_numpy(imgs), up_to="1_2").numpy()
            q(torch.from_numpy(imgs), up_to="5_3")
        finally:
            ssd_mod.int8_conv = real
    assert len(calls) == 1 + 12
    np.testing.assert_allclose(got, want, atol=0.05)
    assert float(np.mean(np.abs(got - want))) < 1e-3


def test_saturation_rates(trunk):
    """0 at pure abs-max; above 0.05 somewhere with every amax shrunk 10x."""
    model, imgs, _, _ = trunk
    qd = pq.calibrate_trunk(model, [imgs])
    rates = pq.saturation_rates(model, qd, [imgs])
    assert set(rates) == set(pq.QUANT_LAYERS)
    assert all(r == 0.0 for r in rates.values()), rates
    rates10 = pq.saturation_rates(model, {k: v / 10.0 for k, v in qd.items()}, [imgs])
    assert max(rates10.values()) > 0.05, rates10


# ------------------------------------------------ the full model at 264


@pytest.fixture(scope="module")
def full():
    """The port's seeded SSD and its JAX variables at the smallest full
    pyramid, two seeded images (with one, batch statistics zero the 1x1 map
    of layer 11_2, and head 11_2 would calibrate to 0)."""
    model = SSD(num_classes=21, seed=0)
    imgs = np.random.default_rng(5).random((2, FULL_IMSIZE, FULL_IMSIZE, 3)).astype(np.float32)
    return model, jax_variables_from_state_dict(model.state_dict()), imgs


@pytest.mark.slow
def test_full_int8_tracks_float(full):
    """calibrate_full gives the 28 amaxes; the full-int8 output (trunk,
    extras, heads) tracks the float output, cosine > 0.95 (the JAX
    package's threshold; random weights are the worst case). Port only:
    marked slow, chip_smoke.py's phase_moved_training holds it on the
    card."""
    model, _, imgs = full
    qd = pq.calibrate_full(model, [imgs])
    assert set(qd) == {f"amax_{layer}" for layer in pq.FULL_QUANT_LAYERS} and all(v > 0 for v in qd.values())
    q = SSD(num_classes=21, full_int8=True)
    q.load_state_dict(model.state_dict())
    q.set_quant(qd)
    with torch.no_grad():
        ref = model(torch.from_numpy(imgs)).numpy()
        out = q(torch.from_numpy(imgs)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _cosine(ref, out) > 0.95


def test_trainer_refuses_full_int8_and_a_trainable_trunk(full):
    model, _, _ = full
    df = default_boxes(feature_grids_for(FULL_IMSIZE))
    qd = {f"amax_{layer}": 1.0 for layer in pq.FULL_QUANT_LAYERS}
    with pytest.raises(ValueError, match="serving-only"):
        Trainer(SSD(full_int8=True), default_boxes=df, quant=qd, device="cpu")
    with pytest.raises(ValueError, match="calibrat"):
        Trainer(SSD(trunk_int8=True), default_boxes=df, device="cpu")
    trainer = Trainer(SSD(trunk_int8=True), default_boxes=df, quant=qd, device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        trainer.init_state(lambda ps: torch.optim.SGD(ps, lr=1e-3), is_trainable=lambda name: True)


def test_trainer_int8_step_matches_jax(full):
    """One Trainer(quant=) step at 264 from the same weights and scales as
    the JAX package's Trainer (batch 1, as its test): the loss finite and
    within 2e-3 relative of JAX's, the trunk bit-unchanged, a head updated.
    The int8 step cannot agree to 1e-4: float reassociation flips
    knife-edge int8 roundings in the trunk (see
    `test_int8_trunk_matches_jax`), which moves the loss by ~8e-4 here; the
    JAX package's own paired and plain block-1 layouts of this step disagree
    on it too."""
    model, variables, imgs = full
    imgs = imgs[:1]
    qd = pq.calibrate_trunk(model, [imgs])
    targets = np.zeros((1, 2, 25), np.float32)
    targets[:, 0, :4] = [0.5, 0.5, 0.4, 0.4]
    targets[:, 0, 9] = 1.0

    jtrainer = JaxTrainer(JaxSSD(num_classes=21, trunk_int8=True),
                          default_boxes=jax_default_boxes(jax_grids(FULL_IMSIZE)), quant=qd)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), imgs, optax.sgd(1e-3),
                                 variables=jax.tree.map(jnp.asarray, variables))
    _, jloss = jtrainer.train_step(jstate, jnp.asarray(imgs), jnp.asarray(targets))

    q = SSD(num_classes=21, trunk_int8=True)
    q.load_state_dict(model.state_dict())
    trainer = Trainer(q, default_boxes=default_boxes(feature_grids_for(FULL_IMSIZE)), quant=qd, device="cpu")
    state = trainer.init_state(lambda ps: torch.optim.SGD(ps, lr=1e-3))
    assert q.quant_reciprocal
    assert q.quant_amax.tolist()[:len(pq.QUANT_LAYERS)] == [float(np.float32(qd[f"amax_{layer}"]))
                                                            for layer in pq.QUANT_LAYERS]
    trunk_before = q.features["conv_3_1"].weight.clone()
    heads_before = {k: v.clone() for k, v in state.trainable.items() if k.startswith("detectors.")}
    loss = trainer.train_step(state, imgs, targets)
    assert torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    assert torch.equal(trunk_before, q.features["conv_3_1"].weight)
    assert any(not torch.equal(v, state.trainable[k]) for k, v in heads_before.items())

"""Port parity for conv_1_2 (ops/conv12.py) against the JAX package's
`conv12_paired` (the Pallas kernel, run in interpret mode as
tests/test_conv12_pallas.py runs it) and its XLA oracle `_xla_paired`, and of
`SSD(conv12_kernel=True)` against the JAX model with the same flag (CPU).

The port's input is NCHW in the channels_last memory format; the JAX side gets
the same numpy array as NHWC, reshaped to the paired-x layout (N, H, W/2, 2C).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import object_detection_torch2_tpu.ops.conv12_pallas as c12
from object_detection_torch2_tpu.models.ssd import SSD as JaxSSD
from object_detection_torch2_tpu_torch.models.convert import ssd_state_dict_from_jax_variables
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.ops import conv12_cuda
from object_detection_torch2_tpu_torch.ops.conv12 import conv12, conv12_backward, conv12_plain

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(c12, "_INTERPRET", True)


def _case(n, h, w, seed, c=64):
    """Post-ReLU-scale input (NHWC), kaiming fan_out weights (HWIO), small bias."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((n, h, w, c)), 0).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * np.sqrt(2.0 / (9 * c))).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, wt, b


def _port(x, wt, b):
    """NHWC / HWIO numpy -> the port's channels_last x, OIHW w, b."""
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    return xt, torch.from_numpy(np.ascontiguousarray(np.transpose(wt, (3, 2, 0, 1)))), torch.from_numpy(b)


def _paired(x):
    n, h, w, c = x.shape
    return jnp.asarray(x.reshape(n, h, w // 2, 2 * c))


@pytest.mark.parametrize("n,h,w", [(2, 30, 16), (1, 38, 50)])
def test_plain_matches_jax_kernel_and_xla(n, h, w):
    """rtol/atol 1e-5: float32 sums of 576 terms in another order."""
    x, wt, b = _case(n, h, w, seed=h)
    got = conv12_plain(*_port(x, wt, b))
    assert got.dtype == torch.float32 and got.shape == (n, 64, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    xp = _paired(x)
    for ref in (c12.conv12_paired(xp, jnp.asarray(wt), jnp.asarray(b)), c12._xla_paired(xp, jnp.asarray(wt), jnp.asarray(b))):
        np.testing.assert_allclose(got, np.asarray(ref).reshape(n, h, w, 64), rtol=1e-5, atol=1e-5)


def test_gradients_match_jax_custom_vjp():
    """d/dx, d/dw, d/db of sum(y^2) against the JAX kernel's custom VJP
    (which delegates to `_xla_paired`), rtol/atol 1e-4: through autograd of the
    custom op (the CPU path) and through `conv12_backward` (the op's gradient
    on every device, plain PyTorch math, called here with the saved
    tensors); the op's gradient is autograd's of the plain version, bit for
    bit."""
    n, h, w = 1, 30, 16
    x, wt, b = _case(n, h, w, seed=3)
    gj = jax.grad(lambda a, k, c: jnp.sum(c12.conv12_paired(a, k, c) ** 2), argnums=(0, 1, 2))(
        _paired(x), jnp.asarray(wt), jnp.asarray(b))
    want = (np.asarray(gj[0]).reshape(n, h, w, 64), np.transpose(np.asarray(gj[1]), (3, 2, 0, 1)), np.asarray(gj[2]))

    xt, wtt, bt = (t.clone().requires_grad_(True) for t in _port(x, wt, b))
    y = conv12(xt, wtt, bt)
    (y ** 2).sum().backward()
    ctx = types.SimpleNamespace(saved_tensors=(xt.detach(), wtt.detach()), needs_input_grad=(True, True, True, False),
                                bias_dtype=torch.float32)
    by_function = conv12_backward(ctx, 2 * y.detach())[:3]
    xp, wp, bp = (t.clone().requires_grad_(True) for t in _port(x, wt, b))
    (conv12_plain(xp, wp, bp) ** 2).sum().backward()
    for got, plain in zip((xt.grad, wtt.grad, bt.grad), (xp.grad, wp.grad, bp.grad)):
        assert torch.equal(got, plain)
    for got in ((xt.grad, wtt.grad, bt.grad), by_function):
        np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), want[0], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-4, atol=1e-4)


def test_plain_bfloat16_rounds_once():
    """bfloat16 in: the float32 sum and bias, then one cast, bit for bit."""
    x, wt, b = _case(2, 12, 10, seed=5)
    xt, wtt, bt = _port(x, wt, b)
    xb, wb = xt.bfloat16(), wtt.bfloat16()
    got = conv12_plain(xb, wb, bt)
    want = (torch.nn.functional.conv2d(xb.float(), wb.float(), None, padding=1) + bt[None, :, None, None]).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_dispatch_and_wrapper_checks():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses a
    CPU tensor before it loads or builds anything; other devices raise."""
    x, wt, b = _case(1, 6, 8, seed=7)
    xt, wtt, bt = _port(x, wt, b)
    before = conv12_cuda.launches
    assert torch.equal(conv12(xt, wtt, bt), conv12_plain(xt, wtt, bt))
    with pytest.raises(ValueError, match="CUDA"):
        conv12_cuda.conv12_cuda(xt, wtt, bt)
    with pytest.raises(ValueError, match="device"):
        conv12(xt.to("meta"), wtt.to("meta"), bt.to("meta"))
    assert conv12_cuda.launches == before


def test_pack_weights_layout():
    w = torch.arange(64 * 64 * 9, dtype=torch.float32).reshape(64, 64, 3, 3)
    wp = conv12_cuda.pack_weights(w.bfloat16())
    assert wp.shape == (3, 3, 64, 64) and wp.dtype == torch.float32 and wp.is_contiguous()
    assert wp[1, 2, 5, 7] == w.bfloat16()[7, 5, 1, 2].float()



def test_pack_weights_bf16_layout():
    """The tensor-core kernel's weights: (co, ci, ky, kx) -> (ky, kx, co, ci),
    bfloat16, values unchanged bit for bit; float32 weights are refused."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 64, 3, 3)).astype(np.float32)).bfloat16()
    wp = conv12_cuda.pack_weights_bf16(w)
    assert wp.shape == (3, 3, 64, 64) and wp.dtype == torch.bfloat16 and wp.is_contiguous()
    for ky, kx, co, ci in [(0, 0, 0, 0), (1, 2, 5, 7), (2, 1, 63, 0), (2, 2, 17, 63)]:
        assert wp[ky, kx, co, ci].view(torch.int16) == w[co, ci, ky, kx].view(torch.int16)
    assert torch.equal(wp.view(9, 64, 64), w.permute(2, 3, 0, 1).reshape(9, 64, 64))
    assert conv12_cuda.KERNEL_OF == {torch.float32: "conv12", torch.bfloat16: "conv12_bf16"}
    with pytest.raises(TypeError):
        conv12_cuda.pack_weights_bf16(w.float())

@pytest.fixture(scope="module")
def ssd_264():
    """JAX SSD(conv12_kernel=True) (interpret mode) at imsize 264, batch 1,
    and its init variables, as tests/test_conv12_pallas.py runs it."""
    x = np.random.default_rng(11).uniform(0, 1, (1, 264, 264, 3)).astype(np.float32)
    variables = JaxSSD(num_classes=21, conv12_kernel=False).init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    c12._INTERPRET = True
    try:
        out = JaxSSD(num_classes=21, conv12_kernel=True).apply(variables, jnp.asarray(x), train=False,
                                                             use_batch_stats=True, mutable=["batch_stats"])[0]
    finally:
        c12._INTERPRET = False
    return x, jax.tree.map(np.asarray, variables), np.asarray(out)


def test_ssd_conv12_kernel_matches_jax(ssd_264, monkeypatch):
    """The whole SSD with conv_1_2 on the kernel path (the plain version on
    the CPU), batch statistics, against the JAX model with the same flag:
    rtol/atol 1e-3, the JAX package's own pin for this composition. The
    BN+ReLU output that reaches conv_1_2 is channels_last already, so the
    model's explicit layout call copies nothing."""
    x, variables, want = ssd_264
    seen = []
    conv12_layer = SSD._conv12

    def spy(self, conv, xin):
        seen.append(xin.is_contiguous(memory_format=torch.channels_last))
        return conv12_layer(self, conv, xin)

    monkeypatch.setattr(SSD, "_conv12", spy)
    model = SSD(num_classes=21, conv12_kernel=True)
    model.load_state_dict(ssd_state_dict_from_jax_variables(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), use_batch_stats=True).numpy()
    assert seen == [True]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)

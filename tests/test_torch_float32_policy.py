"""The port's float32 convolution policy, `true_float32(dtype)`
(object_detection_torch2_tpu_torch/__init__.py): float32 and float64
convolutions run off cuDNN with TF32 off; any other dtype keeps cuDNN's flags
as the caller left them, with TF32 off, as before the policy. Each path
enters the context of the dtype its convolutions run in: the models'
forwards, `Trainer`'s backward, the conv_1_2 plain version and an exported
program's runs. On the CPU none of these flags changes a result: the VGG16
golden forward is bit-equal with and without the policy. The card's side
(the golden on the card, batch-split invariance) is in tests/test_torch_cuda.py
and chip_smoke.py's `phase_float32_fidelity`."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_detection_torch2_tpu.utils.testing import synth_state_dict_from_manifest
from object_detection_torch2_tpu_torch import true_float32
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.models import convert
from object_detection_torch2_tpu_torch.models import vgg16 as vgg16_module
from object_detection_torch2_tpu_torch.models.quant import QUANT_LAYERS
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.models.vgg16 import VGG16
from object_detection_torch2_tpu_torch.ops.conv12 import conv12_plain
from object_detection_torch2_tpu_torch.serving import conv_dtype
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

cudnn = torch.backends.cudnn
FLAGS = ("enabled", "benchmark", "deterministic", "allow_tf32")
# flags a caller may have set before entering the context
CALLER_STATES = ({"enabled": True, "benchmark": False, "deterministic": False},
                 {"enabled": True, "benchmark": True, "deterministic": True})


def _flags() -> dict:
    return {k: getattr(cudnn, k) for k in FLAGS}


def _todays(caller: dict) -> dict:
    """The context before the policy, for every dtype: TF32 off, the rest as
    the caller left it."""
    return {**caller, "allow_tf32": False}


def _policy(caller: dict) -> dict:
    return {**caller, "enabled": False, "allow_tf32": False}


def _inside(dtype, caller: dict) -> dict:
    """The flags inside true_float32(dtype) when the caller left `caller`;
    the flags are the caller's again after it."""
    with cudnn.flags(**caller, allow_tf32=True):
        before = _flags()
        with true_float32(dtype):
            inside = _flags()
        assert _flags() == before
    return inside


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_float32_and_float64_take_the_policy(dtype):
    for caller in CALLER_STATES:
        assert _inside(dtype, caller) == _policy(caller)


@pytest.mark.parametrize("dtype", [torch.bfloat16, None])
def test_other_dtypes_keep_the_context_of_before(dtype):
    for caller in CALLER_STATES:
        assert _inside(dtype, caller) == _todays(caller)


class _Seen:
    """Stands in for F.conv2d: the cuDNN flags at each float convolution of
    the forward, and at each one's backward (a hook on its output)."""

    def __init__(self, monkeypatch):
        self.forward, self.backward, real = [], [], F.conv2d

        def conv2d(x, *args, **kwargs):
            self.forward.append((x.dtype, _flags()))
            y = real(x, *args, **kwargs)
            if y.requires_grad:
                y.register_hook(lambda g: self.backward.append(_flags()))
            return y

        monkeypatch.setattr(F, "conv2d", conv2d)


@pytest.mark.parametrize("dtype,trunk_int8", [
    (torch.float32, False), (torch.float64, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_trainer_step_runs_each_convolution_under_its_dtype(monkeypatch, dtype, trunk_int8):
    """A `Trainer` step of the SSD (imsize 264, batch 1): every float
    convolution of the forward and of the backward (the extras and heads)
    runs in the model's dtype under the flags `true_float32` gives it, and
    an int8 trunk's layers keep the bfloat16 context. The caller's flags are
    back after."""
    caller = CALLER_STATES[0]
    quant = {f"amax_{layer}": 4.0 for layer in QUANT_LAYERS} if trunk_int8 else None
    trainer = Trainer(SSD(num_classes=21, dtype=dtype, seed=0, trunk_int8=trunk_int8), quant=quant,
                      default_boxes=default_boxes(feature_grids_for(264)), device="cpu")
    state = trainer.init_state(lambda ps: torch.optim.SGD(ps, lr=1e-3))
    images = np.random.default_rng(0).integers(0, 256, (1, 264, 264, 3), dtype=np.uint8)
    targets = np.zeros((1, 2, 25), np.float32)
    targets[0, 0, :4], targets[0, 0, 5] = (0.5, 0.5, 0.3, 0.3), 1.0
    seen = _Seen(monkeypatch)
    with cudnn.flags(**caller, allow_tf32=True):
        trainer.train_step(state, images, targets)
        assert _flags() == {**caller, "allow_tf32": True}
    want = _policy(caller) if dtype in (torch.float32, torch.float64) else _todays(caller)
    # blocks 2-5's 11 convs are int8; on the CPU their plain version sums in
    # float32 convolutions, which keep the bfloat16 model's context
    assert sum(d == dtype for d, _ in seen.forward) == (23 + 6 - 11 if trunk_int8 else 23 + 6)
    assert all(d in (dtype, torch.float32) and f == want for d, f in seen.forward)
    assert len(seen.backward) == 10 + 6 and all(f == want for f in seen.backward)


def test_vgg16_and_conv12_plain_enter_the_float32_policy(monkeypatch):
    """A VGG16 forward (float32, imsize 200, batch 1) and the conv_1_2 plain
    version, whose sums are float32 whatever the input type, run their
    convolutions under the policy; a bfloat16 VGG16 under the flags of before.
    `SSD(conv12_kernel=True)` gives conv_1_2's output back in its input's
    layout: NCHW from the policy's float32 convolutions, channels_last from
    cuDNN's."""
    seen = _Seen(monkeypatch)
    x = torch.rand(1, 200, 200, 3, generator=torch.Generator().manual_seed(0))
    for dtype in (torch.float32, torch.bfloat16):
        with torch.no_grad():
            VGG16(num_classes=20, dtype=dtype, transfer_learning=True)(x, train=False)
    assert [d for d, _ in seen.forward] == [torch.float32] * 13 + [torch.bfloat16] * 13
    assert [f for _, f in seen.forward] == [_policy(_flags())] * 13 + [_todays(_flags())] * 13
    seen.forward.clear()
    xb = torch.rand(1, 64, 8, 8).to(torch.bfloat16)
    conv12_plain(xb, torch.rand(64, 64, 3, 3).to(torch.bfloat16), torch.rand(64))
    assert seen.forward == [(torch.float32, _policy(_flags()))]
    model = SSD(num_classes=21, seed=0, conv12_kernel=True)
    for layout in (torch.contiguous_format, torch.channels_last):
        x64 = torch.rand(2, 64, 8, 8).contiguous(memory_format=layout)
        assert model._conv12(model.features["conv_1_2"], x64).is_contiguous(memory_format=layout)


def test_exported_program_reports_its_convolution_dtype():
    """`serving.conv_dtype`: the dtype an exported program's convolutions
    run in, which its runs hand `true_float32`; None without a convolution."""

    class Net(torch.nn.Module):
        def __init__(self, dtype):
            super().__init__()
            self.dtype, self.conv = dtype, torch.nn.Conv2d(3, 4, 3)

        def forward(self, x):
            return F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), None).float()

    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        assert conv_dtype(torch.export.export(Net(dtype), (torch.rand(1, 3, 8, 8),))) == dtype
    assert conv_dtype(torch.export.export(torch.nn.ReLU(), (torch.rand(2),))) is None


def test_golden_forward_on_the_cpu_is_bit_equal_without_the_policy(goldens, monkeypatch):
    """The VGG16 golden forward (goldens/vgg_forward.npz: batch 2, imsize 200,
    the golden's weights; running and batch statistics) on the CPU gives the
    same logits bit for bit under the policy and under the context of
    before: on the CPU cuDNN's flags change nothing."""
    g = goldens("vgg_forward")
    sd = synth_state_dict_from_manifest(g["manifest_keys"], g["manifest_shapes"])
    model = VGG16(num_classes=20)
    model.load_state_dict(convert.vgg16_state_dict_from_jax_variables(convert.vgg16_variables_from_torch(sd)))
    model.eval()
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(g["x"], (0, 2, 3, 1))))

    def logits():
        with torch.no_grad():
            return [model(x, train=False, use_batch_stats=b) for b in (False, True)]

    policy = logits()
    monkeypatch.setattr(vgg16_module, "true_float32", lambda dtype=None: cudnn.flags(
        enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic, allow_tf32=False))
    before = logits()
    for a, b in zip(policy, before):
        assert torch.equal(a, b)
    np.testing.assert_allclose(policy[0].numpy(), g["out_eval"], atol=5e-2)

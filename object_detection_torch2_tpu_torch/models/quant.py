"""Int8 post-training quantization of the SSD's frozen layers
(counterpart of object_detection_torch2_tpu/models/quant.py; a copy of its
constants and scale file format, imports nothing of it).

Scheme, as the JAX package's (standard symmetric PTQ):
- weights: per-output-channel symmetric scales sw[c] = amax|W[c]| * (1/127),
  quantized from the frozen float weights (`weight_scales`,
  `quantize_weight`) once per weight version (`SSD` caches them), so weights
  files and converters are untouched;
- activations: one static scale per quantized layer input, sx =
  max(amax, 1e-12) * (1/127), from offline abs-max calibration
  (`calibrate_trunk`, `calibrate_full`) held in the model's `quant_amax`
  buffer (`SSD.set_quant`); the input is quantized by `quantize_act`
  (round half to even, clipped to +-127; on the card the one-pass kernel
  csrc/quantize_act.cu);
- the convolution: s8 x s8 -> s32, exact (ops/int8_conv.py: the kernel
  csrc/int8_conv.cu on the card), dequantized in its epilogue by the float32
  vector sx * sw, cast to the model's dtype, + bias in that dtype; BN and
  ReLU follow in float as on the float path.

Arithmetic matched to XLA's: the JAX package divides by the constant 127.0
inside jit, which XLA compiles into a multiplication by float32(1/127), so
`weight_scales` and the activation scale multiply by `INV_127`. `x / sx`
in `quantize_act` is a true division where the JAX package passes the scales
as jit arguments (serving); its Trainer closes over them as constants, which
XLA folds into a multiplication by the float32 reciprocal of sx, so
`quantize_act(..., reciprocal=True)` is the Trainer's form (`SSD.quant_reciprocal`).

No gradient flows through the int8 layers: the trunk is upstream of every
trainable parameter, and `Trainer` refuses `full_int8` (serving only) and a
trainable quantized trunk.

Scale files: `save_quant` writes `{amax_<layer>: float}` as
`json.dumps(indent=1, sort_keys=True)`, byte-identical to the JAX package's
`quant.json` / `quant_full.json` for the same scales; either package reads the
other's.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv  # noqa: F401  (the s8 x s8 -> s32 conv)
# the plain activation quantize; the int8 layers run it through the op
# odt::quantize_act (ops.int8_conv.quantize_act, one kernel on the card)
from object_detection_torch2_tpu_torch.ops.int8_conv import quantize_act_plain as quantize_act

# Quantized trunk layers: conv_1_2 and blocks 2-5 (all 3x3/s1/p1). conv_1_2
# runs int8 only with SSD(conv12_int8=True), but calibration always records it.
QUANT_LAYERS = ("1_2", "2_1", "2_2", "3_1", "3_2", "3_3", "4_1", "4_2", "4_3", "5_1", "5_2", "5_3")
# Serving-only full-model quantization (SSD.full_int8): the extra layers and
# the six detector heads too.
EXTRA_QUANT_LAYERS = ("6_1", "7_1", "8_1", "8_2", "9_1", "9_2", "10_1", "10_2", "11_1", "11_2")
HEAD_QUANT_LAYERS = ("det_4_3", "det_7_1", "det_8_2", "det_9_2", "det_10_2", "det_11_2")
FULL_QUANT_LAYERS = QUANT_LAYERS + EXTRA_QUANT_LAYERS + HEAD_QUANT_LAYERS

INV_127 = float(np.float32(1.0) / np.float32(127.0))  # XLA's folded x / 127.0
AMAX_FLOOR = 1e-12


def weight_scales(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, kh, kw) -> per-output-channel symmetric scales (Cout,) float32."""
    s = w.to(torch.float32).abs().amax(dim=(1, 2, 3)) * INV_127
    return torch.clamp_min(s, AMAX_FLOOR)


def quantize_weight(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Symmetric round-half-even int8 weights (Cout, Cin, kh, kw); scales (Cout,)."""
    q = torch.round(w.to(torch.float32) / scales[:, None, None, None])
    return torch.clamp(q, -127, 127).to(torch.int8)


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """The activation scale sx = max(amax, 1e-12) * float32(1/127)."""
    return torch.clamp_min(amax.to(torch.float32), AMAX_FLOOR) * INV_127


def fake_quant_conv(x: torch.Tensor, w: torch.Tensor, scale, stride: int = 1, pad: int = 1) -> torch.Tensor:
    """Float simulation of quantize -> int8 conv -> dequant (NCHW, OIHW), the
    conv in float64 over the dequantized operands: the reference for accuracy
    comparisons, quantization error included."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    sw = weight_scales(w)
    xq = quantize_act(x, scale).to(torch.float32) * scale
    wq = quantize_weight(w, sw).to(torch.float32) * sw[:, None, None, None]
    return torch.nn.functional.conv2d(xq.double(), wq.double(), stride=stride, padding=pad).float()


def _images(images, device) -> torch.Tensor:
    """A calibration batch on `device`: uint8 -> float32 / 255 (a true
    division, as the JAX package's eager cast), floats as they are."""
    images = torch.as_tensor(images).to(device)
    if images.dtype == torch.uint8:
        images = images.to(torch.float32) / 255.0
    return images


class _Calibrating:
    """Puts `model` on its float path in calibration mode with `observe` as
    the hook of every quantized layer's input; BatchNorm in eval mode, so the
    running statistics do not move. Restores everything on exit."""

    def __init__(self, model, observe):
        self.model, self.observe = model, observe

    def __enter__(self):
        m = self.model
        self.saved = (m.training, m.trunk_int8, m.full_int8, m.quant_calibrate, m.quant_observer)
        m.eval()
        m.trunk_int8 = m.full_int8 = False
        m.quant_calibrate, m.quant_observer = True, self.observe
        return m

    def __exit__(self, *exc):
        m = self.model
        training, m.trunk_int8, m.full_int8, m.quant_calibrate, m.quant_observer = self.saved
        m.train(training)


@torch.no_grad()
def calibrate_trunk(model, batches, use_batch_stats: bool = True, margin: float = 1.0,
                    up_to: str | None = "5_3") -> dict:
    """Abs-max activation calibration over `batches` (uint8 or [0, 1] float
    image batches (N, H, W, 3), e.g. augmented training batches) on the
    model's float path -> {amax_<layer>: float}, each amax times `margin`
    (1.0 = pure abs-max). The forward runs up to `up_to` (default '5_3': the
    trunk). The amaxes are reduced on the device and read once at the end;
    the running statistics do not move."""
    device = next(model.parameters()).device
    amax: dict = {}

    def observe(layer, x):
        a = x.abs().amax().to(torch.float32)
        amax[layer] = a if layer not in amax else torch.maximum(amax[layer], a)

    seen = False
    with _Calibrating(model, observe):
        for images in batches:
            model(_images(images, device), use_batch_stats=use_batch_stats, up_to=up_to)
            seen = True
    if not seen:
        raise ValueError("calibrate_trunk needs at least one batch")
    layers = list(amax)
    values = torch.stack([amax[layer] for layer in layers]).cpu().tolist()
    return {f"amax_{layer}": float(v) * margin for layer, v in zip(layers, values)}


def calibrate_full(model, batches, use_batch_stats: bool = True, margin: float = 1.0) -> dict:
    """Full-model calibration (trunk, extras and heads) for `full_int8`
    serving: `calibrate_trunk` through the detector heads (up_to=None)."""
    quant = calibrate_trunk(model, batches, use_batch_stats=use_batch_stats, margin=margin, up_to=None)
    return check_calibrated(quant, layers=FULL_QUANT_LAYERS)


def save_quant(path, quant: dict) -> None:
    Path(path).write_text(json.dumps(quant, indent=1, sort_keys=True))


def load_quant(path) -> dict:
    quant = json.loads(Path(path).read_text())
    check_calibrated(quant)
    return quant


def missing_layers(quant: dict | None, layers=QUANT_LAYERS) -> list:
    """Quantized layers without a positive calibrated amax: non-empty for a
    quant.json written before the layer set grew (e.g. without '1_2')."""
    if not quant:
        return list(layers)
    return [layer for layer in layers if not (float(quant.get(f"amax_{layer}", 0.0)) > 0.0)]


def check_calibrated(quant: dict | None, layers=QUANT_LAYERS) -> dict:
    """Raise unless every quantized layer has a positive calibrated amax (the
    JAX package's messages)."""
    if not quant:
        raise ValueError("trunk_int8 requires calibrated activation scales "
                         "(models/quant.py calibrate_trunk; cli: --quant_calibrate)")
    missing = missing_layers(quant, layers)
    if missing:
        raise ValueError(
            f"trunk_int8: uncalibrated/zero amax for layers {missing}. If this "
            f"quant.json predates an extension of QUANT_LAYERS it is stale — "
            f"delete it and rerun train.py --trunk_int8 (which recalibrates "
            f"and rewrites it), or recalibrate via models/quant.calibrate_trunk"
        )
    return quant


@torch.no_grad()
def saturation_rates(model, quant: dict, batches, use_batch_stats: bool = True, up_to: str | None = "5_3",
                     layers=QUANT_LAYERS) -> dict:
    """For each quantized layer, the fraction of its input entries whose |x|
    exceeds the calibrated amax of `quant` (the post-margin scales, as in
    quant.json): the entries the int8 path saturates at +-127. Counted on the
    device on the float calibration path and read once at the end."""
    device = next(model.parameters()).device
    amaxes = {layer: torch.tensor(np.float32(quant[f"amax_{layer}"]), device=device) for layer in layers}
    over = {layer: torch.zeros((), dtype=torch.int64, device=device) for layer in layers}
    total = dict.fromkeys(layers, 0)

    def observe(layer, x):
        if layer in amaxes:
            over[layer] += (x.to(torch.float32).abs() > amaxes[layer]).sum()
            total[layer] += x.numel()

    with _Calibrating(model, observe):
        for images in batches:
            model(_images(images, device), use_batch_stats=use_batch_stats, up_to=up_to)
    counts = torch.stack([over[layer] for layer in layers]).cpu().tolist()
    return {layer: c / max(total[layer], 1) for layer, c in zip(layers, counts)}

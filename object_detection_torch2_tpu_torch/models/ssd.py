"""SSD300 detector as a torch `nn.Module`
(counterpart of the plain-layout math of object_detection_torch2_tpu/models/ssd.py:443-526).

Architecture reproduces the reference (reference: src/model/ssd.py:22-106):

- vgg16_bn trunk `conv_L_S` / `bn_L_S`, `pool_5` dropped. The 'M_P' pool
  (pool_3) is MaxPool2d(2, 2, padding=1), padded with -inf — that pad is what
  yields 38x38 at conv4_3 for a 300x300 input;
- extra layers 6-11, each Conv+BN+ReLU (layer 6 a plain 3x3 conv, every extra
  layer with BatchNorm — the reference's own deviations from the paper);
- six 3x3 detector heads tapped after the ReLU of 4_3 / 7_1 / 8_2 / 9_2 / 10_2 /
  11_2, H-major flattened and concatenated to (N, P, num_classes + 4), float32.

Submodules are named after the reference's state_dict keys
(`features.conv_L_S`, `features.bn_L_S`, `detectors.det_L_S`), so its
state_dicts load with `load_state_dict` as they are.

Layouts: the public input is NHWC in [0, 1] like the JAX package's; inside,
activations are NCHW tensors in the channels_last memory format (the
permuted NHWC input already has those strides), which cuDNN runs natively.

Numerics: convs run in `dtype` (float32 or bfloat16), BatchNorm math in
float32. In float32 the convs run in true f32, as the JAX package's
`precision=HIGHEST` does: the forward switches cuDNN's TF32 off
(`true_float32`), and `Trainer` takes its gradients inside the same context.
`dtype=torch.float64` is an exact reference on the CPU (convs, BatchNorm and
the output in float64; the parameters stay float32): the extras' float32
gradients move by up to tens of percent with the reduction order of the
batch statistics (PERF.md), so two computations that should agree, e.g. one
process against a data-parallel mesh, are held to each other in float64.

`conv12_kernel=True` runs layer 1_2 through `ops.conv12.conv12`: on the card
the hand-written kernel csrc/conv12.cu, which sums in float32 and adds the
float32 bias before its one cast (in bfloat16 that is one rounding fewer than
the plain path's bias add in bfloat16). None and False keep it on cuDNN, the
JAX package's default.

`SSD.is_trainable(name)` is the frozen-trunk partition of the reference's
`train_params()`: extras 6-11 (conv and BN) and the detector heads train.

Int8 (models/quant.py; the JAX package's models/ssd.py:326-358, 382-441):
- `trunk_int8=True` runs blocks 2-5 of the trunk as s8 x s8 -> s32 convs
  (ops/int8_conv.py: the kernel csrc/int8_conv.cu on the card): the input
  quantized with its layer's static scale (`ops.int8_conv.quantize_act`: the
  kernel csrc/quantize_act.cu on the card), the weights per output channel
  from the float weights, the dequantization and bias in the kernel's
  epilogue; BN and ReLU stay float. The int8 weights and their scales are
  computed once per weight version and cached (`_int8_weight`). conv_1_2
  joins them with `conv12_int8=True` (default False, as in the JAX
  package); otherwise it keeps its float path (the conv12 kernel with
  `conv12_kernel=True`).
- `full_int8=True` (serving only) quantizes the trunk, the extra layers and
  the six heads.
- `quant_calibrate=True` runs the float path and hands every quantized
  layer's input to `quant_observer(layer, x)` (calibration and saturation
  rates drive it).
- The activation amaxes live in `quant_amax`, a float32 buffer of one value
  per `quant.FULL_QUANT_LAYERS` entry that moves with the model but is not
  in its state_dict (the weights files are unchanged); `set_quant` fills it.
  `quant_reciprocal=True` quantizes activations with the reciprocal of the
  scale, as the JAX package's Trainer does (`Trainer` sets it).
The JAX package's `conv12_staggered_int8` is bit-identical to the plain int8
conv by construction (its ssd.py:174-177), so it is not ported.

`forward(..., up_to=layer)` returns the activation right after that layer
('1_1'..'5_3', '6_1'..'11_2': after its ReLU, and after the block's pool when
it is the block's last conv), NHWC in the model's dtype, instead of the head
outputs.

Not ported here: the TPU lane layouts of the same math (`paired_block1`,
`conv12_stagger`, `conv12_pad_pairs`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from object_detection_torch2_tpu_torch import true_float32
from object_detection_torch2_tpu_torch.models import quant
from object_detection_torch2_tpu_torch.models.bn import BatchNorm, set_mesh  # noqa: F401
from object_detection_torch2_tpu_torch.ops.conv12 import conv12
from object_detection_torch2_tpu_torch.ops.int8_conv import int8_conv, pack_weight, quantize_act

# ImageNet normalization (reference: src/model/vgg16.py:19-20)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# VGG16-bn conv blocks: block L -> (channels per conv, pool spec after block).
# Pool 'M' = valid 2x2/2; 'M_P' = 2x2/2 with padding 1 (reference: vgg16.py:25-30).
# Block 5's pool is dropped in SSD (reference: ssd.py:38-40).
VGG_BLOCKS = (
    (1, (64, 64), "M"),
    (2, (128, 128), "M"),
    (3, (256, 256, 256), "M_P"),
    (4, (512, 512, 512), "M"),
    (5, (512, 512, 512), None),
)

# Extra layers: (name, kernel, out_channels, stride, padding) (reference: ssd.py:49-54)
EXTRA_LAYERS = (
    ("6_1", 3, 1024, 1, 1),
    ("7_1", 1, 1024, 1, 0),
    ("8_1", 1, 256, 1, 0),
    ("8_2", 3, 512, 2, 1),
    ("9_1", 1, 128, 1, 0),
    ("9_2", 3, 256, 2, 1),
    ("10_1", 1, 128, 1, 0),
    ("10_2", 3, 256, 1, 0),
    ("11_1", 1, 128, 1, 0),
    ("11_2", 3, 256, 1, 0),
)

# Detection taps: layer suffix -> anchors-per-cell A (reference: ssd.py:70-77)
DETECTOR_TAPS = (("4_3", 4), ("7_1", 6), ("8_2", 6), ("9_2", 6), ("10_2", 4), ("11_2", 4))

DTYPES = (torch.float32, torch.bfloat16)
REFERENCE_DTYPE = torch.float64  # the exact CPU reference (see the module docstring)


def _layer_specs():
    specs, cin = [], 3
    for block, channels, pool in VGG_BLOCKS:
        for sub, ch in enumerate(channels, start=1):
            last = sub == len(channels)
            specs.append((f"{block}_{sub}", cin, ch, 3, 1, 1, pool if last else None))
            cin = ch
    for suffix, kernel, ch, stride, pad in EXTRA_LAYERS:
        specs.append((suffix, cin, ch, kernel, stride, pad, None))
        cin = ch
    return tuple(specs)


# (suffix, in_ch, out_ch, kernel, stride, pad, pool_after) for every
# conv+BN+ReLU layer of the trunk and the extras, in forward order
LAYER_SPECS = _layer_specs()
# position of each quantizable layer's amax in SSD.quant_amax
_QUANT_INDEX = {layer: i for i, layer in enumerate(quant.FULL_QUANT_LAYERS)}


def normalize_image(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel, NHWC, in float32 (reference: vgg16.py:103-115).

    Multiplies by the float32 reciprocal of std, as XLA compiles the JAX
    package's division by a constant. The constants reach the card by copies
    that do not wait for it (no host sync)."""
    x = x.to(torch.float32)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(x.device, non_blocking=True)
    inv_std = 1.0 / torch.tensor(IMAGENET_STD, dtype=torch.float32)
    return (x - mean) * inv_std.to(x.device, non_blocking=True)


def output_dtype(dtype: torch.dtype) -> torch.dtype:
    """The head outputs' dtype of a model computing in `dtype`: float32, or
    float64 for the reference dtype."""
    return REFERENCE_DTYPE if dtype == REFERENCE_DTYPE else torch.float32


class SSD(nn.Module):
    """SSD300. Input (N, H, W, 3) in [0, 1]; output (N, P, num_classes + 4) float32.

    `forward(x, use_batch_stats, batch_mask)`: `use_batch_stats=True` is the
    reference-parity default (quirk Q9: the reference never calls .eval(), so
    its inference normalizes with batch statistics). Running statistics are
    updated only in `training` mode. `batch_mask` (N,) marks the real rows of a
    padded batch (see models/bn.py).

    Weights are drawn from `torch.Generator().manual_seed(seed)` on the CPU —
    kaiming-normal fan_out convs with zero bias (reference: ssd.py:144-146) —
    so a seed gives the same model on every device.
    """

    def __init__(self, num_classes: int = 21, dtype: torch.dtype = torch.float32, seed: int = 0,
                 conv12_kernel: bool | None = None, trunk_int8: bool = False, full_int8: bool = False,
                 conv12_int8: bool = False, quant_calibrate: bool = False):
        super().__init__()
        if dtype not in DTYPES + (REFERENCE_DTYPE,):
            raise ValueError(f"dtype must be one of {DTYPES}, got {dtype}")
        self.num_classes = num_classes
        self.dtype = dtype
        self.conv12_kernel = conv12_kernel
        self.trunk_int8 = trunk_int8
        self.full_int8 = full_int8
        self.conv12_int8 = conv12_int8
        self.quant_calibrate = quant_calibrate
        self.quant_reciprocal = False
        self.quant_observer = None
        self.register_buffer("quant_amax", torch.zeros(len(quant.FULL_QUANT_LAYERS)), persistent=False)
        self._int8_weights = {}  # layer -> (key, weight, w8, sw): see _int8_weight
        self.features = nn.ModuleDict()
        for suffix, cin, cout, k, stride, pad, _ in LAYER_SPECS:
            self.features[f"conv_{suffix}"] = nn.Conv2d(cin, cout, k, stride=stride, padding=pad)
            self.features[f"bn_{suffix}"] = BatchNorm(cout)
        out_ch = dict((s, cout) for s, _, cout, *_ in LAYER_SPECS)
        self.detectors = nn.ModuleDict({
            f"det_{s}": nn.Conv2d(out_ch[s], a * (num_classes + 4), 3, padding=1)
            for s, a in DETECTOR_TAPS
        })
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=g)
                nn.init.zeros_(m.bias)

    @staticmethod
    def is_trainable(name: str) -> bool:
        """Trainable-parameter predicate of `SSD.train_params` (reference:
        src/model/ssd.py:160-179): extra layers (6_1 onward) and detector
        heads train; the VGG trunk (blocks 1-5) is frozen. `name` is a
        parameter or module name (`features.conv_6_1.weight`, `det_4_3`)."""
        for part in name.split("."):
            if part.startswith("det_"):
                return True
            for prefix in ("conv_", "bn_"):
                if part.startswith(prefix):
                    return int(part[len(prefix):].split("_")[0]) >= 6
        return False

    def set_quant(self, scales: dict) -> None:
        """Hold the calibrated amaxes {amax_<layer>: float} (a quant.json's
        contents) in `quant_amax` on the model's device, float32; a layer the
        dict lacks gets 0 (`quant.check_calibrated` is the caller's check)."""
        values = [np.float32(scales.get(f"amax_{layer}", 0.0)) for layer in quant.FULL_QUANT_LAYERS]
        self.quant_amax.copy_(torch.tensor(np.array(values, np.float32)))

    def _int8_layer(self, suffix: str) -> bool:
        """Whether layer `suffix` (a LAYER_SPECS suffix or 'det_<tap>') runs int8."""
        if suffix.startswith("det_") or int(suffix.split("_")[0]) >= 6:
            return self.full_int8
        if suffix == "1_2":
            return (self.trunk_int8 or self.full_int8) and self.conv12_int8
        return int(suffix.split("_")[0]) >= 2 and (self.trunk_int8 or self.full_int8)

    def _observe(self, layer: str, x: torch.Tensor) -> None:
        if self.quant_calibrate and self.quant_observer is not None and layer in _QUANT_INDEX:
            self.quant_observer(layer, x)

    def _int8_weight(self, layer: str, conv: nn.Conv2d) -> tuple[torch.Tensor, torch.Tensor]:
        """(w8, sw) of a quantized conv: its weights quantized per output
        channel and packed (Cout, kh, kw, Cin), and their float32 scales (Cout,).
        The weights are frozen, so both are computed once and cached, keyed on
        (weight.data_ptr(), weight._version, device, dtype): an optimizer step,
        `load_state_dict` or any in-place edit of the weight (not through
        `.data`, which has a version counter of its own) recomputes them. The
        entry holds the weight it was made from, so its memory is not reused
        by another tensor while the key stands. While `torch.export` traces,
        the cache is bypassed and the quantization stays in the graph."""
        w = conv.weight
        if torch.compiler.is_exporting():
            sw = quant.weight_scales(w)
            return pack_weight(quant.quantize_weight(w, sw)), sw
        key = (w.data_ptr(), w._version, w.device, w.dtype)
        hit = self._int8_weights.get(layer)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                sw = quant.weight_scales(w)
                hit = (key, w.detach(), pack_weight(quant.quantize_weight(w, sw)), sw)
            self._int8_weights[layer] = hit
        return hit[2], hit[3]

    def _conv_int8(self, layer: str, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """conv on the int8 path: quantize x with the layer's static scale
        (the odt::quantize_act op; x is channels_last on the main path, so the
        contiguous call copies nothing), the cached per-channel int8 weights,
        s8 x s8 -> s32, then (acc * (sx * sw)) in the model's dtype + bias, in
        the op's epilogue."""
        sx = quant.act_scale(self.quant_amax[_QUANT_INDEX[layer]])
        w8, sw = self._int8_weight(layer, conv)
        x8 = quantize_act(x.contiguous(memory_format=torch.channels_last), sx, self.quant_reciprocal)
        return int8_conv(x8, w8, sx * sw, conv.bias.to(self.dtype), conv.stride[0], conv.padding[0], self.dtype)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        stride=conv.stride, padding=conv.padding)

    def _conv12(self, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        # the kernel takes channels_last only and never copies; the BN+ReLU
        # output is channels_last already, so this is a no-op on the main path
        x = x.contiguous(memory_format=torch.channels_last)
        return conv12(x, conv.weight.to(self.dtype), conv.bias, out_dtype=self.dtype)

    def forward(self, x: torch.Tensor, use_batch_stats: bool = True,
                batch_mask: torch.Tensor | None = None, up_to: str | None = None) -> torch.Tensor:
        with true_float32():
            return self._forward(x, use_batch_stats, batch_mask, up_to)

    def _forward(self, x, use_batch_stats, batch_mask, up_to):
        n = x.shape[0]
        taps = dict(DETECTOR_TAPS)
        # NHWC -> NCHW view with channels_last strides
        x = normalize_image(x).permute(0, 3, 1, 2).to(self.dtype)
        feature_maps = {}
        for suffix, _, _, _, _, _, pool in LAYER_SPECS:
            conv = self.features[f"conv_{suffix}"]
            if self._int8_layer(suffix):
                x = self._conv_int8(suffix, conv, x)
            else:
                self._observe(suffix, x)
                x = (self._conv12 if suffix == "1_2" and self.conv12_kernel else self._conv)(conv, x)
            x = self.features[f"bn_{suffix}"](x, use_batch_stats, batch_mask, out_dtype=self.dtype)
            x = F.relu(x)
            if suffix in taps:
                feature_maps[suffix] = x
            if pool is not None:
                x = F.max_pool2d(x, 2, 2, padding=1 if pool == "M_P" else 0)
            if suffix == up_to:
                return x.permute(0, 2, 3, 1)

        outputs = []
        for suffix, _ in DETECTOR_TAPS:
            det, fm = self.detectors[f"det_{suffix}"], feature_maps[suffix]
            if self._int8_layer(f"det_{suffix}"):
                y = self._conv_int8(f"det_{suffix}", det, fm)
            else:
                self._observe(f"det_{suffix}", fm)
                y = self._conv(det, fm)
            # (N, A*(C+4), H, W) -> (N, H*W*A, C+4): rows h-major, then w, then
            # anchor (reference: ssd.py:103)
            outputs.append(y.permute(0, 2, 3, 1).reshape(n, -1, self.num_classes + 4))
        return torch.cat(outputs, dim=1).to(output_dtype(self.dtype))

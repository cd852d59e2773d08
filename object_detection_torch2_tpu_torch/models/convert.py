"""Weights and state across frameworks for the port's `SSD`.

- `ssd_state_dict_from_jax_variables`: the JAX package's {"params",
  "batch_stats"} numpy tree -> the port's state_dict. It is the exact inverse
  of object_detection_torch2_tpu/models/convert.py `ssd_variables_from_torch`:
  conv kernel HWIO -> weight OIHW; BN scale/bias/mean/var ->
  weight/bias/running_mean/running_var; num_batches_tracked = 0.
- `ssd_state_dict_from_torch`: a reference-layout state_dict (numpy arrays or
  tensors) -> tensors, after checking every key, shape and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detection_torch2_tpu_torch.models.ssd import DETECTOR_TAPS, LAYER_SPECS


def ssd_state_shapes(num_classes: int = 21) -> dict:
    """{state_dict key: shape} of `SSD(num_classes)`, in module order."""
    shapes = {}
    out_ch = {}
    for suffix, cin, cout, k, *_ in LAYER_SPECS:
        shapes[f"features.conv_{suffix}.weight"] = (cout, cin, k, k)
        shapes[f"features.conv_{suffix}.bias"] = (cout,)
        for stat in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"features.bn_{suffix}.{stat}"] = (cout,)
        shapes[f"features.bn_{suffix}.num_batches_tracked"] = ()
        out_ch[suffix] = cout
    for suffix, a in DETECTOR_TAPS:
        cout = a * (num_classes + 4)
        shapes[f"detectors.det_{suffix}.weight"] = (cout, out_ch[suffix], 3, 3)
        shapes[f"detectors.det_{suffix}.bias"] = (cout,)
    return shapes


def ssd_state_dict_from_torch(sd: dict, num_classes: int = 21) -> dict:
    """Check a reference-layout SSD state_dict and return it as CPU tensors.

    Raises ValueError on a missing or unexpected key, a wrong shape, a
    non-floating parameter or statistic, or a non-integer
    `num_batches_tracked`."""
    want = ssd_state_shapes(num_classes)
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise ValueError(f"state_dict keys differ from SSD({num_classes}): "
                         f"missing {missing[:5]}, unexpected {unexpected[:5]}")
    out = {}
    for key, shape in want.items():
        v = sd[key]
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, order="C"))  # a copy: may be read-only
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)}, expected {shape}")
        integral = key.endswith("num_batches_tracked")
        if integral != (not t.is_floating_point()):
            raise ValueError(f"{key}: dtype {t.dtype} is not {'an integer' if integral else 'a float'} type")
        out[key] = t
    return out


def ssd_state_dict_from_jax_variables(variables: dict, num_classes: int = 21) -> dict:
    """{"params": {layer: {...}}, "batch_stats": {layer: {...}}} (numpy or
    array-likes) -> the port's state_dict of CPU tensors."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if name.startswith("conv_") or name.startswith("det_"):
            prefix = "features" if name.startswith("conv_") else "detectors"
            sd[f"{prefix}.{name}.weight"] = np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))
            sd[f"{prefix}.{name}.bias"] = np.asarray(p["bias"])
        elif name.startswith("bn_"):
            sd[f"features.{name}.weight"] = np.asarray(p["scale"])
            sd[f"features.{name}.bias"] = np.asarray(p["bias"])
            sd[f"features.{name}.running_mean"] = np.asarray(stats[name]["mean"])
            sd[f"features.{name}.running_var"] = np.asarray(stats[name]["var"])
            sd[f"features.{name}.num_batches_tracked"] = np.zeros((), np.int64)
        else:
            raise ValueError(f"unknown SSD layer {name!r}")
    return ssd_state_dict_from_torch(sd, num_classes)

"""Weights and state across frameworks for the port's `SSD`.

- `ssd_state_dict_from_jax_variables`: the JAX package's {"params",
  "batch_stats"} numpy tree -> the port's state_dict. It is the exact inverse
  of object_detection_torch2_tpu/models/convert.py `ssd_variables_from_torch`:
  conv kernel HWIO -> weight OIHW; BN scale/bias/mean/var ->
  weight/bias/running_mean/running_var; num_batches_tracked = 0.
  `jax_variables_from_state_dict` is its exact inverse (what the port's
  weights files hold).
- `ssd_trunk_from_vgg16_variables`, `merge_variables`: seed an SSD's trunk
  from the JAX package's VGG16 classification variables.
- VGG16 (models/vgg16.py): `vgg16_state_dict_from_jax_variables` and its
  exact inverse `jax_variables_from_vgg16_state_dict` (Linear weight
  (out, in) <-> kernel (in, out)); `vgg16_sequential_index_map` and
  `vgg16_variables_from_torch`, copies of the JAX package's converters of
  the reference's `features.<idx>` state_dicts (models/convert.py:61-95);
  `jax_variables_of(model)` picks the inverse of an SSD's or a VGG16's.
- `ssd_state_dict_from_torch`: a reference-layout state_dict (numpy arrays or
  tensors) -> tensors, after checking every key, shape and dtype.
- `jax_path` / `to_jax_layout` / `jax_tree`: the key mapping between the
  port's parameter and buffer names and the JAX package's {"params",
  "batch_stats"} trees (`features.conv_6_1.weight` <-> ("conv_6_1", "kernel"),
  HWIO <-> OIHW), so that the trainable/frozen partitions and trained tensors of
  the two frameworks can be compared leaf by leaf.
- `adam_state_dict_from_optax`: an optax `ScaleByAdamState` (count, mu, nu as
  numpy trees of the JAX params layout) -> a `torch.optim.Adam` state_dict, so
  that both frameworks can start from the same mid-run optimizer state.
- `quant_scales_from_jax_variables` / `jax_quant_collection`: the JAX
  package's `variables["quant"]` collection ({amax_<layer>: float32 scalar})
  <-> the port's scales {amax_<layer>: float} (`SSD.set_quant`,
  `Trainer(quant=)`, quant.json), so both frameworks run with the same
  activation scales.
"""

from __future__ import annotations

import numpy as np
import torch

from object_detection_torch2_tpu_torch.models.ssd import DETECTOR_TAPS, LAYER_SPECS
from object_detection_torch2_tpu_torch.models.vgg16 import GRID, HEAD_WIDTHS, VGG_CFG, VGG16, canonical_conv_names


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
    return _checked(sd, ssd_state_shapes(num_classes), f"SSD({num_classes})")


def _tensor(a) -> torch.Tensor:
    """A leaf (numpy, array-like, or a tensor such as a bfloat16 leaf of a
    weights file) as a CPU tensor; numpy leaves are copied, since they may be
    read-only views of a file's bytes."""
    return a.detach().cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def ssd_state_dict_from_jax_variables(variables: dict, num_classes: int = 21) -> dict:
    """{"params": {layer: {...}}, "batch_stats": {layer: {...}}} (numpy,
    array-likes or tensors) -> the port's state_dict of CPU tensors."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if name.startswith("conv_") or name.startswith("det_"):
            prefix = "features" if name.startswith("conv_") else "detectors"
            sd[f"{prefix}.{name}.weight"] = _tensor(p["kernel"]).permute(3, 2, 0, 1).contiguous()
            sd[f"{prefix}.{name}.bias"] = _tensor(p["bias"])
        elif name.startswith("bn_"):
            sd[f"features.{name}.weight"] = _tensor(p["scale"])
            sd[f"features.{name}.bias"] = _tensor(p["bias"])
            sd[f"features.{name}.running_mean"] = _tensor(stats[name]["mean"])
            sd[f"features.{name}.running_var"] = _tensor(stats[name]["var"])
            sd[f"features.{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:
            raise ValueError(f"unknown SSD layer {name!r}")
    return ssd_state_dict_from_torch(sd, num_classes)


def jax_variables_from_state_dict(sd: dict, num_classes: int = 21) -> dict:
    """The exact inverse of `ssd_state_dict_from_jax_variables`: the port's
    state_dict -> the JAX package's {"params", "batch_stats"} tree, conv
    weights OIHW -> HWIO, leaves as C-contiguous numpy copies.
    `num_batches_tracked` has no JAX counterpart and is dropped. Layers and
    leaves come in the state_dict's order; the weights file sorts them as
    flax does."""
    return _jax_variables(ssd_state_dict_from_torch(sd, num_classes))


def vgg16_state_shapes(num_classes: int = 20) -> dict:
    """{state_dict key: shape} of `VGG16(num_classes)`, in module order."""
    shapes, cin = {}, 3
    for name, ch in canonical_conv_names():
        if name.startswith("conv_"):
            shapes[f"features.{name}.weight"] = (ch, cin, 3, 3)
            shapes[f"features.{name}.bias"] = (ch,)
            bn = f"features.bn{name[4:]}"
            for stat in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{bn}.{stat}"] = (ch,)
            shapes[f"{bn}.num_batches_tracked"] = ()
            cin = ch
    for head, out in (("classifier", 1000), ("classifier2", num_classes)):
        widths = (cin * GRID * GRID, *HEAD_WIDTHS, out)
        for i in range(3):
            shapes[f"{head}_fc{i + 1}.weight"] = (widths[i + 1], widths[i])
            shapes[f"{head}_fc{i + 1}.bias"] = (widths[i + 1],)
    return shapes


def _checked(sd: dict, want: dict, what: str) -> dict:
    """`sd` as CPU tensors in `want`'s key order, after checking every key,
    shape and dtype against `want` ({key: shape})."""
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise ValueError(f"state_dict keys differ from {what}: missing {missing[:5]}, unexpected {unexpected[:5]}")
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


def _jax_variables(sd: dict) -> dict:
    """A checked state_dict -> {"params", "batch_stats"} with C-contiguous
    numpy copies in the JAX layout."""
    params, stats = {}, {}
    for key, t in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        layer, leaf = jax_path(key)
        t = t.detach().cpu()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        elif t.dim() == 2:
            t = t.t()
        value = t.clone(memory_format=torch.contiguous_format).numpy()  # no leaf aliases the model's tensors
        (stats if leaf in ("mean", "var") else params).setdefault(layer, {})[leaf] = value
    return {"params": params, "batch_stats": stats}


def vgg16_state_dict_from_jax_variables(variables: dict, num_classes: int = 20) -> dict:
    """The JAX package's VGG16 {"params", "batch_stats"} tree (numpy,
    array-likes or tensors) -> the port's `VGG16` state_dict of CPU tensors."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd = {}
    for name, p in params.items():
        if name.startswith("conv_"):
            sd[f"features.{name}.weight"] = _tensor(p["kernel"]).permute(3, 2, 0, 1).contiguous()
            sd[f"features.{name}.bias"] = _tensor(p["bias"])
        elif name.startswith("bn_"):
            sd[f"features.{name}.weight"] = _tensor(p["scale"])
            sd[f"features.{name}.bias"] = _tensor(p["bias"])
            sd[f"features.{name}.running_mean"] = _tensor(stats[name]["mean"])
            sd[f"features.{name}.running_var"] = _tensor(stats[name]["var"])
            sd[f"features.{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        elif name.startswith("classifier"):
            sd[f"{name}.weight"] = _tensor(p["kernel"]).t().contiguous()
            sd[f"{name}.bias"] = _tensor(p["bias"])
        else:
            raise ValueError(f"unknown VGG16 layer {name!r}")
    return _checked(sd, vgg16_state_shapes(num_classes), f"VGG16({num_classes})")


def jax_variables_from_vgg16_state_dict(sd: dict, num_classes: int = 20) -> dict:
    """The exact inverse of `vgg16_state_dict_from_jax_variables`: what the
    JAX package's `VGG16` variables hold, which its `save_weights` writes."""
    return _jax_variables(_checked(sd, vgg16_state_shapes(num_classes), f"VGG16({num_classes})"))


def jax_variables_of(model) -> dict:
    """The JAX package's variables of an `SSD` or a `VGG16` of the port."""
    if isinstance(model, VGG16):
        return jax_variables_from_vgg16_state_dict(model.state_dict(), model.num_classes)
    return jax_variables_from_state_dict(model.state_dict(), model.num_classes)


def vgg16_sequential_index_map(cfg=VGG_CFG) -> dict:
    """Map `features.<idx>` Sequential indices (the plain-VGG16 / torch.hub
    layout, reference: vgg16.py:22-39) to canonical `conv_L_S` / `bn_L_S`
    names (copy of object_detection_torch2_tpu/models/convert.py:61-76)."""
    index_map = {}
    idx, block, sub = 0, 1, 1
    for v in cfg:
        if v in ("M", "M_P"):
            idx += 1
            block += 1
            sub = 1
        else:
            index_map[idx] = f"conv_{block}_{sub}"
            index_map[idx + 1] = f"bn_{block}_{sub}"
            idx += 3  # conv, bn, relu
            sub += 1
    return index_map


def _np_conv(sd: dict, key: str) -> dict:
    return {"kernel": np.ascontiguousarray(np.transpose(np.asarray(sd[f"{key}.weight"]), (2, 3, 1, 0))),
            "bias": np.asarray(sd[f"{key}.bias"])}


def _np_dense(sd: dict, key: str) -> dict:
    return {"kernel": np.ascontiguousarray(np.transpose(np.asarray(sd[f"{key}.weight"]), (1, 0))),
            "bias": np.asarray(sd[f"{key}.bias"])}


def vgg16_variables_from_torch(sd: dict) -> dict:
    """A reference-VGG16 (or torch.hub vgg16_bn) state_dict with
    `features.<idx>.*` + `classifier.<idx>.*` (+ optional `classifier2.<idx>.*`)
    keys -> the JAX package's VGG16 variables, numpy leaves (copy of
    object_detection_torch2_tpu/models/convert.py:79-95)."""
    params, batch_stats = {}, {}
    for idx, name in vgg16_sequential_index_map().items():
        key = f"features.{idx}"
        if name.startswith("conv_"):
            params[name] = _np_conv(sd, key)
        else:
            params[name] = {"scale": np.asarray(sd[f"{key}.weight"]), "bias": np.asarray(sd[f"{key}.bias"])}
            batch_stats[name] = {"mean": np.asarray(sd[f"{key}.running_mean"]),
                                 "var": np.asarray(sd[f"{key}.running_var"])}
    # heads: Sequential indices 0, 3, 6 are the Linear layers (reference: vgg16.py:42-61)
    for head in ("classifier", "classifier2"):
        for fc_i, idx in enumerate((0, 3, 6), start=1):
            if f"{head}.{idx}.weight" in sd:
                params[f"{head}_fc{fc_i}"] = _np_dense(sd, f"{head}.{idx}")
    return {"params": params, "batch_stats": batch_stats}


def ssd_trunk_from_vgg16_variables(vgg_vars: dict) -> dict:
    """The conv_1_1..bn_5_3 trunk of the JAX package's VGG16 variables, for
    seeding an SSD (the reference's `weights_path_vgg16` path, ssd.py:25;
    copy of object_detection_torch2_tpu/models/convert.py:98-108)."""
    def keep(name):
        return name.split("_")[1].isdigit() and int(name.split("_")[1]) <= 5 and (
            name.startswith("conv_") or name.startswith("bn_"))

    return {
        "params": {k: v for k, v in vgg_vars["params"].items() if keep(k)},
        "batch_stats": {k: v for k, v in vgg_vars["batch_stats"].items() if keep(k)},
    }


def merge_variables(base: dict, overlay: dict) -> dict:
    """Shallow-merge overlay collections/layers into base, layer by layer
    (copy of object_detection_torch2_tpu/models/convert.py:111-116)."""
    out = {coll: dict(layers) for coll, layers in base.items()}
    for coll, layers in overlay.items():
        out.setdefault(coll, {}).update(layers)
    return out


_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_CONV_LEAVES = {"weight": "kernel", "bias": "bias"}


def jax_path(name: str) -> tuple[str, str]:
    """Port parameter or statistic name -> (JAX layer, leaf):
    `features.conv_6_1.weight` -> ("conv_6_1", "kernel"),
    `features.bn_6_1.running_var` -> ("bn_6_1", "var"),
    `detectors.det_4_3.bias` -> ("det_4_3", "bias"),
    `classifier2_fc1.weight` -> ("classifier2_fc1", "kernel")."""
    layer, leaf = name.split(".")[-2:]
    return layer, (_BN_LEAVES if layer.startswith("bn_") else _CONV_LEAVES)[leaf]


def to_jax_layout(t) -> np.ndarray:
    """A port tensor as the JAX package keeps it (conv weights OIHW -> HWIO,
    linear weights (out, in) -> (in, out))."""
    a = np.asarray(t.detach().cpu().float() if isinstance(t, torch.Tensor) else t)
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a.T if a.ndim == 2 else a


def from_jax_layout(a) -> torch.Tensor:
    """A JAX leaf as the port keeps it (conv kernels HWIO -> OIHW, dense
    kernels (in, out) -> (out, in)), a CPU tensor."""
    a = np.asarray(a)
    a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T if a.ndim == 2 else a
    return torch.from_numpy(np.array(a))  # a writable copy


def jax_tree(named: dict) -> dict:
    """{port name: tensor} -> {JAX layer: {leaf: numpy array}} in the JAX layout."""
    tree = {}
    for name, t in named.items():
        layer, leaf = jax_path(name)
        tree.setdefault(layer, {})[leaf] = to_jax_layout(t)
    return tree


def adam_state_dict_from_optax(count, mu: dict, nu: dict, names: list, param_groups: list) -> dict:
    """optax `ScaleByAdamState` (`count`, `mu`, `nu` as numpy trees of the JAX
    params layout) -> a `torch.optim.Adam` state_dict whose parameter i is the
    port's `names[i]`. `param_groups` is the optimizer's own
    `state_dict()["param_groups"]`, kept as it is. torch's `exp_avg` and
    `exp_avg_sq` are optax's uncorrected `mu` and `nu`, and its `step` is
    `count`, so both frameworks take the next step from the same state."""
    state = {}
    for i, name in enumerate(names):
        layer, leaf = jax_path(name)
        state[i] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": from_jax_layout(mu[layer][leaf]),
            "exp_avg_sq": from_jax_layout(nu[layer][leaf]),
        }
    return {"state": state, "param_groups": param_groups}


def quant_scales_from_jax_variables(variables: dict) -> dict:
    """The JAX package's `variables["quant"]` ({amax_<layer>: scalar}) -> the
    port's scales {amax_<layer>: float}, each the float32 value as a float."""
    return {k: float(np.float32(np.asarray(v))) for k, v in variables["quant"].items()}


def jax_quant_collection(scales: dict) -> dict:
    """The port's scales {amax_<layer>: float} -> the JAX package's "quant"
    collection {amax_<layer>: numpy float32 scalar}, as its models take it."""
    return {k: np.float32(v) for k, v in scales.items()}

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
    params, stats = {}, {}
    for key, t in ssd_state_dict_from_torch(sd, num_classes).items():
        if key.endswith("num_batches_tracked"):
            continue
        layer, leaf = jax_path(key)
        t = t.detach().cpu()
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        value = t.clone(memory_format=torch.contiguous_format).numpy()  # no leaf aliases the model's tensors
        (stats if leaf in ("mean", "var") else params).setdefault(layer, {})[leaf] = value
    return {"params": params, "batch_stats": stats}


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
    `detectors.det_4_3.bias` -> ("det_4_3", "bias")."""
    layer, leaf = name.split(".")[-2:]
    return layer, (_BN_LEAVES if layer.startswith("bn_") else _CONV_LEAVES)[leaf]


def to_jax_layout(t) -> np.ndarray:
    """A port tensor as the JAX package keeps it (conv weights OIHW -> HWIO)."""
    a = np.asarray(t.detach().cpu().float() if isinstance(t, torch.Tensor) else t)
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def from_jax_layout(a) -> torch.Tensor:
    """A JAX leaf as the port keeps it (conv kernels HWIO -> OIHW), a CPU tensor."""
    a = np.asarray(a)
    return torch.from_numpy(np.array(np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a))  # a writable copy


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

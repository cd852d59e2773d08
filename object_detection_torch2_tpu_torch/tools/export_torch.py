"""The CLIs' weights.msgpack -> a reference-layout torch checkpoint (.pth)
(the port's counterpart of the repo's root tools/export_torch.py; the same
tensors under the same keys).

    python -m object_detection_torch2_tpu_torch.tools.export_torch --weights result/detection/weights.msgpack \\
        --model ssd --out result/detection/weights.pth

`ssd_state_dict`: the reference SSD's `features.` / `detectors.` ModuleDict
keys, which the port's `SSD` keeps (`models.convert.ssd_state_dict_from_jax_variables`),
so `SSD().load_state_dict` or the reference's `SSD(weights_path=...)` loads
it. `vgg16_state_dict`: the reference VGG16's `features.<idx>` Sequential
keys and `classifier.<idx>` / `classifier2.<idx>` heads (root
tools/export_torch.py:vgg16_state_dict).
Conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in); each
BatchNorm gets `num_batches_tracked` = 0 (int64).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detection_torch2_tpu_torch.models.convert import (
    ssd_state_dict_from_jax_variables,
    vgg16_sequential_index_map,
)
from object_detection_torch2_tpu_torch.train.checkpoint import load_weights


def _tensor(a) -> torch.Tensor:
    """A leaf of a loaded weights file (a read-only numpy view, or a tensor
    for bfloat16) as a CPU tensor of its own."""
    return a.clone() if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def _conv(layer: dict) -> dict:
    return {"weight": _tensor(layer["kernel"]).permute(3, 2, 0, 1).contiguous(), "bias": _tensor(layer["bias"])}


def _dense(layer: dict) -> dict:
    return {"weight": _tensor(layer["kernel"]).t().contiguous(), "bias": _tensor(layer["bias"])}


def _bn(params: dict, stats: dict) -> dict:
    return {"weight": _tensor(params["scale"]), "bias": _tensor(params["bias"]),
            "running_mean": _tensor(stats["mean"]), "running_var": _tensor(stats["var"]),
            "num_batches_tracked": torch.zeros((), dtype=torch.int64)}


def ssd_state_dict(variables: dict) -> dict:
    """SSD variables -> the reference SSD state_dict (`features.conv_L_S.*`,
    `features.bn_L_S.*`, `detectors.det_L_S.*`: the port's `SSD` keys),
    num_classes read from the first head (4 anchors of num_classes + 4)."""
    num_classes = variables["params"]["det_4_3"]["bias"].shape[0] // 4 - 4
    return ssd_state_dict_from_jax_variables(variables, num_classes)


def vgg16_state_dict(variables: dict) -> dict:
    """VGG16 variables -> the reference VGG16 state_dict (Sequential-index keys)."""
    params, stats = variables["params"], variables["batch_stats"]
    name_to_idx = {v: k for k, v in vgg16_sequential_index_map().items()}
    out = {}
    for name, layer in params.items():
        if name.startswith("conv_"):
            out.update({f"features.{name_to_idx[name]}.{k}": v for k, v in _conv(layer).items()})
        elif name.startswith("bn_"):
            idx = name_to_idx[f"conv{name[2:]}"] + 1
            out.update({f"features.{idx}.{k}": v for k, v in _bn(layer, stats[f"bn{name[2:]}"]).items()})
        elif name.startswith(("classifier_fc", "classifier2_fc")):
            head, fc = name.rsplit("_fc", 1)
            idx = {1: 0, 2: 3, 3: 6}[int(fc)]
            out.update({f"{head}.{idx}.{k}": v for k, v in _dense(layer).items()})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", required=True, help="weights.msgpack written by either package")
    parser.add_argument("--model", choices=["ssd", "vgg16"], required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    variables = load_weights(args.weights)
    sd = ssd_state_dict(variables) if args.model == "ssd" else vgg16_state_dict(variables)
    torch.save(sd, args.out)
    print(f"wrote {args.out}: {len(sd)} tensors")


if __name__ == "__main__":
    main()

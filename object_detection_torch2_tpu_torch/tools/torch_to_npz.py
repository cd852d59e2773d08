"""A reference torch checkpoint (.pth) -> the weights.msgpack the CLIs load
(the port's counterpart of the repo's root tools/torch_to_npz.py; the same
bytes for the same checkpoint).

    python -m object_detection_torch2_tpu_torch.tools.torch_to_npz --pth result/detection/weights.pth \\
        --model ssd --out result/detection/weights.msgpack

`--model ssd`: the reference SSD's state_dict (`features.conv_L_S.*`,
`features.bn_L_S.*`, `detectors.det_L_S.*`), checked key by key by
`models.convert.ssd_state_dict_from_torch`. `--model vgg16`: the reference
VGG16 or torch.hub vgg16_bn layout (`features.<idx>.*`, `classifier.<idx>.*`,
optionally `classifier2.<idx>.*`) through `models.convert.vgg16_variables_from_torch`.
Either is written by `train.checkpoint.save_weights`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from object_detection_torch2_tpu_torch.models.convert import (
    jax_variables_from_state_dict,
    ssd_state_dict_from_torch,
    vgg16_variables_from_torch,
)
from object_detection_torch2_tpu_torch.train.checkpoint import save_weights


def tensors_of(sd) -> dict:
    """A loaded checkpoint (a state_dict, or a module with `state_dict()`)
    -> {key: CPU tensor}, non-tensor entries dropped."""
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: torch.as_tensor(v).cpu() for k, v in sd.items() if isinstance(v, (torch.Tensor, np.ndarray))}


def ssd_num_classes(sd: dict) -> int:
    """Classes (background included) of a reference SSD state_dict, from its
    first head (4 anchors of num_classes + 4 outputs at conv_4_3)."""
    return sd["detectors.det_4_3.bias"].shape[0] // 4 - 4


def variables_from_state_dict(sd: dict, model: str) -> dict:
    """A reference state_dict -> the {"params", "batch_stats"} tree of the
    weights file (float leaves kept in their dtype)."""
    if model == "ssd":
        num_classes = ssd_num_classes(sd)
        return jax_variables_from_state_dict(ssd_state_dict_from_torch(sd, num_classes), num_classes)
    return vgg16_variables_from_torch({k: v.numpy() for k, v in sd.items()})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pth", required=True)
    parser.add_argument("--model", choices=["ssd", "vgg16"], required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    variables = variables_from_state_dict(tensors_of(torch.load(args.pth, map_location="cpu")), args.model)
    save_weights(args.out, variables)
    n = sum(v.size for layer in variables["params"].values() for v in layer.values())
    print(f"wrote {args.out}: {len(variables['params'])} layers, {n:,} params")


if __name__ == "__main__":
    main()

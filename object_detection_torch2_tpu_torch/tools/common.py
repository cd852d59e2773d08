"""What the port's accuracy proofs share: where they write, what each JSON
records besides its mAPs, and the stage-A trunk transfer.

- `PROOFS_DIR`: each proof writes `<PROOFS_DIR>/<name>.json`, by default
  `proofs_torch/` at the repo root (never the JAX artifacts' paths); a
  caller that wants the JSON elsewhere sets it before calling `main`.
- `environment(device)`: the card's name and power limit as
  `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
  them (None on the CPU), the torch and CUDA versions, the device.
- `Stages`: wall seconds and the hand-written kernels' launches of each
  stage of a proof (`launch_counts`: the counters the kernel wrappers add
  one to at each launch; they stay 0 on the CPU, where the plain versions
  run).
- `jax_record(name)`: the JAX artifact's numbers (`PROOF_*.json`,
  `INT8_BUDGET.json` at the repo root), read as JSON, for comparison.
- `trained_images(out)`: images and seconds of one `cli.train.main` run
  from what it returns.
- `detection_trunk_as_vgg16(ssd_vars, base)`: the trunk layers (`*_1_*` ..
  `*_5_*`: conv_1_1 .. bn_5_3, and det_4_3, which the JAX tools' name
  filter also keeps and the VGG16 layout ignores) of trained SSD variables
  laid over a VGG16 variable set, as the JAX tools do it
  (tools/pretrained_trunk_proof.py:172-183, tools/int8_budget.py:102-112),
  so that `cli.common.build_ssd` seeds a detection run's trunk from it.
"""

from __future__ import annotations

import json
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from object_detection_torch2_tpu_torch.models.convert import jax_variables_of, merge_variables
from object_detection_torch2_tpu_torch.models.vgg16 import VGG16

REPO = Path(__file__).resolve().parents[2]
PROOFS_DIR = REPO / "proofs_torch"
FIXTURE = REPO / "tests" / "fixtures" / "voc" / "VOCtest"
KERNELS = ("nms_keep_sorted", "conv12", "conv12_bf16", "int8_conv", "quantize_act")


def card_line() -> str | None:
    """nvidia-smi's "name, power.limit" of the first card, None without one."""
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def environment(device) -> dict:
    return {"card": card_line(), "device": str(device or "cuda"), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def launch_counts() -> dict:
    """Each hand-written kernel's launch counter, as it stands."""
    from object_detection_torch2_tpu_torch.ops import conv12_cuda, int8_conv_cuda, nms_cuda, quantize_act_cuda

    return {"nms_keep_sorted": nms_cuda.launches, "conv12": conv12_cuda.kernel_launches["conv12"],
            "conv12_bf16": conv12_cuda.kernel_launches["conv12_bf16"],
            "int8_conv": int8_conv_cuda.kernel_launches, "quantize_act": quantize_act_cuda.kernel_launches}


class Stages:
    """Per stage of a proof: its wall seconds and each kernel's launches
    during it (the counters' difference across the stage)."""

    def __init__(self):
        self.rows: dict = {}

    @contextmanager
    def stage(self, name: str):
        before, t0 = launch_counts(), time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        after = launch_counts()
        self.rows[name] = {"seconds": round(time.perf_counter() - t0, 1),
                           "launches": {k: after[k] - before[k] for k in KERNELS}}

    def launches(self) -> dict:
        """Each kernel's launches summed over the stages."""
        return {k: sum(row["launches"][k] for row in self.rows.values()) for k in KERNELS}


def jax_record(name: str) -> dict | None:
    """The JAX artifact `<repo>/<name>` as a dict (None where the checkout
    lacks it)."""
    path = REPO / name
    return json.loads(path.read_text()) if path.exists() else None


def trained_images(out: dict, batch_size: int, seconds: float) -> dict:
    """Images, epochs and img/s of one `cli.train.main` run (`out`, what it
    returned; `seconds`, its wall time), and the per-epoch mean train,
    validation and save seconds of its phase_times rows."""
    images = sum(int(loss.shape[0]) for loss in out["losses"]) * batch_size
    rows = out["phase_times"]
    mean = {k: round(sum(r[k] for r in rows) / max(len(rows), 1), 4) for k in ("train_s", "val_s", "save_s")}
    loop_s = sum(r["train_s"] for r in rows)
    return {"epochs": len(rows), "images": images, "seconds": round(seconds, 1),
            "img_per_s": round(images / max(seconds, 1e-9), 1),
            "img_per_s_train_loop": round(images / max(loop_s, 1e-9), 1),
            "per_epoch_mean_s": mean}


def is_trunk_layer(name: str) -> bool:
    """conv_L_S / bn_L_S with L <= 5, the VGG16 trunk's layers in an SSD's
    variables, and det_4_3: the JAX tools' `k.split("_")[1].isdigit() and
    int(k.split("_")[1]) <= 5`."""
    part = name.split("_")[1]
    return part.isdigit() and int(part) <= 5


def trunk_overlay(ssd_vars: dict) -> dict:
    """The trunk layers of SSD variables, params and batch statistics."""
    return {coll: {k: v for k, v in ssd_vars[coll].items() if is_trunk_layer(k)}
            for coll in ("params", "batch_stats")}


def vgg16_base_variables(seed: int = 0) -> dict:
    """A VGG16(20) variable set of the port's seeded init (the JAX tools'
    `VGG16(num_classes=20).init(PRNGKey(0), ...)`; its heads are never read
    by the detection purpose)."""
    return jax_variables_of(VGG16(num_classes=20, seed=seed))


def detection_trunk_as_vgg16(ssd_vars: dict, base: dict) -> dict:
    """`base` (VGG16 variables) with the trunk layers of `ssd_vars` laid over it."""
    return merge_variables({coll: base[coll] for coll in ("params", "batch_stats")}, trunk_overlay(ssd_vars))


def write_record(name: str, record: dict, echo: bool = True) -> Path:
    """`record` as `<PROOFS_DIR>/<name>.json`; with `echo`, prints it on one
    line too."""
    out = Path(PROOFS_DIR) / f"{name}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2) + "\n")
    if echo:
        print(json.dumps(record))
    return out


def device_flags(device) -> list:
    """The CLIs' `--device` argv for the proofs' `--device` (none: the card)."""
    return ["--device", str(device)] if device else []


def clean(values) -> list:
    """Per-class APs for JSON: 4 digits, None for the classes a small
    held-out set lacks (NaN), as the JAX tools write them."""
    return [round(float(v), 4) if float(v) == float(v) else None for v in values]

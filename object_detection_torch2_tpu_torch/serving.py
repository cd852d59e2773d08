"""Portable serving artifacts: the detection pipeline as `torch.export`
programs (counterpart of object_detection_torch2_tpu/serving.py:42-110).

`export_detection_pipeline` traces the WHOLE serving path — uint8 images ->
normalize -> SSD forward -> decode -> scores -> NMS -> top-K -> packed rows —
once for each platform, on that platform's device, with the weights embedded
in the program, and writes:
- `<path>`: a zip archive holding one `torch.export` program per platform
  (`<platform>.pt2`, `torch.export.save`'s format);
- `<path>.json`: the calling contract (shapes, platforms, knobs, bytes).

`load_detection_pipeline(path, device=None)` gives back `(run, meta)`. It
needs no model code: the programs call the package's kernels as the
custom ops `torch.ops.odt.*`, so loading imports only `ops/registry.py`. The
artifact keeps the same (packed (N, K, 6), n_valid (N,)) contract as
`infer.build_detection_pipeline`, so `infer.unpack_detections` reads its
output as it is. On the card the program's NMS sweeps run the CUDA kernel
through the registered op; the NMS tier is a `torch.cond` in the graph.

Limits, as the JAX package's: a fixed batch size (a ragged tail is masked by
n_real, as in the live pipeline) and one device per artifact run. A program
runs only on the platform it was traced on; loading it for another raises.
float32 convolutions run in true float32 (TF32 off) when the artifact runs,
as in the live pipeline.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import torch

FORMAT = "object_detection_torch2_tpu_torch/detection-pipeline"
VERSION = 1


def export_detection_pipeline(model, path, *, batch_size: int, use_batch_stats: bool = False, imsize: int = 300,
                              iou_thresh: float = 0.5, max_detections: int = 200,
                              platforms: tuple = ("cuda", "cpu"), d2h_half: bool = False) -> dict:
    """Trace the detection pipeline of `model` (an SSD holding its weights)
    on each platform's device and write `<path>` and `<path>.json`; returns
    the metadata. The artifact's call: (images_u8 (N, H, W, 3) uint8,
    n_real () int) -> (packed (N, K, 6), n_valid (N,)). A "cuda" platform
    needs the card and raises without one. The model ends on the last
    platform's device, in eval mode."""
    from object_detection_torch2_tpu_torch import resolve_device, true_float32
    from object_detection_torch2_tpu_torch.infer import DetectionPipeline

    platforms = tuple(platforms)
    if not platforms or any(p not in ("cuda", "cpu") for p in platforms):
        raise ValueError(f"platforms must be a non-empty subset of ('cuda', 'cpu'), got {platforms}")
    programs = {}
    for platform in platforms:
        device = resolve_device(platform)
        pipe = DetectionPipeline(model.to(device).eval(), use_batch_stats, imsize, iou_thresh, max_detections,
                                 d2h_half).to(device)
        args = (torch.zeros((batch_size, imsize, imsize, 3), dtype=torch.uint8, device=device),
                torch.tensor(batch_size, dtype=torch.int64, device=device))
        with torch.no_grad(), true_float32():
            exported = torch.export.export(pipe, args)
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        programs[platform] = buf.getvalue()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for platform, data in programs.items():
            zf.writestr(f"{platform}.pt2", data)
    meta = {
        "format": FORMAT,
        "version": VERSION,
        "batch_size": batch_size,
        "imsize": imsize,
        "max_detections": max_detections,
        "iou_thresh": iou_thresh,
        "use_batch_stats": use_batch_stats,
        "d2h_half": d2h_half,
        "platforms": list(platforms),
        "inputs": {"images_u8": [batch_size, imsize, imsize, 3], "n_real": []},
        "outputs": {"packed": [batch_size, max_detections, 6], "n_valid": [batch_size]},
        "bytes": path.stat().st_size,
    }
    path.with_suffix(path.suffix + ".json").write_text(json.dumps(meta, indent=1))
    return meta


def load_detection_pipeline(path, device=None):
    """An exported pipeline -> (run, metadata). run(images_u8, n_real) takes
    host arrays or tensors and returns (packed, n_valid) on the device.
    device=None means the CUDA card (raises without one); "cpu" loads the
    CPU program. A device whose platform the artifact does not hold raises."""
    from object_detection_torch2_tpu_torch import resolve_device, true_float32
    from object_detection_torch2_tpu_torch.ops import registry  # noqa: F401  (the programs' custom ops)

    device = resolve_device(device)
    path = Path(path)
    meta_path = path.with_suffix(path.suffix + ".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        member = f"{device.type}.pt2"
        if member not in names:
            raise ValueError(f"{path} holds programs for {sorted(n[:-4] for n in names)}, not {device.type}")
        exported = torch.export.load(io.BytesIO(zf.read(member)))
    module = exported.module()

    def run(images_u8, n_real):
        images_u8 = torch.as_tensor(images_u8).to(device)
        n_real = torch.as_tensor(n_real, dtype=torch.int64).to(device)
        with torch.no_grad(), true_float32():
            return module(images_u8, n_real)

    return run, meta

"""Serve from an exported pipeline artifact alone: no model code, no weights
(the port's counterpart of the repo's root tools/serve_artifact.py: its
flags, outputs and rounding, plus `--device`).

The artifact that `cli.inference --export_pipeline` writes (serving.py)
carries the whole forward -> NMS -> top-K program with its weights embedded,
so a serving site needs only torch, the artifact and this thin program: image
IO and rendering. Loading it imports the custom-op registrations
(ops/registry.py) and no module of the port's models.

    python -m object_detection_torch2_tpu_torch.tools.serve_artifact --artifact pipe.bin \\
        --records_dir <records> [--out_dir result/served] [--limit N] [--device cpu]

Output: one rendered PNG per image, `<out_dir>/<k:06>.png` for the k-th
image from 0 (the renderer of cli/inference.py, which numbers from 1), and
`detections.json` with [image_index, class_name, score, cx, cy, w, h] rows,
5 decimals. The artifact's batch is fixed: a short final batch is padded
(`serving.pad_batch`) and its pad rows masked by the real count. The program
runs on `--device` (default the CUDA card; it raises without one, or when
the artifact holds no program for that platform); an artifact exported with
`--trunk_int8` or `--full_int8` runs its int8 kernels as exported.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.serving import load_detection_pipeline, pad_batch, unpack_detections
from object_detection_torch2_tpu_torch.utils.render import (
    hls_palette,
    render_detections_compact,
    require_pil,
    save_detections,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--artifact", type=str, required=True)
    parser.add_argument("--data_dirs", type=str, nargs="+", default=None,
                        help="VOC roots (test.txt split); omit with --records_dir")
    parser.add_argument("--records_dir", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default="result/served")
    parser.add_argument("--limit", type=int, default=None, help="serve at most N images")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the program; default the CUDA card (raises without one), "
                             "'cpu' for the artifact's CPU program")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Serve every image (or --limit of them); returns {"images": served,
    "detections": rows written, "paths": the PNGs in order}."""
    args = parse_args(argv)
    require_pil()
    run, meta = load_detection_pipeline(args.artifact, args.device)
    batch_size, imsize = int(meta["batch_size"]), int(meta["imsize"])
    print(f"artifact: {meta}")

    if args.records_dir:
        dataset = RecordDataset(args.records_dir)
    else:
        dataset = PascalVOCDataset("detection", args.data_dirs, "test.txt", imsize)
    loader = DataLoader(dataset, batch_size, max_gt=8, drop_last=False)

    labelmap = LabelMap("PascalVOC")
    palette = hls_palette(len(labelmap) + 1)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    rows, paths = [], []
    n = 0
    try:
        for images_u8, _ in loader:
            images_u8 = np.asarray(images_u8)
            padded, real = pad_batch(images_u8, batch_size)
            packed, _ = run(padded, real)
            boxes, classes, scores = unpack_detections(packed.cpu().numpy())
            for i in range(int(real)):
                img = render_detections_compact(images_u8[i], boxes[i], classes[i], scores[i], labelmap, imsize,
                                                palette)
                paths.append(save_detections(out_dir, n, img))
                for b, c, s in zip(boxes[i], classes[i], scores[i]):
                    if s > 0 and c > 0:
                        rows.append([n, labelmap.id2name(int(c) - 1), round(float(s), 5)]
                                    + [round(float(v), 5) for v in b])
                n += 1
                if args.limit and n >= args.limit:
                    break
            if args.limit and n >= args.limit:
                break
    finally:
        loader.close()
    (out_dir / "detections.json").write_text(json.dumps(rows, indent=0))
    print(f"served {n} images -> {out_dir} ({len(rows)} detections)")
    return {"images": n, "detections": len(rows), "paths": paths}


if __name__ == "__main__":
    main()

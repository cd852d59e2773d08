"""Inference entry point (counterpart of object_detection_torch2_tpu/cli/inference.py:31-184;
reference: src/inference.py:13-103).

    python -m object_detection_torch2_tpu_torch.cli.inference --records_dir <dir> [--device cpu]

VOC2007 test (packed records, or the raw VOC tree) -> the serving pipeline
(`infer.build_detection_pipeline`: forward, decode, scores, NMS with the CUDA
sweep kernel on the card, top-K) -> only the packed (N, K, 6) rows come back
to the host -> PIL rendering of boxes and labels (void skipped) on the host
uint8 image -> <result_dir>/detection/{n:06}.png, numbered globally from 1
over the whole dataset. PIL is needed: the CLI raises at its start when it
does not import.

Weights come from <result_dir>/detection/<weights> (a weights.msgpack of
either package), else as `cli.common.build_ssd` says. The run is on the CUDA
card unless `--device cpu` is given; without a card it raises.

Batches run one after another: the next batch is dispatched after this
batch's rows reach the host and are rendered (the loader's thread prefetches
the input meanwhile). Not ported yet (ROADMAP Queue 1 G): the overlapped
fetch pipeline, --batches_per_dispatch above 1, --d2h_half,
--export_pipeline and multi-process inference; int8 serving waits for
Queue 1 F.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.cli import common
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.infer import build_detection_pipeline, unpack_detections
from object_detection_torch2_tpu_torch.utils.render import (
    hls_palette,
    render_detections_compact,
    require_pil,
    save_detections,
)

PROGRESS_EVERY = 10  # batches between progress lines


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, batch_size_default=2)
    parser.add_argument("--max_detections", type=int, default=200,
                        help="device-side top-K compaction bound (post-NMS survivors)")
    parser.add_argument("--batches_per_dispatch", type=int, default=1,
                        help="batches per dispatch; above 1 is not ported yet (ROADMAP Queue 1 G)")
    parser.add_argument("--d2h_half", action="store_true",
                        help="fetch packed detections as float16; not ported yet (ROADMAP Queue 1 G)")
    parser.add_argument("--export_pipeline", type=str, default=None,
                        help="serialize the whole pipeline; not ported yet (ROADMAP Queue 1 G)")
    parser.add_argument("--export_platforms", type=str, default="tpu,cpu",
                        help="lowering platforms of --export_pipeline artifacts")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    common.add_serving_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Render every image's detections; returns {"paths": the PNGs in
    order, "batch_s": each batch's host seconds to its rows on the host,
    "render_s": each batch's host seconds of rendering and saving}."""
    args = parse_args(argv)
    if args.batches_per_dispatch > 1:
        raise NotImplementedError("--batches_per_dispatch above 1 is not ported yet (ROADMAP Queue 1 G)")
    if args.d2h_half:
        raise NotImplementedError("--d2h_half is not ported yet (ROADMAP Queue 1 G)")
    if args.export_pipeline:
        raise NotImplementedError("--export_pipeline is not ported yet (ROADMAP Queue 1 G)")
    common.check_int8(args)
    common.init_serving_distributed(args)
    common.serving_mesh(args)
    device = resolve_device(args.device)
    require_pil()
    out_dir = Path(args.result_dir) / "detection"

    if args.records_dir:
        dataset = RecordDataset(args.records_dir)
    else:
        dataset = PascalVOCDataset(
            "detection", args.data_dirs or common.DEFAULT_TEST_DIRS, "test.txt", args.imsize
        )
    loader = DataLoader(dataset, args.batch_size, max_gt=args.max_gt, drop_last=False,
                        num_workers=args.num_workers)
    paths, batch_s, render_s = [], [], []
    truncated = False
    try:
        model, labelmap = common.build_ssd(args, out_dir / args.weights)
        run = build_detection_pipeline(model, args.bn_mode == "batch", args.imsize,
                                       max_detections=args.max_detections, device=device)
        palette = hls_palette(len(labelmap) + 1)
        base = 0  # images in previous batches: output numbering is global
        for b, (images_u8, _) in enumerate(loader, start=1):
            images_u8 = np.asarray(images_u8)
            real = images_u8.shape[0]
            t0 = time.perf_counter()
            packed, n_valid = run(common.pad_rows(images_u8, args.batch_size), real)
            boxes, classes, scores = unpack_detections(packed.cpu().numpy())
            truncated |= int(n_valid.max()) > args.max_detections
            t1 = time.perf_counter()
            for i in range(real):
                img = render_detections_compact(images_u8[i], boxes[i], classes[i], scores[i], labelmap,
                                                args.imsize, palette)
                paths.append(save_detections(out_dir, base + i + 1, img))
            render_s.append(time.perf_counter() - t1)
            batch_s.append(t1 - t0)
            base += real
            if b % PROGRESS_EVERY == 0 or b == len(loader):
                print(f"inference: batch {b}/{len(loader)}", flush=True)
    finally:
        loader.close()
    if truncated:
        print(f"warning: >{args.max_detections} post-NMS detections in a batch; "
              "lowest-scored were dropped (raise --max_detections)")
    print("Finished Inference")
    return {"paths": paths, "batch_s": batch_s, "render_s": render_s}


if __name__ == "__main__":
    main()

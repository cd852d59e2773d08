"""Evaluation entry point (counterpart of object_detection_torch2_tpu/cli/evaluate.py:39-239;
reference: src/evaluate.py:74-187).

    python -m object_detection_torch2_tpu_torch.cli.evaluate --records_dir <dir> [--strict_ap] [--device cpu]

VOC2007 test (packed records, or the raw VOC tree) -> the serving pipeline
through NMS and top-K (the CUDA NMS sweep kernel on the card) -> first-claim
TP assignment of every class at once -> per-class AP. The parity metric (the
default) is the reference's recall-equivalent "average precision" (quirk Q5),
comparable with the published 0.314 mAP; --strict_ap also computes the
score-ranked AP. Writes the reference's markdown report to
<result_dir>/detection/.

Weights come from <result_dir>/detection/<weights> (a weights.msgpack of
either package), else as `cli.common.build_ssd` says. The run is on the CUDA
card unless `--device cpu` is given; without a card it raises.

Per batch, the device computes the forward, post-processing and matcher, and
only the (N, C, K) match tensors come back to the host. The loop is
sequential: the next batch is dispatched after this batch's matches reach
the host (the loader's thread prefetches the input meanwhile). Not ported
yet (ROADMAP Queue 1 G): --batches_per_dispatch above 1, --d2h_half, the
overlapped fetch pipeline and multi-process evaluation; int8 serving waits for
Queue 1 F.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.cli import common
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.infer import build_detection_pipeline
from object_detection_torch2_tpu_torch.metrics.ap import APAccumulator
from object_detection_torch2_tpu_torch.metrics.assign import detection_matches
from object_detection_torch2_tpu_torch.ops.scores import expand_detections
from object_detection_torch2_tpu_torch.utils.report import write_report

PROGRESS_EVERY = 10  # batches between progress lines


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, batch_size_default=2)
    parser.add_argument("--strict_ap", action="store_true", help="also report proper score-ranked AP")
    parser.add_argument("--max_detections", type=int, default=200,
                        help="device-side top-K compaction bound (post-NMS survivors)")
    parser.add_argument("--batches_per_dispatch", type=int, default=1,
                        help="batches per dispatch; above 1 is not ported yet (ROADMAP Queue 1 G)")
    parser.add_argument("--d2h_half", action="store_true",
                        help="fetch match scores as float16; not ported yet (ROADMAP Queue 1 G)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    common.add_serving_args(parser)
    return parser.parse_args(argv)


def build_eval_pipeline(model, use_batch_stats: bool, imsize: int, num_classes: int,
                        max_detections: int = 200, device=None):
    """-> run(images_u8 (N, H, W, 3) uint8, gts (N, G, 4 + 21), n_real) ->
    (detection_matches dict at K = max_detections rows, n_valid (N,)), both
    on `device`.

    The detection pipeline of `infer.build_detection_pipeline` (forward,
    decode, scores, NMS, top-K), then the top-K rows in the post-NMS layout
    (`expand_detections`), the ground truth of pad rows (index >= n_real)
    zeroed, and `detection_matches`. device=None means the CUDA card, and
    raises without one; pass "cpu" to run on the CPU."""
    device = resolve_device(device)
    detect = build_detection_pipeline(model, use_batch_stats, imsize, max_detections=max_detections, device=device)

    @torch.inference_mode()
    def run(images_u8, gts, n_real: int):
        packed, n_valid = detect(images_u8, n_real)
        boxes, classes, scores = packed[..., :4], packed[..., 4].to(torch.int64), packed[..., 5]
        compact = expand_detections(boxes, classes, scores, num_classes + 1)
        gts = torch.as_tensor(gts).to(device)
        mask = (torch.arange(gts.shape[0], device=device) < n_real).to(gts.dtype)
        return detection_matches(compact, gts * mask[:, None, None], num_classes=num_classes), n_valid

    return run


def accumulate(run, loader, batch_size: int, num_classes: int, max_detections: int):
    """Every batch of `loader` through `run`, a ragged final batch padded to
    `batch_size` (repeat-last rows, masked by n_real) -> (APAccumulator, True
    if some image had more than max_detections survivors)."""
    acc = APAccumulator(num_classes)
    truncated = False
    for i, (images_u8, gts) in enumerate(loader, start=1):
        real = images_u8.shape[0]
        matches, n_valid = run(common.pad_rows(images_u8, batch_size),
                               common.pad_rows(np.asarray(gts, np.float32), batch_size), real)
        acc.update(matches)
        truncated |= int(n_valid.max()) > max_detections
        if i % PROGRESS_EVERY == 0 or i == len(loader):
            print(f"evaluate: batch {i}/{len(loader)}", flush=True)
    return acc, truncated


def main(argv=None):
    args = parse_args(argv)
    if args.batches_per_dispatch > 1:
        raise NotImplementedError("--batches_per_dispatch above 1 is not ported yet (ROADMAP Queue 1 G)")
    if args.d2h_half:
        raise NotImplementedError("--d2h_half is not ported yet (ROADMAP Queue 1 G)")
    common.check_int8(args)
    common.init_serving_distributed(args)
    common.serving_mesh(args)
    device = resolve_device(args.device)
    out_dir = Path(args.result_dir) / "detection"

    if args.records_dir:
        dataset = RecordDataset(args.records_dir)
    else:
        dataset = PascalVOCDataset(
            "detection", args.data_dirs or common.DEFAULT_TEST_DIRS, "test.txt", args.imsize
        )
    loader = DataLoader(dataset, args.batch_size, max_gt=args.max_gt, drop_last=False,
                        num_workers=args.num_workers)
    try:
        model, labelmap = common.build_ssd(args, out_dir / args.weights)
        num_classes = len(labelmap)
        run = build_eval_pipeline(model, args.bn_mode == "batch", args.imsize, num_classes,
                                  args.max_detections, device=device)
        acc, truncated = accumulate(run, loader, args.batch_size, num_classes, args.max_detections)
    finally:
        loader.close()
    if truncated:
        print(f"warning: >{args.max_detections} post-NMS detections in a batch; "
              "lowest-scored were dropped (raise --max_detections)")

    aps, mean_ap = acc.result(strict=False)
    strict_mean = strict_aps = None
    if args.strict_ap:
        strict_aps, strict_mean = acc.result(strict=True)
    print("mAP (reference parity metric):", round(mean_ap, 4))
    if strict_mean is not None:
        print("mAP (strict, score-ranked):", round(strict_mean, 4))
    path = write_report(out_dir, vars(args), aps, mean_ap, labelmap, device=device)
    print("report:", path)
    print("Finished Evaluate")
    return aps, mean_ap, strict_mean, strict_aps


if __name__ == "__main__":
    main()

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
only the (N, C, K) match tensors come back to the host, through
`utils.hostsync.FetchPipeline`: each batch's matches start their copy at
dispatch and are accumulated two batches later, so the host's AP work and
the copy overlap the next batches on the card. `--batches_per_dispatch K`
runs K padded batches a call (each with its own batch statistics, as K calls
would) and brings their matches back in one copy; the batches left over at
the end run one at a time. `--d2h_half` copies the largest leaf, the match
scores, as float16 (`correct` is already bool). Not ported yet: multi-process
evaluation (ROADMAP Queue 1 G2); int8 serving waits for Queue 1 F.
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
from object_detection_torch2_tpu_torch.utils.hostsync import FetchPipeline
from object_detection_torch2_tpu_torch.utils.report import write_report

PROGRESS_EVERY = 10  # batches between progress lines


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_args(parser, batch_size_default=2)
    parser.add_argument("--strict_ap", action="store_true", help="also report proper score-ranked AP")
    parser.add_argument("--max_detections", type=int, default=200,
                        help="device-side top-K compaction bound (post-NMS survivors)")
    parser.add_argument("--batches_per_dispatch", type=int, default=1,
                        help="evaluate K batches per call, their matches copied to the host at once "
                             "(per-batch semantics unchanged; leftover batches run one at a time)")
    parser.add_argument("--d2h_half", action="store_true",
                        help="copy the match scores to the host as float16 (~5e-4 quantization); "
                             "default float32 is bit-exact")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    common.add_serving_args(parser)
    return parser.parse_args(argv)


def build_eval_pipeline(model, use_batch_stats: bool, imsize: int, num_classes: int,
                        max_detections: int = 200, device=None, d2h_half: bool = False):
    """-> run(images_u8 (N, H, W, 3) uint8, gts (N, G, 4 + 21), n_real) ->
    (detection_matches dict at K = max_detections rows, n_valid (N,)), both
    on `device`.

    The detection pipeline of `infer.build_detection_pipeline` (forward,
    decode, scores, NMS, top-K), then the top-K rows in the post-NMS layout
    (`expand_detections`), the ground truth of pad rows (index >= n_real)
    zeroed, and `detection_matches`. device=None means the CUDA card, and
    raises without one; pass "cpu" to run on the CPU.

    run also takes K stacked batches — images (K, N, H, W, 3), gts
    (K, N, G, 25), n_real (K,) — each with its own batch statistics, and
    returns the results with a leading K axis. d2h_half casts the matches'
    `scores` to float16 on the device."""
    device = resolve_device(device)
    detect = build_detection_pipeline(model, use_batch_stats, imsize, max_detections=max_detections, device=device)

    def body(images_u8, gts, n_real):
        packed, n_valid = detect(images_u8, n_real)
        boxes, classes, scores = packed[..., :4], packed[..., 4].to(torch.int64), packed[..., 5]
        compact = expand_detections(boxes, classes, scores, num_classes + 1)
        mask = (torch.arange(gts.shape[0], device=device) < n_real).to(gts.dtype)
        matches = detection_matches(compact, gts * mask[:, None, None], num_classes=num_classes)
        if d2h_half:
            matches = {**matches, "scores": matches["scores"].to(torch.float16)}
        return matches, n_valid

    @torch.inference_mode()
    def run(images_u8, gts, n_real):
        images_u8, gts = torch.as_tensor(images_u8).to(device), torch.as_tensor(gts).to(device)
        if images_u8.dim() == 4:
            return body(images_u8, gts, n_real)
        outs = [body(images_u8[k], gts[k], int(r)) for k, r in enumerate(n_real)]
        matches = {key: torch.stack([m[key] for m, _ in outs]) for key in outs[0][0]}
        return matches, torch.stack([n for _, n in outs])

    return run


def accumulate(run, loader, batch_size: int, num_classes: int, max_detections: int,
               batches_per_dispatch: int = 1, fetch_depth: int = 2):
    """Every batch of `loader` through `run`, a ragged final batch padded to
    `batch_size` (repeat-last rows, masked by n_real), K = batches_per_dispatch
    batches a call (the last < K one at a time), each call's results fetched
    `fetch_depth` calls later -> (APAccumulator, True if some image had more
    than max_detections survivors)."""
    acc = APAccumulator(num_classes)
    truncated = False
    pipe = FetchPipeline(fetch_depth)
    group: list = []

    def drain(done):
        nonlocal truncated
        if done is None:
            return
        matches, n_valid = done
        for k in range(n_valid.shape[0]):
            acc.update({key: v[k] for key, v in matches.items()})
        truncated |= int(n_valid.max()) > max_detections

    for i, (images_u8, gts) in enumerate(loader, start=1):
        real = images_u8.shape[0]
        group.append((common.pad_rows(np.asarray(images_u8), batch_size),
                      common.pad_rows(np.asarray(gts, np.float32), batch_size), real))
        if len(group) == batches_per_dispatch:
            drain(pipe.push(run(np.stack([g[0] for g in group]), np.stack([g[1] for g in group]),
                                [g[2] for g in group])))
            group = []
        if i % PROGRESS_EVERY == 0 or i == len(loader):
            print(f"evaluate: batch {i}/{len(loader)}", flush=True)
    for images_u8, gts, real in group:  # leftover batches (< K), one at a time
        matches, n_valid = run(images_u8, gts, real)
        drain(pipe.push(({key: v[None] for key, v in matches.items()}, n_valid[None])))
    for done in pipe.flush():
        drain(done)
    return acc, truncated


def main(argv=None):
    args = parse_args(argv)
    if args.batches_per_dispatch < 1:
        raise SystemExit(f"--batches_per_dispatch must be >= 1, got {args.batches_per_dispatch}")
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
                                  args.max_detections, device=device, d2h_half=args.d2h_half)
        acc, truncated = accumulate(run, loader, args.batch_size, num_classes, args.max_detections,
                                    args.batches_per_dispatch)
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

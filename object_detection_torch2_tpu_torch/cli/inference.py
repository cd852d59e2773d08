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

The rows come back through `utils.hostsync.FetchPipeline`: each batch's
packed rows start their copy at dispatch and are rendered two batches later,
so the card computes the next batches while the host draws.
`--batches_per_dispatch K` runs K padded batches a call (the same detections
as K calls), their rows in one copy; the batches left over at the end run one
at a time. `--d2h_half` copies the packed rows as float16 (~5e-4 relative,
≲0.15 px at 300). `--export_pipeline PATH` writes the whole pipeline with its
weights as `torch.export` programs for `--export_platforms` (serving.py) and
exits. `--trunk_int8` and `--full_int8` serve the model on its int8 paths
(`cli.common.apply_int8`; the int8 kernel on the card), the export included:
the exported program then holds the int8 op's calls.

Several processes (`--distributed`, or `--num_devices N`: cli.common's
`run_data_parallel`; the JAX CLI's loop, its cli/inference.py:62-160): each
process reads its contiguous slice of every global batch, pads it to
batch_size // world rows, runs it with the global batch's real count, and
renders and writes the PNGs of its own rows, numbered by their global index.
`--export_pipeline` writes one single-device artifact whatever the flags of
several processes say, as the JAX CLI does (its cli/inference.py:87-99):
`--num_devices N` launches nothing, and under `--distributed` rank 0 writes
it while the others wait at a barrier (one writer of a path).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.cli import common
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.infer import build_detection_pipeline, unpack_detections
from object_detection_torch2_tpu_torch.parallel.mesh import barrier
from object_detection_torch2_tpu_torch.utils.hostsync import FetchPipeline
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
                        help="run K batches per call, their rows copied to the host at once (the same "
                             "detections; leftover batches run one at a time)")
    parser.add_argument("--d2h_half", action="store_true",
                        help="copy the packed detections to the host as float16 (~5e-4 quantization, "
                             "≲0.15 px at 300); default float32 is bit-exact")
    parser.add_argument("--export_pipeline", type=str, default=None,
                        help="instead of running inference, write the whole pipeline (weights embedded) to "
                             "this path as torch.export programs (serving.py; loads without model code) "
                             "and exit")
    parser.add_argument("--export_platforms", type=str, default="cuda,cpu",
                        help="comma-separated platforms of --export_pipeline artifacts, each traced on "
                             "its own device")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    common.add_serving_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Render every image's detections; returns {"paths": the PNGs in
    order, "batch_s": for each dispatch whose rows were rendered, the host
    seconds from the start of the call that returned them from the fetch
    pipeline (or of the final flush) to their arrival on the host,
    "render_s": each such dispatch's host seconds of rendering and saving}.
    With --export_pipeline it writes the artifact instead and returns
    {"export": its metadata}."""
    args = parse_args(argv)
    if args.batches_per_dispatch < 1:
        raise SystemExit(f"--batches_per_dispatch must be >= 1, got {args.batches_per_dispatch}")
    if args.export_pipeline:
        return {"export": common.run_data_parallel(args, _export, _export_world)}
    require_pil()
    return common.run_data_parallel(args, _main, common.serving_mesh)


def _main(args, mesh) -> dict:
    """The inference on one process: the whole run (`mesh` None) or this
    rank's part of it (its rows' PNGs; a launched run returns rank 0's
    paths)."""
    out_dir = Path(args.result_dir) / "detection"
    device = mesh.device if mesh is not None else resolve_device(args.device)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    local_bs = args.batch_size // world
    dataset = _dataset(args)

    loader = DataLoader(dataset, args.batch_size, max_gt=args.max_gt, drop_last=False,
                        num_workers=args.num_workers)
    paths, batch_s, render_s = [], [], []
    truncated = False
    pipe = FetchPipeline()
    group: list = []
    try:
        model, labelmap = common.build_ssd(args, out_dir / args.weights)
        model = common.apply_int8(args, model, dataset, device, mesh)
        run = build_detection_pipeline(model, args.bn_mode == "batch", args.imsize,
                                       max_detections=args.max_detections, device=device, d2h_half=args.d2h_half,
                                       mesh=mesh)
        palette = hls_palette(len(labelmap) + 1)

        def drain(done, t0):
            """Render a dispatch's rows come back from the pipeline."""
            nonlocal truncated
            if done is None:
                return
            t1 = time.perf_counter()
            images_k, packed_k, n_valid, bases = done
            truncated |= int(n_valid.max()) > args.max_detections
            for images_u8, packed, base in zip(images_k, packed_k, bases):
                boxes, classes, scores = unpack_detections(packed.numpy())
                for i in range(images_u8.shape[0]):  # the real rows
                    img = render_detections_compact(images_u8[i], boxes[i], classes[i], scores[i], labelmap,
                                                    args.imsize, palette)
                    paths.append(save_detections(out_dir, base + i + 1, img))
            render_s.append(time.perf_counter() - t1)
            batch_s.append(t1 - t0)

        def dispatch(items):
            """One call over the padded batches of `items` [(images, padded, base, real)]."""
            t0 = time.perf_counter()
            packed, n_valid = run(np.stack([it[1] for it in items]), [it[3] for it in items])
            drain(pipe.push(([it[0] for it in items], packed, n_valid, [it[2] for it in items])), t0)

        n = len(dataset)
        for b, (images_u8, _) in enumerate(loader, start=1):
            images_u8 = np.asarray(images_u8)
            start = (b - 1) * args.batch_size  # output numbering is global
            real = min(args.batch_size, n - start)
            group.append((images_u8, common.pad_rows(images_u8, local_bs), start + rank * local_bs, real))
            if len(group) == args.batches_per_dispatch:
                dispatch(group)
                group = []
            if rank == 0 and (b % PROGRESS_EVERY == 0 or b == len(loader)):
                print(f"inference: batch {b}/{len(loader)}", flush=True)
        for item in group:  # leftover batches (< K), one at a time
            dispatch([item])
        for done in pipe.flush():
            drain(done, time.perf_counter())
    finally:
        loader.close()
    if truncated:
        print(f"warning: >{args.max_detections} post-NMS detections in a batch; "
              "lowest-scored were dropped (raise --max_detections)")
    if rank == 0:
        print("Finished Inference")
    return {"paths": paths, "batch_s": batch_s, "render_s": render_s}


def _dataset(args):
    if args.records_dir:
        return RecordDataset(args.records_dir)
    return PascalVOCDataset("detection", args.data_dirs or common.DEFAULT_TEST_DIRS, "test.txt", args.imsize)


def _export_world(args, mesh=None) -> int:
    """The export's world: one process, or under --distributed torchrun's
    world, held to the serving CLIs' rules (cli.common.serving_mesh)."""
    return 1 if mesh is None else common.serving_mesh(args, mesh)


def _export(args, mesh=None) -> dict:
    """The model, on its int8 path when a flag asks (--full_int8 calibrated
    on the rank's device over the run's dataset), as an exported pipeline;
    returns its metadata. Under a mesh rank 0 writes the artifact while the
    others wait at a barrier, then read its metadata."""
    from object_detection_torch2_tpu_torch.serving import export_detection_pipeline

    path = Path(args.export_pipeline)
    if mesh is not None and mesh.rank != 0:
        barrier(mesh)
        return json.loads(path.with_suffix(path.suffix + ".json").read_text())
    model, _ = common.build_ssd(args, Path(args.result_dir) / "detection" / args.weights)
    if args.full_int8:
        model = common.apply_int8(args, model, _dataset(args),
                                  mesh.device if mesh is not None else resolve_device(args.device))
    elif args.trunk_int8:
        model = common.apply_trunk_int8(args, model)
    meta = export_detection_pipeline(
        model, args.export_pipeline, batch_size=args.batch_size, use_batch_stats=args.bn_mode == "batch",
        imsize=args.imsize, max_detections=args.max_detections,
        platforms=tuple(p.strip() for p in args.export_platforms.split(",") if p.strip()), d2h_half=args.d2h_half)
    print(f"exported {meta['bytes'] / 1e6:.1f} MB pipeline artifact to {args.export_pipeline} "
          f"(platforms {meta['platforms']})")
    barrier(mesh)
    return meta


if __name__ == "__main__":
    main()

"""Input-pipeline feed rate on the card: the records loader plus the copy to
the device, alone (the port's counterpart of the repo's root
tools/bench_loader.py: its records, flags and printed line, plus `--device`).

    python -m object_detection_torch2_tpu_torch.tools.bench_loader [--count 2000] [--batch_size 32]
        [--epochs 3] [--device cpu]

Writes `--count` synthetic packed records (`make_synthetic_records`: the
same images.npy, gts.npy and meta.json bytes as the root tool's for the same
arguments) to a temporary directory, then runs the port's `RecordDataset`
and `DataLoader(batch_size, shuffle=True)` for one warm epoch and
`--epochs` timed ones. Each batch goes to the device as `Trainer.train_step`
moves it (train/trainer.py `Trainer._inputs`: `torch.as_tensor(a).to(device,
non_blocking=True)` from the loader's pageable arrays, then the targets in
the loss's float32). The timed window ends in a synchronize of the card.

Prints the root tool's line (img/s, and MB/s of image bytes host -> device)
and one JSON line with the same numbers, the bytes a batch copies (images
and GT rows), and the card's name and power limit. Runs on the CUDA card
unless `--device cpu` is given; it raises without a card, before writing
anything.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.tools.common import card_line


def make_synthetic_records(out_dir: Path, count: int, imsize: int = 300, max_gt: int = 64):
    """`count` seeded random images and one planted GT row each, as packed
    records in `out_dir` (byte-equal to the root tool's for the same
    arguments)."""
    out_dir = Path(out_dir)
    rng = np.random.default_rng(0)
    images = np.lib.format.open_memmap(
        out_dir / "images.npy", mode="w+", dtype=np.uint8, shape=(count, imsize, imsize, 3)
    )
    gts = np.lib.format.open_memmap(
        out_dir / "gts.npy", mode="w+", dtype=np.float32, shape=(count, max_gt, 25)
    )
    chunk = 256
    for s in range(0, count, chunk):
        e = min(s + chunk, count)
        images[s:e] = rng.integers(0, 255, (e - s, imsize, imsize, 3), dtype=np.uint8)
    gts[:, 0, :4] = [0.5, 0.5, 0.3, 0.3]
    gts[:, 0, 10] = 1.0
    images.flush()
    gts.flush()
    with open(out_dir / "meta.json", "w") as f:
        json.dump({"imsize": imsize, "max_gt": max_gt, "count": count, "purpose": "detection"}, f)


def to_device(images, gts, device):
    """A host batch on `device` as `Trainer._inputs` moves it."""
    images, gts = (torch.as_tensor(a).to(device, non_blocking=True) for a in (images, gts))
    return images, gts.to(torch.float32)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--count", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        make_synthetic_records(tmp, args.count)
        ds = RecordDataset(tmp)
        dl = DataLoader(ds, args.batch_size, shuffle=True)

        for images, gts in dl:  # warm epoch (page cache, the card's allocator)
            to_device(images, gts, device)
        sync()
        n = nbytes = 0
        t0 = time.perf_counter()
        for _ in range(args.epochs):
            for images, gts in dl:
                to_device(images, gts, device)
                n += images.shape[0]
                nbytes += images.nbytes + gts.nbytes
        sync()
        dt = time.perf_counter() - t0
    image_mb_s = n / dt * 300 * 300 * 3 / 1e6
    print(f"loader: {n} images in {dt:.2f}s = {n / dt:.0f} img/s host->device ({image_mb_s:.0f} MB/s)")
    record = {"images": n, "seconds": dt, "img_per_s": n / dt, "image_mb_per_s": image_mb_s,
              "h2d_mb_per_s": nbytes / dt / 1e6, "bytes_per_batch": nbytes // max(n // args.batch_size, 1),
              "count": args.count, "batch_size": args.batch_size, "epochs": args.epochs, "device": str(device),
              "card": card_line() if device.type == "cuda" else None, "torch": torch.__version__}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()

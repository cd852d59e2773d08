"""Packed array records of a VOC tree for the fast input path
(copy of object_detection_torch2_tpu/data/records.py:27-115).

The reference decodes JPEG + parses XML per `__getitem__` in DataLoader worker
processes every epoch (reference: src/dataset.py:36-53, 92-116). Here that
cost is paid ONCE: the dataset is packed into flat memmappable arrays (images
pre-resized to imsize x imsize uint8, GT padded to a static max-G), and a
batch is one fancy index into a memmap.

Record layout (directory):
  images.npy  (N, imsize, imsize, 3) uint8   [np.lib.format, memmappable]
  gts.npy     (N, max_gt, 4+21) float32
  meta.json   {imsize, max_gt, count, purpose, seen_max_gt, sources, list_file}

`RecordDataset` needs only numpy; `pack_voc` imports the VOC dataset (and so
PIL) when it runs.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def pack_voc(
    data_dirs,
    data_list_file_name: str,
    out_dir,
    imsize: int = 300,
    max_gt: int = 64,
    purpose: str = "detection",
    log_every: int = 1000,
    num_workers: int = 0,
) -> "RecordDataset":
    """Build packed records from a VOC tree (runs the host decode path once).

    num_workers > 0 spreads the PIL decode + XML parse over spawned worker
    processes (data/ingest.py)."""
    from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset

    ds = PascalVOCDataset(purpose, data_dirs, data_list_file_name, imsize, transform=None)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(ds)
    gt_width = (ds.num_classes + 1 + 4) if purpose == "detection" else ds.num_classes

    images = np.lib.format.open_memmap(
        out_dir / "images.npy", mode="w+", dtype=np.uint8, shape=(n, imsize, imsize, 3)
    )
    if purpose == "detection":
        gts = np.lib.format.open_memmap(
            out_dir / "gts.npy", mode="w+", dtype=np.float32, shape=(n, max_gt, gt_width)
        )
    else:
        gts = np.lib.format.open_memmap(
            out_dir / "gts.npy", mode="w+", dtype=np.float32, shape=(n, gt_width)
        )

    if num_workers > 0:
        from object_detection_torch2_tpu_torch.data.ingest import IngestPool

        pool = IngestPool(ds, min(num_workers, n), max_gt=max_gt)
        samples = pool.samples(range(n))
    else:
        pool = None
        samples = (ds[i] for i in range(n))

    seen_max_gt = 0
    try:
        for i, (img, gt) in enumerate(samples):
            images[i] = img
            if purpose == "detection":
                g = min(gt.shape[0], max_gt)
                seen_max_gt = max(seen_max_gt, gt.shape[0])
                gts[i, :g] = gt[:g]
            else:
                gts[i] = gt
            if log_every and (i + 1) % log_every == 0:
                print(f"packed {i + 1}/{n}")
    finally:
        if pool is not None:
            pool.close()
    images.flush()
    gts.flush()

    meta = {
        "imsize": imsize,
        "max_gt": max_gt,
        "count": n,
        "purpose": purpose,
        "seen_max_gt": seen_max_gt,
        "sources": [str(d) for d in (data_dirs if isinstance(data_dirs, (list, tuple)) else [data_dirs])],
        "list_file": data_list_file_name,
    }
    with open(out_dir / "meta.json", "w") as f:
        json.dump(meta, f, indent=4)
    if purpose == "detection" and seen_max_gt > max_gt:
        print(f"WARNING: {seen_max_gt} GT boxes seen but max_gt={max_gt}; excess truncated")
    return RecordDataset(out_dir)


class RecordDataset:
    """Memmap-backed packed dataset; batch access is a single fancy index."""

    def __init__(self, record_dir):
        record_dir = Path(record_dir)
        with open(record_dir / "meta.json") as f:
            self.meta = json.load(f)
        self.images = np.load(record_dir / "images.npy", mmap_mode="r")
        self.gts = np.load(record_dir / "gts.npy", mmap_mode="r")

    def __len__(self):
        return int(self.meta["count"])

    def batch(self, indices: np.ndarray):
        return self.images[indices], self.gts[indices]

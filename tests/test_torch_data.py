"""The port's data layer against the JAX package's on the CPU, on
tests/fixtures/voc/VOCtest: the VOC dataset in both purposes, `collate`,
`pack_voc` records and the `DataLoader`'s batches and order."""

import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.data.loader import DataLoader as JaxDataLoader
from object_detection_torch2_tpu.data.records import pack_voc as jax_pack_voc
from object_detection_torch2_tpu.data.voc import PascalVOCDataset as JaxVOC
from object_detection_torch2_tpu.data.voc import collate as jax_collate
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset, pack_voc
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset, collate

torch.set_num_threads(1)

FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"


@pytest.mark.parametrize("purpose,imsize", [("detection", 96), ("classification", 64)])
def test_voc_dataset_matches_jax(purpose, imsize):
    ds = PascalVOCDataset(purpose, [FIXTURE], "trainval.txt", imsize)
    want = JaxVOC(purpose, [FIXTURE], "trainval.txt", imsize)
    assert len(ds) == len(want) == (4 if purpose == "detection" else 6)
    for i in range(len(ds)):
        (img, gt), (wimg, wgt) = ds[i], want[i]
        assert img.dtype == np.uint8 and gt.dtype == np.float32
        np.testing.assert_array_equal(img, wimg)
        np.testing.assert_array_equal(gt, wgt)
    with pytest.raises(ValueError):
        PascalVOCDataset("segmentation", [FIXTURE], "trainval.txt", imsize)


def test_collate_matches_jax_and_warns_on_truncation():
    ds = PascalVOCDataset("detection", [FIXTURE], "trainval.txt", 96)
    batch = [ds[i] for i in range(4)]
    for max_gt in (8, None):
        got, want = collate(batch, max_gt=max_gt), jax_collate(batch, max_gt=max_gt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, gts = collate(batch[:3], max_gt=2)  # image 2 has 3 boxes
    assert gts.shape == (3, 2, 25)
    assert any("truncating to max_gt=2" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        collate(batch, max_gt=8)
    assert not caught
    cls = PascalVOCDataset("classification", [FIXTURE], "trainval.txt", 32)
    _, onehots = collate([cls[i] for i in range(3)])
    assert onehots.shape == (3, 20)


def test_pack_voc_matches_jax(tmp_path):
    rec = pack_voc([FIXTURE], "test.txt", tmp_path / "port", imsize=96, max_gt=8, log_every=0)
    jax_pack_voc([FIXTURE], "test.txt", tmp_path / "jax", imsize=96, max_gt=8, log_every=0)
    for name in ("images.npy", "gts.npy"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert len(rec) == 4 and rec.meta["seen_max_gt"] == 3
    images, gts = RecordDataset(tmp_path / "port").batch(np.array([0, 2]))
    assert images.shape == (2, 96, 96, 3) and gts.shape == (2, 8, 25)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("rec")
    pack_voc([FIXTURE], "trainval.txt", out, imsize=96, max_gt=8, log_every=0)
    return RecordDataset(out)


def _epochs(loader, n=2):
    return [[tuple(np.asarray(a) for a in b) for b in loader] for _ in range(n)]


@pytest.mark.parametrize("source", ["records", "raw"])
@pytest.mark.parametrize("shuffle,drop_last,batch_size,stack_steps",
                         [(False, True, 2, 1), (True, True, 3, 1), (True, False, 3, 1), (False, False, 3, 1),
                          (True, False, 1, 3)])
def test_loader_matches_jax(records, source, shuffle, drop_last, batch_size, stack_steps):
    """Batch contents and order over two epochs (the shuffle re-seeds per
    epoch), with a ragged tail (4 images at batch 3, drop_last=False) and
    stacked steps."""
    ds = records if source == "records" else PascalVOCDataset("detection", [FIXTURE], "trainval.txt", 96)
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=5, max_gt=8, drop_last=drop_last,
              stack_steps=stack_steps)
    port, jax_loader = DataLoader(ds, **kw), JaxDataLoader(ds, **kw)
    got, want = _epochs(port), _epochs(jax_loader)
    assert len(port) == len(jax_loader)
    assert len(got[0]) == -(-len(port) // stack_steps)  # len counts batches; a stack holds K of them
    for epoch_got, epoch_want in zip(got, want, strict=True):
        for (img, gt), (wimg, wgt) in zip(epoch_got, epoch_want, strict=True):
            assert img.dtype == np.uint8 and gt.dtype == np.float32
            np.testing.assert_array_equal(img, wimg)
            np.testing.assert_array_equal(gt, wgt)
    if shuffle:
        assert any(not np.array_equal(a[0], b[0]) for a, b in zip(got[0], got[1]))


def test_loader_num_workers_equivalence():
    """Spawned decode workers (data/ingest.py) yield the in-thread batches, in
    order, over two epochs."""
    ds = PascalVOCDataset("detection", [FIXTURE], "trainval.txt", imsize=96)
    dl0 = DataLoader(ds, batch_size=2, shuffle=True, seed=3, max_gt=8, num_workers=0)
    dl2 = DataLoader(ds, batch_size=2, shuffle=True, seed=3, max_gt=8, num_workers=2)
    try:
        for _ in range(2):
            for (im0, gt0), (im2, gt2) in zip(dl0, dl2, strict=True):
                np.testing.assert_array_equal(im0, im2)
                np.testing.assert_array_equal(gt0, gt2)
    finally:
        dl2.close()


def test_loader_unported_options_and_errors(records):
    """A data-parallel mesh gives each rank its contiguous slice of every
    global batch (tests/test_torch_parallel.py holds the slices against the
    JAX loader's); the JAX loader's refusals stay: a batch that does not
    divide over the ranks, and a ragged final batch under a mesh."""
    from object_detection_torch2_tpu_torch.parallel.mesh import Mesh

    whole = [gts for _, gts in DataLoader(records, batch_size=2)]
    halves = [[gts for _, gts in DataLoader(records, batch_size=2, mesh=Mesh(r, 2, torch.device("cpu")))]
              for r in range(2)]
    for batch, (a, b) in zip(whole, zip(*halves), strict=True):
        np.testing.assert_array_equal(np.concatenate([a, b]), batch)
    with pytest.raises(ValueError, match="must divide over 2 processes"):
        DataLoader(records, batch_size=3, mesh=Mesh(0, 2, torch.device("cpu")))
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(records, batch_size=2, mesh=Mesh(0, 2, torch.device("cpu")), drop_last=False)
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(records, batch_size=2, device_cache=True, drop_last=False, device="cpu")

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise OSError("corrupt image")
            return np.zeros((8, 8, 3), np.uint8), np.zeros((1, 25), np.float32)

    with pytest.raises(OSError, match="corrupt image"):
        list(DataLoader(Broken(), batch_size=2, max_gt=1))

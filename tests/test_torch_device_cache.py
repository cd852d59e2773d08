"""The port's device-resident dataset cache (data/device_cache.py) and
`DataLoader(device_cache=True)` on the CPU: the same batches as streaming, bit
for bit (1-D, stacked, the epoch's tail, two epochs), the JAX package's
guards, the chunked upload, a training run whose losses equal the streaming
run's, and the training CLI's `--device_cache`."""

from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.data.loader import DataLoader as JaxDataLoader
from object_detection_torch2_tpu.data.records import RecordDataset as JaxRecordDataset
from object_detection_torch2_tpu.utils.testing import synth_targets
from object_detection_torch2_tpu_torch.cli import train
from object_detection_torch2_tpu_torch.core.anchors import default_boxes, feature_grids_for
from object_detection_torch2_tpu_torch.data import device_cache
from object_detection_torch2_tpu_torch.data.device_cache import DeviceCache
from object_detection_torch2_tpu_torch.data.loader import DataLoader
from object_detection_torch2_tpu_torch.data.records import RecordDataset, pack_voc
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.train.optimizer import adam_torch
from object_detection_torch2_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"
IMSIZE = 264


def _write_records(out: Path, n: int, imsize: int, seed: int, g_pad: int = 8) -> Path:
    """n seeded records in the layout of data/records.py, with numpy only."""
    import json

    rng = np.random.default_rng(seed)
    out.mkdir(parents=True)
    np.save(out / "images.npy", rng.integers(0, 256, (n, imsize, imsize, 3), dtype=np.uint8))
    np.save(out / "gts.npy", synth_targets(rng, n, rng.integers(1, g_pad + 1, n), g_pad))
    (out / "meta.json").write_text(json.dumps({"imsize": imsize, "max_gt": g_pad, "count": n,
                                               "purpose": "detection", "sources": [], "list_file": ""}))
    return out


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """11 seeded records at imsize 96: 5 batches of 2 and a dropped one."""
    return _write_records(tmp_path_factory.mktemp("rec") / "r", 11, 96, seed=5)


def _host(batches):
    return [(np.asarray(i), np.asarray(g)) for i, g in batches]


@pytest.mark.parametrize("stack_steps", [1, 2, 3])
def test_cached_batches_equal_streaming(rec, stack_steps):
    """Two shuffled epochs: every batch (and every (K, B) stack, the tail's
    shorter one included) bit-equal to the streaming loader's and to the JAX
    package's streaming loader's."""
    kwargs = dict(batch_size=2, shuffle=True, seed=3, max_gt=8, stack_steps=stack_steps)
    stream = DataLoader(RecordDataset(rec), **kwargs)
    cached = DataLoader(RecordDataset(rec), device_cache=True, device="cpu", **kwargs)
    jax_stream = JaxDataLoader(JaxRecordDataset(rec), **kwargs)
    for _ in range(2):
        a, b, c = _host(stream), list(cached), _host(jax_stream)
        assert len(a) == len(b) == len(c) == -(-5 // stack_steps)
        for (ia, ga), (ib, gb), (ic, gc) in zip(a, b, c):
            assert isinstance(ib, torch.Tensor) and ib.device.type == "cpu" and ib.dtype == torch.uint8
            np.testing.assert_array_equal(ia, ib.numpy())
            np.testing.assert_array_equal(ga, gb.numpy())
            np.testing.assert_array_equal(ia, ic)
            np.testing.assert_array_equal(ga, gc)
    if stack_steps == 2:
        assert b[-1][0].shape == (1, 2, 96, 96, 3)  # the tail stack


def test_cached_batches_of_the_fixture_equal_streaming(tmp_path):
    """Records packed from the VOC fixture by the port's pack_voc."""
    ds = pack_voc([FIXTURE], "trainval.txt", tmp_path / "rec", imsize=96, max_gt=8, log_every=0)
    stream = DataLoader(ds, batch_size=2, shuffle=True, seed=1, max_gt=8)
    cached = DataLoader(ds, batch_size=2, shuffle=True, seed=1, max_gt=8, device_cache=True, device="cpu")
    for (ia, ga), (ib, gb) in zip(_host(stream), cached, strict=True):
        np.testing.assert_array_equal(ia, ib.numpy())
        np.testing.assert_array_equal(ga, gb.numpy())


def test_gather_shapes_and_chunked_upload(rec, monkeypatch):
    """The upload in chunks of a few rows gives the records back bit for bit;
    gather takes (B,) and (K, B) indices."""
    ds = RecordDataset(rec)
    monkeypatch.setattr(device_cache, "UPLOAD_CHUNK_BYTES", 3 * 96 * 96 * 3 + 1)  # 3 image rows a chunk
    cache = DeviceCache(ds, device="cpu", verbose=False)
    np.testing.assert_array_equal(cache.images.numpy(), np.asarray(ds.images))
    np.testing.assert_array_equal(cache.gts.numpy(), np.asarray(ds.gts))
    assert cache.nbytes() == np.asarray(ds.images).nbytes + np.asarray(ds.gts).nbytes
    images, gts = cache.gather(np.array([[4, 0], [7, 7]]))
    assert images.shape == (2, 2, 96, 96, 3) and gts.shape == (2, 2, 8, 25)
    np.testing.assert_array_equal(images[1, 0].numpy(), np.asarray(ds.images[7]))
    np.testing.assert_array_equal(gts[0, 0].numpy(), np.asarray(ds.gts[4]))


def test_device_cache_guards(rec):
    """The JAX package's guards: records only and drop_last; a mesh waits for
    G2; no card means an error unless the CPU is asked for."""
    with pytest.raises(ValueError, match="RecordDataset"):
        DataLoader([(np.zeros((8, 8, 3), np.uint8), np.zeros((1, 25), np.float32))] * 4, batch_size=2,
                   device_cache=True, device="cpu")
    with pytest.raises(ValueError, match="drop_last"):
        DataLoader(RecordDataset(rec), batch_size=2, drop_last=False, device_cache=True, device="cpu")
    with pytest.raises(NotImplementedError, match="G2"):
        DataLoader(RecordDataset(rec), batch_size=2, device_cache=True, device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DataLoader(RecordDataset(rec), batch_size=2, device_cache=True)


def test_trainer_takes_device_batches_without_a_copy():
    """A batch already on the trainer's device is used as it is."""
    trainer = Trainer(SSD(num_classes=21), default_boxes=default_boxes(feature_grids_for(IMSIZE)), device="cpu")
    images = torch.rand(2, IMSIZE, IMSIZE, 3)
    targets = torch.zeros(2, 4, 25)
    got_images, got_targets = trainer._inputs(images, targets)
    assert got_images.data_ptr() == images.data_ptr() and got_targets.data_ptr() == targets.data_ptr()


def test_cached_training_loss_identical(tmp_path):
    """Two shuffled steps through the Trainer (augment on): the same losses
    and parameters from cached batches as from streamed ones, bit for bit."""
    rec = _write_records(tmp_path / "rec", 4, IMSIZE, seed=8)
    results = []
    for cached in (False, True):
        loader = DataLoader(RecordDataset(rec), batch_size=2, shuffle=True, seed=2, max_gt=8,
                            device_cache=cached, device="cpu")
        trainer = Trainer(SSD(num_classes=21, seed=0), default_boxes=default_boxes(feature_grids_for(IMSIZE)),
                          augment=True, seed=4, device="cpu")
        state = trainer.init_state(lambda ps: adam_torch(ps, 1e-3, weight_decay=5e-4))
        losses = [trainer.train_step(state, images, gts) for images, gts in loader]
        results.append((torch.stack(losses), {k: v.clone() for k, v in state.trainable.items()}))
    (la, pa), (lb, pb) = results
    assert len(la) == 2 and torch.equal(la, lb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_cli_device_cache_equals_streaming(tmp_path):
    """`cli.train --device_cache` on records: the epoch's losses and the
    weights file equal the streaming run's; without --records_dir it is
    refused, as under --distributed."""
    rec = _write_records(tmp_path / "rec", 4, IMSIZE, seed=9)
    base = ["--records_dir", str(rec), "--imsize", str(IMSIZE), "--batch_size", "2", "--dtype", "float32",
            "--device", "cpu", "--epochs", "1", "--max_gt", "8"]
    runs = {}
    for name, flags in (("stream", []), ("cached", ["--device_cache"])):
        runs[name] = train.main(base + flags + ["--result_dir", str(tmp_path / name), "--log_dir",
                                                str(tmp_path / name / "logs")])
    assert torch.equal(runs["stream"]["losses"][0], runs["cached"]["losses"][0])
    assert ((tmp_path / "stream" / "detection" / "weights.msgpack").read_bytes()
            == (tmp_path / "cached" / "detection" / "weights.msgpack").read_bytes())
    fixture = ["--data_dirs", str(FIXTURE), "--imsize", str(IMSIZE), "--device", "cpu", "--device_cache"]
    with pytest.raises(SystemExit, match="records_dir"):
        train.main(fixture + ["--result_dir", str(tmp_path / "r1")])
    with pytest.raises(SystemExit, match="distributed"):
        train.main(base + ["--device_cache", "--distributed", "--result_dir", str(tmp_path / "r2")])

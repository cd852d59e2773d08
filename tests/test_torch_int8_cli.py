"""The int8 flags of the port's CLIs on the CPU (the plain int8 conv), at
imsize 264 over a few seeded records: `cli.train --trunk_int8` writes
quant.json with the JAX package's layer set and recalibrates a stale one,
`--full_int8` writes quant_full.json and a second run loads it, a missing
quant.json stops the serving CLIs with the JAX package's text, and
`--export_pipeline --trunk_int8` exports the int8 model. The calibration
batches are read by index, the images the JAX package's unshuffled loader
yields first."""

import io
import json
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.cli import common as jax_common
from object_detection_torch2_tpu.data.loader import DataLoader as JaxDataLoader
from object_detection_torch2_tpu.data.voc import PascalVOCDataset as JaxVOC
from object_detection_torch2_tpu_torch.cli import common, evaluate, inference, train
from object_detection_torch2_tpu_torch.data.records import RecordDataset
from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
from object_detection_torch2_tpu_torch.infer import build_detection_pipeline
from object_detection_torch2_tpu_torch.models import quant
from object_detection_torch2_tpu_torch.models import ssd as ssd_mod
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.serving import load_detection_pipeline

torch.set_num_threads(1)

IMSIZE = 264
FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"


def _write_records(out_dir: Path, n: int, seed: int) -> Path:
    """n seeded records (uint8 images, one GT box each) in data/records.py's layout."""
    rng = np.random.default_rng(seed)
    out_dir.mkdir(parents=True)
    gts = np.zeros((n, 4, 25), np.float32)
    gts[:, 0, :4] = [0.5, 0.5, 0.3, 0.4]
    gts[np.arange(n), 0, 4 + rng.integers(1, 21, n)] = 1.0
    np.save(out_dir / "images.npy", rng.integers(0, 256, (n, IMSIZE, IMSIZE, 3), dtype=np.uint8))
    np.save(out_dir / "gts.npy", gts)
    (out_dir / "meta.json").write_text(json.dumps({"imsize": IMSIZE, "max_gt": 4, "count": n,
                                                   "purpose": "detection"}))
    return out_dir


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return _write_records(tmp_path_factory.mktemp("int8_records") / "rec", 2, 17)


def _serve_args(records: Path, result: Path, *flags) -> list:
    return ["--records_dir", str(records), "--imsize", str(IMSIZE), "--batch_size", "2", "--dtype", "float32",
            "--num_workers", "0", "--device", "cpu", "--result_dir", str(result), *flags]


class _CountInt8:
    """Counts the model's int8 convolutions (the plain version on the CPU)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = ssd_mod.int8_conv

        def counted(*args):
            self.calls += 1
            return real(*args)

        monkeypatch.setattr(ssd_mod, "int8_conv", counted)


def test_train_cli_trunk_int8_writes_quant_json(tmp_path, records, monkeypatch):
    """One step over 2 records: quant.json with the 12 keys of the JAX
    package's QUANT_LAYERS (calibrated from the first batch by index, with
    the train augment), 11 int8 convs in the step's forward, the frozen
    trunk written back unchanged, a finite loss."""
    counter = _CountInt8(monkeypatch)
    out = train.main(["--records_dir", str(records), "--imsize", str(IMSIZE), "--batch_size", "2", "--dtype",
                      "float32", "--num_workers", "0", "--device", "cpu", "--result_dir", str(tmp_path / "r"),
                      "--log_dir", str(tmp_path / "logs"), "--trunk_int8", "--calib_batches", "3"])
    qd = json.loads((tmp_path / "r" / "detection" / "quant.json").read_text())
    assert set(qd) == {f"amax_{layer}" for layer in quant.QUANT_LAYERS} and all(v > 0 for v in qd.values())
    assert quant.missing_layers(qd) == []
    assert counter.calls == 11
    assert torch.isfinite(out["losses"][0]).all()
    model = out["state"].model
    assert model.trunk_int8 and model.quant_reciprocal
    seeded = SSD(num_classes=21, seed=0)
    assert torch.equal(model.features["conv_4_2"].weight, seeded.features["conv_4_2"].weight)


def test_train_cli_recalibrates_a_stale_quant_json(tmp_path, records):
    """A quant.json without amax_1_2 (stale) is recalibrated in place: the
    same scales as a fresh calibration, 12 keys; a complete one is loaded as
    it is."""
    args = train.parse_args(["--records_dir", str(records), "--imsize", str(IMSIZE), "--batch_size", "2",
                             "--result_dir", str(tmp_path / "r"), "--device", "cpu", "--dtype", "float32"])
    ds = RecordDataset(records)
    fresh = train._quant_scales(args, SSD(num_classes=21, seed=0), ds, torch.device("cpu"))
    qp = tmp_path / "r" / "detection" / "quant.json"
    stale = {k: v for k, v in fresh.items() if k != "amax_1_2"}
    quant.save_quant(qp, stale)
    again = train._quant_scales(args, SSD(num_classes=21, seed=0), ds, torch.device("cpu"))
    assert again == fresh and json.loads(qp.read_text()) == fresh
    complete = {k: 2.0 for k in fresh}
    quant.save_quant(qp, complete)
    assert train._quant_scales(args, SSD(num_classes=21, seed=0), ds, torch.device("cpu")) == complete


@pytest.mark.parametrize("cli", ["evaluate", "inference"])
def test_serving_trunk_int8_needs_quant_json(tmp_path, records, cli):
    """Without <result_dir>/detection/quant.json the serving CLIs stop with
    the JAX package's text."""
    with pytest.raises(SystemExit) as want:
        jax_common.apply_trunk_int8(SimpleNamespace(result_dir=str(tmp_path)), None, {})
    main = evaluate.main if cli == "evaluate" else inference.main
    with pytest.raises(SystemExit) as got:
        main(_serve_args(records, tmp_path, "--trunk_int8"))
    assert str(got.value) == str(want.value)


def test_evaluate_full_int8_writes_then_loads_quant_full(tmp_path, records, capsys):
    """The first --full_int8 run calibrates over the run's own first batches
    and writes quant_full.json (the 28 keys); a second run loads it (the file
    unchanged) and gives the same APs."""
    first = evaluate.main(_serve_args(records, tmp_path, "--full_int8"))
    qp = tmp_path / "detection" / "quant_full.json"
    data = qp.read_bytes()
    qd = json.loads(data)
    assert set(qd) == {f"amax_{layer}" for layer in quant.FULL_QUANT_LAYERS}
    model = SSD(num_classes=21, seed=0)
    want = quant.calibrate_full(model, common.calib_image_batches(RecordDataset(records), 8, 2), margin=1.25)
    assert qd == want
    assert "full-int8 scales loaded." not in capsys.readouterr().out
    second = evaluate.main(_serve_args(records, tmp_path, "--full_int8"))
    assert "full-int8 scales loaded." in capsys.readouterr().out
    assert qp.read_bytes() == data
    np.testing.assert_array_equal(second[0], first[0])
    assert second[1] == first[1]


def test_full_int8_takes_precedence(tmp_path, records, monkeypatch):
    """--full_int8 with --trunk_int8: the full path, as in the JAX package;
    27 int8 convs in the one forward."""
    counter = _CountInt8(monkeypatch)
    (tmp_path / "detection").mkdir(parents=True)
    quant.save_quant(tmp_path / "detection" / "quant_full.json",
                     {f"amax_{layer}": 3.0 for layer in quant.FULL_QUANT_LAYERS})
    evaluate.main(_serve_args(records, tmp_path, "--full_int8", "--trunk_int8"))
    assert counter.calls == 27


def test_calib_image_batches_are_the_first_images_in_order():
    """The first n x batch_size images by index, the last batch short: the
    images the JAX package's unshuffled DataLoader yields first."""
    port = list(common.calib_image_batches(PascalVOCDataset("detection", [FIXTURE], "test.txt", IMSIZE), 8, 3))
    loader = JaxDataLoader(JaxVOC("detection", [FIXTURE], "test.txt", IMSIZE), 3, max_gt=64, drop_last=False,
                           num_workers=0)
    want = list(jax_common.calib_image_batches(loader, 8))
    assert [b.shape for b in port] == [b.shape for b in want] == [(3, IMSIZE, IMSIZE, 3), (1, IMSIZE, IMSIZE, 3)]
    for a, b in zip(port, want):
        np.testing.assert_array_equal(a, b)


def test_export_pipeline_trunk_int8(tmp_path, records):
    """--export_pipeline with --trunk_int8: the exported program holds the
    11 int8 convolutions as calls of torch.ops.odt.int8_conv, reloads with
    only ops/registry.py, and gives the live int8 pipeline's rows."""
    scales = {f"amax_{layer}": float(v) for layer, v in
              zip(quant.QUANT_LAYERS, np.random.default_rng(3).uniform(1.0, 6.0, len(quant.QUANT_LAYERS)))}
    (tmp_path / "detection").mkdir(parents=True)
    quant.save_quant(tmp_path / "detection" / "quant.json", scales)
    path = tmp_path / "int8.pt2"
    meta = inference.main(_serve_args(records, tmp_path, "--trunk_int8", "--export_pipeline", str(path),
                                      "--export_platforms", "cpu"))["export"]
    assert meta["platforms"] == ["cpu"]
    exported = torch.export.load(io.BytesIO(zipfile.ZipFile(path).read("cpu.pt2")))
    calls = [n for n in exported.graph.nodes if n.op == "call_function" and "int8_conv" in str(n.target)]
    assert len(calls) == 11
    run, _ = load_detection_pipeline(path, device="cpu")
    images = np.asarray(RecordDataset(records).images)
    packed, n_valid = run(images, 2)
    model = SSD(num_classes=21, seed=0, trunk_int8=True)
    model.set_quant(scales)
    live_packed, live_valid = build_detection_pipeline(model, True, IMSIZE, device="cpu")(images, 2)
    assert torch.equal(packed, live_packed) and torch.equal(n_valid, live_valid)

"""The port's inference slice on the CPU: utils/render.py against the JAX
package's drawing, and `cli.inference.main --device cpu` on the fixture tree
and on packed records against the port's own pipeline and render. The
CLI tests, port against port at full width, are marked `slow`: chip_smoke.py's
`phase_moved_serving` holds each at its pins on the card (`python -m pytest -m
slow tests/test_torch_inference.py` runs them here)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from object_detection_torch2_tpu.data.labelmap import LabelMap as JaxLabelMap
from object_detection_torch2_tpu.utils import render as jax_render
from object_detection_torch2_tpu_torch.cli import inference
from object_detection_torch2_tpu_torch.data.labelmap import LabelMap
from object_detection_torch2_tpu_torch.data.records import RecordDataset, pack_voc
from object_detection_torch2_tpu_torch.infer import build_detection_pipeline, unpack_detections
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.utils import render

torch.set_num_threads(1)

IMSIZE = 264
BATCH = 3  # the fixture's 4 images: a full batch and a ragged one
FIXTURE = Path(__file__).parent / "fixtures" / "voc" / "VOCtest"
CLI_ARGS = ["--imsize", str(IMSIZE), "--batch_size", str(BATCH), "--dtype", "float32", "--device", "cpu",
            "--num_workers", "0"]


def _detections(seed, k=40):
    """Seeded compact detections: void rows, boxes across and entirely
    outside the image, every class."""
    rng = np.random.default_rng(seed)
    locs = np.concatenate([rng.uniform(0.0, 1.0, (k, 2)), rng.uniform(0.02, 0.6, (k, 2))], -1).astype(np.float32)
    locs[:4, 0] = (-0.5, 1.6, 0.5, -0.3)  # left of, right of, inside, and straddling the left edge
    locs[4:6, 1] = (-0.7, 1.8)  # above and below
    class_ids = rng.integers(0, 21, k).astype(np.int32)
    class_ids[6:10] = 0
    scores = rng.uniform(0.05, 1.0, k).astype(np.float32)
    return locs, class_ids, scores


def test_hls_palette_equals_jax():
    for n in (1, 2, 21, 33):
        assert render.hls_palette(n) == jax_render.hls_palette(n)


@pytest.mark.parametrize("seed", range(4))
def test_render_compact_pixel_equal_to_jax(seed):
    image = np.random.default_rng(seed).integers(0, 256, (IMSIZE, IMSIZE, 3), dtype=np.uint8)
    dets = _detections(seed)
    got = render.render_detections_compact(image, *dets, LabelMap("PascalVOC"), IMSIZE)
    want = jax_render.render_detections_compact(image, *dets, JaxLabelMap("PascalVOC"), IMSIZE)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(got), image)


def test_render_from_scores_pixel_equal_to_jax():
    rng = np.random.default_rng(9)
    image = rng.uniform(0, 1, (IMSIZE, IMSIZE, 3)).astype(np.float32)
    locs, class_ids, scores = _detections(9, k=12)
    confs = np.zeros((12, 21), np.float32)
    confs[np.arange(12), class_ids] = scores
    got = render.render_detections(image, locs, confs, LabelMap("PascalVOC"), IMSIZE)
    want = jax_render.render_detections(image, locs, confs, JaxLabelMap("PascalVOC"), IMSIZE)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_save_detections_names_by_index(tmp_path):
    img = Image.fromarray(np.zeros((4, 4, 3), np.uint8))
    assert render.save_detections(tmp_path / "d", 7, img) == tmp_path / "d" / "000007.png"
    assert jax_render.save_detections(tmp_path / "j", 7, img).name == "000007.png"


def _expected_pngs(images_u8, d2h_half=False, model=None):
    """The port's pipeline and render of the CLI's batches (by default the
    seeded SSD build_ssd makes without a weights file; batch statistics,
    padding as the CLI pads)."""
    model = SSD(num_classes=21, seed=0) if model is None else model
    run = build_detection_pipeline(model, True, IMSIZE, device="cpu", d2h_half=d2h_half)
    labelmap = LabelMap("PascalVOC")
    out = []
    for start in range(0, len(images_u8), BATCH):
        chunk = images_u8[start:start + BATCH]
        padded = np.concatenate([chunk, np.repeat(chunk[-1:], BATCH - len(chunk), 0)])
        packed, _ = run(padded, len(chunk))
        boxes, classes, scores = unpack_detections(packed.numpy())
        out += [np.asarray(render.render_detections_compact(chunk[i], boxes[i], classes[i], scores[i], labelmap,
                                                            IMSIZE)) for i in range(len(chunk))]
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The fixture's test list packed by the port's pack_voc: its directory."""
    out = tmp_path_factory.mktemp("rec")
    pack_voc([FIXTURE], "test.txt", out, imsize=IMSIZE, max_gt=64, log_every=0)
    return out


@pytest.fixture(scope="module")
def plain_pngs(records):
    """`_expected_pngs` of the fixture's images with the default model and
    float32 rows, which three tests expect: computed once."""
    return _expected_pngs(np.asarray(RecordDataset(records).images))


@pytest.mark.slow
@pytest.mark.parametrize("source", ["voc", "records"])
def test_cli_main_renders_the_pipeline_detections(tmp_path, records, plain_pngs, source):
    """One PNG per image, numbered 1..4 across the two batches, each equal to
    the port's render of its pipeline's detections for that image."""
    flag = ["--data_dirs", str(FIXTURE)] if source == "voc" else ["--records_dir", str(records)]
    out = inference.main(CLI_ARGS + flag + ["--result_dir", str(tmp_path)])
    names = sorted(p.name for p in (tmp_path / "detection").glob("*.png"))
    assert names == [f"{i:06}.png" for i in range(1, 5)]
    assert [p.name for p in out["paths"]] == names and len(out["batch_s"]) == len(out["render_s"]) == 2
    for path, w in zip(out["paths"], plain_pngs):
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), w)


@pytest.mark.slow
@pytest.mark.parametrize("flags", [["--batches_per_dispatch", "2"], ["--batches_per_dispatch", "3", "--d2h_half"]])
def test_cli_flags_render_the_same_pngs(tmp_path, records, plain_pngs, flags):
    """K batches a call: the plain run's PNGs; float16 rows: the render of the
    float16-rounded rows, pixel for pixel, numbered as before."""
    out = inference.main(CLI_ARGS + ["--records_dir", str(records), "--result_dir", str(tmp_path)] + flags)
    names = [p.name for p in out["paths"]]
    assert names == [f"{i:06}.png" for i in range(1, 5)]
    if "--d2h_half" in flags:
        want = _expected_pngs(np.asarray(RecordDataset(records).images), d2h_half=True)
    else:
        want = plain_pngs
    for path, w in zip(out["paths"], want):
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), w)


def test_cli_needs_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="pillow"):
        inference.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path)])


def _export(tmp_path, *flags):
    """`cli.inference --export_pipeline <tmp_path>/x.bin --export_platforms
    cpu` with `flags` (the metadata it returns is the artifact's): the
    reloaded artifact's outputs on one seeded ragged batch, 2 real rows of
    3."""
    from object_detection_torch2_tpu_torch.serving import load_detection_pipeline

    path = tmp_path / "x.bin"
    out = inference.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path),
                                     "--export_pipeline", str(path), "--export_platforms", "cpu", *flags])
    run, meta = load_detection_pipeline(path, device="cpu")
    assert out["export"] == meta and meta["batch_size"] == BATCH
    assert not (tmp_path / "detection").exists()
    images = np.random.default_rng(3).integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    return run(images, 2)


@pytest.fixture(scope="module")
def one_process_export(tmp_path_factory):
    return _export(tmp_path_factory.mktemp("export_one"))


@pytest.mark.slow
@pytest.mark.parametrize("flags,item", [(["--distributed"], "G"), (["--num_devices", "2"], "G")])
def test_cli_unported_flags_raise(tmp_path, flags, item, monkeypatch, one_process_export):
    """The flags of ROADMAP Queue 1 item G (data parallelism), ported:
    --distributed without torchrun's environment raises; --export_pipeline
    with --num_devices 2 writes the one single-device artifact the JAX CLI
    writes, from this process (nothing is launched), and its reloaded
    outputs equal the one-process artifact's
    (tests/test_torch_parallel_cli.py runs the inference on 2
    processes)."""
    from object_detection_torch2_tpu_torch.cli import common

    if flags == ["--distributed"]:
        with pytest.raises(RuntimeError, match="torchrun"):
            inference.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path)] + flags)
        assert not (tmp_path / "detection").exists()
    else:
        monkeypatch.setattr(common, "launch", lambda *a, **k: pytest.fail("--export_pipeline launched ranks"))
        for got, want in zip(_export(tmp_path, *flags), one_process_export):
            assert torch.equal(got, want)
    assert item == "G"


@pytest.mark.slow
def test_cli_export_under_a_distributed_world_of_one(tmp_path, monkeypatch, one_process_export):
    """--export_pipeline --distributed under torchrun's environment for a
    world of one (gloo on the CPU): rank 0 writes the artifact, whose
    reloaded outputs equal the one-process artifact's, and the process group
    is left. The JAX CLI's --distributed checks hold before the export."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"), ("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(port))):
        monkeypatch.setenv(var, value)
    for got, want in zip(_export(tmp_path, "--distributed"), one_process_export):
        assert torch.equal(got, want)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--num_devices 2 unsupported with --distributed"):
        _export(tmp_path / "x", "--distributed", "--num_devices", "2")
    assert not dist.is_initialized() and not (tmp_path / "x").exists()


@pytest.mark.slow
@pytest.mark.parametrize("flag", ["--trunk_int8", "--full_int8"])
def test_cli_int8_flags_render_the_int8_model(tmp_path, records, flag):
    """--trunk_int8 (scales from quant.json) and --full_int8 (calibrated
    over the run's first batches, written to quant_full.json): each PNG
    pixel-equal to the render of the seeded SSD on that int8 path with those
    scales."""
    from object_detection_torch2_tpu_torch.models import quant

    name = "quant.json" if flag == "--trunk_int8" else "quant_full.json"
    if flag == "--trunk_int8":
        (tmp_path / "detection").mkdir(parents=True)
        quant.save_quant(tmp_path / "detection" / name,
                         {f"amax_{layer}": float(v) for layer, v in
                          zip(quant.QUANT_LAYERS, np.linspace(2.0, 6.0, len(quant.QUANT_LAYERS)))})
    out = inference.main(CLI_ARGS + ["--records_dir", str(records), "--result_dir", str(tmp_path), flag])
    model = SSD(num_classes=21, seed=0, trunk_int8=flag == "--trunk_int8", full_int8=flag == "--full_int8")
    model.set_quant(quant.load_quant(tmp_path / "detection" / name))
    want = _expected_pngs(np.asarray(RecordDataset(records).images), model=model)
    assert len(out["paths"]) == len(want) == 4
    for path, w in zip(out["paths"], want):
        np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), w)


def test_cli_without_device_needs_a_card(tmp_path):
    """No --device: the CLI runs on the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is available")
    args = [a for a in CLI_ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(args + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp_path)])
    assert not (tmp_path / "detection").exists()


def test_records_and_voc_give_the_same_images(records):
    """The CLI's two sources hold the same pixels (so one expectation serves
    both)."""
    from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset

    ds = PascalVOCDataset("detection", [FIXTURE], "test.txt", IMSIZE)
    packed = RecordDataset(records)
    assert len(packed) == len(ds) == 4
    for i in range(len(ds)):
        np.testing.assert_array_equal(np.asarray(ds[i][0]), packed.images[i])

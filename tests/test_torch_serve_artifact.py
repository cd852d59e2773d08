"""The port's `tools/serve_artifact.py` on the CPU, against `cli.inference`
and the repo's root tools/serve_artifact.py:

- an artifact that `cli.inference --export_pipeline --export_platforms cpu`
  writes at batch 3 (the fixture's 4 test images: a full batch and a ragged
  one), served with `--device cpu` from the VOC tree, and from packed
  records with `--limit` in a fresh interpreter that imports no module of
  the port's models (or `infer`): every PNG byte-equal to
  `cli.inference --device cpu`'s of the same image from the same weights;
- the root tool's `main`, its `load_detection_pipeline` replaced by one that
  returns the port artifact's packed rows: its detections.json and PNGs
  byte-equal to the port tool's;
- the argv against the root tool's `parse_args`;
- an artifact without a CPU program raises under `--device cpu`, and no
  `--device` without a card raises.
"""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch.cli import inference
from object_detection_torch2_tpu_torch.data.records import pack_voc
from object_detection_torch2_tpu_torch.serving import load_detection_pipeline
from object_detection_torch2_tpu_torch.tools import serve_artifact

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
IMSIZE = 264  # the smallest valid SSD pyramid
BATCH = 3
FIXTURE = ROOT / "tests" / "fixtures" / "voc" / "VOCtest"
CLI_ARGS = ["--imsize", str(IMSIZE), "--batch_size", str(BATCH), "--dtype", "float32", "--device", "cpu",
            "--num_workers", "0"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The seeded SSD's artifact, cli.inference's PNGs of the fixture, the
    port tool's outputs from the VOC tree, and each batch it served: (the
    padded images, the packed rows, the real count)."""
    tmp = tmp_path_factory.mktemp("serve")
    artifact = tmp / "pipe.bin"
    inference.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp / "r"), "--export_pipeline",
                               str(artifact), "--export_platforms", "cpu"])
    inference.main(CLI_ARGS + ["--data_dirs", str(FIXTURE), "--result_dir", str(tmp / "r")])
    batches = []

    def recording_load(path, device=None):
        run, meta = load_detection_pipeline(path, device)

        def recording_run(images, n_real):
            packed, n_valid = run(images, n_real)
            batches.append((np.array(images), packed.numpy().copy(), int(n_real)))
            return packed, n_valid
        return recording_run, meta

    saved = serve_artifact.load_detection_pipeline
    serve_artifact.load_detection_pipeline = recording_load
    try:
        voc = serve_artifact.main(["--artifact", str(artifact), "--data_dirs", str(FIXTURE), "--out_dir",
                                   str(tmp / "voc"), "--device", "cpu"])
    finally:
        serve_artifact.load_detection_pipeline = saved
    return {"tmp": tmp, "artifact": artifact, "voc": voc, "batches": batches}


def _pngs(directory: Path) -> list:
    return sorted(directory.glob("*.png"))


def test_served_pngs_equal_the_inference_cli(served):
    """Image k's PNG (numbered from 0) is byte-equal to cli.inference's PNG
    k + 1 (numbered from 1), the ragged batch's included; the short batch
    went in padded to the artifact's 3 rows with its real count."""
    tmp = served["tmp"]
    want = _pngs(tmp / "r" / "detection")
    got = _pngs(tmp / "voc")
    assert [p.name for p in got] == [f"{k:06}.png" for k in range(4)] and len(want) == 4
    assert served["voc"]["images"] == 4 and served["voc"]["paths"] == got
    for k, path in enumerate(got):
        assert path.read_bytes() == want[k].read_bytes(), path.name
    assert [(b[0].shape[0], b[2]) for b in served["batches"]] == [(3, 3), (3, 1)]
    rows = json.loads((tmp / "voc" / "detections.json").read_text())
    assert len(rows) == served["voc"]["detections"] and {r[0] for r in rows} == {0, 1, 2, 3}


def test_root_tool_writes_the_same_files(served, tmp_path, monkeypatch):
    """The root tool, its load_detection_pipeline returning the packed rows
    the port tool's artifact gave for the same padded batches, writes
    detections.json and PNGs byte-equal to the port tool's."""
    import object_detection_torch2_tpu.serving as jax_serving
    import tools.serve_artifact as root_tool

    meta = json.loads(Path(str(served["artifact"]) + ".json").read_text())
    batches = list(served["batches"])

    def run(images, n_real):
        want_images, packed, want_real = batches.pop(0)
        assert np.array_equal(np.asarray(images), want_images) and int(n_real) == want_real
        return packed, None

    monkeypatch.setattr(jax_serving, "load_detection_pipeline", lambda path: (run, meta))
    root_tool.main(["--artifact", str(served["artifact"]), "--data_dirs", str(FIXTURE), "--out_dir",
                    str(tmp_path / "root")])
    assert batches == []
    port = served["tmp"] / "voc"
    want = (tmp_path / "root" / "detections.json").read_bytes()
    assert (port / "detections.json").read_bytes() == want and len(json.loads(want)) > 0
    assert [p.name for p in _pngs(tmp_path / "root")] == [p.name for p in _pngs(port)]
    for path in _pngs(port):
        assert path.read_bytes() == (tmp_path / "root" / path.name).read_bytes(), path.name


@pytest.mark.parametrize("argv", [
    ["--artifact", "a.bin"],
    ["--artifact", "a.bin", "--data_dirs", "x", "y", "--out_dir", "o", "--limit", "5"],
    ["--artifact", "a.bin", "--records_dir", "r"],
])
def test_argv_equals_the_root_tool(argv):
    import tools.serve_artifact as root_tool

    want = vars(root_tool.parse_args(argv))
    got = vars(serve_artifact.parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu" and got == want
    assert vars(serve_artifact.parse_args(argv))["device"] is None


def test_serving_from_records_imports_no_model_code(served, tmp_path):
    """A fresh interpreter serves the artifact from the fixture's packed
    records (`--limit 2`) with the tool and the op registrations alone: no
    module of the port's models, nor `infer`, is imported; its PNGs are
    cli.inference's of the same images (the records hold the VOC tree's
    decoded images) and its rows the in-process run's of images 0-1."""
    pack_voc([str(FIXTURE)], "test.txt", tmp_path / "records", imsize=IMSIZE, log_every=0)
    code = (
        "import sys, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from object_detection_torch2_tpu_torch.tools import serve_artifact\n"
        f"out = serve_artifact.main(['--artifact', {str(served['artifact'])!r}, '--records_dir',\n"
        f"                           {str(tmp_path / 'records')!r}, '--out_dir', {str(tmp_path / 'sub')!r},\n"
        "                           '--limit', '2', '--device', 'cpu'])\n"
        "loaded = sorted(m for m in sys.modules if m.startswith('object_detection_torch2_tpu_torch'))\n"
        "print(out['images'], loaded)\n"
        "sys.exit(any(m.startswith('object_detection_torch2_tpu_torch.models') or m.endswith('.infer')\n"
        "             for m in loaded))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "2 [" in proc.stdout and "object_detection_torch2_tpu_torch.ops.registry" in proc.stdout
    got = _pngs(tmp_path / "sub")
    want = _pngs(served["tmp"] / "r" / "detection")
    assert [p.name for p in got] == ["000000.png", "000001.png"]
    for k, path in enumerate(got):
        assert path.read_bytes() == want[k].read_bytes(), path.name
    rows = json.loads((tmp_path / "sub" / "detections.json").read_text())
    voc_rows = json.loads((served["tmp"] / "voc" / "detections.json").read_text())
    assert rows == [r for r in voc_rows if r[0] < 2] and rows


def test_an_artifact_for_another_platform_raises(served, tmp_path):
    """An artifact that holds only a cuda program is refused under --device
    cpu (never run elsewhere); without --device the card is required."""
    cuda_only = tmp_path / "cuda_only.bin"
    with zipfile.ZipFile(served["artifact"]) as src, zipfile.ZipFile(cuda_only, "w") as dst:
        dst.writestr("cuda.pt2", src.read("cpu.pt2"))
    argv = ["--artifact", str(cuda_only), "--data_dirs", str(FIXTURE), "--out_dir", str(tmp_path / "o")]
    with pytest.raises(ValueError, match=r"\['cuda'\], not cpu"):
        serve_artifact.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "o").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_artifact.main(["--artifact", str(served["artifact"]), "--data_dirs", str(FIXTURE),
                                 "--out_dir", str(tmp_path / "o")])
        assert not (tmp_path / "o").exists()


def test_pad_batch_and_unpack_live_beside_the_loader():
    """The host helpers keep their old homes' names: cli.common.pad_batch and
    infer.unpack_detections are serving's."""
    from object_detection_torch2_tpu_torch import infer, serving
    from object_detection_torch2_tpu_torch.cli import common

    assert common.pad_batch is serving.pad_batch and infer.unpack_detections is serving.unpack_detections
    images = np.arange(2 * 2 * 2 * 3, dtype=np.uint8).reshape(2, 2, 2, 3)
    padded, real = serving.pad_batch(images, 3)
    assert real == 2 and padded.shape == (3, 2, 2, 3) and np.array_equal(padded[2], images[1])

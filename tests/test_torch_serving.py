"""The port's serving plumbing on the CPU: `utils.hostsync.FetchPipeline`,
the kernels as `torch.library` custom ops (ops/registry.py), and the exported
pipeline (serving.py): reload parity with the live pipeline, the ragged mask,
float16 rows, the metadata, the NMS tiers as `torch.cond`, a load that imports
no model code, and the inference CLI's `--export_pipeline`. The export tests,
port against port at full width, are marked `slow`: chip_smoke.py's
`phase_moved_serving` holds each at its pins on the card (`python -m pytest -m
slow tests/test_torch_serving.py` runs them here)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.library import opcheck

from object_detection_torch2_tpu_torch.cli import inference
from object_detection_torch2_tpu_torch.infer import build_detection_pipeline, unpack_detections
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.ops import conv12_cuda, nms, nms_cuda, registry
from object_detection_torch2_tpu_torch.ops.conv12 import conv12_plain
from object_detection_torch2_tpu_torch.serving import export_detection_pipeline, load_detection_pipeline
from object_detection_torch2_tpu_torch.utils.hostsync import FetchPipeline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
IMSIZE = 264  # the smallest valid SSD pyramid
BATCH = 2


# ------------------------------------------------------------ FetchPipeline


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_fetch_pipeline_order_depth_and_flush(depth):
    """Item i comes back from push i + depth, in order; flush yields the rest;
    leaves of every kind and the tree's structure pass through."""
    pipe = FetchPipeline(depth)
    got = []
    for i in range(6):
        item = ({"x": torch.full((2,), float(i))}, [i, None], "tag")
        out = pipe.push(item)
        if i < depth:
            assert out is None
        else:
            got.append(out)
            assert out[0]["x"][0] == i - depth and out[1] == [i - depth, None] and out[2] == "tag"
    tail = list(pipe.flush())
    assert [t[1][0] for t in got + tail] == list(range(6)) and len(tail) == min(depth, 6)
    assert list(pipe.flush()) == []


def test_fetch_pipeline_passes_cpu_tensors_as_they_are():
    t = torch.arange(4)
    pipe = FetchPipeline(0)
    assert pipe.push((t,))[0] is t
    with pytest.raises(ValueError, match="depth"):
        FetchPipeline(-1)


# ------------------------------------------------------------ custom ops


def _sorted_case(seed, n=3, p=300):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, p, 2)), rng.uniform(0.05, 0.3, (n, p, 2))], -1)
    valid = rng.uniform(size=(n, p)) < 0.6
    return torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(valid)


def test_nms_op_on_the_cpu_is_the_plain_sweep():
    """torch.ops.odt.nms_keep_sorted on CPU tensors: the plain sweep, no
    kernel launch; the op passes torch.library's registration checks."""
    sb, sv = _sorted_case(1)
    before = nms_cuda.launches
    got = torch.ops.odt.nms_keep_sorted(sb, sv, 0.5)
    assert torch.equal(got, nms._blocked_keep_sorted(sb, sv, 0.5))
    assert torch.equal(nms_cuda.keep_sorted(sb, sv, 0.5), got)
    assert nms_cuda.launches == before
    opcheck(registry.nms_keep_sorted, (sb, sv, 0.5))
    with pytest.raises(ValueError, match="device"):
        nms_cuda.keep_sorted(sb.to("meta"), sv.to("meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv12_op_on_the_cpu_is_the_plain_version(dtype):
    """torch.ops.odt.conv12 on CPU tensors: conv12_plain's output, and its
    registered gradient is autograd's of conv12_plain, bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 6, 7, 64), dtype=np.float32)).permute(0, 3, 1, 2).to(dtype)
    w = torch.from_numpy(rng.standard_normal((64, 64, 3, 3), dtype=np.float32) * 0.05).to(dtype)
    b = torch.from_numpy(rng.standard_normal(64, dtype=np.float32))
    before = conv12_cuda.launches
    assert torch.equal(torch.ops.odt.conv12(x, w, b, None), conv12_plain(x, w, b))
    grads = []
    for fn in (lambda *a: registry.conv12(*a, None), conv12_plain):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        (fn(xs, ws, bs).float() ** 2).sum().backward()
        grads.append((xs.grad, ws.grad, bs.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert conv12_cuda.launches == before
    if dtype == torch.float32:
        opcheck(registry.conv12, (x.requires_grad_(True), w.requires_grad_(True), b, None))


# ------------------------------------------------------------ export


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The seeded SSD's pipeline (batch statistics) exported for the CPU,
    its live twin and seeded images."""
    model = SSD(num_classes=21, seed=0, conv12_kernel=True)
    path = tmp_path_factory.mktemp("art") / "pipeline.bin"
    meta = export_detection_pipeline(model, path, batch_size=BATCH, use_batch_stats=True, imsize=IMSIZE,
                                     max_detections=50, platforms=("cpu",))
    live = build_detection_pipeline(model, True, IMSIZE, max_detections=50, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    return path, meta, live, images


@pytest.mark.slow
@pytest.mark.parametrize("n_real", [2, 1])
def test_reload_matches_the_live_pipeline(exported, n_real):
    """The reloaded program's packed rows and n_valid equal the live
    pipeline's, bit for bit, with a ragged batch's pad row masked."""
    path, _, live, images = exported
    run, meta = load_detection_pipeline(path, device="cpu")
    packed, n_valid = run(images, n_real)
    want_packed, want_valid = live(images, n_real)
    assert packed.dtype == torch.float32 and packed.shape == (BATCH, 50, 6)
    assert torch.equal(packed, want_packed) and torch.equal(n_valid, want_valid)
    if n_real == 1:
        _, classes, scores = unpack_detections(packed.numpy())
        assert (scores[1] == 0).all() and (classes[1] == 0).all() and int(n_valid[1]) == 0


@pytest.mark.slow
def test_metadata_and_graph(exported):
    """The calling contract in <path>.json; the program holds both kernels as
    custom ops and the NMS tiers as torch.cond; a platform the artifact does
    not hold raises."""
    import io
    import zipfile

    path, meta, _, _ = exported
    on_disk = json.loads(Path(str(path) + ".json").read_text())
    assert on_disk == meta
    assert meta["platforms"] == ["cpu"] and meta["batch_size"] == BATCH and meta["imsize"] == IMSIZE
    assert meta["outputs"]["packed"] == [BATCH, 50, 6] and meta["bytes"] == path.stat().st_size
    assert meta["use_batch_stats"] is True and meta["d2h_half"] is False
    with zipfile.ZipFile(path) as zf:
        assert zf.namelist() == ["cpu.pt2"]
        program = torch.export.load(io.BytesIO(zf.read("cpu.pt2")))
    targets = [str(n.target) for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count("odt.conv12.default") == 1
    assert targets.count("odt.nms_keep_sorted.default") == 3  # tiers 128, 1024 and the full sweep
    assert targets.count("cond") == 2
    with pytest.raises(ValueError, match="cpu"):
        load_detection_pipeline(path, device="meta")


@pytest.mark.slow
def test_d2h_half_export_matches_the_live_pipeline(tmp_path, exported):
    """float16 rows: the exported program equals the live d2h_half pipeline
    and is the float32 rows rounded to nearest even."""
    _, _, live, images = exported
    model = SSD(num_classes=21, seed=0)
    meta = export_detection_pipeline(model, tmp_path / "half.bin", batch_size=BATCH, use_batch_stats=True,
                                     imsize=IMSIZE, max_detections=50, platforms=["cpu"], d2h_half=True)
    assert meta["d2h_half"] is True
    run, _ = load_detection_pipeline(tmp_path / "half.bin", device="cpu")
    packed, _ = run(images, BATCH)
    half_live = build_detection_pipeline(model, True, IMSIZE, max_detections=50, device="cpu", d2h_half=True)
    assert packed.dtype == torch.float16 and torch.equal(packed, half_live(images, BATCH)[0])
    assert torch.equal(packed, live(images, BATCH)[0].to(torch.float16))


def test_export_refusals(tmp_path):
    with pytest.raises(ValueError, match="platforms"):
        export_detection_pipeline(SSD(), tmp_path / "x.bin", batch_size=1, imsize=IMSIZE, platforms=("tpu",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            export_detection_pipeline(SSD(), tmp_path / "x.bin", batch_size=1, imsize=IMSIZE, platforms=("cuda",))
        with pytest.raises(RuntimeError, match="CUDA"):
            load_detection_pipeline(tmp_path / "x.bin")


@pytest.mark.slow
def test_load_imports_no_model_code(exported):
    """A fresh interpreter loads and runs the artifact with the op
    registrations alone: no module of the port's models is imported. It runs
    at this process's intra-op thread count: oneDNN's float32 convolutions
    sum in another order on one thread than on several."""
    path, _, live, images = exported
    np.save(path.parent / "images.npy", images)
    code = (
        "import sys, numpy as np, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})\n"
        "from object_detection_torch2_tpu_torch.serving import load_detection_pipeline\n"
        f"run, meta = load_detection_pipeline({str(path)!r}, device='cpu')\n"
        f"packed, n_valid = run(np.load({str(path.parent / 'images.npy')!r}), 2)\n"
        f"np.save({str(path.parent / 'packed.npy')!r}, packed.numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('object_detection_torch2_tpu_torch')))\n"
        "sys.exit(any(m.startswith('object_detection_torch2_tpu_torch.models') or m.endswith('.infer')\n"
        "             for m in sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_array_equal(np.load(path.parent / "packed.npy"), live(images, 2)[0].numpy())


@pytest.mark.slow
def test_inference_cli_exports_the_pipeline(tmp_path):
    """`cli.inference --export_pipeline --export_platforms cpu`: the seeded
    SSD's pipeline at the CLI's batch size, equal to its live pipeline."""
    out = inference.main(["--imsize", str(IMSIZE), "--batch_size", str(BATCH), "--dtype", "float32",
                          "--max_detections", "20", "--result_dir", str(tmp_path / "r"), "--export_pipeline",
                          str(tmp_path / "p.bin"), "--export_platforms", "cpu"])
    assert out["export"]["platforms"] == ["cpu"] and out["export"]["batch_size"] == BATCH
    assert not (tmp_path / "r" / "detection").exists()
    run, _ = load_detection_pipeline(tmp_path / "p.bin", device="cpu")
    images = np.random.default_rng(4).integers(0, 256, (BATCH, IMSIZE, IMSIZE, 3), dtype=np.uint8)
    live = build_detection_pipeline(SSD(num_classes=21, seed=0), True, IMSIZE, max_detections=20, device="cpu")
    for got, want in zip(run(images, BATCH), live(images, BATCH)):
        assert torch.equal(got, want)

"""The port's benchmark tools (object_detection_torch2_tpu_torch/tools/
bench_layers.py and bench_loader.py) against the repo's root tools of the
same names: the layer table read from the root tool's source (it is not
imported: importing it sets up the JAX compile cache), the per-layer work
and bound worked by hand, the differencing, a real eager timing and a whole
run at a small size on the CPU, the records byte-equal to the root tool's,
and both tools raising without a card. The card's runs are chip_smoke.py's
`phase_bench_tools`."""

import ast
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch.models.ssd import LAYER_SPECS, SSD
from object_detection_torch2_tpu_torch.tools import bench_layers, bench_loader

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _root_prefixes() -> list:
    """The root tool's PREFIXES, evaluated from its source alone."""
    tree = ast.parse((ROOT / "tools" / "bench_layers.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "PREFIXES")
    return eval(compile(ast.Expression(node.value), "PREFIXES", "eval"), {})


def test_layer_table_matches_the_root_tool():
    """Names, order and the output H/W, Cin, Cout and k of every prefix are
    the root tool's; only conv_1_2's FLOP factor differs (dense here, the
    TPU's staggered 4/3 there). Each row's grid is the conv's output grid of
    models/ssd.py's layers from their input grid."""
    root, port = _root_prefixes(), bench_layers.PREFIXES
    assert [r[:6] for r in root] == [p[:6] for p in port]
    assert {r[0]: (r[6], p[6]) for r, p in zip(root, port) if r[6] != p[6]} == {"1_2": (4.0 / 3.0, 1.0)}
    inputs = bench_layers.layer_inputs()
    specs = {s[0]: s for s in LAYER_SPECS}
    for name, h, w, cin, cout, k, _ in port[:-1]:
        _, scin, scout, sk, stride, pad, _ = specs[name]
        assert (cin, cout, k) == (scin, scout, sk), name
        assert (h, w) == tuple((i + 2 * pad - k) // stride + 1 for i in inputs[name]), name
    assert inputs["2_1"] == (150, 150) and inputs["4_1"] == (38, 38) and inputs["8_2"] == (19, 19)


@pytest.mark.parametrize("layer,want", [
    # 2*32*300*300*9*3*64 FLOP; bytes 32*300*300*3*2 in + 32*300*300*64*2 out + 9*3*64*2 weights
    ("1_1", {"bfloat16": (9.95328, 385_923_456, 385_923_456 / 3.35e9, "bytes"),
             "float32": (9.95328, 771_846_912, 771_846_912 / 3.35e9, "bytes")}),
    # 2*32*38*38*9*512*512 FLOP; bytes 2 * 32*38*38*512*2 + 9*512*512*2; int8: 1-byte input and weights
    ("4_2", {"bfloat16": (218.036699136, 99_352_576, 218.036699136 / 989, "operations"),
             "float32": (218.036699136, 198_705_152, 218.036699136 / 67, "operations"),
             "int8": (218.036699136, 73_334_784, 218.036699136 / 1979, "operations")}),
])
def test_layer_work_and_bound_by_hand(layer, want):
    for kind, (gflop, nbytes, bound_ms, by) in want.items():
        dtype = "bfloat16" if kind == "int8" else kind
        rows = bench_layers.layer_work(32, dtype, int8_layers=(layer,) if kind == "int8" else ())
        row = next(r for r in rows if r["layer"] == layer)
        assert row["gflop"] == pytest.approx(gflop, rel=1e-12), kind
        assert row["bytes"] == nbytes, kind
        assert row["bound_ms"] == pytest.approx(bound_ms, rel=1e-12), kind
        assert row["bound_by"] == by, kind


def test_rows_from_cumulative_times_and_op_categories():
    """Marginals are successive differences (none where either prefix has no
    graph time), the bound's share is of the graph marginal; the op
    categories follow models/ssd.py's and models/bn.py's op order."""
    n = len(bench_layers.PREFIXES)
    graph = [float(i + 1) for i in range(n)]
    graph[3] = None
    eager = [2.0 * (i + 1) for i in range(n)]
    rows = bench_layers.layer_rows(32, "bfloat16", graph, eager)
    assert [r["layer"] for r in rows] == [p[0] for p in bench_layers.PREFIXES[:-1]] + ["heads+concat"]
    assert [r["marginal_ms"] for r in rows[:6]] == [1.0, 1.0, 1.0, None, None, 1.0]
    assert all(r["eager_marginal_ms"] == 2.0 for r in rows)
    assert rows[0]["roofline_pct"] == pytest.approx(100.0 * rows[0]["bound_ms"])
    assert rows[3]["roofline_pct"] is None and rows[3]["eager_cumulative_ms"] == 8.0
    assert bench_layers.marginals([1.0, 3.0, 2.5]) == [1.0, 2.0, -0.5]

    bn = ["aten::to", "aten::mean", "aten::square", "aten::mean", "aten::rsqrt", "aten::mul", "aten::sub",
          "aten::mul", "aten::add", "aten::to"]
    names = ["aten::to", "aten::sub", "aten::mul", "aten::permute", "aten::to", "aten::conv2d", *bn, "aten::relu"]
    assert bench_layers.op_categories(names) == (["input"] * 4 + ["conv"] * 2 + ["bn_stats"] * 6
                                                 + ["bn_apply"] * 4 + ["relu"])
    int8 = ["aten::mul", "odt::quantize_act", "aten::to", "odt::int8_conv", *bn, "aten::relu", "aten::max_pool2d"]
    assert bench_layers.op_categories(int8) == (["conv", "quantize", "conv", "conv"] + ["bn_stats"] * 6
                                                + ["bn_apply"] * 4 + ["relu", "pool"])
    heads = ["aten::to", "aten::conv2d", "aten::permute", "aten::reshape", "aten::cat", "aten::to"]
    assert bench_layers.op_categories(heads) == ["conv", "conv", "other", "other", "other", "other"]


def test_eager_timing_of_the_first_prefix_on_the_cpu():
    model = SSD(num_classes=21, dtype=torch.float32, seed=0, conv12_kernel=True).train()
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        ms = bench_layers.eager_ms(lambda: model(x, use_batch_stats=True, up_to="1_1"), 1, torch.device("cpu"))
    assert math.isfinite(ms) and abs(ms) < 1e4


def test_main_on_the_cpu_prints_the_line_and_the_profile(monkeypatch, capsys, tmp_path):
    """A whole run on the CPU over the first two prefixes at 64 x 64: the
    line has the root tool's keys and the port's, no graph column on the
    CPU, and the profile splits conv_1_2's prefix into its parts."""
    monkeypatch.setattr(bench_layers, "IMSIZE", 64)
    monkeypatch.setattr(bench_layers, "PREFIXES", bench_layers.PREFIXES[:2])
    out = tmp_path / "layers.json"
    record = bench_layers.main(["--batch_size", "1", "--iters", "1", "--dtype", "float32", "--profile",
                                "--out", str(out), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"batch_size", "forward_ms", "layers"} <= set(line)
    assert {"forward_eager_ms", "marginals_sum_ms", "dtype", "card", "conv12_launches", "capture_failures",
            "profile"} <= set(line)
    assert line["batch_size"] == 1 and line["forward_ms"] is None and line["card"] is None
    assert [r["layer"] for r in line["layers"]] == ["1_1", "1_2"]
    row_keys = {"layer", "marginal_ms", "eager_marginal_ms", "gflop", "bytes", "bound_ms", "bound_by", "tflops",
                "roofline_pct", "cumulative_ms", "eager_cumulative_ms"}
    assert all(set(r) == row_keys and math.isfinite(r["eager_marginal_ms"]) for r in line["layers"])
    assert {"input", "conv", "bn_stats", "bn_apply", "relu"} <= set(line["profile"]["1_1"])
    assert {"conv", "bn_stats", "bn_apply", "relu", "pool"} == set(line["profile"]["1_2"])
    conv = [op for op in record["profile"][1]["ops"] if op["category"] == "conv"]
    assert [op["op"] for op in conv][-1] == "odt::conv12"
    assert all(p["consistent"] for p in record["profile"])
    assert json.loads(out.read_text())["profile"][1]["layer"] == "1_2"


def test_synthetic_records_equal_the_root_tools(tmp_path):
    """The root tool imports only numpy at its top, so it is loaded from its
    file; both write the same three files, byte for byte."""
    spec = importlib.util.spec_from_file_location("root_bench_loader", ROOT / "tools" / "bench_loader.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    (tmp_path / "root").mkdir(), (tmp_path / "port").mkdir()
    root.make_synthetic_records(tmp_path / "root", 5, imsize=48, max_gt=8)
    bench_loader.make_synthetic_records(tmp_path / "port", 5, imsize=48, max_gt=8)
    for name in ("images.npy", "gts.npy", "meta.json"):
        assert (tmp_path / "root" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


def test_loader_main_prints_its_line(capsys):
    record = bench_loader.main(["--count", "8", "--batch_size", "4", "--epochs", "1", "--device", "cpu"])
    text, line = capsys.readouterr().out.strip().splitlines()[-2:]
    assert text.startswith("loader: 8 images in ") and "img/s host->device" in text
    assert json.loads(line) == record
    assert record["images"] == 8 and record["img_per_s"] > 0 and record["card"] is None
    assert record["bytes_per_batch"] == 4 * (300 * 300 * 3 + 64 * 25 * 4)


@pytest.mark.parametrize("tool", [bench_layers, bench_loader], ids=["bench_layers", "bench_loader"])
def test_tools_raise_without_a_card(tool):
    """Without --device each tool runs on the card, and without one it
    raises before any work: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])

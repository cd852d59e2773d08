"""The port's accuracy proofs and weight bridges (object_detection_torch2_tpu_torch/tools/)
against the repo's root tools/ on the CPU:

- `tools.synth_voc.generate` writes the root generator's files byte for byte
  (both vocabularies);
- the `.pth` bridge both ways: `torch_to_npz` writes the root tool's
  weights.msgpack byte for byte, `export_torch` its state_dict tensor for
  tensor, and a round trip is bit-lossless (a seeded SSD and a seeded VGG16
  at full trunk width, narrow heads);
- recipe parity of the four proofs: each port proof and its root tool run
  with `cli.train.main`, `cli.evaluate.main`, `pack_voc` and the generator
  replaced by recorders (and the model-side measurements of the int8 budget
  by stubs), at default and non-default flags: the same calls with the same
  argv apart from the port's `--device` and the output directory, and the
  same pass/fail on a given mAP; the stage-A trunk extraction gives the same
  layers as the root tool's on a seeded SSD;
- the int8 budget's own pass rule.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch.models.convert import jax_variables_of
from object_detection_torch2_tpu_torch.models.ssd import SSD
from object_detection_torch2_tpu_torch.tools import common as proof_common
from object_detection_torch2_tpu_torch.tools import export_torch, int8_budget, synth_voc, torch_to_npz

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test's weights files and checkpoints (100 MB each) go when it
    ends: pytest keeps the temporary directories of its last three runs."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kwargs", [dict(n_classes=6, count_dist="uniform3", seed=0),
                                    dict(n_classes=20, count_dist="voc", seed=3)])
def test_synth_voc_byte_equal_to_root_generator(tmp_path, kwargs):
    from tools import synth_voc as root_synth

    root_synth.generate(tmp_path / "root", 3, 2, **kwargs)
    synth_voc.generate(tmp_path / "port", 3, 2, **kwargs)
    want, got = _files(tmp_path / "root"), _files(tmp_path / "port")
    assert len(want) == 2 * 5 + 2  # 5 JPEGs and 5 XMLs, two list files
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


# ---------------------------------------------------------------- the bridge
@pytest.fixture(scope="module")
def reference_pths(tmp_path_factory):
    """{"ssd": path, "vgg16": path}: seeded reference-layout checkpoints. The
    SSD is the port's seeded SSD300 (the reference's keys); the VGG16 has
    the full-width trunk under `features.<idx>` and narrow seeded heads."""
    out = tmp_path_factory.mktemp("pth")
    sd = {k: v.clone() for k, v in SSD(seed=0).state_dict().items()}
    sd["features.bn_1_1.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, out / "ssd.pth")

    rng = np.random.default_rng(1)
    from object_detection_torch2_tpu_torch.models.convert import vgg16_sequential_index_map

    vgg, cin = {}, 3
    for idx, name in vgg16_sequential_index_map().items():
        if name.startswith("conv_"):
            cout = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}[int(name.split("_")[1])]
            vgg[f"features.{idx}.weight"] = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
            vgg[f"features.{idx}.bias"] = rng.standard_normal(cout).astype(np.float32)
            cin = cout
        else:
            for leaf in ("weight", "bias", "running_mean"):
                vgg[f"features.{idx}.{leaf}"] = rng.standard_normal(cin).astype(np.float32)
            vgg[f"features.{idx}.running_var"] = rng.uniform(0.5, 2.0, cin).astype(np.float32)
            vgg[f"features.{idx}.num_batches_tracked"] = np.int64(3)
    for head, out_dim in (("classifier", 10), ("classifier2", 20)):
        for idx, shape in ((0, (8, 512 * 7 * 7)), (3, (8, 8)), (6, (out_dim, 8))):
            vgg[f"{head}.{idx}.weight"] = rng.standard_normal(shape).astype(np.float32)
            vgg[f"{head}.{idx}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)
    torch.save({k: torch.as_tensor(v) for k, v in vgg.items()}, out / "vgg16.pth")
    yield {"ssd": out / "ssd.pth", "vgg16": out / "vgg16.pth"}
    shutil.rmtree(out, ignore_errors=True)


def _root_main(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()


@pytest.mark.parametrize("model", ["ssd", "vgg16"])
def test_torch_to_npz_bytes_equal_to_root_tool(tmp_path, monkeypatch, reference_pths, model):
    import tools.torch_to_npz as root_tool

    _root_main(monkeypatch, root_tool, ["--pth", str(reference_pths[model]), "--model", model,
                                        "--out", str(tmp_path / "root.msgpack")])
    torch_to_npz.main(["--pth", str(reference_pths[model]), "--model", model, "--out", str(tmp_path / "port.msgpack")])
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "root.msgpack").read_bytes()


@pytest.mark.parametrize("model", ["ssd", "vgg16"])
def test_export_torch_tensor_equal_to_root_tool(tmp_path, monkeypatch, reference_pths, model):
    import tools.export_torch as root_tool

    weights = tmp_path / "w.msgpack"
    torch_to_npz.main(["--pth", str(reference_pths[model]), "--model", model, "--out", str(weights)])
    _root_main(monkeypatch, root_tool, ["--weights", str(weights), "--model", model, "--out", str(tmp_path / "root.pth")])
    export_torch.main(["--weights", str(weights), "--model", model, "--out", str(tmp_path / "port.pth")])
    want = torch.load(tmp_path / "root.pth")
    got = torch.load(tmp_path / "port.pth")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("model", ["ssd", "vgg16"])
def test_pth_round_trip_is_bit_lossless(tmp_path, reference_pths, model):
    """.pth -> weights.msgpack -> .pth -> weights.msgpack: the two weights
    files byte-equal, and every tensor of the reference checkpoint back
    bit for bit (less num_batches_tracked, which is written as 0)."""
    torch_to_npz.main(["--pth", str(reference_pths[model]), "--model", model, "--out", str(tmp_path / "a.msgpack")])
    export_torch.main(["--weights", str(tmp_path / "a.msgpack"), "--model", model, "--out", str(tmp_path / "b.pth")])
    torch_to_npz.main(["--pth", str(tmp_path / "b.pth"), "--model", model, "--out", str(tmp_path / "c.msgpack")])
    assert (tmp_path / "c.msgpack").read_bytes() == (tmp_path / "a.msgpack").read_bytes()
    ref, back = torch.load(reference_pths[model]), torch.load(tmp_path / "b.pth")
    assert sorted(back) == sorted(ref)
    for key, t in ref.items():
        if key.endswith("num_batches_tracked"):
            assert back[key].dtype == torch.int64 and int(back[key]) == 0
        else:
            assert torch.equal(back[key], torch.as_tensor(t)), key


# ------------------------------------------------------------- recipe parity
@pytest.fixture(scope="module")
def seeded_ssd_vars():
    """The {"params", "batch_stats"} tree of a seeded SSD300: what a stage-A
    pretraining run leaves in its weights file."""
    return jax_variables_of(SSD(seed=0))


class _Recorder:
    """Stands in for the CLIs, pack_voc, the generator and the weights files
    of one run of a proof (the root tool's or the port's): records each
    call; `train` leaves a weights "file" (the seeded SSD's variables, or a
    trunk-only VGG16's for the classification purpose) in an in-memory
    store, which load_weights / save_weights read and write."""

    def __init__(self, base: Path, ssd_vars: dict, maps: dict):
        self.base, self.ssd_vars, self.maps = base, ssd_vars, maps
        self.calls, self.store = [], {}

    def norm(self, x):
        return str(x).replace(str(self.base), "<out>")

    def _touch(self, path: Path, tree):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.touch()
        self.store[str(path)] = tree

    def train(self, argv):
        argv = list(argv)
        if "--device" in argv:
            i = argv.index("--device")
            del argv[i:i + 2]
        self.calls.append(("train", [self.norm(a) for a in argv]))
        result = Path(argv[argv.index("--result_dir") + 1])
        purpose = argv[argv.index("--purpose") + 1] if "--purpose" in argv else "detection"
        tree = self.ssd_vars if purpose == "detection" else proof_common.trunk_overlay(self.ssd_vars)
        self._touch(result / purpose / "weights.msgpack", tree)
        row = {"train_s": 1.0, "val_s": 0.5, "save_s": 0.25, "total_s": 1.75}
        return {"losses": [torch.zeros(3)], "phase_times": [row]}

    def evaluate(self, argv):
        argv = list(argv)
        if "--device" in argv:
            i = argv.index("--device")
            del argv[i:i + 2]
        self.calls.append(("evaluate", [self.norm(a) for a in argv]))
        key = "full" if "--full_int8" in argv else "trunk" if "--trunk_int8" in argv else "float"
        parity, strict = self.maps[key]
        aps = np.array([parity] * 6 + [np.nan] * 14, np.float32)
        strict_aps = np.array([strict] * 6 + [np.nan] * 14, np.float32)
        return aps, parity, strict, strict_aps

    def pack(self, data_dirs, list_file, out_dir, **kwargs):
        self.calls.append(("pack", [self.norm(d) for d in data_dirs], list_file, self.norm(out_dir), kwargs))

    def generate(self, out, n_train, n_test, seed=0, **kwargs):
        self.calls.append(("generate", self.norm(out), n_train, n_test, seed, kwargs))
        # a real (tiny) tree: the int8 budget reads its calibration images
        synth_voc.generate(Path(out), min(n_train, 2), min(n_test, 2), seed=seed)
        return Path(out)

    def mkdtemp(self, prefix="tmp", **kwargs):
        path = self.base / prefix
        path.mkdir(parents=True, exist_ok=True)
        return str(path)

    def load_weights(self, path):
        return self.store[str(path)]

    def save_weights(self, path, variables):
        self._touch(Path(path), variables)
        self.calls.append(("save_weights", self.norm(path)))


class _FakeJaxModel:
    """The root tools' flax models in the recorders' runs: VGG16.init gives
    an empty variable set (the trunk overlay is all that is compared), and
    SSD.apply a constant block-5 output."""

    def __init__(self, *args, trunk_int8=False, **kwargs):
        self.scale = 2.0 if trunk_int8 else 1.0

    def init(self, *args, **kwargs):
        return {"params": {}, "batch_stats": {}}

    def apply(self, *args, **kwargs):
        return (np.full((2, 3), self.scale, np.float32),)


_AMAX = {f"amax_{layer}": 1.0 + i for i, layer in enumerate(("1_2", "2_1", "5_3"))}
_MAPS = {"float": (0.8, 0.45), "trunk": (0.82, 0.41), "full": (0.78, 0.40)}


def _run_root(tool: str, argv, base: Path, ssd_vars, monkeypatch, maps=_MAPS):
    import object_detection_torch2_tpu.cli.evaluate as jax_eval
    import object_detection_torch2_tpu.cli.train as jax_train
    import object_detection_torch2_tpu.data.augment as jax_augment
    import object_detection_torch2_tpu.data.records as jax_records
    import object_detection_torch2_tpu.models.quant as jax_quant
    import object_detection_torch2_tpu.models.ssd as jax_ssd
    import object_detection_torch2_tpu.models.vgg16 as jax_vgg16
    import object_detection_torch2_tpu.train.checkpoint as jax_ckpt
    import tools.synth_voc as root_synth

    module = __import__(f"tools.{tool}", fromlist=["main"])
    base.mkdir(parents=True, exist_ok=True)
    rec = _Recorder(base, ssd_vars, maps)
    with monkeypatch.context() as m:
        m.setattr(jax_train, "main", rec.train)
        m.setattr(jax_eval, "main", rec.evaluate)
        m.setattr(jax_records, "pack_voc", rec.pack)
        m.setattr(root_synth, "generate", rec.generate)
        m.setattr(tempfile, "mkdtemp", rec.mkdtemp)
        m.setattr(jax_ckpt, "load_weights", rec.load_weights)
        m.setattr(jax_ckpt, "save_weights", rec.save_weights)
        m.setattr(jax_vgg16, "VGG16", _FakeJaxModel)
        m.setattr(jax_ssd, "SSD", _FakeJaxModel)
        m.setattr(jax_quant, "calibrate_trunk", lambda *a, **k: dict(_AMAX))
        m.setattr(jax_quant, "calibrate_full", lambda *a, **k: dict(_AMAX))
        m.setattr(jax_quant, "saturation_rates", lambda *a, **k: {})
        m.setattr(jax_augment, "augment_batch", lambda key, images, gts: (images, gts))
        m.setattr(module, "REPO", base)
        rc = module.main([a.replace("{B}", str(base)) for a in argv])
    out = {"overfit_proof": "PROOF_OVERFIT.json", "generalization_proof": "PROOF_GENERALIZATION.json",
           "pretrained_trunk_proof": "PROOF_PRETRAINED_TRUNK.json", "int8_budget": "INT8_BUDGET.json"}[tool]
    return rec, rc, json.loads((base / out).read_text())


def _run_port(tool: str, argv, base: Path, ssd_vars, monkeypatch, maps=_MAPS, cosine=0.999):
    import object_detection_torch2_tpu_torch.cli.evaluate as port_eval
    import object_detection_torch2_tpu_torch.cli.train as port_train
    import object_detection_torch2_tpu_torch.data.records as port_records
    import object_detection_torch2_tpu_torch.models.quant as port_quant
    import object_detection_torch2_tpu_torch.train.checkpoint as port_ckpt

    module = __import__(f"object_detection_torch2_tpu_torch.tools.{tool}", fromlist=["main"])
    base.mkdir(parents=True, exist_ok=True)
    rec = _Recorder(base, ssd_vars, maps)
    with monkeypatch.context() as m:
        m.setattr(port_train, "main", rec.train)
        m.setattr(port_eval, "main", rec.evaluate)
        m.setattr(port_records, "pack_voc", rec.pack)
        if hasattr(module, "generate"):
            m.setattr(module, "generate", rec.generate)
        m.setattr(tempfile, "mkdtemp", rec.mkdtemp)
        m.setattr(port_ckpt, "load_weights", rec.load_weights)
        m.setattr(port_ckpt, "save_weights", rec.save_weights)
        m.setattr(proof_common, "vgg16_base_variables", lambda seed=0: {"params": {}, "batch_stats": {}})
        m.setattr(proof_common, "PROOFS_DIR", base)
        m.setattr(int8_budget, "load_model", lambda *a: None)
        m.setattr(int8_budget, "saturation", lambda *a: {})
        m.setattr(int8_budget, "trunk_drift", lambda *a: {"cosine": cosine, "rel_l2": 0.05})
        m.setattr(port_quant, "calibrate_trunk", lambda *a, **k: dict(_AMAX))
        m.setattr(port_quant, "calibrate_full", lambda *a, **k: dict(_AMAX))
        rc = module.main([a.replace("{B}", str(base)) for a in argv] + ["--device", "cpu"])
    out = {"overfit_proof": "overfit", "generalization_proof": "generalization",
           "pretrained_trunk_proof": "pretrained_trunk", "int8_budget": "int8_budget"}[tool]
    return rec, rc, json.loads((base / f"{out}.json").read_text())


RECIPES = [
    ("overfit_proof", []),
    ("overfit_proof", ["--epochs", "7", "--lr", "0.002", "--threshold", "0.5", "--dtype", "float32",
                       "--result_dir", "{B}/r"]),
    ("generalization_proof", []),
    ("generalization_proof", ["--use_records", "--device_cache", "--train_aug", "reduced_hue", "--epochs", "3",
                              "--batch_size", "8", "--eval_batch_size", "2", "--num_workers", "2", "--n_train", "40",
                              "--n_test", "8", "--gamma", "0.9", "--lr", "0.01", "--threshold", "0.7",
                              "--dtype", "float32", "--result_dir", "{B}/r"]),
    ("generalization_proof", ["--use_records", "--data_dir", "{B}/d"]),
    ("pretrained_trunk_proof", ["--trunk_source", "detection"]),
    ("pretrained_trunk_proof", []),
    ("pretrained_trunk_proof", ["--trunk_source", "classification", "--cls_epochs", "2", "--cls_batch_size", "8",
                                "--cls_imsize", "200", "--cls_aug", "none", "--det_epochs", "3",
                                "--det_batch_size", "8", "--eval_batch_size", "2", "--train_aug", "reduced_hue",
                                "--threshold", "0.6", "--num_workers", "1", "--data_dir", "{B}/d"]),
]


@pytest.mark.parametrize("tool,argv", RECIPES)
def test_proof_recipe_equals_root_tool(tmp_path, monkeypatch, seeded_ssd_vars, tool, argv):
    """The same CLI, pack and generator calls in the same order with the
    same argv (less the port's --device and the output directory); the same
    pass/fail and exit code on the recorded mAP (0.8 parity) and on one
    just below the threshold; the same trunk layers written for stage C."""
    root_rec, root_rc, root_json = _run_root(tool, argv, tmp_path / "root", seeded_ssd_vars, monkeypatch)
    port_rec, port_rc, port_json = _run_port(tool, argv, tmp_path / "port", seeded_ssd_vars, monkeypatch)
    assert port_rec.calls == root_rec.calls
    assert (port_rc, port_json["passed"]) == (root_rc, root_json["passed"])
    if tool == "pretrained_trunk_proof":
        # stage A's VGG16 variables (detection source), then stage B's read-back ones
        cls = "<out>/trunk_proof_/classification/weights.msgpack"
        saves = 2 if "detection" in argv else 1
        assert [c for c in root_rec.calls if c[0] == "save_weights"] == [("save_weights", cls)] * saves
        a = root_rec.store[cls.replace("<out>", str(root_rec.base))]
        b = port_rec.store[cls.replace("<out>", str(port_rec.base))]
        for coll in ("params", "batch_stats"):
            assert sorted(b[coll]) == sorted(a[coll])
            assert len(b[coll]) == {"params": 26, "batch_stats": 13}[coll]
            assert all(k.startswith(("conv_", "bn_")) and proof_common.is_trunk_layer(k) for k in b[coll])
            for layer in a[coll]:
                for leaf, v in a[coll][layer].items():
                    np.testing.assert_array_equal(np.asarray(b[coll][layer][leaf]), np.asarray(v))
        assert port_json["pth_round_trip"]["lossless"]

    threshold = root_json["threshold"]
    below = {"float": (threshold - 1e-3, 0.3), "trunk": (0, 0), "full": (0, 0)}
    root_rec, root_rc, root_json = _run_root(tool, argv, tmp_path / "root_below", seeded_ssd_vars, monkeypatch, below)
    port_rec, port_rc, port_json = _run_port(tool, argv, tmp_path / "port_below", seeded_ssd_vars, monkeypatch, below)
    assert (port_rc, port_json["passed"], root_rc, root_json["passed"]) == (1, False, 1, False)


@pytest.mark.parametrize("argv", [[], ["--pretrain_epochs", "2", "--det_epochs", "3", "--batch_size", "8",
                                        "--eval_batch_size", "2", "--calib_margin", "1.5", "--train_aug",
                                        "reduced_hue", "--gamma", "0.9", "--dtype", "float32",
                                        "--data_dir", "{B}/d", "--work_dir", "{B}/w"]])
def test_int8_budget_recipe_equals_root_tool(tmp_path, monkeypatch, seeded_ssd_vars, argv):
    """The int8 budget's CLI calls (pretraining, both arms' training, the
    float, margin-sweep, full-int8 and int8-arm evaluations) in the root
    tool's order with its argv, the stage-A VGG16 variables (each arm's
    classification weights) with the root tool's trunk layers, and the
    same margins in the sweep."""
    if "{B}/d" in argv:
        for base in ("root", "port"):
            synth_voc.generate(tmp_path / base / "d", 2, 2, seed=0)
    root_rec, root_rc, root_json = _run_root("int8_budget", argv, tmp_path / "root", seeded_ssd_vars, monkeypatch)
    port_rec, port_rc, port_json = _run_port("int8_budget", argv, tmp_path / "port", seeded_ssd_vars, monkeypatch)
    assert port_rec.calls == root_rec.calls
    margins = len(root_json["same_weights_eval_ab"]["margin_sweep"])
    assert margins == (3 if not argv else 2)  # {1.0, --calib_margin, 1.5}
    kinds = [c[0] for c in port_rec.calls if c[0] in ("train", "evaluate")]
    assert kinds == ["train", "train"] + ["evaluate"] * (2 + margins) + ["train", "evaluate", "evaluate"]
    assert root_rc == port_rc == 0
    assert sorted(port_json["same_weights_eval_ab"]["margin_sweep"]) == sorted(
        root_json["same_weights_eval_ab"]["margin_sweep"])
    saved = [c[1] for c in port_rec.calls if c[0] == "save_weights"]
    assert len(saved) == 2
    for path in saved:
        a = root_rec.store[path.replace("<out>", str(root_rec.base))]
        b = port_rec.store[path.replace("<out>", str(port_rec.base))]
        assert {c: sorted(b[c]) for c in b} == {c: sorted(a[c]) for c in ("params", "batch_stats")}


@pytest.mark.parametrize("maps,cosine,passed", [
    (_MAPS, 0.999, True),
    ({"float": (0.8, 0.45), "trunk": (0.7499, 0.45), "full": (0.8, 0.45)}, 0.999, False),
    ({"float": (0.8, 0.45), "trunk": (0.8, 0.45), "full": (0.8, 0.3499)}, 0.999, False),
    (_MAPS, 0.989, False),
])
def test_int8_budget_pass_rule(tmp_path, monkeypatch, seeded_ssd_vars, maps, cosine, passed):
    """Pass: trunk-feature cosine >= 0.99, each int8 arm's same-weights
    parity >= float - 0.05 and strict >= float - 0.10; a failed budget
    exits 1 with the whole record written."""
    _, rc, record = _run_port("int8_budget", [], tmp_path, seeded_ssd_vars, monkeypatch, maps, cosine)
    assert (record["passed"], rc) == (passed, 0 if passed else 1)
    assert record["trained_with_int8_arm"] != "PENDING"

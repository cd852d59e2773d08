"""The port's reference-scale rehearsal (`tools/voc_scale_proof.py`) against
the repo's root tools/voc_scale_proof.py on the CPU:

- recipe parity: both tools run with `run_stage` replaced by a recorder
  that writes the stage JSONs a real stage would: the same stages in the
  same order with the same argv (apart from the module path, the port's
  `--device` and the output directory), the same SIGKILL target and grace;
  the port's record holds every key of the root tool's; the same pass/fail
  and exit code at parity mAP 0.4499 and 0.45; the resume checks accept a
  replayed epoch and raise on a gap;
- the stages the root tool runs in its subprocesses, in process: generate
  and pack make the same calls, the eval stage the same evaluate calls (the
  float and both int8 arms) and eval.json, and the bridge writes the
  classification weights file byte for byte;
- `run_stage` on real subprocesses: a SIGKILL lands a set time after an
  epoch line (killed, the epochs parsed, RSS read), `run_cli` keeps a CLI's
  kernel launch counts, a library built under `_build/` during a stage is
  listed, and a failing stage raises.
"""

import argparse
import concurrent.futures
import json
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu_torch.tools import common as proof_common
from object_detection_torch2_tpu_torch.tools import voc_scale_proof as port_tool

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

_MAPS = {"float": (0.47, 0.36), "trunk": (0.46, 0.35), "full": (0.45, 0.34)}


class _Stages:
    """Stands in for `run_stage` in one run of a tool: records each call and
    writes what the real stage would leave for the tool (host_pipeline.json,
    bridge.json, eval.json and a report, the run logs), returning the
    monitor's fields with the epochs a run of that argv prints."""

    def __init__(self, base: Path, maps: dict, resume_offset: int = 1):
        self.base, self.maps, self.resume_offset = base, maps, resume_offset
        self.calls = []

    def norm(self, argv) -> list:
        out, argv, i = [], [str(a) for a in argv], 0
        while i < len(argv):
            a = argv[i]
            if a == "--device":
                i += 2
                continue
            if (a, argv[i + 1] if i + 1 < len(argv) else None) in (port_tool.TOOL, port_tool.TRAIN_CLI):
                out.append("<tool>" if (a, argv[i + 1]) == port_tool.TOOL else "<train>")
                i += 2
                continue
            if a.endswith("tools/voc_scale_proof.py"):
                a = "<tool>"
            elif a.endswith("/train.py"):
                a = "<train>"
            out.append(a.replace(str(self.base), "<out>"))
            i += 1
        return out

    def __call__(self, label, argv, log_path, env=None, monitor=False, kill_after_epoch=None, kill_grace_s=25.0,
                 **port_only):
        argv = [str(a) for a in argv]
        self.calls.append((label, self.norm(argv), Path(log_path).name, kill_after_epoch, kill_grace_s))
        res = Path(argv[argv.index("--result_dir") + 1]) if "--result_dir" in argv else None
        log_path.parent.mkdir(parents=True, exist_ok=True)
        log = []
        epochs, killed = [], False
        if label == "pack":
            res.mkdir(parents=True, exist_ok=True)
            (res / "host_pipeline.json").write_text(json.dumps({"host_memmap_img_per_s": 123.0}))
        elif label == "bridge":
            (res / "bridge.json").write_text(json.dumps({"pth_roundtrip_lossless": True, "tensors": 90,
                                                         "trunk_layers": 26, "seconds": 1.0}))
        elif label == "eval":
            arms = {}
            for key, name in (("trunk", "int8_trunk"), ("full", "full_int8")):
                arms[name] = {"parity_mAP": self.maps[key][0], "strict_mAP": self.maps[key][1],
                              "strict_delta_vs_float": 0.0, "eval_seconds": 1.0}
            launch = dict.fromkeys(proof_common.KERNELS, 1)
            (res / "eval.json").write_text(json.dumps({
                "eval_seconds": 2.0, "parity_mAP_heldout": self.maps["float"][0],
                "strict_mAP_heldout": self.maps["float"][1], "per_class_AP": [0.5] * 20, **arms,
                "kernel_launches": launch, "stages": {"eval_float": {"seconds": 1.0, "launches": launch}}}))
            (res / "detection").mkdir(parents=True, exist_ok=True)
            (res / "detection" / "report_2026-01-01.md").write_text("report")
        elif "--epochs" in argv:
            n = int(argv[argv.index("--epochs") + 1])
            first = 1
            if label.startswith("train(run1"):
                n, killed = kill_after_epoch, True
            elif label.startswith("train(run2"):
                # the CLI numbers a resumed run's epochs from the restored step
                first = self.killed_at + self.resume_offset
                n = n + self.killed_at - first + 1
                log += ["Orbax state restored", port_tool.RESUME_LINE]  # the JAX CLI's line, the port's
            epochs = [{"epoch": first + k, "loss": 4.0 - 0.01 * k, "val_loss": 4.1, "img_per_s": 700.0 + k,
                       "t": 10.0 * (k + 1)} for k in range(n)]
            if killed:
                self.killed_at = epochs[-1]["epoch"]
        log_path.write_text("\n".join(log) + "\n")
        return {"seconds": 3.0, "epochs": epochs, "phases": [], "compiles": [], "compile_count": 0,
                "compiles_after_epoch1": 0, "rss_mb": {"start": 1, "end": 2, "max": 3},
                "device_mem_mb": None, "rss_mb_series": [(0.0, 1), (10.0, 3), (20.0, 2)],
                "device_mem_mb_series": None, "killed": killed, "returncode": -9 if killed else 0,
                "lines_after_last_epoch": [] if killed else None,
                "launches": dict.fromkeys(proof_common.KERNELS, 2) if "--epochs" in argv else None}


def _run_root(argv, base: Path, monkeypatch, maps=_MAPS, resume_offset=1):
    import tools.voc_scale_proof as root_tool

    base.mkdir(parents=True, exist_ok=True)
    rec = _Stages(base, maps, resume_offset)
    with monkeypatch.context() as m:
        m.setattr(root_tool, "run_stage", rec)
        m.setattr(root_tool, "REPO", base)
        rc = root_tool.main([a.replace("{B}", str(base)) for a in argv])
    return rec, rc, json.loads((base / "PROOF_VOC_SCALE.json").read_text())


def _run_port(argv, base: Path, monkeypatch, maps=_MAPS, resume_offset=1):
    base.mkdir(parents=True, exist_ok=True)
    rec = _Stages(base, maps, resume_offset)
    with monkeypatch.context() as m:
        m.setattr(port_tool, "run_stage", rec)
        m.setattr(proof_common, "PROOFS_DIR", base)
        rc = port_tool.main([a.replace("{B}", str(base)) for a in argv] + ["--device", "cpu"])
    return rec, rc, json.loads((base / "voc_scale.json").read_text())


def _keys_within(want, got, path=""):
    """Every key of `want` (nested dicts) is in `got`."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        for k, v in want.items():
            assert k in got, f"{path}/{k}"
            _keys_within(v, got[k], f"{path}/{k}")


RECIPES = [
    ["--work_dir", "{B}/w"],
    ["--work_dir", "{B}/w", "--n_train", "512", "--n_test", "96", "--pretrain_n", "256", "--pretrain_epochs", "4",
     "--epochs", "4", "--kill_grace_s", "1"],
    ["--work_dir", "{B}/w", "--epochs", "7", "--batch_size", "16", "--steps_per_dispatch", "2", "--train_aug",
     "none", "--data_dir", "{B}/d", "--result_dir", "{B}/r", "--threshold", "0.3"],
]


@pytest.mark.parametrize("argv", RECIPES)
def test_recipe_equals_the_root_tool(tmp_path, monkeypatch, argv):
    root_rec, root_rc, root_json = _run_root(argv, tmp_path / "root", monkeypatch)
    port_rec, port_rc, port_json = _run_port(argv, tmp_path / "port", monkeypatch)
    assert [c[0] for c in port_rec.calls] == ["generate", "pack", "pretrain", "bridge", "train(run1,killed)",
                                              "train(run2,resumed)", "eval"]
    assert port_rec.calls == root_rec.calls
    _keys_within(root_json, port_json)
    assert (port_rc, port_json["passed"]) == (root_rc, root_json["passed"]) == (0, True)
    assert port_json["train_aug"] == root_json["train_aug"]
    for key in ("scale", "checks"):
        assert {k: port_json[key][k] for k in root_json[key]} == root_json[key], key
    for key in ("killed_after_epoch", "resume_first_epoch", "epochs_completed", "loss_curve", "epoch_wall_s",
                "steady_img_per_s_median", "orbax_exact_resume"):
        assert port_json["train"][key] == root_json["train"][key], key
    for key in ("parity_mAP_heldout", "strict_mAP_heldout", "int8_trunk", "full_int8", "images"):
        assert port_json["eval"][key] == root_json["eval"][key], key
    assert port_json["kernel_launches"]["total"]["conv12_bf16"] == 2 * 3 + 1


@pytest.mark.parametrize("parity,passed", [(0.4499, False), (0.45, True)])
def test_pass_rule_equals_the_root_tool(tmp_path, monkeypatch, parity, passed):
    maps = {**_MAPS, "float": (parity, 0.3)}
    _, root_rc, root_json = _run_root(RECIPES[1], tmp_path / "root", monkeypatch, maps)
    _, port_rc, port_json = _run_port(RECIPES[1], tmp_path / "port", monkeypatch, maps)
    assert (port_rc, port_json["passed"]) == (root_rc, root_json["passed"]) == (0 if passed else 1, passed)
    assert port_json["phase_completed"] == "eval" and port_json["checks"]["mAP_ok"] is passed


@pytest.mark.parametrize("offset,ok", [(0, True), (1, True), (2, False)])
def test_resume_checks_equal_the_root_tool(tmp_path, monkeypatch, offset, ok):
    """Run 2 may replay the killed epoch (the kill landed in its full-state
    write) or start after it; a gap raises in both tools."""
    if ok:
        _, _, root_json = _run_root(RECIPES[1], tmp_path / "root", monkeypatch, resume_offset=offset)
        _, _, port_json = _run_port(RECIPES[1], tmp_path / "port", monkeypatch, resume_offset=offset)
        assert port_json["train"]["resume_first_epoch"] == root_json["train"]["resume_first_epoch"]
        assert port_json["train"]["resume_first_epoch"] == port_json["train"]["killed_after_epoch"] + offset
    else:
        with pytest.raises(AssertionError, match="kill point"):
            _run_root(RECIPES[1], tmp_path / "root", monkeypatch, resume_offset=offset)
        with pytest.raises(AssertionError, match="kill point"):
            _run_port(RECIPES[1], tmp_path / "port", monkeypatch, resume_offset=offset)


# ------------------------------------------------- the stages, in process
def _args(tool, base: Path, **kw):
    a = argparse.Namespace(work_dir=str(base), n_train=40, n_test=8, pretrain_n=16, data_dir=str(base / "data"),
           pretrain_dir=str(base / "data_pre"), pretrain_result=str(base / "result_pre"),
           result_dir=str(base / "result"), device="cpu")
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _fake_records(out: Path, n: int = 40):
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "images.npy", np.random.default_rng(0).integers(0, 256, (n, 4, 4, 3), dtype=np.uint8))
    np.save(out / "gts.npy", np.zeros((n, 2, 25), np.float32))
    (out / "meta.json").write_text(json.dumps({"count": n}))


def test_generate_and_pack_stages_equal_the_root_tool(tmp_path, monkeypatch):
    import object_detection_torch2_tpu.data.records as jax_records
    import tools.synth_voc as root_synth
    import tools.voc_scale_proof as root_tool
    from object_detection_torch2_tpu_torch.data import records as port_records
    from object_detection_torch2_tpu_torch.tools import synth_voc as port_synth

    calls = {"root": [], "port": []}

    def recorder(who, base):
        def generate(out, n_train, n_test, **kw):
            calls[who].append(("generate", str(out).replace(str(base), "<out>"), n_train, n_test, kw))

        def pack(dirs, list_file, out, **kw):
            calls[who].append(("pack", [str(d).replace(str(base), "<out>") for d in dirs], list_file,
                               str(out).replace(str(base), "<out>"), kw))
            _fake_records(Path(out))
        return generate, pack

    for who, gen_mod, rec_mod, tool in (("root", root_synth, jax_records, root_tool),
                                        ("port", port_synth, port_records, port_tool)):
        base = tmp_path / who
        generate, pack = recorder(who, base)
        with monkeypatch.context() as m:
            m.setattr(gen_mod, "generate", generate)
            m.setattr(rec_mod, "pack_voc", pack)
            a = _args(tool, base)
            tool.stage_generate(a)
            tool.stage_pack(a)
        assert json.loads((base / "result" / "host_pipeline.json").read_text())["host_memmap_img_per_s"] > 0
    assert calls["port"] == calls["root"] and len(calls["port"]) == 6


def test_eval_stage_equals_the_root_tool(tmp_path, monkeypatch):
    """The float, --trunk_int8 and --full_int8 evaluations with the root
    tool's argv, the scales calibrated on the first 32 training records at
    margin 1.25 (quant.json and quant_full.json), and eval.json's values."""
    import object_detection_torch2_tpu.cli.evaluate as jax_eval
    import object_detection_torch2_tpu.models.quant as jax_quant
    import object_detection_torch2_tpu.train.checkpoint as jax_ckpt
    import tools.voc_scale_proof as root_tool
    from object_detection_torch2_tpu_torch.cli import evaluate as port_eval
    from object_detection_torch2_tpu_torch.models import quant as port_quant
    from object_detection_torch2_tpu_torch.tools import int8_budget

    out = {}
    for who, tool in (("root", root_tool), ("port", port_tool)):
        base = tmp_path / who
        _fake_records(base / "result" / "rec_train")
        (base / "result" / "detection").mkdir(parents=True)
        seen = {"evaluate": [], "calib": []}

        def evaluate(argv, base=base, seen=seen):
            argv = [a.replace(str(base), "<out>") for a in argv]
            if "--device" in argv:
                del argv[argv.index("--device"):argv.index("--device") + 2]
            seen["evaluate"].append(argv)
            key = "full" if "--full_int8" in argv else "trunk" if "--trunk_int8" in argv else "float"
            return np.full(20, _MAPS[key][0], np.float32), _MAPS[key][0], _MAPS[key][1], None

        def calibrate(up_to, seen=seen):
            def calib(*args, margin=1.0, **kw):
                batches = args[-1]  # the JAX package's calibrate_* take (model, variables, batches)
                seen["calib"].append((up_to, [b.shape for b in batches], int(np.asarray(batches[0]).sum()), margin))
                return {"amax_1_2": 1.5 if up_to == "trunk" else 2.5}
            return calib

        with monkeypatch.context() as m:
            for mod in (jax_eval, port_eval):
                m.setattr(mod, "main", evaluate)
            for mod in (jax_quant, port_quant):
                m.setattr(mod, "calibrate_trunk", calibrate("trunk"))
                m.setattr(mod, "calibrate_full", calibrate("full"))
            m.setattr(jax_ckpt, "load_weights", lambda path: {})
            m.setattr(int8_budget, "load_model", lambda *a: None)
            tool.stage_eval(_args(tool, base))
        res = base / "result"
        out[who] = {"seen": seen, "eval": json.loads((res / "eval.json").read_text()),
                    "quant": [(res / "detection" / f).read_text() for f in ("quant.json", "quant_full.json")]}
    assert out["port"]["seen"] == out["root"]["seen"]
    assert [len(out["port"]["seen"][k]) for k in ("evaluate", "calib")] == [3, 2]
    assert out["port"]["quant"] == out["root"]["quant"]
    root_eval, port_eval_json = out["root"]["eval"], out["port"]["eval"]
    assert {k: port_eval_json[k] for k in root_eval if k != "eval_seconds" and not isinstance(root_eval[k], dict)} \
        == {k: v for k, v in root_eval.items() if k != "eval_seconds" and not isinstance(v, dict)}
    for arm in ("int8_trunk", "full_int8"):
        assert {k: v for k, v in port_eval_json[arm].items() if k != "eval_seconds"} == \
            {k: v for k, v in root_eval[arm].items() if k != "eval_seconds"}
    assert set(port_eval_json["stages"]) == {"eval_float", "calibrate_trunk", "eval_trunk_int8", "calibrate_full",
                                             "eval_full_int8"}


def test_bridge_writes_the_root_tools_weights_file(tmp_path, monkeypatch):
    """The trunk of a seeded SSD's weights file through both bridges (the
    VGG16 base variables empty in both): the classification weights file
    byte for byte, the .pth round trip lossless."""
    import object_detection_torch2_tpu.models.vgg16 as jax_vgg16
    import tools.voc_scale_proof as root_tool
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

    class _EmptyVGG16:
        def __init__(self, *args, **kwargs):
            pass

        def init(self, *args, **kwargs):
            return {"params": {}, "batch_stats": {}}

    weights = tmp_path / "result_pre" / "detection" / "weights.msgpack"
    ckpt.save_weights(weights, SSD(seed=0))
    monkeypatch.setattr(jax_vgg16, "VGG16", _EmptyVGG16)
    monkeypatch.setattr(proof_common, "vgg16_base_variables", lambda seed=0: {"params": {}, "batch_stats": {}})
    files = {}
    for who, tool in (("root", root_tool), ("port", port_tool)):
        a = _args(tool, tmp_path, result_dir=str(tmp_path / who), pretrain_result=str(tmp_path / "result_pre"))
        tool.stage_bridge(a)
        files[who] = (tmp_path / who / "classification" / "weights.msgpack").read_bytes()
    assert files["port"] == files["root"]
    bridge = json.loads((tmp_path / "port" / "bridge.json").read_text())
    assert bridge["pth_roundtrip_lossless"] and bridge["trunk_layers"] == 26 and bridge["tensors"] > 0


# --------------------------------------------------- run_stage, for real
STAGE_LIMIT_S = 60  # each stage below ends in seconds; one that hangs fails its test, not the run


def _run_stage(*args, **kwargs) -> dict:
    """`port_tool.run_stage` with a time limit of its own: past it the test
    fails, and the stage's process (which ends by itself) is not waited for."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return pool.submit(port_tool.run_stage, *args, **kwargs).result(timeout=STAGE_LIMIT_S)
    finally:
        pool.shutdown(wait=False)


EPOCHS_THEN_HANG = textwrap.dedent("""
    import time
    block = bytearray(64 << 20)  # resident memory for the RSS poll
    time.sleep(1.0)  # the monitor's first poll lands before the kill, however loaded the host
    for e in (1, 2):
        print(f"[Epoch {e}/5] loss: 1.5, val_loss: 1.25, 10.0 img/s", flush=True)
        time.sleep(0.2)
    print("[3, 10] loss: 1.4", flush=True)
    time.sleep(60)
""")


def test_run_stage_sigkills_after_the_target_epoch(tmp_path):
    r = _run_stage("kill", ["-c", EPOCHS_THEN_HANG], tmp_path / "kill.log", kill_after_epoch=2, kill_grace_s=0.5)
    assert r["killed"] and r["returncode"] == -9 and r["seconds"] < 30
    assert [e["epoch"] for e in r["epochs"]] == [1, 2] and r["epochs"][0]["img_per_s"] == 10.0
    assert r["rss_mb"]["start"] is not None and r["rss_mb"]["max"] >= 1 and r["rss_mb_series"][0][1] >= 1
    assert r["lines_after_last_epoch"] == ["[3, 10] loss: 1.4"] and r["compile_count"] == 0
    assert "[Epoch 2/5]" in (tmp_path / "kill.log").read_text()


def test_run_stage_skips_a_reading_of_the_child_in_exec(tmp_path, monkeypatch):
    """A first RSS reading under 1 MiB (the child still in its exec, as an
    idle host's first poll finds it) is not a sample: the monitor reads
    again at once, and the series starts at the running child's RSS."""
    import io

    real_open, reads = open, []

    def first_read_in_exec(path, *args, **kwargs):
        if str(path).startswith("/proc/") and str(path).endswith("/status"):
            reads.append(path)
            if len(reads) == 1:
                return io.StringIO("Name:\tpython3\nVmRSS:\t    512 kB\n")
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(port_tool, "open", first_read_in_exec, raising=False)
    r = _run_stage("kill", ["-c", EPOCHS_THEN_HANG], tmp_path / "kill.log", kill_after_epoch=2, kill_grace_s=0.5)
    assert r["killed"] and len(reads) >= 2
    assert r["rss_mb_series"][0][1] >= 1 and r["rss_mb"]["start"] == r["rss_mb_series"][0][1]


def test_run_cli_keeps_launches_and_builds_are_listed(tmp_path, monkeypatch):
    """A CLI module run through run_cli: its kernel launch counts come back
    in the record; a library it writes under the build root is listed as a
    build after epoch 1; a stage that fails (not killed) raises."""
    from object_detection_torch2_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "fake_cli.py").write_text(textwrap.dedent(f"""
        from pathlib import Path
        from object_detection_torch2_tpu_torch.ops import nms_cuda

        def main(argv):
            print("[Epoch 1/2] loss: 2.0, val_loss: 2.5, 50.0 img/s", flush=True)
            nms_cuda.launches += int(argv[0])
            lib = Path({str(tmp_path / "_build" / "abc")!r})
            lib.mkdir(parents=True)
            (lib / "libfake.so").write_bytes(b"x")
            if argv[1:] == ["fail"]:
                raise SystemExit(3)
    """))
    env = port_tool._sub_env()
    env["PYTHONPATH"] += f":{tmp_path / 'pkg'}"
    code = "from object_detection_torch2_tpu_torch.tools.voc_scale_proof import run_cli; run_cli('fake_cli')"
    r = _run_stage("cli", ["-c", code, "7"], tmp_path / "cli.log", env=env,
                   launches_path=tmp_path / "launches.json")
    assert r["returncode"] == 0 and not r["killed"] and [e["epoch"] for e in r["epochs"]] == [1]
    assert r["launches"] == {**dict.fromkeys(proof_common.KERNELS, 0), "nms_keep_sorted": 7}
    assert [c["what"] for c in r["compiles"]] == ["built abc/libfake.so"] and r["compiles_after_epoch1"] == 1
    (tmp_path / "_build" / "abc" / "libfake.so").unlink()
    (tmp_path / "_build" / "abc").rmdir()
    with pytest.raises(RuntimeError, match="stage cli failed rc=3"):
        _run_stage("cli", ["-c", code, "1", "fail"], tmp_path / "cli.log", env=env)

"""Reference-scale dress rehearsal on the card: the flagship recipe at VOC's
true size (the port's counterpart of the repo's root tools/voc_scale_proof.py:
its stages, flags, defaults, record keys and pass rule, plus `--device`).

The reference's one published capability is 100 epochs over 16,551 train /
4,952 test images (reference: README.md:26-32,99, driven by src/train.py:14-158
-> src/evaluate.py:74-187). This runs the whole recipe at that scale:

  1. generate  the synthetic VOC tree at 16,551 train / 4,952 test images,
               all 20 classes, VOC-like objects per image (`tools.synth_voc`,
               n_classes=20, count_dist='voc'; seed 0), and a disjoint
               pretrain split (seed 11);
  2. pack      packed records of every split (`data.records.pack_voc`), and
               the host memmap rate over 64 batches of 32;
  3. pretrain  full-SSD training (`--train_trunk`) on the disjoint split:
               a trunk with useful features (the 'detection' trunk source of
               tools/pretrained_trunk_proof.py);
  4. bridge    its trunk layers over a VGG16 variable set
               (`common.detection_trunk_as_vgg16`) -> a reference-layout .pth
               -> read back bit-equal (`pretrained_trunk_proof.pth_round_trip`)
               -> result/classification/weights.msgpack, which
               `cli.common.build_ssd` seeds the detection trunk from. The
               root tool's own filter keeps conv_*/bn_* of blocks 1-5 and
               drops det_4_3, which the common one keeps; the VGG16 layout
               drops it in the round trip, so the file is the same;
  5. train     the flagship run: frozen trunk, batch 32, bfloat16,
               --steps_per_dispatch 8, --device_cache, the full state every
               epoch (--orbax_dir), SIGKILLed --kill_grace_s seconds after
               epoch max(1, int(0.4 * epochs))'s line, then resumed from the
               full state to the end;
  6. eval      `cli.evaluate --strict_ap` over all held-out images, then the
               trunk and the full model calibrated on the first 32 training
               records at margin 1.25 (`models.quant`) and evaluated with
               --trunk_int8 and --full_int8.

Every stage is a subprocess, stream-parsed by `run_stage`: per epoch the
loss, img/s and wall time, the process's RSS and (on the card) its device
memory every 10 s, and kernel builds. The training CLI runs as
`python -m` would run it, through `run_cli`, which keeps the run's
hand-written kernel launch counts in a file (twice a second and at exit). The
JAX tool counts XLA compiles after epoch 1; the port's counterpart is a
kernel build: the tool builds every kernel (`ops._build.build_all`)
before the first card stage, and any library under `_build/` built or
changed while a stage runs is listed in its record. Only the mAP decides
`passed`.

Writes proofs_torch/voc_scale.json (tools/common.py), updated after each
phase; exits non-zero if held-out parity mAP falls below --threshold.

    python -m object_detection_torch2_tpu_torch.tools.voc_scale_proof [--work_dir DIR]    # full scale
    python -m object_detection_torch2_tpu_torch.tools.voc_scale_proof --n_train 512 --n_test 96 \\
        --pretrain_n 256 --pretrain_epochs 4 --epochs 4 --kill_grace_s 1                  # smoke

The work directory holds ~7 GB of records at full scale, the JPEG trees, a
1 GB VGG16 weights file and a full state per epoch.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.tools import common

REPO = common.REPO
RECORD = "voc_scale"
JAX_RECORD = "PROOF_VOC_SCALE.json"

EPOCH_RE = re.compile(r"\[Epoch (\d+)/(\d+)\] loss: ([-\d.e+]+), val_loss: ([-\d.e+]+), ([\d.]+) img/s")
PHASES_RE = re.compile(r"phases: train ([\d.]+)s, val ([\d.]+)s, save ([\d.]+)s")
# cli/train.py's line after it restored the full state (the JAX CLI's: "Orbax state restored")
RESUME_LINE = "Full state restored (exact optimizer resume)."

TOOL = ("-m", "object_detection_torch2_tpu_torch.tools.voc_scale_proof")
TRAIN_CLI = ("-c", "from object_detection_torch2_tpu_torch.tools.voc_scale_proof import run_cli; "
                   "run_cli('object_detection_torch2_tpu_torch.cli.train')")
LAUNCHES_ENV = "VOC_SCALE_LAUNCHES"
POLL_S = 10.0  # the monitor's RSS, device memory and build polls
LAUNCHES_EVERY_S = 0.5  # run_cli's writes of the launch counts


# --------------------------------------------------------------------- stages
def stage_generate(a):
    from object_detection_torch2_tpu_torch.tools.synth_voc import generate

    generate(Path(a.data_dir), a.n_train, a.n_test, seed=0, n_classes=20,
             count_dist="voc", log_every=2000)
    generate(Path(a.pretrain_dir), a.pretrain_n, 64, seed=11, n_classes=20,
             count_dist="voc", log_every=2000)
    print("generate: done")


def stage_pack(a):
    import numpy as np

    from object_detection_torch2_tpu_torch.data import records

    res = Path(a.result_dir)
    records.pack_voc([a.data_dir], "trainval.txt", res / "rec_train", log_every=4000)
    records.pack_voc([a.data_dir], "test.txt", res / "rec_test", log_every=4000)
    records.pack_voc([a.pretrain_dir], "trainval.txt", res / "rec_pre", log_every=4000)
    records.pack_voc([a.pretrain_dir], "test.txt", res / "rec_pre_val", log_every=4000)

    # the host input pipeline's rate at scale: the streaming path's memmap
    # gather (the --device_cache runs gather on the card instead)
    ds = records.RecordDataset(res / "rec_train")
    rng = np.random.default_rng(0)
    t0 = time.time()
    n_batches, bs = 64, 32
    for _ in range(n_batches):
        idx = np.sort(rng.choice(len(ds), bs, replace=False))
        images, gts = ds.batch(idx)
        images.sum()  # touch the pages
    rate = n_batches * bs / (time.time() - t0)
    print(f"pack: host memmap pipeline {rate:.0f} img/s at {len(ds)} images")
    (res / "host_pipeline.json").write_text(json.dumps({"host_memmap_img_per_s": round(rate, 1)}))


def stage_bridge(a):
    """The pretrained trunk over VGG16 variables, round-tripped through a
    reference-layout .pth (bit-lossless, checked), saved where build_ssd's
    auto-seed reads it; writes bridge.json."""
    from object_detection_torch2_tpu_torch.models.convert import ssd_trunk_from_vgg16_variables
    from object_detection_torch2_tpu_torch.tools.pretrained_trunk_proof import pth_round_trip
    from object_detection_torch2_tpu_torch.train import checkpoint as ckpt

    t0 = time.time()
    res = Path(a.result_dir)
    ssd_vars = ckpt.load_weights(Path(a.pretrain_result) / "detection" / "weights.msgpack")
    merged = common.detection_trunk_as_vgg16(ssd_vars, common.vgg16_base_variables())
    cls_weights = res / "classification" / "weights.msgpack"
    cls_weights.parent.mkdir(parents=True, exist_ok=True)
    reimported, n_tensors = pth_round_trip(merged, cls_weights.with_suffix(".pth"))
    trunk = ssd_trunk_from_vgg16_variables(reimported)
    if not trunk["params"]:
        raise AssertionError("trunk extraction produced nothing")
    ckpt.save_weights(cls_weights, reimported)
    (res / "bridge.json").write_text(json.dumps({"pth_roundtrip_lossless": True, "tensors": n_tensors,
                                                 "trunk_layers": len(trunk["params"]),
                                                 "seconds": round(time.time() - t0, 1)}))
    print(f"bridge: torch .pth round trip lossless ({len(trunk['params'])} trunk layers, {n_tensors} tensors)")


def stage_eval(a):
    import numpy as np

    from object_detection_torch2_tpu_torch.cli import evaluate as eval_cli
    from object_detection_torch2_tpu_torch.data.records import RecordDataset
    from object_detection_torch2_tpu_torch.models import quant as quant_lib
    from object_detection_torch2_tpu_torch.tools.int8_budget import load_model

    res = Path(a.result_dir)
    device = resolve_device(a.device)
    argv = ["--records_dir", str(res / "rec_test"), "--result_dir", str(res),
            "--batch_size", "32", "--batches_per_dispatch", "4", "--strict_ap"] + common.device_flags(a.device)
    stages = common.Stages()
    t0 = time.time()
    with stages.stage("eval_float"):
        aps, mean_ap, strict_map, _ = eval_cli.main(argv)
    out = {
        "eval_seconds": round(time.time() - t0, 1),
        "parity_mAP_heldout": round(float(mean_ap), 4),
        "strict_mAP_heldout": round(float(strict_map), 4) if strict_map is not None else None,
        "per_class_AP": common.clean(aps),
    }
    (res / "eval.json").write_text(json.dumps(out))
    print(f"eval: parity mAP {mean_ap:.4f}, strict {strict_map}")

    # the int8 serving arms on all held-out images, the scales calibrated on
    # the first 32 training records at the production margin (what
    # cli.train --trunk_int8 would write)
    model = load_model(res / "detection" / "weights.msgpack", "bfloat16", device)
    calib = RecordDataset(res / "rec_train").batch(np.arange(32))[0]
    with stages.stage("calibrate_trunk"):
        quant_lib.save_quant(res / "detection" / "quant.json",
                             quant_lib.calibrate_trunk(model, [calib], margin=1.25))
    t1 = time.time()
    with stages.stage("eval_trunk_int8"):
        _, map_q, strict_q, _ = eval_cli.main(argv + ["--trunk_int8"])
    out["int8_trunk"] = {
        "parity_mAP": round(float(map_q), 4),
        "strict_mAP": round(float(strict_q), 4),
        "strict_delta_vs_float": round(float(strict_q) - float(strict_map), 4),
        "eval_seconds": round(time.time() - t1, 1),
    }
    with stages.stage("calibrate_full"):
        quant_lib.save_quant(res / "detection" / "quant_full.json",
                             quant_lib.calibrate_full(model, [calib], margin=1.25))
    t2 = time.time()
    with stages.stage("eval_full_int8"):
        _, map_fq, strict_fq, _ = eval_cli.main(argv + ["--full_int8"])
    out["full_int8"] = {
        "parity_mAP": round(float(map_fq), 4),
        "strict_mAP": round(float(strict_fq), 4),
        "strict_delta_vs_float": round(float(strict_fq) - float(strict_map), 4),
        "eval_seconds": round(time.time() - t2, 1),
    }
    out["kernel_launches"] = stages.launches()
    out["stages"] = stages.rows
    (res / "eval.json").write_text(json.dumps(out))
    print(f"eval int8: trunk parity {map_q:.4f} strict {strict_q:.4f}; "
          f"full parity {map_fq:.4f} strict {strict_fq:.4f}")


def run_cli(module: str) -> None:
    """`python -m <module> <sys.argv[1:]>` in this process, writing the
    hand-written kernels' launch counts to the file named by
    $VOC_SCALE_LAUNCHES every LAUNCHES_EVERY_S seconds and at exit: a run
    killed mid-way leaves its counts as of its last write."""
    path = os.environ.get(LAUNCHES_ENV)
    lock, stop = threading.Lock(), threading.Event()

    def dump():
        if path:
            with lock:
                Path(path + ".tmp").write_text(json.dumps(common.launch_counts()))
                os.replace(path + ".tmp", path)

    def loop():
        while not stop.wait(LAUNCHES_EVERY_S):
            dump()

    threading.Thread(target=loop, daemon=True).start()
    try:
        importlib.import_module(module).main(sys.argv[1:])
    finally:
        stop.set()
        dump()


# ----------------------------------------------------------- the stages in turn
def _sub_env():
    """The stages' environment: the repo importable, output unbuffered (the
    monitor reads each epoch line as it is printed)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    env["PYTHONUNBUFFERED"] = "1"
    return env


def kernel_libraries() -> dict:
    """{library: (bytes, mtime_ns)} of every built kernel under ops/_build."""
    from object_detection_torch2_tpu_torch.ops import _build

    root = _build.BUILD_ROOT
    out = {}
    for p in sorted(root.glob("*/lib*.so")) if root.exists() else []:
        st = p.stat()
        out[str(p.relative_to(root))] = (st.st_size, st.st_mtime_ns)
    return out


def device_memory_mb(pid: int) -> tuple:
    """(the process's device memory, the card's memory in use) in MiB as
    nvidia-smi reports them; None for what it does not report (a process it
    lists under another pid namespace, or no nvidia-smi)."""
    def query(*flags):
        try:
            return subprocess.run(["nvidia-smi", *flags, "--format=csv,noheader,nounits"], capture_output=True,
                                  text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError):
            return ""

    mine = None
    for line in query("--query-compute-apps=pid,used_memory").splitlines():
        fields = [f.strip() for f in line.split(",")]
        if len(fields) == 2 and fields[0] == str(pid) and fields[1].isdigit():
            mine = int(fields[1])
    card = query("--query-gpu=memory.used").strip().splitlines()
    return mine, int(card[0]) if card and card[0].strip().isdigit() else None


def _summary(samples: list, after: float | None) -> dict:
    """start, end and max of (t, value) samples, and their min and max over
    the samples taken after t = `after` (epoch 1's line): a process that
    stays flat after its first epoch keeps the two close. None where there
    are no samples."""
    values = [v for _, v in samples if v is not None]
    late = [v for t, v in samples if v is not None and after is not None and t > after]
    return {"start": values[0] if values else None, "end": values[-1] if values else None,
            "max": max(values) if values else None, "min_after_epoch1": min(late) if late else None,
            "max_after_epoch1": max(late) if late else None}


def run_stage(label, argv, log_path: Path, env=None, kill_after_epoch=None, kill_grace_s=25.0, gpu=False,
              launches_path: Path | None = None):
    """Run a stage subprocess (`python <argv>`); stream-parse its merged output.

    Returns {seconds, epochs: [...], compiles: [...] (kernel builds),
    rss_mb, device_mem_mb (summaries, and their (t, MiB) series every
    POLL_S; RSS from the first reading of the running child, which polls
    every 0.05 s until then), killed, returncode, launches}. With
    kill_after_epoch=E, SIGKILLs the process `kill_grace_s` seconds after
    the epoch-E summary line appears (a crash, not a clean shutdown). With
    gpu, polls the process's device memory; with launches_path, the stage
    writes its kernel launch counts there (`run_cli`)."""
    log_path.parent.mkdir(parents=True, exist_ok=True)
    print(f"--- {label}: {' '.join(map(str, argv))}", flush=True)
    env = dict(env or _sub_env())
    if launches_path is not None:
        Path(launches_path).unlink(missing_ok=True)
        env[LAUNCHES_ENV] = str(launches_path)
    libs = kernel_libraries()
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, *map(str, argv)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1, env=env)
    epochs, compiles, rss, mem_pid, mem_card, phases = [], [], [], [], [], []
    killed = threading.Event()
    kill_timer = None

    builds_lock = threading.Lock()

    def check_builds():
        with builds_lock:  # the poll thread's last check may overlap the one after exit
            now = kernel_libraries()
            for lib in sorted(k for k in now if libs.get(k) != now[k]):
                compiles.append({"t": round(time.time() - t0, 1), "after_epoch": len(epochs),
                                 "what": f"built {lib}"})
            libs.update(now)

    def poll():
        t = round(time.time() - t0, 1)
        try:
            with open(f"/proc/{proc.pid}/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        mb = int(line.split()[1]) // 1024
                        if rss or mb:  # under 1 MiB before any reading: the child is still in its exec
                            rss.append((t, mb))
                        break
        except OSError:
            pass
        if gpu:
            mine, card = device_memory_mb(proc.pid)
            mem_pid.append((t, mine))
            mem_card.append((t, card))
        check_builds()

    def poll_loop():
        while proc.poll() is None:
            poll()
            time.sleep(POLL_S if rss else 0.05)  # the first RSS reading as soon as the child runs

    threading.Thread(target=poll_loop, daemon=True).start()
    tail = []
    with open(log_path, "w") as log:
        for line in proc.stdout:
            log.write(line)
            log.flush()
            tail = (tail + [line.rstrip()])[-3:]
            p = PHASES_RE.search(line)
            if p:
                phases.append({"train_s": float(p.group(1)), "val_s": float(p.group(2)),
                               "save_s": float(p.group(3))})
            m = EPOCH_RE.search(line)
            if m:
                tail = []
                epochs.append({"epoch": int(m.group(1)), "loss": float(m.group(3)),
                               "val_loss": float(m.group(4)), "img_per_s": float(m.group(5)),
                               "t": round(time.time() - t0, 1)})
                print(f"    {label} {line.strip()}", flush=True)
                if kill_after_epoch and int(m.group(1)) >= kill_after_epoch and kill_timer is None:
                    def _kill():
                        killed.set()
                        print(f"    {label}: SIGKILL mid-run (crash simulation)", flush=True)
                        proc.send_signal(signal.SIGKILL)
                    kill_timer = threading.Timer(kill_grace_s, _kill)
                    kill_timer.daemon = True
                    kill_timer.start()
    rc = proc.wait()
    if kill_timer is not None:
        kill_timer.cancel()
    dt = time.time() - t0
    check_builds()  # builds in the last interval
    if rc != 0 and not killed.is_set():
        raise RuntimeError(f"stage {label} failed rc={rc}; see {log_path}")
    after = epochs[0]["t"] if epochs else None
    pid_known = any(v is not None for _, v in mem_pid)
    mem = mem_pid if pid_known else mem_card
    launches = None
    if launches_path is not None and Path(launches_path).exists():
        launches = json.loads(Path(launches_path).read_text())
    return {
        "seconds": round(dt, 1),
        "epochs": epochs,
        "phases": phases,
        "compiles": compiles,
        "compile_count": len(compiles),
        "compiles_after_epoch1": sum(1 for c in compiles if c["after_epoch"] >= 1),
        "rss_mb": _summary(rss, after),
        "device_mem_mb": ({**_summary(mem, after),
                           "of": "the process (nvidia-smi compute-apps)" if pid_known
                           else "the card (nvidia-smi memory.used)"} if gpu else None),
        "rss_mb_series": rss,
        "device_mem_mb_series": [(t, v) for t, v in mem if v is not None] if gpu else None,
        "killed": killed.is_set(),
        "returncode": rc,
        "lines_after_last_epoch": tail if killed.is_set() else None,
        "launches": launches,
    }


def jax_summary(epochs: int) -> dict | None:
    """The JAX package's record (PROOF_VOC_SCALE.json, its TPU run): its
    held-out mAPs at its own epoch count and at this run's, where it has
    them (after 100 epochs, and 20 in `eval_at_epoch_20`)."""
    jax = common.jax_record(JAX_RECORD)
    if jax is None:
        return None
    ev, at20 = jax.get("eval", {}), jax.get("eval_at_epoch_20", {})
    full = {"parity_mAP_heldout": ev.get("parity_mAP_heldout"), "strict_mAP_heldout": ev.get("strict_mAP_heldout"),
            "int8_trunk": ev.get("int8_trunk"), "full_int8": ev.get("full_int8")}
    by_epochs = {jax["scale"]["epochs"]: full,
                 20: {k: at20.get(k) for k in ("parity_mAP_heldout", "strict_mAP_heldout")} if at20 else None}
    return {"epochs": jax["scale"]["epochs"], "eval": full, "at_these_epochs": by_epochs.get(epochs),
            "train": {k: jax["train"].get(k) for k in ("steady_img_per_s_median", "epoch_wall_s")},
            "generate_seconds": jax.get("generate_seconds"), "pack_seconds": jax.get("pack_seconds"),
            "pretrain_seconds": jax.get("pretrain", {}).get("seconds")}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stage", default="all",
                   choices=["all", "generate", "pack", "bridge", "eval"])
    p.add_argument("--n_train", type=int, default=16551)   # reference README.md:99
    p.add_argument("--n_test", type=int, default=4952)
    p.add_argument("--pretrain_n", type=int, default=2560)
    p.add_argument("--pretrain_epochs", type=int, default=50)
    p.add_argument("--epochs", type=int, default=20, help="flagship run epochs (517 steps each at full scale)")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--steps_per_dispatch", type=int, default=8)
    p.add_argument("--train_aug", default="reduced_hue",
                   help="full augmentation path at accuracy level (hue capped: the "
                        "reference's ±0.5 full hue rotation erases synthetic color identity)")
    p.add_argument("--kill_grace_s", type=float, default=40.0,
                   help="SIGKILL this long after the target epoch's summary line (lands "
                        "mid-run at full scale; use ~1s for smoke runs)")
    p.add_argument("--threshold", type=float, default=0.45,
                   help="required held-out parity mAP (frozen-RANDOM trunk ceiling: ~0.31)")
    p.add_argument("--work_dir", default=str(Path(tempfile.gettempdir()) / "voc_scale"))
    p.add_argument("--data_dir", default=None)
    p.add_argument("--pretrain_dir", default=None)
    p.add_argument("--pretrain_result", default=None)
    p.add_argument("--result_dir", default=None)
    p.add_argument("--skip_through", default=None,
                   choices=[None, "generate", "pack", "pretrain", "bridge", "train"],
                   help="resume after a completed phase (artifacts must exist)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the training and evaluation stages; default the CUDA card, "
                        "'cpu' for the CPU")
    a = p.parse_args(argv)
    work = Path(a.work_dir)
    a.data_dir = a.data_dir or str(work / "data")
    a.pretrain_dir = a.pretrain_dir or str(work / "data_pre")
    a.pretrain_result = a.pretrain_result or str(work / "result_pre")
    a.result_dir = a.result_dir or str(work / "result")

    if a.stage != "all":
        {"generate": stage_generate, "pack": stage_pack,
         "bridge": stage_bridge, "eval": stage_eval}[a.stage](a)
        return 0

    # ---------------- the stages in turn ----------------
    device = resolve_device(a.device)  # no card, no run (unless --device cpu)
    gpu = device.type == "cuda"
    t_tool = time.time()
    work.mkdir(parents=True, exist_ok=True)
    res = Path(a.result_dir)
    logs = work / "logs_proof"
    dev = common.device_flags(a.device)
    record: dict = {
        "scale": {"train_images": a.n_train, "test_images": a.n_test,
                  "pretrain_images": a.pretrain_n,
                  "batch_size": a.batch_size, "steps_per_dispatch": a.steps_per_dispatch,
                  "steps_per_epoch": a.n_train // a.batch_size, "epochs": a.epochs,
                  "total_steps": (a.n_train // a.batch_size) * a.epochs},
        "recipe": "disjoint-split SSD pretrain -> trunk via torch .pth bridge -> "
                  "FROZEN-trunk flagship training (bs32 bf16 K=8 device_cache, full-state "
                  "kill+resume) -> full held-out eval, float and int8. Reference workflow: "
                  "README.md:26-32,99; src/train.py:14-158; src/evaluate.py:74-187",
        "train_aug": a.train_aug,
    }
    proof_path = Path(common.PROOFS_DIR) / f"{RECORD}.json"

    def checkpoint_record(phase):
        record["phase_completed"] = phase
        record["tool_seconds"] = round(time.time() - t_tool, 1)
        common.write_record(RECORD, record, echo=False)
        print(f"=== phase done: {phase} ===", flush=True)

    skip_rank = {"generate": 1, "pack": 2, "pretrain": 3, "bridge": 4, "train": 5}
    done = skip_rank.get(a.skip_through, 0)
    if done and proof_path.exists():
        prev = json.loads(proof_path.read_text())
        # keep completed phases' results but let THIS run's config describe
        # the scale (a resumed run may raise --epochs)
        prev["scale"], prev["train_aug"], prev["recipe"] = (
            record["scale"], record["train_aug"], record["recipe"])
        record = prev
    record["environment"] = common.environment(a.device)
    record["jax_record"] = jax_summary(a.epochs)

    stage_flags = ["--work_dir", a.work_dir, "--n_train", a.n_train, "--n_test", a.n_test,
                   "--pretrain_n", a.pretrain_n]

    if done < 1:
        r = run_stage("generate", [*TOOL, "--stage", "generate", *stage_flags], logs / "generate.log")
        record["generate_seconds"] = r["seconds"]
        checkpoint_record("generate")
    if done < 2:
        r = run_stage("pack", [*TOOL, "--stage", "pack", *stage_flags, "--result_dir", a.result_dir],
                      logs / "pack.log")
        record["pack_seconds"] = r["seconds"]
        record["host_pipeline"] = json.loads((res / "host_pipeline.json").read_text())
        record["records_mb"] = round(sum(f.stat().st_size for f in res.glob("rec_*/*.npy")) / 1e6)
        checkpoint_record("pack")

    # every kernel built before the first card stage: a library built or
    # changed while a stage runs shows in its record
    builds = {"libraries": None, "built_before_training": [], "seconds": 0.0}
    if gpu:
        from object_detection_torch2_tpu_torch.ops import _build

        t0 = time.time()
        builds["built_before_training"] = sorted(_build.build_all())
        builds["seconds"] = round(time.time() - t0, 1)
    builds["libraries"] = sorted(kernel_libraries())
    record["kernel_builds"] = builds

    if done < 3:
        r = run_stage("pretrain", [
            *TRAIN_CLI,
            "--records_dir", res / "rec_pre", "--val_records_dir", res / "rec_pre_val",
            "--result_dir", a.pretrain_result, "--log_dir", Path(a.pretrain_result) / "logs",
            "--epochs", a.pretrain_epochs, "--batch_size", a.batch_size,
            "--steps_per_dispatch", a.steps_per_dispatch, "--device_cache",
            "--train_trunk", "--train_aug", a.train_aug, "--val_aug", "none",
            "--gamma", "0.97", "--save_interval", "10", *dev,
        ], logs / "pretrain.log", gpu=gpu, launches_path=logs / "pretrain.launches.json")
        record["pretrain"] = {"epochs": a.pretrain_epochs, "seconds": r["seconds"],
                              "final_loss": r["epochs"][-1]["loss"] if r["epochs"] else None,
                              "final_val_loss": r["epochs"][-1]["val_loss"] if r["epochs"] else None,
                              "img_per_s_per_epoch": [e["img_per_s"] for e in r["epochs"]],
                              "rss_mb": r["rss_mb"], "device_mem_mb": r["device_mem_mb"],
                              "rss_mb_series": r["rss_mb_series"], "device_mem_mb_series": r["device_mem_mb_series"],
                              "kernel_builds": r["compiles"], "launches": r["launches"]}
        checkpoint_record("pretrain")

    if done < 4:
        run_stage("bridge", [*TOOL, "--stage", "bridge", *stage_flags,
                             "--result_dir", a.result_dir, "--pretrain_result", a.pretrain_result],
                  logs / "bridge.log")
        record["bridge"] = json.loads((res / "bridge.json").read_text())
        checkpoint_record("bridge")

    if done < 5:
        train_cmd = [
            *TRAIN_CLI,
            "--records_dir", res / "rec_train", "--val_records_dir", res / "rec_test",
            "--result_dir", a.result_dir, "--log_dir", res / "logs",
            "--epochs", a.epochs, "--batch_size", a.batch_size,
            "--steps_per_dispatch", a.steps_per_dispatch, "--device_cache",
            "--train_aug", a.train_aug, "--val_aug", "none",
            "--orbax_dir", res / "orbax", "--save_interval", "2", *dev,
            # NO --train_trunk: frozen trunk, auto-seeded from
            # result/classification/weights.msgpack (reference load order)
        ]
        kill_epoch = max(1, int(a.epochs * 0.4))
        r1 = run_stage("train(run1,killed)", train_cmd, logs / "train_run1.log",
                       kill_after_epoch=kill_epoch, kill_grace_s=a.kill_grace_s, gpu=gpu,
                       launches_path=logs / "train_run1.launches.json")
        if not r1["killed"]:
            raise AssertionError("run 1 completed before the kill fired — raise --epochs")
        resumed_from = r1["epochs"][-1]["epoch"]
        i = train_cmd.index("--epochs")
        r2 = run_stage("train(run2,resumed)", train_cmd[:i + 1] + [a.epochs - resumed_from] + train_cmd[i + 2:],
                       logs / "train_run2.log", gpu=gpu, launches_path=logs / "train_run2.launches.json")
        all_epochs = r1["epochs"] + r2["epochs"]
        run2_epochs = [e["epoch"] for e in r2["epochs"]]
        # the SIGKILL can land inside the post-epoch full-state write; its
        # temporary directory then leaves epoch resumed_from-1 as the latest
        # state, so the resume may replay epoch resumed_from
        if not (run2_epochs and run2_epochs[0] in (resumed_from, resumed_from + 1)):
            raise AssertionError(f"resume did not continue from the kill point: {run2_epochs[:3]}")
        if run2_epochs != list(range(run2_epochs[0], run2_epochs[0] + len(run2_epochs))):
            raise AssertionError(f"resumed epochs not consecutive: {run2_epochs}")
        restored = RESUME_LINE in (logs / "train_run2.log").read_text()
        if not restored:
            raise AssertionError("run 2 did not restore the full state")

        # steady-state epoch wall times (the first epoch of each run carries
        # the start-up and the device-cache upload; excluded)
        def _wall_times(run):
            es = run["epochs"]
            return [es[i]["t"] - es[i - 1]["t"] for i in range(1, len(es))]
        walls = _wall_times(r1) + _wall_times(r2)
        walls_sorted = sorted(walls)
        keys = ("seconds", "compile_count", "compiles_after_epoch1", "rss_mb", "device_mem_mb", "launches",
                "returncode", "rss_mb_series", "device_mem_mb_series")
        record["train"] = {
            "killed_after_epoch": resumed_from, "kill_was_mid_epoch": True,
            "orbax_exact_resume": restored, "resume_line": RESUME_LINE,
            "resume_first_epoch": run2_epochs[0],
            "kill_target_epoch": kill_epoch, "kill_grace_s": a.kill_grace_s,
            "run1_lines_after_last_epoch": r1["lines_after_last_epoch"],
            "run1": {k: r1[k] for k in keys},
            "run2": {k: r2[k] for k in keys},
            "epochs_completed": all_epochs[-1]["epoch"],
            "loss_curve": [e["loss"] for e in all_epochs],
            "val_loss_curve": [e["val_loss"] for e in all_epochs],
            "img_per_s_per_epoch": [e["img_per_s"] for e in all_epochs],
            "steady_img_per_s_median": sorted(e["img_per_s"] for e in all_epochs[1:])[len(all_epochs[1:]) // 2],
            "epoch_wall_s": {"median": walls_sorted[len(walls) // 2] if walls else None,
                             "min": walls_sorted[0] if walls else None,
                             "max": walls_sorted[-1] if walls else None},
            "epoch_phases_s": r1["phases"] + r2["phases"],
            "compiles": r1["compiles"] + r2["compiles"],
        }
        checkpoint_record("train")

    r = run_stage("eval", [*TOOL, "--stage", "eval", *stage_flags, "--result_dir", a.result_dir, *dev],
                  logs / "eval.log", gpu=gpu)
    record["eval"] = json.loads((res / "eval.json").read_text())
    report = sorted((res / "detection").glob("report_*.md"))
    record["eval"]["report"] = str(report[-1]) if report else None
    record["eval"]["images"] = a.n_test
    record["eval"]["stage_seconds"] = r["seconds"]
    record["eval"]["rss_mb"], record["eval"]["device_mem_mb"] = r["rss_mb"], r["device_mem_mb"]

    # each kernel's launches by stage (the training runs' from run_cli's
    # counts, run 1's as of its last write before the kill)
    by_stage = {"pretrain": record.get("pretrain", {}).get("launches"),
                "train_run1": record.get("train", {}).get("run1", {}).get("launches"),
                "train_run2": record.get("train", {}).get("run2", {}).get("launches"),
                **{k: v["launches"] for k, v in record["eval"].get("stages", {}).items()}}
    launches = {k: v for k, v in by_stage.items() if v is not None}
    record["kernel_launches"] = {"by_stage": launches,
                                 "total": {k: sum(v[k] for v in launches.values()) for k in common.KERNELS}}

    mean_ap = record["eval"]["parity_mAP_heldout"]
    tr = record.get("train", {})
    stability_ok = (tr.get("run1", {}).get("compiles_after_epoch1", 0)
                    + tr.get("run2", {}).get("compiles_after_epoch1", 0)) == 0
    record["checks"] = {
        "mAP_threshold": a.threshold,
        "mAP_ok": mean_ap >= a.threshold,
        "zero_recompiles_after_epoch1": stability_ok,
        "no_kernel_build_in_training": (tr.get("run1", {}).get("compile_count", 0)
                                        + tr.get("run2", {}).get("compile_count", 0)) == 0,
        "frozen_random_trunk_ceiling": 0.31,
    }
    record["passed"] = bool(record["checks"]["mAP_ok"])
    checkpoint_record("eval")
    print(json.dumps(record["checks"]))
    if not record["passed"]:
        print(f"FAIL: held-out parity mAP {mean_ap} < {a.threshold}", file=sys.stderr)
        return 1
    print(f"PASS: reference-scale rehearsal complete — held-out parity mAP {mean_ap}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

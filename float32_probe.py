"""Attributes the port's float32 results on the card to its convolutions,
under each candidate float32 convolution policy.

    python3 float32_probe.py [--candidates policy,cudnn,cudnn_deterministic] [--out chiprun_out/float32_probe.json]

Each candidate runs in a process of its own. A candidate other than `policy`
replaces `true_float32` in every module of the port that calls it, at the
start (and in the 2-rank CLI runs' rank processes), by a context that keeps
cuDNN on, TF32 off:
- policy: the code as it is (`true_float32`: float32 off cuDNN, PyTorch's
  own CUDA convolutions);
- cudnn: cuDNN with `deterministic=False, benchmark=False`, PyTorch's
  defaults (the port before the policy);
- cudnn_deterministic: cuDNN with `deterministic=True, benchmark=False`.

In each (all float32, read against the same model run in float64 on the card,
`dtype` switched on one set of weights):
1. per convolution of the VGG16 golden forward (goldens/vgg_forward.npz:
   batch 2, imsize 200, running and batch statistics) and of the SSD that
   the serving CLIs run (imsize 264, the fixture's four photographs, batch
   4, seed 0, running and batch statistics): the CUDA kernels of one call
   (torch.profiler), its output's max |d| against the float64 run in the
   chain (`chained`) and on the float64 run's own input (`isolated`, the
   algorithm's rounding alone), and whether the call's output equals, bit
   for bit, the two half-batch calls' outputs on the same input (`split`);
   the whole forward's outputs likewise (`forward`);
2. chip_smoke.py's `vgg_golden_readings` and `float32_cli_readings` (the
   golden forward's three cases; the evaluate and inference CLIs with
   running and batch statistics, 2 gloo ranks against one process);
3. the VGG16 trajectory replay (`chip_smoke.cls_replay`) twice: the loss
   drift against the golden, and whether the two runs' losses and trainable
   parameters are bit-equal;
4. the float32 train-mode forward of SSD300 at batch 32 (conv12 kernel on,
   no_grad, CUDA events) and a `Trainer` step at batch 32, G 64
   (`chip_smoke.step_breakdown`), in ms.

Prints one JSON line per candidate and writes them all to `--out`. Needs the
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

CANDIDATES = ("policy", "cudnn", "cudnn_deterministic")
PATCH = """
import torch
import object_detection_torch2_tpu_torch as odt
from object_detection_torch2_tpu_torch.models import ssd, vgg16
from object_detection_torch2_tpu_torch.ops import conv12
from object_detection_torch2_tpu_torch.train import trainer


def _on_cudnn(dtype=None):
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic={deterministic}, allow_tf32=False)


for _module in (odt, ssd, vgg16, conv12, trainer):
    _module.true_float32 = _on_cudnn
"""


def apply_candidate(name: str) -> str:
    """Put the candidate in place in this process; returns the code that puts
    it in place in another."""
    code = "" if name == "policy" else PATCH.format(deterministic=name == "cudnn_deterministic")
    exec(code, {})
    return code


class ConvTap:
    """Stands in for F.conv2d. In "record" mode it keeps each call's input and
    output (the float64 run); in "measure" mode it reads each call against
    the recorded one of the same index."""

    def __init__(self, real):
        self.real, self.mode, self.ref, self.rows = real, None, [], []

    def __call__(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        conv = lambda t: self.real(t, w, b, stride, padding, dilation, groups)  # noqa: E731
        y = conv(x)
        if self.mode == "record":
            self.ref.append((x, y))
        elif self.mode == "measure":
            rx, ry = self.ref[len(self.rows)]
            h = x.shape[0] // 2
            halves = torch.cat([conv(x[:h]), conv(x[h:])])
            iso = self.real(rx.to(x.dtype), w, b, stride, padding, dilation, groups)
            self.rows.append({
                "shape": [list(x.shape), list(w.shape)],
                "kernels": kernels_of(lambda: conv(x)), "half_kernels": kernels_of(lambda: conv(x[:h])),
                "chained": diff(y, ry), "isolated": diff(iso, ry), "ref_absmax": float(ry.abs().max()),
                "split_equal": bool(torch.equal(halves, y)), "split_max": diff(halves, y)})
        return y


def diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def kernels_of(fn) -> list:
    """The CUDA kernels one call of fn launches, in order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name[:120] for e in prof.events() if e.device_type == DeviceType.CUDA]


def attribute(model, x, names: list, call) -> dict:
    """Per convolution of model(x) (call(model, x) -> output), float32 against
    float64 on the same weights; the whole output's max |d| and split."""
    tap = ConvTap(F.conv2d)
    F.conv2d = tap
    try:
        with torch.no_grad():
            model.dtype, tap.mode = torch.float64, "record"
            ref = call(model, x)
            model.dtype, tap.mode = torch.float32, "measure"
            out = call(model, x)
            tap.mode = None
            h = x.shape[0] // 2
            halves = torch.cat([call(model, x[:h]), call(model, x[h:])])
    finally:
        F.conv2d = tap.real
    assert len(tap.rows) == len(names), (len(tap.rows), names)
    return {"layers": dict(zip(names, tap.rows)),
            "forward": {"max_abs": diff(out, ref), "ref_absmax": float(ref.abs().max()),
                        "split_equal": bool(torch.equal(halves, out)), "split_max": diff(halves, out)}}


def vgg_attribution(cs) -> dict:
    from object_detection_torch2_tpu_torch.models.convert import (
        vgg16_state_dict_from_jax_variables,
        vgg16_variables_from_torch,
    )
    from object_detection_torch2_tpu_torch.models.vgg16 import VGG16

    g = np.load(cs.VGG_FORWARD)
    sd = cs.synth_state_dict(cs.unpack_manifest(g["manifest_keys"], g["manifest_shapes"]), cs.synth_array)
    model = VGG16(num_classes=20)
    model.load_state_dict(vgg16_state_dict_from_jax_variables(vgg16_variables_from_torch(sd)))
    model = model.to(cs.DEVICE).eval()
    x = torch.from_numpy(np.ascontiguousarray(g["x"].transpose(0, 2, 3, 1))).to(cs.DEVICE)
    names = [n for n, _ in model.layers if n.startswith("conv_")]
    res = {mode: attribute(model, x, names, lambda m, t: m(t, train=False, use_batch_stats=mode == "batch"))
           for mode in ("running", "batch")}
    # the golden's own rounding: the float64 forward (its logits cast to float32) against it
    model.dtype, ref = torch.float64, {}
    for transfer, batch_stats, key, _ in cs.VGG_GOLDEN_CASES:
        model.transfer_learning = transfer
        with torch.no_grad():
            ref[key] = float(np.abs(model(x, train=False, use_batch_stats=batch_stats).cpu().numpy() - g[key]).max())
    model.dtype = torch.float32
    res["golden_vs_float64"] = ref
    return res


def ssd_attribution(cs) -> dict:
    from object_detection_torch2_tpu_torch.data.voc import PascalVOCDataset
    from object_detection_torch2_tpu_torch.models.ssd import DETECTOR_TAPS, LAYER_SPECS, SSD

    ds = PascalVOCDataset("detection", [cs.FIXTURE], "test.txt", cs.MOVED_IMSIZE)
    x = torch.from_numpy(np.stack([ds[i][0] for i in range(4)])).to(cs.DEVICE).float() / 255.0
    model = SSD(num_classes=21, seed=0).to(cs.DEVICE).eval()
    names = [f"conv_{s[0]}" for s in LAYER_SPECS] + [f"det_{s}" for s, _ in DETECTOR_TAPS]
    return {mode: attribute(model, x, names, lambda m, t: m(t, use_batch_stats=mode == "batch"))
            for mode in ("running", "batch")}


def replays(cs) -> dict:
    from object_detection_torch2_tpu_torch.models.convert import vgg16_variables_from_torch

    g = np.load(cs.CLS_TRAJECTORY)
    variables = vgg16_variables_from_torch(cs.synth_state_dict(
        cs.unpack_manifest(g["manifest_keys"], g["manifest_shapes"]), cs.synth_array_scaled))
    a = cs.cls_replay(g, variables)
    b = cs.cls_replay(g, variables)
    drift = lambda r: float((np.abs(np.array(r["losses"]) - g["losses"]) / np.abs(g["losses"])).max())  # noqa: E731
    return {"losses_equal": a["losses"] == b["losses"],
            "params_equal": all(torch.equal(p, b["state"].trainable[k]) for k, p in a["state"].trainable.items()),
            "drift": [drift(a), drift(b)], "replay_s": [a["replay_s"], b["replay_s"]]}


def costs(cs) -> dict:
    from object_detection_torch2_tpu_torch.core.anchors import default_boxes
    from object_detection_torch2_tpu_torch.models.ssd import SSD
    from object_detection_torch2_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (cs.BATCH, cs.IMSIZE, cs.IMSIZE, 3), dtype=np.uint8)
    x = torch.from_numpy(images).to(cs.DEVICE).float() / 255.0
    model = SSD(num_classes=21, seed=0, conv12_kernel=True).to(cs.DEVICE).train()
    with torch.no_grad():
        forward_ms = cs.time_ms(lambda: model(x), reps=5, trials=3)
    targets = cs.synth_targets(rng, cs.BATCH, rng.integers(1, cs.G_PAD + 1, cs.BATCH), cs.G_PAD)
    trainer = Trainer(SSD(num_classes=21, seed=0, conv12_kernel=True), default_boxes=default_boxes(),
                      device=cs.DEVICE)
    state = trainer.init_state(lambda ps: torch.optim.Adam(ps, lr=1e-4))
    step = cs.step_breakdown(state, trainer.default_boxes, images, targets)
    return {"forward_ms_bs32": forward_ms, "train_step": step}


def one(name: str, out: Path):
    rank_code = apply_candidate(name) + "\n"
    import chip_smoke as cs
    from object_detection_torch2_tpu_torch.ops import _build

    _build.build_all()
    cs.FIDELITY_RANK = rank_code + cs.FIDELITY_RANK
    t0 = time.perf_counter()
    from object_detection_torch2_tpu_torch.models import ssd

    with ssd.true_float32(torch.float32):
        flags = {k: getattr(torch.backends.cudnn, k) for k in ("enabled", "benchmark", "deterministic")}
    res = {"candidate": name, "card": cs.card_line(), "torch": torch.__version__, "float32_flags": flags}
    res["vgg"] = vgg_attribution(cs)
    res["ssd"] = ssd_attribution(cs)
    res["golden"] = cs.vgg_golden_readings()
    with tempfile.TemporaryDirectory() as tmp:
        res["cli"] = cs.float32_cli_readings(Path(tmp))
    res["replays"] = replays(cs)
    res["costs"] = costs(cs)
    res["seconds"] = time.perf_counter() - t0
    out.write_text(json.dumps(res))


def summary(r: dict) -> str:
    """A candidate's readings in a few lines: per convolution chained /
    isolated max |d|, split equality and the first kernel's name."""
    from chip_smoke import same_aps

    if "rc" in r:
        return f"{r['candidate']}: failed, rc {r['rc']}"
    lines = [f"== {r['candidate']} {r['float32_flags']} ({r['card']}, {r['seconds']:.0f} s)"]
    lines.append(f"vgg golden against the float64 forward: {r['vgg'].get('golden_vs_float64')}")
    for model in ("vgg", "ssd"):
        for mode in ("running", "batch"):
            a = r[model][mode]
            lines.append(f"{model} {mode}: forward max |d| {a['forward']['max_abs']:.3g} of {a['forward']['ref_absmax']:.3g}, "
                         f"split equal {a['forward']['split_equal']} ({a['forward']['split_max']:.3g})")
            for name, row in a["layers"].items():
                lines.append(f"  {name}: chained {row['chained']:.3g} isolated {row['isolated']:.3g} of "
                             f"{row['ref_absmax']:.3g}; split {row['split_equal']} ({row['split_max']:.3g}); "
                             f"{row['kernels'][:2]} | half {row['half_kernels'][:2]}")
    lines.append(f"golden {[(g['key'], round(g['max_abs'], 5), g['atol'], g['over']) for g in r['golden']]}")
    for mode, ev in r["cli"]["evaluate"].items():
        lines.append(f"evaluate ({mode}) equal {same_aps(ev['one'], ev['two'])}: one {ev['one']} two {ev['two']}")
    lines.append(f"pngs {r['cli']['pngs']}")
    lines.append(f"replays {r['replays']}; costs {r['costs']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--candidates", default=",".join(CANDIDATES))
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/float32_probe.json"))
    ap.add_argument("--one", choices=CANDIDATES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("float32_probe: no CUDA device is available")
    if args.one:
        one(args.one, args.out)
        return 0
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.candidates.split(","):
            path = Path(tmp) / f"{name}.json"
            rc = subprocess.call([sys.executable, __file__, "--one", name, "--out", str(path)],
                                 cwd=Path(__file__).resolve().parent)
            got = json.loads(path.read_text()) if rc == 0 and path.exists() else {"candidate": name, "rc": rc}
            print(summary(got), flush=True)
            results.append(got)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    return 0 if all("rc" not in r for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())

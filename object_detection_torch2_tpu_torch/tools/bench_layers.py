"""Per-layer time of the SSD300 train-mode forward on the card (the port's
counterpart of the repo's root tools/bench_layers.py: its prefix table, its
differencing and its JSON line, plus `--dtype`, `--trunk_int8`, `--profile`
and `--device`).

    python -m object_detection_torch2_tpu_torch.tools.bench_layers [--batch_size 32] [--iters 30]
        [--dtype bfloat16|float32] [--trunk_int8] [--profile] [--out PATH] [--device cpu]

The model is `SSD(num_classes=21, conv12_kernel=True)` with seed-0 weights,
as `Trainer` runs it: training mode, batch statistics (the running
statistics move), under `torch.no_grad()`, on seeded uint8 images (N, 300,
300, 3) scaled by 1/255 once. The forward is truncated after each layer
(`SSD.forward(up_to=layer)`) and the marginal of a layer is the difference of
two successive prefixes, so each layer is timed in its real context. The
last prefix is the whole forward (heads + concat).

Two columns, each `(t_2k - t_k) / k` over k = `--iters` and 2k forwards,
the best of 3 of each, so that constant costs cancel:
- graph: the prefix's forward captured once in a CUDA graph (after warm-up
  on a side stream) and replayed between CUDA events: the card's own time.
  The capture takes the image normalization's two constants from the card
  (`constants_on_card`: the same values and ops, no host copy), and the
  graph's output is held against an eager call's. Each graph and its
  memory pool are freed before the next capture. A
  prefix that cannot be captured is reported with the error, and its graph
  column stays empty: eager time is never reported as graph time;
- eager: the same forward called k and 2k times between CUDA events. A
  layer whose eager marginal is well above its graph marginal is bound by
  the host's enqueue.

Per layer: the conv's useful GFLOP (dense, the root tool's `conv_gflop`;
conv_1_2 dense, factor 1), its bytes (input read once, output written once,
weights, in the layer's dtype; an int8 layer reads int8 and int8 weights and
writes the model's dtype), its bound (the larger of FLOP over the peak of
its type and bytes over the memory rate; the H100 SXM data sheet: 989 TFLOP/s
bfloat16, 67 TFLOP/s float32 with TF32 off, 1,979 TOP/s int8, 3.35 TB/s),
and `roofline_pct`, the bound's share of the graph marginal. The heads row
counts the six heads' convs and the float32 concat written once.

`--profile` traces one eager forward of every prefix with torch.profiler
(each under a `prefix:<layer>` annotation) and lists, per layer, the ops and
CUDA kernels that prefix adds to the one before it (eager launch order is
deterministic), with their device ms, each op put in one of: input, conv,
quantize, bn_stats, bn_apply, relu, pool, other (`op_categories`, from the op
order of models/ssd.py and models/bn.py). On the CPU it reports the ops' CPU
ms instead.

`--trunk_int8` runs blocks 2-5 on the int8 kernels with scales calibrated on
8 seeded batches of the run's size with margin 1.25 (the training CLI's
--calib_batches and --calib_margin defaults), activations quantized by the
reciprocal of the scale, as `Trainer(quant=)` sets it.

Prints each prefix's cumulative ms (stderr), one JSON line
`{"batch_size", "forward_ms", "layers": [...], ...}` with the card's name
and power limit and the conv12 kernel's launches over the run (stdout), and
a table (stderr). `--out` also writes the whole record (with every profiled
kernel) as JSON. Runs on the CUDA card unless `--device cpu` is given; it
raises without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from object_detection_torch2_tpu_torch import resolve_device
from object_detection_torch2_tpu_torch.data.augment import to_tensor_batch
from object_detection_torch2_tpu_torch.models import quant as quant_lib
from object_detection_torch2_tpu_torch.models import ssd
from object_detection_torch2_tpu_torch.models.ssd import DETECTOR_TAPS, LAYER_SPECS, SSD
from object_detection_torch2_tpu_torch.ops import conv12_cuda
from object_detection_torch2_tpu_torch.tools.common import card_line

IMSIZE = 300
NUM_CLASSES = 21
# H100 SXM data-sheet peaks: memory bytes/s, and dense operations/s of each type
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
CALIB_BATCHES, CALIB_MARGIN = 8, 1.25  # cli.train's --calib_batches and --calib_margin defaults
WARMUP, TRIALS = 3, 3

# (prefix, H_out, W_out, C_in, C_out, k, flop_factor): the root tool's table.
# H/W are the conv's OUTPUT grid. conv_1_2 runs dense here (the TPU's
# staggered 4/3 layout is not ported), so its factor is 1.
PREFIXES = [
    ("1_1", 300, 300, 3, 64, 3, 1.0),
    ("1_2", 300, 300, 64, 64, 3, 1.0),        # incl. pool_1
    ("2_1", 150, 150, 64, 128, 3, 1.0),
    ("2_2", 150, 150, 128, 128, 3, 1.0),      # incl. pool_2
    ("3_1", 75, 75, 128, 256, 3, 1.0),
    ("3_2", 75, 75, 256, 256, 3, 1.0),
    ("3_3", 75, 75, 256, 256, 3, 1.0),        # incl. pool_3 (M_P -> 38)
    ("4_1", 38, 38, 256, 512, 3, 1.0),
    ("4_2", 38, 38, 512, 512, 3, 1.0),
    ("4_3", 38, 38, 512, 512, 3, 1.0),        # incl. pool_4
    ("5_1", 19, 19, 512, 512, 3, 1.0),
    ("5_2", 19, 19, 512, 512, 3, 1.0),
    ("5_3", 19, 19, 512, 512, 3, 1.0),
    ("6_1", 19, 19, 512, 1024, 3, 1.0),
    ("7_1", 19, 19, 1024, 1024, 1, 1.0),
    ("8_1", 19, 19, 1024, 256, 1, 1.0),
    ("8_2", 10, 10, 256, 512, 3, 1.0),        # stride 2
    ("9_1", 10, 10, 512, 128, 1, 1.0),
    ("9_2", 5, 5, 128, 256, 3, 1.0),          # stride 2
    ("10_1", 5, 5, 256, 128, 1, 1.0),
    ("10_2", 3, 3, 128, 256, 3, 1.0),         # VALID
    ("11_1", 3, 3, 256, 128, 1, 1.0),
    ("11_2", 1, 1, 128, 256, 3, 1.0),         # VALID
    (None, 0, 0, 0, 0, 0, 1.0),               # full forward (heads + concat)
]
HEADS = "heads+concat"


def conv_gflop(n, h, w, cin, cout, k, factor):
    return 2.0 * n * h * w * k * k * cin * cout * factor / 1e9


def layer_inputs(imsize: int = IMSIZE) -> dict:
    """{layer: (H_in, W_in)} of every conv of the trunk and extras: the
    previous layer's output after its pool (models/ssd.py's LAYER_SPECS)."""
    out, h = {}, imsize
    for suffix, _, _, k, stride, pad, pool in LAYER_SPECS:
        out[suffix] = (h, h)
        h = (h + 2 * pad - k) // stride + 1
        if pool == "M":
            h //= 2
        elif pool == "M_P":
            h = h // 2 + 1
    return out


def layer_work(n: int, dtype: str, int8_layers=()) -> list:
    """Per row of PREFIXES: {layer, gflop, bytes, bound_ms, bound_by}; an
    int8 layer (in `int8_layers`) counts int8 operations at the int8 peak,
    int8 input and weights, and its output in `dtype`."""
    size = {"bfloat16": 2, "float32": 4}[dtype]
    inputs = layer_inputs()
    rows, couts = [], {}
    for name, h, w, cin, cout, k, factor in PREFIXES:
        if name is None:
            gflop, nbytes, anchors_total = 0.0, 0.0, 0
            for tap, anchors in DETECTOR_TAPS:
                th, tcin = couts[tap]
                tcout = anchors * (NUM_CLASSES + 4)
                gflop += conv_gflop(n, th, th, tcin, tcout, 3, 1.0)
                nbytes += (n * th * th * (tcin + tcout) + 9 * tcin * tcout) * size
                anchors_total += th * th * anchors
            nbytes += n * anchors_total * (NUM_CLASSES + 4) * 4  # the float32 concat
            name, peak = HEADS, PEAK_OPS_PER_S[dtype]
        else:
            couts[name] = (h, cout)
            gflop = conv_gflop(n, h, w, cin, cout, k, factor)
            hi, wi = inputs[name]
            int8 = name in int8_layers
            in_size = 1 if int8 else size
            nbytes = n * hi * wi * cin * in_size + n * h * w * cout * size + k * k * cin * cout * in_size
            peak = PEAK_OPS_PER_S["int8" if int8 else dtype]
        ops_ms, bytes_ms = gflop * 1e9 / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append({"layer": name, "gflop": gflop, "bytes": int(nbytes), "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"})
    return rows


def marginals(cumulative: list) -> list:
    """Successive differences of cumulative prefix times; None where a
    prefix or the one before it has no time."""
    out, prev = [], 0.0
    for ms in cumulative:
        out.append(None if ms is None or prev is None else ms - prev)
        prev = ms
    return out


def layer_rows(n: int, dtype: str, graph_cum: list, eager_cum: list, int8_layers=()) -> list:
    """The per-layer rows of the JSON line: the graph and eager marginals
    beside the layer's work, bound and the bound's share of the graph
    marginal."""
    rows = []
    for work, g, e, gc, ec in zip(layer_work(n, dtype, int8_layers), marginals(graph_cum), marginals(eager_cum),
                                  graph_cum, eager_cum):
        ok = g is not None and g > 0
        rows.append({**work, "marginal_ms": g, "eager_marginal_ms": e,
                     "tflops": work["gflop"] / g if ok else None,
                     "roofline_pct": 100.0 * work["bound_ms"] / g if ok else None,
                     "cumulative_ms": gc, "eager_cumulative_ms": ec})
    return rows


def _best_ms(run, k: int, device) -> float:
    """The best of TRIALS wall times (ms) of run(k): CUDA events on the card,
    the host clock on the CPU."""
    best = float("inf")
    for _ in range(TRIALS):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(k)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run(k)
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def differenced_ms(run, iters: int, device) -> float:
    """(t_2k - t_k) / k for k = iters: the time of one more call of what
    run(k) repeats k times, with constant costs cancelled."""
    return (_best_ms(run, 2 * iters, device) - _best_ms(run, iters, device)) / iters


def eager_ms(fn, iters: int, device) -> float:
    """One eager call of `fn`, differenced over iters and 2 * iters calls."""
    for _ in range(WARMUP):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def run(k):
        for _ in range(k):
            fn()

    return differenced_ms(run, iters, device)


@contextmanager
def constants_on_card(device):
    """models/ssd.py's `normalize_image` with its mean and 1/std made once on
    `device`: the same float32 values and the same ops, without the two
    copies from pageable host memory that each call makes, which CUDA graph
    capture refuses."""
    mean = torch.tensor(ssd.IMAGENET_MEAN, dtype=torch.float32).to(device)
    inv_std = (1.0 / torch.tensor(ssd.IMAGENET_STD, dtype=torch.float32)).to(device)

    def normalize(x):
        return (x.to(torch.float32) - mean) * inv_std

    saved = ssd.normalize_image
    ssd.normalize_image = normalize
    try:
        yield
    finally:
        ssd.normalize_image = saved


def graph_ms(fn, iters: int, device):
    """(ms, output) of one replay of `fn` captured in a CUDA graph,
    differenced over iters and 2 * iters replays; the graph and its memory
    pool are freed on return. Raises where the capture fails."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    try:
        with constants_on_card(device), torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize(device)

        def run(k):
            for _ in range(k):
                graph.replay()

        ms = differenced_ms(run, iters, device)
        return ms, out.to(torch.float32, copy=True)  # out of the graph's pool, freed below
    finally:
        torch.cuda.synchronize(device)
        graph.reset()
        del graph
        torch.cuda.empty_cache()


# op names of models/ssd.py's forward, by the part of a layer they belong to
CONV_OPS = ("aten::conv2d", "odt::conv12", "odt::int8_conv")


def op_categories(names: list) -> list:
    """The part of a layer each of its top-level ops (in launch order)
    belongs to, read from the op order of models/ssd.py and models/bn.py:
    up to the image's permute 'input'; the casts and the conv 'conv';
    `odt::quantize_act` 'quantize'; between the conv and the ReLU, BatchNorm:
    up to the op after its last rsqrt (inv = rsqrt(var + eps) * weight)
    'bn_stats', the rest 'bn_apply'; 'relu'; the max pool 'pool'; anything
    else 'other' (the heads' reshapes and the concat)."""
    cats = ["other"] * len(names)
    permute = names.index("aten::permute") if "aten::permute" in names else -1
    convs = [i for i, n in enumerate(names) if n in CONV_OPS]
    if convs and permute < convs[0]:
        cats[:permute + 1] = ["input"] * (permute + 1)
    start = permute + 1 if convs and permute < convs[0] else 0
    for c in convs:
        for i in range(start, c + 1):
            cats[i] = "quantize" if names[i] == "odt::quantize_act" else "conv"
        start = c + 1
        relu = next((i for i in range(c + 1, len(names)) if names[i] == "aten::relu"), None)
        if relu is None:
            continue
        rsqrt = [i for i in range(c + 1, relu) if names[i] == "aten::rsqrt"]
        split = rsqrt[-1] + 2 if rsqrt else c + 1
        for i in range(c + 1, relu):
            cats[i] = "bn_stats" if i < split else "bn_apply"
        cats[relu] = "relu"
        for i in range(relu + 1, len(names)):
            if names[i] == "aten::max_pool2d":
                cats[i] = "pool"
        start = relu + 1
    return cats


def _subtree_kernels(evt) -> list:
    found = list(evt.kernels)
    for child in evt.cpu_children:
        found += _subtree_kernels(child)
    return found


def profile_prefixes(prefix_fns: list, device) -> list:
    """Per prefix (name, fn): its top-level ops in order as (op name, [(kernel,
    device ms)], ms): one eager forward each, under a `prefix:<name>`
    annotation in one torch.profiler trace. ms is the kernels' device time on
    the card, the op's CPU time on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    for _, fn in prefix_fns:
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for name, fn in prefix_fns:
            with record_function(f"prefix:{name}"):
                fn()
            if cuda:
                torch.cuda.synchronize(device)
    # the annotations' host-side events (on the card each also has a device-side twin)
    marks = {e.name: e for e in prof.events() if e.name.startswith("prefix:") and e.device_type == DeviceType.CPU}
    out = []
    for name, _ in prefix_fns:
        ops = []
        for op in sorted(marks[f"prefix:{name}"].cpu_children, key=lambda e: e.time_range.start):
            kernels = [(k.name, k.duration / 1e3) for k in _subtree_kernels(op)]
            ms = sum(d for _, d in kernels) if cuda else op.cpu_time_total / 1e3
            ops.append((op.name, kernels, ms))
        out.append(ops)
    return out


def layer_profile(prefix_ops: list, names: list) -> list:
    """Per layer: the ops its prefix adds to the one before (the trailing
    NHWC permute of a truncated forward left out), each with its category,
    kernels and ms, and the ms summed by category. `consistent` says whether
    the previous prefix's ops are the first ops of this one."""
    rows, prev = [], []
    for name, ops in zip(names, prefix_ops):
        ops = list(ops)
        if name != HEADS and ops and ops[-1][0] == "aten::permute":
            ops = ops[:-1]
        consistent = [o[0] for o in ops[:len(prev)]] == [o[0] for o in prev]
        own = ops[len(prev):]
        cats = op_categories([o[0] for o in own])
        by_cat = {}
        for cat, (_, _, ms) in zip(cats, own):
            by_cat[cat] = by_cat.get(cat, 0.0) + ms
        rows.append({"layer": name, "consistent": consistent, "by_category_ms": by_cat,
                     "ms": sum(by_cat.values()),
                     "ops": [{"op": op, "category": cat, "ms": ms,
                              "kernels": [{"name": k, "ms": d} for k, d in kernels]}
                             for cat, (op, kernels, ms) in zip(cats, own)]})
        prev = ops
    return rows


def calibrated_scales(model, n: int, device) -> dict:
    """The int8 trunk's {amax_<layer>: float}: abs-max calibration on
    CALIB_BATCHES seeded uint8 batches of n images, margin CALIB_MARGIN."""
    rng = np.random.default_rng(1)
    batches = (rng.integers(0, 256, (n, IMSIZE, IMSIZE, 3), dtype=np.uint8) for _ in range(CALIB_BATCHES))
    return quant_lib.calibrate_trunk(model, batches, margin=CALIB_MARGIN)


def build(n: int, dtype: str, trunk_int8: bool, device):
    """(model, x): the seeded SSD as Trainer runs it, in training mode, and
    the seeded images in [0, 1] on `device`."""
    model = SSD(num_classes=NUM_CLASSES, dtype=getattr(torch, dtype), seed=0, conv12_kernel=True).to(device)
    if trunk_int8:
        model.set_quant(calibrated_scales(model, n, device))
        model.trunk_int8 = True
        model.quant_reciprocal = True
    model.train()
    images = np.random.default_rng(0).integers(0, 255, (n, IMSIZE, IMSIZE, 3)).astype(np.uint8)
    return model, to_tensor_batch(torch.from_numpy(images).to(device))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    parser.add_argument("--trunk_int8", action="store_true")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--out", type=Path, default=None, help="also write the whole record here as JSON")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; default the CUDA card (raises without one), 'cpu' for the CPU")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    n = args.batch_size
    kernel = conv12_cuda.KERNEL_OF[getattr(torch, args.dtype)]
    launches0 = conv12_cuda.kernel_launches[kernel]
    model, x = build(n, args.dtype, args.trunk_int8, device)
    int8_layers = [s for s, *_ in LAYER_SPECS if model._int8_layer(s)]
    print(f"device={device} bs={n} dtype={args.dtype} trunk_int8={args.trunk_int8} iters={args.iters}",
          file=sys.stderr, flush=True)

    names = [p[0] or HEADS for p in PREFIXES]
    prefix_fns = [(name, (lambda up_to=p[0]: model(x, use_batch_stats=True, up_to=up_to)))
                  for name, p in zip(names, PREFIXES)]
    graph_cum, eager_cum, failures, graph_vs_eager = [], [], {}, {}
    with torch.no_grad():
        for name, fn in prefix_fns:
            g = None
            if device.type == "cuda":
                try:
                    g, out = graph_ms(fn, args.iters, device)
                    graph_vs_eager[name] = (out - fn().float()).abs().max().item()
                except Exception as e:  # reported by prefix; the eager column still runs
                    failures[name] = f"{type(e).__name__}: {e}"
            e = eager_ms(fn, args.iters, device)
            graph_cum.append(g)
            eager_cum.append(e)
            print(f"prefix {name:>12}: cumulative graph {'-' if g is None else f'{g:8.3f}'} ms, "
                  f"eager {e:8.3f} ms", file=sys.stderr, flush=True)
        profile = layer_profile(profile_prefixes(prefix_fns, device), names) if args.profile else None

    rows = layer_rows(n, args.dtype, graph_cum, eager_cum, int8_layers)
    graph_sum = sum(r["marginal_ms"] for r in rows) if all(r["marginal_ms"] is not None for r in rows) else None
    record = {"batch_size": n, "forward_ms": graph_cum[-1], "forward_eager_ms": eager_cum[-1],
              "marginals_sum_ms": graph_sum, "layers": rows, "dtype": args.dtype, "trunk_int8": args.trunk_int8,
              "iters": args.iters, "device": str(device), "card": card_line() if device.type == "cuda" else None,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "conv12_kernel": kernel, "conv12_launches": conv12_cuda.kernel_launches[kernel] - launches0,
              "capture_failures": failures, "graph_vs_eager_max_abs": graph_vs_eager}
    if profile is not None:
        record["profile"] = profile
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    line = dict(record)
    if profile is not None:  # the line keeps each layer's split; --out keeps every kernel
        line["profile"] = {p["layer"]: p["by_category_ms"] for p in profile}
    print(json.dumps(line))
    print_table(record)
    return record


def print_table(record: dict) -> None:
    def f(v, spec):
        return "-" if v is None else format(v, spec)

    print(f"\n{record['card']} {record['dtype']} bs={record['batch_size']}", file=sys.stderr)
    print(f"{'layer':>12} {'graph ms':>9} {'eager ms':>9} {'GFLOP':>8} {'MB':>8} {'bound ms':>9} {'by':>10} "
          f"{'roofline%':>9}", file=sys.stderr)
    for r in record["layers"]:
        print(f"{r['layer']:>12} {f(r['marginal_ms'], '9.3f')} {f(r['eager_marginal_ms'], '9.3f')} "
              f"{r['gflop']:8.1f} {r['bytes'] / 1e6:8.1f} {r['bound_ms']:9.4f} {r['bound_by']:>10} "
              f"{f(r['roofline_pct'], '9.1f')}", file=sys.stderr)
    for name, why in record["capture_failures"].items():
        print(f"prefix {name}: not captured in a CUDA graph ({why}); eager column only", file=sys.stderr)
    for p in record.get("profile") or ():
        split = ", ".join(f"{k} {v:.3f}" for k, v in p["by_category_ms"].items())
        print(f"{p['layer']:>12}: {split}{'' if p['consistent'] else ' (prefix ops differ)'}", file=sys.stderr)
        for op in p["ops"]:
            for k in op["kernels"]:
                print(f"{'':>14}{op['category']:>9} {k['ms']:8.4f} {op['op']} {k['name'][:90]}", file=sys.stderr)


if __name__ == "__main__":
    main()

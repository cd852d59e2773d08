"""Tracing and profiling hooks
(counterpart of object_detection_torch2_tpu/utils/profiling.py:21-78).

The reference's only observability is tqdm running-loss bars (reference:
src/train.py:105-108) plus `torch.autograd.set_detect_anomaly(True)`
(train.py:102). Here:

- `maybe_trace`: a `torch.profiler` trace of a region (CPU and, on a card,
  CUDA activity), exported as a Chrome trace into a directory;
- `ThroughputMeter`: images/sec counters with no device synchronization on
  the hot path (a copy of the JAX package's);
- `enable_debug_nans`: torch's anomaly detection, the counterpart of
  `jax_debug_nans`/`jax_debug_infs` (the training CLI also raises on a
  non-finite loss with it on; large overhead, off by default).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def maybe_trace(log_dir: str | None):
    """Trace the region with torch.profiler when log_dir is set, and write
    `<log_dir>/trace.json` (Chrome trace format) when it ends."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def enable_debug_nans(enabled: bool = True):
    """torch detect_anomaly: the backward raises where it produces NaN."""
    torch.autograd.set_detect_anomaly(enabled)


class ThroughputMeter:
    """Images/sec (per chip) without forcing device syncs inside the step loop.

    `clock` is injectable (tests use a fake) so the two rate accessors can be
    validated deterministically; each accessor reads the clock once, so callers
    that need mutually consistent total/per-chip rates should take one
    `rates()` snapshot rather than two separate live reads.
    """

    def __init__(self, batch_size: int, num_devices: int = 1, clock=time.perf_counter):
        self.batch_size = batch_size
        self.num_devices = num_devices
        self._clock = clock
        self.reset()

    def reset(self):
        self._start = self._clock()
        self._steps = 0

    def step(self, n: int = 1):
        self._steps += n

    @property
    def steps(self) -> int:
        return self._steps

    def images_per_sec(self) -> float:
        dt = self._clock() - self._start
        return self._steps * self.batch_size / dt if dt > 0 else 0.0

    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec() / max(self.num_devices, 1)

    def rates(self) -> tuple[float, float]:
        """(total, per-chip) images/sec from ONE clock read — exactly
        proportional by construction, unlike two live accessor calls."""
        total = self.images_per_sec()
        return total, total / max(self.num_devices, 1)

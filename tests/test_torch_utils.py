"""The port's utils/tb.py and utils/profiling.py against the JAX package's on
the CPU: the event file byte for byte, the throughput meter on a fake clock,
the trace and the anomaly switch."""

import json
import struct

import numpy as np
import pytest
import torch

from object_detection_torch2_tpu.utils import profiling as jax_profiling
from object_detection_torch2_tpu.utils import tb as jax_tb
from object_detection_torch2_tpu_torch.utils import profiling, tb

torch.set_num_threads(1)


def _write_events(module, log_dir, monkeypatch):
    clock = iter(np.arange(1.7e9, 1.7e9 + 100, 0.25))
    monkeypatch.setattr(module.time, "time", lambda: float(next(clock)))
    monkeypatch.setattr(module.socket, "gethostname", lambda: "host-a")
    monkeypatch.setattr(module.os, "getpid", lambda: 4242)
    writer = module.SummaryWriter(log_dir=str(log_dir))
    for epoch in range(1, 4):
        writer.add_scalar("loss/train", 10.0 / epoch, epoch)
        writer.add_scalar("loss/validation", 12.5 / epoch, epoch)
        writer.add_scalar("lr", 1e-3 * 0.95 ** (epoch - 1), epoch)
    writer.close()
    files = list(log_dir.iterdir())
    assert len(files) == 1
    return files[0]


def test_event_file_bytes_equal_jax_writer(tmp_path, monkeypatch):
    ours = _write_events(tb, tmp_path / "port", monkeypatch)
    theirs = _write_events(jax_tb, tmp_path / "jax", monkeypatch)
    assert ours.name == theirs.name == "events.out.tfevents.1700000000.host-a.4242.0"
    assert ours.read_bytes() == theirs.read_bytes()


def read_records(path):
    """TFRecord frames of an event file, each length and payload checked
    against its masked crc32c."""
    data, out, pos = path.read_bytes(), [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == tb._masked_crc(header)
        payload = data[pos + 12:pos + 12 + length]
        assert struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])[0] == tb._masked_crc(payload)
        out.append(payload)
        pos += 16 + length
    return out


def test_event_records_and_crcs(tmp_path, monkeypatch):
    records = read_records(_write_events(tb, tmp_path, monkeypatch))
    assert len(records) == 1 + 9
    assert b"brain.Event:2" in records[0]
    assert b"loss/train" in records[1] and b"loss/validation" in records[2] and b"lr" in records[3]
    assert tb.crc32c(b"123456789") == 0xE3069283  # the Castagnoli check value


def test_throughput_meter_matches_jax_on_a_fake_clock():
    ticks = [0.0, 0.5, 2.0, 2.0, 3.0, 7.5]
    ours = profiling.ThroughputMeter(32, 4, clock=iter(ticks).__next__)
    theirs = jax_profiling.ThroughputMeter(32, 4, clock=iter(ticks).__next__)
    got, want = [], []
    for meter, out in ((ours, got), (theirs, want)):
        meter.step(3)
        out.append(meter.images_per_sec())
        meter.step()
        out.append(meter.images_per_sec_per_chip())
        out.append(meter.rates())
        meter.reset()
        out.append((meter.steps, meter.images_per_sec()))
    assert got == want
    assert got[0] == 3 * 32 / 0.5


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_enable_debug_nans_switches_anomaly_detection():
    try:
        profiling.enable_debug_nans()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(UserWarning, match="Error detected"):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()

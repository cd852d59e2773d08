"""Minimal, dependency-free TensorBoard scalar writer
(copy of object_detection_torch2_tpu/utils/tb.py:1-120).

The reference logs per-epoch scalars `loss/train`, `loss/validation`, `lr` via
torch's SummaryWriter (reference: src/train.py:99, 141-143). This writer emits
the same event-file format (TFRecord-framed Event protos with masked crc32c)
hand-encoded in pure Python, byte for byte what the JAX package's writer
writes for the same clock, host and process id. Files are readable by
standard TensorBoard; torch's own writer would need the tensorboard package.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# ---------------------------------------------------------------- crc32c (Castagnoli)
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf wire format
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_varint(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    # Summary.Value { string tag = 1; float simple_value = 2; }
    return _f_bytes(1, tag.encode()) + _f_float(2, float(value))


def _event(wall_time: float, step: int, *, file_version: str | None = None, scalars=None) -> bytes:
    # Event { double wall_time = 1; int64 step = 2; string file_version = 3; Summary summary = 5; }
    body = _f_double(1, wall_time) + _f_varint(2, step)
    if file_version is not None:
        body += _f_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(_f_bytes(1, _summary_value(t, v)) for t, v in scalars)
        body += _f_bytes(5, summary)
    return body


class SummaryWriter:
    """API-compatible subset of torch.utils.tensorboard.SummaryWriter."""

    def __init__(self, log_dir: str = "./logs"):
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self._f = open(Path(log_dir) / fname, "wb")
        self._write_record(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event(time.time(), int(step), scalars=[(tag, float(value))]))

    def close(self):
        self._f.close()

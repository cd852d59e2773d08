"""flax's msgpack layout for weight trees, read and written without the
`msgpack` and `flax` packages (the port depends on neither; flax is not
installed beside the card).

The layout `flax.serialization.msgpack_serialize` writes (flax/serialization.py):
- nested maps with str keys, written in sorted key order (flax maps the tree
  through `jax.tree_util`, which sorts dict keys);
- an ndarray leaf is ext type 1 whose payload is itself the msgpack array
  `(shape, dtype.name, C-order bytes)`; bfloat16 is named "bfloat16";
- a numpy scalar leaf is ext type 3 with the same payload;
- Python None, bool, int, float, str, bytes and lists as msgpack's own types,
  in the smallest encoding msgpack-python picks.

`packb` writes those bytes exactly as flax does for the same tree; `unpackb`
reads every msgpack header family (fixext 1/2/4/8/16, ext 8/16/32 included).
ndarray leaves load as numpy arrays (read-only views of the buffer, as flax
returns them); a bfloat16 leaf, which numpy cannot hold, loads as a
`torch.bfloat16` tensor, and a CPU tensor leaf writes as an ndarray.

flax splits leaves above 2**30 bytes into chunk maps; no SSD leaf is that
large, and `unpackb` raises on a chunked leaf rather than misread it.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"

_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# ---------------------------------------------------------------- writing
def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return struct.pack(">B", v)
    if v >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"),
                                 (1 << 64, 0xCF, ">Q")):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
        raise OverflowError(f"integer {v} does not fit msgpack's uint64")
    if v >= -32:
        return struct.pack(">b", v)
    for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"), (1 << 31, 0xD2, ">i"),
                             (1 << 63, 0xD3, ">q")):
        if v >= -limit:
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's int64")


def _header(n: int, fix: int | None, fix_limit: int, codes) -> bytes:
    """A length header: the fix form below fix_limit, else the 8/16/32-bit form."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    for bits, code in zip((8, 16, 32), codes):
        if code is not None and n < (1 << bits):
            return bytes([code]) + n.to_bytes(bits // 8, "big")
    raise OverflowError(f"length {n} does not fit msgpack's 32-bit lengths")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data


def _bin(data: bytes) -> bytes:
    return _header(len(data), None, 0, (0xC4, 0xC5, 0xC6)) + data


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    head = bytes([_FIXEXT[n]]) if n in _FIXEXT else _header(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, bytes)."""
    return (bytes([0x93]) + _header(len(shape), 0x90, 16, (None, 0xDC, 0xDD))
            + b"".join(_int(int(s)) for s in shape) + _str(dtype_name) + _bin(data))


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError(f"dtype {a.dtype} cannot be serialized")
    return _array_payload(a.shape, a.dtype.name, a.tobytes("C"))


def _tensor_payload(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _array_payload(t.shape, "bfloat16", t.view(torch.int16).numpy().tobytes())
    return _ndarray_payload(t.numpy())


def _pack(x, out: list):
    # exact type checks, as flax's msgpack_serialize (strict_types=True): a
    # numpy float64 is a float subclass, and is written as a numpy scalar
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        out.append(_int(x))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        out.append(_str(x))
    elif t is bytes:
        out.append(_bin(x))
    elif t is dict:
        if not all(type(k) is str for k in x):
            raise TypeError(f"map keys must be str, got {sorted({type(k).__name__ for k in x})}")
        out.append(_header(len(x), 0x80, 16, (None, 0xDE, 0xDF)))
        for k in sorted(x):
            out.append(_str(k))
            _pack(x[k], out)
    elif t is list:
        out.append(_header(len(x), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    elif isinstance(x, torch.Tensor):
        out.append(_ext(EXT_NDARRAY, _tensor_payload(x)))
    else:
        raise TypeError(f"cannot serialize {t.__name__!r}")


def packb(tree) -> bytes:
    """The bytes flax's `msgpack_serialize` writes for `tree`."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ---------------------------------------------------------------- reading
class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.buf) - self.pos} left")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width scalars: header byte -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# 8/16/32-bit length prefixes: header byte -> (family, struct format)
_LENGTHS = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT_LEN = {v: k for k, v in _FIXEXT.items()}


def _read(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _FIXEXT_LEN:
        return _read_ext(r, _FIXEXT_LEN[b])
    if b in _LENGTHS:
        family, fmt = _LENGTHS[b]
        n = r.unpack(fmt)
        if family == "bin":
            return bytes(r.take(n))
        if family == "str":
            return str(r.take(n), "utf-8")
        if family == "ext":
            return _read_ext(r, n)
        if family == "array":
            return [_read(r) for _ in range(n)]
        return _read_map(r, n)
    raise ValueError(f"invalid msgpack header byte 0x{b:02x} at offset {r.pos - 1}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    if CHUNKED_KEY in out:
        raise ValueError("a chunked leaf (flax splits leaves above 2**30 bytes) is not supported")
    return out


def _read_array_payload(payload: memoryview):
    r = _Reader(payload)
    shape, name, data = _read(r)
    if name == "bfloat16":
        words = np.frombuffer(data, np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def _read_ext(r: _Reader, n: int):
    code = r.unpack(">b")
    payload = r.take(n)
    if code == EXT_NDARRAY:
        return _read_array_payload(payload)
    if code == EXT_NPSCALAR:
        a = _read_array_payload(payload)
        return a if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"unsupported msgpack ext type {code} ({n} bytes)")


def unpackb(data) -> object:
    """The tree flax's `msgpack_restore` reads from `data`."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return tree

"""A small MessagePack codec for argus_tpu checkpoints, with no msgpack/flax.

It reads and writes exactly what `flax.serialization.msgpack_serialize`
produces for a checkpoint tree: maps, arrays (lists and tuples), str, bin,
ints, floats, bool and nil, plus flax's ext types

  * 1 (ndarray): payload is the msgpack of ``(shape, dtype name, C-order bytes)``,
  * 3 (numpy scalar): the same payload for a 0-d array, unpacked to a scalar,

and, when reading, flax's chunked form for arrays above 2**30 bytes. The
encoder makes the
same choices as msgpack-python's `packb(use_bin_type=True)` (smallest int and
length forms, float64 for Python floats), so a tree read and written again
gives the same bytes.

numpy has no bfloat16, so a ``bfloat16`` array is returned as a torch
bfloat16 tensor, and torch tensors of any dtype can be written.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ─────────────────────────────── encoding ───────────────────────────────


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out += struct.pack("B", v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack("B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack("b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """Header of a str/bin/array/map of length n: the fix form when
    n < fix_max (fix=None: none), else the 8/16/32-bit form."""
    c8, c16, c32 = codes
    if fix is not None and n < fix_max:
        out += struct.pack("B", fix | n)
    elif c8 is not None and n <= 0xFF:
        out += struct.pack(">BB", c8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", c16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


class _Runs:
    """The encoded stream as runs of bytes: headers and small values gathered
    in a bytearray (`out += b`), array contents kept as views of the arrays
    (`view`), so a checkpoint's arrays are not copied to be encoded."""

    def __init__(self) -> None:
        self.runs: list = []
        self.head = bytearray()

    def __iadd__(self, data) -> "_Runs":
        self.head += data
        return self

    def view(self, data: memoryview) -> None:
        if self.head:
            self.runs.append(bytes(self.head))
            self.head = bytearray()
        self.runs.append(data)

    def done(self) -> list:
        if self.head:
            self.runs.append(bytes(self.head))
            self.head = bytearray()
        return self.runs


def _pack_ext_header(out, code: int, n: int) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out += struct.pack("B", fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code)


def _pack_array(out: _Runs, code: int, shape, dtype_name: str, a: np.ndarray) -> None:
    """flax's ndarray ext: the msgpack of (shape, dtype name, C-order bytes),
    with the bytes written as a view of the array."""
    raw = memoryview(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
    head = _Runs()
    _pack_len(head, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _pack(head, list(shape))
    _pack(head, dtype_name)
    _pack_len(head, raw.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
    head = head.done()[0]
    _pack_ext_header(out, code, len(head) + raw.nbytes)
    out += head
    out.view(raw)


def _tensor_parts(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy()
    a = t.numpy()
    return a.shape, a.dtype.name, a


def _pack(out: _Runs, obj: Any) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialized")
        _pack_array(out, _EXT_NDARRAY, obj.shape, obj.dtype.name, obj)
    elif isinstance(obj, torch.Tensor):
        _pack_array(out, _EXT_NDARRAY, *_tensor_parts(obj))
    elif isinstance(obj, np.generic):
        a = np.asarray(obj)
        _pack_array(out, _EXT_NPSCALAR, a.shape, a.dtype.name, a)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def _encode(obj: Any) -> list:
    out = _Runs()
    _pack(out, obj)
    return out.done()


def packb(obj: Any) -> bytes:
    """Serialize a tree of dicts, lists, scalars and arrays to msgpack bytes."""
    return b"".join(_encode(obj))


def dump(obj: Any, f) -> None:
    """`packb(obj)` written to the binary file `f` run by run: the arrays'
    contents go from their own memory to the file, with no copy that holds
    the interpreter lock (a writer thread then leaves the loop room to run)."""
    for run in _encode(obj):
        f.write(run)


# ─────────────────────────────── decoding ───────────────────────────────


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos : end].tobytes()
        self.pos = end
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_payload(payload: bytes):
    shape, dtype_name, raw = unpackb(payload)
    shape = tuple(int(s) for s in shape)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        a = _array_from_payload(data)
        return a.reshape(()).item() if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader) -> Any:
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    simple = {
        0xC0: lambda: None,
        0xC2: lambda: False,
        0xC3: lambda: True,
        0xC4: lambda: r.take(r.unpack("B")),
        0xC5: lambda: r.take(r.unpack(">H")),
        0xC6: lambda: r.take(r.unpack(">I")),
        0xCA: lambda: r.unpack(">f"),
        0xCB: lambda: r.unpack(">d"),
        0xCC: lambda: r.unpack("B"),
        0xCD: lambda: r.unpack(">H"),
        0xCE: lambda: r.unpack(">I"),
        0xCF: lambda: r.unpack(">Q"),
        0xD0: lambda: r.unpack("b"),
        0xD1: lambda: r.unpack(">h"),
        0xD2: lambda: r.unpack(">i"),
        0xD3: lambda: r.unpack(">q"),
        0xD9: lambda: r.take(r.unpack("B")).decode("utf-8"),
        0xDA: lambda: r.take(r.unpack(">H")).decode("utf-8"),
        0xDB: lambda: r.take(r.unpack(">I")).decode("utf-8"),
        0xDC: lambda: [_read(r) for _ in range(r.unpack(">H"))],
        0xDD: lambda: [_read(r) for _ in range(r.unpack(">I"))],
        0xDE: lambda: _read_map(r, r.unpack(">H")),
        0xDF: lambda: _read_map(r, r.unpack(">I")),
    }
    if b in simple:
        return simple[b]()
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        n = fixext[b]
    elif b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
    else:
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")
    code = r.unpack("b")
    return _ext(code, r.take(n))


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """Deserialize msgpack bytes; raises on trailing or truncated data."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


def restore(data: bytes) -> Any:
    """`unpackb` plus flax's chunked-array reassembly: the counterpart of
    `flax.serialization.msgpack_restore`."""
    return _unchunk(unpackb(data))

"""The checkpoint reader of the plain reference: the subset of msgpack
that flax writes (maps, arrays, strings, binaries, integers, floats,
nil/bool, and ext type 1, a packed ndarray ``(shape, dtype name, raw
little-endian bytes)``), and the conv trunk's weights from a version-9
checkpoint directory. The card's machine has neither flax nor msgpack.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack payload truncated")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode_ext(code: int, data: bytes) -> Any:
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, raw = unpackb(data)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _read(r: _Reader) -> Any:
    b = r.unpack("B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return r.take(b & 0x1f).decode("utf-8")
    simple = {0xc0: None, 0xc2: False, 0xc3: True}
    if b in simple:
        return simple[b]
    if b in (0xc4, 0xc5, 0xc6):                     # bin 8/16/32
        n = r.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b])
        return r.take(n)
    if b in (0xc7, 0xc8, 0xc9):                     # ext 8/16/32
        n = r.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n))
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xd4, 0xd5, 0xd6, 0xd7, 0xd8):         # fixext 1/2/4/8/16
        n = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}[b]
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n))
    if b in (0xd9, 0xda, 0xdb):                     # str 8/16/32
        n = r.unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b])
        return r.take(n).decode("utf-8")
    if b in (0xdc, 0xdd):                           # array 16/32
        n = r.unpack(">H" if b == 0xdc else ">I")
        return [_read(r) for _ in range(n)]
    if b in (0xde, 0xdf):                           # map 16/32
        return _read_map(r, r.unpack(">H" if b == 0xde else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(payload: bytes) -> Any:
    """Decode one msgpack object (flax's subset; ext 1 -> numpy array)."""
    r = _Reader(payload)
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xff)
        elif obj >= 0:
            for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
                if obj < top:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} too large for msgpack")
        else:
            for code, fmt, lo in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                                  (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
                if obj >= lo:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} too small for msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        _pack_sized(out, obj.encode("utf-8"), 0xa0, 32, (0xd9, 0xda, 0xdb))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_sized(out, bytes(obj), None, 0, (0xc4, 0xc5, 0xc6))
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays do not serialize")
        data = packb((obj.shape, obj.dtype.name, obj.tobytes("C")))
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _pack_header(out, len(data), None, 0, (0xc7, 0xc8, 0xc9))
        out += struct.pack(">b", _EXT_NDARRAY) + data
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_header(out: bytearray, n: int, fix, fix_limit: int, codes) -> None:
    """A length header: the fix form below fix_limit, else the 8/16/32-bit
    forms of ``codes`` (None where msgpack has no such form)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_sized(out: bytearray, data: bytes, fix, fix_limit: int, codes) -> None:
    _pack_header(out, len(data), fix, fix_limit, codes)
    out += data


def packb(obj: Any) -> bytes:
    """Encode one object as msgpack the way flax.serialization writes a
    state dict: maps in insertion order, Python floats as doubles, bytes as
    bin, numpy arrays as ext 1."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# Weights bridge: JAX/flax parameter trees -> the port's state dicts
# ---------------------------------------------------------------------------


def load_trunk(path: str):
    """(layers, [(weight (cout, cin, kh, kw), bias (cout,)), ...]) numpy
    float32 arrays of a single-scale checkpoint's conv trunk, from the
    flax kernels (kh, kw, cin, cout). Every layer must be dense."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    layers = tuple(tuple(l) for l in meta["geometry"]["layers"])
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        tree = unpackb(f.read())
    params = tree["params"] if "params" in tree else tree
    out, cprev = [], layers[0][0]
    for i, (cin, kh, kw, cout) in enumerate(layers):
        if cin != cprev:
            raise ValueError(f"layer{i + 1}: a sparse connection map")
        k = np.asarray(params[f"layer{i + 1}"]["kernel"], np.float32)
        b = np.asarray(params[f"layer{i + 1}"]["bias"], np.float32)
        if k.shape != (kh, kw, cin, cout):
            raise ValueError(f"layer{i + 1}: kernel shape {k.shape}")
        out.append((np.ascontiguousarray(k.transpose(3, 2, 0, 1)), b.copy()))
        cprev = cout
    return layers, out

"""Read flax msgpack checkpoints without flax or the msgpack package.

The shipped assets were written by ``flax.serialization.msgpack_serialize``:
nested maps of str keys whose leaves are arrays packed as msgpack ext type 1,
a nested msgpack of ``(shape, dtype name, raw bytes)``. Ext type 3 is a numpy
scalar in the same packing and ext type 2 a complex number. Arrays above
2**30 bytes are split into a ``__msgpack_chunked_array__`` map of chunks.
This module decodes that subset of msgpack in plain Python, so the port
loads the same files on a machine that has neither flax nor msgpack.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8..64, int 8..64
            return self.unpack(">" + "BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int, raw: bool):
        s = bytes(self.take(n))
        return s if raw else s.decode("utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.obj(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj(raw)
            out[key] = self.obj(raw)
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        if code == _EXT_COMPLEX:
            re, im = unpackb(payload)
            return complex(re, im)
        raise ValueError(f"unsupported msgpack ext type {code}")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape, order="C")


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object (the subset flax writes)."""
    reader = _Reader(data)
    out = reader.obj(raw)
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_variables(path: str) -> Any:
    """Load a variables tree saved by the JAX package's ``save_variables``."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))

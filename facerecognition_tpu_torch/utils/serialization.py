"""Read and write flax msgpack checkpoints without flax or the msgpack package.

The shipped assets were written by ``flax.serialization.msgpack_serialize``:
nested maps of str keys whose leaves are arrays packed as msgpack ext type 1,
a nested msgpack of ``(shape, dtype name, raw bytes)``. Ext type 3 is a numpy
scalar in the same packing and ext type 2 a complex number. Arrays above
2**30 bytes are split into a ``__msgpack_chunked_array__`` map of chunks.
This module decodes that subset of msgpack in plain Python, so the port
loads the same files on a machine that has neither flax nor msgpack, and
``save_variables`` writes them as ``flax.serialization.msgpack_serialize``
does, byte for byte, so a model the port trains serves from either package.
"""

from __future__ import annotations

import os
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


# -- writing ---------------------------------------------------------------------

#: flax splits arrays above this many bytes into chunks.
MAX_CHUNK_SIZE = 2**30


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, then 8/16/32-bit
    forms (``codes``: their type bytes, None where msgpack has none)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = (
        ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16), (0xCE, ">I", 0, 1 << 32),
         (0xCF, ">Q", 0, 1 << 64))
        if v >= 0 else
        ((0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0), (0xD2, ">i", -(1 << 31), 0),
         (0xD3, ">q", -(1 << 63), 0))
    )
    for code, fmt, lo, hi in forms:
        if lo <= v < hi:
            out.append(code)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, complex):
        _pack_ext(out, _EXT_COMPLEX, packb((obj.real, obj.imag)))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode one object as msgpack (the subset flax writes; str8 and bin
    types, as ``use_bin_type=True`` packs them)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _host_tree(tree: Any) -> Any:
    """Tensors and arrays as numpy arrays, arrays above ``MAX_CHUNK_SIZE``
    bytes as flax's chunked maps, map keys sorted (as flax's tree copy
    orders them)."""
    if isinstance(tree, dict):
        return {str(k): _host_tree(tree[k]) for k in sorted(tree)}
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):  # a torch tensor
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        flat = tree.reshape(-1)
        size = max(1, int(MAX_CHUNK_SIZE / tree.dtype.itemsize))
        chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
        return {
            "__msgpack_chunked_array__": True,
            "shape": {str(i): d for i, d in enumerate(tree.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)},
        }
    return tree


def save_variables(path: str, variables: Any) -> None:
    """Write a variables tree (``params``/``batch_stats`` of numpy arrays or
    tensors) as the JAX package's ``save_variables`` does."""
    data = packb(_host_tree(variables))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)

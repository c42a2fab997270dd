"""ctypes bindings of the port's image decoder (``csrc/decode.cpp``).

Counterpart of ``facerecognition_tpu/data/native_decode.py``
(``available``, ``decode_mem``, ``decode_batch``). The library is built with
the host C++ compiler at first use into ``_build/`` (``_build.build_host``):
PNG through its own reader on zlib, JPEG through libjpeg where the machine
has it, else through the CUDA toolkit's nvJPEG (on the card), else not at
all; ``jpeg_backend()`` says which. There is no PIL fallback: what the
library cannot decode raises ``OSError`` naming the format. A failure of
the machine rather than of the data (the card, its driver, memory, a build
without a JPEG backend) raises ``RuntimeError``, so that no caller takes it
for an undecodable file.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np

from facerecognition_tpu_torch import _build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_ERR_CAP = 512

#: Leading bytes of formats the decoder does not read, for the error message.
_OTHER_FORMATS = (
    (b"BM", "BMP"),
    (b"GIF87a", "GIF"),
    (b"GIF89a", "GIF"),
    (b"II*\x00", "TIFF"),
    (b"MM\x00*", "TIFF"),
    (b"\x00\x00\x01\x00", "ICO"),
    (b"8BPS", "PSD"),
)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The decoder library, built at first use, with its signatures."""
    jpeg_libs = _build.jpeg_config(_build.find_cxx())[1]
    lib = _build.build_host("decode", (*jpeg_libs, *_build.HOST_LIBS)).lib
    lib.frt_jpeg_backend.restype = ctypes.c_char_p
    lib.frt_decode_alloc.argtypes = [
        _U8P, ctypes.c_long, ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int,
    ]
    lib.frt_decode_alloc.restype = ctypes.c_int
    lib.frt_decode_jpeg_gray_alloc.argtypes = lib.frt_decode_alloc.argtypes
    lib.frt_decode_jpeg_gray_alloc.restype = ctypes.c_int
    lib.frt_free.argtypes = [_U8P]
    lib.frt_free.restype = None
    lib.frt_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P, _U8P, ctypes.c_int, ctypes.c_int,
    ]
    lib.frt_decode_batch.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True when the decoder builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def jpeg_backend() -> str:
    """``"libjpeg"``, ``"nvjpeg"`` or ``"none"``: how this build reads JPEG."""
    return _lib().frt_jpeg_backend().decode()


def sniff_format(data: bytes) -> str:
    """The image format named by the leading bytes: ``JPEG``, ``PNG``, or
    another format's name (``BMP``, ``GIF``, ``WebP``, ...), ``unknown``."""
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return name
    return "unknown"


def _decode(entry: str, data: bytes, channels: int, where: str) -> np.ndarray:
    """One call of the library's ``entry`` (``frt_decode_alloc`` or
    ``frt_decode_jpeg_gray_alloc``): (H, W, channels) uint8."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    out = _U8P()
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    err = ctypes.create_string_buffer(_ERR_CAP)
    rc = getattr(lib, entry)(
        src.ctypes.data_as(_U8P), len(data), ctypes.byref(out), ctypes.byref(w), ctypes.byref(h),
        err, _ERR_CAP,
    )
    if rc < 0:
        raise RuntimeError(f"{where}{err.value.decode(errors='replace')}")
    if rc == 0:
        raise OSError(f"{where}{err.value.decode(errors='replace')}")
    try:
        img = np.empty((h.value, w.value, channels), np.uint8)
        ctypes.memmove(img.ctypes.data, out, img.nbytes)
    finally:
        lib.frt_free(out)
    return img


def decode_mem(data: bytes, name: Optional[str] = None) -> np.ndarray:
    """Decode JPEG/PNG bytes at their own size: (H, W, 3) uint8 RGB. Any
    other format, or a file the decoder refuses, raises ``OSError`` naming
    the format and ``name`` (a path, for the message); a failure of the
    card or of memory raises ``RuntimeError``."""
    where = f"{name}: " if name else ""
    fmt = sniff_format(data)
    if fmt not in ("JPEG", "PNG"):
        raise OSError(f"{where}cannot decode {fmt} image data: the port reads JPEG and PNG")
    return _decode("frt_decode_alloc", data, 3, where)


def decode_jpeg_gray(data: bytes, name: Optional[str] = None) -> np.ndarray:
    """JPEG bytes as libjpeg's grayscale output (what OpenCV's
    ``IMREAD_GRAYSCALE`` reads): the Y plane as stored, (H, W) uint8; by
    nvJPEG's IDCT where that is the backend. Errors as ``decode_mem``."""
    where = f"{name}: " if name else ""
    if sniff_format(data) != "JPEG":
        raise OSError(f"{where}not JPEG data")
    return _decode("frt_decode_jpeg_gray_alloc", data, 1, where)[..., 0]


def decode_file(path) -> np.ndarray:
    """Read and decode one image file; a missing file raises
    ``FileNotFoundError``."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    return decode_mem(data, path)


def decode_batch(
    paths: Sequence[str], size: int, n_threads: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Decode and resize (bilinear, half-pixel centres, rounded to uint8) a
    batch of files with ``n_threads`` threads: (images (N, size, size, 3)
    uint8, ok (N,) bool); rows that failed are zero. A failure of the card
    or of memory on any row raises ``RuntimeError``."""
    if size <= 0:
        raise ValueError(f"decode_batch: size must be positive, got {size}")
    lib = _lib()
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    if n:
        arr = (ctypes.c_char_p * n)(*[os.fspath(p).encode() for p in paths])
        lib.frt_decode_batch(arr, n, out.ctypes.data_as(_U8P), ok.ctypes.data_as(_U8P), size,
                             n_threads)
    if (ok == 2).any():
        bad = [os.fspath(paths[i]) for i in np.flatnonzero(ok == 2)[:3]]
        raise RuntimeError(
            f"decode_batch: the decoder itself failed (card, memory or JPEG backend) on {bad}"
        )
    return out, ok.astype(bool)

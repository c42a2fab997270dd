"""Host image IO: paths, bytes, arrays and PIL-like images as RGB uint8 HWC,
a PNG writer and a baseline JPEG writer.

Counterpart of ``facerecognition_tpu/utils/imageio.py``. It imports neither
PIL nor cv2 (the card machine's port uses neither): a path or bytes are
decoded by the port's own decoder (``data/native_decode``, JPEG and PNG), a
PIL-like object is recognised by its ``convert`` method. A missing file
raises ``FileNotFoundError`` and any other format ``OSError``, which the
staged engine API reports as an error result, as the JAX engine does.
``encode_jpeg`` is the port's own encoder (``csrc/jpeg_encode.cpp``, built
with the host C++ compiler at first use), where the JAX app calls
``cv2.imencode``: one code path gives the same bytes on every machine.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from typing import Any, Union

import numpy as np

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.data import native_decode

PNG_LEVEL = 6  # zlib's default compression level


def load_image(img_input: Union[str, "os.PathLike", bytes, np.ndarray, Any]) -> np.ndarray:
    """An image path, encoded bytes, array or PIL-like image as RGB uint8
    HWC: gray is stacked to three channels, alpha dropped, floats in [0, 1]
    scaled by 255, then clipped and cast (``to_uint8``)."""
    if isinstance(img_input, np.ndarray):
        arr = img_input
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        elif arr.ndim == 3 and arr.shape[2] == 4:
            arr = arr[:, :, :3]  # drop alpha: the contract is RGB HWC
        return to_uint8(arr)
    if hasattr(img_input, "convert"):  # a PIL image, duck-typed
        return np.asarray(img_input.convert("RGB"))
    if isinstance(img_input, (bytes, bytearray, memoryview)):
        return native_decode.decode_mem(bytes(img_input))
    if isinstance(img_input, (str, os.PathLike)):
        return native_decode.decode_file(img_input)
    raise TypeError(
        f"expected an image path, bytes, an image array or a PIL image, got {type(img_input).__name__}"
    )


#: libpng's ``png_set_rgb_to_gray`` weights as OpenCV sets them (0.299,
#: 0.587) in its 15-bit fixed point: red and green truncated, blue the rest.
PNG_GRAY_WEIGHTS = (9797, 19234, 3737)


def load_gray(path) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: (H, W) uint8. A PNG is
    converted as OpenCV has libpng do it, ``(9797 R + 19234 G + 3737 B) >>
    15`` (gray files as they are), bit for bit. A JPEG is the Y plane as
    stored (``native_decode.decode_jpeg_gray``), not a gray of the decoded
    colours: bit for bit where the decoder's backend is libjpeg; where it
    is nvJPEG, its IDCT's plane, which need not have libjpeg's bits."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if native_decode.sniff_format(data) == "JPEG":
        return native_decode.decode_jpeg_gray(data, path)
    rgb = native_decode.decode_mem(data, path).astype(np.int64)
    wr, wg, wb = PNG_GRAY_WEIGHTS
    return ((wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]) >> 15).astype(np.uint8)


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """Clamp and convert an array to uint8 [0, 255]; floats whose maximum is
    at most 1 are taken as [0, 1] and scaled by 255 first."""
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.floating) and arr.max() <= 1.0 + 1e-6:
        arr = arr * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 as PNG bytes (8 bits, no filter,
    not interlaced)."""
    img = np.ascontiguousarray(to_uint8(np.asarray(image)))
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) images, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), PNG_LEVEL)) + _chunk(b"IEND", b""))


def save_png(path, image: np.ndarray) -> str:
    """Write ``image`` (see ``encode_png``) to ``path``; returns the path."""
    path = os.fspath(path)
    with open(path, "wb") as f:
        f.write(encode_png(image))
    return path


_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=None)
def _jpeg_lib() -> ctypes.CDLL:
    """The JPEG encoder library, built at first use, with its signatures."""
    lib = _build.build_host("jpeg_encode").lib
    lib.frt_encode_jpeg.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(_U8P)]
    lib.frt_encode_jpeg.restype = ctypes.c_long
    lib.frt_jpeg_free.argtypes = [_U8P]
    lib.frt_jpeg_free.restype = None
    return lib


def encode_jpeg(rgb: np.ndarray, quality: int = 80) -> bytes:
    """(H, W, 3) RGB or (H, W) gray uint8 as baseline JPEG bytes: YCbCr
    4:2:0, libjpeg's standard tables scaled by ``quality`` (1-100) and the
    standard Huffman tables."""
    img = to_uint8(np.asarray(rgb))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.ndim != 3 or img.shape[2] != 3 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"encode_jpeg takes (H, W) or (H, W, 3) images, got {img.shape}")
    img = np.ascontiguousarray(img)
    lib = _jpeg_lib()
    out = _U8P()
    n = lib.frt_encode_jpeg(img.ctypes.data_as(_U8P), img.shape[1], img.shape[0], int(quality),
                            ctypes.byref(out))
    if n <= 0:
        raise ValueError(f"encode_jpeg: cannot encode an image of shape {img.shape}")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.frt_jpeg_free(out)

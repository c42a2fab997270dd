"""Host image IO: paths, bytes, arrays and PIL-like images as RGB uint8 HWC,
and a PNG writer.

Counterpart of ``facerecognition_tpu/utils/imageio.py``. It imports neither
PIL nor cv2 (the card machine's port uses neither): a path or bytes are
decoded by the port's own decoder (``data/native_decode``, JPEG and PNG), a
PIL-like object is recognised by its ``convert`` method. A missing file
raises ``FileNotFoundError`` and any other format ``OSError``, which the
staged engine API reports as an error result, as the JAX engine does.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Union

import numpy as np

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

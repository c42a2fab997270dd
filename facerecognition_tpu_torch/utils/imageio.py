"""Host image input: arrays and PIL-like images as RGB uint8 HWC.

Counterpart of ``facerecognition_tpu/utils/imageio.py`` for the inputs the
port takes. It imports neither PIL nor cv2 (the card machine has neither):
a PIL-like object is recognised by its ``convert`` method. The port reads
no image files: a path raises ``ImageFileNotRead``, an ``OSError``, which
the staged engine API reports as an error result, as the JAX engine does
for a file it cannot read.
"""

from __future__ import annotations

import os
from typing import Any, Union

import numpy as np


class ImageFileNotRead(OSError, TypeError):
    """An image path was given; the port reads no image files. An
    ``OSError``, as a file that cannot be read, and a ``TypeError``: the
    port takes image arrays."""


def load_image(img_input: Union[np.ndarray, Any]) -> np.ndarray:
    """An image array or PIL-like image as RGB uint8 HWC: gray is stacked to
    three channels, alpha dropped, floats in [0, 1] scaled by 255, then
    clipped and cast (``to_uint8``)."""
    if isinstance(img_input, np.ndarray):
        arr = img_input
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        elif arr.ndim == 3 and arr.shape[2] == 4:
            arr = arr[:, :, :3]  # drop alpha: the contract is RGB HWC
        return to_uint8(arr)
    if hasattr(img_input, "convert"):  # a PIL image, duck-typed
        return np.asarray(img_input.convert("RGB"))
    if isinstance(img_input, (str, os.PathLike)):
        raise ImageFileNotRead(
            f"{os.fspath(img_input)!r}: the port reads no image files; "
            "pass an image array or a PIL image"
        )
    raise TypeError(f"expected an image array or a PIL image, got {type(img_input).__name__}")


def to_uint8(arr: np.ndarray) -> np.ndarray:
    """Clamp and convert an array to uint8 [0, 255]; floats whose maximum is
    at most 1 are taken as [0, 1] and scaled by 255 first."""
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.floating) and arr.max() <= 1.0 + 1e-6:
        arr = arr * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)

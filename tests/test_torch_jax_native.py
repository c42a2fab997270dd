"""The JAX package's native decoder, built once for the whole suite.

The port's loader and decoder tests compare against the JAX loader's native
path (``facerecognition_tpu/data/native_decode.py``, ``native/decode.cpp``).
That module builds ``native/libfrt_decode.so`` at first use with ``make``,
which writes the library in place, and locks only within its process. When
several of the suite's workers reach it at once on a fresh tree, one of them
can ``dlopen`` a library another is still writing: the module then marks
the build as failed for the life of that worker, and the JAX ``BatchLoader``
reads with PIL (another resize), so a bit-for-bit comparison fails. Six
processes racing on a fresh tree showed it in one of eighteen.

``jax_native_decoder`` takes a lock shared by the workers (a file lock in
the temporary directory), builds or loads the library under it, retries a
load that met a half-written file, and fails unless the library loaded.
"""

from __future__ import annotations

import fcntl
import importlib
import os
import tempfile
import time

import numpy as np

LOCK_PATH = os.path.join(tempfile.gettempdir(), "facerecognition_tpu_native_decode.lock")


def jax_native_decoder():
    """The JAX ``native_decode`` module with its library loaded."""
    nd = importlib.import_module("facerecognition_tpu.data.native_decode")
    with open(LOCK_PATH, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for _ in range(10):
                if nd._ensure_built() is not None:
                    break
                # A load that failed on a library another process was
                # writing: the module keeps that failure; clear it and retry.
                nd._build_failed = False
                time.sleep(0.5)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert nd.available(), "the JAX package's native decoder did not build or load"
    return nd


def test_jax_loader_takes_its_native_path(tmp_path):
    """After ``jax_native_decoder``, the JAX ``BatchLoader`` reads through
    the native library (not PIL), and a second call finds it loaded."""
    from facerecognition_tpu.data.datasets import FolderDataset
    from facerecognition_tpu.data.loader import BatchLoader
    from facerecognition_tpu_torch.utils.imageio import save_png

    nd = jax_native_decoder()
    for person in ("a", "b"):
        os.makedirs(tmp_path / person)
        for i in range(2):
            save_png(str(tmp_path / person / f"{i}.png"), np.full((20, 20, 3), 40 * i, np.uint8))
    loader = BatchLoader(FolderDataset(str(tmp_path)), iter([np.arange(4)]), image_size=16, n_workers=1)
    assert loader._native is nd
    (imgs, labels), = list(loader)
    assert imgs.shape == (4, 16, 16, 3) and list(labels) == [0, 0, 1, 1]
    assert jax_native_decoder() is nd and nd._lib is not None

"""Prefetching host batch loader, and the validation resize.

Counterpart of ``facerecognition_tpu/data/loader.py``. ``BatchLoader``
reads each batch with the native decoder (``data/native_decode.
decode_batch``: decode, half-pixel bilinear resize, rounded to uint8) in a
producer thread, ``n_prefetch`` batches ahead. A row the decoder rejects is
zero-filled with a warning: the JAX loader retries such a row with PIL
(other formats than PNG and JPEG), the port reads PNG and JPEG only.

``_load_resize`` is what the trainers' validation reads: the image resized
to ``size``² with PIL's ``Image.BILINEAR`` for 8-bit images, in numpy and
bit for bit: a triangle filter whose support widens with the downscale
factor (so it antialiases), coefficients rounded to 22-bit fixed point, a
horizontal pass rounded to uint8, then a vertical one.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
import warnings
from typing import Iterator

import numpy as np

from facerecognition_tpu_torch.data import native_decode
from facerecognition_tpu_torch.data.datasets import DatasetIndex
from facerecognition_tpu_torch.utils.imageio import load_image

_END_OF_DATA = object()  # finite-sampler end marker (queue sentinel)
_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images


class _ProducerError:
    """Wraps a producer-thread exception for re-raise in the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


@functools.lru_cache(maxsize=64)
def pil_bilinear_coefficients(in_size: int, out_size: int) -> np.ndarray:
    """PIL's fixed-point bilinear weights of a resize from ``in_size`` to
    ``out_size`` samples: (out_size, in_size) int64, each row summing to
    about 2**22 (``precompute_coeffs`` and ``normalize_coeffs_8bpc`` of
    PIL's Resample.c). Cached: do not write into it."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    out = np.zeros((out_size, in_size), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = sum(w)
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            out[xx, xmin + x] = int((-0.5 if k < 0 else 0.5) + k * (1 << _PRECISION_BITS))
    out.flags.writeable = False
    return out


def _pil_pass(img: np.ndarray, coef: np.ndarray, axis: int) -> np.ndarray:
    # The fixed-point sums in float64: every product and partial sum is an
    # integer below 2**31, exact in float64 in any order, so the BLAS
    # product gives PIL's integers (int64 products have no BLAS).
    acc = np.tensordot(img.astype(np.float64), coef.astype(np.float64), axes=([axis], [1]))
    acc = np.moveaxis(acc, -1, axis).astype(np.int64)
    acc = (acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def pil_bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``Image.fromarray(img).resize((out_w, out_h), Image.BILINEAR)`` for
    a (H, W) or (H, W, C) uint8 array, bit for bit."""
    h, w = img.shape[:2]
    if w != out_w:
        img = _pil_pass(img, pil_bilinear_coefficients(w, out_w), 1)
    if h != out_h:
        img = _pil_pass(img, pil_bilinear_coefficients(h, out_h), 0)
    return img


def _load_resize(path: str, size: int) -> np.ndarray:
    """An image file as (size, size, 3) uint8 RGB, resized as PIL's
    ``Image.BILINEAR`` does (the JAX loader's ``_load_resize``)."""
    img = load_image(path)
    if img.shape[:2] != (size, size):
        img = pil_bilinear_resize(img, size, size)
    return img


class BatchLoader:
    """Iterates (images (B, S, S, 3) uint8, labels (B,)) with prefetch.

    ``sampler`` yields index arrays; ``n_prefetch`` batches are decoded
    ahead, each with ``n_workers`` decoder threads."""

    def __init__(
        self,
        index: DatasetIndex,
        sampler: Iterator[np.ndarray],
        image_size: int = 112,
        n_workers: int = 8,
        n_prefetch: int = 4,
    ):
        self.index = index
        self.sampler = sampler
        self.image_size = image_size
        self.n_workers = n_workers
        self.queue: queue.Queue = queue.Queue(maxsize=n_prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._started = False
        self._n_failed = 0

    def _warn_failed(self, path: str) -> None:
        # Zero-filled rows train real labels against black images: never
        # silently (a few messages at most).
        self._n_failed += 1
        if self._n_failed <= 5:
            warnings.warn(
                f"image decode failed, zero-filled: {path} (the native decoder reads PNG and JPEG)"
            )

    def _load_batch(self, idx: np.ndarray):
        paths = [self.index.paths[i] for i in idx]
        imgs, ok = native_decode.decode_batch(paths, self.image_size, self.n_workers)
        for j in np.flatnonzero(~ok):
            self._warn_failed(paths[j])
        return imgs, self.index.labels[idx]

    def _producer(self):
        try:
            for idx in self.sampler:
                if self._stop.is_set():
                    return
                batch = self._load_batch(idx)
                while not self._stop.is_set():
                    try:
                        self.queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as exc:  # surface in the consumer, don't hang
            self._put_control(_ProducerError(exc))
            return
        self._put_control(_END_OF_DATA)  # finite sampler: clean stop

    def _put_control(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def __iter__(self):
        if not self._started:
            self._thread.start()
            self._started = True
        while not self._stop.is_set():
            item = self.queue.get()
            if item is _END_OF_DATA:
                return
            if isinstance(item, _ProducerError):
                raise RuntimeError("loader producer failed") from item.exc
            yield item

    def stop(self):
        self._stop.set()
        # Drain so the producer can exit a blocked put.
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass


def benchmark_loader(loader: BatchLoader, n_batches: int = 10) -> dict:
    """Loader throughput: images and batches per second after one warm batch."""
    it = iter(loader)
    next(it)  # warm
    t0 = time.perf_counter()
    n_images = 0
    for _ in range(n_batches):
        imgs, _ = next(it)
        n_images += len(imgs)
    dt = time.perf_counter() - t0
    return {
        "images_per_sec": n_images / dt,
        "batches_per_sec": n_batches / dt,
        "seconds_per_batch": dt / n_batches,
    }

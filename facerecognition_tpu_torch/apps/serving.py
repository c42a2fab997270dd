"""Dynamic micro-batching onto the fused serving call.

Counterpart of ``facerecognition_tpu/apps/serving.py``: concurrent
``submit(frame)`` calls are coalesced into one
``RecognitionEngine.fused_recognize_frames`` call per batch, padded to the
standard bucket sizes. Requests wait at most ``max_delay_ms`` after the first
arrival; one dispatcher thread owns the device and request threads block on
an event. Frames are resized on the host by ``bilinear_resize_u8``, which
computes ``cv2.resize(INTER_LINEAR)`` on uint8 bit for bit.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.ops.image import bilinear_resize_u8

BUCKETS = (1, 8, 32, 128, 512)


class OverloadedError(RuntimeError):
    """Raised by ``submit`` when the pending queue is at capacity (load
    shedding; an HTTP front end maps it to 429)."""


class _Item:
    __slots__ = ("frame", "event", "result", "error")

    def __init__(self, frame: np.ndarray):
        self.frame = frame
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Coalesce concurrent ``submit(frame)`` calls into fused batches.

    Args:
      engine: a ``RecognitionEngine`` with a detector and non-empty gallery.
      frame_size: every frame is resized on the host to this (H, W).
      k: top-k identities per face.
      max_faces: faces per frame; above 1 the engine serves the crowd path.
      max_batch: cap per dispatch (also the largest pad bucket used).
      max_delay_ms: how long the first request of a batch waits for company.
      request_timeout: default ``submit`` wait in seconds.
      max_queue: pending-request cap; past it ``submit`` raises
        ``OverloadedError`` instead of queueing.
    """

    def __init__(
        self,
        engine,
        frame_size: tuple[int, int] = (256, 256),
        k: int = 5,
        max_faces: int = 1,
        max_batch: int = 128,
        max_delay_ms: float = 5.0,
        request_timeout: float = 600.0,
        max_queue: int = 1024,
    ):
        self._engine = engine
        self._frame_size = tuple(frame_size)
        self._k = k
        self._max_faces = max_faces
        self._max_batch = int(max_batch)
        self._max_delay = max_delay_ms / 1000.0
        self._request_timeout = request_timeout
        self._max_queue = int(max_queue)
        self._queue: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._lifecycle_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_padded = 0
        self._n_rejected = 0
        self._dispatch_s = 0.0  # seconds inside fused calls (device duty cycle)
        self._latencies: deque[float] = deque(maxlen=4096)
        self._closed = False
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="micro-batcher"
        )
        self._thread.start()

    # -- request side --------------------------------------------------------

    def submit(self, frame: np.ndarray, timeout: Optional[float] = None) -> dict:
        """Recognize one frame; blocks until its batch returns. Raises what
        the fused call raised, or ``TimeoutError`` after ``timeout`` seconds
        (default: the constructor's ``request_timeout``)."""
        return self.submit_many([frame], timeout=timeout)[0]

    def submit_many(self, frames, timeout: Optional[float] = None) -> list[dict]:
        """Recognize N frames from one caller; admission is all-or-nothing."""
        prepared = [self._prepare(f) for f in frames]
        if not prepared:
            return []
        items = [_Item(f) for f in prepared]
        t_submit = time.monotonic()
        with self._lifecycle_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self._queue.qsize() + len(items) > self._max_queue:
                with self._stats_lock:
                    self._n_rejected += len(items)
                raise OverloadedError(f"pending queue at capacity ({self._max_queue})")
            for item in items:
                self._queue.put(item)
        deadline = t_submit + (self._request_timeout if timeout is None else timeout)
        for item in items:
            if not item.event.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError("recognition batch not ready in time")
        with self._stats_lock:
            dt = time.monotonic() - t_submit
            self._latencies.extend([dt] * len(items))
        for item in items:
            if item.error is not None:
                raise item.error
        return [item.result for item in items]

    def _prepare(self, frame: np.ndarray) -> np.ndarray:
        frame = np.asarray(frame)
        if frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) frame, got {frame.shape}")
        if frame.dtype != np.uint8:
            frame = np.clip(np.rint(frame), 0, 255).astype(np.uint8)
        if frame.shape[:2] != self._frame_size:
            frame = bilinear_resize_u8(torch.from_numpy(frame), *self._frame_size).numpy()
        return frame

    def stats(self) -> dict:
        with self._stats_lock:
            n_req, n_bat = self._n_requests, self._n_batches
            lat = sorted(self._latencies)
            out = {
                "requests": n_req,
                "batches": n_bat,
                "padded_frames": self._n_padded,
                "mean_batch": round(n_req / n_bat, 2) if n_bat else 0.0,
                "rejected": self._n_rejected,
                "queue_depth": self._queue.qsize(),
                "max_queue": self._max_queue,
                "dispatch_s": round(self._dispatch_s, 3),
            }
        if lat:
            # nearest-rank percentiles over the newest-4096 window
            out["latency_ms"] = {
                "p50": round(lat[int(0.50 * (len(lat) - 1))] * 1e3, 2),
                "p90": round(lat[int(0.90 * (len(lat) - 1))] * 1e3, 2),
                "p99": round(lat[int(0.99 * (len(lat) - 1))] * 1e3, 2),
                "mean": round(sum(lat) / len(lat) * 1e3, 2),
            }
        return out

    def close(self) -> None:
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # FIFO: queued requests drain first
        self._thread.join(timeout=10)

    # -- dispatcher side ------------------------------------------------------

    def _collect(self) -> Optional[list[_Item]]:
        """Block for the first item, then gather until max_batch or the delay
        window closes. Returns None on the shutdown sentinel."""
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self._max_delay
        while len(items) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # shutdown mid-collection: serve what we have
                self._queue.put(None)
                break
            items.append(nxt)
        return items

    def _dispatch_loop(self) -> None:
        while True:
            items = self._collect()
            if items is None:
                return
            n = len(items)
            bucket = next((b for b in BUCKETS if b >= n), n)
            frames = np.zeros((bucket, *self._frame_size, 3), np.uint8)
            for i, it in enumerate(items):
                frames[i] = it.frame
            t_disp = time.monotonic()
            try:
                results = self._engine.fused_recognize_frames(
                    frames, k=self._k, max_faces=self._max_faces
                )
                for it, res in zip(items, results):
                    it.result = res
            except BaseException as e:  # propagate to every waiter
                for it in items:
                    it.error = e
            finally:
                with self._stats_lock:
                    self._n_requests += n
                    self._n_batches += 1
                    self._n_padded += bucket - n
                    self._dispatch_s += time.monotonic() - t_disp
                for it in items:
                    it.event.set()

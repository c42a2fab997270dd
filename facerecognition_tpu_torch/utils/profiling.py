"""Profiling and throughput instrumentation.

Counterpart of ``facerecognition_tpu/utils/profiling.py``:

- ``trace(log_dir)``: ``torch.profiler`` around the enclosed block, the
  CPU's activity and the card's (CUDA) when one is present, written as a
  Chrome trace (``trace.json``, for Perfetto or ``chrome://tracing``) in
  ``log_dir``;
- ``ThroughputCounter``: rolling items/s and latency percentiles over the
  last N events;
- ``ms_per_call``: the measurement tools' timer (``scripts/profile_pipeline``,
  ``scripts/bench_embed``, ``examples/realtime_bench``).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator

import torch

TRACE_FILE = "trace.json"


def _leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return []


def ms_per_call(fn, inputs: tuple, iters: int, device: torch.device) -> float:
    """Best of 3 rounds of ``iters`` calls ``fn(*inputs)``, in ms per call.

    The JAX tools time a ``lax.scan`` inside one ``jit`` so that XLA cannot
    drop an unread result; eager PyTorch runs every kernel it launches, so
    here, after one warm-up call, each round's calls run between two CUDA
    events on the card (wall clock on the CPU) and the round ends on the
    second event. Nothing is read inside the rounds; a floating-point
    output of the last call that is not finite raises."""
    cuda = device.type == "cuda"
    out = fn(*inputs)
    best = float("inf")
    for _ in range(3):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*inputs)
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    for t in _leaves(out):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError("an output of the timed call is not finite")
    return best


@contextlib.contextmanager
def trace(log_dir: str = "traces") -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; yields the profiler (its
    ``key_averages()`` give the kernels' device time) and writes
    ``log_dir/trace.json`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ThroughputCounter:
    """Rolling throughput + latency percentiles over the last N events."""

    def __init__(self, window: int = 256):
        self.window = window
        self._events: deque[tuple[float, int, float]] = deque(maxlen=window)

    def record(self, n_items: int, seconds: float) -> None:
        self._events.append((time.time(), n_items, seconds))

    @contextlib.contextmanager
    def measure(self, n_items: int = 1) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(n_items, time.perf_counter() - t0)

    def stats(self) -> dict:
        if not self._events:
            return {"items_per_sec": 0.0, "p50_ms": 0.0, "p95_ms": 0.0, "n": 0}
        total_items = sum(n for _, n, _ in self._events)
        total_time = sum(s for _, _, s in self._events)
        lat = sorted(s / max(n, 1) for _, n, s in self._events)

        def pct(p: float) -> float:
            i = min(int(len(lat) * p), len(lat) - 1)
            return lat[i] * 1e3

        return {
            "items_per_sec": total_items / max(total_time, 1e-9),
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "n": len(self._events),
        }

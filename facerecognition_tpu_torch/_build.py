"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``_build/`` (git-ignored) under a
name keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and
the flags. Nothing here includes
PyTorch's headers, so a build takes seconds, not minutes. A missing
``nvcc`` or a failed build raises with the compiler's output. The build
writes to a temporary name and renames it into place, so there is no lock
file for a concurrent or interrupted build to wait on.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Sequence

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600


@dataclasses.dataclass
class Built:
    """A loaded kernel library and how it was built."""

    name: str
    path: str
    lib: ctypes.CDLL
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc's output (ptxas registers, shared memory, spills)


_lock = threading.Lock()
_loaded: dict[str, Built] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        candidate = os.path.join(home, "bin", "nvcc")
        nvcc = candidate if os.path.exists(candidate) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, "
            "/usr/local/cuda/bin); the CUDA kernels are built at first use"
        )
    return nvcc


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _target(name: str) -> str:
    """The library's path, keyed by the source, the shared headers of
    ``csrc/`` and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, nvcc: str) -> tuple[str, str, subprocess.Popen]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = _target(name)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, tmp, proc


def build(names: Sequence[str]) -> list[Built]:
    """Build (one nvcc each, all started together) and load ``names``."""
    with _lock:
        pending = [n for n in names if n not in _loaded]
        fresh = [n for n in pending if not os.path.exists(_target(n))]
        t0 = time.perf_counter()
        started = {}
        if fresh:
            nvcc = find_nvcc()
            started = {n: _start(n, nvcc) for n in fresh}
        logs = {}
        try:
            for n, (target, tmp, proc) in started.items():
                out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
                logs[n] = out
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {source_path(n)} "
                        f"(exit {proc.returncode}):\n{out}"
                    )
                os.replace(tmp, target)
        finally:
            for _, tmp, proc in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
        seconds = time.perf_counter() - t0
        for n in pending:
            path = _target(n)
            _loaded[n] = Built(
                n, path, ctypes.CDLL(path),
                seconds if n in started else 0.0, logs.get(n, ""),
            )
        return [_loaded[n] for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    built = _loaded.get(name)
    return built.lib if built is not None else build([name])[0].lib


class LaunchCounter:
    """Counts a wrapper's kernel launches (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        return self._n

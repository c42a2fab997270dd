"""Build the package's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface,
compiled for ``sm_90a`` at first use into ``_build/`` (git-ignored) under a
name keyed by a hash of the source, the shared ``csrc/*.cuh`` headers and
the flags. The host image decoder ``csrc/decode.cpp`` is built alike with
the host C++ compiler (``build_host``), its JPEG backend chosen from what
the machine has (``jpeg_config``). Nothing here includes
PyTorch's headers, so a build takes seconds, not minutes. A missing
compiler or a failed build raises with the compiler's output. The build
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
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_LIBS = ("-lz", "-lpthread")


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


def cuda_home() -> str:
    """The CUDA toolkit's root: ``$CUDA_HOME``, else nvcc's, else
    ``/usr/local/cuda``."""
    if os.environ.get("CUDA_HOME"):
        return os.environ["CUDA_HOME"]
    nvcc = shutil.which("nvcc")
    return os.path.dirname(os.path.dirname(nvcc)) if nvcc else "/usr/local/cuda"


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _target(name: str, source: str = "", flags: Sequence[str] = NVCC_FLAGS) -> str:
    """The library's path, keyed by the source, the shared headers of
    ``csrc/`` and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source or source_path(name)] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
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


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH; the image decoder is "
                           "built at first use")
    return cxx


def _has_header(cxx: str, header: str, extra: Sequence[str] = ()) -> bool:
    probe = subprocess.run(
        [cxx, "-E", "-x", "c++", *extra, "-"], input=f"#include <cstdio>\n#include <{header}>\n",
        capture_output=True, text=True, timeout=60,
    )
    return probe.returncode == 0


def _has_library(cxx: str, lib: str) -> bool:
    found = subprocess.run(
        [cxx, f"-print-file-name=lib{lib}.so"], capture_output=True, text=True, timeout=60
    ).stdout.strip()
    return os.path.isabs(found) and os.path.exists(found)


def jpeg_config(cxx: str) -> tuple[str, tuple[str, ...]]:
    """How the decoder reads JPEG here, and its flags: ``libjpeg`` where its
    header and library are found; else ``nvjpeg``, the CUDA toolkit's
    (decoded on the card); else ``none``, and decoding a JPEG raises."""
    if _has_header(cxx, "jpeglib.h") and _has_library(cxx, "jpeg"):
        return "libjpeg", ("-DFRT_JPEG_LIBJPEG", "-ljpeg")
    home = cuda_home()
    inc, lib = os.path.join(home, "include"), os.path.join(home, "lib64")
    if os.path.exists(os.path.join(inc, "nvjpeg.h")) and os.path.exists(os.path.join(lib, "libnvjpeg.so")):
        return "nvjpeg", ("-DFRT_JPEG_NVJPEG", f"-I{inc}", f"-L{lib}", f"-Wl,-rpath,{lib}",
                          "-lnvjpeg", "-lcudart_static", "-ldl", "-lrt")
    return "none", ()


def build_host(name: str = "decode") -> Built:
    """Build (once) and load ``csrc/<name>.cpp`` with the host C++ compiler."""
    key = f"host:{name}"
    with _lock:
        if key in _loaded:
            return _loaded[key]
        cxx = find_cxx()
        source = os.path.join(CSRC_DIR, f"{name}.cpp")
        _, jpeg_flags = jpeg_config(cxx)
        flags = (*HOST_CXX_FLAGS, *jpeg_flags, *HOST_LIBS)
        target = _target(name, source, flags)
        seconds, log = 0.0, ""
        if not os.path.exists(target):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [cxx, *HOST_CXX_FLAGS, "-o", tmp, source, *jpeg_flags, *HOST_LIBS],
                    capture_output=True, text=True, timeout=NVCC_TIMEOUT_S,
                )
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"{cxx} failed on {source} (exit {proc.returncode}):\n{log}")
                os.replace(tmp, target)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            seconds = time.perf_counter() - t0
        _loaded[key] = Built(name, target, ctypes.CDLL(target), seconds, log)
        return _loaded[key]


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

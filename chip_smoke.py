#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``facerecognition_tpu_torch``) on one NVIDIA card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc builds every kernel of the path from ``csrc/`` (seconds and
   the ptxas register / shared-memory / spill lines).
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, at the serving match shapes, with planted duplicate rows (the lowest
   index must win); kernel, plain and library times by CUDA events.
4. serving: the shipped detector and ArcFace assets on the card, a
   100,000-row gallery with each frame's own embedding planted, and 16
   requests through ``MicroBatcher`` from 4 threads with the streaming
   kernel as the matcher. Every top-1 must be its planted row; the same
   frames through the port on the CPU (plain versions) must agree.

It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the exit code
is not 0; without a CUDA card it exits 2 before printing any result. A
watchdog ends the run, with a stack dump, after 900 s.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import re
import subprocess
import sys
import threading
import time

WATCHDOG_S = 900
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the float32 (non-tensor-core) rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
KERNEL_CASES = (  # (B, N, D, k)
    (128, 1_000_000, 512, 5),
    (1, 1_000_000, 512, 5),
    (32, 100_000, 512, 5),
    (7, 3_001, 512, 10),
    (40, 5_000, 512, 16),
    (3, 5_000, 512, 32),
    (4, 3, 512, 5),
)
GALLERY_ROWS = 100_000
N_FRAMES = 16
N_CLIENTS = 4
FRAME = (256, 256)


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_topk(s, i, rs, ri, tol: float, what: str) -> float:
    """Scores within ``tol``; indices equal wherever the plain version's
    neighbouring scores differ by more than ``tol``. Returns max |Δscore|."""
    import torch

    err = (s - rs).abs().max().item()
    check(err <= tol, f"{what}: max |score - plain| {err} > {tol}")
    gap = torch.full_like(rs, float("inf"))
    d = rs[:, :-1] - rs[:, 1:]
    gap[:, :-1] = d
    gap[:, 1:] = torch.minimum(gap[:, 1:], d)
    clear = gap > tol
    check(bool((i[clear] == ri[clear]).all()), f"{what}: indices differ from plain")
    return err


def kernel_phase(device):
    import torch

    from facerecognition_tpu_torch.ops import stream_topk as st

    gen = torch.Generator(device=device).manual_seed(SEED)
    max_err = 0.0
    main = None
    for b, n, d, k in KERNEL_CASES:
        q = torch.randn(b, d, generator=gen, device=device)
        g = torch.randn(n, d, generator=gen, device=device)
        planted = None
        if n > 2:
            lo, hi = n // 3, n - 1
            g[hi] = g[lo]  # duplicate rows: the lower index must come first
            q[0] = g[lo] * 3.0
            planted = (lo, hi)
        s, i = st.stream_topk(q, g, k)
        torch.cuda.synchronize()
        rs, ri = st.stream_topk_reference(q, g, k)
        err = check_topk(s, i, rs, ri, 1e-5, f"stream_topk B={b} N={n} D={d} k={k}")
        max_err = max(max_err, err)
        if planted is not None:
            check(
                i[0, :2].tolist() == list(planted),
                f"planted duplicates {planted} came back as {i[0, :2].tolist()}",
            )
        if k > n:
            check(
                bool((s[:, n:] == st.UNFILLED_SCORE).all() and (i[:, n:] == 0).all()),
                "unfilled slots must hold (-1e30, 0)",
            )
        line = {"B": b, "N": n, "D": d, "k": k, "max_abs_err": err}
        if b * n >= 10**6:
            qn = torch.nn.functional.normalize(q, dim=1)
            gn = torch.nn.functional.normalize(g, dim=1)
            line["ms"] = cuda_ms(lambda: st.stream_topk(q, g, k), 10)
            line["plain_ms"] = cuda_ms(lambda: st.stream_topk_reference(q, g, k), 3, 1)
            line["library_ms"] = cuda_ms(lambda: torch.topk(qn @ gn.T, k), 10)
            bytes_moved = (n * d + b * d) * 4 + b * k * 8
            flops = 2 * b * n * d + 2 * (n + b) * d
            line["bound_bytes_ms"] = bytes_moved / HBM_BYTES_PER_S * 1e3
            line["bound_ops_ms"] = flops / FP32_FLOPS_PER_S * 1e3
            line["bound_ms"] = max(line["bound_bytes_ms"], line["bound_ops_ms"])
            line["bound_by"] = (
                "bytes" if line["bound_bytes_ms"] >= line["bound_ops_ms"] else "operations"
            )
            if main is None:
                main = line
        print("stream_topk", json.dumps(line), flush=True)
        del q, g
    torch.cuda.empty_cache()
    return max_err, main


def serving_phase(card: str):
    import numpy as np

    from facerecognition_tpu_torch.apps.serving import MicroBatcher
    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        load_arcface_model,
    )
    from facerecognition_tpu_torch.ops import stream_topk as st
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    rng = np.random.default_rng(SEED)
    # Smooth random frames: noise upsampled 16x, so the warp and the
    # detector see structure rather than pixel noise.
    coarse = rng.integers(0, 256, (N_FRAMES, FRAME[0] // 16, FRAME[1] // 16, 3))
    frames = np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2).astype(np.uint8)
    rows = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    names = [f"id{r:06d}" for r in range(GALLERY_ROWS)]
    planted = [int(r) for r in rng.choice(GALLERY_ROWS, N_FRAMES, replace=False)]

    def build_engine(device):
        detector = FaceDetector(confidence_threshold=0.0, min_face_size=0, device=device)
        embedder = load_arcface_model(default_arcface_checkpoint(), device=device)
        gallery = Gallery(512, device=device)
        gallery.add_many(names, rows)
        return RecognitionEngine(
            embedder, gallery, detector, match_kernel="stream", device=device
        )

    t0 = time.perf_counter()
    engine = build_engine(None)  # the entry points' default device: the card
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    first = engine.fused_recognize_frames(frames)
    own = np.stack([r["embedding"] for r in first])
    engine.gallery.add_many([names[r] for r in planted], own)
    print(f"engine ready, gallery planted: {time.perf_counter() - t0:.3f} s", flush=True)

    batcher = MicroBatcher(engine, frame_size=FRAME, max_delay_ms=5)
    results: dict[int, dict] = {}
    latencies: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(ids):
        for f in ids:
            t = time.perf_counter()
            try:
                res = batcher.submit(frames[f], timeout=120)
            except BaseException as e:  # reported by the main thread
                with lock:
                    errors.append(e)
                return
            with lock:
                results[f] = res
                latencies.append(time.perf_counter() - t)

    st.launches.reset()
    threads = [
        threading.Thread(target=client, args=(range(c, N_FRAMES, N_CLIENTS),))
        for c in range(N_CLIENTS)
    ]
    t_serve = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        batcher.close()
    serve_s = time.perf_counter() - t_serve
    launches = st.launches.count
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    check(len(results) == N_FRAMES, f"{len(results)} of {N_FRAMES} answers")
    check(launches > 0, "the serving path launched no stream_topk kernel")
    for f in range(N_FRAMES):
        name, score = results[f]["top_k"][0]
        check(
            name == names[planted[f]] and score > 0.99,
            f"frame {f}: top-1 {name} {score}, planted {names[planted[f]]}",
        )
    lat = sorted(latencies)
    stats = batcher.stats()
    print(
        "serving", json.dumps({
            "card": card, "requests": N_FRAMES, "clients": N_CLIENTS,
            "batches": stats["batches"], "wall_s": serve_s,
            "latency_ms_p50": lat[(len(lat) - 1) // 2] * 1e3,
            "latency_ms_p99": lat[int(0.99 * (len(lat) - 1))] * 1e3,
            "stream_topk_launches": launches,
        }),
        flush=True,
    )

    t0 = time.perf_counter()
    cpu_engine = build_engine("cpu")
    cpu_engine.gallery.add_many([names[r] for r in planted], own)
    cpu = cpu_engine.fused_recognize_frames(frames)
    worst = 1.0
    for f in range(N_FRAMES):
        e_gpu, e_cpu = results[f]["embedding"], cpu[f]["embedding"]
        cos = float(e_gpu @ e_cpu / (np.linalg.norm(e_gpu) * np.linalg.norm(e_cpu)))
        worst = min(worst, cos)
        check(cos > 0.999, f"frame {f}: card vs CPU embedding cosine {cos}")
        check(
            results[f]["top_k"][0][0] == cpu[f]["top_k"][0][0],
            f"frame {f}: card top-1 {results[f]['top_k'][0]} vs CPU {cpu[f]['top_k'][0]}",
        )
    print(
        f"cpu plain path agrees: min embedding cosine {worst}, "
        f"{time.perf_counter() - t0:.3f} s", flush=True,
    )
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    from facerecognition_tpu_torch import _build

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        card = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} CUDA {torch.version.cuda}: {card}", flush=True)

    with phase("build"):
        for built in _build.build(["stream_topk"]):
            print(f"{built.name}: nvcc {built.seconds:.2f} s -> {built.path}", flush=True)
            for line in built.log.splitlines():
                entry = re.search(r"Compiling entry function '(\w+)'", line)
                if entry:  # the mangled name holds the kernel and its template values
                    print("  " + entry.group(1), flush=True)
                elif "Used" in line or "spill" in line or "error" in line.lower():
                    print("    " + line.strip(), flush=True)

    with phase("kernels"):
        max_err, main_case = kernel_phase(torch.device("cuda", 0))

    with phase("serving"):
        launches = serving_phase(f"{smi}")

    kernels = [{
        "name": "stream_topk",
        "route": "cuda",
        "source": "facerecognition_tpu_torch/csrc/stream_topk.cu",
        "replaces": "facerecognition_tpu/ops/pallas_topk.py:34",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   index must win); kernel, plain and library times by CUDA events, the
   kernel and the library timed in turns (library, kernel, kernel, library)
   and reported as medians; the host time of a call, the device time of
   each of the wrapper's kernels from the profiler's trace, and for the
   first case the SM clock and power draw under load (nvidia-smi).
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
import statistics
import subprocess
import sys
import threading
import time

WATCHDOG_S = 900
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet, dense). The kernel's bound
# is the larger of its bytes over the memory rate and its operations over
# the rate of the arithmetic it uses: three tf32 tensor-core products
# (3 * 2BND). The first design's yardstick, float32 FMA outside the tensor
# cores (2BND at 67 TFLOP/s), is printed beside it.
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
DESIGN = "3xTF32 wgmma, TMA ring, gallery rows on M"
KERNEL_CASES = (  # (B, N, D, k)
    (128, 1_000_000, 512, 5),
    (1, 1_000_000, 512, 5),
    (32, 100_000, 512, 5),
    (512, 1_000_000, 512, 5),  # the largest serving bucket: several query groups
    (300, 20_000, 512, 5),  # a ragged query group
    (5, 10_001, 132, 7),  # D not a multiple of the 32-dim chunk, ragged N
    (7, 3_001, 512, 10),
    (40, 5_000, 512, 16),
    (3, 5_000, 512, 32),
    (4, 3, 512, 5),
)
# The three kernels one stream_topk call launches.
STREAM_TOPK_KERNELS = ("split_queries", "topk_partial", "topk_merge")
TIMING_ROUNDS = 2  # each round times library, kernel, kernel, library
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


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call, the device left to run behind."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_us(fn, kernels, calls: int = 5) -> dict:
    """Device microseconds per call of each of ``kernels``, the names of the
    kernels that ``fn`` launches, from the profiler's CUDA trace. Fails if
    the trace lacks one of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", ev.key)
        base = name.split("<")[0]
        if ev.device_time_total > 0 and base in kernels:
            out[name] = out.get(name, 0.0) + ev.device_time_total / calls
    found = {name.split("<")[0] for name in out}
    check(found == set(kernels), f"profiler trace holds {sorted(found)}, not {list(kernels)}")
    return out


def clocks_under_load(fn, seconds: float = 2.0) -> dict:
    """SM clock (MHz) and power draw (W) sampled by nvidia-smi every 100 ms
    while ``fn`` runs back to back for about ``seconds``."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=30)
    rows = [re.fullmatch(r"\s*([\d.]+),\s*([\d.]+)\s*", ln) for ln in text.splitlines()]
    rows = [(float(m.group(1)), float(m.group(2))) for m in rows if m]
    check(bool(rows), f"nvidia-smi gave no clock or power samples: {text[:200]!r}")
    return {
        "samples": len(rows),
        "sm_clock_mhz_median": statistics.median(r[0] for r in rows),
        "sm_clock_mhz_min": min(r[0] for r in rows),
        "power_w_max": max(r[1] for r in rows),
    }


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
        p = st.plan(b, n, k, torch.cuda.get_device_properties(device).multi_processor_count)
        line = {
            "B": b, "N": n, "D": d, "k": k, "max_abs_err": err,
            "plan": {f: getattr(p, f) for f in ("width", "groups", "n_split")},
        }
        if b * n >= 10**6:
            qn = torch.nn.functional.normalize(q, dim=1)
            gn = torch.nn.functional.normalize(g, dim=1)
            kernel = lambda: st.stream_topk(q, g, k)  # noqa: E731
            library = lambda: torch.topk(qn @ gn.T, k)  # noqa: E731
            fns = {"kernel": kernel, "library": library}
            times = {"kernel": [], "library": []}
            for _ in range(TIMING_ROUNDS):
                for name in ("library", "kernel", "kernel", "library"):
                    times[name].append(cuda_ms(fns[name], 10))
            line["ms"] = statistics.median(times["kernel"])
            line["library_ms"] = statistics.median(times["library"])
            line["ms_samples"] = times["kernel"]
            line["library_ms_samples"] = times["library"]
            line["plain_ms"] = cuda_ms(lambda: st.stream_topk_reference(q, g, k), 3, 1)
            line["host_us_per_call"] = host_us(kernel)
            line["device_us"] = device_us(kernel, STREAM_TOPK_KERNELS)
            bytes_moved = (n * d + b * d) * 4 + b * k * 8
            line["bound_bytes_ms"] = bytes_moved / HBM_BYTES_PER_S * 1e3
            line["bound_ops_ms"] = 3 * 2 * b * n * d / TF32_FLOPS_PER_S * 1e3
            line["bound_ms"] = max(line["bound_bytes_ms"], line["bound_ops_ms"])
            line["bound_by"] = (
                "bytes" if line["bound_bytes_ms"] >= line["bound_ops_ms"] else "operations"
            )
            line["bound_fp32_simt_ms"] = max(
                line["bound_bytes_ms"], 2 * b * n * d / FP32_FLOPS_PER_S * 1e3
            )
            if main is None:
                main = line
                line["under_load"] = clocks_under_load(kernel)
        print("stream_topk", json.dumps(line), flush=True)
        q = g = qn = gn = kernel = library = None  # free this case's gallery
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
        "design": DESIGN,
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

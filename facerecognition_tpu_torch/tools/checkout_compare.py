"""This checkout's kernels against another checkout's, on the card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 -m facerecognition_tpu_torch.tools.checkout_compare OTHER [SECTION ...]

where OTHER is a checkout of another tree of this repository, for example
``git archive <commit> | tar -x -C _archive/parent`` (a git-ignored
directory), and the sections are ``int8``, ``fused`` and ``lbph`` (all by
default; ``lbph`` needs only the package, the others the shipped assets).
Each tree runs in a process of its own, in turns (OTHER, this, this,
OTHER), and builds its kernels from its own sources into its own build
directory. Each process measures, on the same seeded inputs and through the
API both trees share:

- ``int8``: ``int8_topk_codes`` at ``SHAPES`` and on a gallery whose scores
  rise with the row (every row enters every list): the device µs per call
  of pass 1 + merge (profiler), the median of ``WINDOWS`` windows;
- ``fused``: one fused call (``fused_recognize_frames``, B = 128 frames of
  256², one face, a 100k-row gallery) with ``match_kernel`` ``int8`` and
  ``stream``, in alternating turns (``ROUNDS`` rounds of ``CALLS`` calls of
  each, the first kind alternating by round): the median wall ms per call,
  the spread of the rounds, and the device events per call (profiler);
- ``lbph``: chip_smoke.py's LBPH data: ``lbph_hist`` device µs at B = 128
  and 4096 (profiler), ``chi2_nn`` ms (CUDA events, the median of
  ``WINDOWS``) at (128, 75,000), (1, 75,000) and with ``return_distances``
  at (8, 4,096), and ``LBPHModel`` on 75,000 faces: ``train_s`` and
  ``predict_batch_s`` for 128 probes (host clock, synchronised);
- a digest of the results (matches, features, nearest rows), which must
  agree across the trees (the same functions on the same inputs).

It prints each process's line and a summary of both trees' numbers side by
side, and fails if the digests differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHAPES = ((128, 1_000_000, 512, 5), (128, 100_000, 512, 5), (1, 1_000_000, 512, 5),
          (32, 100_000, 512, 5))
RISING = (128, 1_000_000, 512, 5)
MATCH_KERNELS = ("int8_partial", "topk_merge")
WINDOWS = 3
ROUNDS = 5
CALLS = 10
FUSED_BATCH = 128
GALLERY_ROWS = 100_000
SEED = 0
WORKER_TIMEOUT_S = 600
LBPH_BATCHES = (128, 4096)
LBPH_ROWS = 75_000


def device_us(fn, kernels, calls: int = 20, attempts: int = 5) -> float:
    """Device µs per call of ``fn``: each of ``kernels`` (base names, one
    launch a call) from the profiler, its total over the events the window
    holds (the tracer now and then drops some, or a whole window, which is
    then taken again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    totals = {}
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        totals = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            base = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key).split("<")[0]
            us, n = totals.get(base, (0.0, 0))
            totals[base] = (us + e.device_time_total, n + e.count)
        if all(totals.get(k, (0, 0))[1] >= calls // 2 for k in kernels):
            return sum(totals[k][0] / totals[k][1] for k in kernels)
        time.sleep(1.0)
    raise RuntimeError(f"no profiler window held the kernels of {kernels}: {totals}")


def events_per_call(fn, calls: int = 3) -> float:
    """Kernel launches per call of ``fn`` in the profiler's trace (copies
    and memsets not counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):  # the tracer now and then drops a whole window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(("Memcpy", "Memset")))
        if n:
            return n / calls
        time.sleep(1.0)
    raise RuntimeError("no profiler window held a device event")


def alternate_ms(fns: dict, rounds: int = ROUNDS, calls: int = CALLS) -> dict:
    """Wall ms per call of each of ``fns`` (host clock, synchronised), timed
    in alternating turns: ``rounds`` rounds of ``calls`` calls of each, the
    first one taken by turns. {name: {"ms": median, "rounds_ms": [...]}}."""
    import torch

    names = list(fns)
    for fn in fns.values():
        fn()
    samples = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[name]()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) / calls * 1e3)
    return {name: {"ms": statistics.median(v), "rounds_ms": v} for name, v in samples.items()}


def smooth_frames(rng, n: int, side: int):
    """chip_smoke.py's frames: noise upsampled 16x."""
    import numpy as np

    coarse = rng.integers(0, 256, (n, side // 16, side // 16, 3))
    return np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2).astype(np.uint8)


def lbph_faces(gen, identities: int, samples: int, device):
    """``tools/lbph_data.lbph_faces`` of this checkout, loaded from its file
    (the worker's package may be another checkout's, which may lack it)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lbph_data.py")
    spec = importlib.util.spec_from_file_location("_checkout_compare_lbph_data", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.lbph_faces(gen, identities, samples, device)


def events_ms(fn, calls: int = 3) -> float:
    """ms per call of ``fn`` by CUDA events, after one call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def lbph_worker(device, digest) -> dict:
    """The ``lbph`` section (see the module's docstring)."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.lbph import LBPHModel
    from facerecognition_tpu_torch.ops import chi2_nn as cn
    from facerecognition_tpu_torch.ops import lbph_hist as lh

    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    for b in LBPH_BATCHES:
        imgs = lbph_faces(gen, b, 1, device)
        call = lambda: lh.lbph_hist(imgs)  # noqa: E731
        digest.update(call().cpu().numpy().tobytes())
        out[f"lbph_hist B={b} us"] = statistics.median(
            device_us(call, ("lbph_hist",)) for _ in range(WINDOWS))
    identities, samples = LBPH_ROWS // 10, 10
    faces = lbph_faces(gen, identities, samples, device)
    labels = np.repeat(np.arange(identities), samples)
    probes = torch.cat([faces[:: LBPH_ROWS // 64][:64], lbph_faces(gen, 64, 1, device)])
    model = LBPHModel(device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.train(faces, labels)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    model.predict_batch(probes)
    t0 = time.perf_counter()
    pred, conf = model.predict_batch(probes)
    out["predict_batch_s"] = time.perf_counter() - t0
    digest.update(pred.tobytes() + conf.tobytes())
    g = model._gallery
    q = model.features(probes)
    for b, n, dists in ((128, LBPH_ROWS, False), (1, LBPH_ROWS, False), (8, 4096, True)):
        qb, gn = q[:b].contiguous(), g[:n]
        call = lambda: cn.chi2_nn(qb, gn, dists)  # noqa: E731
        for t in call():
            digest.update(t.cpu().numpy().tobytes())
        key = f"chi2_nn B={b} N={n}" + (" return_distances" if dists else "") + " ms"
        out[key] = statistics.median(events_ms(call) for _ in range(WINDOWS))
    return out


def int8_worker(device, digest) -> dict:
    """The ``int8`` section."""
    import torch

    from facerecognition_tpu_torch.ops import int8_topk as it
    from facerecognition_tpu_torch.ops import matcher as m

    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED)
    for b, n, d, k in SHAPES:
        q = torch.randn(b, d, generator=gen, device=device)
        g = torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device=device), dim=1)
        gq, gs = m.quantize_embeddings_int8(g)
        qq, qs = it.quantize_queries(q)
        call = lambda: it.int8_topk_codes(qq, qs, gq, gs, k)  # noqa: E731
        for t in call():
            digest.update(t.cpu().numpy().tobytes())
        out[f"B={b} N={n} us"] = statistics.median(device_us(call, MATCH_KERNELS) for _ in range(WINDOWS))
        del q, g, gq, gs, qq, qs, call
    b, n, d, k = RISING  # chip_smoke.py's rising-score gallery
    gq = torch.randint(1, 128, (1, d), generator=gen, device=device, dtype=torch.int8).expand(n, d)
    gq = gq.contiguous()
    gs = 0.5 + torch.arange(n, device=device, dtype=torch.float32) * 2.0**-22
    qq, qs = it.quantize_queries(torch.rand(b, d, generator=gen, device=device) + 0.1)
    call = lambda: it.int8_topk_codes(qq, qs, gq, gs, k)  # noqa: E731
    for t in call():
        digest.update(t.cpu().numpy().tobytes())
    out[f"rising B={b} N={n} us"] = statistics.median(
        device_us(call, MATCH_KERNELS, calls=5) for _ in range(WINDOWS))
    del gq, gs, qq, qs, call
    torch.cuda.empty_cache()
    return out


def fused_worker(device, digest) -> dict:
    """The ``fused`` section."""
    import numpy as np

    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        load_arcface_model,
    )
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    rng = np.random.default_rng(SEED)
    frames = smooth_frames(rng, FUSED_BATCH, 256)
    rows = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    names = [f"id{r:06d}" for r in range(GALLERY_ROWS)]
    detector = FaceDetector(confidence_threshold=0.0, min_face_size=0, device=device)
    embedder = load_arcface_model(default_arcface_checkpoint(), device=device)
    fns = {}
    for kind in ("int8", "stream"):
        gallery = Gallery(512, device=device)
        gallery.add_many(names, rows)
        engine = RecognitionEngine(embedder, gallery, detector, match_kernel=kind, device=device)
        fns[kind] = lambda e=engine: e.fused_recognize_frames(frames, max_faces=1)
    fused = alternate_ms(fns)
    for kind, fn in fns.items():
        fused[kind]["events_per_call"] = events_per_call(fn)
    return {"fused": fused}


SECTIONS = {"int8": int8_worker, "fused": fused_worker, "lbph": lbph_worker}


def worker(sections) -> dict:
    """One tree's numbers (the package PYTHONPATH names)."""
    import torch

    import facerecognition_tpu_torch

    device = torch.device("cuda", 0)
    out = {"package": os.path.dirname(os.path.abspath(facerecognition_tpu_torch.__file__))}
    digest = hashlib.sha256()
    for name in sections:
        out.update(SECTIONS[name](device, digest))
    out["digest"] = digest.hexdigest()[:16]
    return out


def run(tree: str, sections) -> dict:
    env = dict(os.environ, PYTHONPATH=tree)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", *sections],
                          cwd=tree, env=env,
                          capture_output=True, text=True, timeout=WORKER_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"the worker in {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("checkout_compare ")][-1]
    out = json.loads(line.split(" ", 1)[1])
    out["tree"], out["seconds"] = tree, time.perf_counter() - t0
    print("checkout_compare", json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        print("checkout_compare", json.dumps(worker(argv[1:])), flush=True)
        return 0
    if not argv or set(argv[1:]) - set(SECTIONS):
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    sections = argv[1:] or list(SECTIONS)
    runs = [run(tree, sections) for tree in (other, HERE, HERE, other)]
    if len({r["digest"] for r in runs}) != 1:
        raise SystemExit(f"the trees' results differ: {[r['digest'] for r in runs]}")
    summary = {}
    for key in runs[0]:
        if key.endswith((" us", " ms", "_s")):
            summary[key] = {"other": [runs[0][key], runs[3][key]], "this": [runs[1][key], runs[2][key]]}
    if "fused" in sections:
        for kind in ("int8", "stream"):
            for key in ("ms", "events_per_call"):
                summary[f"fused {kind} {key}"] = {
                    "other": [runs[0]["fused"][kind][key], runs[3]["fused"][kind][key]],
                    "this": [runs[1]["fused"][kind][key], runs[2]["fused"][kind][key]]}
    print("checkout_compare summary", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

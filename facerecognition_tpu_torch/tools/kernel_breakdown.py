"""Where the time of the port's hand-written kernels goes, on the card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 -m facerecognition_tpu_torch.tools.kernel_breakdown [--tree DIR] [SECTION ...]

(every section, or those named: detect_post, warp_sample, int8_phases,
int8_variants, chi2_phases, lbph_hist_phases, chi2_variants,
lbph_variants; ``--tree
DIR`` takes the sources and wrappers of the checkout at DIR, for example
an earlier design of ``chi2_nn`` and ``lbph_hist`` from ``git archive
<commit> facerecognition_tpu_torch``). It builds patched copies of the kernels'
sources into the build directory (the sources in ``csrc/`` are not
touched) and prints:

- ``detect_post``: the cycles (``clock64``) of each phase of one frame's
  warp, median over the 128 frames of the crowd path's shape (896 anchors,
  M = 4 and 16), from stamps the patched copy writes to its box output;
- ``warp_sample``: the device time (profiler) of the align warp (B = 128,
  256² → 112²) and the window warp (B = 32 x M = 4) as built, with the
  per-slot solve replaced by a read of precomputed parameters, and with
  every tile read from global memory instead of the stage;
- ``int8_topk``: the cycles (``clock64``) of each phase of a consumer per
  128-row tile at the timed shapes of ``chip_smoke.py`` (waiting for a
  stage, the products, the register filter, the fold and its barriers),
  the cycles before its first tile and of that tile, and the consumers'
  and the grid's time from entry to end (``%globaltimer``); and the device
  time (profiler) of one call as built and with one of its choices undone
  each: the threshold filter off, the epilogue not overlapped with the
  other consumer's products, the bounded round off; taken in turns (each
  variant, then each again in reverse order), at the same shapes and on a
  gallery whose scores rise with the row.
- ``chi2_phases``: the cycles of thread 0 of each block per phase of
  ``chi2_nn`` at (128, 75,000, 16,384) and (1, 75,000) on chip_smoke.py's
  histograms: the dense design's ``chi2_partial`` (staging a chunk, its
  term loop, the epilogue) or the filter design's ``chi2_filter`` (waiting
  for a staged chunk, the loop over the query bits, the epilogue), with
  the call's ms;
- ``lbph_hist_phases``: the same for ``lbph_hist`` at B = 128 and 4096
  (a block per cell: zeroing, codes + atomics, write-out; a block per
  band: zeroing, staging, codes + atomics, the last barrier, write-out);
- ``chi2_variants``: the ms of ``chi2_nn`` as built and with one choice
  undone each (no skipping, skipping without the filter, the filter
  without prefetch), in turns, at the shapes of ``chi2_phases``;
- ``lbph_variants``: the device µs of ``lbph_hist`` as built and with
  every plan's taps read at their offsets in shared memory, in turns, at
  B = 128 and 4096 (r 1) and B = 128 (r 2), every window printed.

Each patch asserts the text it replaces, so a kernel that changed shape
fails here loudly instead of measuring something else.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import sys

import numpy as np
import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.models.detector_net import anchor_centers
from facerecognition_tpu_torch.ops import detect_post as dp
from facerecognition_tpu_torch.ops import int8_topk as it
from facerecognition_tpu_torch.ops import matcher
from facerecognition_tpu_torch.ops import warp_mxu, warp_sample as ws

PACKAGE_CSRC = _build.CSRC_DIR
#: The sources the sections patch and the wrappers they call: this
#: checkout's, or another tree's (``--tree DIR``).
SOURCE_DIR = PACKAGE_CSRC
PHASES = ("keys", "select", "counts", "tie search", "compaction", "sort", "decode", "nms")
_PHASE_MARKS = (
    "  // 2. radix select", "  const int need = K - grp.reduce", "  int amax = INT_MAX;",
    "  // compaction", "  // 3. bitonic sort", "  // 4. the candidates' boxes",
    "  int n_valid = 0;", "  grp.sync();\n\n  // 5. fixed-shape outputs",
)


def _patched(name: str, source: str, patches) -> None:
    """Build csrc/ with ``patches`` [(old, new)] applied to ``source`` into
    a directory of its own under the build directory, and load from it."""
    out = os.path.join(_build.BUILD_DIR, "breakdown", name)
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(SOURCE_DIR):
        with open(os.path.join(SOURCE_DIR, f)) as fh:
            text = fh.read()
        if f == source:
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f"{source} no longer holds {old[:60]!r}")
                text = text.replace(old, new, 1)
        with open(os.path.join(out, f), "w") as fh:
            fh.write(text)
    _build.CSRC_DIR, _build.BUILD_DIR = out, os.path.join(out, "_build")
    _build._loaded.clear()


def _restore() -> None:
    _build.CSRC_DIR = PACKAGE_CSRC
    _build.BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_CSRC), "_build")
    _build._loaded.clear()


def _wrapper(name: str):
    """``ops/<name>.py`` of the tree the sources come from, loaded from its
    file (it builds through this package's ``_build``, which ``_patched``
    points at the patched copy)."""
    import importlib.util

    path = os.path.join(os.path.dirname(SOURCE_DIR), "ops", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_breakdown_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def _stamps_for(source: str, designs: dict) -> tuple[str, list]:
    """The design whose marker ``source`` holds, and its patches."""
    with open(os.path.join(SOURCE_DIR, source)) as fh:
        text = fh.read()
    found = [(name, patches) for name, (marker, patches) in designs.items() if marker in text]
    if len(found) != 1:
        raise RuntimeError(f"{source}: no single known design ({[n for n, _ in found]})")
    return found[0]


def _read_phases(lib, names) -> dict:
    buf = (ctypes.c_ulonglong * 16)()
    if lib.phases_read(buf):
        raise RuntimeError("could not read the phase cycles")
    return dict(zip(names, buf))


def detect_post_phases(device) -> dict:
    stamp = "  clk[nclk++] = clock64();\n"
    patches = [("  // 1. keys, as unsigned words",
                "  long long clk[12]; int nclk = 0;\n" + stamp + "  // 1. keys, as unsigned words")]
    patches += [(m, stamp + m) for m in _PHASE_MARKS]
    patches.append(("  // 5. fixed-shape outputs", stamp + (
        "  if (g == 0)\n    for (int q = 1; q < nclk; ++q)\n"
        "      out_box[(size_t)f * M * 4 + q - 1] = (float)(clk[q] - clk[q - 1]);\n"
        "  return;\n  // 5. fixed-shape outputs")))
    _patched("detect_post_phases", "detect_post.cu", patches)
    try:
        anchors = torch.as_tensor(anchor_centers(128), device=device)
        gen = torch.Generator(device=device).manual_seed(0)
        raw = torch.randn(128, anchors.shape[0], 15, generator=gen, device=device) * 2.0
        raw[..., 0] *= 4.0
        raw[:64, 40:90, 0] = 25.0  # as chip_smoke.py: ties at the prefilter's edge
        out = {}
        for m in (4, 16):
            for _ in range(3):
                boxes = dp.detect_post(raw, anchors, 0.3, m)[0]
            torch.cuda.synchronize()
            cycles = boxes.reshape(128, -1)[:, : len(PHASES)].cpu().numpy()
            out[f"M={m}"] = {p: float(np.median(cycles[:, q])) for q, p in enumerate(PHASES)}
        return out
    finally:
        _restore()


def _device_us(fn, kernels, calls: int = 20, attempts: int = 5) -> float:
    """Device µs per call of ``fn``: each of ``kernels`` (base names, one
    launch a call) timed by the profiler over ``calls`` calls, its total over
    the events the window holds (the tracer now and then drops some, or a
    whole window, which is then taken again)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
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
    raise RuntimeError(f"no profiler window held the kernels of {kernels}: {totals}")


def _faces(rng, side, b, m, device):
    """chip_smoke.py's warp inputs: smooth frames, faces of 0.2-0.34 of the
    frame rotated up to 0.4 rad."""
    template = warp_mxu.ARCFACE_TEMPLATE - warp_mxu.ARCFACE_TEMPLATE.mean(0)
    coarse = rng.integers(0, 256, (b, side // 8, side // 8, 3))
    frames = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(np.uint8)
    ang = rng.uniform(-0.4, 0.4, (b, m))
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    lm = np.einsum("bmij,nj->bmni", rot, template) * rng.uniform(0.2, 0.34, (b, m, 1, 1)) * side / 40.0
    lm = lm + rng.uniform(0.2 * side, 0.8 * side, (b, m, 1, 2))
    return (torch.as_tensor(frames, device=device),
            torch.as_tensor(lm.astype(np.float32), device=device))


def warp_variants(device) -> dict:
    rng = np.random.default_rng(0)
    cases = {"align": (*_faces(rng, 256, 128, 1, device), 0),
             "window": (*_faces(rng, 256, 32, 4, device), 160)}
    params = {k: ws.slot_parameters(f, l, 112, w or None) for k, (f, l, w) in cases.items()}
    variants = {
        "as built": [],
        "solve read, not computed": [(
            "  slot_prologue(a, s, sl);\n  if (a.slot_params != nullptr && blockIdx.y == 0) {",
            "  {\n    const float* q = a.slot_params + (size_t)s * 8;\n"
            "    const int side_h = a.window ? a.window : a.H, side_w = a.window ? a.window : a.W;\n"
            "    sl = Slot{q[0], q[1], q[2], q[3], q[4], q[5], s / a.per_frame, (int)q[6], (int)q[7],"
            " side_h, side_w};\n  }\n  if (false) {")],
        "every tile from global memory": [(
            "  fp.use = (fp.yhi - fp.ylo + 1) * fp.pitch <= STAGE_BYTES;", "  fp.use = 0;")],
    }
    out = {}
    for name, patches in variants.items():
        _patched("warp_" + str(len(out)), "warp_sample.cu", patches)
        try:
            read = bool(patches) and "solve" in name
            out[name] = {
                case: statistics.median(_device_us(
                    (lambda f=f, l=l, w=w, p=params[case]: ws._launch(
                        f, 112, 112, True, l, w, slot_params=p.clone())) if read else
                    (lambda f=f, l=l, w=w: ws._launch(f, 112, 112, True, l, w)), ("warp_sample",))
                    for _ in range(3))
                for case, (f, l, w) in cases.items()
            }
        finally:
            _restore()
    return out


INT8_SHAPES = ((128, 1_000_000, 512, 5), (1, 1_000_000, 512, 5), (32, 100_000, 512, 5),
               (128, 100_000, 512, 5))
_PHASE_SUMS = """
__device__ unsigned long long phase_cycles[16];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int phases_read(unsigned long long* out) {
  if (cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles)) != cudaSuccess) return 1;
  static const unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero)) != cudaSuccess;
}
"""

# What thread 0 of each consumer adds up (its cycles per phase, its tiles
# and rounds), then what the grid's earliest start and latest end are (ns).
INT8_SUMS = ("wait", "products", "filter", "fold", "tiles", "rounds", "before tiles", "first tile",
             "consumers", "consumer ns")
# clock64 stamps in a consumer of int8_partial; thread 0 also refills its
# consumer's ring, so its "products" hold that.
INT8_STAMPS = [
    ("namespace {\n", _PHASE_SUMS + "namespace {\n"),
    ("  extern __shared__ unsigned char smem_raw[];\n",
     "  const long long k0 = clock64();\n  const unsigned long long g0 = global_ns();\n"
     "  extern __shared__ unsigned char smem_raw[];\n"),
    ("  for (long long j = cons; j < n_tiles; j += CONSUMERS) {\n",
     "  long long c_wait = 0, c_mma = 0, c_filter = 0, c_fold = 0, n_tile = 0, n_round = 0;\n"
     "  long long c_first = 0;\n  const long long c_before = clock64() - k0;\n"
     "  for (long long j = cons; j < n_tiles; j += CONSUMERS) {\n"
     "    const long long s0 = clock64();\n"),
    ("      mbar_wait(&full[stage], take.phase);\n",
     "      const long long w0 = clock64();\n      mbar_wait(&full[stage], take.phase);\n"
     "      c_wait += clock64() - w0;\n"),
    ("    for (int c = max(0, n_chunks - ring); c < n_chunks; ++c) release();\n",
     "    for (int c = max(0, n_chunks - ring); c < n_chunks; ++c) release();\n"
     "    c_mma += clock64() - s0;\n"),
    ("    dequantise<W>(acc0, 0, qs_r, cb, gs_r);\n",
     "    long long f0 = clock64();\n    dequantise<W>(acc0, 0, qs_r, cb, gs_r);\n"),
    ("      named_barrier(1 + cons, 128);  // the buffers are written\n",
     "      named_barrier(1 + cons, 128);  // the buffers are written\n"
     "      const long long f1 = clock64();\n      c_filter += f1 - f0;\n      ++n_round;\n"),
    ("      if (!named_barrier_any(3 + cons, 128, more)) break;\n",
     "      const bool again = named_barrier_any(3 + cons, 128, more);\n"
     "      f0 = clock64();\n      c_fold += f0 - f1;\n      if (!again) break;\n"),
    ("    if (j + CONSUMERS < n_tiles) scales_of(",
     "    if (++n_tile == 1) c_first = clock64() - s0;\n    if (j + CONSUMERS < n_tiles) scales_of("),
    ("\n  if (owner) {\n    const int query = group * W + tid;\n",
     "\n  if (tid == 0) {\n"
     + "".join(f"    atomicAdd(&phase_cycles[{q}], (unsigned long long)({v}));\n" for q, v in enumerate(
         ["c_wait", "c_mma - c_wait", "c_filter", "c_fold", "n_tile", "n_round", "c_before", "c_first",
          "1", "global_ns() - g0"]))
     + "    atomicMax(&phase_cycles[14], ~g0);\n    atomicMax(&phase_cycles[15], global_ns());\n  }\n"
     "  if (owner) {\n    const int query = group * W + tid;\n"),
]


def _int8_cases(device) -> dict:
    """The timed shapes on random unit rows, and chip_smoke.py's rising case
    (every row enters every list) at the first shape."""
    gen = torch.Generator(device=device).manual_seed(0)
    cases = {}
    for b, n, d, k in INT8_SHAPES:
        q = torch.randn(b, d, generator=gen, device=device)
        g = torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device=device), dim=1)
        cases[f"B={b} N={n}"] = (*it.quantize_queries(q), *matcher.quantize_embeddings_int8(g), k)
    b, n, d, k = INT8_SHAPES[0]
    gq = torch.randint(1, 128, (1, d), generator=gen, device=device, dtype=torch.int8).expand(n, d)
    gs = 0.5 + torch.arange(n, device=device, dtype=torch.float32) * 2.0**-22
    q = torch.rand(b, d, generator=gen, device=device) + 0.1
    cases[f"rising B={b} N={n}"] = (*it.quantize_queries(q), gq.contiguous(), gs, k)
    return cases


def int8_phases(device) -> dict:
    """At each shape, from thread 0 of each consumer warpgroup summed over
    the grid: cycles per own 128-row tile of each phase, rounds per tile,
    cycles before the first tile and of the first tile per consumer, a
    consumer's ns from the kernel's entry to its end, and the grid's ns from
    the first consumer's entry to the last one's end."""
    cases = _int8_cases(device)
    _patched("int8_phases", "int8_topk.cu", INT8_STAMPS)
    try:
        lib = _build.load("int8_topk")
        out = {}
        for case, args in cases.items():
            it.int8_topk_codes(*args)
            torch.cuda.synchronize()
            _read_phases(lib, INT8_SUMS)  # clears the sums
            it.int8_topk_codes(*args)
            torch.cuda.synchronize()
            sums = _read_phases(lib, INT8_SUMS + ("",) * 4 + ("first ns", "last ns"))
            first, last = sums.pop("first ns"), sums.pop("last ns")
            sums.pop("")
            tiles, consumers = sums.pop("tiles"), sums.pop("consumers")
            out[case] = {p: v / (consumers if p in ("before tiles", "first tile", "consumer ns") else tiles)
                         for p, v in sums.items()}
            out[case]["tiles"] = tiles
            out[case]["grid ns"] = last - (~first & (2**64 - 1))
        return out
    finally:
        _restore()


def int8_variants(device) -> dict:
    """Device µs of one call as built and with one choice undone each, in
    turns: every element of a tile offered to its query's list (the
    threshold filter off); both consumers held to start each tile's
    products together, so neither's epilogue runs under the other's wgmmas;
    and no bound from a tile's own rows (the bounded round off)."""
    cases = _int8_cases(device)
    variants = {
        "as built": [],
        "threshold filter off": [
            ("      near |= (uint32_t)!(__int_as_float(sc[4 * i + j]) < (j % 2 ? t.y : t.x)) << (4 * i + j);",
             "      near |= 1u << (4 * i + j);"),
            ("    if (!(key > fk || (later && key == fk)) ||", "    if (!(!later || key >= fk) ||"),
            ("      if (BOUNDED && (later || j == cons || overflowed)) {", "      if (false) {")],
        "epilogue not overlapped": [(
            "    const long long t0 = r_begin + j * TILE_ROWS;\n",
            "    if ((j | 1) < n_tiles) named_barrier(7, 256);\n"
            "    const long long t0 = r_begin + j * TILE_ROWS;\n")],
        "bounded round off": [(
            "  constexpr bool BOUNDED = KMAX <= 8;", "  constexpr bool BOUNDED = false;")],
    }
    times = {name: {case: [] for case in cases} for name in variants}
    for name in list(variants) + list(variants)[::-1]:  # in turns
        _patched("int8_" + name.replace(" ", "_"), "int8_topk.cu", variants[name])
        try:
            for case, args in cases.items():
                times[name][case].append(_device_us(lambda a=args: it.int8_topk_codes(*a),
                                                    ("int8_partial", "topk_merge")))
        finally:
            _restore()
    return {name: {case: statistics.median(v) for case, v in by_case.items()}
            for name, by_case in times.items()}


def _sum_stamps(values, guard: str) -> str:
    """The lines that add ``values`` (C expressions) to ``phase_cycles``
    when ``guard`` holds."""
    adds = "".join(f"    atomicAdd(&phase_cycles[{q}], (unsigned long long)({v}));\n"
                   for q, v in enumerate(values))
    return f"  if ({guard}) {{\n{adds}  }}\n"


# chi2_nn: thread 0 of each block sums its cycles per phase. The dense
# design's chi2_partial: staging a chunk (global loads to shared memory and the
# barrier) against its term loop (and the barrier after it), and the
# epilogue (distances, the block's minima).
CHI2_SUMS = ("staging", "terms", "epilogue", "blocks")
CHI2_DESIGNS = {
    "dense": ("constexpr int TB = 32;   // queries of a block", [
        ("namespace {\n", _PHASE_SUMS + "namespace {\n"),
        ("  for (int f0 = 0; f0 < F; f0 += KF) {\n    const int f = f0 + lane;\n",
         "  long long c_stage = 0, c_terms = 0;\n"
         "  for (int f0 = 0; f0 < F; f0 += KF) {\n    const long long s0 = clock64();\n"
         "    const int f = f0 + lane;\n"),
        ("    __syncthreads();\n    float part[4][4];\n",
         "    __syncthreads();\n    const long long s1 = clock64();\n    c_stage += s1 - s0;\n"
         "    float part[4][4];\n"),
        ("acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);\n    __syncthreads();\n  }\n",
         "acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);\n    __syncthreads();\n"
         "    c_terms += clock64() - s1;\n  }\n  const long long e0 = clock64();\n"),
        ("    }\n  }\n}\n\n__global__ void chi2_merge(",
         "    }\n  }\n" + _sum_stamps(("c_stage", "c_terms", "clock64() - e0", "1"), "t == 0")
         + "}\n\n__global__ void chi2_merge("),
    ]),
    # The filter design's chi2_filter: waiting for a staged chunk (the cp.async ring's
    # wait, the barrier, issuing the chunk two ahead) against the loop over
    # the query bits, and the epilogue (P, the tiles' bounds).
    "filter": ("- chi2_filter + chi2_rescore: the nearest row.", [
        ("namespace {\n", _PHASE_SUMS + "namespace {\n"),
        ("  Ring<false> ring(reinterpret_cast<Stage*>(smem), a, n0, b0);\n",
         "  Ring<false> ring(reinterpret_cast<Stage*>(smem), a, n0, b0);\n"
         "  long long c_stage = 0, c_terms = 0;\n"),
        ("    const Stage& s = ring.ready(c);\n#pragma unroll\n    for (int i = 0; i < QPW; ++i) {\n"
         "      const int b = warp + WARPS * i;  // warp-uniform: the loop below does not diverge\n",
         "    const long long s0 = clock64();\n    const Stage& s = ring.ready(c);\n"
         "    const long long s1 = clock64();\n    c_stage += s1 - s0;\n"
         "#pragma unroll\n    for (int i = 0; i < QPW; ++i) {\n"
         "      const int b = warp + WARPS * i;  // warp-uniform: the loop below does not diverge\n"),
        ("      for (int j = 0; j < RPT; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[j]);\n    }\n  }\n",
         "      for (int j = 0; j < RPT; ++j) acc[i][j] = __fadd_rn(acc[i][j], part[j]);\n    }\n"
         "    c_terms += clock64() - s1;\n  }\n  const long long e0 = clock64();\n"),
        ("      a.tile_hi[(size_t)b * tiles + blockIdx.x] = hi;\n    }\n  }\n}\n",
         "      a.tile_hi[(size_t)b * tiles + blockIdx.x] = hi;\n    }\n  }\n"
         + _sum_stamps(("c_stage", "c_terms", "clock64() - e0", "1"), "threadIdx.x == 0") + "}\n"),
    ]),
}
# lbph_hist: thread 0 of each block. A block per (cell, image):
# zeroing the histogram (and copying the plan), the codes and their
# atomics, the write-out.
LBPH_SUMS = {"cell blocks": ("zeroing", "codes + atomics", "write-out", "blocks"),
             "band blocks": ("zeroing", "staging", "codes + atomics", "last barrier", "write-out",
                             "blocks")}
LBPH_DESIGNS = {
    "cell blocks": ("One block per (cell, image).", [
        ("namespace {\n", _PHASE_SUMS + "namespace {\n"),
        ("  extern __shared__ int hist[];\n",
         "  const long long k0 = clock64();\n  extern __shared__ int hist[];\n"),
        ("  __syncthreads();\n  const int pixels = a.cell_h * a.cell_w;\n",
         "  __syncthreads();\n  const long long k1 = clock64();\n"
         "  const int pixels = a.cell_h * a.cell_w;\n"),
        ("  __syncthreads();\n  for (int b = threadIdx.x; b < bins; b += THREADS) {\n    // the float",
         "  __syncthreads();\n  const long long k2 = clock64();\n"
         "  for (int b = threadIdx.x; b < bins; b += THREADS) {\n    // the float"),
        ("    out[b] = __fmul_rn(count, a.inv_cell);\n  }\n}\n",
         "    out[b] = __fmul_rn(count, a.inv_cell);\n  }\n"
         + _sum_stamps(("k1 - k0", "k2 - k1", "clock64() - k2", "1"), "threadIdx.x == 0") + "}\n"),
    ]),
    # A block per band of cells: zeroing the band's histograms,
    # staging its pixel rows (and the barrier), the codes and their atomics,
    # the wait at the last barrier, the write-out.
    "band blocks": ("A block per band:", [
        ("namespace {\n", _PHASE_SUMS + "namespace {\n"),
        ("  int* hist = smem;\n",
         "  const long long k0 = clock64();\n  long long c_zero = 0, c_stage = 0, c_codes = 0, k1 = 0, k2 = 0;\n"
         "  int* hist = smem;\n"),
        ("    __syncthreads();  // the zeroing is done, the previous slab's taps read\n",
         "    __syncthreads();  // the zeroing is done, the previous slab's taps read\n"
         "    k1 = clock64();\n    if (y0 == 0) c_zero = k1 - k0;\n"),
        ("    __syncthreads();\n    for (int j = lane; j < width; j += 32) {\n",
         "    __syncthreads();\n    k2 = clock64();\n    c_stage += k2 - k1;\n"
         "    for (int j = lane; j < width; j += 32) {\n"),
        ("        else atomicAdd(&out[bin0 + code], 1.0f);\n      }\n    }\n  }\n  __syncthreads();\n",
         "        else atomicAdd(&out[bin0 + code], 1.0f);\n      }\n    }\n    c_codes += clock64() - k2;\n"
         "  }\n  const long long k3 = clock64();\n  __syncthreads();\n  const long long k4 = clock64();\n"),
        ("      out[k] = __fmul_rn(v, a.inv_cell);\n    }\n  }\n}\n",
         "      out[k] = __fmul_rn(v, a.inv_cell);\n    }\n  }\n"
         + _sum_stamps(("c_zero", "c_stage", "c_codes", "k4 - k3", "clock64() - k4", "1"),
                       "threadIdx.x == 0") + "}\n"),
    ]),
}
CHI2_PHASE_SHAPES = ((128, 75_000, 16_384), (1, 75_000, 16_384))
LBPH_PHASE_BATCHES = (128, 4096)


def _lbph_gallery(device, rows: int):
    """chip_smoke.py's LBPH histograms: ``rows`` faces (identities of 10
    samples) through this checkout's ``lbph_hist``."""
    from facerecognition_tpu_torch.ops.lbph_hist import lbph_hist
    from facerecognition_tpu_torch.tools.lbph_data import lbph_faces

    gen = torch.Generator(device=device).manual_seed(0)
    faces = lbph_faces(gen, rows // 10, 10, device)
    return torch.cat([lbph_hist(faces[i : i + 4096]) for i in range(0, rows, 4096)])


def _events_ms(fn, calls: int = 3) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def chi2_phases(device) -> dict:
    """Cycles of thread 0 of each block per phase of ``chi2_nn`` (the
    design the sources hold), summed over the grid and divided by the
    blocks, with the call's ms (CUDA events) beside them, at
    ``CHI2_PHASE_SHAPES`` on chip_smoke.py's histograms."""
    design, patches = _stamps_for("chi2_nn.cu", CHI2_DESIGNS)
    gallery = _lbph_gallery(device, max(n for _, n, _ in CHI2_PHASE_SHAPES))
    _patched("chi2_phases", "chi2_nn.cu", patches)
    try:
        cn = _wrapper("chi2_nn")
        lib = _build.load("chi2_nn")
        out = {"design": design}
        # the filter design keeps the gallery's stats beside it (LBPHModel)
        extra = {} if design == "dense" else {"gallery_stats": cn.chi2_row_stats(gallery)}
        for b, n, f in CHI2_PHASE_SHAPES:
            q, g = gallery[7 : 7 + b].clone(), gallery[:n]
            call = lambda: cn.chi2_nn(q, g, **extra)  # noqa: E731
            ms = _events_ms(call)
            _read_phases(lib, CHI2_SUMS)  # clears the sums
            call()
            torch.cuda.synchronize()
            sums = _read_phases(lib, CHI2_SUMS)
            blocks = sums.pop("blocks")
            out[f"B={b} N={n} F={f}"] = {"ms": ms, "blocks": blocks,
                                         **{p: v / blocks for p, v in sums.items()}}
        return out
    finally:
        _restore()


def lbph_hist_phases(device) -> dict:
    """Cycles of thread 0 of each block per phase of ``lbph_hist`` (the
    design the sources hold), divided by the blocks, with the device µs of
    a call, at B = 128 and 4096, 100², r 1, 8x8 cells of 256 bins."""
    design, patches = _stamps_for("lbph_hist.cu", LBPH_DESIGNS)
    from facerecognition_tpu_torch.tools.lbph_data import lbph_faces

    gen = torch.Generator(device=device).manual_seed(0)
    _patched("lbph_hist_phases", "lbph_hist.cu", patches)
    try:
        lh = _wrapper("lbph_hist")
        lib = _build.load("lbph_hist")
        out = {"design": design}
        for b in LBPH_PHASE_BATCHES:
            imgs = lbph_faces(gen, b, 1, device)
            call = lambda: lh.lbph_hist(imgs)  # noqa: E731
            us = _events_ms(call, 20) * 1e3
            _read_phases(lib, LBPH_SUMS[design])
            call()
            torch.cuda.synchronize()
            sums = _read_phases(lib, LBPH_SUMS[design])
            blocks = sums.pop("blocks")
            out[f"B={b}"] = {"us_events": us, "blocks": blocks, **{p: v / blocks for p, v in sums.items()}}
        return out
    finally:
        _restore()


# chi2_nn as built (the filter and the rescoring) and with one choice undone
# each: every bin of every chunk summed exactly (no skipping: the exact pass
# over all 32 terms of a chunk, then the merge); the exact skipping pass
# without the filter (``return_distances``'s kernels); the filter without
# prefetch (each chunk staged, then waited for, then summed).
CHI2_VARIANTS = {
    "as built": ([], False),
    "no skipping (dense)": ([
        ("      unsigned cur = qm | gm[0];\n", "      unsigned cur = 0xffffffffu;\n"),
        ("          cur = qm | next;\n", "          cur = 0xffffffffu;\n"),
    ], True),
    "skipping without the filter": ([], True),
    "filter without prefetch": ([
        ("    cp_async_wait<STAGES - 2>();\n    __syncthreads();  // chunk c landed for all; chunk c - 1's buffer is free\n"
         "    if (c + STAGES - 1 < a.C) stage(c + STAGES - 1);\n    cp_async_commit();\n",
         "    __syncthreads();\n    if (c > 0) stage(c);\n"
         "    cp_async_commit();\n    cp_async_wait<0>();\n    __syncthreads();\n"),
    ], False),
}
CHI2_VARIANT_SHAPES = ((128, 75_000, 16_384), (1, 75_000, 16_384))


def chi2_variants(device) -> dict:
    """ms per call (CUDA events, the median of 3 calls) of each of
    ``CHI2_VARIANTS`` at ``CHI2_VARIANT_SHAPES``, in turns (each variant,
    then each again in reverse order), on chip_smoke.py's histograms; the
    nearest rows must agree across the variants."""
    gallery = _lbph_gallery(device, max(n for _, n, _ in CHI2_VARIANT_SHAPES))
    times = {name: {shape: [] for shape in CHI2_VARIANT_SHAPES} for name in CHI2_VARIANTS}
    answers = {}
    for name in list(CHI2_VARIANTS) + list(CHI2_VARIANTS)[::-1]:
        patches, exact = CHI2_VARIANTS[name]
        _patched("chi2_" + name.split()[0], "chi2_nn.cu", patches)
        try:
            from facerecognition_tpu_torch.ops import chi2_nn as cn

            stats = cn.chi2_row_stats(gallery)
            for b, n, f in CHI2_VARIANT_SHAPES:
                q, g = gallery[7 : 7 + b].clone(), gallery[:n]
                gs = stats if n == gallery.shape[0] else tuple(t[:n] for t in stats)
                call = lambda: cn.chi2_nn(q, g, exact, gs)  # noqa: E731
                times[name][(b, n, f)].append(statistics.median(_events_ms(call, 1) for _ in range(3)))
                idx = call()[1].cpu()
                if not torch.equal(answers.setdefault((b, n, f), idx), idx):
                    raise RuntimeError(f"chi2_nn variant {name!r} found other rows at {(b, n, f)}")
        finally:
            _restore()
    return {name: {f"B={b} N={n} F={f}": statistics.median(v) for (b, n, f), v in by.items()}
            for name, by in times.items()}


# lbph_hist as built and with the plan's taps read at their offsets in
# shared memory for every plan (the kernel with the offsets of (r 1, P 8)
# and (r 2, P 8) compiled in is not taken).
LBPH_VARIANTS = {
    "as built": [],
    "generic taps": [("  bool statics = a.neighbors == 8 && (a.radius == 1 || a.radius == 2);\n",
                      "  bool statics = false;\n")],
}
# (B, radius, neighbours), 100², 8x8 cells; B = 4096 is LBPHModel.features' chunk
LBPH_VARIANT_CASES = ((128, 1, 8), (4096, 1, 8), (128, 2, 8))
LBPH_VARIANT_ROUNDS = 3


def lbph_variants(device) -> dict:
    """Device µs per call (profiler) of each of ``LBPH_VARIANTS`` at
    ``LBPH_VARIANT_CASES`` on chip_smoke.py's faces, in turns (each variant,
    then each again in reverse order, ``LBPH_VARIANT_ROUNDS`` times): every
    window's value, so the spread shows, and their median; the histograms
    must be equal across the variants."""
    from facerecognition_tpu_torch.tools.lbph_data import lbph_faces

    gen = torch.Generator(device=device).manual_seed(0)
    imgs = {b: lbph_faces(gen, b, 1, device) for b in {b for b, _, _ in LBPH_VARIANT_CASES}}
    times = {name: {case: [] for case in LBPH_VARIANT_CASES} for name in LBPH_VARIANTS}
    answers = {}
    order = list(LBPH_VARIANTS) + list(LBPH_VARIANTS)[::-1]
    for name in order * LBPH_VARIANT_ROUNDS:
        _patched("lbph_" + name.replace(" ", "_"), "lbph_hist.cu", LBPH_VARIANTS[name])
        try:
            lh = _wrapper("lbph_hist")
            for case in LBPH_VARIANT_CASES:
                b, r, p = case
                call = lambda: lh.lbph_hist(imgs[b], r, p)  # noqa: E731
                out = call()
                if not torch.equal(answers.setdefault(case, out), out):
                    raise RuntimeError(f"lbph_hist variant {name!r} differs at {case}")
                times[name][case].append(_device_us(call, ("lbph_hist",)))
        finally:
            _restore()
    return {name: {f"B={b} r={r} P={p}": {"median_us": statistics.median(v), "windows_us": v}
                   for (b, r, p), v in by_case.items()}
            for name, by_case in times.items()}


SECTIONS = {
    "detect_post": ("detect_post cycles per phase", detect_post_phases),
    "warp_sample": ("warp_sample device us", warp_variants),
    "int8_phases": ("int8_topk cycles per tile", int8_phases),
    "int8_variants": ("int8_topk device us", int8_variants),
    "chi2_phases": ("chi2_nn cycles per block", chi2_phases),
    "lbph_hist_phases": ("lbph_hist cycles per block", lbph_hist_phases),
    "chi2_variants": ("chi2_nn ms", chi2_variants),
    "lbph_variants": ("lbph_hist device us", lbph_variants),
}


def main(argv) -> None:
    """Every section, or those named on the command line; ``--tree DIR``
    first takes the sources and wrappers of the checkout at DIR."""
    global SOURCE_DIR
    if argv[:1] == ["--tree"]:
        SOURCE_DIR = os.path.join(os.path.abspath(argv[1]), "facerecognition_tpu_torch", "csrc")
        argv = argv[2:]
    unknown = set(argv) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"kernel_breakdown: no section {sorted(unknown)}; sections: {list(SECTIONS)}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: no CUDA device")
    device = torch.device("cuda", 0)
    for name in argv or SECTIONS:
        title, fn = SECTIONS[name]
        print(title, json.dumps(fn(device)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

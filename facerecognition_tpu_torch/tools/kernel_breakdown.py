"""Where the time of ``detect_post``, ``warp_sample`` and ``int8_topk`` goes, on the card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 -m facerecognition_tpu_torch.tools.kernel_breakdown [SECTION ...]

(every section, or those named: detect_post, warp_sample, int8_phases,
int8_variants). It builds patched copies of the kernels' sources into the
build directory (the sources in ``csrc/`` are not touched) and prints:

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

SOURCE_DIR = _build.CSRC_DIR
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
    _build.CSRC_DIR = SOURCE_DIR
    _build.BUILD_DIR = os.path.join(os.path.dirname(SOURCE_DIR), "_build")
    _build._loaded.clear()


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
_INT8_SUM = """
__device__ unsigned long long phase_cycles[16];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int int8_phases_read(unsigned long long* out) {
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
    ("namespace {\n", _INT8_SUM + "namespace {\n"),
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
        buf = (ctypes.c_ulonglong * 16)()
        out = {}
        for case, args in cases.items():
            it.int8_topk_codes(*args)
            torch.cuda.synchronize()
            lib.int8_phases_read(buf)  # clears the sums
            it.int8_topk_codes(*args)
            torch.cuda.synchronize()
            if lib.int8_phases_read(buf):
                raise RuntimeError("could not read the phase cycles")
            sums = dict(zip(INT8_SUMS, buf))
            tiles, consumers = sums.pop("tiles"), sums.pop("consumers")
            out[case] = {p: v / (consumers if p in ("before tiles", "first tile", "consumer ns") else tiles)
                         for p, v in sums.items()}
            out[case]["tiles"] = tiles
            out[case]["grid ns"] = buf[15] - (~buf[14] & (2**64 - 1))
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


SECTIONS = {
    "detect_post": ("detect_post cycles per phase", detect_post_phases),
    "warp_sample": ("warp_sample device us", warp_variants),
    "int8_phases": ("int8_topk cycles per tile", int8_phases),
    "int8_variants": ("int8_topk device us", int8_variants),
}


def main(argv) -> None:
    """Every section, or those named on the command line."""
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

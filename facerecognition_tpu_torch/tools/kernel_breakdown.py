"""Where the time of ``detect_post``, ``warp_sample`` and ``int8_topk`` goes, on the card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 -m facerecognition_tpu_torch.tools.kernel_breakdown

It builds patched copies of the kernels' sources into the build directory
(the sources in ``csrc/`` are not touched) and prints:

- ``detect_post``: the cycles (``clock64``) of each phase of one frame's
  warp, median over the 128 frames of the crowd path's shape (896 anchors,
  M = 4 and 16), from stamps the patched copy writes to its box output;
- ``warp_sample``: the device time (profiler) of the align warp (B = 128,
  256² → 112²) and the window warp (B = 32 x M = 4) as built, with the
  per-slot solve replaced by a read of precomputed parameters, and with
  every tile read from global memory instead of the stage;
- ``int8_topk``: the device time (profiler) of one call at the timed
  shapes of ``chip_smoke.py`` as built and with one of its choices undone
  each: the fold loading one score-tile row at a time, a consumer waiting
  for each stage's wgmmas before the next; taken in turns (each variant,
  then each again in reverse order).

Each patch asserts the text it replaces, so a kernel that changed shape
fails here loudly instead of measuring something else.
"""

from __future__ import annotations

import json
import os
import statistics

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


def _device_us(fn, calls: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / calls


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
                    (lambda f=f, l=l, w=w: ws._launch(f, 112, 112, True, l, w)))
                    for _ in range(3))
                for case, (f, l, w) in cases.items()
            }
        finally:
            _restore()
    return out


INT8_SHAPES = ((128, 1_000_000, 512, 5), (1, 1_000_000, 512, 5), (32, 100_000, 512, 5))


def int8_variants(device) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    cases = {}
    for b, n, d, k in INT8_SHAPES:
        q = torch.randn(b, d, generator=gen, device=device)
        g = torch.nn.functional.normalize(torch.randn(n, d, generator=gen, device=device), dim=1)
        cases[f"B={b} N={n}"] = (*it.quantize_queries(q), *matcher.quantize_embeddings_int8(g), k)
    variants = {
        "as built": [],
        "fold one row a load": [("      if (rows == WG_ROWS) {", "      if (false) {")],
        "wait for each stage's wgmmas": [(
            "      if (prev >= 0) {\n        wgmma_wait_one();",
            "      if (prev >= 0) {\n        wgmma_wait_all();")],
    }
    times = {name: {case: [] for case in cases} for name in variants}
    for name in list(variants) + list(variants)[::-1]:  # in turns
        _patched("int8_" + name.replace(" ", "_"), "int8_topk.cu", variants[name])
        try:
            for case, args in cases.items():
                times[name][case].append(_device_us(lambda a=args: it.int8_topk_codes(*a)))
        finally:
            _restore()
    return {name: {case: statistics.median(v) for case, v in by_case.items()}
            for name, by_case in times.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_breakdown: no CUDA device")
    device = torch.device("cuda", 0)
    print("detect_post cycles per phase", json.dumps(detect_post_phases(device)), flush=True)
    print("warp_sample device us", json.dumps(warp_variants(device)), flush=True)
    print("int8_topk device us", json.dumps(int8_variants(device)), flush=True)


if __name__ == "__main__":
    main()

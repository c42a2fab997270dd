#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``facerecognition_tpu_torch``) on one NVIDIA card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing its wall seconds:

1. device: the card's name and power limit (nvidia-smi) and torch's name.
2. build: nvcc builds the six kernels from ``csrc/``, one process
   per source, all started together (seconds and the ptxas register /
   shared-memory / spill lines).
3. kernels: ``stream_topk`` against its plain PyTorch version on the card,
   at the serving match shapes, with planted duplicate rows (the lowest
   index must win), a NaN query and a NaN gallery row, and a gallery above
   4.2M rows; kernel, plain and library times by CUDA events, the kernel and
   the library timed in turns (library, kernel, kernel, library) and
   reported as medians; the host time of a call, the device time of each of
   the wrapper's kernels from the profiler's trace, and for the first case
   the SM clock and power draw under load (nvidia-smi).
4. int8: ``int8_quantize`` against ``quantize_queries`` on the card, codes
   and scales bit for bit, at D = 96, 128, 132 and 512 with zero, NaN, ±inf,
   subnormal, overflowing and exact-.5 rows; ``int8_topk`` against its plain
   version on the card, bit for bit, from codes and from float queries (one
   call, three kernels: the trace and the launch count are checked), at
   (128, 1M), (1, 1M), (32, 100k) and the int8 fused call's (128, 100k)
   (D = 512, k = 5; timed in turns
   against ``torch._int_mm`` + dequantisation + ``torch.topk``, with the
   plain time, the bound, the host time, the profiler's device time from
   codes and from float queries, and the clock under load for the first),
   at ``n_valid`` below the capacity with poisoned padding, k = 1, 7, 16,
   32, D = 132, N = 3, a NaN query and a NaN gallery scale, a 4.3M-row
   store (2.2 GB), and a 1M-row gallery whose scores rise with the row (the
   threshold filter's worst case: every row enters every list), timed.
5. warp: ``warp_sample`` against the two-pass plain version, uint8 frames,
   ``fast`` on and off: the public functions (the resize 256²→128² and the
   align warp 256²→112² at B = 128, the crowd window warp at B = 32 x M = 4,
   the repeat path at 160² frames) and the model inputs the engine builds
   (``detector_input``, ``embedder_input`` for the same three warps, from
   landmarks in the detector's pixels, some outside the frame). Each must
   equal the plain version bit for bit with ``fast`` on, within 1e-3 without;
   the kernel's per-slot coefficients and window origins must equal the plain
   version's bit for bit, on the card and on the CPU; one call must launch
   exactly one kernel. Max and mean |Δ|, call / plain / library times
   (``interpolate`` for the resize at ``fast=False``), the bound, the
   kernel's device time and the call's trace.
6. detect_post: the kernel against ``detect_faces_batch`` at B = 128, M = 4
   and 16 (timed), and at 3584 anchors, a prefilter of 512 and K = A = 48
   (checked), on raw outputs with saturated-sigmoid ties and NaN logits:
   boxes, landmarks, scores and validity equal bit for bit, one kernel per
   call, and a 40000-anchor frame refused.
7. serving: the shipped detector and ArcFace assets on the card, a
   100,000-row gallery with each frame's own embedding planted, and 16
   requests through ``MicroBatcher`` from 4 threads with the streaming
   kernel as the matcher, one face per frame. Every top-1 must be its
   planted row; the same frames through the port on the CPU (plain
   versions) must agree.
8. crowd: the same through ``MicroBatcher(max_faces=4)`` (the window path),
   each valid slot's own embedding planted; every planted slot's top-1 is
   its row (or ties it within 1e-6), and the CPU agrees.
9. serving int8: phase 7 with ``match_kernel="int8"``: the CPU agrees
   within ``INT8_TOL``, and ``stream_topk`` must not launch. Then the
   one-face fused calls of phases 7 and 9 at B = 128 are timed in
   alternating turns (5 rounds of 10 calls each, wall medians).
10. staged: ``add_to_db``, ``recognize``, ``recognize_batch`` and
    ``recognize_all`` with the dense, stream and int8 matchers, against the
    CPU port.
11. blaze: ``detector_v2_128`` through ``detect_all`` and one fused call
    (M = 4, int8), against the CPU port.
12. lbph: ``lbph_hist`` at B = 128, 100², (r 1, 8x8) and (r 2, 5x4), at
    16 neighbours and at B = 4096 (timed), bit for bit against its plain
    version; ``LBPHModel`` trained on 75,000 faces on the card (the
    gallery's ``chi2_row_stats`` computed there) and 128 probes through
    ``predict_batch`` (planted faces come back at distance 0); ``chi2_nn``
    at (128, 75,000, 16,384): the nearest rows equal the kernel-order argmin
    at every probe (planted, duplicated, near-duplicated, 300 equal rows,
    fresh), within 1e-5 relative of the plain version, ``return_distances``
    bit for bit against the kernel's summation order on a block of rows,
    timed at (128, 75,000), (1, 75,000) and ``return_distances`` at (8,
    4,096) against the chunked PyTorch expression + ``torch.min``, with the
    filter's candidates per query and the terms counted on the run's
    histograms; the model's API on small data against the CPU port, with
    launches per call.
13. facenet: the shipped ``facenet_synthid9k_512.msgpack`` (read by the
    port's msgpack reader; InceptionResnetV1 at 160²) as phases 7 and 8
    (one face and ``max_faces=4`` through ``MicroBatcher``, 100k gallery,
    ``stream``, planted top-1s, the CPU agrees; one fused call at B = 128
    profiled), and the staged API with ``stream`` against the CPU port.
    The warp phase also checks ``embedder_input`` at 160² (align and the
    160² crowd window).

14. enrol: the enrolment and evaluation path (``enrol_phase``): the
    committed fixture files decoded (PIL's pixels; nvJPEG within its
    bound), an LBPH ``DatabaseBuilder`` job over 1,024 x 4 generated PNG
    faces (64 identities also on the CPU), ArcFace and FaceNet gallery
    jobs over the fixture folder with the shipped detector, the engine
    loaded from the ArcFace gallery (``stream``) recognizing every fixture
    path, ``evaluate_recognition_engine`` and Grad-CAM / activation-CAM,
    each against the CPU port; decode, training, threshold search and job
    times.
15. apps: the serving apps (``apps_phase``): galleries built through the
    web app's builder routes, the WSGI app in process (every page, the
    three-model compare with CAM overlays, /batch, /recognize raw and
    multipart, with ``stream`` and ``int8``) against the same requests to
    the app on the CPU, ``main()``'s threaded server over a socket (4
    clients x 32 /recognize requests: requests/s, p50/p99, /stats reads
    ``gpu`` and shows a coalesced batch), /video with the committed MJPEG
    clip against ``process_video`` on the CPU (its frames decoded on the
    card within ``NVJPEG_MAX_ABS``), and 8 parts of the /video_feed MJPEG
    stream decoded; each of the six kernels must launch.

16. train: the training path (``train_phase``), in a process of its own
    (``in_child``: late in this process the profiler's windows came
    back empty). ``affine_warp``, the
    ``warp_sample`` kernel's matrix mode, against ``affine_warp_mxu_batch``
    at B = 128, 112² (float32 and uint8 frames) and B = 32, 160², with
    heavy-tier, identity and guard (|m00| < 1e-6) maps: bit for bit with
    ``fast``, within 1e-3 without, the per-slot coefficients bit for bit on
    the card and the CPU, one kernel per call, timed against the bound.
    One ArcFace step (ResNet50, B = 16, 112², SGD + decay + clip + warmup)
    and one FaceNet step (P 4 x K 2, 160², semi_hard, adam) on the card, on
    the CPU and on the CPU in float64 from the same initial variables: loss
    within 1e-4, every gradient and BN statistic (and SGD's parameters)
    within the larger of 1e-3 and 4x the CPU's own float32 error. The heavy
    tier's augmentation of one batch on the card against the CPU (1e-3
    levels, one warp); the miners' indices on the card against the CPU's
    with planted ties (argmin/argmax take the first index). ``ArcFaceTrainer`` from ``configs/arcface_config.
    yaml`` over 1,024 x 4 generated 128² PNG faces: 2 epochs x 8 steps,
    resume("last") and a third epoch (checkpoint GC to keep_last_n = 2,
    history equal, one warp a step), the exported weights served by one
    fused ``RecognitionEngine`` call; ``FaceNetTrainer`` from
    ``configs/facenet_config.yaml`` (2 epochs x 4 steps, the split resident
    on the card), then a batch_hard and a remat step. The ArcFace step at
    B = 128, 9,343 classes, heavy, resident data and the FaceNet step at
    P 8 x K 4, 160², timed (ms, images/s, the warp's share of device time).
17. synth: the procedural renderer and the two trainers that use it
    (``synth_phase``, in a process of its own). The port's renderer on the
    host against the committed fixture the JAX package rendered
    (``tools/scene_fixture``: generator states, ``valid``, JPEG flags and
    geometry equal, pixels within the CPU tests' bounds, nvJPEG's
    ``NVJPEG_MAX_ABS`` on top for JPEG'd scenes); scenes/s of
    ``scene_batch(64, 128, 2, v4)`` on one and on four threads; JPEG
    encode/decode per scene and four threads decoding at once. The shipped
    ``detector_v4_128`` through ``evaluate_detector`` on the fixture's
    seed (v3 and v4 scenes): recall, mean IoU and false positives an image
    within ``SYNTH_SHIPPED_TOL`` of the JAX numbers in the fixture,
    ``detect_post`` once a scene. The v4 curriculum as
    ``scripts/train_detector_v4.py`` runs it, cut to ``SYNTH_STEPS`` steps
    (DenseDetNet from ``detector_v3_128``, 128², B 64, v4, lr 7e-4, four
    producer threads): step ms by CUDA events, the device's busy share, the
    producers' queue wait, the loss; the checkpoint saved, calibrated on
    ``SYNTH_CAL_SCENES`` scenes, and its recall on v3 and v4 scenes within
    ``SYNTH_RECALL_TOL`` of the warm start's. ``train_synthid`` through
    ``main()`` at 9,343 classes, (1,1,1,1), 512-D, B 128, resident, one
    epoch (render seconds, step ms, images/s, retrieval metrics, one
    ``warp_sample`` a step); its checkpoint in a ``RecognitionEngine``
    names 32 enrolled aligned samples top-1.

Phases 7-17 are the paths: every kernel counter is set to 0 just before
each and read just after, and each kernel of the path must have launched;
after each serving phase, one fused call at B = 128 is profiled
(``fused_profile``: device µs per kernel, launches per call, host time the
device does not cover). It prints one ``{"kernels": [...]}`` line, then as its last line
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
WARP_DESIGN = ("four-tap direct sampling of the two-pass function, per-slot solve in the launch, "
               "uint8 tile footprint staged by cp.async, planar normalised output")
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
NAN_CASE = (4, 100_000, 512, 5)  # query 1 holds a NaN, gallery row 7 is NaN
LARGE_CASE = (4, 4_300_000, 512, 5)  # above 4,194,304 rows: offsets past 2^31 elements
# The three kernels one stream_topk call launches.
STREAM_TOPK_KERNELS = ("split_queries", "topk_partial", "topk_merge")
TIMING_ROUNDS = 2  # each round times library, kernel, kernel, library
GALLERY_ROWS = 100_000
N_FRAMES = 16
N_CLIENTS = 4
FRAME = (256, 256)
CROWD_FACES = 4
WARP_B = 128
DET_SIZE = 128  # the shipped detector's input side
# (name, frame side, frames, slots per frame, mode, output side): the shapes
# the paths give warp_sample. "resize" feeds the detector, "align" the
# one-face path, "window" the crowd path at frames above 160², "repeat" the
# crowd path at 160² or less; ArcFace takes 112², FaceNet 160². WARP_CASES
# call the public functions (no normalisation), INPUT_CASES the model inputs
# the engine builds (detector_input, embedder_input).
WARP_CASES = (
    ("resize", 256, WARP_B, 1, "resize", 128),
    ("align", 256, WARP_B, 1, "align", 112),
    ("window", 256, 32, CROWD_FACES, "window", 112),
    ("repeat", 160, 32, CROWD_FACES, "align", 112),
)
INPUT_CASES = (
    ("detector_input", 256, WARP_B, 1, "resize", DET_SIZE),
    ("embedder_input", 256, WARP_B, 1, "align", 112),
    ("embedder_input_window", 256, 32, CROWD_FACES, "window", 112),
    ("embedder_input_repeat", 160, 32, CROWD_FACES, "align", 112),
    ("embedder_input_160", 256, WARP_B, 1, "align", 160),
    ("embedder_input_window_160", 256, 32, CROWD_FACES, "window", 160),
)
# (B, detector side of the anchors, anchors kept (None: all), M). Timed: the
# crowd path's shape (896 anchors) at M = 4 and 16. Checked only: a frame of
# 3584 anchors (four warps share it), a prefilter of 512 (two warps), and
# K = A = 48.
DETECT_CASES = ((128, 128, None, 4), (128, 128, None, 16))
DETECT_CHECKS = ((16, 256, None, 16), (8, 128, None, 64), (4, 128, 48, 16))
PROFILE_BATCH = 128  # the fused call profiled at the serving batch
# int8_topk: the bound's operations are the int8 tensor cores' (2BND at
# 1,979 TOP/s, H100 SXM dense), its bytes the codes and scales read once.
INT8_OPS_PER_S = 1979e12
INT8_DESIGN = ("query normalise + quantize kernel; s8 wgmma (int32 exact), a TMA ring of int8 "
               "tiles per ping-pong consumer, register epilogue filtered by each query's k-th key")
INT8_TIMED = ((128, 1_000_000, 512, 5), (1, 1_000_000, 512, 5), (32, 100_000, 512, 5),
              (128, 100_000, 512, 5))  # the last: the int8 fused call's match
INT8_CHECKS = (  # (B, capacity, n_valid, D, k)
    (8, 20_000, 12_345, 512, 5),  # n_valid below capacity; the padding rows poisoned
    (16, 50_000, 50_000, 512, 1),
    (16, 50_000, 49_999, 512, 7),
    (40, 50_000, 50_000, 512, 16),
    (3, 50_000, 50_000, 512, 32),
    (5, 10_001, 10_001, 132, 7),  # a width that is not a multiple of 16 bytes
    (4, 3, 3, 512, 3),  # N = 3
)
INT8_NAN_CASE = (4, 100_000, 512, 5)  # query 1 holds a NaN, gallery row 7's scale is NaN
INT8_LARGE_CASE = (4, 4_300_000, 512, 5)  # 2.2 GB of codes: byte offsets past 2^31
INT8_RISING_CASE = (128, 1_000_000, 512, 5)  # scores rise with the row: every row enters
INT8_QUANTIZE_WIDTHS = (96, 128, 132, 512)
# The three kernels one int8_topk call launches; from codes, the last two.
INT8_KERNELS = ("int8_quantize", "int8_partial", "topk_merge")
INT8_CODES_KERNELS = INT8_KERNELS[1:]
INT8_TOL = 5e-4  # the card against the CPU port: a flipped query code moves a score ~2e-4
STAGED_FRAMES = 6
STAGED_ROWS = 2_000
BLAZE_WEIGHTS = "assets/detector_v2_128.msgpack"
# Every kernel source of the port, built together at the start.
KERNELS = ("stream_topk", "warp_sample", "detect_post", "int8_topk", "lbph_hist", "chi2_nn")
FACENET_WEIGHTS = "facenet_synthid9k_512.msgpack"
# LBPH: 100² gray faces, the reference's 9,343-identity scale (~75k training
# images), 128 probes. Bounds: the FP32 pipes' 67 TFLOP/s (H100 SXM, dense)
# for the operations a chi-square term needs (add, subtract, square, divide,
# accumulate) on the terms the function needs (see lbph_phase).
FP32_OPS_PER_TERM = 5
# (B, r, P, gx, gy, side): B = 4096 is the chunk LBPHModel.features
# launches; 99² and 2 bins a cell take the kernel's scalar paths
LBPH_CASES = ((WARP_B, 1, 8, 8, 8, 100), (WARP_B, 2, 8, 5, 4, 100), (8, 1, 16, 2, 2, 100),
              (8, 1, 1, 3, 3, 99), (4096, 1, 8, 8, 8, 100))
LBPH_IDENTITIES, LBPH_SAMPLES = 7_500, 10  # 75,000 gallery rows
LBPH_PROBES = 128
CHI2_CHECK_ROWS = 4_096  # rows the kernel-order emulation covers
CHI2_OVERFLOW_ROW, CHI2_OVERFLOW_COPIES = 5_000, 300  # a block of equal rows
# A model, not a reading: MUFU.RCP at 16 a cycle per SM (H100: 132 SMs, 1.98 GHz).
MUFU_PER_S = 132 * 16 * 1.98e9
# The enrolment path: the committed fixture folder (16 identities x baseline,
# progressive and gray JPEG and RGB PNG, 128²; make_torch_fixtures.py), and
# an LBPH job over 1,024 identities x 4 gray 100² PNG faces, of which the
# first 64 identities are also trained on the CPU.
FIXTURES = "facerecognition_tpu_torch/fixtures"
ENROL_LBPH_IDENTITIES, ENROL_LBPH_SAMPLES, ENROL_LBPH_SUBSET = 1_024, 4, 64
# nvJPEG against libjpeg (PIL), the same files: the IDCT alone differs (the
# decoder upsamples and converts nvJPEG's planes as libjpeg does).
NVJPEG_MAX_ABS = 3  # measured on the fixtures: at most 3 levels, mean 0.019
# The apps phase: the card's answers against the CPU port's, the same requests.
APPS_THRESHOLD = 0.5
APPS_CONF_TOL = 1e-3  # ArcFace / FaceNet confidences
APPS_LBPH_RTOL = 1e-5  # LBPH chi-square distances, relative
# CAM overlays (uint8): the enrol phase holds the CAMs within 1e-3; the jet
# map's slope of 4 turns that into about 1 level of a heat channel (2 with
# its truncation), blended at alpha 0.45, plus the blend's own truncation.
APPS_OVERLAY_MAX_ABS = 3
APPS_CLIENTS, APPS_REQUESTS = 4, 32  # socket clients x /recognize requests each
# The training path: affine_warp (warp_sample's matrix mode) at the trainers'
# shapes, (name, B, side, frame dtype); the card-vs-CPU steps; the trainers
# over TRAIN_IDENTITIES x TRAIN_SAMPLES generated PNG faces of TRAIN_SIDE²
# (128² → ArcFace's 112² and FaceNet's 160²); the timed steps at the
# reference's CelebA identity count on TRAIN_RESIDENT images on the card.
AFFINE_CASES = (("arcface_f32", 128, 112, "float32"), ("arcface_u8", 128, 112, "uint8"),
                ("facenet_u8", 32, 160, "uint8"))
PARITY_ARC_B, PARITY_FN_PK = 16, (4, 2)
TRAIN_IDENTITIES, TRAIN_SAMPLES, TRAIN_SIDE = 1_024, 4, 128
TRAIN_ARC_STEPS, TRAIN_FN_STEPS = 8, 4
TRAIN_CLASSES = 9_343
TRAIN_RESIDENT = 1_024


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


def profile_kernels(fn, calls: int = 5, attempts: int = 5) -> dict:
    """Every device event ``fn`` causes, by name, from the profiler's CUDA
    trace: {name: (events per call, device µs per call)}. A trace that came
    back without device events (the tracer now and then drops whole windows
    in a row) is taken again after a pause, up to ``attempts`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for attempt in range(attempts):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # Late in a run the tracer loses the first device event of a
            # window: a marker kernel, left out below, takes that place.
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            if ev.device_time_total <= 0 or "spin_kernel" in ev.key:
                continue
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", ev.key)
            count, us = out.get(name, (0.0, 0.0))
            out[name] = (count + ev.count / calls, us + ev.device_time_total / calls)
        if out:
            break
        print(f"profiler: window {attempt + 1} of {attempts} held no device event",
              file=sys.stderr, flush=True)
    return out


def device_us(fn, kernels=None, calls: int = 5, attempts: int = 5) -> dict:
    """Device microseconds per call of each kernel ``fn`` launches, by name,
    from the profiler's CUDA trace. Given ``kernels`` (base names), only
    those, and it fails unless the trace holds each of them (a window that
    lacks one, as the tracer now and then drops events, is taken again up
    to ``attempts`` times); else every kernel, and it fails if the trace
    holds none."""
    for attempt in range(attempts):
        out = {}
        for name, (_, us) in profile_kernels(fn, calls).items():
            if kernels is None:
                name = name[:60]
            elif name.split("<")[0] not in kernels:
                continue
            out[name] = out.get(name, 0.0) + us
        if kernels is None:
            check(bool(out), "the profiler's trace holds no device time")
            return out
        found = {name.split("<")[0] for name in out}
        if found == set(kernels):
            return out
        print(f"profiler: window {attempt + 1} of {attempts} held {sorted(found)}, "
              f"not {list(kernels)}", file=sys.stderr, flush=True)
        time.sleep(1.0)
    check(False, f"profiler trace holds {sorted(found)}, not {list(kernels)}")


def kernel_trace(fn, kernel: str, calls: int = 5, attempts: int = 5) -> tuple[list, dict]:
    """A profiled window of ``calls`` calls of ``fn``: the device events of
    one call, which must be exactly one, ``kernel``'s (no copy, no
    elementwise or solver kernel around it), or it fails; and that kernel's
    device µs per call. A window whose events of ``kernel`` fall short of
    one a call (the tracer drops events now and then) is taken again, up to
    ``attempts`` times; any other event fails at once."""
    for attempt in range(attempts):
        events = profile_kernels(fn, calls)
        per_call = []
        for name, (count, _) in events.items():
            per_call += [name.split("<")[0]] * round(count)
        if per_call == [kernel]:
            return per_call, {name: us for name, (_, us) in events.items()}
        check(set(per_call) <= {kernel}, f"one call launched {per_call}, not one {kernel}")
        seen = {name[:40]: round(count, 2) for name, (count, _) in events.items()}
        print(f"profiler: window {attempt + 1} of {attempts} held {seen} events a call, "
              f"not one {kernel}", file=sys.stderr, flush=True)
        time.sleep(1.0)
    check(False, f"one call launched {per_call}, not one {kernel}")


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
    nan_case(st, gen, device)
    max_err = max(max_err, large_case(st, gen, device))
    return max_err, main


def nan_case(st, gen, device) -> None:
    """A NaN query and a NaN gallery row rank as the plain version ranks
    them: NaN above +inf, NaNs lowest index first."""
    import torch

    b, n, d, k = NAN_CASE
    q = torch.randn(b, d, generator=gen, device=device)
    g = torch.randn(n, d, generator=gen, device=device)
    q[1, 3] = float("nan")
    g[7] = float("nan")
    s, i = st.stream_topk(q, g, k)
    torch.cuda.synchronize()
    rs, ri = st.stream_topk_reference(q, g, k)
    check(torch.equal(i, ri), f"NaN case: indices {i.tolist()} vs plain {ri.tolist()}")
    check(i[1].tolist() == list(range(k)), f"NaN query: indices {i[1].tolist()}")
    check(bool((i[[0, 2, 3], 0] == 7).all()), "the NaN gallery row must rank first")
    nan = torch.isnan(rs)
    check(torch.equal(torch.isnan(s), nan), "NaN scores differ from plain")
    err = (s[~nan] - rs[~nan]).abs().max().item()
    check(err <= 1e-5, f"NaN case: max |score - plain| {err}")
    print("stream_topk", json.dumps({"B": b, "N": n, "D": d, "k": k, "nan": True,
                                     "max_abs_err": err}), flush=True)


def large_case(st, gen, device) -> float:
    """A gallery above 4,194,304 rows of 512: element offsets past 2^31."""
    import torch

    b, n, d, k = LARGE_CASE
    q = torch.randn(b, d, generator=gen, device=device)
    g = torch.randn(n, d, generator=gen, device=device)
    lo, hi = 123, n - 1  # a planted pair either side of the old cap
    g[hi] = g[lo]
    q[0] = g[lo] * 3.0
    q[1] = g[n - 5]
    s, i = st.stream_topk(q, g, k)
    torch.cuda.synchronize()
    rs, ri = st.stream_topk_reference(q, g, k)
    err = check_topk(s, i, rs, ri, 1e-5, f"stream_topk B={b} N={n} D={d} k={k}")
    check(i[0, :2].tolist() == [lo, hi], f"planted duplicates came back as {i[0, :2].tolist()}")
    check(i[1, 0].item() == n - 5, f"a row past 2^31 / D came back as {i[1, 0].item()}")
    ms = cuda_ms(lambda: st.stream_topk(q, g, k), 5)
    print("stream_topk", json.dumps({"B": b, "N": n, "D": d, "k": k, "gallery_gb": n * d * 4 / 1e9,
                                     "max_abs_err": err, "ms": ms}), flush=True)
    del q, g
    torch.cuda.empty_cache()
    return err


def int8_inputs(gen, b: int, cap: int, d: int, device):
    """Float queries and a quantized store of ``cap`` unit rows, with row
    cap - 1 a duplicate of row cap // 3 and query 0 that row's direction
    (the lower index must come first)."""
    import torch

    from facerecognition_tpu_torch.ops import matcher as m

    q = torch.randn(b, d, generator=gen, device=device)
    g = torch.nn.functional.normalize(torch.randn(cap, d, generator=gen, device=device), dim=1)
    gq, gs = m.quantize_embeddings_int8(g)
    if cap > 2:
        lo, hi = cap // 3, cap - 1
        gq[hi], gs[hi] = gq[lo], gs[lo]
        q[0] = g[lo] * 3.0
    return q, gq, gs


def check_int8(it, q, gq, gs, k: int, n_valid, what: str):
    """The kernel against the plain version on the card, bit for bit, on the
    codes (``int8_topk_codes``) and from float queries (``int8_topk``
    against ``cosine_topk_int8``, whose mask scores rows >= n_valid -inf).
    NaN scores must sit where the plain version's are. Returns the codes
    and the kernel's result."""
    import torch

    from facerecognition_tpu_torch.ops import matcher as m

    qq, qs = it.quantize_queries(q)
    s, i = it.int8_topk_codes(qq, qs, gq, gs, k, n_valid)
    torch.cuda.synchronize()
    rs, ri = it.int8_topk_codes_reference(qq, qs, gq, gs, k, n_valid)
    fs, fi = it.int8_topk(q, gq, gs, k, n_valid)
    ms, mi = m.cosine_topk_int8(q, gq, gs, k, n_valid)
    for (a, ai), (r, rj), how in (((s, i), (rs, ri), "codes"), ((fs, fi), (ms, mi), "float queries")):
        check(torch.equal(ai, rj), f"int8_topk {what} ({how}): indices differ from plain")
        nan = torch.isnan(r)
        check(torch.equal(torch.isnan(a), nan), f"int8_topk {what} ({how}): NaNs differ")
        check(torch.equal(a[~nan], r[~nan]), f"int8_topk {what} ({how}): scores differ from plain")
    if n_valid is not None:
        check(int(i.max()) < n_valid, f"int8_topk {what}: a row past n_valid won")
    return qq, qs, s, i


def int8_phase(device):
    """``int8_topk`` against its plain version on the card at the timed
    shapes and the checked edge cases; timings at the timed shapes."""
    import torch

    from facerecognition_tpu_torch.ops import int8_topk as it

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    r = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=device)
    for d in INT8_QUANTIZE_WIDTHS:
        int8_quantize_case(it, gen, d, device)
    main = None
    for b, n, d, k in INT8_TIMED:
        q, gq, gs = int8_inputs(gen, b, n, d, device)
        qq, qs, s, i = check_int8(it, q, gq, gs, k, None, f"B={b} N={n} D={d} k={k}")
        check(i[0, :2].tolist() == [n // 3, n - 1], f"planted duplicates came back as {i[0, :2].tolist()}")
        line = {"B": b, "N": n, "D": d, "k": k, "max_abs_err": 0.0, "bit_equal": True}
        qpad = torch.nn.functional.pad(qq, (0, 0, 0, max(0, 17 - b)))  # _int_mm needs B > 16

        def library():
            acc = torch._int_mm(qpad, gq.T)[:b]
            return torch.topk(acc.float() * (qs * r)[:, None] * (gs * r)[None, :], k)

        lib_s, _ = library()
        check(torch.equal(lib_s, s), "the library yardstick's top scores differ from the kernel's")
        kernel = lambda: it.int8_topk_codes(qq, qs, gq, gs, k)  # noqa: E731
        fns = {"kernel": kernel, "library": library}
        times = {"kernel": [], "library": []}
        for _ in range(TIMING_ROUNDS):
            for name in ("library", "kernel", "kernel", "library"):
                times[name].append(cuda_ms(fns[name], 10))
        line["ms"] = statistics.median(times["kernel"])
        line["library_ms"] = statistics.median(times["library"])
        line["ms_samples"] = times["kernel"]
        line["library_ms_samples"] = times["library"]
        line["library"] = "torch._int_mm + dequantisation + torch.topk" + (
            f" (B padded to 17)" if b <= 16 else "")
        line["plain_ms"] = cuda_ms(lambda: it.int8_topk_codes_reference(qq, qs, gq, gs, k), 3, 1)
        floats = lambda: it.int8_topk(q, gq, gs, k)  # noqa: E731
        line["float_queries_ms"] = cuda_ms(floats, 10)
        line["host_us_per_call"] = host_us(kernel)
        line["float_queries_host_us_per_call"] = host_us(floats)
        line["device_us"] = device_us(kernel, INT8_CODES_KERNELS)
        line["float_queries_device_us"] = device_us(floats, INT8_KERNELS)
        bytes_moved = n * (d + 4) + b * (d + 4) + b * k * 8
        line["bound_bytes_ms"] = bytes_moved / HBM_BYTES_PER_S * 1e3
        line["bound_ops_ms"] = 2 * b * n * d / INT8_OPS_PER_S * 1e3
        line["bound_ms"] = max(line["bound_bytes_ms"], line["bound_ops_ms"])
        line["bound_by"] = "bytes" if line["bound_bytes_ms"] >= line["bound_ops_ms"] else "operations"
        if main is None:
            main = line
            line["under_load"] = clocks_under_load(kernel)
            int8_one_call(it, floats)
        print("int8_topk", json.dumps(line), flush=True)
        q = gq = gs = qq = qpad = kernel = floats = None
    for b, cap, n_valid, d, k in INT8_CHECKS:
        q, gq, gs = int8_inputs(gen, b, cap, d, device)
        if n_valid < cap:  # rows a mask must hide: each would win if it were read
            gq[n_valid:] = 127
            gs[n_valid:] = 1e6
        check_int8(it, q, gq, gs, k, n_valid, f"B={b} cap={cap} n_valid={n_valid} D={d} k={k}")
        print("int8_topk", json.dumps({"B": b, "capacity": cap, "n_valid": n_valid, "D": d, "k": k,
                                       "bit_equal": True}), flush=True)
    b, n, d, k = INT8_NAN_CASE
    q, gq, gs = int8_inputs(gen, b, n, d, device)
    q[1, 3] = float("nan")
    gs[7] = float("nan")
    _, _, s, i = check_int8(it, q, gq, gs, k, None, "NaN case")
    check(i[1].tolist() == list(range(k)), f"NaN query: indices {i[1].tolist()}")
    check(bool((i[[0, 2, 3], 0] == 7).all()), "the NaN gallery scale must rank first")
    print("int8_topk", json.dumps({"B": b, "N": n, "D": d, "k": k, "nan": True, "bit_equal": True}),
          flush=True)
    int8_large_case(it, gen, device)
    torch.cuda.empty_cache()
    main["rising"] = int8_rising_case(it, gen, device)
    torch.cuda.empty_cache()
    return main


def tie_row(d: int, odd) -> list:
    """Integer entries whose squares sum to 4^9, so the normalised row is
    exact: a maximum of 254 and entries 2n + 1, whose codes are n + 0.5
    before rounding."""
    vals = [254, *odd]
    rest = 4**9 - sum(v * v for v in vals)
    while rest:
        v = min(254, int(rest**0.5))
        vals.append(v)
        rest -= v * v
    return vals + [0] * (d - len(vals))


def int8_quantize_case(it, gen, d: int, device) -> None:
    """``int8_quantize`` against ``quantize_queries`` on the card: codes equal
    and scales equal bit for bit (NaN where the plain scale is NaN)."""
    import torch

    x = torch.randn(64, d, generator=gen, device=device)
    x[1] = 0.0
    x[2, 3] = float("nan")
    x[3, 5] = float("inf")
    x[4, 0] = -float("inf")
    x[5] = torch.tensor(tie_row(d, (1, 3, 5, 7)), dtype=torch.float32)
    x[6] = -torch.tensor(tie_row(d, (9, 11, 13)), dtype=torch.float32)
    x[7] *= 1e-20  # squares below the normal range
    x[8] *= 1e19  # squares that overflow
    codes, scales = it.int8_quantize(x)
    pq, ps = it.quantize_queries(x)
    check(torch.equal(codes, pq), f"int8_quantize D={d}: codes differ from plain")
    nan = torch.isnan(ps)
    check(torch.equal(torch.isnan(scales), nan), f"int8_quantize D={d}: NaN scales differ")
    check(torch.equal(scales[~nan].view(torch.int32), ps[~nan].view(torch.int32)),
          f"int8_quantize D={d}: scales differ from plain")
    check(codes[5, 1:5].tolist() == [0, 2, 2, 4] and codes[6, 1:4].tolist() == [-4, -6, -6],
          f"int8_quantize D={d}: half-way codes {codes[5, 1:5].tolist()} {codes[6, 1:4].tolist()}")
    print("int8_quantize", json.dumps({"B": x.shape[0], "D": d, "bit_equal": True,
                                       "nan_rows": int(nan.sum())}), flush=True)


def int8_one_call(it, floats) -> None:
    """One ``int8_topk`` call on float queries is one count and exactly the
    three kernels, once each (no PyTorch kernel touches the queries)."""
    it.launches.reset()
    for _ in range(3):
        floats()
    check(it.launches.count == 3, f"3 int8_topk calls counted {it.launches.count}")
    want = {name: 1.0 for name in INT8_KERNELS}
    for attempt in range(5):  # the tracer now and then drops a kernel from a window
        per_call = {}
        for name, (count, _) in profile_kernels(floats).items():
            per_call[name.split("<")[0]] = per_call.get(name.split("<")[0], 0.0) + count
        if per_call == want:
            break
        print(f"profiler: window {attempt + 1} of 5 held {per_call}", file=sys.stderr, flush=True)
        time.sleep(1.0)
    check(per_call == want, f"one int8_topk call launched {per_call}, not {list(INT8_KERNELS)} once each")
    print("int8_topk one call", json.dumps(per_call), flush=True)


def int8_rising_case(it, gen, device) -> dict:
    """The filter's worst case: one positive code row repeated with scales
    rising by 2^-22 a row, and positive queries, so each row scores above
    every row before it and enters every list. Bit for bit, timed."""
    import torch

    b, n, d, k = INT8_RISING_CASE
    gq = torch.randint(1, 128, (1, d), generator=gen, device=device, dtype=torch.int8).expand(n, d)
    gq = gq.contiguous()
    gs = 0.5 + torch.arange(n, device=device, dtype=torch.float32) * 2.0**-22
    q = torch.rand(b, d, generator=gen, device=device) + 0.1
    qq, qs, s, i = check_int8(it, q, gq, gs, k, None, f"rising B={b} N={n}")
    check(bool((i[:, 0] == n - 1).all()), "rising scores: the last row must come first")
    kernel = lambda: it.int8_topk_codes(qq, qs, gq, gs, k)  # noqa: E731
    line = {"B": b, "N": n, "D": d, "k": k, "rising": True, "bit_equal": True,
            "ms": cuda_ms(kernel, 5), "device_us": device_us(kernel, INT8_CODES_KERNELS)}
    print("int8_topk", json.dumps(line), flush=True)
    return line


def int8_large_case(it, gen, device) -> None:
    """A store of 4.3M rows of 512 codes (2.2 GB): byte offsets past 2^31."""
    import torch

    b, n, d, k = INT8_LARGE_CASE
    gq = torch.randint(-127, 128, (n, d), generator=gen, device=device, dtype=torch.int8)
    gs = torch.rand(n, generator=gen, device=device) * 0.1 + 0.1
    lo, hi = 123, n - 1
    gq[hi], gs[hi] = gq[lo], gs[lo]
    q = torch.randn(b, d, generator=gen, device=device)
    q[0] = gq[lo].float()
    q[1] = gq[n - 5].float()
    _, _, s, i = check_int8(it, q, gq, gs, k, None, f"B={b} N={n} D={d} k={k}")
    check(i[0, :2].tolist() == [lo, hi], f"planted duplicates came back as {i[0, :2].tolist()}")
    check(i[1, 0].item() == n - 5, f"a row past 2^31 bytes came back as {i[1, 0].item()}")
    qq, qs = it.quantize_queries(q)
    ms = cuda_ms(lambda: it.int8_topk_codes(qq, qs, gq, gs, k), 5)
    print("int8_topk", json.dumps({"B": b, "N": n, "D": d, "k": k, "store_gb": n * d / 1e9,
                                   "bit_equal": True, "ms": ms}), flush=True)
    del gq, gs


def touched_pixels(frames, lms, m: int, mode: str, out: int) -> int:
    """Distinct source pixels (frame, y, x) the taps reach, from the plain
    version's own positions (landmarks in frame pixels): the pixels the
    warp must read once."""
    import torch

    from facerecognition_tpu_torch.ops import warp_mxu as wm

    b, h, w, _ = frames.shape
    dev = frames.device
    if mode == "resize":
        ys = wm.resize_positions(h, out, dev).floor().long()
        xs = wm.resize_positions(w, out, dev).floor().long()
        rows = torch.unique(torch.cat([ys, ys + 1]).clamp(0, h - 1)).numel()
        cols = torch.unique(torch.cat([xs, xs + 1]).clamp(0, w - 1)).numel()
        return b * rows * cols
    if mode == "window":
        ms, origin, win = wm.window_slots(lms, h, w, out, 160)
        region = (win, win)
    else:
        ms = wm.align_matrices(lms.reshape(-1, 5, 2), out)
        origin = torch.zeros((b * m, 2), dtype=torch.long, device=dev)
        region = (h, w)
    m00, m01, m02, aa, bb, cc = wm.warp_coefficients(wm.invert_affine(ms)).unbind(1)
    ii = torch.arange(out, device=dev, dtype=torch.float32)[None, :, None]
    jj = torch.arange(out, device=dev, dtype=torch.float32)[None, None, :]
    xs = m00[:, None, None] * jj + m01[:, None, None] * ii + m02[:, None, None]
    keys = []
    frame_of = torch.arange(b, device=dev).repeat_interleave(m)[:, None, None]
    for t in (0, 1):
        x = xs.floor() + t
        y0 = (aa[:, None, None] * ii + bb[:, None, None] * x + cc[:, None, None]).floor()
        for u in (0, 1):
            y = y0 + u
            ok = (x >= 0) & (x < region[1]) & (y >= 0) & (y < region[0])
            gy = (y + origin[:, 1, None, None]).long()
            gx = (x + origin[:, 0, None, None]).long()
            keys.append(((frame_of * h + gy) * w + gx)[ok])
    return torch.unique(torch.cat(keys)).numel()


def warp_inputs(rng, side: int, b: int, m: int, device):
    """Smooth uint8 frames and (B, M, 5, 2) face landmarks in frame pixels:
    faces of 0.2-0.34 of the frame, rotated up to 0.4 rad, anywhere in it."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.ops import warp_mxu as wm

    template = wm.ARCFACE_TEMPLATE - wm.ARCFACE_TEMPLATE.mean(0)
    coarse = rng.integers(0, 256, (b, side // 8, side // 8, 3))
    frames = torch.as_tensor(
        np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(np.uint8), device=device
    )
    ang = rng.uniform(-0.4, 0.4, (b, m))
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    scale = rng.uniform(0.2, 0.34, (b, m, 1, 1)) * side / 40.0
    lm = np.einsum("bmij,nj->bmni", rot, template) * scale
    lm = lm + rng.uniform(0.2 * side, 0.8 * side, (b, m, 1, 2))
    return frames, torch.as_tensor(lm.astype(np.float32), device=device)


def check_slot_parameters(ws, frames, lms, out, window, det_size) -> None:
    """The kernel's per-slot prologue gives the plain version's coefficients
    and origins bit for bit, against the plain version on the card and on
    the CPU."""
    import torch

    got = ws.slot_parameters(frames, lms, out, window, det_size)
    on_card = ws.slot_parameters_plain(frames.shape, lms, out, window, det_size)
    on_cpu = ws.slot_parameters_plain(frames.shape, lms.cpu(), out, window, det_size)
    check(torch.equal(got, on_card), "warp_sample prologue differs from the plain version on the card")
    check(torch.equal(got.cpu(), on_cpu), "warp_sample prologue differs from the plain version on the CPU")


def warp_phase(device):
    import numpy as np
    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.ops import warp_mxu as wm
    from facerecognition_tpu_torch.ops import warp_sample as ws

    rng = np.random.default_rng(SEED)
    lines = {}
    for case in WARP_CASES + INPUT_CASES:
        name, side, b, m, mode, out = case
        frames, lms = warp_inputs(rng, side, b, m, device)
        model_input = case in INPUT_CASES
        window = 160 if mode == "window" else None
        if model_input:
            # landmarks in the detector's pixels, some outside the frame
            lms = lms * (DET_SIZE / side)
            lms[0, 0, 0] = torch.tensor([-3.0, DET_SIZE + 5.0], device=device)
        det_size = DET_SIZE if model_input else None
        if mode != "resize":
            check_slot_parameters(ws, frames, lms, out, window, det_size)
        lms_frame = ws.scale_landmarks(lms, side, side, DET_SIZE) if model_input else lms
        for fast in (True, False):
            if mode == "resize" and model_input:
                kernel = lambda: ws.detector_input(frames, out, fast)  # noqa: E731
                plain = lambda: ws.detector_input_plain(frames, out, fast)  # noqa: E731
            elif model_input:
                kernel = lambda: ws.embedder_input(frames, lms, DET_SIZE, out, window, fast)  # noqa: E731
                plain = lambda: ws.embedder_input_plain(  # noqa: E731
                    frames, lms, DET_SIZE, out, window, fast
                )
            elif mode == "resize":
                kernel = lambda: ws.bilinear_resize(frames, out, out, fast)  # noqa: E731
                plain = lambda: wm.bilinear_resize_mxu_batch(frames, out, out, fast)  # noqa: E731
            elif mode == "window":
                kernel = lambda: ws.align_crop_window(frames, lms, out, 160, fast)  # noqa: E731
                plain = lambda: wm.align_crop_mxu_window(frames, lms, out, 160, fast)  # noqa: E731
            else:
                kernel = lambda: ws.align_crop(frames, lms, out, fast)  # noqa: E731
                plain = lambda: wm.align_crop_mxu_batch(  # noqa: E731
                    frames.repeat_interleave(m, 0), lms.reshape(-1, 5, 2), out, fast
                )
            with strict_fp32():
                got = kernel()
                torch.cuda.synchronize()
                ref = plain()
                diff = (got - ref).abs()
                line = {"case": name, "frames": b, "side": side, "out": out, "slots": b * max(m, 1),
                        "fast": fast, "max_abs_err": diff.max().item(),
                        "mean_abs_err": diff.mean().item()}
                check(line["max_abs_err"] <= (0.0 if fast else 1e-3),
                      f"warp_sample {name} fast={fast}: max |Δ| {line['max_abs_err']}")
                line["ms"] = statistics.median(cuda_ms(kernel, 20) for _ in range(3))
                line["plain_ms"] = cuda_ms(plain, 3, 1)
                line["library_ms"] = None
                if mode == "resize" and not fast and not model_input:
                    x = frames.permute(0, 3, 1, 2).float().contiguous()
                    interp = lambda: torch.nn.functional.interpolate(  # noqa: E731
                        x, size=(out, out), mode="bilinear", align_corners=False, antialias=False
                    )
                    lib_diff = (interp().permute(0, 2, 3, 1) - got).abs().max().item()
                    check(lib_diff <= 1e-3, f"interpolate differs from the resize by {lib_diff}")
                    line["library_max_abs_diff"] = lib_diff
                    line["library_ms"] = statistics.median(cuda_ms(interp, 20) for _ in range(3))
                    line["library_device_us"] = sum(device_us(interp, calls=3).values())
                    x = None
                moved = got.numel() * 4 + touched_pixels(frames, lms_frame, m, mode, out) * 3
                moved += 0 if mode == "resize" else lms.numel() * 4
                line["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
                line["bound_by"] = "bytes"
                line["trace"], line["device_us"] = kernel_trace(kernel, "warp_sample")
                line["plain_device_us"] = sum(device_us(plain, calls=3).values())
            print("warp_sample", json.dumps(line), flush=True)
            lines[(name, fast)] = line
    torch.cuda.empty_cache()
    return lines


def detect_phase(device):
    import torch

    from facerecognition_tpu_torch.models.detector_net import anchor_centers, detect_faces_batch
    from facerecognition_tpu_torch.ops import detect_post as dp

    gen = torch.Generator(device=device).manual_seed(SEED)
    lines = {}
    for b, side, n_anchors, m in DETECT_CASES + DETECT_CHECKS:
        anchors = torch.as_tensor(anchor_centers(side)[:n_anchors], device=device)
        raw = torch.randn(b, anchors.shape[0], 15, generator=gen, device=device) * 2.0
        raw[..., 0] *= 4.0
        raw[: b // 2, 40:90, 0] = 25.0  # saturated sigmoids: ties to the lowest anchor
        raw[1, 7, 0] = float("nan")  # NaN ranks above +inf and is never live
        raw[2, :, 0] = float("nan")  # no live candidate: every slot invalid
        kernel = lambda: dp.detect_post(raw, anchors, 0.3, m)  # noqa: E731
        plain = lambda: detect_faces_batch(raw, anchors, 0.3, m)  # noqa: E731
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        for what, x, y in zip(("boxes", "landmarks", "scores", "validity"), got, ref):
            check(torch.equal(x, y), f"detect_post B={b} A={anchors.shape[0]} M={m}: {what} differ")
        check(not bool(got[3][2].any()), "a frame of NaN logits has a valid slot")
        line = {"B": b, "A": anchors.shape[0], "M": m, "valid_slots": int(got[3].sum()),
                "max_abs_err": 0.0}
        line["trace"], line["device_us"] = kernel_trace(kernel, "detect_post")
        if (b, side, n_anchors, m) in DETECT_CASES:
            line.update({"ms": statistics.median(cuda_ms(kernel, 20) for _ in range(3)),
                         "plain_ms": cuda_ms(plain, 3, 1), "library_ms": None})
            line["bytes"] = detect_post_bytes(raw, anchors, 0.3, m, got)
            line["bound_ms"] = line["bytes"] / HBM_BYTES_PER_S * 1e3
            line["bound_by"] = "bytes"
            line["plain_device_us"] = sum(device_us(plain, calls=3).values())
        print("detect_post", json.dumps(line), flush=True)
        lines[(b, m)] = line
    # The launcher plans the warps and shared memory in the kernel's own
    # source: it refuses a frame that 32 warps cannot hold, and the wrapper
    # raises.
    big = torch.zeros(1, 40000, 15, device=device)
    try:
        dp.detect_post(big, torch.zeros(40000, 3, device=device), 0.3, 16)
        refused = ""
    except ValueError as err:
        refused = str(err)
    check("refused" in refused, "detect_post did not refuse 40000 anchors")
    print(f"detect_post refuses 40000 anchors: {refused}", flush=True)
    return lines


def detect_post_bytes(raw, anchors, iou_threshold: float, max_faces: int, outs) -> int:
    """Bytes ``detect_post`` must move on this run's data. The card reads
    device memory in 32-byte sectors and a raw row is 60 bytes, so each
    anchor's logit costs a sector of its own. Counted once each: the sectors
    that hold every anchor's logit, the K candidates' box fields and the M
    picks' landmark fields (an invalid slot reads candidate 0's, as the
    kernel does); the sectors of the anchor rows those use; the outputs.
    ``raw`` starts on a sector, as the caching allocator places it."""
    import torch

    from facerecognition_tpu_torch.models.detector_net import decode_predictions, prefilter_size
    from facerecognition_tpu_torch.ops.matcher import topk_lowest_index
    from facerecognition_tpu_torch.ops.nms import nms_padded

    b, a, width = raw.shape
    dev = raw.device
    scores, boxes, _ = decode_predictions(raw, anchors)
    top_s, top_i = topk_lowest_index(scores, prefilter_size(a, max_faces))
    top_i = top_i.long()
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    keep, _ = nms_padded(top_boxes, top_s, iou_threshold, max_faces)
    picks = torch.gather(top_i, 1, keep.clamp(min=0).long())
    frame_row = torch.arange(b, device=dev)[:, None] * a

    def sectors(anchor, fields):
        fields = torch.tensor(fields, device=dev)
        return ((((frame_row + anchor)[..., None] * width + fields) * 4) // 32).flatten()

    every = torch.arange(a, device=dev).expand(b, -1)
    raw_sectors = torch.cat(
        [sectors(every, [0]), sectors(top_i, range(1, 5)), sectors(picks, range(5, 15))]
    ).unique().numel()
    used = torch.cat([top_i, picks], 1).unique()
    anchor_sectors = (((used[:, None] * 3 + torch.arange(3, device=dev)) * 4) // 32).unique().numel()
    return (raw_sectors + anchor_sectors) * 32 + sum(t.numel() * t.element_size() for t in outs)


def _counters():
    from facerecognition_tpu_torch.ops import (
        chi2_nn,
        detect_post,
        int8_topk,
        lbph_hist,
        stream_topk,
        warp_sample,
    )

    return {"stream_topk": stream_topk.launches, "warp_sample": warp_sample.launches,
            "detect_post": detect_post.launches, "int8_topk": int8_topk.launches,
            "lbph_hist": lbph_hist.launches, "chi2_row_stats": chi2_nn.stats_launches,
            "chi2_nn": chi2_nn.launches}


def reset_counters() -> dict:
    counters = _counters()
    for c in counters.values():
        c.reset()
    return counters


def smooth_frames(rng, n: int, side: int):
    """Noise upsampled 16x: the warp and the detector see structure rather
    than pixel noise."""
    import numpy as np

    coarse = rng.integers(0, 256, (n, side // 16, side // 16, 3))
    return np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2).astype(np.uint8)


def load_embedder(model_type: str, device):
    """The shipped embedder of ``model_type`` (ArcFace ultraslim, 112²; the
    9,343-identity FaceNet, 160², read by the port's msgpack reader)."""
    import os

    from facerecognition_tpu_torch.inference import extract_embeddings as ee

    if model_type == "facenet":
        path = ee.default_facenet_checkpoint()
        check(path is not None and os.path.basename(path) == FACENET_WEIGHTS,
              f"FaceNet weights resolved to {path}, not {FACENET_WEIGHTS}")
        return ee.load_facenet_model(path, device=device)
    return ee.load_arcface_model(ee.default_arcface_checkpoint(), device=device)


def serving_phase(card: str, max_faces: int, match_kernel: str = "stream",
                  model_type: str = "arcface"):
    """16 requests through ``MicroBatcher(max_faces=...)`` on the card, each
    detected face's own embedding planted in a 100k gallery; the same frames
    through the port on the CPU must agree. Returns the kernel launches, the
    fused call's profile and that call (the serving batch's fused call)."""
    import numpy as np

    from facerecognition_tpu_torch.apps.serving import MicroBatcher
    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    rng = np.random.default_rng(SEED + max_faces)
    frames = smooth_frames(rng, N_FRAMES, FRAME[0])
    rows = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    names = [f"id{r:06d}" for r in range(GALLERY_ROWS)]

    def build_engine(device):
        detector = FaceDetector(confidence_threshold=0.0, min_face_size=0, device=device)
        embedder = load_embedder(model_type, device)
        check(embedder.config.input_size == (160 if model_type == "facenet" else 112),
              f"{model_type} embedder takes {embedder.config.input_size}²")
        gallery = Gallery(512, device=device)
        gallery.add_many(names, rows)
        return RecognitionEngine(
            embedder, gallery, detector, match_kernel=match_kernel, device=device
        )

    t0 = time.perf_counter()
    engine = build_engine(None)  # the entry points' default device: the card
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    first = engine.fused_recognize_frames(frames, max_faces=max_faces)
    faces = [(f, j) for f in range(N_FRAMES) for j in range(len(first[f]["faces"]))]
    check(len(faces) >= N_FRAMES, f"only {len(faces)} faces in {N_FRAMES} frames")
    planted = {fj: int(r) for fj, r in zip(faces, rng.choice(GALLERY_ROWS, len(faces), replace=False))}
    own = np.stack([first[f]["faces"][j]["embedding"] for f, j in faces])
    engine.gallery.add_many([names[planted[fj]] for fj in faces], own)
    print(f"engine ready, {len(faces)} faces planted: {time.perf_counter() - t0:.3f} s", flush=True)

    batcher = MicroBatcher(engine, frame_size=FRAME, max_faces=max_faces, max_delay_ms=5)
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

    counters = reset_counters()
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
    launches = {name: c.count for name, c in counters.items()}
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    check(len(results) == N_FRAMES, f"{len(results)} of {N_FRAMES} answers")
    matcher = "int8_topk" if match_kernel == "int8" else "stream_topk"
    path = (matcher, "warp_sample") + (("detect_post",) if max_faces > 1 else ())
    for name in path:
        check(launches[name] > 0, f"max_faces={max_faces}: the path launched no {name} kernel")
    other = "stream_topk" if match_kernel == "int8" else "int8_topk"
    check(launches[other] == 0, f"match_kernel={match_kernel} launched {other}")
    for f, j in faces:
        check(j < len(results[f]["faces"]), f"frame {f}: face {j} missing when served")
        top = results[f]["faces"][j]["top_k"]
        want = names[planted[(f, j)]]
        row_score = dict(top).get(want)
        check(
            top[0][0] == want or (row_score is not None and top[0][1] - row_score <= 1e-6),
            f"frame {f} face {j}: top-1 {top[0]}, planted {want}",
        )
        check(top[0][1] > 0.99, f"frame {f} face {j}: top-1 score {top[0][1]}")
    lat = sorted(latencies)
    stats = batcher.stats()
    print(
        "serving", json.dumps({
            "card": card, "model_type": model_type, "max_faces": max_faces,
            "match_kernel": match_kernel,
            "requests": N_FRAMES, "faces": len(faces),
            "clients": N_CLIENTS, "batches": stats["batches"], "wall_s": serve_s,
            "latency_ms_p50": lat[(len(lat) - 1) // 2] * 1e3,
            "latency_ms_p99": lat[int(0.99 * (len(lat) - 1))] * 1e3,
            "launches": launches,
        }),
        flush=True,
    )

    t0 = time.perf_counter()
    cpu_engine = build_engine("cpu")
    cpu_engine.gallery.add_many([names[planted[fj]] for fj in faces], own)
    cpu = cpu_engine.fused_recognize_frames(frames, max_faces=max_faces)
    worst, worst_score = 1.0, 0.0
    for f, j in faces:
        check(j < len(cpu[f]["faces"]), f"frame {f}: face {j} missing on the CPU")
        card_face, cpu_face = results[f]["faces"][j], cpu[f]["faces"][j]
        e_gpu, e_cpu = card_face["embedding"], cpu_face["embedding"]
        cos = float(e_gpu @ e_cpu / (np.linalg.norm(e_gpu) * np.linalg.norm(e_cpu)))
        worst = min(worst, cos)
        check(cos > 0.999, f"frame {f} face {j}: card vs CPU embedding cosine {cos}")
        check(
            card_face["top_k"][0][0] == cpu_face["top_k"][0][0],
            f"frame {f} face {j}: card top-1 {card_face['top_k'][0]} vs CPU {cpu_face['top_k'][0]}",
        )
        if match_kernel == "int8":
            worst_score = max(worst_score, same_top_k(card_face["top_k"], cpu_face["top_k"],
                                                      INT8_TOL, f"frame {f} face {j}"))
    print(
        f"cpu plain path agrees: min embedding cosine {worst}, "
        + (f"max |score - CPU| {worst_score}, " if match_kernel == "int8" else "")
        + f"{time.perf_counter() - t0:.3f} s", flush=True,
    )
    batch = np.tile(frames, (PROFILE_BATCH // N_FRAMES, 1, 1, 1))
    profile = fused_profile(engine, batch, max_faces)
    return launches, profile, lambda: engine.fused_recognize_frames(batch, max_faces=max_faces)


def chi2_term_counts(q, g) -> dict:
    """The chi-square terms of (q, g) by kind: ``needed_terms`` (bins not
    both empty: what the exact form visits), ``both_nonzero_terms`` (the
    filter's P), ``filter_terms`` (the query's non-zero bins against every
    row: what the filter's loop visits) and ``dense_terms`` (B·N·F). Counts
    of 0/1 products in float32, exact below 2^24 a product."""
    import torch

    from facerecognition_tpu_torch.device import strict_fp32

    zq, nq = (q == 0).float(), (q != 0).float()
    both_zero = both_nonzero = 0.0
    with strict_fp32():
        for n0 in range(0, g.shape[0], 16_384):
            rows = g[n0 : n0 + 16_384]
            both_zero += float((zq @ (rows == 0).float().T).double().sum())
            both_nonzero += float((nq @ (rows != 0).float().T).double().sum())
    dense = q.shape[0] * g.shape[0] * q.shape[1]
    return {"needed_terms": int(dense - both_zero), "both_nonzero_terms": int(both_nonzero),
            "filter_terms": int(nq.sum().item()) * g.shape[0], "dense_terms": dense}


def kernel_order_nearest(q, g, rows: int = 256):
    """Each query's nearest row by ``chi2_distances_kernel_order`` (the
    kernels' summation order), ``rows`` gallery rows at a time: NaN first,
    then the smaller distance, then the lower index."""
    import torch

    from facerecognition_tpu_torch.ops import chi2_nn as cn

    best = torch.full((q.shape[0],), float("inf"), device=q.device)
    idx = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    for n0 in range(0, g.shape[0], rows):
        v, i = cn.nearest(cn.chi2_distances_kernel_order(q, g[n0 : n0 + rows]))
        nan_v, nan_b = torch.isnan(v), torch.isnan(best)
        better = (nan_v & ~nan_b) | (~nan_v & ~nan_b & (v < best))
        best = torch.where(better, v, best)
        idx = torch.where(better, i + n0, idx)
    return best, idx


def chi2_irregular_case(device) -> None:
    """``chi2_nn`` at a width that is not a multiple of 32, a gallery that
    ends inside a tile, duplicated rows, NaN and infinite bins (rows and
    queries the filter cannot bound): both paths equal the kernel-order
    emulation, nearest rows and distances, NaN where it has NaN."""
    import torch

    from facerecognition_tpu_torch.ops import chi2_nn as cn

    gen = torch.Generator(device=device).manual_seed(SEED + 23)

    def rows(n):
        return (torch.randint(1, 20, (n, 100), generator=gen, device=device) / 144.0
                * (torch.rand(n, 100, generator=gen, device=device) < 0.3))

    g, q = rows(3001), rows(6)
    q[0] = g[17]
    g[2000] = g[17]
    g[40, 3], g[41, 7] = float("nan"), float("-inf")  # terms of 0; rows the filter cannot bound
    q[1] = g[40]
    q[2, 9], q[3] = float("inf"), 0.0  # query 2: NaN against every row, the lowest wins
    want = cn.chi2_distances_kernel_order(q, g)
    wbest, widx = cn.nearest(want)
    best, idx = cn.chi2_nn(q, g)
    dbest, didx, d = cn.chi2_nn(q, g, return_distances=True)

    def same(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    check(torch.equal(idx, widx) and torch.equal(didx, widx) and same(best, wbest)
          and same(dbest, wbest) and same(d, want),
          f"chi2_nn at F = 100 with NaN/inf bins: rows {idx.tolist()} / {didx.tolist()}, "
          f"want {widx.tolist()}")
    print("chi2_nn irregular", json.dumps({"F": 100, "N": 3001, "rows": idx.tolist()}), flush=True)


def lbph_phase(card: str, device):
    """The LBPH path on the card. ``lbph_hist`` at B = 128, 100², (r 1, 8x8)
    and (r 2, 5x4), and at 16 neighbours (the histogram in the output row),
    bit for bit against its plain version on the card and on the CPU.
    ``LBPHModel`` trained on 75,000 faces on the card (the features from
    ``lbph_hist``), 128 probes through ``predict_batch`` (``chi2_nn``): each
    probe that is a training face comes back with its label at distance 0.
    ``chi2_nn`` at (128, 75,000, 16,384): argmin equal to the plain
    version's wherever the plain version's two nearest rows differ by more
    than 1e-5 relative, distances within 1e-5 relative, bit for bit against
    the kernel's order (``chi2_distances_kernel_order``) on a block of rows,
    duplicated rows resolved to the lower index; kernel, plain and library
    (the chunked PyTorch expression + ``torch.min``) times. Then the
    model's train / predict / predict_topk / predict_batch and
    ``recognize_face`` on the striped-class data of tests/test_lbph.py
    against the CPU port, with the launches per call."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.lbph import LBPHModel
    from facerecognition_tpu_torch.models.lbph_tools import recognize_face
    from facerecognition_tpu_torch.ops import chi2_nn as cn
    from facerecognition_tpu_torch.ops import lbph_hist as lh
    from facerecognition_tpu_torch.tools.lbph_data import lbph_faces

    gen = torch.Generator(device=device).manual_seed(SEED + 17)
    hist_lines = []
    for b, r, p, gx, gy, side in LBPH_CASES:
        imgs = lbph_faces(gen, b, 1, device)[:, :side, :side].contiguous()
        imgs[0, 20:60, 30:80] = 131.0  # a flat region: the fused taps decide its bits
        kernel = lambda: lh.lbph_hist(imgs, r, p, gx, gy)  # noqa: E731
        plain = lambda: lh.lbph_features_plain(imgs, r, p, gx, gy)  # noqa: E731
        got = kernel()
        torch.cuda.synchronize()
        check(torch.equal(got, plain()), f"lbph_hist r={r} P={p} {gx}x{gy}: differs from plain")
        if b <= WARP_B:
            check(torch.equal(got.cpu(), lh.lbph_features_plain(imgs.cpu(), r, p, gx, gy)),
                  f"lbph_hist r={r} P={p} {gx}x{gy}: differs from the plain version on the CPU")
        line = {"B": b, "side": side, "radius": r, "neighbors": p, "grid": [gx, gy],
                "bit_equal": True, "max_abs_err": 0.0}
        line["trace"], line["device_us"] = kernel_trace(kernel, "lbph_hist")
        line["ms"] = statistics.median(cuda_ms(kernel, 20) for _ in range(3))
        line["plain_ms"] = cuda_ms(plain, 3, 1)
        line["library_ms"] = None
        line["bound_ms"] = (imgs.numel() + got.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        line["bound_by"] = "bytes"
        print("lbph_hist", json.dumps(line), flush=True)
        hist_lines.append(line)

    # the full-size path: train on 75,000 faces, predict 128 probes
    counters = reset_counters()
    faces = lbph_faces(gen, LBPH_IDENTITIES, LBPH_SAMPLES, device)
    labels = np.repeat(np.arange(LBPH_IDENTITIES), LBPH_SAMPLES)
    model = LBPHModel(device=None)  # the entry points' default device: the card
    check(model.device == device, f"LBPHModel on {model.device}")
    t0 = time.perf_counter()
    model.train(faces, labels)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    gallery = model._gallery
    rows = faces.shape[0]
    probe_rows = torch.randperm(rows, generator=gen, device=device)[: LBPH_PROBES // 2]
    fresh = lbph_faces(gen, LBPH_PROBES // 2, 1, device)  # new faces: no planted answer
    probes = torch.cat([faces[probe_rows], fresh])
    t0 = time.perf_counter()
    pred, conf = model.predict_batch(probes)
    predict_s = time.perf_counter() - t0
    planted = probe_rows.cpu().numpy()
    check(bool((pred[: len(planted)] == labels[planted]).all()), "a training face came back mislabelled")
    check(bool((conf[: len(planted)] == 0.0).all()), "a training face is not at distance 0")
    model_launches = {name: c.count for name, c in counters.items()}
    for name in ("lbph_hist", "chi2_row_stats", "chi2_nn"):
        check(model_launches[name] > 0, f"the LBPH path launched no {name} kernel")
    print("lbph_model", json.dumps({
        "card": card, "rows": rows, "features": gallery.shape[1], "probes": len(probes),
        "train_s": train_s, "predict_batch_s": predict_s, "launches": model_launches,
    }), flush=True)
    del faces, fresh

    # chi2_nn at the full shape: the exact kernel-order argmin at planted,
    # duplicated, near-duplicated, overflowing and fresh probes; the plain
    # version; the return_distances path bit for bit on a block of rows
    q = model.features(probes)
    g = gallery
    dup = (rows // 3, rows - 2)
    g[dup[1]] = g[dup[0]]  # duplicated rows: the lower index must win
    ov = CHI2_OVERFLOW_ROW
    g[ov + 1 : ov + 1 + CHI2_OVERFLOW_COPIES] = g[ov]  # hundreds of rows within the margin
    near = int(planted[3])
    q[1] = g[int(planted[0])]  # a training row: distance 0
    q[2] = g[dup[0]]
    q[3] = g[near]  # a near-duplicate: counts moved between bins of one cell
    bins = q[3, :256].nonzero()[:3, 0]
    inv_cell = q[3][q[3] > 0].min()
    q[3, bins[0]] += 2 * inv_cell
    q[3, bins[1:]] -= inv_cell
    q[4] = g[ov]
    stats = cn.chi2_row_stats(g)  # the gallery changed under the model
    cand = torch.zeros(q.shape[0], dtype=torch.int32, device=device)
    best, idx = cn.chi2_nn(q, g, gallery_stats=stats, candidates=cand)
    torch.cuda.synchronize()
    kbest, kidx = kernel_order_nearest(q, g)
    check(torch.equal(idx, kidx) and torch.equal(best, kbest),
          f"chi2_nn differs from the kernel-order argmin at {(idx != kidx).nonzero()[:, 0].tolist()}")
    check(best[1].item() == 0.0, "the planted training row is not at distance 0")
    check(idx[2].item() == dup[0], f"duplicated rows {dup} came back as {idx[2].item()}")
    check(idx[3].item() == near and best[3].item() > 0.0, f"the near-duplicate came back as {idx[3].item()}")
    check(idx[4].item() == ov and cand[4].item() > CHI2_OVERFLOW_COPIES,
          f"the overflow probe came back as {idx[4].item()} from {cand[4].item()} candidates")
    t0 = time.perf_counter()
    pbest, pidx, pd = cn.chi2_nn_plain(q, g, return_distances=True)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rel = ((best - pbest).abs() / pbest.abs().clamp(min=1e-30)).max().item()
    err = (best - pbest).abs().max().item()
    check(rel <= 1e-5, f"chi2_nn: nearest distance differs from plain by {rel} relative")
    top2 = torch.topk(pd, 2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0]) > 1e-5 * top2[:, 1]
    check(bool((idx[clear] == pidx[clear]).all()), "chi2_nn: nearest rows differ from plain")
    _, _, kd = cn.chi2_nn(q[:8], g[:CHI2_CHECK_ROWS], return_distances=True)
    emulated = cn.chi2_distances_kernel_order(q[:8], g[:CHI2_CHECK_ROWS])
    check(torch.equal(kd, emulated), "chi2_nn distances differ from the kernel-order emulation")
    drel = ((kd - pd[:8, :CHI2_CHECK_ROWS]).abs()
            / pd[:8, :CHI2_CHECK_ROWS].abs().clamp(min=1e-30)).max().item()
    check(drel <= 1e-5, f"chi2_nn distances differ from plain by {drel} relative")
    err = max(err, (kd - pd[:8, :CHI2_CHECK_ROWS]).abs().max().item())
    masks, sums = cn.row_stats_plain(g[:CHI2_CHECK_ROWS])
    check(torch.equal(stats[0][:CHI2_CHECK_ROWS], masks), "chi2_row_stats masks differ from plain")
    check(torch.allclose(stats[1][:CHI2_CHECK_ROWS], sums, rtol=1e-12, atol=0.0),
          "chi2_row_stats sums differ from plain")
    del pd, top2, kd, emulated
    # timed on the model's probes (planted and fresh: q[4] on the block of
    # equal rows, whose 301 rows are all rescored, is timed apart)
    typical = q.clone()
    typical[4] = typical[5]
    kernel = lambda: cn.chi2_nn(typical, g, gallery_stats=stats)  # noqa: E731
    checked = lambda: cn.chi2_nn(q, g, gallery_stats=stats)  # noqa: E731
    one = lambda: cn.chi2_nn(q[:1], g, gallery_stats=stats)  # noqa: E731  predict's shape
    q8, g8 = q[:8].contiguous(), g[:CHI2_CHECK_ROWS]
    exact = lambda: cn.chi2_nn(q8, g8, return_distances=True)  # noqa: E731

    def library():
        # the chunked PyTorch expression of the distance, then torch.min
        out = torch.empty((q.shape[0], g.shape[0]), device=device)
        step = max(1, (1 << 28) // (q.shape[0] * q.shape[1]))
        for n0 in range(0, g.shape[0], step):
            x, y = q[:, None, :], g[None, n0 : n0 + step]
            s_, d_ = x + y, x - y
            out[:, n0 : n0 + step] = 2.0 * torch.where(
                s_ > 0, d_ * d_ / s_.clamp(min=1e-20), 0.0).sum(-1)
        return torch.min(out, dim=1)

    lib = library()
    check(bool((lib.indices[clear] == idx[clear]).all()), "the library expression's rows differ")
    chi2 = {"B": q.shape[0], "N": g.shape[0], "F": g.shape[1], "max_abs_err": err,
            "max_rel_err": max(rel, drel), "exact_argmin_probes": q.shape[0],
            "nearest_checked": int(clear.sum()), "plain_s": plain_s,
            "candidates": {"max": int(cand.max()), "median": float(cand.float().median()),
                           "total": int(cand.sum()), "overflow_probe": int(cand[4])}}
    chi2["ms"] = statistics.median(cuda_ms(kernel, 3, 1) for _ in range(3))
    chi2["ms_with_overflow_probe"] = statistics.median(cuda_ms(checked, 3, 1) for _ in range(3))
    chi2["ms_B1"] = statistics.median(cuda_ms(one, 5, 1) for _ in range(3))
    chi2["return_distances_ms_8x4096"] = statistics.median(cuda_ms(exact, 5, 1) for _ in range(3))
    chi2["library_ms"] = cuda_ms(library, 1, 0)
    chi2["plain_ms"] = plain_s * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel()
    torch.cuda.synchronize()
    chi2["wall_ms_one_call"] = (time.perf_counter() - t0) * 1e3
    # the profiler's kernels of each path (late in a run it may lose long
    # events or halve them: ``ms`` is by CUDA events)
    chi2["profiler_events_us_per_call"] = {
        path: {name: [count, us] for name, (count, us) in profile_kernels(fn, calls=calls).items()}
        for path, fn, calls in (("gallery stats", lambda: cn.chi2_row_stats(g), 5),
                                ("filter B=128", kernel, 2), ("with the overflow probe", checked, 2),
                                ("filter B=1", one, 5), ("return_distances 8x4096", exact, 5))}
    names = {n.split("<")[0] for path in chi2["profiler_events_us_per_call"].values() for n in path}
    check({"chi2_stats", "chi2_filter", "chi2_rescore", "chi2_exact", "chi2_merge"} <= names,
          f"the profiler's trace lacks chi2_nn's kernels: {sorted(names)}")
    chi2.update(chi2_term_counts(typical, g))
    moved = (typical.numel() + g.numel()) * 4 + typical.shape[0] * 12
    chi2["visited_share"] = chi2["filter_terms"] / chi2["dense_terms"]
    chi2["bound_bytes_ms"] = moved / HBM_BYTES_PER_S * 1e3
    # the operations the function needs on this data: with (q-g)^2/(q+g) =
    # (q+g) - 4qg/(q+g) and the rows' sums, only the bins non-zero on both
    # sides take arithmetic, plus the exact rescoring of one row a query
    # (B·F terms)
    chi2["bound_ops_ms"] = ((chi2["both_nonzero_terms"] + q.shape[0] * g.shape[1])
                            * FP32_OPS_PER_TERM / FP32_FLOPS_PER_S * 1e3)
    chi2["bound_ms"] = max(chi2["bound_bytes_ms"], chi2["bound_ops_ms"])
    # computed, not measured: the first design's bound (every term whose
    # bins are not both empty), so shares compare across designs; and the
    # kernel's reciprocals (one for two rows of a lane) at the MUFU rate
    chi2["bound_ms_union_terms"] = max(
        chi2["bound_bytes_ms"], chi2["needed_terms"] * FP32_OPS_PER_TERM / FP32_FLOPS_PER_S * 1e3)
    chi2["mufu_model_ms"] = chi2["filter_terms"] / 2 / MUFU_PER_S * 1e3
    chi2["bound_by"] = "bytes" if chi2["bound_bytes_ms"] >= chi2["bound_ops_ms"] else "operations"
    chi2["under_load"] = clocks_under_load(kernel, 3.0)
    print("chi2_nn", json.dumps(chi2), flush=True)
    del q, typical, g, gallery, model, lib, stats
    torch.cuda.empty_cache()
    chi2_irregular_case(device)

    # the model's API on the striped classes, card against the CPU port
    rng = np.random.default_rng(SEED + 19)
    images, labels = [], []
    for c in range(3):
        for _ in range(5):
            img = rng.integers(0, 100, (60, 60)).astype(np.uint8)
            img[:: c + 2, :] = 220
            images.append(img)
            labels.append(c)
    images, labels = np.stack(images), np.array(labels)
    per_call = {}
    models = {}
    for dev in (device, "cpu"):
        m = LBPHModel(device=dev)
        m.train(images[:10], labels[:10])
        m.update(images[10:], labels[10:])
        models[str(dev)] = m
    card_m, cpu_m = models[str(device)], models["cpu"]
    check(np.array_equal(card_m.histograms, cpu_m.histograms), "LBPH histograms differ from the CPU")
    for probe in [images[0], images[7] // 2 + 10] + [images[i] for i in (3, 12)]:
        for name, call in (("predict", lambda m: m.predict(probe)),
                           ("predict_topk", lambda m: m.predict_topk(probe, k=3)),
                           ("recognize_face", lambda m: recognize_face(m, probe, {0: "a", 1: "b"}))):
            counters = reset_counters()
            got = call(card_m)
            per_call[name] = {k: c.count for k, c in counters.items() if c.count}
            want = call(cpu_m)
            if name == "predict":
                check(got[0] == want[0] and abs(got[1] - want[1]) <= 1e-5 * max(1.0, want[1]),
                      f"LBPH predict {got} vs CPU {want}")
            elif name == "predict_topk":
                check([lab for lab, _ in got] == [lab for lab, _ in want],
                      f"LBPH predict_topk {got} vs CPU {want}")
            else:
                check(got["identity"] == want["identity"], f"recognize_face {got} vs CPU {want}")
    counters = reset_counters()
    got = card_m.predict_batch(images, probe_chunk=4)
    per_call["predict_batch (15 images, 4 a call)"] = {k: c.count for k, c in counters.items() if c.count}
    want = cpu_m.predict_batch(images, probe_chunk=4)
    check(np.array_equal(got[0], want[0]) and np.allclose(got[1], want[1], rtol=1e-5, atol=1e-6),
          "LBPH predict_batch differs from the CPU")
    print("lbph_api", json.dumps({"card": card, "agree_with_cpu": True,
                                  "launches_per_call": per_call}), flush=True)
    return hist_lines[0], hist_lines[-1], chi2, model_launches


def staged_phase(card: str, model_type: str = "arcface",
                 kinds: tuple = ("dense", "stream", "int8")) -> dict:
    """The staged API on the card against the CPU port: ``add_to_db`` of
    three identities (two images each), then ``recognize``,
    ``recognize_batch`` and ``recognize_all`` with each matcher of
    ``kinds``. Identities and top-k names equal; confidences within 1e-4
    (dense, stream) or ``INT8_TOL`` (int8: a query code can flip); each
    embedding's cosine with the CPU's above 0.999. Every kernel the staged
    path runs must launch."""
    import numpy as np

    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    rng = np.random.default_rng(SEED + 11)
    frames = smooth_frames(rng, STAGED_FRAMES, 160)
    crowd = smooth_frames(rng, 1, FRAME[0])[0]
    rows = rng.normal(size=(STAGED_ROWS, 512)).astype(np.float32)
    names = [f"row{r:05d}" for r in range(STAGED_ROWS)]

    def build(device):
        engine = RecognitionEngine(
            load_embedder(model_type, device),
            detector=FaceDetector(confidence_threshold=0.0, min_face_size=0, max_faces=4,
                                  device=device),
            device=device,
        )
        engine.gallery.add_many(names, rows)
        return engine

    card_engine, cpu_engine = build(None), build("cpu")
    counters = reset_counters()
    for e in (card_engine, cpu_engine):
        for i in range(3):
            check(e.add_to_db(f"enrolled{i}", [frames[i], frames[i][:, ::-1].copy()]),
                  f"add_to_db enrolled{i} on {e.device}")
    for i in range(3):
        row = card_engine.gallery._index[f"enrolled{i}"]
        cos = float(card_engine.gallery._store[row] @ cpu_engine.gallery._store[row])
        check(cos > 0.9999, f"enrolled{i}: card vs CPU mean embedding cosine {cos}")
    worst, worst_cos = {}, 1.0
    for kind in kinds:
        tol = INT8_TOL if kind == "int8" else 1e-4
        out = []
        for e in (card_engine, cpu_engine):
            e.match_kernel = kind
            single = [e.recognize(f, k=5) for f in frames[:3]]
            batch = e.recognize_batch(list(frames), k=5)
            crowd_faces = e.recognize_all(crowd, k=5, max_faces=4)["faces"]
            out.append(single + batch + crowd_faces)
            for i in range(3):
                check(single[i]["identity"] == batch[i]["identity"] == f"enrolled{i}",
                      f"{kind} on {e.device}: frame {i} recognized as {single[i]['identity']}")
        got, ref = out
        check(len(got) == len(ref), f"{kind}: {len(got)} results on the card, {len(ref)} on the CPU")
        err = 0.0
        for n, (g, r) in enumerate(zip(got, ref)):
            check(g["identity"] == r["identity"], f"{kind} result {n}: {g['identity']} vs CPU {r['identity']}")
            check(abs(g["confidence"] - r["confidence"]) <= tol,
                  f"{kind} result {n}: confidence {g['confidence']} vs CPU {r['confidence']}")
            cos = float(g["embedding"] @ r["embedding"]
                        / (np.linalg.norm(g["embedding"]) * np.linalg.norm(r["embedding"])))
            check(cos > 0.999, f"{kind} result {n}: card vs CPU embedding cosine {cos}")
            worst_cos = min(worst_cos, cos)
            err = max(err, same_top_k(g["top_k"], r["top_k"], tol, f"{kind} result {n}"))
        worst[kind] = err
    launches = {name: c.count for name, c in counters.items()}
    path = ("warp_sample", "detect_post") + (("stream_topk",) if "stream" in kinds else ()) + (
        ("int8_topk",) if "int8" in kinds else ())
    for name in path:
        check(launches[name] > 0, f"the staged path launched no {name} kernel")
    print("staged", json.dumps({"card": card, "model_type": model_type,
                                "results_per_matcher": len(got),
                                "max_abs_confidence_diff": worst,
                                "min_embedding_cosine": worst_cos, "launches": launches}),
          flush=True)
    return launches


def blaze_phase(card: str) -> dict:
    """The blaze checkpoint (``detector_v2_128``) on the card: ``detect_all``
    and one fused call with ``max_faces=4`` and the int8 matcher; boxes
    within 1e-3 px of the CPU port's, identities equal."""
    import numpy as np

    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        load_arcface_model,
    )
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    rng = np.random.default_rng(SEED + 13)
    frames = smooth_frames(rng, 8, FRAME[0])
    rows = rng.normal(size=(STAGED_ROWS, 512)).astype(np.float32)
    names = [f"row{r:05d}" for r in range(STAGED_ROWS)]

    def build(device):
        det = FaceDetector(weights=BLAZE_WEIGHTS, confidence_threshold=0.0, min_face_size=0,
                           max_faces=4, device=device)
        check(det.arch == "blaze", f"{BLAZE_WEIGHTS} loaded as {det.arch}")
        engine = RecognitionEngine(load_arcface_model(default_arcface_checkpoint(), device=device),
                                   detector=det, match_kernel="int8", device=device)
        engine.gallery.add_many(names, rows)
        return engine

    card_engine, cpu_engine = build(None), build("cpu")
    counters = reset_counters()
    worst = 0.0
    for f in frames[:3]:
        got, ref = card_engine.detector.detect_all(f), cpu_engine.detector.detect_all(f)
        check(len(got) == len(ref) > 0, f"blaze detect_all: {len(got)} faces vs CPU {len(ref)}")
        for g, r in zip(got, ref):
            worst = max(worst, float(np.abs(np.subtract(g["bbox"], r["bbox"])).max()))
    got = card_engine.fused_recognize_frames(frames, k=5, max_faces=4)
    ref = cpu_engine.fused_recognize_frames(frames, k=5, max_faces=4)
    for b, (g, r) in enumerate(zip(got, ref)):
        check(len(g["faces"]) == len(r["faces"]) == 4, f"blaze fused frame {b}: face counts")
        for gf, rf in zip(g["faces"], r["faces"]):
            worst = max(worst, float(np.abs(np.subtract(gf["bbox"], rf["bbox"])).max()))
            check(gf["identity"] == rf["identity"], f"blaze fused frame {b}: identities differ")
    check(worst <= 1e-3, f"blaze boxes differ from the CPU port by {worst} px")
    launches = {name: c.count for name, c in counters.items()}
    for name in ("warp_sample", "detect_post", "int8_topk"):
        check(launches[name] > 0, f"the blaze path launched no {name} kernel")
    print("blaze", json.dumps({"card": card, "weights": BLAZE_WEIGHTS, "max_abs_box_px": worst,
                               "launches": launches}), flush=True)
    return launches


def enrol_phase(card: str) -> dict:
    """The enrolment and evaluation path on the card against the CPU port:

    1. decode: every fixture file through ``load_image`` (PNG: the stored PIL
       digests; JPEG: the digests with libjpeg, within ``NVJPEG_MAX_ABS`` of
       the stored PIL arrays with nvJPEG), ``decode_batch`` files/s;
    2. an LBPH ``DatabaseBuilder`` job over 1,024 x 4 generated PNG faces
       (its two files load); the first 64 identities trained on the card and
       on the CPU: histograms, labels, label map, sweep rows and threshold
       equal; training and threshold search timed on the card;
    3. ArcFace and FaceNet ``DatabaseBuilder`` jobs over the fixture folder
       with the shipped detector: the same identities, each mean embedding's
       cosine with the CPU's above 0.999;
    4. ``create_engine_from_embeddings_dir`` on the ArcFace gallery with the
       ``stream`` matcher, ``recognize(path)`` on every fixture: identities
       equal, confidences within 1e-4;
    5. ``evaluate_recognition_engine`` (``measure_speed=True``) on the
       engines' aligned fixture faces: metrics, top-k and CMC equal, AUC and
       EER within 1e-3 (pair scores close to each other may trade places);
    6. ``ExplainabilityEngine`` and ``FaceNetExplainabilityEngine`` on a
       fixture file: CAMs within 1e-3, embeddings' cosine above 0.999.

    ``lbph_hist``, ``chi2_nn``, ``detect_post`` and ``stream_topk`` must
    launch."""
    import hashlib
    import os
    import tempfile

    import numpy as np
    import torch

    from facerecognition_tpu_torch.data import native_decode
    from facerecognition_tpu_torch.data.datasets import FolderDataset
    from facerecognition_tpu_torch.inference import extract_embeddings as ee
    from facerecognition_tpu_torch.inference.database_builder import DatabaseBuilder
    from facerecognition_tpu_torch.inference.engine import create_engine_from_embeddings_dir
    from facerecognition_tpu_torch.inference.evaluate import evaluate_recognition_engine
    from facerecognition_tpu_torch.inference.explainability import (
        ExplainabilityEngine,
        FaceNetExplainabilityEngine,
    )
    from facerecognition_tpu_torch.models.lbph import LBPHModel
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.tools.lbph_data import lbph_faces
    from facerecognition_tpu_torch.training import train_lbph
    from facerecognition_tpu_torch.utils.imageio import load_image, save_png

    line: dict = {"card": card}
    with open(os.path.join(FIXTURES, "faces.json")) as f:
        files = json.load(f)["files"]
    stored = np.load(os.path.join(FIXTURES, "faces_jpeg_pixels.npz"))
    backend = native_decode.jpeg_backend()
    counters = reset_counters()

    # 1. decode
    jpeg_err, jpeg_sum, jpeg_px, digests_equal = 0, 0.0, 0, 0
    for rel, info in sorted(files.items()):
        img = load_image(os.path.join(FIXTURES, rel))
        check(list(img.shape) == info["shape"], f"{rel}: decoded {img.shape}, want {info['shape']}")
        same = hashlib.sha256(img.tobytes()).hexdigest() == info["sha256"]
        digests_equal += same
        if rel.endswith(".png") or backend == "libjpeg":
            check(same, f"{rel}: decoded pixels differ from PIL's ({backend})")
        else:
            diff = np.abs(img.astype(np.int64) - stored[rel].astype(np.int64))
            jpeg_err, jpeg_sum, jpeg_px = max(jpeg_err, int(diff.max())), jpeg_sum + float(diff.sum()), jpeg_px + diff.size
    check(jpeg_err <= NVJPEG_MAX_ABS, f"nvJPEG pixels {jpeg_err} levels from PIL's (bound {NVJPEG_MAX_ABS})")
    paths = [os.path.join(FIXTURES, rel) for rel in sorted(files)]
    _, ok = native_decode.decode_batch(paths, 128)
    check(bool(ok.all()), "decode_batch failed on a fixture")
    t0 = time.perf_counter()
    for _ in range(5):
        native_decode.decode_batch(paths, 128)
    line["decode"] = {"jpeg_backend": backend, "files": len(paths), "digests_equal": digests_equal,
                      "jpeg_max_abs_vs_pil": jpeg_err, "jpeg_mean_abs_vs_pil": jpeg_sum / max(jpeg_px, 1),
                      "decode_batch_files_per_s": 5 * len(paths) / (time.perf_counter() - t0)}

    with tempfile.TemporaryDirectory(prefix="enrol-") as tmp:
        # 2. LBPH: a DatabaseBuilder job over 1,024 x 4 PNG faces, then the subset on both devices
        faces = lbph_faces(torch.Generator().manual_seed(SEED + 17), ENROL_LBPH_IDENTITIES,
                           ENROL_LBPH_SAMPLES, "cpu").to(torch.uint8).numpy()
        lbph_dir, subset_dir = os.path.join(tmp, "lbph"), os.path.join(tmp, "lbph_subset")
        t0 = time.perf_counter()
        for i in range(ENROL_LBPH_IDENTITIES):
            for d in (lbph_dir, subset_dir) if i < ENROL_LBPH_SUBSET else (lbph_dir,):
                os.makedirs(os.path.join(d, f"person{i}"))
                for k in range(ENROL_LBPH_SAMPLES):
                    save_png(os.path.join(d, f"person{i}", f"{k}.png"), faces[i * ENROL_LBPH_SAMPLES + k])
        write_s = time.perf_counter() - t0
        lbph_paths = [os.path.join(lbph_dir, f"person{i}", f"{k}.png")
                      for i in range(ENROL_LBPH_IDENTITIES) for k in range(ENROL_LBPH_SAMPLES)]
        t0 = time.perf_counter()
        _, ok = native_decode.decode_batch(lbph_paths, 100)
        png_files_per_s = len(lbph_paths) / (time.perf_counter() - t0)
        check(bool(ok.all()), "decode_batch failed on a generated PNG")
        builder = DatabaseBuilder(os.path.join(tmp, "out"))
        job = builder.create_job("lbph", lbph_dir)
        builder.start_build(job).join()
        check(job.status == "completed", f"LBPH job {job.status}: {job.error}")
        model = LBPHModel.load(job.output_files[0])
        label_map = np.load(job.output_files[1], allow_pickle=True).item()
        check(len(label_map) == ENROL_LBPH_IDENTITIES and len(model.labels) == len(lbph_paths),
              f"LBPH job files: {len(label_map)} identities, {len(model.labels)} rows")
        t0 = time.perf_counter()
        images, labels, _ = train_lbph.load_faces_and_labels(lbph_dir)
        load_s = time.perf_counter() - t0
        timed = LBPHModel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.train(images, labels)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        thr, best, _ = train_lbph.find_optimal_threshold(timed, images, labels)
        search_s = time.perf_counter() - t0
        check(thr == model.threshold, f"LBPH threshold {thr} vs the job's {model.threshold}")
        sub = {}
        for name, dev in (("card", None), ("cpu", "cpu")):
            res = train_lbph.train_lbph_from_directory(subset_dir, os.path.join(tmp, f"sub_{name}"),
                                                       device=dev)
            sub[name] = (res, np.load(res["model_path"]),
                         np.load(res["label_map_path"], allow_pickle=True).item())
        (rc, mc, lc), (rp, mp, lp) = sub["card"], sub["cpu"]
        check(np.array_equal(mc["histograms"], mp["histograms"]), "LBPH subset: histograms differ")
        check(np.array_equal(mc["labels"], mp["labels"]) and lc == lp, "LBPH subset: labels differ")
        check(rc["sweep"] == rp["sweep"] and rc["optimal_threshold"] == rp["optimal_threshold"],
              f"LBPH subset: sweep or threshold differ ({rc['optimal_threshold']} vs {rp['optimal_threshold']})")
        line["lbph"] = {"identities": ENROL_LBPH_IDENTITIES, "images": len(lbph_paths),
                        "write_png_s": write_s, "decode_batch_png_files_per_s": png_files_per_s,
                        "job_s": job.elapsed_seconds, "load_faces_s": load_s, "train_s": train_s,
                        "threshold_search_s": search_s, "threshold": thr, "best": best,
                        "subset_identities": ENROL_LBPH_SUBSET,
                        "subset_threshold": rc["optimal_threshold"]}

        # 3. ArcFace and FaceNet gallery jobs over the fixture folder, card and CPU
        folder = os.path.join(FIXTURES, "faces")
        checkpoints = {"arcface": ee.default_arcface_checkpoint(), "facenet": ee.default_facenet_checkpoint()}
        galleries, jobs = {}, {}
        for model_type in ("arcface", "facenet"):
            for name, dev in (("card", None), ("cpu", "cpu")):
                builder = DatabaseBuilder(os.path.join(tmp, name), device=dev)
                job = builder.create_job(model_type, folder)
                builder.start_build(job, detector=FaceDetector(device=dev),
                                    checkpoint_path=checkpoints[model_type]).join()
                check(job.status == "completed", f"{model_type} job on {name}: {job.status} {job.error}")
                galleries[model_type, name] = np.load(job.output_files[0], allow_pickle=True).item()
                jobs[f"{model_type}_{name}_s"] = job.elapsed_seconds
            got, ref = galleries[model_type, "card"], galleries[model_type, "cpu"]
            check(sorted(got) == sorted(ref) and len(got) > 0,
                  f"{model_type} gallery: {len(got)} identities on the card, {len(ref)} on the CPU")
            worst = min(float(got[k] @ ref[k]) for k in ref)
            check(worst > 0.999, f"{model_type} gallery: card vs CPU cosine {worst}")
            jobs[f"{model_type}_identities"] = len(got)
            jobs[f"{model_type}_min_cosine"] = worst
        line["galleries"] = jobs

        # 4. the engine on the built ArcFace gallery
        engines = {name: create_engine_from_embeddings_dir(
            checkpoints["arcface"], os.path.join(tmp, name, "arcface"),
            detector=FaceDetector(device=dev), device=dev, match_kernel="stream")
            for name, dev in (("card", None), ("cpu", "cpu"))}
        conf_err, right = 0.0, 0
        for rel in sorted(files):
            got, ref = (engines[n].recognize(os.path.join(FIXTURES, rel)) for n in ("card", "cpu"))
            check(got["status"] == ref["status"] and got["identity"] == ref["identity"],
                  f"recognize {rel}: {got['identity']} on the card, {ref['identity']} on the CPU")
            conf_err = max(conf_err, abs(got["confidence"] - ref["confidence"]))
            right += got["identity"] == rel.split("/")[1]
        check(conf_err <= 1e-4, f"recognize: confidences {conf_err} apart")
        line["recognize"] = {"files": len(files), "identity_is_folder": right,
                             "max_abs_confidence_diff": conf_err}

        # 5. evaluation on each engine's aligned fixture faces
        index = FolderDataset(folder)
        evals = {}
        for name, engine in engines.items():
            faces_ = []
            for path in index.paths:
                img = load_image(path)
                aligned = engine.detect_and_align(img)
                faces_.append(aligned if aligned is not None else
                              np.asarray(img, np.float32)[8:120, 8:120])
            evals[name] = evaluate_recognition_engine(
                engine, np.stack(faces_), index.labels, index.label_names,
                measure_speed=name == "card")
        got, ref = evals["card"], evals["cpu"]
        for key in ("metrics", "top_1_accuracy", "top_5_accuracy", "cmc"):
            check(got[key] == ref[key], f"evaluation {key}: {got[key]} vs CPU {ref[key]}")
        for key in ("auc", "eer"):
            check(abs(got["verification"][key] - ref["verification"][key]) <= 1e-3,
                  f"evaluation {key}: {got['verification'][key]} vs CPU {ref['verification'][key]}")
        line["evaluate"] = {"metrics": got["metrics"], "top_1_accuracy": got["top_1_accuracy"],
                            "verification": got["verification"], "speed": got["speed"]}

        # 6. explanations of one fixture file
        path = os.path.join(FIXTURES, "faces", "id3", "3_rgb.png")
        cams = {}
        for kind in ("arcface", "facenet"):
            out = {}
            for name, dev in (("card", None), ("cpu", "cpu")):
                detector = FaceDetector(device=dev)
                if kind == "arcface":
                    out[name] = ExplainabilityEngine(engines[name].embedder, detector).explain(path)
                else:
                    out[name] = FaceNetExplainabilityEngine(load_embedder("facenet", dev),
                                                            detector).explain(path)
            g, r = out["card"], out["cpu"]
            cam_err = float(np.abs(g["cam"] - r["cam"]).max())
            cos = float(g["embedding"] @ r["embedding"]
                        / (np.linalg.norm(g["embedding"]) * np.linalg.norm(r["embedding"])))
            check(cam_err <= 1e-3 and cos > 0.999, f"{kind} CAM: {cam_err} apart, cosine {cos}")
            cams[kind] = {"cam_max_abs_diff": cam_err, "embedding_cosine": cos}
        line["explain"] = cams

    launches = {name: c.count for name, c in counters.items()}
    for name in ("lbph_hist", "chi2_nn", "detect_post", "stream_topk"):
        check(launches[name] > 0, f"the enrolment path launched no {name} kernel")
    line["launches"] = launches
    print("enrol", json.dumps(line), flush=True)
    return launches


def apps_phase(card: str) -> dict:
    """The serving apps on the card (``apps/web_app``, ``apps/realtime``),
    against the same requests to the port's app on the CPU:

    1. galleries built through the app: POST /database-builder/build over
       the fixture folder for ArcFace, FaceNet and LBPH, polled through
       /database-builder/status/<id>; registries on the outputs (shipped
       checkpoints and detector) on the card with ``stream`` and ``int8``,
       and on the CPU;
    2. the WSGI app in process: every page 200; POST / (three-model compare
       with Grad-CAM overlays) on three fixture files, /batch with 8 files,
       /recognize raw and multipart with 8 frames: identities and top-k
       names equal (rows closer than the tolerance may trade places),
       ArcFace / FaceNet confidences within ``APPS_CONF_TOL``, LBPH
       distances within ``APPS_LBPH_RTOL``, CAM overlays within
       ``APPS_OVERLAY_MAX_ABS`` levels; the int8 registry's top-1s equal;
    3. ``main()``'s threaded server on 127.0.0.1:0 over a real socket:
       ``APPS_CLIENTS`` threads x ``APPS_REQUESTS`` /recognize requests of
       the clip's 256² JPEG frames (``http.client``): requests/s, p50/p99;
       /stats must read ``gpu`` and show a batch of more than one request;
    4. /video with the committed MJPEG clip, every_n=2: the frame count,
       the identities of ``process_video`` on the CPU port, and the frames
       decoded on the card within ``NVJPEG_MAX_ABS`` of the stored pixels;
    5. /video_feed: 8 MJPEG parts decoded by the port's decoder,
       /realtime_result leaves "..." within 30 s, /stop_camera.

    Every kernel counter is set to 0 at the start; each of the six kernels
    must launch in the phase."""
    import base64
    import http.client
    import io
    import os
    import tempfile

    import numpy as np

    from facerecognition_tpu_torch.apps import web_app
    from facerecognition_tpu_torch.apps.realtime import (
        SyntheticFrameSource,
        VideoFileSource,
        avi_frames,
        process_video,
    )
    from facerecognition_tpu_torch.data.native_decode import decode_mem
    from facerecognition_tpu_torch.inference.database_builder import DatabaseBuilder
    from facerecognition_tpu_torch.inference.engine import Gallery
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.utils.imageio import encode_jpeg

    t_phase = time.perf_counter()
    counters = reset_counters()
    line: dict = {"card": card}

    def call(app, method, path, fields=None, body=b"", ctype=None, accept="application/json",
             query=""):
        if fields is not None:
            boundary = "chipsmokeboundary"
            parts = []
            for name, value in fields:
                if isinstance(value, tuple):
                    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                                 f'filename="{value[0]}"\r\n\r\n'.encode() + value[1] + b"\r\n")
                else:
                    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"'
                                 f'\r\n\r\n{value}\r\n'.encode())
            body = b"".join(parts) + f"--{boundary}--\r\n".encode()
            ctype = f"multipart/form-data; boundary={boundary}"
        environ = {"REQUEST_METHOD": method, "PATH_INFO": path, "QUERY_STRING": query,
                   "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body),
                   "HTTP_ACCEPT": accept}
        if ctype:
            environ["CONTENT_TYPE"] = ctype
        got = {}
        chunks = app(environ, lambda status, headers: got.update(status=status))
        data = b"".join(chunks)
        check(got["status"] == "200 OK", f"{method} {path}: {got['status']} {data[:300]!r}")
        return json.loads(data) if data[:1] in (b"{", b"[") else data

    def fixture(rel):
        with open(os.path.join(FIXTURES, "faces", rel), "rb") as f:
            return f.read()

    def near_tie(ref, tol):
        """The reference's answer could flip within ``tol``: its best score
        that close to the threshold or to the runner-up."""
        top = ref["top_k"]
        return abs(ref["confidence"] - APPS_THRESHOLD) <= tol or (len(top) > 1 and top[0][1] - top[1][1] <= tol)

    def same_result(got, ref, what):
        check(got["status"] == ref["status"], f"{what}: {got['status']} vs CPU {ref['status']}")
        if got["status"] != "success":
            return 0.0
        if got.get("model") == "lbph":
            check(got["identity"] == ref["identity"], f"{what}: {got['identity']} vs CPU {ref['identity']}")
            gd, rd = np.array([d for _, d in got["top_k"]]), np.array([d for _, d in ref["top_k"]])
            check([n for n, _ in got["top_k"]] == [n for n, _ in ref["top_k"]]
                  and np.allclose(gd, rd, rtol=APPS_LBPH_RTOL, atol=0), f"{what}: {got['top_k']} vs CPU {ref['top_k']}")
            return float(np.max(np.abs(gd - rd) / np.maximum(np.abs(rd), 1e-30)))
        err = same_top_k(got["top_k"], ref["top_k"], APPS_CONF_TOL, what)
        if not near_tie(ref, APPS_CONF_TOL):
            check(got["identity"] == ref["identity"], f"{what}: {got['identity']} vs CPU {ref['identity']}")
        for gf, rf in zip(got.get("faces", []), ref.get("faces", [])):
            check(abs(gf["confidence"] - rf["confidence"]) <= APPS_CONF_TOL, f"{what}: face {gf} vs CPU {rf}")
        check(len(got.get("faces", [])) == len(ref.get("faces", [])), f"{what}: faces differ from the CPU's")
        return err

    with tempfile.TemporaryDirectory(prefix="apps-") as tmp:
        # 1. galleries through the app's builder routes
        t0 = time.perf_counter()
        builder = DatabaseBuilder(os.path.join(tmp, "databases"))
        detector = FaceDetector(confidence_threshold=0.5)
        builder_app = web_app.create_app(web_app.EngineRegistry(detector=detector), builder=builder)
        outputs = {}
        for model_type in ("arcface", "facenet", "lbph"):
            job = call(builder_app, "POST", "/database-builder/build",
                       [("dataset_dir", os.path.join(FIXTURES, "faces")), ("model_type", model_type)])
            deadline = time.time() + 120
            while True:
                status = call(builder_app, "GET", f"/database-builder/status/{job['job_id']}")
                if status["status"] in ("completed", "failed") or time.time() > deadline:
                    break
                time.sleep(0.1)
            check(status["status"] == "completed", f"{model_type} build job: {status['status']} {status['error']}")
            outputs[model_type] = status["output_files"]
        line["build_s"] = time.perf_counter() - t0

        def registry(device, match_kernel):
            reg = web_app.EngineRegistry(
                gallery_path=outputs["arcface"][0], lbph_model_path=outputs["lbph"][0],
                detector=FaceDetector(confidence_threshold=0.5, device=device),
                threshold=APPS_THRESHOLD, match_kernel=match_kernel, device=device)
            facenet = reg.get("facenet")
            facenet.gallery = Gallery.load(outputs["facenet"][0], device=device)
            check(len(reg.get("arcface").gallery) == 16 and len(facenet.gallery) == 16
                  and reg.get("lbph") is not None, "the built galleries did not load")
            return reg

        reg_card, reg_int8, reg_cpu = registry(None, "stream"), registry(None, "int8"), registry("cpu", "stream")
        check(reg_card.get("arcface").device.type == "cuda", "the app's engine is not on the card")
        app_card = web_app.create_app(reg_card, builder=builder)
        app_int8 = web_app.create_app(reg_int8, builder=builder)
        app_cpu = web_app.create_app(reg_cpu, builder=DatabaseBuilder(os.path.join(tmp, "cpu"), device="cpu"))

        # 2. the WSGI app in process
        for page in ("/", "/batch", "/realtime", "/database-builder", "/static/css/style.css",
                     "/static/js/index.js", "/stats", "/healthz"):
            call(app_card, "GET", page, accept="text/html")
        conf_err, lbph_err, overlay_err, overlay_mean = 0.0, 0.0, 0, 0.0
        t0 = time.perf_counter()
        for rel in ("id0/0_baseline.jpg", "id5/1_progressive.jpg", "id11/2_gray.jpg"):
            fields = [("image", (rel, fixture(rel))), ("threshold", str(APPS_THRESHOLD)), ("gradcam", "1")]
            got, ref = call(app_card, "POST", "/", fields), call(app_cpu, "POST", "/", fields)
            for m in ("arcface", "facenet", "lbph"):
                err = same_result(got["results"][m], ref["results"][m], f"POST / {rel} {m}")
                if m == "lbph":
                    lbph_err = max(lbph_err, err)
                else:
                    conf_err = max(conf_err, err)
            check(set(got["gradcam"]) == set(ref["gradcam"]) == {"arcface", "facenet"},
                  f"POST / {rel}: overlays {set(got['gradcam'])} vs CPU {set(ref['gradcam'])}")
            for m in got["gradcam"]:
                g = decode_mem(base64.b64decode(got["gradcam"][m])).astype(np.int64)
                r = decode_mem(base64.b64decode(ref["gradcam"][m])).astype(np.int64)
                check(g.shape == r.shape, f"POST / {rel}: {m} overlay {g.shape} vs CPU {r.shape}")
                overlay_err = max(overlay_err, int(np.abs(g - r).max()))
                overlay_mean = max(overlay_mean, float(np.abs(g - r).mean()))
        check(overlay_err <= APPS_OVERLAY_MAX_ABS, f"CAM overlays {overlay_err} levels from the CPU's")
        page = call(app_card, "POST", "/", [("image", ("a.jpg", fixture("id3/0_baseline.jpg")))],
                    accept="text/html")
        check(b"data:image/png;base64" in page, "the HTML answer draws no faces")
        line["compare_s"] = time.perf_counter() - t0

        batch_files = [f"id{i}/{k}" for i, k in zip(range(0, 16, 2), ["0_baseline.jpg", "3_rgb.png"] * 4)]
        fields = [("model", "arcface")] + [("images", (rel, fixture(rel))) for rel in batch_files]
        got, ref = call(app_card, "POST", "/batch", fields), call(app_cpu, "POST", "/batch", fields)
        for g, r in zip(got["results"], ref["results"]):
            check(g["filename"] == r["filename"] and g["status"] == r["status"] == "success",
                  f"/batch {g['filename']}: {g['status']} vs CPU {r['status']}")
            check(abs(g["confidence"] - r["confidence"]) <= APPS_CONF_TOL,
                  f"/batch {g['filename']}: {g['confidence']} vs CPU {r['confidence']}")
            if abs(r["confidence"] - APPS_THRESHOLD) > APPS_CONF_TOL:
                check(g["identity"] == r["identity"], f"/batch {g['filename']}: {g['identity']} vs {r['identity']}")
            conf_err = max(conf_err, abs(g["confidence"] - r["confidence"]))

        path = os.path.join(FIXTURES, "faces_clip.avi")
        with open(path, "rb") as f:
            clip = f.read()
        frames_jpeg = [clip[o:o + n] for o, n in avi_frames(path)[2]]
        raw = frames_jpeg[0]
        multi = [("file", (f"f{i}.jpg", frames_jpeg[i])) for i in range(8)]
        answers = {}
        for name, app in (("card", app_card), ("int8", app_int8), ("cpu", app_cpu)):
            answers[name] = (call(app, "POST", "/recognize", body=raw, ctype="image/jpeg"),
                             call(app, "POST", "/recognize", multi))
        for (g, r, i8, what) in [(answers["card"][0], answers["cpu"][0], answers["int8"][0], "raw")] + [
                (g, r, i8, f"multipart frame {i}") for i, (g, r, i8) in enumerate(zip(
                    answers["card"][1]["results"], answers["cpu"][1]["results"], answers["int8"][1]["results"]))]:
            conf_err = max(conf_err, same_result(g, r, f"/recognize {what}"))
            check([n for n, _ in i8["top_k"][:1]] == [n for n, _ in g["top_k"][:1]] or near_tie(g, INT8_TOL),
                  f"/recognize {what}: int8 top-1 {i8['top_k'][:1]} vs stream {g['top_k'][:1]}")
        check(answers["card"][1]["count"] == 8, "multipart /recognize did not answer 8 frames")
        with_face = sum(r["identity"] != "No face" for r in answers["card"][1]["results"])
        check(with_face >= 4, f"/recognize found a face in {with_face} of 8 clip frames")
        line["in_process"] = {"max_abs_confidence_diff": conf_err, "max_rel_lbph_diff": lbph_err,
                              "overlay_max_abs": overlay_err, "overlay_mean_abs": overlay_mean,
                              "recognize_identities": [r["identity"] for r in answers["card"][1]["results"]],
                              "recognize_frames_with_a_face": with_face}

        # 3. main()'s threaded server over a socket
        servers: list = []
        argv = ["--port", "0", "--threads", "16", "--gallery", outputs["arcface"][0],
                "--lbph-model", outputs["lbph"][0], "--match-kernel", "stream", "--warmup"]
        server_thread = threading.Thread(target=web_app.main, kwargs={"argv": argv, "ready": servers.append},
                                         daemon=True)
        server_thread.start()
        deadline = time.time() + 120
        while not servers and time.time() < deadline and server_thread.is_alive():
            time.sleep(0.05)
        check(bool(servers), "main() did not start its server")
        port = servers[0].server_address[1]
        latencies: list[float] = []
        first: list[float] = []  # each client's first request
        failures: list[str] = []
        lock = threading.Lock()

        def get_stats() -> dict:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("GET", "/stats")
            out = json.loads(conn.getresponse().read())
            conn.close()
            return out

        def client(c):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                for i in range(APPS_REQUESTS):
                    body = frames_jpeg[(c * APPS_REQUESTS + i) % len(frames_jpeg)]
                    t = time.perf_counter()
                    conn.request("POST", "/recognize", body=body, headers={"Content-Type": "image/jpeg"})
                    resp = conn.getresponse()
                    data = resp.read()
                    with lock:
                        (latencies if i else first).append(time.perf_counter() - t)
                        if resp.status != 200:
                            failures.append(f"{resp.status} {data[:200]!r}")
            finally:
                conn.close()

        try:
            before = get_stats()["models"]["arcface"]["batching"]  # --warmup's frames
            threads = [threading.Thread(target=client, args=(c,)) for c in range(APPS_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - t0
            check(not failures and len(latencies) + len(first) == APPS_CLIENTS * APPS_REQUESTS,
                  f"socket: {len(latencies) + len(first)} answers, failures {failures[:3]}")
            stats = get_stats()
        finally:
            servers[0].shutdown()
            server_thread.join(timeout=60)
        check(not server_thread.is_alive(), "the server did not stop")
        batching = stats["models"]["arcface"]["batching"]
        check(stats["platform"] == "gpu", f"/stats platform {stats['platform']}")
        # the clients' own requests and batches, without the warm-up's
        requests, batches = (batching[key] - before[key] for key in ("requests", "batches"))
        check(requests == APPS_CLIENTS * APPS_REQUESTS and requests > batches,
              f"no batch coalesced the clients' requests: {before} then {batching}")
        lat = sorted(latencies + first)
        warm = sorted(latencies)
        line["socket"] = {"clients": APPS_CLIENTS, "requests": len(lat), "wall_s": wall,
                          "requests_per_s": len(lat) / wall, "latency_ms_p50": lat[(len(lat) - 1) // 2] * 1e3,
                          "latency_ms_p99": lat[int(0.99 * (len(lat) - 1))] * 1e3,
                          "first_request_ms": [round(x * 1e3, 3) for x in first],
                          "after_first_p50_ms": warm[(len(warm) - 1) // 2] * 1e3,
                          "after_first_p99_ms": warm[int(0.99 * (len(warm) - 1))] * 1e3,
                          "stats_platform": stats["platform"], "stats_device": stats["device"],
                          "batching": batching, "batching_before_clients": before}

        # 4. /video with the committed clip
        with open(os.path.join(FIXTURES, "faces_clip.json")) as f:
            clip_meta = json.load(f)
        stored = np.load(os.path.join(FIXTURES, "faces_clip_pixels.npz"))
        src = VideoFileSource(path)
        decode_err = 0
        for i in range(src.frame_count):
            frame = src.read()
            if f"frame{i:02d}" in stored.files:
                decode_err = max(decode_err, int(np.abs(frame.astype(np.int64)
                                                        - stored[f"frame{i:02d}"].astype(np.int64)).max()))
        src.release()
        check(decode_err <= NVJPEG_MAX_ABS, f"clip frames {decode_err} levels from libjpeg's")
        t0 = time.perf_counter()
        video = call(app_card, "POST", "/video", [("video", ("clip.avi", clip)), ("every_n", "2")])
        video_s = time.perf_counter() - t0
        want = process_video(reg_cpu.get("arcface"), path, every_n=2)
        check(video["frames"] == want["frames"] == len(clip_meta["sha256"]) // 2,
              f"/video frames {video['frames']} vs CPU {want['frames']}")
        for i, (g, r) in enumerate(zip(video["timeline"], want["results"])):
            check(abs(g["confidence"] - r["confidence"]) <= APPS_CONF_TOL + 1e-4,
                  f"/video frame {i}: {g} vs CPU {r['identity']} {r['confidence']}")
            if not near_tie(r, APPS_CONF_TOL):
                check(g["identity"] == r["identity"], f"/video frame {i}: {g['identity']} vs CPU {r['identity']}")
        card_video = process_video(reg_card.get("arcface"), path, every_n=1)
        clip_right = sum(bool(r["top_k"]) and r["top_k"][0][0] == name
                         for r, name in zip(card_video["results"], clip_meta["identities"]))
        line["video"] = {"frames": video["frames"], "route_s": video_s, "route_fps": video["frames"] / video_s,
                         "process_video_fps": card_video["fps"], "process_video_frames": card_video["frames"],
                         "clip_top1_is_its_identity": clip_right,
                         "decode_max_abs_vs_libjpeg": decode_err,
                         "identities": [t["identity"] for t in video["timeline"]],
                         "clip_identities": clip_meta["identities"][::2]}

        # 5. the MJPEG stream
        environ = {"REQUEST_METHOD": "GET", "PATH_INFO": "/video_feed"}
        stream = app_card(environ, lambda status, headers: None)
        t0 = time.perf_counter()
        part_ms = []
        for part in stream:
            part_ms.append((time.perf_counter() - t0) * 1e3 - sum(part_ms))
            head, jpeg = part.split(b"\r\n\r\n", 1)
            check(head == b"--frame\r\nContent-Type: image/jpeg", f"MJPEG part header {head!r}")
            check(decode_mem(jpeg[:-2]).shape == (480, 640, 3), "an MJPEG part does not decode")
            if len(part_ms) == 8:
                break
        stream_s = time.perf_counter() - t0
        parts = len(part_ms)
        stream.close()
        deadline = time.time() + 30
        while True:
            result = call(app_card, "GET", "/realtime_result")
            if result["identity"] != "..." or time.time() > deadline:
                break
            time.sleep(0.1)
        check(result["identity"] not in ("...", "Error"), f"/realtime_result: {result}")
        call(app_card, "POST", "/stop_camera")
        # the stream's host work alone, the worker stopped: a synthetic frame, its encoding
        source = SyntheticFrameSource()
        frame_ms, encode_ms = [], []
        for _ in range(5):
            t = time.perf_counter()
            frame = source.read()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            encode_jpeg(frame)
            encode_ms.append((time.perf_counter() - t) * 1e3)
        line["stream"] = {"parts": parts, "seconds": stream_s, "parts_per_s": parts / stream_s,
                          "part_ms": [round(x, 3) for x in part_ms],
                          "frame_ms_alone": statistics.median(frame_ms),
                          "encode_ms_alone": statistics.median(encode_ms),
                          "realtime_result": result.get("identity")}

    launches = {name: c.count for name, c in counters.items()}
    for name in KERNELS:
        check(launches[name] > 0, f"the apps launched no {name} kernel")
    line["launches"] = launches
    line["phase_s"] = time.perf_counter() - t_phase
    print("apps", json.dumps(line), flush=True)
    return launches


def same_top_k(got, ref, tol: float, what: str) -> float:
    """Two top-k lists of (name, score): scores within ``tol``, names equal
    wherever the reference's neighbouring scores are more than ``tol``
    apart (closer rows may trade places). Returns max |Δscore|."""
    import numpy as np

    check(len(got) == len(ref), f"{what}: {len(got)} matches vs {len(ref)}")
    gs = np.array([sc for _, sc in got])
    rs = np.array([sc for _, sc in ref])
    err = float(np.abs(gs - rs).max()) if len(rs) else 0.0
    check(err <= tol, f"{what}: max |score - reference| {err} > {tol}")
    gap = np.full(len(rs), np.inf)
    if len(rs) > 1:
        d = rs[:-1] - rs[1:]
        gap[:-1] = d
        gap[1:] = np.minimum(gap[1:], d)
    for (gn, _), (rn, _), clear in zip(got, ref, gap > tol):
        check(gn == rn or not clear, f"{what}: {got} vs {ref}")
    return err


def fused_profile(engine, frames, max_faces: int) -> dict:
    """Where one fused call of the serving batch spends device time: every
    kernel's device µs per call from the profiler's trace, their sum, the
    call's wall time (host clock, synchronised), the host time the device
    does not cover (wall - device) and the device events per call (kernel
    launches and copies counted one by one, not by name)."""
    import torch

    def call():
        return engine.fused_recognize_frames(frames, max_faces=max_faces)

    call()  # warm: cuDNN picks its algorithms
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    events = profile_kernels(call, calls=3)
    check(bool(events), "the profiler's trace holds no device time")
    times = {name[:60]: us for name, (_, us) in events.items()}
    device_ms = sum(times.values()) / 1e3
    copies = sum(n for name, (n, _) in events.items() if name.startswith("Memcpy") or name.startswith("Memset"))
    top = dict(sorted(times.items(), key=lambda kv: -kv[1])[:14])
    line = {
        "max_faces": max_faces, "match_kernel": engine.match_kernel, "batch": len(frames),
        "wall_ms": wall_ms,
        "device_ms": device_ms, "host_gap_ms": wall_ms - device_ms,
        "launches_per_call": sum(n for n, _ in events.values()) - copies,
        "copies_per_call": copies, "kernels": len(times), "top_us": top,
        "ours_us": {k: v for k, v in times.items()
                    if k.split("<")[0] in ("warp_sample", "detect_post", "split_queries",
                                           "topk_partial", "topk_merge", "int8_quantize",
                                           "int8_partial")},
    }
    print("fused_profile", json.dumps(line), flush=True)
    return line


# -- the training path ------------------------------------------------------------


def affine_matrices_for(kind: str, b: int, s: int, gen):
    """(b, 2, 3) forward maps: ``heavy`` draws the heavy tier's ranges with
    every gate on; ``identity``; ``guard`` a 90° turn whose inverse has
    |m00| < 1e-6 (warp_coefficients' sign-preserving guard)."""
    import math

    import torch

    from facerecognition_tpu_torch.data.augment import affine_matrices, augment_draws

    if kind == "heavy":
        draws = augment_draws(gen, b, s, "heavy")
        draws["affine"] = torch.ones_like(draws["affine"])
        return affine_matrices(draws, s)
    ms = torch.zeros((b, 2, 3))
    if kind == "identity":
        ms[:, 0, 0] = ms[:, 1, 1] = 1.0
        return ms
    theta = math.pi / 2 + 5e-7
    c = (s - 1) / 2.0
    ms[:, 0, 0], ms[:, 0, 1], ms[:, 1, 0], ms[:, 1, 1] = (
        math.cos(theta), -math.sin(theta), math.sin(theta), math.cos(theta))
    ms[:, 0, 2] = c - ms[:, 0, 0] * c - ms[:, 0, 1] * c
    ms[:, 1, 2] = c - ms[:, 1, 0] * c - ms[:, 1, 1] * c
    return ms


def affine_warp_checks(device) -> dict:
    """``affine_warp`` (the kernel's matrix mode) against
    ``affine_warp_mxu_batch`` on the card: at B 128, 112² with float32 and
    uint8 frames and at B 32, 160², with heavy-tier, identity and guard
    matrices. Bit-equal with ``fast``, within 1e-3 levels without; the
    per-slot coefficients bit for bit against the plain ones on the card and
    the CPU; one kernel per call (its trace). The guard's pixels are printed,
    not gated (its shear is ill-conditioned): its coefficients and finite
    output are. Returns the lines by (case, fast)."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.ops import warp_mxu as wm
    from facerecognition_tpu_torch.ops import warp_sample as ws

    rng = np.random.default_rng(SEED + 11)
    gen = torch.Generator().manual_seed(SEED + 11)
    lines = {}
    for name, b, s, dtype in AFFINE_CASES:
        frames_u8, _ = warp_inputs(rng, s, b, 1, device)
        frames = frames_u8 if dtype == "uint8" else frames_u8.float()
        for kind in ("heavy", "identity", "guard"):
            ms = affine_matrices_for(kind, b, s, gen).to(device)
            got_p = ws.affine_slot_parameters(frames, ms, s)
            check(torch.equal(got_p, ws.affine_slot_parameters_plain(ms)),
                  f"affine_warp {name} {kind}: slot parameters differ from the plain ones on the card")
            check(torch.equal(got_p.cpu(), ws.affine_slot_parameters_plain(ms.cpu())),
                  f"affine_warp {name} {kind}: slot parameters differ from the plain ones on the CPU")
            for fast in (True, False):
                kernel = lambda: ws.affine_warp(frames, ms, s, s, fast)  # noqa: E731
                plain = lambda: wm.affine_warp_mxu_batch(frames, ms, s, s, fast=fast)  # noqa: E731
                with strict_fp32():
                    got = kernel()
                    ref = plain()
                    diff = (got - ref).abs()
                    line = {"case": name, "matrices": kind, "frames": b, "side": s, "dtype": dtype,
                            "fast": fast, "max_abs_err": diff.max().item(),
                            "mean_abs_err": diff.mean().item(),
                            "finite": bool(torch.isfinite(got).all())}
                    check(line["finite"], f"affine_warp {name} {kind}: non-finite output")
                    if kind != "guard":
                        check(line["max_abs_err"] <= (0.0 if fast else 1e-3),
                              f"affine_warp {name} {kind} fast={fast}: max |Δ| {line['max_abs_err']}")
                    if kind == "heavy":
                        line["ms"] = statistics.median(cuda_ms(kernel, 20) for _ in range(3))
                        line["plain_ms"] = cuda_ms(plain, 3, 1)
                        moved = got.numel() * 4 + frames.numel() * frames.element_size() + ms.numel() * 4
                        line["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
                        line["bound_by"] = "bytes"
                        line["library_ms"] = None
                        line["trace"], line["device_us"] = kernel_trace(kernel, "warp_sample")
                print("affine_warp", json.dumps(line), flush=True)
                lines[f"{name}/{kind}/{fast}"] = line
    return lines


def rel_err(a, b, floor: float = 0.0) -> float:
    """max |a - b| / max(max |b|, floor): a tensor whose true value is 0
    (the gradient of a bias a training-mode batch norm follows, the running
    mean of a batch-normalised input) holds rounding only and is measured
    against ``floor``, 1e-3 of the largest tensor of its kind."""
    scale = max(b.abs().max().item(), floor)
    return (a - b).abs().max().item() / scale if scale else (a - b).abs().max().item()


def parity_step(kind: str, device) -> dict:
    """One train step on the card and on the CPU from the same initial
    variables on a fixed batch (augmentation none, dropout 0, mixup 0):
    ArcFace (ResNet50, B 16, 112², SGD with momentum, weight decay, clip and
    a warmup) or FaceNet (P 4 x K 2, 160², semi_hard, adam). The CPU also
    runs it in float64, the truth both float32 runs are measured against: a
    training-mode batch norm over 16 samples makes some gradients of a
    random-init ResNet50 cancel, and float32 on the CPU itself is up to 15%
    off float64 there. Gates: the loss within 1e-4 relative; every gradient
    tensor and BN statistic (and the SGD run's updated parameters; adam's
    first update is about lr·sign(g), printed only) within the larger of
    1e-3 and 4x the CPU's own float32 error, each by ``rel_err`` with its
    floor."""
    import copy

    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.facenet import FaceNetModel
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain
    from facerecognition_tpu_torch.training.schedules import build_schedule

    rng = np.random.default_rng(SEED + 12)
    gen = torch.Generator().manual_seed(SEED + 12)
    if kind == "arcface":
        b, s, classes = PARITY_ARC_B, 112, TRAIN_IDENTITIES
        model = init_like_flax(ArcFaceModel(512, num_classes=classes, margin=0.2, easy_margin=True,
                                            dropout=0.0), gen, ("fc",))
        labels = torch.as_tensor(rng.integers(0, classes, b))
        step = steps.make_arcface_train_step(label_smoothing=0.1)
        tx = lambda m: OptaxChain(dict(m.named_parameters()), "sgd",  # noqa: E731
                                  build_schedule(0.1, "cosine", 100, 10), momentum=0.9,
                                  weight_decay=5e-4, grad_clip=1.0)
    else:
        p, k = PARITY_FN_PK
        b, s = p * k, 160
        model = init_like_flax(FaceNetModel(512, dropout=0.0), gen)
        labels = torch.arange(p).repeat_interleave(k)
        step = steps.make_facenet_train_step(0.5, "semi_hard")
        tx = lambda m: OptaxChain(dict(m.named_parameters()), "adam",  # noqa: E731
                                  build_schedule(3e-4, "step", 100, step_size=10, gamma=0.5))
    images = torch.as_tensor(rng.normal(size=(b, s, s, 3)).astype(np.float32))
    results = {}
    for name, dev, dtype in (("card", device, torch.float32), ("cpu", torch.device("cpu"), torch.float32),
                             ("cpu64", torch.device("cpu"), torch.float64)):
        m = copy.deepcopy(model).to(dev, dtype)
        state = steps.TrainState(m, tx(m))
        grads, metrics = step.gradients(state, images.to(dev, dtype), labels.to(dev))
        steps.apply_gradients(state, grads)
        results[name] = {
            "loss": metrics["loss"].item(),
            "grads": {n: g.detach().cpu().double() for n, g in grads.items()},
            "state": {n: t.detach().cpu().double() for n, t in m.state_dict().items()
                      if t.is_floating_point()},
        }

    def errors(got, want):
        floor = 1e-3 * max(t.abs().max().item() for t in want.values())
        return {n: rel_err(got[n], t, floor) for n, t in want.items()}

    def split(r):
        return {"grads": r["grads"],
                "stats": {n: t for n, t in r["state"].items() if "running_" in n},
                "params": {n: t for n, t in r["state"].items() if "running_" not in n}}

    card, cpu, truth = (split(results[n]) for n in ("card", "cpu", "cpu64"))
    loss_rel = abs(results["card"]["loss"] - results["cpu"]["loss"]) / max(abs(results["cpu"]["loss"]), 1e-30)
    line = {"kind": kind, "batch": b, "side": s, "loss_card": results["card"]["loss"],
            "loss_cpu": results["cpu"]["loss"], "loss_cpu64": results["cpu64"]["loss"], "loss_rel": loss_rel,
            "tensors": len(cpu["grads"])}
    check(loss_rel <= 1e-4, f"{kind}: card loss {line['loss_card']} vs CPU {line['loss_cpu']}")
    per_tensor = {}
    for what in ("grads", "stats", "params"):
        vs_cpu = errors(card[what], cpu[what])
        own = errors(cpu[what], truth[what])  # the CPU's float32 against float64
        vs_truth = errors(card[what], truth[what])
        per_tensor[what] = {n: [float(f"{vs_cpu[n]:.3g}"), float(f"{own[n]:.3g}")] for n in vs_cpu}
        worst = max(vs_cpu, key=lambda n: vs_cpu[n] / max(1e-3, 4 * own[n]))
        line[what] = {"card_vs_cpu_max": max(vs_cpu.values()), "cpu32_vs_cpu64_max": max(own.values()),
                      "card_vs_cpu64_max": max(vs_truth.values()),
                      "worst": [worst, vs_cpu[worst], own[worst]]}
        if what != "params" or kind == "arcface":
            check(all(vs_cpu[n] <= max(1e-3, 4 * own[n]) for n in vs_cpu),
                  f"{kind}: {what} {worst} off the CPU's by {vs_cpu[worst]} (CPU float32 vs float64: {own[worst]})")
    print("train parity", json.dumps(line), flush=True)
    print("train parity per tensor [card vs CPU, CPU float32 vs float64]",
          json.dumps({"kind": kind, **per_tensor}), flush=True)
    return line


def heavy_augment_parity(device) -> dict:
    """The heavy tier's augmentation of one ArcFace batch on the card and on
    the CPU from the same draws: within 1e-3 levels; then one step on it."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws

    rng = np.random.default_rng(SEED + 13)
    b, s = PARITY_ARC_B, 112
    frames, _ = warp_inputs(rng, s, b, 1, torch.device("cpu"))
    draws = augment_draws(torch.Generator().manual_seed(SEED + 13), b, s, "heavy")
    counters = reset_counters()
    card = apply_augment(frames.to(device), {k: v.to(device) for k, v in draws.items()}, "heavy")
    check(counters["warp_sample"].count == 1, f"heavy augmentation launched warp_sample "
          f"{counters['warp_sample'].count} times, not once")
    cpu = apply_augment(frames, draws, "heavy")
    err = (card.cpu() - cpu).abs().max().item()
    line = {"batch": b, "side": s, "max_abs_err": err, "mean_abs_err": (card.cpu() - cpu).abs().mean().item()}
    print("train heavy augmentation", json.dumps(line), flush=True)
    check(err <= 1e-3, f"heavy augmentation: card vs CPU {err} levels")
    return line


def miner_ties_check(device) -> dict:
    """The miners on the card pick the CPU's indices on embeddings with
    planted ties (equal rows: equal distances), and torch's argmin/argmax
    take the first index there as on the CPU (and in JAX)."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.models import facenet

    x = torch.tensor([[3.0, 1.0, 1.0, 5.0, 5.0, 0.5, 0.5]], device=device)
    check((torch.argmin(x, -1).item(), torch.argmax(x, -1).item()) == (5, 3),
          "argmin/argmax on the card do not take the first index on ties")
    rng = np.random.default_rng(SEED + 17)
    p, k = 8, 4
    emb = rng.normal(size=(p * k, 512)).astype(np.float32)
    emb[3], emb[10], emb[14] = emb[7], emb[11], emb[2]
    emb = torch.nn.functional.normalize(torch.as_tensor(emb), dim=1)
    labels = torch.arange(p).repeat_interleave(k)
    n = 0
    for miner in (lambda e, l: facenet.mine_semi_hard(e, l, 0.5), facenet.mine_batch_hard):
        cpu = miner(emb, labels)
        card = miner(emb.to(device), labels.to(device))
        check(all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu)), "the miners' indices differ on the card")
        n += int(cpu[3].sum())
    line = {"triplets_checked": n}
    print("train miners", json.dumps(line), flush=True)
    return line


def write_train_faces(root: str, device) -> float:
    """``TRAIN_IDENTITIES`` x ``TRAIN_SAMPLES`` RGB PNG faces of
    ``TRAIN_SIDE``², a person per folder: each identity a blocky colour
    pattern of its own, each sample it shifted and with noise. Made on the
    card in bulk, written by 8 threads. Returns the seconds."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from facerecognition_tpu_torch.utils.imageio import save_png

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    n, k, side = TRAIN_IDENTITIES, TRAIN_SAMPLES, TRAIN_SIDE
    coarse = torch.randint(30, 226, (n, 3, 9, 9), generator=gen, device=device).float()
    base = torch.nn.functional.interpolate(coarse, size=(side + 8, side + 8), mode="bilinear",
                                           align_corners=False)
    shifts = torch.randint(0, 9, (n, k, 2), generator=gen, device=device).cpu()
    noise = torch.randint(-10, 11, (n, k, 3, side, side), generator=gen, device=device)
    faces = torch.stack([
        torch.stack([base[i, :, shifts[i, j, 0]:shifts[i, j, 0] + side,
                          shifts[i, j, 1]:shifts[i, j, 1] + side] for j in range(k)])
        for i in range(n)])
    faces = (faces + noise).clamp(0, 255).to(torch.uint8).permute(0, 1, 3, 4, 2).cpu().numpy()
    for i in range(n):
        os.makedirs(os.path.join(root, f"person{i:04d}"))

    def write(i):
        for j in range(k):
            save_png(os.path.join(root, f"person{i:04d}", f"{j}.png"), faces[i, j])

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(write, range(n)))
    return time.perf_counter() - t0


def arcface_trainer_run(card: str, data_dir: str, ckpt_dir: str, export: str) -> dict:
    """``ArcFaceTrainer`` on the card from ``configs/arcface_config.yaml`` as
    shipped (ResNet50, 512-D, heavy, SGD, cosine with 2 warmup epochs, clip
    5, smoothing 0.1, B 128), ``TRAIN_ARC_STEPS`` steps an epoch, 2 epochs,
    a periodic checkpoint every epoch, ``keep_last_n`` 2; then ``resume
    ("last")`` in a new trainer and one more epoch, which deletes
    ``epoch_0``. Checks: finite losses, the tags, the resumed history, one
    warp a step; the weights exported by ``save_variables`` and loaded by
    ``load_arcface_model`` run one fused ``RecognitionEngine`` call."""
    import os

    import numpy as np

    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training.train_arcface import ArcFaceTrainer
    from facerecognition_tpu_torch.utils.serialization import save_variables

    overrides = [f"data.data_dir={data_dir}", f"checkpoint.dir={ckpt_dir}",
                 f"train.steps_per_epoch={TRAIN_ARC_STEPS}", "train.num_epochs=2",
                 "checkpoint.save_every_epochs=1", "checkpoint.keep_last_n=2"]
    line: dict = {"card": card}
    t0 = time.perf_counter()
    trainer = ArcFaceTrainer("configs/arcface_config.yaml", overrides)
    check(trainer.device.type == "cuda", f"ArcFaceTrainer on {trainer.device}")
    c = trainer.config
    check((c["data"]["augmentation"], c["train"]["batch_size"], c["train"]["optimizer"])
          == ("heavy", 128, "sgd"), f"arcface_config.yaml is not as shipped: {c}")
    line["setup_s"] = time.perf_counter() - t0
    counters = reset_counters()
    t0 = time.perf_counter()
    history = trainer.train()
    line["train_s"] = time.perf_counter() - t0
    line["launches"] = {name: c.count for name, c in counters.items()}
    check(counters["warp_sample"].count == 2 * TRAIN_ARC_STEPS,
          f"warp_sample launched {counters['warp_sample'].count} times in {2 * TRAIN_ARC_STEPS} steps")
    check(len(history) == 2 and all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"])
                                    for h in history), f"ArcFace history {history}")
    for tag in ("best", "last", "epoch_0", "epoch_1"):
        check(trainer.ckpt.exists(tag), f"ArcFace checkpoint {tag} missing")
    t2 = ArcFaceTrainer("configs/arcface_config.yaml", overrides)
    t2.resume("last")
    check(t2.history == history, "the resumed history differs from the saved one")
    check(t2.epoch == 2 and t2.config["train"]["num_epochs"] > 2, "resume did not auto-extend")
    t2.config["train"]["num_epochs"] = 3
    counters = reset_counters()
    h2 = t2.train()
    check(counters["warp_sample"].count == TRAIN_ARC_STEPS, "the resumed epoch did not warp once a step")
    check(len(h2) == 3 and np.isfinite(h2[-1]["train_loss"]), f"resumed history {h2}")
    tags = sorted(n for n in os.listdir(ckpt_dir) if n.startswith("ckpt_epoch_") and "." not in n)
    check(tags == ["ckpt_epoch_1", "ckpt_epoch_2"], f"periodic checkpoints after GC: {tags}")
    line["history"] = [{k: h[k] for k in ("epoch", "train_loss", "train_acc", "val_loss", "ver_acc",
                                          "epoch_seconds")} for h in h2]

    save_variables(export, t2.export_variables())
    embedder = load_arcface_model(export)
    gallery = Gallery(512)
    rows = np.random.default_rng(SEED + 15).normal(size=(64, 512)).astype(np.float32)
    gallery.add_many([f"id{r}" for r in range(64)], rows)
    engine = RecognitionEngine(embedder, gallery, FaceDetector(confidence_threshold=0.0,
                                                               min_face_size=0))
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    frames = smooth_frames(np.random.default_rng(SEED + 15), 4, FRAME[0])
    counters = reset_counters()
    out = engine.fused_recognize_frames(frames)
    check(len(out) == 4 and counters["warp_sample"].count >= 1,
          "the exported ArcFace checkpoint did not serve a fused call")
    faces = [f for r in out for f in r["faces"]]
    check(all(np.isfinite(f["embedding"]).all() for f in faces), "non-finite served embeddings")
    line["served_faces"] = len(faces)
    print("train arcface", json.dumps(line), flush=True)
    return line


def facenet_trainer_run(card: str, data_dir: str, ckpt_dir: str) -> dict:
    """``FaceNetTrainer`` on the card from ``configs/facenet_config.yaml``
    (P 8 x K 4, semi_hard, adam, light) at 160² over the same folder, 2
    epochs x ``TRAIN_FN_STEPS`` steps with ``resident: auto`` (the split on
    the card), then one step each with ``batch_hard`` and with ``remat``:
    finite losses, triplets mined."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.data.sampler import PKSampler
    from facerecognition_tpu_torch.training.steps import make_facenet_train_step
    from facerecognition_tpu_torch.training.train_arcface import normalize_u8
    from facerecognition_tpu_torch.training.train_facenet import FaceNetTrainer

    overrides = [f"data.data_dir={data_dir}", f"checkpoint.dir={ckpt_dir}",
                 f"train.steps_per_epoch={TRAIN_FN_STEPS}", "train.num_epochs=2"]
    line: dict = {"card": card}
    t0 = time.perf_counter()
    trainer = FaceNetTrainer("configs/facenet_config.yaml", overrides)
    counters = reset_counters()
    history = trainer.train()
    line["train_s"] = time.perf_counter() - t0
    line["launches"] = {name: c.count for name, c in counters.items()}
    check(trainer._resident_data is not None and trainer._resident_data.device.type == "cuda",
          "the FaceNet train split is not resident on the card")
    check(counters["warp_sample"].count == 2 * TRAIN_FN_STEPS, "FaceNet did not warp once a step")
    check(all(np.isfinite(h["train_loss"]) and h["avg_triplets"] > 0 for h in history),
          f"FaceNet history {history}")
    line["history"] = [{k: h[k] for k in ("epoch", "train_loss", "avg_triplets", "val_loss", "ver_acc")}
                       for h in history]
    idx = torch.as_tensor(next(iter(PKSampler(trainer.train_index, 8, 4, seed=SEED))),
                          device=trainer.device)
    s = trainer.config["data"]["image_size"]
    images = normalize_u8(trainer._resident_data.index_select(0, idx).reshape(-1, s, s, 3))
    labels = trainer._resident_labels.index_select(0, idx)
    for name, step in (("batch_hard", make_facenet_train_step(0.5, "batch_hard")),
                       ("remat", make_facenet_train_step(0.5, "semi_hard", remat=True))):
        gen = torch.Generator(device=trainer.device).manual_seed(SEED)
        metrics = step(trainer.state, images, labels, gen)
        loss, n = metrics["loss"].item(), metrics["n_triplets"].item()
        check(np.isfinite(loss) and n > 0, f"FaceNet {name} step: loss {loss}, {n} triplets")
        line[name] = {"loss": loss, "n_triplets": n}
    print("train facenet", json.dumps(line), flush=True)
    return line


def train_step_times(card: str, device) -> dict:
    """The ArcFace step at B 128, 112², ``TRAIN_CLASSES`` classes, heavy
    augmentation, on data resident on the card (``make_resident_step``): ms
    a step by CUDA events, images/s, the warp's share of the step's device
    time (profiler); the FaceNet step at P 8 x K 4, 160² (light)."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws
    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.facenet import FaceNetModel
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain
    from facerecognition_tpu_torch.training.schedules import build_schedule
    from facerecognition_tpu_torch.training.train_arcface import normalize_u8

    rng = np.random.default_rng(SEED + 16)
    out = {"card": card}
    for kind, b, s, tier in (("arcface", 128, 112, "heavy"), ("facenet", 32, 160, "light")):
        gen = torch.Generator().manual_seed(SEED + 16)
        if kind == "arcface":
            model = init_like_flax(ArcFaceModel(512, num_classes=TRAIN_CLASSES, margin=0.2,
                                                easy_margin=True), gen, ("fc",)).to(device)
            raw = steps.make_arcface_train_step(0.1)
            tx = OptaxChain(dict(model.named_parameters()), "sgd", build_schedule(0.01, "cosine", 1000, 20),
                            weight_decay=5e-4, grad_clip=5.0)
            labels_all = torch.as_tensor(rng.integers(0, TRAIN_CLASSES, TRAIN_RESIDENT), device=device)
        else:
            model = init_like_flax(FaceNetModel(512), gen).to(device)
            raw = steps.make_facenet_train_step(0.5, "semi_hard")
            tx = OptaxChain(dict(model.named_parameters()), "adam", build_schedule(3e-4, "step", 1000))
            labels_all = torch.arange(TRAIN_RESIDENT // 4, device=device).repeat_interleave(4)
        state = steps.TrainState(model, tx)
        data, _ = warp_inputs(rng, s, TRAIN_RESIDENT, 1, device)
        data = data.reshape(TRAIN_RESIDENT, -1)

        def with_aug(st, images_u8, labels, g, tier=tier, raw=raw):
            draws = augment_draws(g, images_u8.shape[0], images_u8.shape[1], tier)
            return raw(st, normalize_u8(apply_augment(images_u8, draws, tier)), labels, g)

        resident = steps.make_resident_step(with_aug, (s, s, 3))
        g = torch.Generator(device=device).manual_seed(SEED)
        if kind == "arcface":
            batches = [torch.as_tensor(rng.integers(0, TRAIN_RESIDENT, b), device=device) for _ in range(8)]
        else:
            ids = [rng.choice(TRAIN_RESIDENT // 4, 8, replace=False) for _ in range(8)]
            batches = [torch.as_tensor((i[:, None] * 4 + np.arange(4)).reshape(-1), device=device)
                       for i in ids]
        turn = [0]

        def one():
            turn[0] += 1
            return resident(state, data, labels_all, batches[turn[0] % len(batches)], g)

        ms = statistics.median(cuda_ms(one, 5, 2) for _ in range(3))
        events = profile_kernels(one, calls=3)
        total_us = sum(us for _, us in events.values())
        warp_us = sum(us for name, (_, us) in events.items() if name.startswith("warp_sample"))
        line = {"kind": kind, "batch": b, "side": s, "tier": tier, "ms_per_step": ms,
                "images_per_s": b / ms * 1e3, "device_ms_per_step": total_us / 1e3,
                "warp_device_us": warp_us, "warp_share": warp_us / total_us if total_us else None,
                "classes": TRAIN_CLASSES if kind == "arcface" else None}
        check(warp_us > 0, f"{kind} step trace holds no warp_sample")
        loss = one()["loss"].item()
        check(np.isfinite(loss), f"{kind} timed step loss {loss}")
        print("train step time", json.dumps(line), flush=True)
        out[kind] = line
        state = model = data = None
        torch.cuda.empty_cache()
    return out


def train_phase(card: str, device) -> dict:
    """The training path on the card: ``affine_warp`` against its plain
    version, one ArcFace and one FaceNet step against the CPU, the heavy
    augmentation against the CPU, both trainers end to end over a generated
    face folder (resume, checkpoint GC, the exported ArcFace weights served)
    and the step times."""
    import os
    import tempfile

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    out = {"affine": timed("affine_warp", affine_warp_checks, device)}
    out["parity"] = {kind: timed(f"parity_{kind}", parity_step, kind, device)
                     for kind in ("arcface", "facenet")}
    out["heavy"] = timed("heavy_augment", heavy_augment_parity, device)
    out["miners"] = timed("miners", miner_ties_check, device)
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        data_dir = os.path.join(tmp, "faces")
        timed("write_faces", write_train_faces, data_dir, device)
        out["arcface"] = timed("arcface_trainer", arcface_trainer_run, card, data_dir,
                               os.path.join(tmp, "ck_arc"), os.path.join(tmp, "arcface_trained.msgpack"))
        out["facenet"] = timed("facenet_trainer", facenet_trainer_run, card, data_dir,
                               os.path.join(tmp, "ck_fn"))
    out["times"] = timed("step_times", train_step_times, card, device)
    out["seconds"] = seconds
    print("train seconds", json.dumps(seconds), flush=True)
    return out


SYNTH_STEPS = 300  # curriculum steps; scripts/train_detector_v4.py runs 4,000
SYNTH_EVAL_SCENES = 200  # per envelope, seed 778 (the v4 script evaluates 250)
SYNTH_CAL_SCENES = 100  # the v4 script fits on 300
SYNTH_IDS = 9_343  # the shipped synthid9k embedder's classes
SYNTH_RENDER_BUDGET_S = 90.0  # above it the identity set takes 1 train sample an id, not 2
SYNTH_RECALL_TOL = 0.05  # the curriculum's recall against its warm start
SYNTH_SHIPPED_TOL = 0.02  # the shipped v4 detector on the port's scenes against JAX's numbers


def renderer_checks(card: str) -> dict:
    """The port's renderer on this machine's host: the fixture's scenes
    (rendered by the JAX package) within the CPU tests' bounds, nvJPEG's on
    top for the JPEG'd ones; scenes/s of ``scene_batch(64, 128, 2, v4)`` on
    one thread and on four at once; the JPEG step's decode per scene, and
    four threads decoding at once against one after another."""
    import threading

    import numpy as np

    from facerecognition_tpu_torch.data import native_decode
    from facerecognition_tpu_torch.tools import scene_fixture
    from facerecognition_tpu_torch.training import synthetic_faces as sf
    from facerecognition_tpu_torch.utils.imageio import encode_jpeg

    line: dict = {"card": card, "jpeg_backend": native_decode.jpeg_backend()}
    ref, record = scene_fixture.load()
    t0 = time.perf_counter()
    ours, states = scene_fixture.render_port()
    line["fixture_render_s"] = time.perf_counter() - t0
    try:
        line["fixture"] = scene_fixture.compare(ours, states, ref, record, extra_jpeg_abs=NVJPEG_MAX_ABS)
    except AssertionError as err:
        check(False, f"the port's scenes against the JAX fixture: {err}")
    check(line["fixture"]["jpeg_scenes"] >= 1, "no fixture scene took the JPEG step")

    t0 = time.perf_counter()
    imgs = sf.scene_batch(np.random.default_rng(SEED + 30), 64, 128, 2, ranges=sf.RANGES_V4)[0]
    line["scenes_per_s_1_thread"] = 64 / (time.perf_counter() - t0)
    done: dict = {}

    def produce(t):
        done[t] = sf.scene_batch(np.random.default_rng(SEED + 31 + t), 64, 128, 2, ranges=sf.RANGES_V4)

    threads = [threading.Thread(target=produce, args=(t,)) for t in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    line["scenes_per_s_4_threads"] = 4 * 64 / (time.perf_counter() - t0)
    check(len(done) == 4, "a producer thread failed")

    blobs = [encode_jpeg(img.astype(np.uint8), 60) for img in imgs]
    t0 = time.perf_counter()
    one = [native_decode.decode_mem(b) for b in blobs]
    line["jpeg_decode_ms_per_scene"] = (time.perf_counter() - t0) / len(blobs) * 1e3
    t0 = time.perf_counter()
    for img in imgs[:16]:
        encode_jpeg(img.astype(np.uint8), 60)
    line["jpeg_encode_ms_per_scene"] = (time.perf_counter() - t0) / 16 * 1e3
    many: dict = {}

    def decode(t):
        many[t] = [native_decode.decode_mem(b) for b in blobs[t::4]]

    threads = [threading.Thread(target=decode, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for t in range(4):
        for got, want in zip(many[t], one[t::4]):
            check(np.array_equal(got, want), "decoding from four threads at once changed pixels")
    print("synth renderer", json.dumps(line), flush=True)
    return line


def shipped_detector_eval(card: str) -> dict:
    """The shipped ``detector_v4_128`` through the port's
    ``evaluate_detector`` on the fixture's seed, v3 and v4 envelopes:
    recall, mean IoU and false positives an image within
    ``SYNTH_SHIPPED_TOL`` of the JAX package's numbers on JAX's scenes;
    ``detect_post`` once a scene."""
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.tools import scene_fixture
    from facerecognition_tpu_torch.training import synthetic_faces as sf
    from facerecognition_tpu_torch.training.train_detector import evaluate_detector

    _, record = scene_fixture.load()
    ev = record["spec"]["evaluate"]
    det = FaceDetector(weights="assets/detector_v4_128.msgpack")
    check(det.device.type == "cuda", f"detector on {det.device}")
    line: dict = {"card": card, "n_scenes": ev["n_scenes"], "seed": ev["seed"]}
    for r in ev["ranges"]:
        counters = reset_counters()
        got = evaluate_detector(det, n_scenes=ev["n_scenes"], seed=ev["seed"], max_faces=ev["max_faces"],
                                ranges=sf.SCENE_RANGES[r])
        launches = counters["detect_post"].count
        want = record["detector_v4_128"][r]
        check(launches == ev["n_scenes"], f"detect_post launched {launches} times for {ev['n_scenes']} scenes")
        check(got["n_gt"] == want["n_gt"], f"{r}: {got['n_gt']} faces, JAX scenes hold {want['n_gt']}")
        for key in ("recall", "mean_iou", "fp_per_image"):
            check(abs(got[key] - want[key]) <= SYNTH_SHIPPED_TOL,
                  f"shipped v4 detector on {r} scenes: {key} {got[key]} against JAX's {want[key]}")
        line[r] = {"port": got, "jax": want, "detect_post_launches": launches}
    print("synth shipped detector", json.dumps(line), flush=True)
    return line


def curriculum_run(card: str, tmp: str) -> dict:
    """``scripts/train_detector_v4.py`` on the port, its depth cut to
    ``SYNTH_STEPS``: DenseDetNet from ``detector_v3_128`` (calibration and
    arch popped), 128², B 64, ``max_faces`` 2, v4 scenes, lr 7e-4, four
    producer threads. Step ms by CUDA events, the device's busy share (the
    profiler's device time of a step on a fixed batch over the wall time a
    step took in the run), the producers' queue wait a step, the loss
    history; then ``save_variables`` with ``arch``, ``fit_score_calibration``
    and the calibrated checkpoint's recall against the warm start's on the
    same v3 and v4 scenes (seed 778)."""
    import os
    import statistics

    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.detector_net import anchor_centers
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training import synthetic_faces as sf
    from facerecognition_tpu_torch.training import train_detector as td
    from facerecognition_tpu_torch.utils.serialization import load_variables, save_variables

    init = load_variables("assets/detector_v3_128.msgpack")
    init.pop("calibration", None)
    arch = init.pop("arch", b"blaze")
    arch = arch.decode() if isinstance(arch, bytes) else str(arch)
    check(arch == "dense", f"detector_v3_128 is {arch}, not dense")
    cfg = td.CurriculumConfig(input_size=128, batch_size=64, steps=SYNTH_STEPS, lr=7e-4, arch="dense",
                              max_faces=2, ranges="v4", prefetch_threads=4)
    timings: dict = {}
    counters = reset_counters()
    t0 = time.perf_counter()
    variables, history = td.train_detector_curriculum(cfg, log_every=25, init_variables=init,
                                                      timings=timings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(c.count == 0 for c in counters.values()), "a port kernel launched inside the train steps")
    check(all(np.isfinite(h["loss"]) for h in history), f"non-finite curriculum loss {history}")
    step_ms = [a.elapsed_time(b) for a, b in timings["events"]]
    waits = timings["wait_s"]
    line: dict = {"card": card, "steps": SYNTH_STEPS, "steps_full_recipe": 4000, "wall_s": wall,
                  "steps_per_s": SYNTH_STEPS / wall,
                  "step_ms_median": statistics.median(step_ms), "step_ms_p90": float(np.percentile(step_ms, 90)),
                  "queue_wait_ms_mean": float(np.mean(waits)) * 1e3,
                  "queue_wait_ms_median": statistics.median(waits) * 1e3,
                  "loss_history": history}

    # The device's work in one step, on a fixed batch, against the wall
    # time a step took in the run.
    net = td.init_detector_net("dense", 0)
    from facerecognition_tpu_torch.convert import load_flax_variables

    load_flax_variables(net, variables)
    net = net.cuda().train()
    state = td.detector_train_state(net, lambda count: 1e-7)
    step = td.make_detector_train_step(net, torch.as_tensor(anchor_centers(128), device="cuda"))
    imgs, gb, gl, gv = sf.scene_batch(np.random.default_rng(SEED + 32), 64, 128, 2, ranges=sf.RANGES_V4)
    batch = (td.normalize_u8(torch.from_numpy(imgs.astype(np.uint8)).cuda()), torch.from_numpy(gb).cuda(),
             torch.from_numpy(gl).cuda(), torch.from_numpy(gv).cuda())
    line["isolated_step_ms"] = cuda_ms(lambda: step(state, *batch), 10, 3)
    events = profile_kernels(lambda: step(state, *batch), calls=3)
    device_ms = sum(us for _, us in events.values()) / 1e3
    line["device_ms_per_step"] = device_ms
    line["busy_share"] = device_ms / (wall / SYNTH_STEPS * 1e3)
    line["busy_share_isolated"] = device_ms / line["isolated_step_ms"]
    state = step = net = batch = None

    path = os.path.join(tmp, "detector_v4_port.msgpack")
    save_variables(path, {"params": variables["params"], "arch": "dense"})
    det = FaceDetector(weights=path, confidence_threshold=0.3)
    counters = reset_counters()
    a, b = td.fit_score_calibration(det, n_scenes=SYNTH_CAL_SCENES, ranges=sf.SCENE_RANGES["v4"])
    line["calibration"] = {"a": a, "b": b, "detect_post_launches": counters["detect_post"].count}
    check(counters["detect_post"].count == SYNTH_CAL_SCENES, "calibration did not detect once a scene")
    check(np.isfinite(a) and np.isfinite(b), f"calibration ({a}, {b})")
    save_variables(path, {"params": variables["params"], "arch": "dense", "calibration": {"a": a, "b": b}})
    trained = FaceDetector(weights=path, confidence_threshold=0.5)
    start = FaceDetector(weights="assets/detector_v3_128.msgpack", confidence_threshold=0.5)
    line["eval"] = {}
    launches = 0
    for r in ("v3", "v4"):
        kw = dict(n_scenes=SYNTH_EVAL_SCENES, seed=778, ranges=sf.SCENE_RANGES[r])
        counters = reset_counters()
        got = td.evaluate_detector(trained, **kw)
        launches += counters["detect_post"].count
        base = td.evaluate_detector(start, **kw)
        check(got["recall"] >= base["recall"] - SYNTH_RECALL_TOL,
              f"curriculum recall on {r}: {got['recall']} against the warm start's {base['recall']}")
        line["eval"][r] = {"trained": got, "warm_start": base}
    line["eval_detect_post_launches"] = launches
    print("synth curriculum", json.dumps(line), flush=True)
    return line


def synthid_run(card: str, tmp: str) -> dict:
    """``train_synthid`` at full width through ``main()``: 9,343 classes,
    ``stage_sizes`` (1,1,1,1), 512-D, B 128, resident, one epoch, 2 train +
    2 validation samples an id (1 + 2 when the measured render rate puts
    the set over ``SYNTH_RENDER_BUDGET_S``; one validation sample leaves no
    verification pairs). Render seconds, step ms and images/s, the final
    retrieval metrics, ``warp_sample`` (matrix mode) once a step; then the
    checkpoint ``main()`` wrote, in the port's ``RecognitionEngine``, names
    each of 32 enrolled aligned samples top-1."""
    import os

    import numpy as np
    import torch

    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
    from facerecognition_tpu_torch.training import synthetic_faces as sf
    from facerecognition_tpu_torch.training import train_synthid as ts

    line: dict = {"card": card, "n_ids": SYNTH_IDS}
    t0 = time.perf_counter()
    sf.identity_dataset(64, 4, seed=SEED + 40)
    rate = 256 / (time.perf_counter() - t0)
    train_per_id = 2 if SYNTH_IDS * 4 / rate <= SYNTH_RENDER_BUDGET_S else 1
    line.update(samples_per_s_probe=rate, train_per_id=train_per_id, val_per_id=2)
    cache = os.path.join(tmp, "synthid.npz")
    args = ["--n-ids", str(SYNTH_IDS), "--train-per-id", str(train_per_id), "--val-per-id", "2",
            "--batch-size", "128", "--epochs", "1", "--stage-sizes", "1,1,1,1", "--cache", cache,
            "--out", os.path.join(tmp, "synthid.msgpack"), "--report", os.path.join(tmp, "synthid.json")]
    config = ts.SynthIdConfig(n_ids=SYNTH_IDS, train_per_id=train_per_id, val_per_id=2, cache=cache)
    t0 = time.perf_counter()
    ts.load_or_render(config, log=lambda *_: None)
    line["render_s"] = time.perf_counter() - t0
    counters = reset_counters()
    t0 = time.perf_counter()
    variables, history, final = ts.main(args)
    torch.cuda.synchronize()
    line["main_s"] = time.perf_counter() - t0
    steps = SYNTH_IDS * train_per_id // 128
    check(counters["warp_sample"].count == steps,
          f"warp_sample launched {counters['warp_sample'].count} times in {steps} steps")
    check(np.isfinite(history[0]["loss"]), f"synthid history {history}")
    line.update(steps=steps, epoch_s=history[0]["sec"], epoch_ms_per_step=history[0]["sec"] / steps * 1e3,
                loss=history[0]["loss"], train_acc=history[0]["train_acc"],
                final={k: final[k] for k in ("top_1_accuracy", "top_5_accuracy", "auc", "eer")},
                warp_sample_launches=counters["warp_sample"].count)

    # The step alone: CUDA events over resident batches of the same set.
    with np.load(cache) as z:
        imgs, labels = z["imgs"], z["labels"]
    tr_imgs, tr_labels, va_imgs, va_labels = ts.split_train_val(imgs, labels, config)
    model = ts.build_model(config).cuda()
    state = ts.TrainState(model, ts.build_tx(model, config, steps))
    step = ts.make_resident_step(ts.make_step_with_aug(config, steps), tr_imgs.shape[1:])
    data = torch.from_numpy(np.ascontiguousarray(tr_imgs.reshape(len(tr_imgs), -1))).cuda()
    lab = torch.from_numpy(tr_labels.astype(np.int64)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rng = np.random.default_rng(SEED + 41)
    line["step_ms"] = cuda_ms(
        lambda: step(state, data, lab, torch.as_tensor(rng.integers(0, len(tr_imgs), 128), device="cuda"), gen),
        8, 3)
    line["images_per_s"] = 128 / line["step_ms"] * 1e3
    state = model = data = step = None
    torch.cuda.empty_cache()

    embedder = load_arcface_model(os.path.join(tmp, "synthid.msgpack"))
    check(embedder.model.stage_sizes == (1, 1, 1, 1), f"served stage sizes {embedder.model.stage_sizes}")
    engine = RecognitionEngine(embedder, Gallery(512))
    check(engine.device.type == "cuda", f"engine on {engine.device}")
    ids = np.arange(0, SYNTH_IDS, SYNTH_IDS // 32)[:32]
    first = {int(i): int(np.flatnonzero(va_labels == i)[0]) for i in ids}
    for i in ids:
        check(engine.add_to_db(f"id{i}", [va_imgs[first[int(i)]]]), f"enrolling id{i} failed")
    hits = 0
    for i in ids:
        out = engine.recognize(va_imgs[first[int(i)]], k=1)
        hits += out["identity"] == f"id{i}"
    check(hits == len(ids), f"the synthid checkpoint named {hits} of {len(ids)} enrolled samples top-1")
    others = sum(engine.recognize(va_imgs[np.flatnonzero(va_labels == i)[1]], k=1)["identity"] == f"id{i}"
                 for i in ids)
    line["engine"] = {"enrolled": len(ids), "top1_enrolled": hits, "top1_second_sample": int(others)}
    print("synth synthid", json.dumps(line), flush=True)
    return line


def synth_phase(card: str, device) -> dict:
    """The procedural renderer and the two trainers on the card: the
    renderer against the JAX fixture, the shipped v4 detector on the port's
    scenes, the v4 detector curriculum from its warm start, and synthid
    training at full width."""
    import tempfile

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    out = {"renderer": timed("renderer", renderer_checks, card),
           "shipped": timed("shipped_detector", shipped_detector_eval, card)}
    with tempfile.TemporaryDirectory(prefix="synth-") as tmp:
        out["curriculum"] = timed("curriculum", curriculum_run, card, tmp)
        out["synthid"] = timed("synthid", synthid_run, card, tmp)
    out["seconds"] = seconds
    print("synth seconds", json.dumps(seconds), flush=True)
    return out


def phase_child(entry: str, result_path: str, card: str) -> int:
    """``entry`` (``train_phase``, ``synth_phase``) on the card, its result
    written to ``result_path`` as JSON (the body of ``in_child``'s
    process)."""
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    out = globals()[entry](card, torch.device("cuda", 0))
    with open(result_path, "w") as f:
        json.dump(out, f)
    faulthandler.cancel_dump_traceback_later()
    return 0


def in_child(entry: str, card: str) -> dict:
    """A phase in a process of its own, started here and waited for: late
    in this process (after the serving and FaceNet phases) the profiler's
    windows came back without any device event, and the train and synth
    phases time kernels by the profiler. Its lines print to this process's
    output; its counters are set to 0 and read in that process."""
    import os
    import tempfile

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the child trains on the whole card
    with tempfile.TemporaryDirectory(prefix=f"{entry}-child-") as tmp:
        path = os.path.join(tmp, "result.json")
        code = f"import sys, chip_smoke; sys.exit(chip_smoke.phase_child({entry!r}, {path!r}, {card!r}))"
        proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                              timeout=WATCHDOG_S)
        check(proc.returncode == 0, f"the {entry} process exited with {proc.returncode}")
        with open(path) as f:
            return json.load(f)


T_START = time.perf_counter()


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
        for built in _build.build(list(KERNELS)):
            print(f"{built.name}: nvcc {built.seconds:.2f} s -> {built.path}", flush=True)
            for line in built.log.splitlines():
                entry = re.search(r"Compiling entry function '(\w+)'", line)
                if entry:  # the mangled name holds the kernel and its template values
                    print("  " + entry.group(1), flush=True)
                elif "Used" in line or "spill" in line or "error" in line.lower():
                    print("    " + line.strip(), flush=True)

    device = torch.device("cuda", 0)
    with phase("kernels"):
        max_err, main_case = kernel_phase(device)

    with phase("int8"):
        int8_main = int8_phase(device)

    with phase("warp"):
        warp = warp_phase(device)

    with phase("detect_post"):
        detect = detect_phase(device)

    with phase("serving"):
        one_face, stream_profile, stream_call = serving_phase(smi, 1)

    with phase("crowd"):
        crowd, _, _ = serving_phase(smi, CROWD_FACES)

    with phase("serving int8"):
        int8_serving, int8_profile, int8_call = serving_phase(smi, 1, "int8")

    with phase("fused int8 vs stream"):
        from facerecognition_tpu_torch.tools.checkout_compare import alternate_ms

        walls = alternate_ms({"int8": int8_call, "stream": stream_call})
        stream_call = int8_call = None

    with phase("staged"):
        staged = staged_phase(smi)

    with phase("blaze"):
        blaze = blaze_phase(smi)

    with phase("lbph"):
        lbph_main, lbph_big, chi2_main, lbph_launches = lbph_phase(smi, device)

    with phase("facenet"):
        facenet, facenet_profile, _ = serving_phase(smi, 1, model_type="facenet")
        facenet_crowd, _, _ = serving_phase(smi, CROWD_FACES, model_type="facenet")
        facenet_staged = staged_phase(smi, "facenet", ("stream",))

    with phase("enrol"):
        enrol = enrol_phase(smi)

    with phase("apps"):
        apps = apps_phase(smi)

    with phase("train"):
        train = in_child("train_phase", smi)

    with phase("synth"):
        synth = in_child("synth_phase", smi)

    post = detect[(DETECT_CASES[0][0], DETECT_CASES[0][3])]
    kernels = [
        {
            "name": "stream_topk",
            "design": DESIGN,
            "route": "cuda",
            "source": "facerecognition_tpu_torch/csrc/stream_topk.cu",
            "replaces": "facerecognition_tpu/ops/pallas_topk.py:34",
            "launches": crowd["stream_topk"],
            "max_abs_err": max_err,
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        },
        *(
            {
                "name": "warp_sample",
                "design": WARP_DESIGN,
                "case": case,
                "route": "cuda",
                "source": "facerecognition_tpu_torch/csrc/warp_sample.cu",
                "replaces": replaces,
                "launches": launches["warp_sample"],
                "max_abs_err": max(line["max_abs_err"] for line in warp.values()),
                "ms": warp[key]["ms"],
                "plain_ms": warp[key]["plain_ms"],
                "bound_ms": warp[key]["bound_ms"],
                "bound_by": warp[key]["bound_by"],
                "library_ms": warp[key]["library_ms"],
            }
            for key, case, replaces, launches in (
                (("resize", False), "resize B=128 256x256 -> 128x128, fast=False",
                 "facerecognition_tpu/ops/warp_mxu.py:206", crowd),
                (("detector_input", True), "detector_input B=128 256x256 -> 128x128, fast=True",
                 "facerecognition_tpu/ops/warp_mxu.py:206", crowd),
                (("embedder_input", True), "embedder_input align B=128 256x256 -> 112x112, fast=True",
                 "facerecognition_tpu/ops/warp_mxu.py:249", one_face),
                (("embedder_input_window", True),
                 "embedder_input window B=32 x M=4 256x256 -> 112x112, fast=True",
                 "facerecognition_tpu/ops/warp_mxu.py:264", crowd),
                (("embedder_input_160", True), "embedder_input align B=128 256x256 -> 160x160, fast=True",
                 "facerecognition_tpu/ops/warp_mxu.py:249", facenet),
            )
        ),
        {
            "name": "warp_sample",
            "design": WARP_DESIGN + "; matrix mode: each slot's forward map given, inverted in the launch",
            "case": "affine_warp B=128 112x112 uint8, heavy-tier maps, fast=False",
            "route": "cuda",
            "source": "facerecognition_tpu_torch/csrc/warp_sample.cu",
            "replaces": "facerecognition_tpu/ops/warp_mxu.py:57",
            "launches": train["arcface"]["launches"]["warp_sample"],
            "synthid_launches": synth["synthid"]["warp_sample_launches"],
            "max_abs_err": max(line["max_abs_err"] for key, line in train["affine"].items()
                               if "/guard/" not in key),
            "ms": train["affine"]["arcface_u8/heavy/False"]["ms"],
            "device_us": train["affine"]["arcface_u8/heavy/False"]["device_us"],
            "plain_ms": train["affine"]["arcface_u8/heavy/False"]["plain_ms"],
            "bound_ms": train["affine"]["arcface_u8/heavy/False"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "detect_post",
            "design": "one warp per frame: radix-select prefilter, shuffle bitonic sort, greedy NMS in registers",
            "case": f"B={DETECT_CASES[0][0]} M={DETECT_CASES[0][3]}",
            "route": "cuda",
            "source": "facerecognition_tpu_torch/csrc/detect_post.cu",
            "replaces": "facerecognition_tpu/models/detector_net.py:200",
            "launches": crowd["detect_post"],
            "synth_launches": {
                "shipped_eval": sum(synth["shipped"][r]["detect_post_launches"] for r in ("v3", "v4")),
                "calibration": synth["curriculum"]["calibration"]["detect_post_launches"],
                "curriculum_eval": synth["curriculum"]["eval_detect_post_launches"],
            },
            "max_abs_err": max(line["max_abs_err"] for line in detect.values()),
            "ms": post["ms"],
            "plain_ms": post["plain_ms"],
            "bound_ms": post["bound_ms"],
            "bound_by": post["bound_by"],
            "library_ms": None,
        },
        {
            "name": "int8_topk",
            "design": INT8_DESIGN,
            "case": "B={B} N={N} D={D} k={k}".format(**int8_main),
            "route": "cuda",
            "source": "facerecognition_tpu_torch/csrc/int8_topk.cu",
            "replaces": "facerecognition_tpu/ops/matcher.py:232",
            "launches": int8_serving["int8_topk"],
            "max_abs_err": 0.0,
            "ms": int8_main["ms"],
            "float_queries_ms": int8_main["float_queries_ms"],
            "plain_ms": int8_main["plain_ms"],
            "bound_ms": int8_main["bound_ms"],
            "bound_by": int8_main["bound_by"],
            "library_ms": int8_main["library_ms"],
        },
        {
            "name": "lbph_hist",
            "design": "a block per band of cells: pixel rows and halo staged in shared memory, "
                      "codes by XLA's tap plan as fma operands (no branch), int histograms in "
                      "shared memory by atomicAdd, 16-byte writes",
            "case": "B={B} 100x100 r={radius} P={neighbors} grid {grid[0]}x{grid[1]}".format(**lbph_main),
            "route": "cuda",
            "source": "facerecognition_tpu_torch/csrc/lbph_hist.cu",
            "replaces": "facerecognition_tpu/models/lbph.py:101",
            "launches": lbph_launches["lbph_hist"],
            "max_abs_err": 0.0,
            "ms": lbph_main["ms"],
            "device_us": lbph_main["device_us"],
            "ms_B4096": lbph_big["ms"],
            "plain_ms": lbph_main["plain_ms"],
            "bound_ms": lbph_main["bound_ms"],
            "bound_by": lbph_main["bound_by"],
            "library_ms": None,
        },
        {
            "name": "chi2_nn",
            "design": "per-row masks of non-zero bins and sums; a filter over the bins non-zero on "
                      "both sides (128 queries x 64 rows a block, cp.async double buffer, two rows a "
                      "lane sharing one reciprocal) with proven bounds, "
                      "then the rows it cannot rule out rescored exactly in the fixed order, "
                      "skipping empty bins",
            "case": "B={B} N={N} F={F}".format(**chi2_main),
            "route": "cuda",
            "source": "facerecognition_tpu_torch/csrc/chi2_nn.cu",
            "replaces": "facerecognition_tpu/models/lbph.py:115",
            "launches": lbph_launches["chi2_nn"],
            "row_stats_launches": lbph_launches["chi2_row_stats"],
            "max_abs_err": chi2_main["max_abs_err"],
            "max_rel_err": chi2_main["max_rel_err"],
            "ms": chi2_main["ms"],
            "ms_with_overflow_probe": chi2_main["ms_with_overflow_probe"],
            "ms_B1": chi2_main["ms_B1"],
            "return_distances_ms_8x4096": chi2_main["return_distances_ms_8x4096"],
            "candidates_max": chi2_main["candidates"]["max"],
            "plain_ms": chi2_main["plain_ms"],
            "bound_ms": chi2_main["bound_ms"],
            "bound_by": chi2_main["bound_by"],
            "library_ms": chi2_main["library_ms"],
            "library": "chunked PyTorch expression of the distance + torch.min",
        },
    ]
    print("fused int8 vs stream", json.dumps({
        kind: {**{key: profile[key] for key in ("wall_ms", "device_ms", "host_gap_ms",
                                                "launches_per_call", "copies_per_call")},
               "alternating_wall_ms": walls[kind]["ms"], "alternating_rounds_ms": walls[kind]["rounds_ms"]}
        for kind, profile in (("int8", int8_profile), ("stream", stream_profile))}), flush=True)
    print(f"one-face path launches: {json.dumps(one_face)}", flush=True)
    print(f"staged path launches: {json.dumps(staged)}; blaze path: {json.dumps(blaze)}; "
          f"enrolment path: {json.dumps(enrol)}; apps: {json.dumps(apps)}", flush=True)
    print("facenet", json.dumps({
        "launches": {"one_face": facenet, "crowd": facenet_crowd, "staged": facenet_staged},
        "fused_profile": {key: facenet_profile[key] for key in (
            "wall_ms", "device_ms", "host_gap_ms", "launches_per_call", "copies_per_call")},
    }), flush=True)
    print("train", json.dumps({
        "arcface": {k: train["arcface"][k] for k in ("setup_s", "train_s", "launches", "served_faces")},
        "facenet": {k: train["facenet"][k] for k in ("train_s", "launches", "batch_hard", "remat")},
        "parity": train["parity"], "heavy_augment": train["heavy"], "times": train["times"],
    }), flush=True)
    print("synth", json.dumps({
        "renderer": {k: synth["renderer"][k] for k in ("scenes_per_s_1_thread", "scenes_per_s_4_threads",
                                                       "jpeg_decode_ms_per_scene", "fixture")},
        "curriculum": {k: synth["curriculum"][k] for k in ("step_ms_median", "busy_share",
                                                           "queue_wait_ms_mean", "steps_per_s")},
        "synthid": {k: synth["synthid"][k] for k in ("render_s", "step_ms", "images_per_s", "final")},
        "seconds": synth["seconds"],
    }), flush=True)
    print(f"total: {time.perf_counter() - T_START:.1f} s", flush=True)
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

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
    yaml`` over 1,024 x 4 generated 128² PNG faces: 2 epochs x 4 steps,
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
    ``main()`` at ``SYNTH_IDS`` = 1,000 classes, (1,1,1,1), 512-D, B 128, resident, one
    epoch (render seconds, step ms, images/s, retrieval metrics, one
    ``warp_sample`` a step); its checkpoint in a ``RecognitionEngine``
    names 32 enrolled aligned samples top-1.
18. evals: the tools, the CelebA preprocessor and the evaluation drivers
    (``evals_phase``, in a process of its own). ``utils/profiling.trace``
    around one fused call (the trace names ``warp_sample`` and
    ``topk_partial``); ``inspect_checkpoint`` on a shipped msgpack, an
    exported ``.pth`` and a training checkpoint; ``create_label_map``;
    ``visualize_logs``' overfit analysis (no matplotlib here: no plot).
    ``CelebAPreprocessor.run``'s steps on a rendered CelebA-like set (32
    identities, a ninth of the images without landmarks) on the card and on
    the CPU: stats, CSVs and file names equal, aligned pixels within a level,
    augmented within two, ``warp_sample`` launched and in the trace. The
    ArcFace ultraslim and FaceNet msgpacks through ``scripts/export_torch``
    to ``.pth`` and back through the loaders: embeddings within
    ``EVALS_EXPORT_TOL``. The four evaluations at ``tools/eval_fixture.
    SPEC``'s reduced sizes against the JAX package's numbers in
    ``fixtures/evals.json`` (``eval_fixture.compare``: fails the run). Then
    at the records' sizes or below (the int8 and LBPH ones are cut below
    theirs for the script's time; a record is compared at its own size only):
    ``ood_eval`` (200 scenes x 6 families + control at
    256², 100 embedder ids), ``int8_agreement`` (2,000 ids x 2, 1M rows;
    the record's slim checkpoint; top-1 agreement at least
    ``EVALS_INT8_MIN_AGREEMENT`` %), ``lbph_scale_eval`` at 200 ids x (8 +
    2) on ``render_id_folders``, ``compare_all_models`` and
    ``evaluate_model`` on 120 ids x 12 (seed 1, ``stream``), and
    ``facenet_ab_eval`` on its first 500 images (``docs/COMPARISON.md``'s
    seed-1 A/B): each beside its record with the delta, a delta beyond
    ``EVALS_DELTA`` listed as a finding; each path's kernels must launch.

19. parallel: the last API slice and the multi-device layer
    (``parallel_phase``, in a process of its own). The int8 warp mode
    (``fast="int8"``) against its plain version bit for bit at the align
    warp B 128, 256² → 112² and the window B 32 x M 4, timed;
    ``detect_best_face_batch`` and ``align_crop_batch`` against the CPU port;
    MobileFaceNet (512-D, 112², B 128, a seeded init) in evaluation and
    training mode against the CPU port (cosine above 0.999, TF32 off), with
    images/s of the forward and of a training step. A ``ShardedGallery`` of
    1,000,003 x 512 rows cut into 4 shards on the one card, float32 and int8
    (B 128, k 5), against one ``stream_topk`` / ``int8_topk`` over the whole
    gallery (indices and scores equal, planted rows top-1), its call timed
    beside the whole-gallery call's in turns. 2 ranks over gloo sharing the
    card (``parallel.launch.spawn_ranks``): a 100,003-row 4-shard search, 2
    shards a rank on the rank's kernels, equal to the single-process
    result; a data-parallel ArcFace step (global batch norm, mixup pairs
    across ranks) within 2e-3 of each tensor's scale of the one-process
    step. ``train_arcface`` from ``configs/arcface_config.yaml`` on 9,343
    generated identities, 2 steps with ``train.num_devices=auto``, under a
    1-rank NCCL ``torchrun`` and without a group: the losses within 1e-3,
    the checkpoints within 2e-3 of scale. The ArcFace step of phase 16 in a
    1-rank NCCL group in the phase's process, data-parallel and one-card,
    timed in turns.
20. dtype: the models' compute dtype (``dtype_phase``, in a process of its
    own). ``warp_sample``'s float32, bf16 and float16 model inputs
    (``detector_input`` B 128 256² → 128², ``embedder_input`` one face B 128
    → 112² and 160², the window B 32 x M 4 → 112²; fast on) against the
    plain version on the card bit for bit, one kernel per call, timed. The
    shipped v4 detector and ultraslim ArcFace, both bf16, serving 16 frames
    rendered by the port's ``training/synthetic_faces`` through
    ``MicroBatcher`` (one face and M = 4, ``stream`` and ``int8``; a
    100k-row gallery with each face's own embedding planted: every top-1 is
    its row); the same frames through the CPU port's bf16 plain path and
    the card's float32 engine: the embeddings' min and mean cosine (faces
    paired by box). FaceNet bf16 one face the same way. ``detect_all`` and
    ``recognize`` in bf16 against the CPU. One fused call at B = 128: no
    cast of a model input in the bf16 call (profiler shapes), bf16 against
    float32 profiled and timed in alternating turns.
21. measure: the measurement and robustness tools (``measure_phase``, in a
    process of its own), through their functions at the JAX scripts'
    default sizes. ``profile_pipeline`` at B 256 with ``--extra`` (10k-row
    gallery): every stage's ms per batch, then each stage's CPU plain path
    on the first ``MEASURE_CHECK_ROWS`` rows of the card's own inputs (the
    resize within 0.5 level, the align within 1.5 and a mean under 0.01,
    the detector within 1e-3 of scale, the post-process's validity equal and
    boxes within 1e-3 px, embeddings' cosine at least ``MEASURE_EMBED_COS``,
    the matches' indices equal); ``bench_embed`` of (3,4,6,3) and (2,2,2,2)
    at B 256 (cosine against the CPU); ``serving_bench`` with 32 clients x
    256 requests of a 256² scene (no failure; the answer against the CPU
    port's engine); ``realtime_bench`` at 64 frames of 720p (the first 4
    frames' top-1 rows against the CPU's chain) and ``--mjpeg`` at 64
    frames; ``detector_robustness`` on a rendered 900² face scene (the
    detected flags equal the CPU port's, IoU within ``MEASURE_IOU_TOL``).
    Every JSON line has the JAX script's keys and positive times;
    ``warp_sample``, ``detect_post`` and ``stream_topk`` must launch on their
    paths.
22. bench: the end-to-end benches (``bench_phase``, in a process of its
    own), each through its ``main``. ``bench`` at its defaults (B 256, 16
    batches a run, a 10k-row gallery, 160², ``--warp bf16``), at
    ``--max-faces 4`` on B 64 frames of 256² (the window path), and at B 64,
    2 batches a run, with ``--warp int8``, ``--warp f32``, each ``--ablate``
    and ``--noise``; then ``bench_gallery`` at 250,000 rows, 2 batches a run,
    all three paths (its two parity checks run inside it). Every line
    parses with the JAX script's keys; each run's launches equal what its
    mode implies (``bench_launches_expected``: two ``warp_sample`` calls and,
    at M > 1, one ``detect_post`` a batch; no ``stream_topk`` at 10k rows,
    where ``auto`` matches densely; one ``stream_topk`` and one
    ``int8_topk`` call a batch in ``bench_gallery``); each run's first
    ``BENCH_CHECK_FRAMES`` frames through its batch on the card against the
    CPU port (detector scores within ``BENCH_DET_TOL``, top-5 scores within
    ``BENCH_SCORE_TOL``, indices equal where the CPU's gap to a
    neighbouring score exceeds it) and its ``mean_det_score`` within
    ``BENCH_MEAN_DET_TOL`` of the CPU's. The default and crowd runs also
    check their whole batch (``bench_full_batch``): the detector scores
    against the CPU port's within ``BENCH_DET_TOL``, and the align's output
    (``warp_sample`` at the bench's shapes) against the CPU's plain warp
    from the card's landmarks within ``BENCH_ALIGN_LEVELS``.

Phases 7-22 are the paths: every kernel counter is set to 0 just before
each and read just after, and each kernel of the path must have launched;
after each serving phase, one fused call at B = 128 is profiled
(``fused_profile``: device µs per kernel, launches per call, host time the
device does not cover). It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Any failed check raises and the exit code
is not 0; without a CUDA card it exits 2 before printing any result. A
watchdog ends the run, with a stack dump, after ``MAIN_WATCHDOG_S`` (each
child process after ``WATCHDOG_S``).
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
from typing import Optional

WATCHDOG_S = 900  # a child phase's process
MAIN_WATCHDOG_S = 1150  # the whole run, under the 1200 s the script has
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
#: The 16-bit parity step (``half_parity_step``) starts ArcFace from this
#: many float32 steps on the card: at random init a ResNet50's bf16
#: gradients over 16 samples are 0.9-2.2 of their tensors' scale off float64
#: on the CPU itself, and a gate at 4x such an error passes a zero gradient;
#: after 100 or 200 steps the worst tensor's was 0.063 or 0.069 (RMS, on an
#: H100's host).
PARITY_WARMUP = 100
PARITY_FACES = (16, 4)  # rendered identities x samples the warm-up and the 16-bit step read
PARITY_OWN_MAX = 0.25  # the CPU's own 16-bit error of every gated tensor, of its RMS
TRAIN_DTYPE_LOSS_REL = 2e-3  # the card's 16-bit loss against the CPU's, relative
#: Steps, batch, classes, fixed batches and peak lr of the bf16-against-float32
#: runs: at lr 0.1 or two batches the loss still falls steeply at step 30, at
#: 1.0 it jumps before it falls.
TRAIN_DTYPE_RUN = (30, 64, 100, 1, 0.3)
TRAIN_DTYPE_FINAL_REL = 0.10  # the bf16 run's final loss against the float32 run's
TRAIN_IDENTITIES, TRAIN_SAMPLES, TRAIN_SIDE = 1_024, 4, 128
TRAIN_ARC_STEPS, TRAIN_FN_STEPS = 4, 2  # cut from 8, 4 for the script's time
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


def rms_rel(a, b, unit: float) -> float:
    """RMS(a - b) / max(RMS(b), unit): ``unit`` is 1e-3 of the largest RMS
    of the tensors of a kind, for a tensor whose true value is about 0."""
    return (a - b).pow(2).mean().sqrt().item() / max(b.pow(2).mean().sqrt().item(), unit)


def half_parity_step(kind: str, device) -> dict:
    """One train step in bf16 on the card and on the CPU, and the float32
    model in float64 on the CPU (the truth), from one trained start on a
    fixed batch of rendered faces (``PARITY_FACES``; augmentation none,
    dropout 0): ArcFace (ResNet50, B 16 = 8 identities x 2, 112², SGD with
    momentum, weight decay, clip and a warmup) from ``PARITY_WARMUP``
    float32 SGD steps on the card under ``deterministic_algorithms``, or
    FaceNet (P 4 x K 2, 160², semi_hard, adam) from the shipped weights.
    The CPU's plain path computes XLA's 16-bit graph; cuDNN on the card
    rounds once more (each convolution's output). Errors per tensor by
    ``rms_rel``; "gated" tensors: the gradients, the BN statistics and the
    SGD run's updated parameters (adam's first update is about lr·sign(g):
    printed only). Gates: the loss is not 0; the CPU's own error of every
    gated tensor below ``PARITY_OWN_MAX`` (else a zero tensor would pass the
    next gates); pooled over the gated tensors (the RMS of their errors)
    the card's error at most 2x the CPU's own; ArcFace: each gated tensor's
    card error at most 4x the CPU's own, or 1e-3, and the loss within
    ``TRAIN_DTYPE_LOSS_REL`` of the CPU's. FaceNet's semi-hard loss sums a
    few triplets that the card's extra roundings move (2.9% from the CPU's,
    a few tensors 5x the CPU's own error on an H100): its loss against
    float64 within 4x the CPU's own, and no per-tensor gate."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.inference.extract_embeddings import load_facenet_checkpoint
    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.facenet import FaceNetModel
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training import synthetic_faces as sf
    from facerecognition_tpu_torch.training.optim import OptaxChain
    from facerecognition_tpu_torch.training.schedules import build_schedule
    from facerecognition_tpu_torch.training.train_arcface import normalize_u8

    dtype = "bfloat16"
    ids, per = PARITY_FACES
    side = 112 if kind == "arcface" else 160
    faces, face_ids = sf.identity_dataset(ids, per, side, seed=SEED + 60 + (kind == "facenet"))
    images, labels = normalize_u8(torch.as_tensor(faces)), torch.as_tensor(face_ids).long()
    t0 = time.perf_counter()
    warm = None
    if kind == "arcface":
        build = lambda dt: ArcFaceModel(512, num_classes=ids, margin=0.2, easy_margin=True,  # noqa: E731
                                        dropout=0.0, dtype=dt)
        step = steps.make_arcface_train_step(label_smoothing=0.1)
        tx = lambda m: OptaxChain(dict(m.named_parameters()), "sgd",  # noqa: E731
                                  build_schedule(0.1, "cosine", 100, 10), momentum=0.9,
                                  weight_decay=5e-4, grad_clip=1.0)
        model = init_like_flax(build("float32"), torch.Generator().manual_seed(SEED + 12), ("fc",)).to(device)
        state = steps.TrainState(model, OptaxChain(dict(model.named_parameters()), "sgd", lambda c: 0.1,
                                                   momentum=0.9, grad_clip=5.0))
        with deterministic_algorithms():  # each step: every identity once
            warm = [step(state, images[j::per].to(device), labels[j::per].to(device))["loss"]
                    for j in (n % per for n in range(PARITY_WARMUP))]
        warm = [warm[0].item(), warm[-1].item()]
        start = {n: t.cpu() for n, t in model.state_dict().items()}
        pick = torch.cat([torch.arange(i * per, i * per + 2) for i in range(PARITY_ARC_B // 2)])
    else:
        build = lambda dt: FaceNetModel(512, dropout=0.0, dtype=dt)  # noqa: E731
        step = steps.make_facenet_train_step(0.5, "semi_hard")
        tx = lambda m: OptaxChain(dict(m.named_parameters()), "adam",  # noqa: E731
                                  build_schedule(3e-4, "step", 100, step_size=10, gamma=0.5))
        start = load_facenet_checkpoint("assets/" + FACENET_WEIGHTS).state_dict()
        pick = torch.cat([torch.arange(i * per, i * per + 2) for i in range(PARITY_FN_PK[0])])
    start_s = time.perf_counter() - t0
    results = {}
    cpu = torch.device("cpu")
    x, y = images[pick], labels[pick]
    for name, dev, dt in (("card", device, dtype), ("cpu", cpu, dtype), ("cpu64", cpu, "float64")):
        wide = torch.float64 if dt == "float64" else torch.float32
        m = build("float32" if dt == "float64" else dt)
        m.load_state_dict(start)
        m = m.to(dev, wide)
        state = steps.TrainState(m, tx(m))
        grads, metrics = step.gradients(state, x.to(dev, wide), y.to(dev))
        check({g.dtype for g in grads.values()} == {wide}, f"{kind} {dt}: gradients in "
              f"{sorted({str(g.dtype) for g in grads.values()})}")
        steps.apply_gradients(state, grads)
        results[name] = {
            "loss": metrics["loss"].item(),
            "grads": {n: g.detach().cpu().double() for n, g in grads.items()},
            "state": {n: t.detach().cpu().double() for n, t in m.state_dict().items() if t.is_floating_point()},
        }

    def errors(got, want):
        unit = 1e-3 * max(t.pow(2).mean().sqrt().item() for t in want.values())
        return {n: rms_rel(got[n], t, unit) for n, t in want.items()}

    def split(r):
        return {"grads": r["grads"],
                "stats": {n: t for n, t in r["state"].items() if "running_" in n},
                "params": {n: t for n, t in r["state"].items() if "running_" not in n}}

    card, cpu_r, truth = (split(results[n]) for n in ("card", "cpu", "cpu64"))
    loss = {n: results[n]["loss"] for n in results}
    line = {"kind": kind, "dtype": dtype, "batch": len(pick), "side": side,
            "start": f"{PARITY_WARMUP} float32 steps" if kind == "arcface" else FACENET_WEIGHTS,
            "warmup_loss_first_last": warm, "start_s": start_s, "loss_card": loss["card"],
            "loss_cpu": loss["cpu"], "loss_cpu64": loss["cpu64"],
            "loss_rel": abs(loss["card"] - loss["cpu"]) / max(abs(loss["cpu"]), 1e-30),
            "loss_card_vs_cpu64": abs(loss["card"] - loss["cpu64"]) / max(abs(loss["cpu64"]), 1e-30),
            "loss_cpu_vs_cpu64": abs(loss["cpu"] - loss["cpu64"]) / max(abs(loss["cpu64"]), 1e-30),
            "tensors": len(truth["grads"])}
    gates = [(loss["cpu64"] > 0, f"{kind}: the step's loss is 0, no gradient to compare")]
    if kind == "arcface":
        gates.append((line["loss_rel"] <= TRAIN_DTYPE_LOSS_REL,
                      f"{kind}: card loss {loss['card']} vs CPU {loss['cpu']} (float64 {loss['cpu64']})"))
    else:
        gates.append((line["loss_card_vs_cpu64"] <= 4 * line["loss_cpu_vs_cpu64"],
                      f"{kind}: card loss {loss['card']}, CPU {loss['cpu']}, float64 {loss['cpu64']}"))
    per_tensor = {}
    for what in ("grads", "stats", "params"):
        own = errors(cpu_r[what], truth[what])
        vs_truth = errors(card[what], truth[what])
        per_tensor[what] = {n: [float(f"{own[n]:.3g}"), float(f"{vs_truth[n]:.3g}")] for n in own}
        over = lambda n: vs_truth[n] / max(1e-3, 4 * own[n])  # noqa: E731
        worst, ill = max(own, key=over), max(own, key=own.get)
        pooled = [float(np.sqrt(np.mean([e[n] ** 2 for n in own]))) for e in (own, vs_truth)]
        line[what] = {"cpu_vs_cpu64_max": own[ill], "card_vs_cpu64_max": max(vs_truth.values()),
                      "pooled_cpu_card": pooled, "over_4x": sum(over(n) > 1 for n in own),
                      "worst": [worst, vs_truth[worst], own[worst]]}
        if what != "params" or kind == "arcface":
            gates.append((own[ill] < PARITY_OWN_MAX, f"{kind}: the CPU's own error of {what} {ill} is "
                          f"{own[ill]} of its scale, so a zero tensor would pass"))
            gates.append((pooled[1] <= 2 * pooled[0], f"{kind}: {what} pooled card error {pooled[1]} "
                          f"against the CPU's {pooled[0]}"))
            if kind == "arcface":
                gates.append((line[what]["over_4x"] == 0, f"{kind}: {what} {worst} off by "
                              f"{vs_truth[worst]} (the CPU's own error {own[worst]})"))
    print("train parity", json.dumps(line), flush=True)
    print("train parity per tensor [CPU vs float64, card vs float64]",
          json.dumps({"kind": kind, "dtype": dtype, **per_tensor}), flush=True)
    for ok, what in gates:
        check(ok, what)
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


def write_train_faces(root: str, device, n: int = TRAIN_IDENTITIES, k: int = TRAIN_SAMPLES,
                      side: int = TRAIN_SIDE) -> float:
    """``n`` x ``k`` RGB PNG faces of ``side``², a person per folder (by
    default ``TRAIN_IDENTITIES`` x ``TRAIN_SAMPLES`` at ``TRAIN_SIDE``²):
    each identity a blocky colour pattern of its own, each sample it shifted
    and with noise. Made on the card in bulk, written by 8 threads. Returns
    the seconds."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from facerecognition_tpu_torch.utils.imageio import save_png

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
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


def resident_step(kind: str, device, dtype: str = "float32"):
    """``train_step_times``' step on data resident on the card, the model
    computing in ``dtype``: ``(one, batch, side, tier)``, ``one()`` taking
    the next of eight fixed batches. ArcFace: B 128, 112², ``TRAIN_CLASSES``
    classes, heavy augmentation (``warp_sample``'s matrix mode); FaceNet: P
    8 x K 4, 160², light. The same seeds for every dtype."""
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

    rng = np.random.default_rng(SEED + 16 + (kind == "facenet"))
    gen = torch.Generator().manual_seed(SEED + 16)
    b, s, tier = (128, 112, "heavy") if kind == "arcface" else (32, 160, "light")
    if kind == "arcface":
        model = init_like_flax(ArcFaceModel(512, num_classes=TRAIN_CLASSES, margin=0.2,
                                            easy_margin=True, dtype=dtype), gen, ("fc",)).to(device)
        raw = steps.make_arcface_train_step(0.1)
        tx = OptaxChain(dict(model.named_parameters()), "sgd", build_schedule(0.01, "cosine", 1000, 20),
                        weight_decay=5e-4, grad_clip=5.0)
        labels_all = torch.as_tensor(rng.integers(0, TRAIN_CLASSES, TRAIN_RESIDENT), device=device)
    else:
        model = init_like_flax(FaceNetModel(512, dtype=dtype), gen).to(device)
        raw = steps.make_facenet_train_step(0.5, "semi_hard")
        tx = OptaxChain(dict(model.named_parameters()), "adam", build_schedule(3e-4, "step", 1000))
        labels_all = torch.arange(TRAIN_RESIDENT // 4, device=device).repeat_interleave(4)
    state = steps.TrainState(model, tx)
    data, _ = warp_inputs(rng, s, TRAIN_RESIDENT, 1, device)
    data = data.reshape(TRAIN_RESIDENT, -1)

    def with_aug(st, images_u8, labels, g):
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

    return one, b, s, tier


def train_step_times(card: str, device) -> dict:
    """The ArcFace step at B 128, 112², ``TRAIN_CLASSES`` classes, heavy
    augmentation, on data resident on the card (``resident_step``): ms a
    step by CUDA events, images/s, the warp's share of the step's device
    time (profiler); the FaceNet step at P 8 x K 4, 160² (light)."""
    import numpy as np
    import torch

    out = {"card": card}
    for kind in ("arcface", "facenet"):
        one, b, s, tier = resident_step(kind, device)
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
        one = None
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


SYNTH_STEPS = 30  # curriculum steps (cut from 300, then 100, for the script's time); the script runs 4,000
SYNTH_EVAL_SCENES = 200  # per envelope, seed 778 (the v4 script evaluates 250)
SYNTH_CAL_SCENES = 100  # the v4 script fits on 300
SYNTH_IDS = 1_000  # classes (cut from 9,343, the shipped synthid9k embedder's, for the script's time)
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


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms (``cudnn.deterministic``, no
    benchmark) and ``use_deterministic_algorithms`` inside, all restored
    after. An operation without a deterministic kernel warns instead of
    raising; the messages are collected in the list this yields. cuBLAS's
    determinism also needs ``CUBLAS_WORKSPACE_CONFIG`` in the process's
    environment before its first cuBLAS call (``in_child``'s ``env``)."""
    import warnings

    import torch

    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    messages: list = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield messages
        messages.extend(sorted({str(w.message).splitlines()[0] for w in caught}))
    finally:
        cudnn.deterministic, cudnn.benchmark = before[0], before[1]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])


#: The environment of a phase that runs ``deterministic_algorithms`` (the
#: synth phase's curriculum, the 16-bit parity's warm-up): cuBLAS's
#: deterministic workspace.
DETERMINISTIC_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}


def curriculum_run(card: str, tmp: str) -> dict:
    """``scripts/train_detector_v4.py`` on the port, its depth cut to
    ``SYNTH_STEPS``: DenseDetNet from ``detector_v3_128`` (calibration and
    arch popped), 128², B 64, ``max_faces`` 2, v4 scenes, lr 7e-4, four
    producer threads, under ``deterministic_algorithms`` (cuDNN's fastest
    algorithms sum the backward in an order that changes from run to run,
    which moved the gate's recall by a face or two).
    Step ms by CUDA events, the device's busy share (the profiler's device
    time of a step on a fixed batch over the wall time a step took in the
    run), the producers' queue wait a step, the loss history; then
    ``save_variables`` with ``arch``, ``fit_score_calibration`` and the
    calibrated checkpoint's recall against the warm start's on the same v3
    and v4 scenes (seed 778)."""
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
    with deterministic_algorithms() as nondeterministic:
        variables, history = td.train_detector_curriculum(cfg, log_every=25, init_variables=init,
                                                          timings=timings)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(c.count == 0 for c in counters.values()), "a port kernel launched inside the train steps")
    check(all(np.isfinite(h["loss"]) for h in history), f"non-finite curriculum loss {history}")
    step_ms = [a.elapsed_time(b) for a, b in timings["events"]]
    waits = timings["wait_s"]
    line: dict = {"card": card, "steps": SYNTH_STEPS, "steps_full_recipe": 4000, "wall_s": wall,
                  "nondeterministic_ops": nondeterministic,
                  "cublas_workspace_config": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
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
    """``train_synthid`` at full width through ``main()``: ``SYNTH_IDS`` classes,
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


EVALS_INT8_IDS = 2_000  # identities (cut from 9,343, the record's, for the script's time)
EVALS_INT8_RECORD_IDS = 9_343  # docs/INT8_AGREEMENT.json's: its numbers are compared at that size only
EVALS_INT8_ROWS = 1_000_000  # its --extend-to
EVALS_INT8_MIN_AGREEMENT = 99.9  # % of probes whose top-1 stream_topk and int8_topk agree on
EVALS_LBPH_IDS = 200  # cut from 1,000, the script's default and the record's size, for the script's time
EVALS_LBPH_RECORD_TOP1 = 0.165  # JAX at 1,000 ids (docs/COMPARISON.md, "LBPH at reference scale")
EVALS_COMPARE = (120, 12, 160, 1)  # ids, renders, side, seed: docs/COMPARISON.md's set (seed 1 its A/B's)
EVALS_OOD = (200, 100, 256)  # scenes a row (5 families + control), embedder ids, side (the records)
EVALS_FACENET_AB = (500, 98.4)  # probes, top-1 %: docs/COMPARISON.md's A/B of the shipped FaceNet, seed 1
EVALS_DELTA = {"recall": 0.02, "top1_pp": 1.0, "lbph_pp": 2.0}  # a larger delta is written down
EVALS_EXPORT_TOL = 1e-5  # embeddings from the exported .pth against the msgpack's (the same weights)
EVALS_CELEBA_IDS = 32


def evals_tools(card: str, tmp: str) -> dict:
    """The host tools on the card machine: ``utils/profiling.trace`` around
    one fused engine call (a non-empty trace that names the port's
    kernels), ``inspect_checkpoint`` on a shipped msgpack, an exported
    ``.pth`` and a training checkpoint, ``create_label_map`` and
    ``visualize_logs`` (no plot: matplotlib is not on this machine)."""
    import os

    import numpy as np
    import torch

    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.scripts import create_label_map, export_torch, inspect_checkpoint
    from facerecognition_tpu_torch.scripts import visualize_logs
    from facerecognition_tpu_torch.training.checkpoint import CheckpointManager
    from facerecognition_tpu_torch.utils import profiling

    line: dict = {"card": card}
    engine = RecognitionEngine(detector=FaceDetector(), checkpoint_path="assets/arcface_synthid9k_ultraslim_512.msgpack",
                               match_kernel="stream")
    rows = np.random.default_rng(SEED).standard_normal((64, 512)).astype(np.float32)
    engine.gallery.add_many([f"id{i}" for i in range(64)], rows)
    frames = smooth_frames(np.random.default_rng(SEED + 1), 8, 256)
    engine.fused_recognize_frames(frames)  # warm
    trace_dir = os.path.join(tmp, "trace")
    with profiling.trace(trace_dir):
        engine.fused_recognize_frames(frames)
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        text = f.read()
    names = [k for k in ("warp_sample", "topk_partial", "split_queries", "topk_merge") if k in text]
    check(len(text) > 1000 and "warp_sample" in names and "topk_partial" in names,
          f"the trace ({len(text)} bytes) names {names}")
    line["trace"] = {"bytes": len(text), "kernels_named": names}

    shipped = inspect_checkpoint.inspect("assets/detector_v4_128.msgpack")
    pth = os.path.join(tmp, "arcface.pth")
    export_torch.main(["--model", "arcface", "--ckpt", "assets/arcface_synthid9k_ultraslim_512.msgpack",
                       "--out", pth])
    exported = inspect_checkpoint.inspect(pth)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
    mgr.save("last", {"model": engine.embedder.model.state_dict(), "step": 3}, {"epoch": 1})
    trained = inspect_checkpoint.inspect(os.path.join(tmp, "ckpt", "ckpt_last"))
    n_model = sum(p.numel() for p in engine.embedder.model.parameters())
    n_buffers = sum(b.numel() for n, b in engine.embedder.model.named_buffers() if b.ndim)
    check(trained["n_params"] == n_model + n_buffers and exported["n_params"] == n_model + n_buffers
          and shipped["n_params"] > 0,
          f"inspect_checkpoint counts {shipped['n_params']} / {exported['n_params']} / {trained['n_params']}")
    line["inspect"] = {"shipped": shipped["n_params"], "pth": exported["n_params"],
                       "training_checkpoint": trained["n_params"]}

    import pandas as pd

    csv = os.path.join(tmp, "map.csv")
    pd.DataFrame({"identity_id": ["a", "b"], "label": [0, 1]}).to_csv(csv, index=False)
    check(create_label_map.create_label_map(csv, output_path=os.path.join(tmp, "lm.npy")) == {0: "a", 1: "b"},
          "create_label_map from a CSV")
    hist = [{"epoch": i, "train_loss": 1.0 - i * 0.05, "ver_acc": 0.5 + (i if i < 10 else 20 - i) * 0.02}
            for i in range(20)]
    with open(os.path.join(tmp, "h.json"), "w") as f:
        json.dump(hist, f)
    overfit = visualize_logs.analyze_overfit(visualize_logs.merge_histories([os.path.join(tmp, "h.json")]))
    check(overfit["overfitting"] is True and overfit["best_epoch"] == 10, f"analyze_overfit gave {overfit}")
    line["visualize_logs"] = "overfit analysis only: no matplotlib on this machine, plot_history skipped"
    del engine
    torch.cuda.empty_cache()
    print("evals tools", json.dumps(line), flush=True)
    return line


def celeba_metadata(root: str) -> None:
    """A CelebA-like set: ``EVALS_CELEBA_IDS`` identities of 3-8 one-face
    scenes (JPEG, 160² or 192², so a batch is padded), the landmarks CSV
    missing every ninth image."""
    import os

    import numpy as np

    from facerecognition_tpu_torch.training.synthetic_faces import render_scene
    from facerecognition_tpu_torch.utils.imageio import encode_jpeg

    rng = np.random.default_rng(SEED + 60)
    img_dir = os.path.join(root, "img_align_celeba")
    os.makedirs(img_dir)
    idents, rows = [], []
    for pid in range(EVALS_CELEBA_IDS):
        for i in range(3 + pid % 6):
            name = f"{pid:03d}{i:03d}.jpg"
            img, _, lms, _ = render_scene(rng, 160 + 32 * (i % 2), 1, 1.0)
            with open(os.path.join(img_dir, name), "wb") as f:
                f.write(encode_jpeg(img, quality=90))
            idents.append(f"{name} {pid + 1}")
            if len(idents) % 9:
                rows.append(",".join([name] + [f"{v:.0f}" for v in lms[0].reshape(-1)]))
    with open(os.path.join(root, "identity_CelebA.txt"), "w") as f:
        f.write("\n".join(idents) + "\n")
    from facerecognition_tpu_torch.preprocessing.celeba import LANDMARK_COLUMNS

    with open(os.path.join(root, "list_landmarks_align_celeba.csv"), "w") as f:
        f.write(",".join(("image_id",) + LANDMARK_COLUMNS) + "\n" + "\n".join(rows) + "\n")


def evals_celeba(card: str, tmp: str) -> dict:
    """``CelebAPreprocessor`` on the card against the same run on the CPU:
    kept identities, split membership, file names and CSVs equal; aligned
    pixels within a level and augmented within two (``warp_sample`` within
    1e-3 of its plain version, then truncated to uint8); ``warp_sample``
    launched and named in the trace; the written JPEGs' largest pixel
    difference reported."""
    import os

    import numpy as np
    import pandas as pd

    from facerecognition_tpu_torch.data.native_decode import decode_file
    from facerecognition_tpu_torch.preprocessing.celeba import CelebAConfig, CelebAPreprocessor
    from facerecognition_tpu_torch.utils import profiling

    data = os.path.join(tmp, "celeba")
    celeba_metadata(data)
    runs, line = {}, {"card": card}
    for dev in ("cuda", "cpu"):
        config = CelebAConfig(data_dir=data, output_dir=os.path.join(tmp, f"out_{dev}"), min_images=5,
                              target_min_images=8, batch_size=32)
        pre = CelebAPreprocessor(config, device=dev)
        pre.load_metadata()
        pre.analyze_and_filter()
        counters = reset_counters()
        t0 = time.perf_counter()
        if dev == "cuda":
            trace_dir = os.path.join(tmp, "celeba_trace")
            with profiling.trace(trace_dir):
                aligned = pre.align_all()
            with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
                check("warp_sample" in f.read(), "the alignment's trace names no warp_sample kernel")
        else:
            aligned = pre.align_all()
        snapshot = {p: [a.copy() for a in v] for p, v in aligned.items()}
        augmented = pre.augment_to_target(aligned)
        pre.split_and_write(augmented)
        runs[dev] = {"aligned": snapshot, "augmented": augmented, "stats": pre.stats, "config": config,
                     "warp_launches": counters["warp_sample"].count, "s": time.perf_counter() - t0}
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    check(card_run["warp_launches"] > 0, "CelebAPreprocessor launched no warp_sample on the card")
    check(card_run["stats"] == cpu_run["stats"], f"stats {card_run['stats']} != {cpu_run['stats']}")
    worst = {"aligned": 0, "augmented": 0}
    for key in worst:
        for pid, imgs in card_run[key].items():
            check(len(imgs) == len(cpu_run[key][pid]), f"{key} {pid}: {len(imgs)} images")
            for a, b in zip(imgs, cpu_run[key][pid]):
                worst[key] = max(worst[key], int(np.abs(a.astype(int) - b).max()))
    # aligned: the kernel within 1e-3 of its plain version, truncated to
    # uint8; augmented: from those sources, contrast up to 1.2x
    check(worst["aligned"] <= 1 and worst["augmented"] <= 2, f"card against CPU, levels: {worst}")
    jpeg_worst = 0
    for split in ("train", "val", "test"):
        frames = [pd.read_csv(os.path.join(r["config"].output_dir, "metadata", f"{split}_labels.csv"))
                  for r in (card_run, cpu_run)]
        rel = [[os.path.relpath(p, r["config"].output_dir) for p in f["image_path"]]
               for f, r in zip(frames, (card_run, cpu_run))]
        check(rel[0] == rel[1] and frames[0]["label"].tolist() == frames[1]["label"].tolist(),
              f"{split}_labels.csv differs between the card and the CPU")
        for p in rel[0]:
            a, b = (decode_file(os.path.join(r["config"].output_dir, p)) for r in (card_run, cpu_run))
            jpeg_worst = max(jpeg_worst, int(np.abs(a.astype(int) - b).max()))
    line.update({"stats": card_run["stats"], "max_abs_levels": worst, "jpeg_max_abs": jpeg_worst,
                 "warp_sample_launches": card_run["warp_launches"], "card_s": card_run["s"],
                 "cpu_s": cpu_run["s"]})
    print("evals celeba", json.dumps(line), flush=True)
    return line


def evals_export(card: str, tmp: str) -> dict:
    """The serving msgpack → a reference ``.pth`` (``scripts/export_torch``)
    → the port's loader: ArcFace ultraslim and FaceNet (``--prefix
    model.``), embeddings on the card within ``EVALS_EXPORT_TOL``."""
    import os

    import numpy as np

    from facerecognition_tpu_torch.inference import extract_embeddings as ee
    from facerecognition_tpu_torch.scripts import export_torch

    line: dict = {"card": card}
    faces = smooth_frames(np.random.default_rng(SEED + 70), 16, 160).astype(np.float32)
    for model, ckpt, load in (("arcface", "assets/arcface_synthid9k_ultraslim_512.msgpack", ee.load_arcface_model),
                              ("facenet", "assets/" + FACENET_WEIGHTS, ee.load_facenet_model)):
        pth = os.path.join(tmp, f"{model}.pth")
        export_torch.main(["--model", model, "--ckpt", ckpt, "--out", pth, "--prefix", "model."])
        a, b = (load(p).embed_uint8(faces) for p in (ckpt, pth))
        err = float(np.abs(a - b).max())
        check(err <= EVALS_EXPORT_TOL, f"{model}: the exported .pth's embeddings are {err} off")
        line[model] = {"max_abs_err": err, "pth_mb": os.path.getsize(pth) / 1e6}
        os.remove(pth)
    print("evals export", json.dumps(line), flush=True)
    return line


def _record(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def evals_full(card: str, tmp: str) -> dict:
    """The four evaluations at the records' sizes, each path's launches
    read, the accuracy beside the record's value with the delta; a delta
    beyond ``EVALS_DELTA`` is listed in ``findings`` (the gate is the
    reduced-size fixture)."""
    import os

    import numpy as np

    from facerecognition_tpu_torch.examples import compare_all_models, evaluate_model
    from facerecognition_tpu_torch.scripts.facenet_ab_eval import facenet_ab
    from facerecognition_tpu_torch.scripts.int8_agreement import (
        distractor_draws,
        int8_report,
        render_and_embed,
    )
    from facerecognition_tpu_torch.scripts.lbph_scale_eval import lbph_scale_report
    from facerecognition_tpu_torch.scripts.ood_eval import ood_report
    from facerecognition_tpu_torch.scripts.render_id_folders import render_id_folders
    from facerecognition_tpu_torch.training.ood_faces import OOD_FAMILIES

    out: dict = {"card": card, "seconds": {}, "launches": {}, "findings": []}
    quiet = lambda *_: None  # noqa: E731

    def run(name, fn):
        counters = reset_counters()
        t0 = time.perf_counter()
        result = fn()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = {k: c.count for k, c in counters.items()}
        return result

    def delta(name, ours, record, limit):
        d = ours - record
        out.setdefault("accuracy", {})[name] = {"port": ours, "record": record, "delta": round(d, 6)}
        if abs(d) > limit:
            out["findings"].append(f"{name}: {ours} against the record's {record}")

    scenes, ids, side = EVALS_OOD
    ood = run("ood", lambda: ood_report(scenes, ids, side, "assets/detector_v4_128.msgpack", log=quiet))
    rec = _record("docs/OOD_EVAL_detector_v4_128.json")["detector"]
    for family, row in ood["detector"].items():
        delta(f"ood.{family}.recall", row["recall@iou0.5"], rec[family]["recall@iou0.5"], EVALS_DELTA["recall"])
    emb = _record("docs/OOD_EVAL.json")["embedder_ood_appearance"]
    delta("ood.embedder.top1_pp", 100 * ood["embedder_ood_appearance"]["top1"], 100 * emb["top1"],
          EVALS_DELTA["top1_pp"])
    check(out["launches"]["ood"]["detect_post"] == scenes * (len(OOD_FAMILIES) + 1), f"ood: {out['launches']['ood']}")

    rec = _record("docs/INT8_AGREEMENT.json")
    out["int8"] = {}
    images = None
    draws = run("int8_draws", lambda: distractor_draws(EVALS_INT8_IDS, EVALS_INT8_ROWS - EVALS_INT8_IDS, 512,
                                                       np.random.default_rng(0 + 1)))  # seed 0, the script's + 1
    # The record's slim checkpoint only (the ultraslim one is left out for
    # the script's time).
    for ckpt in ("assets/arcface_synthid9k_slim_512.msgpack",):
        name = os.path.basename(ckpt).split("_")[2]
        embedded = run(f"int8_{name}_embed", lambda: render_and_embed(EVALS_INT8_IDS, 0, ckpt, 512, None,
                                                                      log=quiet, images=images))
        images = embedded.pop("images")
        rep = run(f"int8_{name}", lambda: int8_report(EVALS_INT8_IDS, EVALS_INT8_ROWS, 512, 0, embedded=embedded,
                                                      draws=draws, log=quiet))
        launches = out["launches"][f"int8_{name}"]
        check(launches["stream_topk"] > 0 and launches["int8_topk"] > 0, f"int8 {name}: {launches}")
        out["int8"][name] = {"render_s": embedded["render_s"], "embed_s": embedded["embed_s"],
                             "checkpoint": embedded["checkpoint"], "report": rep}
        for gallery in ("real_9k", "capacity_1m"):
            check(rep[gallery]["top1_agreement_pct"] >= EVALS_INT8_MIN_AGREEMENT,
                  f"int8 {name} {gallery}: agreement {rep[gallery]['top1_agreement_pct']}%")
            if name == "slim" and EVALS_INT8_IDS == EVALS_INT8_RECORD_IDS:  # the record's checkpoint and size
                for key in ("top1_agreement_pct", "f32_top1_correct_pct", "int8_top1_correct_pct"):
                    delta(f"int8.{gallery}.{key}", rep[gallery][key], rec[gallery][key], EVALS_DELTA["top1_pp"])
    del images, draws

    lbph_dir = os.path.join(tmp, "lbph_ids")
    rendered = run("lbph_render", lambda: render_id_folders(lbph_dir, EVALS_LBPH_IDS, 10, 160, 0, log=None))
    lbph = run("lbph", lambda: lbph_scale_report(lbph_dir, EVALS_LBPH_IDS, 8, 2, 100, log=quiet))
    check(out["launches"]["lbph"]["lbph_hist"] > 0 and out["launches"]["lbph"]["chi2_nn"] > 0,
          f"lbph: {out['launches']['lbph']}")
    out["lbph"] = {"render": rendered, "report": lbph}
    if EVALS_LBPH_IDS == 1_000:  # the record's size
        delta("lbph.top1_pp_1000_ids", 100 * lbph["top1"], 100 * EVALS_LBPH_RECORD_TOP1, EVALS_DELTA["lbph_pp"])
    else:
        out.setdefault("accuracy", {})[f"lbph.top1_pp_{EVALS_LBPH_IDS}_ids"] = {"port": 100 * lbph["top1"]}

    n_ids, per_id, size, seed = EVALS_COMPARE
    cmp_dir = os.path.join(tmp, "compare_ids")
    rendered = run("compare_render", lambda: render_id_folders(cmp_dir, n_ids, per_id, size, seed, log=None))
    rows = run("compare", lambda: compare_all_models.compare_models(cmp_dir, max_images=n_ids * per_id,
                                                                     match_kernel="stream"))
    launches = out["launches"]["compare"]
    check(all(launches[k] > 0 for k in ("stream_topk", "lbph_hist", "chi2_nn")), f"compare: {launches}")
    rec = _record("docs/COMPARISON.json")
    for model, row in rows.items():
        for key in ("accuracy", "f1_macro"):
            delta(f"compare.{model}.{key}_pp", 100 * row[key], 100 * rec[model][key],
                  EVALS_DELTA["lbph_pp" if model == "lbph" else "top1_pp"])
    out["compare"] = {"render": rendered, "rows": rows}
    probes, record = EVALS_FACENET_AB
    ab = run("facenet_ab", lambda: facenet_ab(["assets/facenet_synthid9k_512.msgpack"], cmp_dir, probes))
    out["facenet_ab"] = ab = ab["facenet_synthid9k_512.msgpack"]
    check(ab["n"] == probes, f"facenet_ab over {ab['n']} images")
    delta(f"facenet_ab.top1_pp_{probes}", 100 * ab["top1"], record, EVALS_DELTA["top1_pp"])
    results = run("evaluate", lambda: evaluate_model.evaluate_model(
        cmp_dir, checkpoint="assets/arcface_synthid9k_ultraslim_512.msgpack",
        output_dir=os.path.join(tmp, "eval_out"), match_kernel="stream", plots=False))
    check(out["launches"]["evaluate"]["stream_topk"] > 0, f"evaluate: {out['launches']['evaluate']}")
    out["evaluate"] = {k: results[k] for k in ("top_1_accuracy", "top_5_accuracy") if k in results}
    print("evals full", json.dumps({k: out[k] for k in ("seconds", "launches", "findings", "accuracy")}),
          flush=True)
    return out


def evals_phase(card: str, device) -> dict:
    """The tools, the CelebA preprocessor, the export round trip, the
    reduced-size evaluations against the JAX fixture (gate i), and the four
    evaluations at the records' sizes (the int8 agreement's gate ii)."""
    import tempfile

    from facerecognition_tpu_torch.tools import eval_fixture

    seconds, out = {}, {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="evals-") as tmp:
        timed("tools", evals_tools, card, tmp)
        timed("celeba", evals_celeba, card, tmp)
        timed("export", evals_export, card, tmp)
        t0 = time.perf_counter()
        counters = reset_counters()
        reduced = eval_fixture.run_reduced(device)
        seconds["reduced"] = time.perf_counter() - t0
        fails, deltas = eval_fixture.compare(eval_fixture.load(), reduced)
        out["reduced"] = {"deltas": deltas, "launches": {k: c.count for k, c in counters.items()}}
        print("evals reduced", json.dumps({"card": card, "failures": fails, **out["reduced"]}), flush=True)
        check(not fails, f"the reduced-size evaluations against the JAX fixture: {fails}")
        timed("full", evals_full, card, tmp)
    out["seconds"] = seconds
    print("evals seconds", json.dumps(seconds), flush=True)
    return out


PARALLEL_ROWS = 1_000_003  # the sharded gallery: PARALLEL_SHARDS shards on the one card
PARALLEL_SHARDS = 4
PARALLEL_B, PARALLEL_K = 128, 5
PARALLEL_GLOO_ROWS = 100_003  # the 2-rank gloo search: 2 of 4 shards a rank
MFN_B = 128
DP_IDS, DP_SAMPLES, DP_SIDE = 9_343, 2, 32  # the torchrun trainers' folder, resized to 112² by the loader
DP_STEP_B, DP_STEP_CLASSES = 32, 1_000  # the 2-rank gloo ArcFace step: (1,1,1,1) ResNet at 112²
DP_TOL = 2e-3  # of a tensor's scale: the SGD steps' tolerance of tests/test_torch_train_steps.py


def int8_warp_checks(device) -> dict:
    """The int8 warp mode (``fast="int8"``) against its plain version on the
    card, bit for bit, at the align warp B 128, 256² → 112² and the crowd
    window B 32 x M 4; timed against the plain version, with the bound
    (the output once, the source pixels the taps reach once) and the
    kernel's trace; the first 8 slots bit for bit against the plain version
    on the CPU too."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.ops import warp_sample as ws

    rng = np.random.default_rng(SEED + 21)
    lines = {}
    for name, b, m, window in (("align", WARP_B, 1, None), ("window", 32, CROWD_FACES, 160)):
        frames, lms = warp_inputs(rng, FRAME[0], b, m, device)
        if window:
            kernel = lambda: ws.align_crop_window(frames, lms, 112, window, fast="int8")  # noqa: E731
        else:
            kernel = lambda: ws.align_crop(frames, lms, 112, fast="int8")  # noqa: E731
        plain = lambda: ws._align_plain(frames, lms, 112, window, "int8")  # noqa: E731
        counters = reset_counters()
        with strict_fp32():
            got = kernel()
            launched = counters["warp_sample"].count
            ref = plain()
            diff = (got - ref).abs()
            few = 8 // m  # the CPU's plain version on the first 8 slots (it takes seconds a slot)
            cpu = ws._align_plain(frames[:few].cpu(), lms[:few].cpu(), 112, window, "int8")
            line = {"case": name, "frames": b, "slots": b * m, "side": FRAME[0], "out": 112,
                    "fast": "int8", "launches": launched, "max_abs_err": diff.max().item(),
                    "mean_abs_err": diff.mean().item(),
                    "cpu_plain_max_abs_diff_8_slots": (got[:8].cpu() - cpu).abs().max().item()}
            check(launched == 1, f"int8 warp {name}: {launched} launches for one call")
            check(line["max_abs_err"] == 0.0, f"int8 warp {name}: max |Δ| {line['max_abs_err']}")
            check(line["cpu_plain_max_abs_diff_8_slots"] == 0.0, f"int8 warp {name} against the CPU: {line}")
            line["ms"] = statistics.median(cuda_ms(kernel, 20) for _ in range(3))
            line["plain_ms"] = cuda_ms(plain, 3, 1)
            moved = got.numel() * 4 + touched_pixels(frames, lms, m, "window" if window else "align", 112) * 3
            line["bound_ms"] = (moved + lms.numel() * 4) / HBM_BYTES_PER_S * 1e3
            line["bound_by"] = "bytes"
            line["library_ms"] = None
            line["trace"], line["device_us"] = kernel_trace(kernel, "warp_sample")
        print("int8 warp", json.dumps(line), flush=True)
        lines[name] = line
    torch.cuda.empty_cache()
    return lines


def batch_helper_checks(device) -> dict:
    """``detect_best_face_batch`` and ``align_crop_batch`` on the card
    against the CPU port (boxes and landmarks within 1e-4 px, crops within
    1e-3 levels)."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.detector_net import anchor_centers, detect_best_face_batch
    from facerecognition_tpu_torch.ops.image import align_crop_batch

    rng = np.random.default_rng(SEED + 22)
    anchors = torch.as_tensor(anchor_centers(DET_SIZE))
    raw = torch.as_tensor(rng.normal(size=(WARP_B, len(anchors), 15)).astype(np.float32))
    raw[..., 0] *= 6.0
    got = detect_best_face_batch(raw.to(device), anchors.to(device))
    want = detect_best_face_batch(raw, anchors)
    line = {"detect_best_face_batch_max_abs_diff": max((a.cpu() - b).abs().max().item()
                                                       for a, b in zip(got, want))}
    check(line["detect_best_face_batch_max_abs_diff"] <= 1e-4, f"detect_best_face_batch card vs CPU {line}")
    frames, lms = warp_inputs(rng, FRAME[0], 16, 1, device)
    crops = align_crop_batch(frames, lms[:, 0], 112)
    line["align_crop_batch_max_abs_diff"] = (crops.cpu() - align_crop_batch(frames.cpu(), lms[:, 0].cpu(), 112)
                                             ).abs().max().item()
    check(line["align_crop_batch_max_abs_diff"] <= 1e-3, f"align_crop_batch card vs CPU {line}")
    print("batch helpers", json.dumps(line), flush=True)
    return line


def mobilefacenet_checks(device) -> dict:
    """MobileFaceNet at full width (512-D, 112², a seeded init) at B 128 on
    the card against the CPU port, in evaluation and training mode (TF32
    off): every row's cosine above 0.999; images/s of the forward, and of a
    training step of ``MobileFaceNetArcFace`` (SGD, 1,000 classes)."""
    import copy

    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.models.mobilefacenet import MobileFaceNetArcFace
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain

    gen = torch.Generator().manual_seed(SEED + 23)
    model = init_like_flax(MobileFaceNetArcFace(1_000, 512), gen)
    cpu = copy.deepcopy(model)
    card = model.to(device)
    x = torch.randn((MFN_B, 112, 112, 3), generator=gen)
    xd = x.to(device)
    out = {"batch": MFN_B}
    with strict_fp32():
        for mode in ("eval", "train"):
            card.train(mode == "train")
            cpu.train(mode == "train")
            with torch.no_grad():
                a, b = card.backbone(xd).cpu(), cpu.backbone(x)
                cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
                forward = lambda: card.backbone(xd)  # noqa: E731
                ms = statistics.median(cuda_ms(forward, 10) for _ in range(3))
            out[mode] = {"min_cosine": cos.min().item(), "ms": ms, "images_per_s": MFN_B / ms * 1e3}
            check(out[mode]["min_cosine"] > 0.999, f"MobileFaceNet {mode} card vs CPU: {out[mode]}")
        labels = torch.randint(0, 1_000, (MFN_B,), generator=gen).to(device)
        state = steps.TrainState(card, OptaxChain(dict(card.named_parameters()), "sgd", lambda c: 0.01,
                                                  momentum=0.9))
        step = steps.make_arcface_train_step(0.1)
        metrics = step(state, xd, labels)
        check(bool(torch.isfinite(metrics["loss"])), f"MobileFaceNet train step loss {metrics}")
        ms = statistics.median(cuda_ms(lambda: step(state, xd, labels), 5) for _ in range(3))
        out["train_step"] = {"ms": ms, "images_per_s": MFN_B / ms * 1e3}
    print("mobilefacenet", json.dumps(out), flush=True)
    return out


def sharded_gallery_checks(device) -> dict:
    """A ``ShardedGallery`` of ``PARALLEL_ROWS`` x 512 cut into
    ``PARALLEL_SHARDS`` shards on the one card, float32 (``stream_topk`` a
    shard) and int8 (``int8_topk`` a shard), B 128, k 5, against one
    ``stream_topk`` / ``int8_topk`` over the whole gallery: indices equal,
    scores bit for bit (each row's score does not depend on its shard:
    the difference is printed, and gated at 0); the planted rows come back
    top-1; the sharded call's time beside the whole-gallery call's, in
    turns."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.ops.int8_topk import int8_topk
    from facerecognition_tpu_torch.ops.matcher import quantize_embeddings_int8_np
    from facerecognition_tpu_torch.ops.stream_topk import stream_topk
    from facerecognition_tpu_torch.parallel import ShardedGallery, create_mesh
    from facerecognition_tpu_torch.parallel.sharding import _f32_topk, _int8_topk, _sharded_topk

    n, d, b, k = PARALLEL_ROWS, 512, PARALLEL_B, PARALLEL_K
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    g = torch.randn((n, d), generator=gen, device=device)
    planted = torch.randperm(n, generator=gen, device=device)[:b]
    q = g[planted] + 0.05 * torch.randn((b, d), generator=gen, device=device)
    host = g.cpu().numpy()
    g = None
    norm = host / np.maximum(np.linalg.norm(host, axis=1, keepdims=True), 1e-12)  # set_all's rows
    names = [str(i) for i in range(n)]
    mesh = create_mesh([device] * PARALLEL_SHARDS, gallery=PARALLEL_SHARDS)
    out = {"rows": n, "shards": PARALLEL_SHARDS, "B": b, "k": k}
    for quantize in (False, True):
        kernel = "int8_topk" if quantize else "stream_topk"
        sg = ShardedGallery(mesh, dim=d, quantize=quantize)
        t0 = time.perf_counter()
        sg.set_all(names, host)
        line = {"set_all_s": time.perf_counter() - t0}
        if quantize:
            codes, scales = quantize_embeddings_int8_np(norm)
            codes, scales = torch.from_numpy(codes).to(device), torch.from_numpy(scales).to(device)
            whole = lambda: int8_topk(q, codes, scales, k)  # noqa: E731
            fn = _int8_topk
        else:
            rows = torch.from_numpy(np.ascontiguousarray(norm)).to(device)
            whole = lambda: stream_topk(q, rows, k)  # noqa: E731
            fn = _f32_topk
        counters = reset_counters()
        s, i = sg.topk(q.cpu().numpy(), k)
        line["launches"] = {name: c.count for name, c in counters.items() if c.count}
        check(counters[kernel].count == PARALLEL_SHARDS,
              f"{kernel} launched {counters[kernel].count} times for {PARALLEL_SHARDS} shards")
        ws_, wi = (t.cpu().numpy() for t in whole())
        line["indices_equal"] = bool((i == wi).all())
        line["max_abs_score_diff"] = float(np.abs(s - ws_).max())
        line["planted_top1"] = float((i[:, 0] == planted.cpu().numpy()).mean())
        check(line["indices_equal"], f"sharded {kernel}: indices differ from the whole gallery's")
        check(line["max_abs_score_diff"] == 0.0, f"sharded {kernel}: scores differ: {line}")
        check(line["planted_top1"] == 1.0, f"sharded {kernel}: planted rows not top-1: {line}")
        sharded = lambda: _sharded_topk(q, sg._shards, k, n, fn)  # noqa: E731
        rounds = []
        for _ in range(TIMING_ROUNDS):  # sharded, whole, whole, sharded
            a = cuda_ms(sharded, 10)
            w1, w2 = cuda_ms(whole, 10), cuda_ms(whole, 10)
            rounds.append((a, w1, w2, cuda_ms(sharded, 10)))
        line["sharded_ms"] = statistics.median([r[0] for r in rounds] + [r[3] for r in rounds])
        line["whole_ms"] = statistics.median([r[1] for r in rounds] + [r[2] for r in rounds])
        print("sharded gallery", kernel, json.dumps(line), flush=True)
        out[kernel] = line
        sg = rows = codes = scales = None
        torch.cuda.empty_cache()
    return out


def dp_arcface_step(device, shard=None) -> dict:
    """One ArcFace step ((1,1,1,1) ResNet, 512-D, 112², B ``DP_STEP_B``,
    mixup with given draws, SGD with momentum and clip) from a seeded init,
    as one process or as ``shard``'s rank; its metrics and final tensors on
    the host."""
    import torch

    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain

    gen = torch.Generator().manual_seed(SEED + 25)
    model = ArcFaceModel(512, (1, 1, 1, 1), num_classes=DP_STEP_CLASSES, dropout=0.0)
    init_like_flax(model, gen, ("fc",))
    model = model.to(device)
    x = torch.randn((DP_STEP_B, 112, 112, 3), generator=gen)
    labels = torch.randint(0, DP_STEP_CLASSES, (DP_STEP_B,), generator=gen)
    perm = torch.randperm(DP_STEP_B, generator=gen)
    if shard is not None:
        x, labels = shard.take(x), shard.take(labels)
    state = steps.TrainState(model, OptaxChain(dict(model.named_parameters()), "sgd", lambda c: 0.01,
                                               momentum=0.9, grad_clip=5.0))
    metrics = steps.make_arcface_train_step(0.1, 0.2)(state, x.to(device), labels.to(device),
                                                      mix=(0.7, perm), shard=shard)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "tensors": {k: v.cpu() for k, v in model.state_dict().items() if v.is_floating_point()}}


def parallel_rank(rank: int, seed: int) -> dict:
    """One of 2 gloo ranks sharing the card: its 2 of the 4 shards of a
    ``PARALLEL_GLOO_ROWS``-row gallery (float32, then int8; the launches
    counted), then its half of ``dp_arcface_step``."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch import _build
    from facerecognition_tpu_torch.parallel import ShardedGallery, create_mesh
    from facerecognition_tpu_torch.parallel.collectives import batch_shard
    from facerecognition_tpu_torch.parallel.mesh import MeshDevice

    device = torch.device("cuda", 0)
    g, q = gloo_search_data(seed)
    mesh = create_mesh([MeshDevice(i, device, i // 2) for i in range(4)], gallery=4)
    out = {}
    for quantize in (False, True):
        sg = ShardedGallery(mesh, dim=g.shape[1], quantize=quantize)
        sg.set_all([str(i) for i in range(len(g))], g)
        counters = reset_counters()
        s, i = sg.topk(q, PARALLEL_K)
        out["int8" if quantize else "float32"] = {
            "scores": s, "indices": i, "shards": len(sg._shards),
            "launches": {name: c.count for name, c in counters.items() if c.count}}
    out["step"] = dp_arcface_step(device, batch_shard(DP_STEP_B))
    return out


def gloo_search_data(seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    g = rng.standard_normal((PARALLEL_GLOO_ROWS, 512), dtype=np.float32)
    q = g[rng.permutation(PARALLEL_GLOO_ROWS)[:PARALLEL_B]] + 0.05 * rng.standard_normal(
        (PARALLEL_B, 512), dtype=np.float32)
    return g, q


def gloo_ranks_check(device) -> dict:
    """2 ranks over gloo sharing the card (``parallel.launch.spawn_ranks``):
    the sharded search, each rank's local top-k on its kernels, equal to the
    single-process ``ShardedGallery`` on the same 4 shards (indices equal,
    scores bit for bit); the data-parallel ArcFace step (global batch norm
    and mixup pairs, gradients summed over gloo) within ``DP_TOL`` of each
    tensor's scale of the one-process step, the loss within 1e-4."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.parallel import ShardedGallery, create_mesh
    from facerecognition_tpu_torch.parallel.launch import spawn_ranks

    seed = SEED + 26
    t0 = time.perf_counter()
    ranks = spawn_ranks(parallel_rank, 2, seed, backend="gloo", threads=0)
    out = {"spawn_s": time.perf_counter() - t0}
    g, q = gloo_search_data(seed)
    mesh = create_mesh([device] * 4, gallery=4)
    for quantize in (False, True):
        kind = "int8" if quantize else "float32"
        kernel = "int8_topk" if quantize else "stream_topk"
        sg = ShardedGallery(mesh, dim=512, quantize=quantize)
        sg.set_all([str(i) for i in range(len(g))], g)
        ws_, wi = sg.topk(q, PARALLEL_K)
        for r, res in enumerate(ranks):
            got = res[kind]
            check(got["shards"] == 2 and got["launches"].get(kernel) == 2,
                  f"rank {r} {kind}: {got['shards']} shards, launches {got['launches']}")
            check(bool((got["indices"] == wi).all()), f"rank {r} {kind}: indices differ")
            diff = float(np.abs(got["scores"] - ws_).max())
            check(diff == 0.0, f"rank {r} {kind}: scores differ by {diff}")
        out[kind] = {"launches_per_rank": [res[kind]["launches"] for res in ranks]}
    one = dp_arcface_step(device)
    steps_out = {}
    for r, res in enumerate(ranks):
        got = res["step"]
        errs = {name: rel_err(got["tensors"][name], t, 1e-3) for name, t in one["tensors"].items()}
        worst = max(errs, key=errs.get)
        steps_out[r] = {"loss": got["metrics"]["loss"], "one_process_loss": one["metrics"]["loss"],
                        "max_rel_err": errs[worst], "worst": worst}
        check(abs(got["metrics"]["loss"] - one["metrics"]["loss"]) <= 1e-4 * abs(one["metrics"]["loss"]),
              f"rank {r}: DP loss {got['metrics']} against {one['metrics']}")
        check(errs[worst] <= DP_TOL, f"rank {r}: {worst} {errs[worst]} of its scale off the one-process step")
    out["step"] = steps_out
    print("gloo ranks", json.dumps(out), flush=True)
    return out


#: The trainer's command line with cuDNN's deterministic algorithms (the
#: environment sets cuBLAS's): written to a file that ``torchrun`` and
#: ``python`` run alike.
TRAINER_ENTRY = """import sys
import torch
torch.backends.cudnn.deterministic = True
from facerecognition_tpu_torch.training.train_arcface import main
main(sys.argv[1:])
"""


def torchrun_trainer_check(device) -> dict:
    """``train_arcface`` at the train phase's full width (``configs/arcface_config.
    yaml``: ResNet50, 512-D, heavy, B 128, 112²) on ``DP_IDS`` = 9,343
    identities x 2 generated faces, 2 steps with ``train.num_devices=auto``,
    once under ``torchrun`` (a 1-rank NCCL group: the data-parallel step,
    its collectives on NCCL) and once without a group, both with cuDNN's
    and cuBLAS's deterministic algorithms (``TRAINER_ENTRY``: without them
    two processes differed by 1.4-2.5e-3 of a batch-norm bias's scale): the
    histories' train losses within 1e-3 and every tensor of the ``last``
    checkpoints within ``DP_TOL`` of its scale; whether the two are
    bit-equal is printed with the seconds of each run."""
    import os
    import tempfile

    import torch

    from facerecognition_tpu_torch.training.checkpoint import CheckpointManager

    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(prefix="parallel-") as tmp:
        data = os.path.join(tmp, "faces")
        out["write_faces_s"] = write_train_faces(data, device, DP_IDS, DP_SAMPLES, DP_SIDE)
        torch.cuda.empty_cache()
        entry = os.path.join(tmp, "train_arcface_deterministic.py")
        with open(entry, "w") as f:
            f.write(TRAINER_ENTRY)
        env = {**os.environ, "PYTHONPATH": repo, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
        args = [entry, "--config", "configs/arcface_config.yaml"]
        for key in (f"data.data_dir={data}", "data.val_frac=0.02", "train.steps_per_epoch=2",
                    "train.num_epochs=1", "train.num_devices=auto", "checkpoint.save_every_epochs=0"):
            args += ["--set", key]
        runs = {}
        for name, launcher in (("torchrun_nccl_1", [sys.executable, "-m", "torch.distributed.run",
                                                     "--standalone", "--nproc_per_node", "1"]),
                               ("no_group", [sys.executable])):
            ck = os.path.join(tmp, name)
            t0 = time.perf_counter()
            proc = subprocess.run(launcher + args + ["--set", f"checkpoint.dir={ck}"], cwd=repo, env=env,
                                  capture_output=True, text=True, timeout=WATCHDOG_S // 3)
            seconds = time.perf_counter() - t0
            check(proc.returncode == 0, f"{name}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
            grouped = "data-parallel: rank 0 of 1 (nccl)" in proc.stdout
            check(grouped == (name != "no_group"), f"{name}: data-parallel line {grouped}\n{proc.stdout[-2000:]}")
            tree, meta = CheckpointManager(ck).restore("last", map_location="cpu")
            runs[name] = {"seconds": seconds, "history": meta["history"], "model": tree["model"]}
    a, b = runs["torchrun_nccl_1"], runs["no_group"]
    errs = {k: rel_err(a["model"][k].float(), v.float(), 1e-3) for k, v in b["model"].items()
            if v.is_floating_point()}
    worst = max(errs, key=errs.get)
    out.update({name: {"seconds": r["seconds"], "train_loss": r["history"][-1]["train_loss"],
                       "ver_acc": r["history"][-1]["ver_acc"]} for name, r in runs.items()})
    out["max_rel_err"], out["worst"] = errs[worst], worst
    out["bit_equal"] = all(torch.equal(a["model"][k], v) for k, v in b["model"].items())
    check(abs(a["history"][-1]["train_loss"] - b["history"][-1]["train_loss"])
          <= 1e-3 * abs(b["history"][-1]["train_loss"]), f"torchrun vs no group: {out}")
    check(errs[worst] <= DP_TOL, f"torchrun vs no group: {worst} {errs[worst]} of its scale")
    print("torchrun trainer", json.dumps(out), flush=True)
    return out


def dp_step_times(device) -> dict:
    """The ArcFace step of ``train_step_times`` (ResNet50, B 128, 112²,
    ``TRAIN_CLASSES`` classes, heavy, resident data) in a 1-rank NCCL group
    in this process, as the data-parallel step (``shard``: its gradients and
    metrics all-reduced over NCCL) and as the one-card step, timed in turns
    (dp, one, one, dp); the group is taken down after."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws
    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.parallel.collectives import batch_shard
    from facerecognition_tpu_torch.parallel.launch import free_port
    from facerecognition_tpu_torch.parallel.multihost import initialize_multihost
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain
    from facerecognition_tpu_torch.training.schedules import build_schedule
    from facerecognition_tpu_torch.training.train_arcface import normalize_u8

    initialize_multihost(f"localhost:{free_port()}", 1, 0, [device.index], backend="nccl")
    try:
        rng = np.random.default_rng(SEED + 27)
        gen = torch.Generator().manual_seed(SEED + 27)
        model = init_like_flax(ArcFaceModel(512, num_classes=TRAIN_CLASSES, margin=0.2, easy_margin=True),
                               gen, ("fc",)).to(device)
        state = steps.TrainState(model, OptaxChain(dict(model.named_parameters()), "sgd",
                                                   build_schedule(0.01, "cosine", 1000, 20),
                                                   weight_decay=5e-4, grad_clip=5.0))
        raw = steps.make_arcface_train_step(0.1)
        data, _ = warp_inputs(rng, 112, TRAIN_RESIDENT, 1, device)
        labels_all = torch.as_tensor(rng.integers(0, TRAIN_CLASSES, TRAIN_RESIDENT), device=device)
        batches = [torch.as_tensor(rng.integers(0, TRAIN_RESIDENT, 128), device=device) for _ in range(8)]
        g = torch.Generator(device=device).manual_seed(SEED)
        shard = batch_shard(128)
        turn = [0]

        def step(sh):
            turn[0] += 1
            idx = batches[turn[0] % len(batches)]
            images = data.index_select(0, idx)
            draws = augment_draws(g, 128, 112, "heavy")
            return raw(state, normalize_u8(apply_augment(images, draws, "heavy")),
                       labels_all.index_select(0, idx), g, shard=sh)

        dp, one = (lambda: step(shard)), (lambda: step(None))
        rounds = [(cuda_ms(dp, 5, 2), cuda_ms(one, 5, 2), cuda_ms(one, 5, 2), cuda_ms(dp, 5, 2))
                  for _ in range(2)]
        out = {"world": shard.world, "backend": dist.get_backend(), "batch": 128, "classes": TRAIN_CLASSES,
               "dp_ms": statistics.median([r[0] for r in rounds] + [r[3] for r in rounds]),
               "one_card_ms": statistics.median([r[1] for r in rounds] + [r[2] for r in rounds])}
        check(np.isfinite(dp()["loss"].item()), "the data-parallel step's loss is not finite")
    finally:
        dist.destroy_process_group()
    print("dp step time", json.dumps(out), flush=True)
    return out


def parallel_phase(card: str, device) -> dict:
    """The last API slice and the multi-device layer on the card (a process
    of its own): the int8 warp mode, the batch helpers, MobileFaceNet, the
    sharded gallery on the one card, 2 gloo ranks sharing it, the
    data-parallel step at one NCCL rank, and the trainer under a 1-rank NCCL
    ``torchrun``."""
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    out = {"int8_warp": timed("int8_warp", int8_warp_checks, device),
           "batch_helpers": timed("batch_helpers", batch_helper_checks, device),
           "mobilefacenet": timed("mobilefacenet", mobilefacenet_checks, device),
           "sharded": timed("sharded_gallery", sharded_gallery_checks, device),
           "gloo": timed("gloo_ranks", gloo_ranks_check, device),
           "dp_step": timed("dp_step_times", dp_step_times, device),
           "torchrun": timed("torchrun_trainer", torchrun_trainer_check, device)}
    out["seconds"] = seconds
    print("parallel seconds", json.dumps(seconds), flush=True)
    return out


# -- the models' compute dtype ------------------------------------------------------

#: The dtype phase's warp shapes: (name, frame side, frames, slots per frame,
#: mode, output side), the model inputs of the bf16 serving path.
DTYPE_WARP_CASES = (
    ("detector_input", 256, WARP_B, 1, "resize", DET_SIZE),
    ("embedder_input", 256, WARP_B, 1, "align", 112),
    ("embedder_input_160", 256, WARP_B, 1, "align", 160),
    ("embedder_input_window", 256, 32, CROWD_FACES, "window", 112),
)
#: bf16 embedding cosines, card against the CPU's bf16 plain path (serving and
#: staged; least reading 0.99970 on an H100) and against the card's float32
#: (least reading 0.99962). They hold the bf16 path's rounding, not its dtype:
#: float32 in place of bf16 would pass them too. What shows the dtype is
#: ``dtype_engine``'s dtypes, ``conv_output_dtypes``, the serving run's
#: warp launches by kind and ``input_casts``.
DTYPE_MIN_COS_CPU = 0.9995
DTYPE_MIN_COS_F32 = 0.999
DTYPE_CONF_TOL = 2e-2  # staged confidences (cosines) card against CPU in bf16
#: detect_all boxes card against CPU in bf16, frame pixels at 256²: the box
#: regression in bf16 (an ulp is 0.4% of a value), doubled from the
#: detector's 128² (1.15 px measured on an H100)
DTYPE_BOX_PX = 2.0
DTYPE_FACE_SCORE = 0.5  # faces compared across engines: detector score at least this
ARCFACE_WEIGHTS = "arcface_synthid9k_ultraslim_512.msgpack"
DETECTOR_WEIGHTS = "detector_v4_128.msgpack"


def dtype_warp_checks(device) -> dict:
    """``warp_sample`` writing the model inputs in bf16 and float16 (fast on,
    the engine's mode): bit for bit against its plain version on the card at
    the serving shapes, one kernel per call (no cast after it), timed beside
    the float32 output of the same call; the bound counts the 2-byte
    output."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.ops import warp_sample as ws

    rng = np.random.default_rng(SEED + 40)
    lines = {}
    for name, side, b, m, mode, out in DTYPE_WARP_CASES:
        frames, lms = warp_inputs(rng, side, b, m, device)
        lms = lms * (DET_SIZE / side)  # the engine hands the warp detector pixels
        window = 160 if mode == "window" else None
        lms_frame = ws.scale_landmarks(lms, side, side, DET_SIZE)
        touched = touched_pixels(frames, lms_frame, m, mode, out) * 3
        for dtype in ("float32", "bfloat16", "float16"):
            if mode == "resize":
                kernel = lambda: ws.detector_input(frames, out, True, out_dtype=dtype)  # noqa: E731
                plain = lambda: ws.detector_input_plain(frames, out, True, dtype)  # noqa: E731
            else:
                kernel = lambda: ws.embedder_input(  # noqa: E731
                    frames, lms, DET_SIZE, out, window, True, out_dtype=dtype)
                plain = lambda: ws.embedder_input_plain(  # noqa: E731
                    frames, lms, DET_SIZE, out, window, True, dtype)
            before = ws.launches.count
            got = kernel()
            launched = ws.launches.count - before
            ref = plain()
            torch.cuda.synchronize()
            check(launched == 1, f"warp_sample {name} out_dtype={dtype}: {launched} launches for one call")
            check(got.dtype == ref.dtype == getattr(torch, dtype), f"{name}: {got.dtype}, {ref.dtype}")
            check(torch.equal(got, ref), f"warp_sample {name} out_dtype={dtype} differs from the plain version")
            line = {"case": name, "out_dtype": dtype, "frames": b, "side": side, "out": out,
                    "slots": b * m, "max_abs_err": 0.0, "launches": launched}
            line["ms"] = statistics.median(cuda_ms(kernel, 20) for _ in range(3))
            line["plain_ms"] = cuda_ms(plain, 3, 1)
            moved = got.numel() * got.element_size() + touched
            moved += 0 if mode == "resize" else lms.numel() * 4
            line["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
            line["bound_by"] = "bytes"
            line["library_ms"] = None
            _, line["device_us"] = kernel_trace(kernel, "warp_sample")
            print("warp_sample dtype", json.dumps(line), flush=True)
            lines[f"{name}/{dtype}"] = line
    return lines


def rendered_frames(n: int, side: int, max_faces: int, seed: int):
    """(n, side, side, 3) uint8 scenes of the port's renderer with up to
    ``max_faces`` faces each."""
    import numpy as np

    from facerecognition_tpu_torch.training.synthetic_faces import scene_batch

    imgs = scene_batch(np.random.default_rng(seed), n, side, max_faces=max_faces)[0]
    return np.clip(np.rint(imgs), 0, 255).astype(np.uint8)


def dtype_engine(model_type: str, dtype: str, device):
    """A ``RecognitionEngine`` with the shipped v4 detector and the shipped
    embedder of ``model_type``, both computing in ``dtype``."""
    import os

    import torch

    from facerecognition_tpu_torch.inference import extract_embeddings as ee
    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.preprocessing.face_detector import (
        FaceDetector,
        default_detector_checkpoint,
    )

    det_path = default_detector_checkpoint()
    check(os.path.basename(det_path) == DETECTOR_WEIGHTS, f"detector weights {det_path}")
    detector = FaceDetector(confidence_threshold=0.0, min_face_size=0, max_faces=4,
                            dtype=dtype, device=device)
    if model_type == "facenet":
        path = ee.default_facenet_checkpoint()
        check(os.path.basename(path) == FACENET_WEIGHTS, f"FaceNet weights {path}")
        embedder = ee.load_facenet_model(path, dtype=dtype, device=device)
    else:
        path = ee.default_arcface_checkpoint()
        check(os.path.basename(path) == ARCFACE_WEIGHTS, f"ArcFace weights {path}")
        embedder = ee.load_arcface_model(path, dtype=dtype, device=device)
    check(embedder.config.dtype == detector.dtype == getattr(torch, dtype),
          f"{model_type} engine in {embedder.config.dtype} / {detector.dtype}, not {dtype}")
    return RecognitionEngine(embedder, detector=detector, device=device)


def _iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def matched_cosines(results, others) -> list:
    """Each face of ``results`` with a detector score of at least
    ``DTYPE_FACE_SCORE`` paired with the face of ``others`` (same frame)
    whose box overlaps it most (IoU above 0.5, or it fails): the cosines of
    their embeddings."""
    import numpy as np

    out = []
    for f, (res, oth) in enumerate(zip(results, others)):
        for face in res["faces"]:
            if face["det_score"] < DTYPE_FACE_SCORE:
                continue
            best = max(oth["faces"], key=lambda o: _iou(face["bbox"], o["bbox"]), default=None)
            check(best is not None and _iou(face["bbox"], best["bbox"]) > 0.5,
                  f"frame {f}: face at {face['bbox']} has no counterpart")
            a, b = face["embedding"], best["embedding"]
            out.append(float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b))))
    return out


def dtype_serving(card: str, model_type: str, engines: dict, frames, max_faces: int,
                  match_kernel: str) -> dict:
    """16 requests of rendered frames through ``MicroBatcher`` on the bf16
    card engine, each face's own embedding planted in a 100k-row gallery:
    every top-1 is its row. The same frames through the CPU port's bf16
    plain path and the card's float32 engine: the embeddings' cosines
    (faces paired by box), min and mean."""
    import numpy as np

    from facerecognition_tpu_torch.apps.serving import MicroBatcher
    from facerecognition_tpu_torch.inference.engine import Gallery

    rng = np.random.default_rng(SEED + 50 + max_faces)
    bf16 = engines["bf16"]
    for e in engines.values():
        e.match_kernel = match_kernel
        e.gallery = Gallery(512, device=e.device)
        e.gallery.add_many(["seed"], rng.normal(size=(1, 512)).astype(np.float32))
    first = bf16.fused_recognize_frames(frames, max_faces=max_faces)
    faces = [(f, j) for f in range(len(frames)) for j in range(len(first[f]["faces"]))]
    check(len(faces) >= len(frames), f"only {len(faces)} faces in {len(frames)} frames")
    rows = rng.normal(size=(GALLERY_ROWS, 512)).astype(np.float32)
    names = [f"id{r:06d}" for r in range(GALLERY_ROWS)]
    planted = {fj: int(r) for fj, r in zip(faces, rng.choice(GALLERY_ROWS, len(faces), replace=False))}
    own = np.stack([first[f]["faces"][j]["embedding"] for f, j in faces])
    for e in engines.values():
        e.gallery = Gallery(512, device=e.device)
        e.gallery.add_many(names, rows)
        e.gallery.add_many([names[planted[fj]] for fj in faces], own)
    batcher = MicroBatcher(bf16, frame_size=FRAME, max_faces=max_faces, max_delay_ms=5)
    results, errors, lock = {}, [], threading.Lock()

    def client(ids):
        for f in ids:
            try:
                res = batcher.submit(frames[f], timeout=120)
            except BaseException as e:  # reported by the main thread
                with lock:
                    errors.append(e)
                return
            with lock:
                results[f] = res

    counters = reset_counters()
    threads = [threading.Thread(target=client, args=(range(c, len(frames), N_CLIENTS),))
               for c in range(N_CLIENTS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        batcher.close()
    launches = {name: c.count for name, c in counters.items()}
    warp_kinds = counters["warp_sample"].by_kind()
    if errors:
        raise errors[0]
    check(len(results) == len(frames), f"{len(results)} of {len(frames)} answers")
    matcher = "int8_topk" if match_kernel == "int8" else "stream_topk"
    for name in (matcher, "warp_sample") + (("detect_post",) if max_faces > 1 else ()):
        check(launches[name] > 0, f"bf16 max_faces={max_faces}: the path launched no {name} kernel")
    embedder_kind = "window/bfloat16" if max_faces > 1 else "align/bfloat16"
    check(warp_kinds.get("resize/bfloat16", 0) > 0 and warp_kinds.get(embedder_kind, 0) > 0
          and set(warp_kinds) == {"resize/bfloat16", embedder_kind},
          f"bf16 max_faces={max_faces}: warp_sample launches by kind {warp_kinds}")
    for f, j in faces:
        top = results[f]["faces"][j]["top_k"]
        want = names[planted[(f, j)]]
        row_score = dict(top).get(want)
        check(top[0][0] == want or (row_score is not None and top[0][1] - row_score <= 1e-6),
              f"bf16 frame {f} face {j}: top-1 {top[0]}, planted {want}")
    served = [results[f] for f in range(len(frames))]
    line = {"card": card, "model_type": model_type, "max_faces": max_faces,
            "match_kernel": match_kernel, "faces": len(faces), "planted_top1": len(faces),
            "launches": launches, "warp_launches_by_kind": warp_kinds}
    for other, least in (("cpu", DTYPE_MIN_COS_CPU), ("f32", DTYPE_MIN_COS_F32)):
        cos = matched_cosines(served, engines[other].fused_recognize_frames(frames, max_faces=max_faces))
        check(len(cos) > 0 and min(cos) > least,
              f"bf16 vs {other}: embedding cosines min {min(cos, default=None)}")
        line[f"cos_vs_{other}"] = {"min": min(cos), "mean": statistics.fmean(cos), "faces": len(cos)}
    print("dtype serving", json.dumps(line), flush=True)
    return line


def dtype_staged(card: str, engines: dict, frames) -> dict:
    """``detect_all`` and ``recognize`` of the bf16 engine on the card against
    the CPU port's bf16 plain path: the same faces (boxes within
    ``DTYPE_BOX_PX``, confidences within 1e-2), the same identities, confidences within
    ``DTYPE_CONF_TOL``, embedding cosines above ``DTYPE_MIN_COS_CPU``."""
    import numpy as np

    card_e, cpu_e = engines["bf16"], engines["cpu"]
    box_err = conf_err = 0.0
    cos = []
    for frame in frames:
        got, ref = card_e.detector.detect_all(frame), cpu_e.detector.detect_all(frame)
        check(len(got) == len(ref), f"detect_all: {len(got)} faces on the card, {len(ref)} on the CPU")
        for g, r in zip(got, ref):
            box_err = max(box_err, float(np.abs(np.subtract(g["bbox"], r["bbox"])).max()))
            conf_err = max(conf_err, abs(g["confidence"] - r["confidence"]))
        g, r = card_e.recognize(frame, k=5), cpu_e.recognize(frame, k=5)
        check(g["identity"] == r["identity"], f"recognize: {g['identity']} vs CPU {r['identity']}")
        check(abs(g["confidence"] - r["confidence"]) <= DTYPE_CONF_TOL,
              f"recognize: confidence {g['confidence']} vs CPU {r['confidence']}")
        cos.append(float(g["embedding"] @ r["embedding"]
                         / (np.linalg.norm(g["embedding"]) * np.linalg.norm(r["embedding"]))))
    check(box_err <= DTYPE_BOX_PX and conf_err <= 1e-2,
          f"detect_all: box {box_err} px, confidence {conf_err}")
    check(min(cos) > DTYPE_MIN_COS_CPU, f"recognize: card vs CPU cosine {min(cos)}")
    line = {"card": card, "frames": len(frames), "detect_all_max_box_px": box_err,
            "detect_all_max_conf_diff": conf_err, "recognize_cos_min": min(cos),
            "recognize_cos_mean": statistics.fmean(cos)}
    print("dtype staged", json.dumps(line), flush=True)
    return line


def input_casts(fn, shapes) -> int:
    """``aten::_to_copy`` / ``aten::copy_`` calls on a tensor of one of
    ``shapes`` in one call of ``fn`` (the profiler's shapes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    n = 0
    for ev in prof.key_averages(group_by_input_shape=True):
        if ev.key in ("aten::_to_copy", "aten::copy_") and ev.input_shapes and \
                list(ev.input_shapes[0]) in shapes:
            n += ev.count
    return n


def conv_output_dtypes(engine, frames) -> list:
    """The dtypes the detector's and the embedder's convolutions wrote in one
    fused call of ``engine`` (forward hooks on every ``layers.Conv2d``)."""
    from facerecognition_tpu_torch.models.layers import Conv2d

    seen = set()
    convs = [m for net in (engine.detector.net, engine.embedder.model) for m in net.modules()
             if isinstance(m, Conv2d)]
    hooks = [m.register_forward_hook(lambda _m, _x, y: seen.add(str(y.dtype))) for m in convs]
    try:
        engine.fused_recognize_frames(frames)
    finally:
        for h in hooks:
            h.remove()
    return sorted(seen)


def dtype_phase(card: str, device) -> dict:
    """The models' compute dtype on the card: the warp's bf16 / float16
    model inputs, bf16 serving (ArcFace one face and M = 4 with ``stream``
    and ``int8``, FaceNet one face) against the CPU and float32, the staged
    API, and one fused call at B = 128, bf16 against float32 in turns."""
    import numpy as np

    from facerecognition_tpu_torch.tools.checkout_compare import alternate_ms

    t0 = time.perf_counter()
    out = {"warp": dtype_warp_checks(device)}
    scenes = {m: rendered_frames(N_FRAMES, FRAME[0], m, SEED + 60 + m) for m in (1, CROWD_FACES)}
    arcface = {"bf16": dtype_engine("arcface", "bfloat16", None),
               "f32": dtype_engine("arcface", "float32", None),
               "cpu": dtype_engine("arcface", "bfloat16", "cpu")}
    out["serving"] = {f"arcface/{m}/{kind}": dtype_serving(card, "arcface", arcface, scenes[m], m, kind)
                      for m in (1, CROWD_FACES) for kind in ("stream", "int8")}
    out["staged"] = dtype_staged(card, arcface, scenes[CROWD_FACES][:4])
    batch = np.tile(scenes[1], (PROFILE_BATCH // N_FRAMES, 1, 1, 1))
    for e in arcface.values():
        e.match_kernel = "stream"
    bf16, f32 = arcface["bf16"], arcface["f32"]
    casts = input_casts(lambda: bf16.fused_recognize_frames(batch),
                        [[PROFILE_BATCH, s, s, 3] for s in (DET_SIZE, 112)]
                        + [[PROFILE_BATCH, 3, s, s] for s in (DET_SIZE, 112)])
    check(casts == 0, f"the bf16 fused call cast its model inputs {casts} times")
    conv_dtypes = conv_output_dtypes(bf16, scenes[1])
    check(conv_dtypes == ["torch.bfloat16"], f"the bf16 fused call's convolutions wrote {conv_dtypes}")
    profiles = {"bf16": fused_profile(bf16, batch, 1), "f32": fused_profile(f32, batch, 1)}
    walls = alternate_ms({kind: (lambda e=e: e.fused_recognize_frames(batch))
                          for kind, e in (("bf16", bf16), ("f32", f32))})
    out["fused"] = {kind: {**{key: profiles[kind][key] for key in (
        "wall_ms", "device_ms", "host_gap_ms", "launches_per_call", "copies_per_call", "ours_us")},
        "alternating_wall_ms": walls[kind]["ms"], "alternating_rounds_ms": walls[kind]["rounds_ms"]}
        for kind in ("bf16", "f32")}
    out["fused"]["input_casts_bf16"] = casts
    out["fused"]["conv_output_dtypes_bf16"] = conv_dtypes
    print("fused bf16 vs float32", json.dumps(out["fused"]), flush=True)
    arcface = bf16 = f32 = None
    facenet = {"bf16": dtype_engine("facenet", "bfloat16", None),
               "f32": dtype_engine("facenet", "float32", None),
               "cpu": dtype_engine("facenet", "bfloat16", "cpu")}
    out["serving"]["facenet/1/stream"] = dtype_serving(card, "facenet", facenet, scenes[1], 1, "stream")
    out["seconds"] = time.perf_counter() - t0
    return out


def bf16_backward_check(device) -> dict:
    """One bf16 ArcFace step (ResNet50, B 16, 112²) on the card: the dtypes
    each convolution's backward read (its output's cotangent) and wrote
    (its input's and its kernel's gradients), by hooks on the autograd
    nodes of every ``layers.Conv2d``; the dtypes of the gradients that
    reach ``OptaxChain``; and the device kernels of the step whose names
    hold ``dgrad`` or ``wgrad``."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.layers import Conv2d, init_like_flax
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain

    rng = np.random.default_rng(SEED + 41)
    model = init_like_flax(ArcFaceModel(512, num_classes=TRAIN_IDENTITIES, dropout=0.0, dtype="bfloat16"),
                           torch.Generator().manual_seed(SEED + 41), ("fc",)).to(device)
    state = steps.TrainState(model, OptaxChain(dict(model.named_parameters()), "sgd", lambda c: 0.0))
    images = torch.as_tensor(rng.normal(size=(PARITY_ARC_B, 112, 112, 3)).astype(np.float32), device=device)
    labels = torch.as_tensor(rng.integers(0, TRAIN_IDENTITIES, PARITY_ARC_B), device=device)
    read, wrote, nodes = set(), set(), []

    def on_node(grad_inputs, grad_outputs):
        read.update(str(g.dtype) for g in grad_outputs if g is not None)
        wrote.update(str(g.dtype) for g in grad_inputs[:2] if g is not None)

    def on_forward(_m, _x, y):
        node = y.grad_fn
        while node is not None and "Convolution" not in type(node).__name__:
            node = node.next_functions[0][0]  # past a bias add
        check(node is not None, "a bf16 convolution's output has no convolution node")
        nodes.append(node.register_hook(on_node))

    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    hooks = [m.register_forward_hook(on_forward) for m in convs]
    step = steps.make_arcface_train_step(0.1)
    try:
        grads, _ = step.gradients(state, images, labels)
    finally:
        for h in hooks + nodes:
            h.remove()
    events = profile_kernels(lambda: step.gradients(state, images, labels), calls=1)
    grad_kernels = sorted(n for n in events if "dgrad" in n.lower() or "wgrad" in n.lower())
    line = {"convolutions": len(convs), "backward_read": sorted(read), "backward_wrote": sorted(wrote),
            "grads_to_optax": sorted({str(g.dtype) for g in grads.values()}),
            "grad_kernels": len(grad_kernels), "grad_kernel_names": grad_kernels[:8]}
    check(len(nodes) == len(convs), f"{len(nodes)} convolution nodes hooked of {len(convs)}")
    check(line["backward_read"] == line["backward_wrote"] == ["torch.bfloat16"],
          f"the convolutions' backward read {line['backward_read']} and wrote {line['backward_wrote']}")
    check(line["grads_to_optax"] == ["torch.float32"], f"gradients reach OptaxChain in {line['grads_to_optax']}")
    print("train dtype backward", json.dumps(line), flush=True)
    return line


def dtype_training_runs(device) -> dict:
    """``TRAIN_DTYPE_RUN``: ArcFace (ResNet50, 512-D, 112²) trained on fixed
    batches in bf16 and in float32 from one init (SGD, momentum 0.9, a
    cosine schedule with 3 warmup steps, clip 5): both losses fall (the last
    five steps' mean below the first five's) and the bf16 final loss (the
    last five's mean) is within ``TRAIN_DTYPE_FINAL_REL`` of float32's."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.models.arcface import ArcFaceModel
    from facerecognition_tpu_torch.models.layers import init_like_flax
    from facerecognition_tpu_torch.training import steps
    from facerecognition_tpu_torch.training.optim import OptaxChain
    from facerecognition_tpu_torch.training.schedules import build_schedule

    n_steps, b, classes, n_batches, lr = TRAIN_DTYPE_RUN
    rng = np.random.default_rng(SEED + 42)
    batches = [(torch.as_tensor(rng.normal(size=(b, 112, 112, 3)).astype(np.float32), device=device),
                torch.as_tensor(rng.integers(0, classes, b), device=device)) for _ in range(n_batches)]
    out = {"steps": n_steps, "batch": b, "classes": classes, "fixed_batches": n_batches, "lr": lr}
    for dt in ("bfloat16", "float32"):
        model = init_like_flax(ArcFaceModel(512, num_classes=classes, margin=0.2, easy_margin=True,
                                            dropout=0.0, dtype=dt),
                               torch.Generator().manual_seed(SEED + 42), ("fc",)).to(device)
        state = steps.TrainState(model, OptaxChain(dict(model.named_parameters()), "sgd",
                                                   build_schedule(lr, "cosine", n_steps, 3),
                                                   momentum=0.9, grad_clip=5.0))
        step = steps.make_arcface_train_step(0.1)
        t0 = time.perf_counter()
        losses = [step(state, *batches[i % n_batches])["loss"] for i in range(n_steps)]
        losses = [x.item() for x in losses]
        out[dt] = {"losses": losses, "first5": statistics.fmean(losses[:5]),
                   "final": statistics.fmean(losses[-5:]), "seconds": time.perf_counter() - t0}
        model = state = None
    out["final_rel"] = abs(out["bfloat16"]["final"] - out["float32"]["final"]) / out["float32"]["final"]
    print("train dtype runs", json.dumps(out), flush=True)
    for dt in ("bfloat16", "float32"):
        check(all(np.isfinite(out[dt]["losses"])), f"{dt} run: losses {out[dt]['losses']}")
        check(out[dt]["final"] < out[dt]["first5"], f"{dt} run: loss did not fall {out[dt]['losses']}")
    check(out["final_rel"] <= TRAIN_DTYPE_FINAL_REL,
          f"bf16 final loss {out['bfloat16']['final']} vs float32 {out['float32']['final']}")
    return out


def dtype_step_times(card: str, device) -> dict:
    """``resident_step`` in bf16 and in float32, timed in turns
    (``alternate_ms``): wall ms a step, images/s, and from the profiler
    the device ms and kernel launches a step."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.tools.checkout_compare import alternate_ms

    out = {"card": card}
    for kind in ("arcface", "facenet"):
        runs = {dt: resident_step(kind, device, dt) for dt in ("bfloat16", "float32")}
        walls = alternate_ms({dt: r[0] for dt, r in runs.items()}, rounds=3, calls=4)
        out[kind] = {}
        for dt, (one, b, s, tier) in runs.items():
            events = profile_kernels(one, calls=3)
            loss = one()["loss"].item()
            check(np.isfinite(loss), f"{kind} {dt} timed step loss {loss}")
            out[kind][dt] = {"batch": b, "side": s, "tier": tier, "ms_per_step": walls[dt]["ms"],
                             "rounds_ms": walls[dt]["rounds_ms"], "images_per_s": b / walls[dt]["ms"] * 1e3,
                             "device_ms_per_step": sum(us for _, us in events.values()) / 1e3,
                             "launches_per_step": sum(n for n, _ in events.values())}
        out[kind]["bf16_over_f32_wall"] = out[kind]["bfloat16"]["ms_per_step"] / out[kind]["float32"]["ms_per_step"]
        print("train dtype step time", json.dumps({"kind": kind, **out[kind]}), flush=True)
        runs = None
        torch.cuda.empty_cache()
    return out


def train_dtype_phase(card: str, device) -> dict:
    """Training in bf16 on the card: one ArcFace and one FaceNet step
    against the CPU's bf16 step and float64 (``half_parity_step``), the
    convolutions' backward in bf16 with float32 gradients for the
    optimizer, ``TRAIN_DTYPE_RUN`` steps in bf16 and float32 from one init,
    and the step times of both dtypes in turns."""
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    out = {"parity": {kind: timed(f"parity_{kind}", half_parity_step, kind, device)
                      for kind in ("arcface", "facenet")}}
    out["backward"] = timed("backward", bf16_backward_check, device)
    out["runs"] = timed("runs", dtype_training_runs, device)
    out["times"] = timed("times", dtype_step_times, card, device)
    out["seconds"] = seconds
    print("train dtype seconds", json.dumps(seconds), flush=True)
    return out


MEASURE_BATCH = 256  # profile_pipeline's and bench_embed's default batch
MEASURE_GALLERY = 10_000  # profile_pipeline's and realtime_bench's default gallery
MEASURE_ITERS = 16
MEASURE_CHECK_ROWS = 32  # each stage's first rows held against the CPU on the card's own inputs
MEASURE_VARIANTS = ((3, 4, 6, 3), (2, 2, 2, 2))
MEASURE_SERVING = (32, 256, 256)  # clients, requests, frame side (serving_bench's defaults)
MEASURE_REALTIME = (64, 720, 1280)  # frames, height, width (realtime_bench's defaults)
MEASURE_REALTIME_CPU_FRAMES = 4  # frames of the chain also run on the CPU
MEASURE_MJPEG_FRAMES = 64
MEASURE_ROBUST_SIDE = 900  # the rendered stand-in for the JAX script's 900² photo
MEASURE_EMBED_COS = 0.999
MEASURE_IOU_TOL = 0.01
MEASURE_TIED = 1e-3  # top-1 rows closer than this in score may trade places


def _cos_min(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    return float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())


def measure_profile(card: str, device) -> dict:
    """``profile_pipeline`` at B 256 with ``--extra``: every stage timed on
    the card, then each stage's CPU plain path on the first
    ``MEASURE_CHECK_ROWS`` rows of the card's own inputs."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.scripts import profile_pipeline as pp
    from facerecognition_tpu_torch.utils.profiling import ms_per_call

    cpu = torch.device("cpu")
    inputs = pp.draws(MEASURE_BATCH, MEASURE_GALLERY)
    detector, embedder = pp.load_models(device)
    counters = reset_counters()
    stages = pp.build_stages(MEASURE_BATCH, MEASURE_GALLERY, extra=True, device=device,
                             detector=detector, embedder=embedder, inputs=inputs)
    ms = {}
    with torch.no_grad(), strict_fp32():
        for name, (fn, args) in stages.items():
            ms[name] = ms_per_call(fn, args, MEASURE_ITERS, device)
    launches = {name: c.count for name, c in counters.items() if c.count}
    for name in ("warp_sample", "detect_post", "stream_topk"):
        check(launches.get(name, 0) > 0, f"profile_pipeline: {name} did not launch")
    check(tuple(ms) == pp.STAGES + pp.EXTRA, f"profile_pipeline stages {list(ms)}")
    check(all(np.isfinite(v) and v > 0 for v in ms.values()), f"profile_pipeline times {ms}")

    n = MEASURE_CHECK_ROWS
    cpu_det, cpu_emb = pp.load_models(cpu)
    ref = pp.build_stages(n, MEASURE_GALLERY, extra=True, device=cpu, detector=cpu_det, embedder=cpu_emb,
                          inputs=(inputs[0][:n], inputs[1]))
    errs = {}
    with torch.no_grad(), strict_fp32():
        for name, (fn, args) in stages.items():
            got = fn(*args)
            want = ref[name][0](*(a[:n].cpu() for a in args))
            if name == "decode_nms":
                check(torch.equal(got[3][:n].cpu(), want[3]), "decode_nms: validity differs from the CPU")
                errs[name] = max(float((g[:n].cpu() - w).abs().max()) for g, w in zip(got[:3], want[:3]))
                check(errs[name] <= 1e-3, f"decode_nms: {errs[name]} px from the CPU")
            elif name in ("match_topk", "x_topk_lax", "x_topk_blocked", "x_topk_approx"):
                s_got, i_got = (t[:n].cpu() for t in got)
                s_want, i_want = want
                errs[name] = float((s_got - s_want).abs().max())
                close = (s_want[:, :-1] - s_want[:, 1:]).abs().min(1).values < MEASURE_TIED
                check(bool(((i_got.long() == i_want.long()).all(1) | close).all()),
                      f"{name}: indices differ from the CPU")
                check(errs[name] <= 1e-4, f"{name}: scores {errs[name]} from the CPU")
            elif name == "embed_resnet50":
                errs[name] = _cos_min(got[:n].cpu(), want)
                check(errs[name] >= MEASURE_EMBED_COS, f"embed: min cosine {errs[name]} against the CPU")
            else:
                g, w = got[:n].cpu().float(), want.float()
                diff = (g - w).abs()
                errs[name] = float(diff.max())
                if name == "detector_fwd":
                    rel = errs[name] / float(w.abs().max())
                    check(rel < 1e-3, f"detector_fwd: {rel} of scale from the CPU")
                elif name == "warp_align_112":
                    check(errs[name] <= 1.5 and float(diff.mean()) < 0.01, f"align: {errs[name]} from the CPU")
                else:
                    bound = 0.5 if name == "resize_160_to_det" else 1e-3
                    check(errs[name] <= bound, f"{name}: {errs[name]} from the CPU")
    out = {"B": MEASURE_BATCH, "gallery": MEASURE_GALLERY, "iters": MEASURE_ITERS, "ms": ms,
           "sum_ms": sum(ms[k] for k in pp.STAGES), "launches": launches, "cpu_err": errs}
    print("measure profile_pipeline", json.dumps(out), flush=True)
    return out


def measure_embed(card: str, device) -> dict:
    """``bench_embed`` of each of ``MEASURE_VARIANTS`` at B 256; the first 8
    images' embeddings on the card against the CPU's (same weights)."""
    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.scripts import bench_embed as be

    rows = []
    for stages in MEASURE_VARIANTS:
        model = be.variant_model(stages)
        cpu_fn = be.variant_forward(be.variant_model(stages), torch.device("cpu"))
        ips = be.bench_variant(stages, MEASURE_BATCH, MEASURE_ITERS, device, model=model)
        x = be.frames(8, torch.device("cpu"))
        with torch.no_grad(), strict_fp32():
            cos = _cos_min(be.variant_forward(model, device)(x.to(device)).cpu(), cpu_fn(x))
        check(cos >= MEASURE_EMBED_COS, f"bench_embed {stages}: min cosine {cos} against the CPU")
        row = {"stage_sizes": list(stages), "img_per_sec": round(ips, 1), "batch": MEASURE_BATCH,
               "vs_reference_1592": round(ips / be.REFERENCE_IMG_PER_SEC, 2)}
        check(tuple(row) == be.REPORT_KEYS and ips > 0, f"bench_embed line {row}")
        print("measure bench_embed", json.dumps({**row, "cos_vs_cpu": cos}), flush=True)
        rows.append({**row, "cos_vs_cpu": cos})
    return {"variants": rows}


def measure_serving(card: str, device) -> dict:
    """``serving_bench`` at 32 clients x 256 requests of a 256² scene, then
    the warm-up answer against the CPU port's engine on the same upload."""
    import io

    import numpy as np
    import torch

    from facerecognition_tpu_torch.data.native_decode import decode_mem
    from facerecognition_tpu_torch.examples import serving_bench as sb
    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import default_arcface_checkpoint
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    clients, requests, frame = MEASURE_SERVING
    counters = reset_counters()
    with contextlib.redirect_stderr(io.StringIO()):  # wsgiref logs every request
        out = sb.run(clients, requests, frame, port=0, device=device, log=lambda *_: None)
    launches = {name: c.count for name, c in counters.items() if c.count}
    report = out["report"]
    check(tuple(report) == sb.REPORT_KEYS, f"serving_bench keys {list(report)}")
    check(report["failed"] == 0, f"serving_bench: {report['failed']} requests failed")
    for key in ("throughput_rps", "throughput_imgs_s", "p50_ms", "p99_ms", "mean_batch"):
        check(np.isfinite(report[key]) and report[key] > 0, f"serving_bench {key} = {report[key]}")
    # the registry's match kernel is "auto": a 1,000-row gallery is matched
    # densely, so the path's one kernel is the warp
    check(launches.get("warp_sample", 0) > 0, "serving_bench: warp_sample did not launch")
    cpu = torch.device("cpu")
    ref_engine = RecognitionEngine(checkpoint_path=default_arcface_checkpoint(),
                                   detector=FaceDetector(confidence_threshold=0.3, device=cpu), device=cpu)
    gal = np.random.default_rng(0).normal(size=(len(out["engine"].gallery), 512)).astype(np.float32)
    ref_engine.gallery.add_many([f"id_{i}" for i in range(len(gal))], gal)
    ref = ref_engine.fused_recognize_frames(decode_mem(out["jpegs"][0])[None])[0]
    ans = out["answers"][0]
    scores = [s for _, s in ref["top_k"]]
    check(ans["identity"] == ref["identity"] or scores[0] - scores[1] < MEASURE_TIED,
          f"serving_bench: {ans['identity']} on the card, {ref['identity']} on the CPU")
    check(abs(ans["confidence"] - ref["confidence"]) <= APPS_CONF_TOL,
          f"serving_bench: confidence {ans['confidence']} against {ref['confidence']}")
    line = {**report, "launches": launches, "identity": ans["identity"],
            "confidence_vs_cpu": abs(ans["confidence"] - ref["confidence"])}
    print("measure serving_bench", json.dumps(line), flush=True)
    return line


def measure_realtime(card: str, device) -> dict:
    """``realtime_bench`` at 64 frames of 720p, its first frames' chain also
    on the CPU, then ``--mjpeg`` at 64 frames."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.device import strict_fp32
    from facerecognition_tpu_torch.examples import realtime_bench as rb
    from facerecognition_tpu_torch.scripts import profile_pipeline as pp

    frames, h, w = MEASURE_REALTIME
    detector, embedder = pp.load_models(device)
    counters = reset_counters()
    lat = rb.latency(frames, h, w, MEASURE_GALLERY, device, detector, embedder)
    launches = {name: c.count for name, c in counters.items() if c.count}
    for name in ("warp_sample", "stream_topk"):
        check(launches.get(name, 0) > 0, f"realtime_bench: {name} did not launch")
    check(np.isfinite(lat["value"]) and lat["value"] > 0, f"realtime_bench latency {lat['value']}")
    cpu = torch.device("cpu")
    cpu_det, cpu_emb = pp.load_models(cpu)
    n = MEASURE_REALTIME_CPU_FRAMES
    gal, imgs = rb.staged(n, h, w, MEASURE_GALLERY, cpu)
    step = rb.frame_step(cpu_det, cpu_emb, gal, h, w)
    carry = torch.zeros(())
    with torch.no_grad(), strict_fp32():
        for i in range(n):
            carry, idx, scores = step(imgs[i], carry)
            check(int(idx[0]) == lat["top5"][i][0] or float(scores[0] - scores[1]) < MEASURE_TIED,
                  f"realtime_bench frame {i}: row {lat['top5'][i][0]} on the card, {int(idx[0])} on the CPU")
    counters = reset_counters()
    mj = rb.mjpeg(MEASURE_MJPEG_FRAMES, h, w, device, wait_s=120)
    mj_launches = {name: c.count for name, c in counters.items() if c.count}
    # the recognizer's fused calls take the crowd path (M = 4); four
    # enrolled rows are matched densely ("auto")
    for name in ("warp_sample", "detect_post"):
        check(mj_launches.get(name, 0) > 0, f"realtime_bench --mjpeg: {name} did not launch")
    check(mj["value"] > 0 and mj["recognitions_per_s"] > 0, f"realtime_bench --mjpeg {mj['value']}")
    out = {"latency": {k: lat[k] for k in rb.LATENCY_KEYS}, "latency_launches": launches,
           "mjpeg": {k: mj[k] for k in rb.MJPEG_KEYS}, "mjpeg_launches": mj_launches,
           "mjpeg_result": mj["result"].get("identity")}
    print("measure realtime_bench", json.dumps(out), flush=True)
    return out


def measure_robustness(card: str, device) -> dict:
    """``detector_robustness`` on a rendered ``MEASURE_ROBUST_SIDE``² face
    scene (the JAX script's photo is not in the repository): the table on
    the card against the CPU port's."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.scripts import detector_robustness as dr
    from facerecognition_tpu_torch.training.synthetic_faces import scene_batch

    imgs, boxes, _, valid = scene_batch(np.random.default_rng(SEED), 1, MEASURE_ROBUST_SIDE, max_faces=1,
                                        p_face=1.0)
    check(bool(valid[0, 0]), "the robustness scene has no face")
    img, gt = imgs[0].astype(np.uint8), boxes[0, 0].astype(np.float32)
    cases = list(dr.variants(img, gt))
    counters = reset_counters()
    got = dr.evaluate(FaceDetector(confidence_threshold=0.5, device=device), cases)
    launches = {name: c.count for name, c in counters.items() if c.count}
    check(launches.get("detect_post", 0) > 0, "detector_robustness: detect_post did not launch")
    ref = dr.evaluate(FaceDetector(confidence_threshold=0.5, device=torch.device("cpu")), cases)
    worst = 0.0
    for a, b in zip(got, ref):
        check(a["detected"] == b["detected"], f"detector_robustness {a['name']}: {a} on the card, {b} on the CPU")
        worst = max(worst, abs(a["iou"] - b["iou"]))
    check(worst <= MEASURE_IOU_TOL, f"detector_robustness: IoU {worst} from the CPU")
    out = {"side": MEASURE_ROBUST_SIDE, "recall": f"{sum(r['detected'] for r in got)}/{len(got)}",
           "iou_vs_cpu": worst, "launches": launches, "rows": got}
    print("measure detector_robustness", json.dumps(out), flush=True)
    return out


def measure_phase(card: str, device) -> dict:
    """The measurement and robustness tools on the card (``measure``, in a
    process of its own), each through its functions at the JAX scripts'
    default sizes, its counters set to 0 just before and read just after."""
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn(card, device)
        seconds[name] = time.perf_counter() - t0
        return result

    out = {"profile": timed("profile_pipeline", measure_profile),
           "embed": timed("bench_embed", measure_embed),
           "serving": timed("serving_bench", measure_serving),
           "realtime": timed("realtime_bench", measure_realtime),
           "robustness": timed("detector_robustness", measure_robustness)}
    launches = {}
    for key, part in (("profile", "launches"), ("serving", "launches"), ("robustness", "launches")):
        for name, n in out[key][part].items():
            launches[name] = launches.get(name, 0) + n
    for part in ("latency_launches", "mjpeg_launches"):
        for name, n in out["realtime"][part].items():
            launches[name] = launches.get(name, 0) + n
    out["launches"] = launches
    out["seconds"] = seconds
    print("measure seconds", json.dumps(seconds), flush=True)
    return out


BENCH_CHECK_FRAMES = 8  # each run's first frames through its batch on the card and on the CPU
BENCH_SCORE_TOL = {"bf16": 1e-3, "int8": 2e-3, "f32": 1e-3}  # by --warp (int8: the warp's known rounding)
BENCH_DET_TOL = 1e-4
BENCH_MEAN_DET_TOL = 1e-3
#: The align's output on the card against the CPU's plain warp, in levels of the frame (x 127.5):
#: (max, mean), as tests/test_torch_bench.py holds the port's align against JAX's
BENCH_ALIGN_LEVELS = (2.0, 0.01)
BENCH_FULL_RUNS = ("default", "crowd")  # runs whose whole batch is checked (bench_full_batch)
#: bench.main's runs (name, argv): the defaults (B 256, K 16, 10k rows, 160², bf16), the crowd
#: window path, then each other --warp, --ablate and --noise at B 64, K 2
BENCH_RUNS = (("default", []), ("crowd", ["--max-faces", "4", "--batch", "64"])) + tuple(
    (name, argv + ["--batch", "64", "--iters", "2"])
    for name, argv in (("int8", ["--warp", "int8"]), ("f32", ["--warp", "f32"]),
                       ("ablate_detect", ["--ablate", "detect"]), ("ablate_warp", ["--ablate", "warp"]),
                       ("ablate_match", ["--ablate", "match"]), ("noise", ["--noise"])))
BENCH_GALLERY_ARGV = ["--gallery", "250000", "--iters", "2"]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "gallery", "frame", "trained_weights", "ablate",
              "max_faces", "frames_per_sec", "ms_per_frame", "gt_faces_per_frame", "slots_per_sec",
              "mean_det_score")  # bench.py's JSON line, in its order
BENCH_CROWD_KEYS = ("max_faces", "frames_per_sec", "ms_per_frame", "gt_faces_per_frame", "slots_per_sec")
BENCH_GALLERY_KEYS = (("metric", "value", "unit", "max_score_err"), ("metric", "value", "unit", "vs_baseline"))


def _printed(fn, argv):
    """``fn(argv)`` with its standard output captured, printed again, and
    returned: (result, the printed lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    print(buf.getvalue(), end="", flush=True)
    return out, buf.getvalue().strip().splitlines()


def bench_launches_expected(m: int, frame: int, ablate: str, noise: bool, batches: int) -> dict:
    """The kernels a ``bench`` run launches: per batch the detector's resize
    (not under the detect ablation), then the align (the window at M > 1 on
    frames above 160², a second resize under the warp ablation), and
    ``detect_post`` at M > 1; plus the detection sanity's resize and
    ``detect_post`` (scenes only). No ``stream_topk`` at 10k rows (``auto``
    matches densely), no ``int8_topk``."""
    second = ("resize/float32" if ablate == "warp" else
              "window/float32" if m > 1 and frame > 160 else "align/float32")
    kinds = {second: batches}
    if ablate != "detect":
        kinds["resize/float32"] = kinds.get("resize/float32", 0) + batches
    post = batches if m > 1 else 0
    if not noise:
        kinds["resize/float32"] = kinds.get("resize/float32", 0) + 1
        post += 1
    return {"warp_sample": kinds, "detect_post": post, "stream_topk": 0, "int8_topk": 0}


def bench_full_batch(name: str, p, ref, frames_np) -> dict:
    """The whole batch of a run through ``Pipeline.detect`` and ``align`` on
    the card (``p``) and on the CPU (``ref``): the detector scores within
    ``BENCH_DET_TOL``; the align's output within ``BENCH_ALIGN_LEVELS`` of
    the CPU's plain warp of the same frames from the card's landmarks; the
    landmarks' largest difference (pixels of the detector) is recorded."""
    import torch

    from facerecognition_tpu_torch.device import strict_fp32

    t0 = time.perf_counter()
    frames, frames_cpu = torch.as_tensor(frames_np, device=p.device), torch.as_tensor(frames_np)
    lm, d, det_size = p.detect(frames)
    lm_ref, d_ref, _ = ref.detect(frames_cpu)
    with torch.no_grad(), strict_fp32():
        x = p.align(frames, lm, det_size).cpu()
        x_ref = ref.align(frames_cpu, lm.cpu(), det_size)
    det_err = float((d.cpu() - d_ref).abs().max())
    levels = (x - x_ref).abs() * 127.5
    out = {"frames": len(frames_np), "det_scores": det_err, "landmarks": float((lm.cpu() - lm_ref).abs().max()),
           "align_max_levels": float(levels.max()), "align_mean_levels": float(levels.mean())}
    check(det_err <= BENCH_DET_TOL, f"bench {name}: the batch's detector scores {det_err} from the CPU")
    check(out["align_max_levels"] <= BENCH_ALIGN_LEVELS[0] and out["align_mean_levels"] < BENCH_ALIGN_LEVELS[1],
          f"bench {name}: the batch's align {out} from the CPU")
    out["seconds"] = time.perf_counter() - t0
    return out


def bench_run(name: str, argv: list, cpu_models, device) -> dict:
    """One ``bench.main`` run on the card: its line's keys, its launches
    against ``bench_launches_expected``, then its first
    ``BENCH_CHECK_FRAMES`` frames through its batch on the card and on the
    CPU (detector scores, top-5 scores and indices; the indices where the
    CPU's own gap to a neighbouring score exceeds the tolerance) and the
    detection sanity against the CPU's."""
    import numpy as np
    import torch

    from facerecognition_tpu_torch import bench
    from facerecognition_tpu_torch.ops.matcher import cosine_topk

    counters = reset_counters()
    out, lines = _printed(bench.main, argv)
    launches = {"warp_sample": counters["warp_sample"].by_kind(),
                **{k: counters[k].count for k in ("detect_post", "stream_topk", "int8_topk")}}
    line, p = out["line"], out["pipeline"]
    check(json.loads(lines[-1]) == line, f"bench {name}: the last line is not the run's line")
    m, ablate, noise = p.max_faces, p.ablate, "--noise" in argv
    absent = set() if m > 1 else set(BENCH_CROWD_KEYS)
    absent |= set() if ablate else {"ablate"}
    absent |= {"mean_det_score"} if noise else set()
    check(list(line) == [k for k in BENCH_KEYS if k not in absent], f"bench {name} keys {list(line)}")
    check(line["value"] > 0 and line["trained_weights"] is True, f"bench {name} line {line}")
    iters = int(argv[argv.index("--iters") + 1]) if "--iters" in argv else 16
    want = bench_launches_expected(m, line["frame"], ablate, noise, 4 * iters)  # a warm-up run and 3 timed runs
    check(launches == want, f"bench {name}: launches {launches}, expected {want}")

    frames_np, gal_np, _ = out["inputs"]
    f8 = frames_np[:BENCH_CHECK_FRAMES]
    ref = bench.Pipeline(m, ablate, p.warp_mode, torch.device("cpu"), *cpu_models)
    gal_cpu = torch.as_tensor(gal_np)
    s, i, d = (t.cpu() for t in p.one_batch(torch.as_tensor(f8, device=device),
                                            torch.as_tensor(gal_np, device=device)))
    emb, d_ref = ref.embed(torch.as_tensor(f8))
    s_ref, i_ref = ref.match(emb, gal_cpu)
    warp = next(w for w, mode in bench.WARP_MODES.items() if mode == p.warp_mode)
    tol = BENCH_SCORE_TOL[warp]
    det_err = float((d - d_ref).abs().max())
    score_err = float((s - s_ref).abs().max())
    check(det_err <= BENCH_DET_TOL, f"bench {name}: detector scores {det_err} from the CPU")
    check(score_err <= tol, f"bench {name}: scores {score_err} from the CPU")
    if ablate == "match":
        check(bool((i == i_ref).all()), f"bench {name}: indices differ from the CPU")
    else:
        top6 = cosine_topk(emb, gal_cpu, 6, normalized=True)[0]
        gaps = (top6[:, 1:] - top6[:, :-1]).abs()
        apart = torch.minimum(torch.cat([torch.full_like(gaps[:, :1], float("inf")), gaps[:, :4]], 1), gaps)
        firm = apart > tol
        check(bool((i[firm] == i_ref[firm]).all()), f"bench {name}: indices differ from the CPU")
    mean_det = None
    if not noise:
        got = p.mean_det_score(torch.as_tensor(frames_np, device=device))
        mean_det = abs(got - ref.mean_det_score(torch.as_tensor(frames_np)))
        check(round(got, 3) == line["mean_det_score"] and mean_det <= BENCH_MEAN_DET_TOL,
              f"bench {name}: mean_det_score {got} ({mean_det} from the CPU)")
    cpu_err = {"det_scores": det_err, "scores": score_err, "mean_det_score": mean_det}
    if name in BENCH_FULL_RUNS:
        cpu_err["full_batch"] = bench_full_batch(name, p, ref, frames_np)
    return {"line": line, "rounds_ms": out["rounds_ms"], "launches": launches, "cpu_err": cpu_err}


def bench_gallery_run(device) -> dict:
    """``bench_gallery`` at ``BENCH_GALLERY_ARGV``: the two JAX checks run
    inside it; every line parses with the JAX script's keys and the port's
    metric names; one ``stream_topk`` and one ``int8_topk`` call per batch
    (a warm-up run and 3 timed runs) plus one each for the parity lines."""
    from facerecognition_tpu_torch import bench_gallery

    counters = reset_counters()
    out, lines = _printed(bench_gallery.main, BENCH_GALLERY_ARGV)
    launches = {k: counters[k].count for k in ("stream_topk", "int8_topk", "warp_sample")}
    n = BENCH_GALLERY_ARGV[1]
    iters = int(BENCH_GALLERY_ARGV[3])
    parsed = [json.loads(line) for line in lines[1:]]
    check(lines[0].startswith("# gallery=") and len(parsed) == 5, f"bench_gallery lines {lines}")
    check([p["metric"] for p in parsed] == [
        "stream_vs_dense_top1_agreement", "int8_vs_dense_top1_agreement",
        *(f"gallery_match_qps_{path}_N{n}" for path in bench_gallery.PATHS)], f"bench_gallery metrics {parsed}")
    check(all(tuple(p) == BENCH_GALLERY_KEYS[j >= 2] for j, p in enumerate(parsed)), "bench_gallery keys")
    check(launches == {"stream_topk": 1 + 4 * iters, "int8_topk": 1 + 4 * iters, "warp_sample": 0},
          f"bench_gallery launches {launches}")
    return {"lines": parsed, "rounds_ms": {k: v["rounds_ms"] for k, v in out["paths"].items()},
            "launches": launches}


def bench_phase(card: str, device) -> dict:
    """The end-to-end benches on the card (``bench``, in a process of its
    own): ``bench.main`` for each of ``BENCH_RUNS`` (``bench_run``), then
    ``bench_gallery.main`` (``bench_gallery_run``)."""
    import torch

    from facerecognition_tpu_torch import bench
    from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cpu_models = (FaceDetector(device=cpu), load_arcface_model(bench.embedder_weights(), device=cpu))
    runs = {name: bench_run(name, argv, cpu_models, device) for name, argv in BENCH_RUNS}
    gallery = bench_gallery_run(device)
    launches = {}
    for part in [r["launches"] for r in runs.values()] + [gallery["launches"]]:
        for name, n in part.items():
            launches[name] = launches.get(name, 0) + (sum(n.values()) if isinstance(n, dict) else n)
    return {"runs": runs, "gallery": gallery, "launches": launches, "seconds": time.perf_counter() - t0}


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


def in_child(entry: str, card: str, env: Optional[dict] = None) -> dict:
    """A phase in a process of its own, started here and waited for: late
    in this process (after the serving and FaceNet phases) the profiler's
    windows came back without any device event, and the train and synth
    phases time kernels by the profiler. Its lines print to this process's
    output; its counters are set to 0 and read in that process. ``env``:
    variables added to its environment."""
    import os
    import tempfile

    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the child trains on the whole card
    with tempfile.TemporaryDirectory(prefix=f"{entry}-child-") as tmp:
        path = os.path.join(tmp, "result.json")
        code = f"import sys, chip_smoke; sys.exit(chip_smoke.phase_child({entry!r}, {path!r}, {card!r}))"
        proc = subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(os.path.abspath(__file__)),
                              env={**os.environ, **(env or {})}, timeout=WATCHDOG_S)
        check(proc.returncode == 0, f"the {entry} process exited with {proc.returncode}")
        with open(path) as f:
            return json.load(f)


T_START = time.perf_counter()


def main() -> int:
    faulthandler.dump_traceback_later(MAIN_WATCHDOG_S, exit=True)
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
        synth = in_child("synth_phase", smi, DETERMINISTIC_ENV)

    with phase("evals"):
        evals = in_child("evals_phase", smi)

    with phase("parallel"):
        parallel = in_child("parallel_phase", smi)

    with phase("dtype"):
        dtype = in_child("dtype_phase", smi)

    with phase("train dtype"):
        train_dtype = in_child("train_dtype_phase", smi, DETERMINISTIC_ENV)

    with phase("measure"):
        measure = in_child("measure_phase", smi)

    with phase("bench"):
        bench = in_child("bench_phase", smi)
    evals_launches = {name: sum(paths.get(name, 0) for paths in evals["full"]["launches"].values())
                      + evals["reduced"]["launches"].get(name, 0) for name in KERNELS}
    evals_launches["warp_sample"] += evals["celeba"]["warp_sample_launches"]

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
        *(
            {
                "name": "warp_sample",
                "design": WARP_DESIGN + "; int8 mode: tap weights rint(127 w), levels rint and clipped, "
                          "integer sums exact in float32, each vertical sample rounded to a level",
                "case": case,
                "route": "cuda",
                "source": "facerecognition_tpu_torch/csrc/warp_sample.cu",
                "replaces": "facerecognition_tpu/ops/warp_mxu.py:129",
                "launches": parallel["int8_warp"][key]["launches"],
                "launches_in": "the parallel phase's int8 checks (no JAX engine runs the int8 mode)",
                "max_abs_err": parallel["int8_warp"][key]["max_abs_err"],
                "ms": parallel["int8_warp"][key]["ms"],
                "device_us": parallel["int8_warp"][key]["device_us"],
                "plain_ms": parallel["int8_warp"][key]["plain_ms"],
                "bound_ms": parallel["int8_warp"][key]["bound_ms"],
                "bound_by": "bytes",
                "library_ms": None,
            }
            for key, case in (("align", "align int8 B=128 256x256 -> 112x112"),
                              ("window", "align_crop_window int8 B=32 x M=4 256x256 -> 112x112"))
        ),
        *(
            {
                "name": "warp_sample",
                "design": WARP_DESIGN + "; 16-bit output: each float32 value rounded once to the "
                          "model's dtype as it is stored (the model's entry cast), 8-byte stores",
                "case": f"{case} fast=True out_dtype={dt}",
                "route": "cuda",
                "source": "facerecognition_tpu_torch/csrc/warp_sample.cu",
                "replaces": replaces,
                "launches": (dtype["serving"][path]["warp_launches_by_kind"][kind] if dt == "bfloat16"
                             else dtype["warp"][f"{key}/{dt}"]["launches"]),
                "launches_in": (f"the dtype phase's bf16 serving run {path}, {kind} launches"
                                if dt == "bfloat16" else
                                "one call of the dtype phase's warp check (no path serves float16)"),
                "max_abs_err": dtype["warp"][f"{key}/{dt}"]["max_abs_err"],
                "ms": dtype["warp"][f"{key}/{dt}"]["ms"],
                "device_us": dtype["warp"][f"{key}/{dt}"]["device_us"],
                "float32_output_ms": dtype["warp"][f"{key}/float32"]["ms"],
                "plain_ms": dtype["warp"][f"{key}/{dt}"]["plain_ms"],
                "bound_ms": dtype["warp"][f"{key}/{dt}"]["bound_ms"],
                "bound_by": "bytes",
                "library_ms": None,
            }
            for key, case, replaces, path, kind in (
                ("detector_input", "detector_input B=128 256x256 -> 128x128",
                 "facerecognition_tpu/ops/warp_mxu.py:206", "arcface/1/stream", "resize/bfloat16"),
                ("embedder_input", "embedder_input align B=128 256x256 -> 112x112",
                 "facerecognition_tpu/ops/warp_mxu.py:249", "arcface/1/stream", "align/bfloat16"),
                ("embedder_input_160", "embedder_input align B=128 256x256 -> 160x160",
                 "facerecognition_tpu/ops/warp_mxu.py:249", "facenet/1/stream", "align/bfloat16"),
                ("embedder_input_window", "embedder_input window B=32 x M=4 256x256 -> 112x112",
                 "facerecognition_tpu/ops/warp_mxu.py:264", "arcface/4/stream", "window/bfloat16"),
            )
            for dt in ("bfloat16", "float16")
        ),
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
                                                           "queue_wait_ms_mean", "steps_per_s",
                                                           "nondeterministic_ops")},
        "synthid": {k: synth["synthid"][k] for k in ("render_s", "step_ms", "images_per_s", "final")},
        "seconds": synth["seconds"],
    }), flush=True)
    print("evals", json.dumps({
        "celeba": {k: evals["celeba"][k] for k in ("stats", "max_abs_levels", "jpeg_max_abs")},
        "export": evals["export"], "reduced_deltas": evals["reduced"]["deltas"],
        "accuracy": evals["full"]["accuracy"], "findings": evals["full"]["findings"],
        "launches": evals_launches, "seconds": {**evals["seconds"], **evals["full"]["seconds"]},
    }), flush=True)
    print("parallel", json.dumps({
        "mobilefacenet": parallel["mobilefacenet"], "batch_helpers": parallel["batch_helpers"],
        "sharded": parallel["sharded"], "gloo": parallel["gloo"], "torchrun": parallel["torchrun"],
        "dp_step": parallel["dp_step"], "seconds": parallel["seconds"],
    }), flush=True)
    print("dtype", json.dumps({
        "serving": {k: {key: v[key] for key in ("faces", "planted_top1", "cos_vs_cpu", "cos_vs_f32")}
                    for k, v in dtype["serving"].items()},
        "staged": dtype["staged"], "fused": dtype["fused"], "seconds": dtype["seconds"],
    }), flush=True)
    print("train dtype", json.dumps({
        "parity": train_dtype["parity"], "backward": train_dtype["backward"],
        "runs": {k: v for k, v in train_dtype["runs"].items() if k not in ("bfloat16", "float32")} | {
            dt: {k: train_dtype["runs"][dt][k] for k in ("first5", "final", "seconds")}
            for dt in ("bfloat16", "float32")},
        "times": train_dtype["times"], "seconds": train_dtype["seconds"],
    }), flush=True)
    print("measure", json.dumps({
        "profile_ms": measure["profile"]["ms"], "bench_embed": measure["embed"]["variants"],
        "serving": {k: measure["serving"][k] for k in ("throughput_rps", "p50_ms", "p99_ms", "mean_batch",
                                                       "device_duty_cycle")},
        "realtime": measure["realtime"]["latency"], "mjpeg": measure["realtime"]["mjpeg"],
        "robustness_recall": measure["robustness"]["recall"], "launches": measure["launches"],
        "seconds": measure["seconds"],
    }), flush=True)
    print("bench", json.dumps({
        "lines": {k: r["line"] for k, r in bench["runs"].items()}, "gallery": bench["gallery"]["lines"],
        "rounds_ms": {k: r["rounds_ms"] for k, r in bench["runs"].items()},
        "gallery_rounds_ms": bench["gallery"]["rounds_ms"],
        "cpu_err": {k: r["cpu_err"] for k, r in bench["runs"].items()}, "launches": bench["launches"],
        "seconds": bench["seconds"],
    }), flush=True)
    for entry in kernels:
        entry["evals_launches"] = evals_launches[entry["name"]]
        entry["measure_launches"] = measure["launches"].get(entry["name"], 0)
        entry["bench_launches"] = bench["launches"].get(entry["name"], 0)
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

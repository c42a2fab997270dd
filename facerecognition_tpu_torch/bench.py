"""End-to-end benchmark: faces per second through detect → align → embed → match.

Counterpart of the repository's ``bench.py``, with its flags, defaults and
JSON line, plus ``--device``. One batch (``Pipeline.one_batch``) is what
the JAX script's ``one_batch`` computes, with the port's functions:

- ``ops.warp_sample.detector_input(frames, 128, True)``: the bf16-operand
  resize to 128² and ``/ 127.5 - 1`` (the ``warp_sample`` kernel);
- the serving detector (``FaceDetector``: the shipped dense v4 net, or
  its random-init blaze net when no checkpoint ships) in float32 under
  ``device.strict_fp32``, as serving runs it;
- one face: ``models.detector_net.detect_best_face_batch`` (the argmax
  decode); ``--max-faces`` M > 1: ``ops.detect_post.detect_post`` at IoU
  0.3 and M slots (the ``detect_post`` kernel);
- ``ops.warp_sample.embedder_input``: the landmarks scaled to the frame
  and clamped into it, each slot aligned to 112² (from its frame, or from
  its 160² window when M > 1 and the frame is larger than 160²), then
  ``normalize_imagenet_style`` (the ``warp_sample`` kernel);
- the embedder (``FACEREC_BENCH_EMBEDDER``, else
  ``default_arcface_checkpoint()``, else ``arcface_synthid_512.msgpack``,
  else a random-init ResNet50 ArcFace), float32, then
  ``ops.matcher.l2_normalize``;
- ``ops.matcher.auto_cosine_topk(emb, gallery, 5, normalized=True)``: the
  dense product and top-k while the (B, N) float32 scores stay under
  ``DENSE_SCORES_MAX_BYTES`` (2 GiB, as in JAX: 2,097,152 rows at B 256),
  the ``stream_topk`` kernel above it.

``--warp bf16 / int8 / f32`` is the align's ``fast`` True / ``"int8"`` /
False. ``--ablate`` knocks one stage out, as in JAX: ``detect`` (the ArcFace
template scaled to the frame as landmarks, scores of one), ``warp`` (a 112²
resize of the whole frame, repeated M times) or ``match`` (the first five
embedding columns, zero indices).

Refused, with a message: ``--unroll`` other than 1 (a ``lax.scan`` knob
with no counterpart in eager PyTorch; a CUDA graph of the batches would be
a feature the JAX script lacks), and ``--ablate detect`` with
``--max-faces`` > 1 (the JAX script fails on its shapes there).

Inputs (``draws``), in the JAX script's draw order from
``np.random.default_rng(0)``: ``training.synthetic_faces.scene_batch(rng,
B, FRAME, max_faces=M, p_face=1.0)`` (or ``--noise`` integers), then the
(gallery, 512) normal rows, normalised to unit rows. The frames stay
float32, as the JAX script feeds them (serving uploads uint8 frames; the
warp reads either as it is), and are staged on the device with the gallery
before the timing.

Method (``utils/profiling.checksum_rounds``): one warm-up run of
``--iters`` batches, then 3 runs, each of ``--iters`` ``one_batch`` calls
between two CUDA events (wall clock with ``--device cpu``), nothing read
inside a run; the JAX checksum ``sum(scores) + sum(idx)·1e-9 +
sum(det_scores)`` is carried on the device, read after each run and must be
finite; the best run counts. ``mean_det_score``, outside the timing: the
crowd decode (M 4) on the same frames, the best slot's score under the
checkpoint's Platt calibration, averaged.

    python -m facerecognition_tpu_torch.bench [--gallery 10000] [--batch 256] \\
        [--iters 16] [--noise] [--max-faces 1] [--frame 0] [--warp bf16] \\
        [--ablate {detect,warp,match}] [--device cpu]

Prints a ``#`` line (each run's ms, the kernels' launches in the process,
the device) and, last, the JAX script's JSON line with its keys in its
order.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.inference.extract_embeddings import (
    default_arcface_checkpoint,
    load_arcface_model,
)
from facerecognition_tpu_torch.models.detector_net import detect_best_face_batch
from facerecognition_tpu_torch.ops import detect_post as _detect_post
from facerecognition_tpu_torch.ops import stream_topk as _stream_topk
from facerecognition_tpu_torch.ops import warp_sample as _warp_sample
from facerecognition_tpu_torch.ops.detect_post import detect_post
from facerecognition_tpu_torch.ops.image import normalize_imagenet_style
from facerecognition_tpu_torch.ops.matcher import auto_cosine_topk, l2_normalize
from facerecognition_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE
from facerecognition_tpu_torch.ops.warp_mxu import check_fast
from facerecognition_tpu_torch.ops.warp_sample import bilinear_resize, detector_input, embedder_input
from facerecognition_tpu_torch.preprocessing.face_detector import (
    ASSETS_DIR,
    FaceDetector,
    default_detector_checkpoint,
)
from facerecognition_tpu_torch.utils.profiling import checksum_rounds

METRIC = "faces_per_sec_per_chip_detect_align_embed_match"
#: The reference's best batched embed-only throughput (img/s), the JAX
#: script's baseline.
BASELINE = 1592.0
DET_SIZE = 128
EMBED_SIZE = 112
#: The crowd path aligns each slot from this window when the frame is larger.
WINDOW = 160
IOU_THRESHOLD = 0.3
K = 5
WARP_MODES = {"bf16": True, "int8": "int8", "f32": False}
ABLATIONS = ("", "detect", "warp", "match")


def embedder_weights() -> str:
    """``FACEREC_BENCH_EMBEDDER``, else the serving default ArcFace
    checkpoint, else ``assets/arcface_synthid_512.msgpack`` (which may not
    exist: then the embedder is random)."""
    return (os.environ.get("FACEREC_BENCH_EMBEDDER") or default_arcface_checkpoint()
            or os.path.join(ASSETS_DIR, "arcface_synthid_512.msgpack"))


def refusal(max_faces: int, ablate: str, unroll: int = 1) -> Optional[str]:
    """Why a flag combination is refused, or None."""
    if unroll != 1:
        return ("--unroll is the JAX script's lax.scan unroll factor; eager PyTorch has no scan "
                "to unroll, so only 1 is taken")
    if ablate == "detect" and max_faces > 1:
        return ("--ablate detect takes one face a frame: the JAX script fails on its shapes "
                "with --max-faces > 1")
    return None


def draws(batch: int, frame: int, max_faces: int, gallery: int, noise: bool = False):
    """The JAX script's inputs from ``default_rng(0)``: float32 frames
    (B, frame, frame, 3), the (gallery, 512) unit rows, and the number of
    ground-truth faces in the frames (B with ``noise``)."""
    rng = np.random.default_rng(0)
    if noise:
        frames = rng.integers(0, 256, (batch, frame, frame, 3)).astype(np.float32)
        n_gt = batch
    else:
        from facerecognition_tpu_torch.training.synthetic_faces import scene_batch

        frames, _, _, valid = scene_batch(rng, batch, frame, max_faces=max_faces, p_face=1.0)
        frames = frames.astype(np.float32)
        n_gt = int(np.asarray(valid).sum())
    gal = rng.normal(size=(gallery, 512)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    return frames, gal, n_gt


class Pipeline:
    """The benched chain on one device: ``one_batch(frames, gallery)`` →
    (scores (S, 5), int32 indices (S, 5), detector scores (B,) or (B, M)),
    S = B·M slots. ``detector`` / ``embedder``: a ``FaceDetector`` and an
    ``Embedder``, both on ``device`` (default: loaded)."""

    def __init__(self, max_faces: int = 1, ablate: str = "", warp_mode=True,
                 device: DeviceLike = None, detector=None, embedder=None):
        why = refusal(max_faces, ablate)
        if why:
            raise ValueError(why)
        if ablate not in ABLATIONS:
            raise ValueError(f"unknown ablation {ablate!r}; have {ABLATIONS}")
        check_fast(warp_mode)
        self.device = resolve_device(device)
        self.max_faces, self.ablate, self.warp_mode = max_faces, ablate, warp_mode
        self.detector = detector or FaceDetector(device=self.device)
        self.trained_detector = default_detector_checkpoint() is not None
        if embedder is None:
            path = embedder_weights()
            embedder = load_arcface_model(path if os.path.exists(path) else None, device=self.device)
        self.embedder = embedder

    def detect(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Landmarks (B, M, 5, 2) in the detector's pixels, detector scores
        and the detector's size (the frame's under the detect ablation)."""
        b, h = frames.shape[:2]
        with torch.no_grad(), strict_fp32():
            if self.ablate == "detect":
                # the template in frame pixels; a detector size of h scales it by 1
                lm = torch.as_tensor(ARCFACE_TEMPLATE * np.float32(h / 112.0), device=frames.device)
                return lm.expand(b, 1, 5, 2), torch.ones((b,), device=frames.device), h
            raw = self.detector.net(detector_input(frames, DET_SIZE, True))
            if self.max_faces == 1:
                _, lm, det_scores = detect_best_face_batch(raw, self.detector.anchors)
                return lm[:, None], det_scores, DET_SIZE
            _, lm, det_scores, _ = detect_post(raw, self.detector.anchors, IOU_THRESHOLD, self.max_faces)
            return lm, det_scores, DET_SIZE

    def align(self, frames: torch.Tensor, lm: torch.Tensor, det_size: int) -> torch.Tensor:
        """The embedder's input (B·M, 112, 112, 3) from ``detect``'s landmarks."""
        m = self.max_faces
        if self.ablate == "warp":
            x = normalize_imagenet_style(bilinear_resize(frames, EMBED_SIZE, EMBED_SIZE, True))
            return x.repeat_interleave(m, 0) if m > 1 else x
        window = WINDOW if m > 1 and frames.shape[1] > WINDOW else None
        return embedder_input(frames, lm, det_size, EMBED_SIZE, window, self.warp_mode)

    def embed(self, frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """detect → align → embed: unit embeddings (B·M, 512) and detector
        scores."""
        lm, det_scores, det_size = self.detect(frames)
        with torch.no_grad(), strict_fp32():
            emb = l2_normalize(self.embedder.model(self.align(frames, lm, det_size)).float())
        return emb, det_scores

    def match(self, emb: torch.Tensor, gallery: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Top-5 of the unit embeddings in the unit gallery rows."""
        if self.ablate == "match":
            return emb[:, :K], torch.zeros((emb.shape[0], K), dtype=torch.int32, device=emb.device)
        with torch.no_grad():
            return auto_cosine_topk(emb, gallery, K, normalized=True)

    def one_batch(self, frames: torch.Tensor, gallery: torch.Tensor):
        emb, det_scores = self.embed(frames)
        scores, idx = self.match(emb, gallery)
        return scores, idx, det_scores

    def step(self, carry: torch.Tensor, frames: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
        """``carry`` plus one batch's checksum, as the JAX script's scan body."""
        scores, idx, det_scores = self.one_batch(frames, gallery)
        return carry + scores.sum() + idx.sum().float() * 1e-9 + det_scores.sum()

    def mean_det_score(self, frames: torch.Tensor) -> float:
        """The calibrated best-slot detector score of the crowd decode (M 4),
        averaged over the frames (the JAX script's detection sanity)."""
        with torch.no_grad(), strict_fp32():
            raw = self.detector.net(detector_input(frames, DET_SIZE, True))
            ds = detect_post(raw, self.detector.anchors, IOU_THRESHOLD, 4)[2]
        return float(np.mean(self.detector.calibrate(ds[:, 0].cpu().numpy())))


def report(rounds_ms: list, batch: int, iters: int, gallery: int, frame: int, max_faces: int,
           n_gt_faces: int, trained_weights: bool, ablate: str = "",
           mean_det: Optional[float] = None) -> dict:
    """The JAX script's JSON line from the best run."""
    best = min(rounds_ms) / 1e3
    if max_faces == 1:
        faces_per_sec = iters * batch / best
        extra = {}
    else:
        # faces/s counts the ground-truth faces of the scenes, not the slots
        faces_per_sec = iters * n_gt_faces / best
        extra = {
            "max_faces": max_faces,
            "frames_per_sec": round(iters * batch / best, 1),
            "ms_per_frame": round(best / (iters * batch) * 1e3, 3),
            "gt_faces_per_frame": round(n_gt_faces / batch, 2),
            "slots_per_sec": round(iters * batch * max_faces / best, 1),
        }
    return {
        "metric": METRIC,
        "value": round(faces_per_sec, 1),
        "unit": "faces/s",
        "vs_baseline": round(faces_per_sec / BASELINE, 2),
        "gallery": gallery,
        "frame": frame,
        "trained_weights": trained_weights,
        **({"ablate": ablate} if ablate else {}),
        **extra,
        **({"mean_det_score": round(mean_det, 3)} if mean_det is not None else {}),
    }


def main(argv=None) -> dict:
    """Run the bench; returns its record: the JSON ``line``, each run's
    ``rounds_ms`` and ``checksums``, the ``inputs`` (frames, gallery rows,
    ground-truth faces) and the ``pipeline``."""
    import argparse

    ap = argparse.ArgumentParser(description="faces/s through detect → align → embed → match")
    ap.add_argument("--gallery", type=int, default=10_000,
                    help="identity count (see bench_gallery for match-only numbers at 1M rows)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16, help="batches per timed run")
    ap.add_argument("--noise", action="store_true", help="random-noise frames instead of rendered scenes")
    ap.add_argument("--max-faces", type=int, default=1,
                    help=">1 takes the crowd path (detect_post, M slots per frame) over multi-face scenes")
    ap.add_argument("--frame", type=int, default=0,
                    help="frame edge in px (default 160, or 256 for multi-face crowd scenes)")
    ap.add_argument("--unroll", type=int, default=1, help="the JAX scan's unroll factor: only 1 is taken")
    ap.add_argument("--warp", default="bf16", choices=list(WARP_MODES),
                    help="align-warp operands: bf16, int8 or float32")
    ap.add_argument("--ablate", default="", choices=list(ABLATIONS),
                    help="knock one stage out (diagnostic; value is NOT a pipeline throughput)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    why = refusal(args.max_faces, args.ablate, args.unroll)
    if why:
        ap.error(why)
    device = resolve_device(args.device)
    m = args.max_faces
    frame = args.frame or (160 if m == 1 else 256)
    pipeline = Pipeline(m, args.ablate, WARP_MODES[args.warp], device)
    frames_np, gal_np, n_gt = draws(args.batch, frame, m, args.gallery, args.noise)
    frames = torch.as_tensor(frames_np, device=device)
    gallery = torch.as_tensor(gal_np, device=device)
    # detection sanity on the bench inputs, outside the timing
    mean_det = None if args.noise or not pipeline.trained_detector else pipeline.mean_det_score(frames)
    runs = checksum_rounds(lambda c, _: pipeline.step(c, frames, gallery), args.iters, device)
    rounds_ms = [ms for ms, _ in runs]
    trained = pipeline.trained_detector and os.path.exists(embedder_weights())
    line = report(rounds_ms, args.batch, args.iters, args.gallery, frame, m, n_gt, trained,
                  args.ablate, mean_det)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    launches = {mod.__name__.rsplit(".", 1)[1]: mod.launches.count
                for mod in (_warp_sample, _detect_post, _stream_topk)}
    print(f"# rounds_ms={[round(ms, 3) for ms in rounds_ms]} launches={json.dumps(launches)} "
          f"device={device} ({name})", flush=True)
    print(json.dumps(line), flush=True)
    return {"line": line, "rounds_ms": rounds_ms, "checksums": [c for _, c in runs],
            "inputs": (frames_np, gal_np, n_gt), "pipeline": pipeline}


if __name__ == "__main__":
    main()

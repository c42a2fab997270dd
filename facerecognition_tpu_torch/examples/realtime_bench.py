"""Realtime benchmark: per-frame latency and the MJPEG loop's rate.

Counterpart of ``examples/realtime_bench.py``. Two modes:

1. Default: one frame at a time at ``--height`` x ``--width`` (720 x 1280),
   the frames pre-staged on the device, each perturbed by the previous
   frame's result (``frame + carry * 1e-12``) on the device, so the frames
   form a serial chain with no host sync between them: resize
   (``warp_sample``) → detector → ``detect_best_face`` → landmarks scaled and
   clipped per axis → align (``warp_sample``) → embed → ``stream_topk``
   against a ``--gallery``-row gallery of unit rows. The shipped detector
   and serving ArcFace. Method (``utils/profiling.ms_per_call``): the JAX
   script scans the frames inside one ``jit``; here the chain runs between
   two CUDA events (wall clock with ``--device cpu``) after one warm-up
   pass; the best of 3, in ms per frame.
2. ``--mjpeg``: ``apps/realtime.RealtimeRecognizer`` over a pre-rendered
   ring of 32 frames (a face rendered into the top-left square of each),
   its recognize worker taking the fused path on the device while the
   stream copies, overlays and JPEG-encodes: stream frames per second and
   fused recognitions per second over ``--frames`` frames.

    python -m facerecognition_tpu_torch.examples.realtime_bench [--frames 64] [--height 720]
    python -m facerecognition_tpu_torch.examples.realtime_bench --mjpeg [--frames 256]

``--device cpu`` runs either on the CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32

DET = 128
RING = 32


def frame_step(detector, embedder, gallery: torch.Tensor, h: int, w: int):
    """One frame of the chain: ``(frame, carry) → (result, top-5 indices,
    top-5 scores)``, result = top-1 score + detection score (a 0-d
    tensor)."""
    from facerecognition_tpu_torch.models.detector_net import detect_best_face
    from facerecognition_tpu_torch.ops import stream_topk, warp_sample
    from facerecognition_tpu_torch.ops.image import normalize_imagenet_style
    from facerecognition_tpu_torch.ops.matcher import l2_normalize

    dev = gallery.device
    net, model, anchors = detector.net, embedder.model, detector.anchors
    scale = torch.tensor([w / DET, h / DET], device=dev)
    upper = torch.tensor([w - 1.0, h - 1.0], device=dev)

    def step(frame, carry):
        f = frame + carry * 1e-12
        small = warp_sample.bilinear_resize(f[None], DET, DET)
        raw = net(small / 127.5 - 1.0)
        _, lms, det_score = detect_best_face(raw, anchors)
        # per-axis clip: one min(h, w) bound would cap x at h - 1 on a wide frame
        lm = torch.minimum(torch.clamp(lms * scale, min=0.0), upper)
        aligned = warp_sample.align_crop(f[None], lm[:, None], 112)
        emb = l2_normalize(model(normalize_imagenet_style(aligned)).float())
        scores, idx = stream_topk.stream_topk(emb, gallery, 5)
        return scores[0, 0] + det_score[0], idx[0], scores[0]

    return step


def staged(frames: int, h: int, w: int, gallery: int, device: torch.device):
    """The JAX script's draws: the gallery's normal rows (normalised), then
    the frames, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(gallery, 512)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    imgs = rng.integers(0, 256, (frames, h, w, 3)).astype(np.float32)
    return torch.as_tensor(gal, device=device), torch.as_tensor(imgs, device=device)


def latency(frames: int = 64, h: int = 720, w: int = 1280, gallery: int = 10_000,
            device: DeviceLike = None, detector=None, embedder=None) -> dict:
    """The default mode: the JAX script's JSON, with ``top5`` and ``scores``
    (each frame's five best gallery rows and their cosines) and ``carry``
    (the last result) of the last pass."""
    from facerecognition_tpu_torch.scripts.profile_pipeline import load_models
    from facerecognition_tpu_torch.utils.profiling import ms_per_call

    device = resolve_device(device)
    if detector is None or embedder is None:
        detector, embedder = load_models(device)
    gal, imgs = staged(frames, h, w, gallery, device)
    step = frame_step(detector, embedder, gal, h, w)

    def chain():
        carry = torch.zeros((), dtype=torch.float32, device=device)
        top, scores = [], []
        for i in range(frames):
            carry, idx, s = step(imgs[i], carry)
            top.append(idx)
            scores.append(s)
        return carry, torch.stack(top), torch.stack(scores)

    last = {}

    def run():
        last["out"] = chain()
        return last["out"]

    with torch.no_grad(), strict_fp32():
        per_frame_ms = ms_per_call(run, (), 1, device) / frames
    carry, top, scores = last["out"]
    return {
        "metric": "p50_frame_latency_720p_detect_align_embed_match",
        "value": round(per_frame_ms, 3),
        "unit": "ms",
        "fps": round(1000.0 / per_frame_ms, 1),
        "meets_30fps": per_frame_ms < 33.3,
        "top5": top.cpu().tolist(),
        "scores": scores.cpu().tolist(),
        "carry": float(carry),
    }


class RingFrameSource:
    """``RING`` pre-rendered frames read in a ring: a ``synthetic_face_batch``
    face in the top-left ``min(height, width)`` square of each."""

    def __init__(self, height: int, width: int):
        from facerecognition_tpu_torch.training.train_detector import synthetic_face_batch

        rng = np.random.default_rng(0)
        side = min(height, width)
        imgs = synthetic_face_batch(rng, RING, side, p_face=1.0)[0]
        self.frames = np.zeros((RING, height, width, 3), np.uint8)
        self.frames[:, :side, :side] = imgs.astype(np.uint8)
        self.i = 0

    def read(self):
        f = self.frames[self.i % len(self.frames)]
        self.i += 1
        return f

    def release(self):
        pass


def mjpeg(frames: int = 256, height: int = 720, width: int = 1280, device: DeviceLike = None,
          embedder=None, wait_s: float = 900.0) -> dict:
    """The ``--mjpeg`` mode: the JAX script's JSON, with the recognizer's
    last ``result``, the frame ``ring`` and the ``engine``. ``embedder``
    None: the engine's own (a random-init ResNet50, as the JAX script's)."""
    from facerecognition_tpu_torch.apps.realtime import RealtimeRecognizer
    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training.train_detector import synthetic_face_batch

    device = resolve_device(device)
    detector = FaceDetector(device=device)
    engine = RecognitionEngine(embedder=embedder, detector=detector, device=device)
    # a handful of identities, so the worker takes the fused path
    rng = np.random.default_rng(1)
    for i in range(4):
        imgs = synthetic_face_batch(rng, 1, 160, p_face=1.0)[0]
        engine.add_to_db(f"id{i}", [imgs[0].astype(np.uint8)])
    source = RingFrameSource(height=height, width=width)
    rec = RealtimeRecognizer(engine, detector=detector, source=source)
    n_rec = [0]
    fused = engine.fused_recognize_frames

    def counted(*a, **kw):
        n_rec[0] += 1
        return fused(*a, **kw)

    engine.fused_recognize_frames = counted
    gen = rec.frames()
    try:
        # warm: pull until a real result lands, so the timed window is steady
        next(gen)
        t_wait = time.time()
        while rec.result.get("bbox") is None and time.time() - t_wait < wait_s:
            next(gen)
            time.sleep(0.01)
        n0 = n_rec[0]
        t0 = time.perf_counter()
        for _ in range(frames):
            next(gen)
        wall = time.perf_counter() - t0
    finally:
        rec.stop()
    engine.fused_recognize_frames = fused
    return {
        "metric": "mjpeg_stream_fps",
        "value": round(frames / wall, 1),
        "unit": "frames/s",
        "frame": [height, width],
        "frames": frames,
        "recognitions_per_s": round((n_rec[0] - n0) / wall, 1),
        "reference_fps_effective": 2.0,
        "engine": engine,
        "ring": source.frames,
        "result": rec.result,
    }


#: The keys each mode prints (the JAX script's).
LATENCY_KEYS = ("metric", "value", "unit", "fps", "meets_30fps")
MJPEG_KEYS = ("metric", "value", "unit", "frame", "frames", "recognitions_per_s",
              "reference_fps_effective")


def main(argv=None) -> dict:
    import argparse

    parser = argparse.ArgumentParser(description="per-frame latency and the MJPEG loop's rate")
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--gallery", type=int, default=10_000)
    parser.add_argument("--mjpeg", action="store_true",
                        help="measure the end-to-end MJPEG streaming loop (RealtimeRecognizer) "
                        "instead of device latency")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.mjpeg:
        out = mjpeg(args.frames, args.height, args.width, device)
        keys = MJPEG_KEYS
    else:
        out = latency(args.frames, args.height, args.width, args.gallery, device)
        keys = LATENCY_KEYS
    line = {k: out[k] for k in keys}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()

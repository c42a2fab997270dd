"""Per-stage breakdown of the fused detect → align → embed → match path.

Counterpart of ``scripts/profile_pipeline.py``. Each stage runs alone on
pre-staged inputs on the device (computed once, not timed):

- ``resize_160_to_det``: ``ops/warp_sample.bilinear_resize`` (bf16 operands,
  the ``warp_sample`` kernel's resize mode);
- ``detector_fwd``: the shipped detector (``default_detector_checkpoint``,
  dense v4) on the resized frames;
- ``decode_nms``: ``ops/detect_post.detect_post`` at ``max_faces`` 4 (the
  ``detect_post`` kernel);
- ``warp_align_112``: ``ops/warp_sample.align_crop`` of each frame's first
  face (bf16 operands, the ``warp_sample`` kernel);
- ``embed_resnet50``: the serving ArcFace (``default_arcface_checkpoint``)
  on the aligned faces;
- ``match_topk``: ``ops/stream_topk.stream_topk`` against a ``--gallery``-row
  gallery of unit rows (the ``stream_topk`` kernel; the JAX script times
  ``cosine_topk(normalized=True)``, a plain product, on rows it does not
  normalise: the kernel takes cosines, so the gallery is stored as serving
  stores it).

``--extra`` adds the JAX script's diagnostics: ``x_match_matmul_only`` (the
score product, ``torch.matmul`` in float32), ``x_topk_lax`` (``torch.topk`` of
the scores), ``x_topk_blocked`` (top-k of 1,024-column blocks, then of the
candidates), ``x_topk_approx`` (``lax.approx_max_k`` off the TPU is the exact
top-k: ``torch.topk``) and ``x_resize_f32`` (the resize with float32
operands).

Method (``utils/profiling.ms_per_call``): the JAX script scans each stage
``--iters`` times inside one ``jit``; here each stage is called ``--iters``
times between two CUDA events after a warm-up call; the best of 3 rounds,
in ms per batch (wall clock with ``--device cpu``).

    python -m facerecognition_tpu_torch.scripts.profile_pipeline \\
        [--batch 256] [--iters 16] [--gallery 10000] [--extra] [--device cpu]

Prints the markdown table and the JSON line of the JAX script.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32

STAGES = ("resize_160_to_det", "detector_fwd", "decode_nms", "warp_align_112", "embed_resnet50",
          "match_topk")
EXTRA = ("x_match_matmul_only", "x_topk_lax", "x_topk_blocked", "x_topk_approx", "x_resize_f32")
FRAME = 160


def topk_blocked(s: torch.Tensor, k: int = 5, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level top-k: each ``block`` columns' top-k, then the top-k of
    those candidates (the JAX script's ``topk_blocked``)."""
    b, n = s.shape
    pad = (-n) % block
    if pad:
        s = torch.nn.functional.pad(s, (0, pad), value=float("-inf"))
    nb = s.shape[1] // block
    sv, si = torch.topk(s.reshape(b, nb, block), k)
    cand = sv.reshape(b, nb * k)
    cidx = (si + (torch.arange(nb, device=s.device) * block)[None, :, None]).reshape(b, nb * k)
    v2, i2 = torch.topk(cand, k)
    return v2, torch.gather(cidx, 1, i2)


def load_models(device: torch.device):
    """The serving detector (a ``FaceDetector`` at 128²) and embedder (an
    ``Embedder``) from the shipped checkpoints."""
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        load_arcface_model,
    )
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    ckpt = default_arcface_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no serving ArcFace checkpoint found in assets/")
    detector = FaceDetector(confidence_threshold=0.0, device=device)
    return detector, load_arcface_model(ckpt, device=device)


def draws(batch: int, gallery: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX script's draws: ``scene_batch(default_rng(0), batch, 160,
    max_faces=1, p_face=1.0)`` frames, then the gallery's (gallery, 512)
    normal rows from the same generator."""
    from facerecognition_tpu_torch.training.synthetic_faces import scene_batch

    rng = np.random.default_rng(0)
    frames = scene_batch(rng, batch, FRAME, max_faces=1, p_face=1.0)[0].astype(np.float32)
    return frames, rng.normal(size=(gallery, 512)).astype(np.float32)


def build_stages(batch: int, gallery: int = 10_000, det_size: int = 128, extra: bool = False,
                 device: DeviceLike = None, detector=None, embedder=None, inputs=None) -> dict:
    """``{name: (fn, inputs)}`` for every stage, its inputs pre-staged on
    ``device`` from ``inputs`` (frames, gallery rows; default ``draws(batch,
    gallery)``), the gallery rows normalised."""
    from facerecognition_tpu_torch.models.detector_net import anchor_centers
    from facerecognition_tpu_torch.ops import detect_post, stream_topk, warp_sample
    from facerecognition_tpu_torch.ops.image import normalize_imagenet_style
    from facerecognition_tpu_torch.ops.matcher import l2_normalize

    device = resolve_device(device)
    if detector is None or embedder is None:
        detector, embedder = load_models(device)
    frames_np, gallery_np = inputs if inputs is not None else draws(batch, gallery)
    frames = torch.as_tensor(frames_np, device=device)
    anchors = torch.as_tensor(anchor_centers(det_size), device=device)
    gal = l2_normalize(torch.as_tensor(gallery_np, device=device))
    net, model = detector.net, embedder.model

    def resize(f):
        return warp_sample.bilinear_resize(f, det_size, det_size, True)

    def detect(s):
        return net(s / 127.5 - 1.0)

    def post(r):
        return detect_post.detect_post(r, anchors, 0.3, 4)

    def align(f, lm):
        return warp_sample.align_crop(f, lm[:, None], 112, True)

    def embed(a):
        return model(normalize_imagenet_style(a))

    def match(e):
        return stream_topk.stream_topk(e, gal, 5)

    with torch.no_grad(), strict_fp32():
        small = resize(frames)
        raw = detect(small)
        lms = post(raw)[1]
        lm = torch.clamp(lms[:, 0] * (FRAME / det_size), 0.0, FRAME - 1.0)
        aligned = align(frames, lm)
        emb = l2_normalize(embed(aligned).float())
        stages = {
            "resize_160_to_det": (resize, (frames,)),
            "detector_fwd": (detect, (small,)),
            "decode_nms": (post, (raw,)),
            "warp_align_112": (align, (frames, lm)),
            "embed_resnet50": (embed, (aligned,)),
            "match_topk": (match, (emb,)),
        }
        if extra:
            scores0 = emb @ gal.T
            stages.update({
                "x_match_matmul_only": (lambda e: e @ gal.T, (emb,)),
                "x_topk_lax": (lambda s: torch.topk(s, 5), (scores0,)),
                "x_topk_blocked": (topk_blocked, (scores0,)),
                "x_topk_approx": (lambda s: torch.topk(s, 5), (scores0,)),
                "x_resize_f32": (lambda f: warp_sample.bilinear_resize(f, det_size, det_size, False),
                                 (frames,)),
            })
    return stages


def profile(batch: int = 256, iters: int = 16, gallery: int = 10_000, det_size: int = 128,
            extra: bool = False, device: DeviceLike = None, detector=None, embedder=None) -> dict:
    """ms per batch of every stage (``STAGES``, then ``EXTRA`` with
    ``extra``), best of 3."""
    from facerecognition_tpu_torch.utils.profiling import ms_per_call

    device = resolve_device(device)
    stages = build_stages(batch, gallery, det_size, extra, device, detector, embedder)
    out = {}
    with torch.no_grad(), strict_fp32():
        for name, (fn, inputs) in stages.items():
            out[name] = ms_per_call(fn, inputs, iters, device)
    return out


def report(stages: dict, batch: int, det_size: int = 128) -> str:
    """The JAX script's table and JSON line."""
    total = sum(stages.values())
    lines = [f"\nPer-stage (B={batch}, det={det_size}², best-of-3, ms/batch):",
             "| stage | ms | % | img/s |", "|---|---|---|---|"]
    for name, ms in stages.items():
        lines.append(f"| {name} | {ms:.2f} | {100 * ms / total:.0f}% | {batch / ms * 1e3:,.0f} |")
    lines.append(f"| **sum** | {total:.2f} | 100% | {batch / total * 1e3:,.0f} |")
    lines.append(json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return "\n".join(lines)


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description="per-stage breakdown of the fused path")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--gallery", type=int, default=10_000)
    ap.add_argument("--det-size", type=int, default=128)
    ap.add_argument("--extra", action="store_true",
                    help="also time diagnostic sub-stages + candidate match kernels")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    stages = profile(args.batch, args.iters, args.gallery, args.det_size, args.extra,
                     resolve_device(args.device))
    print(report(stages, args.batch, args.det_size), flush=True)
    return stages


if __name__ == "__main__":
    main()

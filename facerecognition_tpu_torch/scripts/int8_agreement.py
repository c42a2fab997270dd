"""float32-vs-int8 top-1 agreement on trained embeddings.

Counterpart of ``scripts/int8_agreement.py``. Protocol:

1. Render ``--ids`` synthetic identities x 2 aligned samples each (enroll /
   probe) with ``training/synthetic_faces.identity_dataset``, the generator
   the serving checkpoint was trained on.
2. Embed both with the ArcFace checkpoint (``--checkpoint``; default the
   serving default, ``default_arcface_checkpoint``: the ultraslim file, where
   the JAX record ``docs/INT8_AGREEMENT.json`` ran the slim one).
3. Gallery A: the enrolled embeddings. Gallery B: A plus ``--extend-to`` −
   len(A) distractor rows, renormalised pairwise mixtures of real rows
   (alpha ~ U(0.25, 0.75) plus sigma = 0.05 Gaussian), drawn by numpy from
   ``default_rng(seed + 1)`` in JAX's order: given the same embeddings,
   JAX's rows.
4. For each gallery: the top-5 of every probe by ``ops/stream_topk``
   (float32; the streaming kernel on the card) and by ``ops/int8_topk``
   (the gallery quantised on the host, ``quantize_embeddings_int8_np``;
   the int8 kernels on the card) → top-1 agreement, identity correctness
   under both, and the float32 top-1 margins at the disagreements.

    python -m facerecognition_tpu_torch.scripts.int8_agreement --out int8.json \
        [--ids 9343] [--extend-to 1000000]
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device

TOP_K = 5


def distractor_draws(n_rows: int, n: int, dim: int, rng: np.random.Generator) -> dict:
    """The JAX script's draws for ``n`` distractors of an ``n_rows``-row
    gallery, in its order: the two rows, the mixing weight, the noise.
    They do not depend on the embeddings, so one set serves every
    checkpoint."""
    i = rng.integers(0, n_rows, n)
    j = rng.integers(0, n_rows, n)
    a = rng.uniform(0.25, 0.75, (n, 1)).astype(np.float32)
    noise = rng.normal(0, 0.05, (n, dim)).astype(np.float32)
    return {"i": i, "j": j, "a": a, "noise": noise}


def distractors(enroll: np.ndarray, draws: dict) -> np.ndarray:
    """Renormalised pairwise mixtures of ``enroll``'s rows plus noise."""
    a = draws["a"]
    d = a * enroll[draws["i"]] + (1 - a) * enroll[draws["j"]]
    d += draws["noise"]
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def agreement(gallery: np.ndarray, probes: np.ndarray, batch: int, device) -> dict:
    """The JAX script's report of one gallery (row r = identity r)."""
    from facerecognition_tpu_torch.ops.int8_topk import int8_topk
    from facerecognition_tpu_torch.ops.matcher import quantize_embeddings_int8_np
    from facerecognition_tpu_torch.ops.stream_topk import stream_topk

    gal = torch.as_tensor(gallery, device=device)
    codes, scales = quantize_embeddings_int8_np(gallery)
    codes = torch.as_tensor(codes, device=device)
    scales = torch.as_tensor(scales, device=device)
    top_f, top_i, sc_f = [], [], []
    for lo in range(0, len(probes), batch):
        q = torch.as_tensor(probes[lo : lo + batch], device=device)
        s, idx = stream_topk(q, gal, TOP_K)
        _, idx8 = int8_topk(q, codes, scales, TOP_K)
        top_f.append(idx[:, 0].cpu().numpy())
        top_i.append(idx8[:, 0].cpu().numpy())
        sc_f.append(s[:, :2].cpu().numpy())
    top_f, top_i, sc_f = np.concatenate(top_f), np.concatenate(top_i), np.concatenate(sc_f)
    agree = top_f == top_i
    margins = sc_f[:, 0] - sc_f[:, 1]
    truth = np.arange(len(probes))
    return {
        "gallery_rows": int(len(gallery)),
        "probes": int(len(probes)),
        "top1_agreement_pct": round(100.0 * float(agree.mean()), 4),
        "disagreements": int((~agree).sum()),
        "f32_top1_correct_pct": round(100.0 * float((top_f == truth).mean()), 4),
        "int8_top1_correct_pct": round(100.0 * float((top_i == truth).mean()), 4),
        "median_top1_margin": round(float(np.median(margins)), 4),
        "min_margin_at_disagreement": round(float(margins[~agree].min()), 6) if (~agree).any() else None,
        "max_margin_at_disagreement": round(float(margins[~agree].max()), 6) if (~agree).any() else None,
    }


def render_and_embed(ids: int, seed: int, checkpoint: Optional[str], batch: int,
                     device: DeviceLike, workers: int = 8, log=print,
                     images: Optional[np.ndarray] = None) -> dict:
    """(enroll, probes) embeddings of ``ids`` identities, with the seconds
    each step took and the checkpoint's path; ``images`` (the
    ``identity_dataset(ids, 2, seed=seed)`` samples) skips rendering."""
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        load_arcface_model,
    )
    from facerecognition_tpu_torch.training.synthetic_faces import identity_dataset

    t0 = time.perf_counter()
    imgs = identity_dataset(ids, 2, seed=seed, workers=workers)[0] if images is None else images
    render_s = time.perf_counter() - t0
    ckpt = checkpoint or default_arcface_checkpoint()
    if ckpt is None:
        raise FileNotFoundError("no serving ArcFace checkpoint found in assets/")
    log(f"rendered {len(imgs)} samples ({render_s:.1f}s); checkpoint: {ckpt}")
    embedder = load_arcface_model(ckpt, device=device)

    def embed_all(arr):
        return np.concatenate([embedder.embed_uint8(arr[i : i + batch]) for i in range(0, len(arr), batch)])

    t1 = time.perf_counter()
    # identity_dataset's layout: row i*2+k is identity i, sample k
    enroll, probes = embed_all(imgs[0::2]), embed_all(imgs[1::2])
    return {"enroll": enroll, "probes": probes, "checkpoint": ckpt, "render_s": render_s,
            "embed_s": time.perf_counter() - t1, "images": imgs}


def int8_report(ids: int = 9343, extend_to: int = 1_000_000, batch: int = 512, seed: int = 0,
                checkpoint: Optional[str] = None, device: DeviceLike = None, embedded=None,
                draws: Optional[dict] = None, log=print) -> dict:
    """The whole report; ``embedded`` (``render_and_embed``'s result) skips
    rendering, ``draws`` (``distractor_draws`` from ``default_rng(seed +
    1)``) drawing."""
    device = resolve_device(device)
    e = embedded or render_and_embed(ids, seed, checkpoint, batch, device, log=log)
    report = {"checkpoint": e["checkpoint"], "real_9k": agreement(e["enroll"], e["probes"], batch, device)}
    log(f"[real_9k] {json.dumps(report['real_9k'])}")
    if extend_to > len(e["enroll"]):
        if draws is None:
            draws = distractor_draws(len(e["enroll"]), extend_to - len(e["enroll"]),
                                     e["enroll"].shape[1], np.random.default_rng(seed + 1))
        ext = np.concatenate([e["enroll"], distractors(e["enroll"], draws)])
        report["capacity_1m"] = agreement(ext, e["probes"], batch, device)
        log(f"[capacity_1m] {json.dumps(report['capacity_1m'])}")
    return report


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="float32 vs int8 top-1 agreement on the card")
    ap.add_argument("--ids", type=int, default=9343)
    ap.add_argument("--extend-to", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None, help="ArcFace weights (default: the serving default)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t0 = time.time()
    report = int8_report(args.ids, args.extend_to, args.batch, args.seed, args.checkpoint,
                         resolve_device(args.device))
    with open(args.out, "w") as f:
        f.write(json.dumps(report, indent=2) + "\n")
    print(f"wrote {args.out} ({time.time()-t0:.0f}s total)", flush=True)
    return report


if __name__ == "__main__":
    main()

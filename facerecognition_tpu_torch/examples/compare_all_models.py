"""Cross-model comparison: ArcFace, FaceNet and LBPH over the same labelled
test set, side by side (accuracy, F1, ms per face), as JSON.

Counterpart of ``examples/compare_all_models.py``: a folder-per-identity
set (``FolderDataset``, at least 2 images each, the first
``--max-images``). ArcFace and FaceNet (the shipped serving checkpoints
unless given) enrol the mean of the first half of each identity's images
in a ``RecognitionEngine`` (threshold 0) and recognise every image
(``recognize_batch``; ``compare_models(match_kernel="stream")`` matches
with the ``stream_topk`` kernel on the card, the command line with the
engine's ``auto`` as JAX). LBPH (``--lbph-model``, or trained
inline on 2 images an identity, the reference's low-shot regime) predicts
every image, each read as JAX reads it: PIL's bilinear resize to 100², then
the BT.601 gray of ``models/lbph_tools.gray_face`` (JAX's
``rgb_to_grayscale`` + ``bilinear_resize`` with XLA's fused rounding
rebuilt: its bits, on the host); the histograms and the nearest rows by the
``lbph_hist`` and ``chi2_nn`` kernels on the card. The times are this run's
own.

    python -m facerecognition_tpu_torch.examples.compare_all_models --data-dir test \
        --output comparison.json
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from facerecognition_tpu_torch.device import resolve_device


def compare_models(data_dir: str, arcface_ckpt=None, facenet_ckpt=None, lbph_model=None,
                   max_images: int = 500, match_kernel: str = "auto", device=None) -> dict:
    from facerecognition_tpu_torch.data.datasets import FolderDataset
    from facerecognition_tpu_torch.data.loader import _load_resize
    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.inference.evaluate import compute_metrics
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        default_facenet_checkpoint,
    )
    from facerecognition_tpu_torch.models.lbph import LBPHModel
    from facerecognition_tpu_torch.models.lbph_tools import gray_face

    device = resolve_device(device)
    index = FolderDataset(data_dir, min_images=2)
    n = min(len(index), max_images)
    labels = np.asarray(index.labels[:n])
    rows = {}
    for model_type, ckpt, size in (
        ("arcface", arcface_ckpt or default_arcface_checkpoint(), 112),
        ("facenet", facenet_ckpt or default_facenet_checkpoint(), 160),
    ):
        images = np.stack([_load_resize(index.paths[i], size) for i in range(n)])
        engine = RecognitionEngine(model_type=model_type, checkpoint_path=ckpt, threshold=0.0,
                                   match_kernel=match_kernel, device=device)
        for c in np.unique(labels):
            idx = np.flatnonzero(labels == c)
            embs = engine.embedder.embed_uint8(images[idx[: max(len(idx) // 2, 1)]].astype(np.float32))
            engine.gallery.add(index.label_names[int(c)], embs.mean(0))
        t0 = time.perf_counter()
        results = engine.recognize_batch(list(images))
        dt = time.perf_counter() - t0
        name_to_id = {nm: i for i, nm in enumerate(index.label_names)}
        pred = np.asarray([name_to_id.get(r["identity"], -1) for r in results])
        rows[model_type] = {**compute_metrics(labels, pred), "ms_per_face": dt / n * 1e3,
                            "checkpoint": os.path.basename(ckpt)}

    gray = np.stack([gray_face(_load_resize(index.paths[i], 100), 100) for i in range(n)])
    if lbph_model and os.path.exists(lbph_model):
        lbph = LBPHModel.load(lbph_model, device=device)
    else:
        lbph = LBPHModel(device=device)
        train = [i for c in np.unique(labels) for i in np.flatnonzero(labels == c)[:2]]
        lbph.train(gray[train], labels[train])
    t0 = time.perf_counter()
    pred, _ = lbph.predict_batch(gray)
    dt = time.perf_counter() - t0
    rows["lbph"] = {**compute_metrics(labels, pred), "ms_per_face": dt / n * 1e3}
    return rows


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="ArcFace, FaceNet and LBPH side by side on the card")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--arcface-ckpt", default=None, help="default: the shipped serving checkpoint")
    parser.add_argument("--facenet-ckpt", default=None, help="default: the shipped serving checkpoint")
    parser.add_argument("--lbph-model", default=None)
    parser.add_argument("--output", default="comparison.json")
    parser.add_argument("--max-images", type=int, default=500)
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    rows = compare_models(args.data_dir, args.arcface_ckpt, args.facenet_ckpt, args.lbph_model,
                          args.max_images, device=resolve_device(args.device))
    with open(args.output, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"{'model':10s} {'accuracy':>9s} {'f1_macro':>9s} {'ms/face':>8s}")
    for m, r in rows.items():
        print(f"{m:10s} {r['accuracy']:9.4f} {r['f1_macro']:9.4f} {r['ms_per_face']:8.2f}")
    return rows


if __name__ == "__main__":
    main()

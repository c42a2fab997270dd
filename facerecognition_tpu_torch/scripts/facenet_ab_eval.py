"""FaceNet checkpoint A/B on an open-set identity-folder benchmark.

Counterpart of ``scripts/facenet_ab_eval.py``: over a folder per identity
(``data/datasets.FolderDataset``, at least 2 images each; the first
``--max-images`` files, resized as PIL's bilinear by ``data/loader.
_load_resize``), each checkpoint's embeddings (``load_facenet_model``, 160²)
→ the per-identity mean prototype of the first half of its images → top-1
over all images.

    python -m facerecognition_tpu_torch.scripts.facenet_ab_eval --data-dir ids \
        ckptA.msgpack [ckptB.msgpack ...]
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from facerecognition_tpu_torch.device import DeviceLike, resolve_device


def load_folder(data_dir: str, size: int, max_images: Optional[int] = None):
    """(index, images (n, size, size, 3) uint8, labels (n,)) of the first
    ``max_images`` files (all when None) of a folder-per-identity set."""
    from facerecognition_tpu_torch.data.datasets import FolderDataset
    from facerecognition_tpu_torch.data.loader import _load_resize

    index = FolderDataset(data_dir, min_images=2)
    n = len(index) if max_images is None else min(len(index), max_images)
    images = np.stack([_load_resize(index.paths[i], size) for i in range(n)])
    return index, images, np.asarray(index.labels[:n])


def prototype_top1(embeddings: np.ndarray, labels: np.ndarray) -> float:
    """Top-1 of every image against per-identity prototypes (the mean of
    the first half of each identity's images)."""
    e = embeddings / np.linalg.norm(embeddings, axis=1, keepdims=True)
    classes = np.unique(labels)
    prots = []
    for c in classes:
        idx = np.flatnonzero(labels == c)
        p = e[idx[: max(len(idx) // 2, 1)]].mean(0)
        prots.append(p / (np.linalg.norm(p) + 1e-12))
    pred = (e @ np.stack(prots).T).argmax(1)
    return float((classes[pred] == labels).mean())


def facenet_ab(ckpts, data_dir: str, max_images: int = 500, device: DeviceLike = None) -> dict:
    from facerecognition_tpu_torch.inference.extract_embeddings import load_facenet_model

    _, images, labels = load_folder(data_dir, 160, max_images)
    report = {}
    for ck in ckpts:
        embedder = load_facenet_model(ck, device=device)
        acc = prototype_top1(np.array(embedder.embed_uint8(images.astype(np.float32))), labels)
        report[os.path.basename(ck)] = {"top1": acc, "n": int(len(labels))}
    return report


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="FaceNet checkpoint A/B on the card")
    ap.add_argument("ckpts", nargs="+")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--max-images", type=int, default=500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    report = facenet_ab(args.ckpts, args.data_dir, args.max_images, resolve_device(args.device))
    for name, row in report.items():
        print(f"{name}: top-1 {row['top1']:.4f} over {row['n']} images")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()

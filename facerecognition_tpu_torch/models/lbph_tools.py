"""LBPH convenience tools.

Counterpart of ``facerecognition_tpu/models/lbph_tools.py``:
``recognize_face``, ``load_faces_capped`` (a person-per-folder directory as
gray 100² faces, at most ``max_per_class`` an identity; ``gray_face`` is
the conversion ``training/train_lbph`` shares) and
``plot_confidence_histogram`` (host only: matplotlib is imported inside).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from facerecognition_tpu_torch.data.datasets import FolderDataset
from facerecognition_tpu_torch.models.lbph import LBPHModel
from facerecognition_tpu_torch.ops.umeyama import fma
from facerecognition_tpu_torch.utils.imageio import load_image


def gray_face(img: np.ndarray, image_size: int) -> np.ndarray:
    """RGB image → (image_size, image_size) float32 gray, on the host's CPU:
    ``ops/image.rgb_to_grayscale``'s BT.601 luma, then its
    ``bilinear_resize`` when the size differs, as the JAX loaders, with
    XLA's fused multiply-adds rebuilt, so the gray values (and the LBP codes
    read from them) are the JAX loaders' bits."""
    rgb = torch.from_numpy(np.asarray(img, np.float32))
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32)
    # summed as XLA's CPU dot does: fma(b, w_b, fma(g, w_g, r * w_r))
    gray = fma(rgb[..., 2], w[2], fma(rgb[..., 1], w[1], rgb[..., 0] * w[0]))
    if tuple(gray.shape) != (image_size, image_size):
        gray = _resize_fused(gray, image_size)
    return gray.numpy()


def _resize_fused(gray: torch.Tensor, size: int) -> torch.Tensor:
    """``bilinear_resize`` of an (H, W) image to (size, size), each step
    rounded as XLA's CPU graph fuses it."""
    h, w = gray.shape

    def positions(n_in: int) -> torch.Tensor:
        # (i + 0.5) * scale - 0.5 as one fused multiply-add
        i = torch.arange(size, dtype=torch.float32) + 0.5
        return fma(i, torch.tensor(n_in / size, dtype=torch.float32), torch.tensor(-0.5))

    def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        # a * (1 - t) + b * t with the left product fused
        return fma(a, 1.0 - t, b * t)

    ys, xs = positions(h), positions(w)
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0f)[:, None], (xs - x0f)[None, :]
    y0, x0 = y0f.long(), x0f.long()
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    top, bot = gray[y0c], gray[y1c]
    top = lerp(top[:, x0c], top[:, x1c], wx)
    bot = lerp(bot[:, x0c], bot[:, x1c], wx)
    return lerp(top, bot, wy)


def recognize_face(
    model: LBPHModel,
    image: np.ndarray,
    label_map: Optional[dict[int, str]] = None,
    threshold: Optional[float] = None,
) -> dict:
    """One grayscale image through ``model.predict``: {'identity', 'label',
    'confidence', 'recognized'}, the confidence being the chi-square
    distance (lower is better); ``threshold`` overrides the model's for this
    call."""
    saved = model.threshold
    model.threshold = threshold if threshold is not None else saved
    try:
        label, conf = model.predict(image)
    finally:
        model.threshold = saved
    name = "Unknown"
    if label >= 0:
        name = label_map.get(label, str(label)) if label_map else str(label)
    return {
        "identity": name,
        "label": int(label),
        "confidence": float(conf),
        "recognized": label >= 0,
    }


def load_faces_capped(
    data_dir: str,
    image_size: int = 100,
    max_per_class: int = 30,
) -> tuple[np.ndarray, np.ndarray, dict[int, str]]:
    """(images (N, size, size) float32 gray, labels (N,) int64, label map)
    of a person-per-folder directory (``FolderDataset`` order), at most
    ``max_per_class`` readable images an identity; unreadable files are
    skipped."""
    index = FolderDataset(data_dir)
    images, labels = [], []
    counts: dict[int, int] = {}
    for path, label in zip(index.paths, index.labels):
        if counts.get(int(label), 0) >= max_per_class:
            continue
        try:
            img = load_image(path)
        except OSError:
            continue
        images.append(gray_face(img, image_size))
        labels.append(int(label))
        counts[int(label)] = counts.get(int(label), 0) + 1
    label_map = {i: n for i, n in enumerate(index.label_names)}
    return np.stack(images), np.asarray(labels, np.int64), label_map


def plot_confidence_histogram(
    confidences: Sequence[float],
    output_path: str,
    threshold: Optional[float] = None,
    bins: int = 30,
) -> str:
    """Histogram of LBPH distances, with the threshold marked when given,
    written to ``output_path`` (host only: matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 4))
    ax.hist(np.asarray(confidences), bins=bins, color="#4878cf", alpha=0.85)
    if threshold is not None:
        ax.axvline(threshold, color="r", linestyle="--", label=f"threshold = {threshold}")
        ax.legend()
    ax.set_xlabel("LBPH distance (lower = more confident)")
    ax.set_ylabel("count")
    d = os.path.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path

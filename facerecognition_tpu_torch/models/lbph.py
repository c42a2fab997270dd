"""LBPH face recognizer (OpenCV ``LBPHFaceRecognizer`` semantics) on the
card.

Counterpart of ``facerecognition_tpu/models/lbph.py``: the plain functions
``lbp_code_image``, ``spatial_histogram``, ``lbph_features`` and
``chi2_alt_distances`` (re-exported from ``ops/lbph_hist`` and
``ops/chi2_nn``), and ``LBPHModel``. On the card the features come from the
``lbph_hist`` kernel and the distances from ``chi2_nn``; on the CPU from
their plain versions. Codes, histograms and the saved ``.npz`` are JAX's
bits, so a model saved by one package loads in the other.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device
from facerecognition_tpu_torch.ops.chi2_nn import chi2_alt_distances, chi2_nn, chi2_row_stats
from facerecognition_tpu_torch.ops.lbph_hist import lbp_code_image, lbph_hist, spatial_histogram

__all__ = [
    "LBPHModel",
    "chi2_alt_distances",
    "lbp_code_image",
    "lbph_features",
    "spatial_histogram",
]


def lbph_features(
    gray: torch.Tensor,
    radius: int = 1,
    neighbors: int = 8,
    grid_x: int = 8,
    grid_y: int = 8,
    num_patterns: int = 256,
) -> torch.Tensor:
    """LBP codes and cell histograms of one (H, W) image: (grid_y·grid_x·
    num_patterns,) float32."""
    return spatial_histogram(lbp_code_image(gray, radius, neighbors), grid_x, grid_y, num_patterns)


class LBPHModel:
    """Train / predict / save / load over LBP histograms, as the JAX model.

    ``predict`` gives (label, distance) of the nearest training histogram,
    label -1 when the distance is not below ``threshold``;
    ``predict_topk`` each identity's best distance, ascending;
    ``predict_batch`` the nearest rows of a batch. ``histograms`` (N, F)
    float32 and ``labels`` (N,) int64 are numpy arrays, as in the JAX model;
    the histograms also stay on ``device`` (``device=None``: the card) as
    the gallery the matcher reads, on the card with its ``chi2_row_stats``
    (the masks of non-zero bins and the row sums), computed whenever the
    gallery changes.
    """

    def __init__(
        self,
        radius: int = 1,
        neighbors: int = 8,
        grid_x: int = 8,
        grid_y: int = 8,
        threshold: float = float("inf"),
        device: DeviceLike = None,
    ):
        self.radius = radius
        self.neighbors = neighbors
        self.grid_x = grid_x
        self.grid_y = grid_y
        self.threshold = threshold
        self.device = resolve_device(device)
        self.labels: Optional[np.ndarray] = None
        self._gallery: Optional[torch.Tensor] = None  # (N, F) on the device
        self._stats: Optional[tuple[torch.Tensor, torch.Tensor]] = None  # chi2_row_stats(_gallery)
        self._host: Optional[np.ndarray] = None

    @property
    def num_patterns(self) -> int:
        return 2**self.neighbors

    @property
    def histograms(self) -> Optional[np.ndarray]:
        """(N, F) float32 training histograms (copied from the device on
        first read)."""
        if self._host is None and self._gallery is not None:
            self._host = self._gallery.cpu().numpy()
        return self._host

    @histograms.setter
    def histograms(self, value) -> None:
        host = None if value is None else np.ascontiguousarray(value, np.float32)
        self._set_gallery(None if host is None else torch.as_tensor(host, device=self.device))
        self._host = host

    def _set_gallery(self, gallery: Optional[torch.Tensor], stats=None) -> None:
        """The gallery and, on the card, its stats (``stats``, or computed
        here); the plain version on the CPU reads none."""
        self._gallery, self._host = gallery, None
        if gallery is None or gallery.device.type == "cpu":
            self._stats = None
        else:
            self._stats = chi2_row_stats(gallery) if stats is None else stats

    def features(self, images, chunk: int = 4096) -> torch.Tensor:
        """(N, H, W) gray images (or one (H, W)), numpy or a tensor → (N, F)
        float32 histograms on the device, ``chunk`` images at a time."""
        if isinstance(images, torch.Tensor):
            arr = images.to(self.device, torch.float32)
        else:
            arr = np.asarray(images, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        parts = []
        for i in range(0, max(len(arr), 1), chunk):
            x = torch.as_tensor(arr[i : i + chunk], device=self.device).contiguous()
            parts.append(lbph_hist(x, self.radius, self.neighbors, self.grid_x, self.grid_y))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _compute_histograms(self, images, chunk: int = 4096) -> np.ndarray:
        """(N, F) histograms of a stack of images, on the host."""
        return self.features(images, chunk).cpu().numpy()

    def _trained(self) -> torch.Tensor:
        if self._gallery is None:
            raise RuntimeError("model not trained")
        return self._gallery

    def train(self, images, labels) -> None:
        """(Re)train from a stack of same-size grayscale images."""
        hist = self.features(images)
        lab = np.asarray(labels, dtype=np.int64).reshape(-1)
        if len(lab) != len(hist):  # validate before changing state
            raise ValueError("images and labels length mismatch")
        self._set_gallery(hist)
        self.labels = lab

    def update(self, images, labels) -> None:
        """Add samples (OpenCV ``update``)."""
        hist = self.features(images)
        lab = np.asarray(labels, dtype=np.int64).reshape(-1)
        if self._gallery is None:
            self._set_gallery(hist)
            self.labels = lab
        else:
            stats = None
            if self._stats is not None:
                stats = tuple(torch.cat(p) for p in zip(self._stats, chi2_row_stats(hist)))
            self._set_gallery(torch.cat([self._gallery, hist]), stats)
            self.labels = np.concatenate([self.labels, lab])

    def predict(self, image) -> tuple[int, float]:
        """Nearest training histogram of one grayscale image: (label or -1,
        distance)."""
        gallery = self._trained()
        best, idx = chi2_nn(self.features(image), gallery, gallery_stats=self._stats)
        conf = float(best[0])
        label = int(self.labels[int(idx[0])]) if conf < self.threshold else -1
        return label, conf

    def predict_topk(self, image, k: int = 5) -> list[tuple[int, float]]:
        """The k identities with the smallest distance over their samples,
        ascending; equal distances keep the order in which the identities
        first appear in the training set, as the JAX model's stable sort."""
        gallery = self._trained()
        _, _, dists = chi2_nn(self.features(image), gallery, return_distances=True,
                              gallery_stats=self._stats)
        best: dict[int, float] = {}
        for label, d in zip(self.labels, dists[0].cpu().numpy()):
            lab = int(label)
            if lab not in best or d < best[lab]:
                best[lab] = float(d)
        return sorted(best.items(), key=lambda t: t[1])[:k]

    def predict_batch(self, images, probe_chunk: int = 512) -> tuple[np.ndarray, np.ndarray]:
        """(labels, distances) of a batch: int64 labels (-1 at or above the
        threshold) and float64 distances, ``probe_chunk`` queries a call."""
        gallery = self._trained()
        feats = self.features(images)
        best_parts, conf_parts = [], []
        for i in range(0, len(feats), probe_chunk):
            conf, idx = chi2_nn(feats[i : i + probe_chunk], gallery, gallery_stats=self._stats)
            best_parts.append(idx.cpu().numpy())
            conf_parts.append(conf.cpu().numpy())
        best = np.concatenate(best_parts)
        conf = np.concatenate(conf_parts)
        labels = np.where(conf < self.threshold, self.labels[best], -1)
        return labels.astype(np.int64), conf.astype(np.float64)

    def save(self, path) -> None:
        """``.npz`` of the JAX model's layout."""
        np.savez(
            path,
            histograms=self.histograms,
            labels=self.labels,
            radius=self.radius,
            neighbors=self.neighbors,
            grid_x=self.grid_x,
            grid_y=self.grid_y,
            threshold=self.threshold,
        )

    @classmethod
    def load(cls, path, device: DeviceLike = None) -> "LBPHModel":
        p = str(path)
        if not p.endswith(".npz"):
            p_path = Path(p)
            if not p_path.exists() and p_path.with_suffix(".npz").exists():
                p = str(p_path.with_suffix(".npz"))
        data = np.load(p, allow_pickle=False)
        model = cls(
            radius=int(data["radius"]),
            neighbors=int(data["neighbors"]),
            grid_x=int(data["grid_x"]),
            grid_y=int(data["grid_y"]),
            threshold=float(data["threshold"]),
            device=device,
        )
        model.histograms = data["histograms"]
        model.labels = data["labels"]
        return model

"""Batch samplers: class-balanced and P×K (identities × images).

Counterpart of ``facerecognition_tpu/data/sampler.py``, numpy only: the same
seed gives the same index arrays.

- ``ClassBalancedSampler``: inverse-frequency weighted sampling with
  replacement (the ArcFace trainer's batches).
- ``PKSampler``: P identities × K images per batch for online triplet mining
  (the FaceNet trainer's batches).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from facerecognition_tpu_torch.data.datasets import DatasetIndex


class ClassBalancedSampler:
    """Yields index arrays of ``batch_size`` with inverse-class-frequency
    probabilities (with replacement)."""

    def __init__(self, index: DatasetIndex, batch_size: int, seed: int = 0):
        self.batch_size = batch_size
        counts = np.bincount(index.labels, minlength=index.num_classes)
        w = 1.0 / np.maximum(counts[index.labels], 1)
        self.p = w / w.sum()
        self.n = len(index)
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.rng.choice(self.n, size=self.batch_size, p=self.p)

    def epoch_batches(self) -> int:
        return max(self.n // self.batch_size, 1)


class PKSampler:
    """Yields index arrays of P identities × K images (flattened P*K).

    Identities with fewer than K images are sampled with replacement.
    """

    def __init__(
        self,
        index: DatasetIndex,
        p_identities: int = 8,
        k_images: int = 4,
        seed: int = 0,
    ):
        self.p = p_identities
        self.k = k_images
        self.rng = np.random.default_rng(seed)
        self.by_class: dict[int, np.ndarray] = {}
        for c in np.unique(index.labels):
            self.by_class[int(c)] = np.flatnonzero(index.labels == c)
        self.classes = np.asarray(sorted(self.by_class))
        if len(self.classes) < self.p:
            raise ValueError(
                f"need >= {self.p} identities, dataset has {len(self.classes)}"
            )
        self.labels = index.labels

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            chosen = self.rng.choice(self.classes, self.p, replace=False)
            batch = []
            for c in chosen:
                pool = self.by_class[int(c)]
                take = self.rng.choice(pool, self.k, replace=len(pool) < self.k)
                batch.append(take)
            yield np.concatenate(batch)

    def epoch_batches(self) -> int:
        return max(len(self.labels) // (self.p * self.k), 1)

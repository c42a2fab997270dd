"""Batch visualization: a grid of a loader batch with its label names,
and the augmented batch below it. Counterpart of
``facerecognition_tpu/data/visualize.py``; host only (matplotlib, Agg,
imported inside the function)."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def visualize_batch(
    images: np.ndarray,
    labels: np.ndarray,
    label_names: Optional[Sequence[str]] = None,
    output_path: str = "batch.png",
    max_images: int = 16,
    augmented: Optional[np.ndarray] = None,
) -> str:
    """Save a grid of batch images (optionally augmented pairs below)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = min(len(images), max_images)
    rows = 2 if augmented is not None else 1
    fig, axes = plt.subplots(rows, n, figsize=(1.6 * n, 1.8 * rows), squeeze=False)
    for i in range(n):
        ax = axes[0, i]
        ax.imshow(np.clip(images[i], 0, 255).astype(np.uint8))
        name = label_names[int(labels[i])] if label_names is not None else str(int(labels[i]))
        ax.set_title(name, fontsize=7)
        ax.axis("off")
        if augmented is not None:
            ax2 = axes[1, i]
            ax2.imshow(np.clip(augmented[i], 0, 255).astype(np.uint8))
            ax2.axis("off")
    d = os.path.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(output_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return output_path

"""LBPH convenience tools on image arrays.

Counterpart of ``facerecognition_tpu/models/lbph_tools.py``'s
``recognize_face``. ``load_faces_capped`` (it reads image folders) and
``plot_confidence_histogram`` (matplotlib) wait (ROADMAP): the port reads no
files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from facerecognition_tpu_torch.models.lbph import LBPHModel


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

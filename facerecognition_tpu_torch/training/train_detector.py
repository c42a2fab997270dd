"""The procedural face generator of the detector trainer.

Counterpart of ``synthetic_face_batch`` and ``MAX_GT`` in
``facerecognition_tpu/training/train_detector.py``, numpy only, so the
realtime app's ``SyntheticFrameSource`` draws the same frames as the JAX
package's for the same seed. The detector trainer itself is not ported yet.
"""

from __future__ import annotations

import numpy as np

MAX_GT = 4  # static per-image ground-truth face slots


def _np_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """IoU of one xyxy box against (N, 4) boxes."""
    ix = np.maximum(0.0, np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]))
    iy = np.maximum(0.0, np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]))
    inter = ix * iy
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(area + areas - inter, 1e-9)


def synthetic_face_batch(
    rng: np.random.Generator,
    batch: int,
    size: int = 128,
    p_face: float = 0.9,
    max_per_image: int = 1,
):
    """Procedural 'faces': skin ellipse + eyes/nose/mouth landmarks on noise.

    Places 1..max_per_image non-overlapping faces per image (w.p. p_face).
    Returns (images (B, S, S, 3) f32, gt_boxes (B, MAX_GT, 4),
    gt_lms (B, MAX_GT, 5, 2), gt_valid (B, MAX_GT) bool), drawing from
    ``rng`` in the JAX generator's order.
    """
    assert max_per_image <= MAX_GT
    imgs = rng.integers(0, 90, (batch, size, size, 3)).astype(np.float32)
    boxes = np.zeros((batch, MAX_GT, 4), np.float32)
    lms = np.zeros((batch, MAX_GT, 5, 2), np.float32)
    valid = np.zeros((batch, MAX_GT), bool)
    yy, xx = np.mgrid[0:size, 0:size]
    for b in range(batch):
        if rng.random() > p_face:
            continue
        # (no draw when single-face, which keeps the RNG stream stable)
        n_faces = 1 if max_per_image == 1 else int(rng.integers(1, max_per_image + 1))
        slot = 0
        for _ in range(n_faces * 4):  # rejection-sample placements
            if slot >= n_faces:
                break
            rmax = size * (0.3 if n_faces == 1 else 0.18)
            r = rng.uniform(size * 0.12, rmax)
            cx = rng.uniform(r + 2, size - r - 2)
            cy = rng.uniform(r + 2, size - r - 2)
            box = np.array([cx - r, cy - 1.25 * r, cx + r, cy + 1.25 * r])
            if slot and _np_iou(box, boxes[b, :slot]).max() > 0.05:
                continue
            skin = np.array([rng.uniform(170, 230), rng.uniform(120, 180), rng.uniform(90, 140)])
            mask = ((xx - cx) / r) ** 2 + ((yy - cy) / (1.25 * r)) ** 2 <= 1.0
            imgs[b][mask] = skin + rng.normal(0, 6, 3)
            # landmarks in the canonical face layout
            eye_y = cy - 0.35 * r
            lm = np.array([
                [cx - 0.45 * r, eye_y],
                [cx + 0.45 * r, eye_y],
                [cx, cy + 0.15 * r],
                [cx - 0.35 * r, cy + 0.65 * r],
                [cx + 0.35 * r, cy + 0.65 * r],
            ])
            for k, (lx, ly) in enumerate(lm):
                ix, iy = int(lx), int(ly)
                rad = max(1, int(r * 0.1))
                m2 = (xx - ix) ** 2 + (yy - iy) ** 2 <= rad * rad
                imgs[b][m2] = 25.0 if k < 2 else (80.0 if k == 2 else 50.0)
            boxes[b, slot] = box
            lms[b, slot] = lm
            valid[b, slot] = True
            slot += 1
    return imgs, boxes, lms, valid

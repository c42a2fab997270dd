"""Out-of-distribution scene families: generator parameterizations held
OUT of every detector/embedder training curriculum.

Counterpart of ``facerecognition_tpu/training/ood_faces.py``, drawn in its
order from the same generator, with the port's rasteriser
(``training/raster``) where the JAX module calls OpenCV.

The detector and the synthid embedder train exclusively on
``synthetic_faces.render_scene`` / ``sample_identity`` draws. Held-out
*seeds* of the same generator measure memorization, not generality — the
strongest generality proxy this (photo-less) environment allows is entire
parameter FAMILIES the curricula never sampled. Each family below moves a
different axis strictly outside its training range (ranges quoted from
synthetic_faces.py):

- ``pose``          rotation ±32..50° (training: ±30), face fraction
                    0.10..0.15 or 0.80..0.90 of the frame (training:
                    0.16..0.80).
- ``illumination``  gain 0.30..0.50 or 1.40..1.80 (training: 0.55..1.35),
                    bias ±45..80 (training: −30..45), per-channel cast
                    0.70..0.88 or 1.12..1.30 (training: 0.9..1.1), always-on
                    vignette at 0.45 strength (training: 0.25, p=0.3).
- ``appearance``    identities outside ``sample_identity``: head aspect
                    1.02..1.13 or 1.47..1.60 (training: 1.15..1.45),
                    gray/white hair (training: dark or blond only),
                    green/cool skin ratios (training pins a warm melanin
                    axis), glasses always on, thick brows, wide mouths.
- ``background``    scene classes ``_background`` never draws:
                    checkerboards, hard stripes, concentric circles, dense
                    skin-tone blob fields (5..9 blobs vs training's single
                    optional blob).
- ``degradation``   blur sigma 1.8..3.2 (training: 0.4..1.6), sensor noise
                    sigma 9..20 (training: 1..8), JPEG quality 8..22
                    (training: 25..90).

Scenes are single-face with GT (box, landmarks) in the training format, so
the same eval code runs on both distributions (scripts/ood_eval.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from facerecognition_tpu_torch.training import raster
from facerecognition_tpu_torch.training.synthetic_faces import (
    MAX_GT,
    FaceParams,
    _background,
    place_face,
    render_face_patch,
    sample_identity,
)

OOD_FAMILIES = (
    "pose",
    "illumination",
    "appearance",
    "background",
    "degradation",
)


def sample_identity_ood(rng: np.random.Generator) -> FaceParams:
    """An identity whose appearance axes sit OUTSIDE sample_identity's
    ranges (see module docstring) — the embedder's OOD probe population."""
    p = sample_identity(rng)
    # Head geometry outside 1.15..1.45.
    aspect = (
        rng.uniform(1.02, 1.13) if rng.random() < 0.5 else rng.uniform(1.47, 1.60)
    )
    # Gray/white hair: near-achromatic bright — training hair is dark
    # (15..70) or a warm blond ratio, never this.
    g = rng.uniform(185, 245)
    hair = np.clip(g * rng.uniform(0.96, 1.04, 3), 0, 255)
    # Cool/green-shifted skin: training fixes R≈base with G/R in 0.72..0.92
    # and B/R in 0.55..0.82; here G ≥ R and B is high.
    base = rng.uniform(80, 225)
    skin = np.clip(
        np.array(
            [
                base * rng.uniform(0.80, 0.95),
                base * rng.uniform(0.95, 1.05),
                base * rng.uniform(0.70, 0.95),
            ]
        ),
        25,
        250,
    )
    return dataclasses.replace(
        p,
        aspect=aspect,
        hair=hair,
        brow_color=np.clip(hair * 0.8, 10, 255),
        skin=skin,
        glasses=True,
        headset=rng.random() < 0.5,
        brow_thick=rng.uniform(0.10, 0.15),
        mouth_w=rng.uniform(0.38, 0.46),
    )


def _ood_background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Background classes `_background` never draws."""
    kind = int(rng.integers(0, 4))
    if kind == 0:  # checkerboard
        cell = int(rng.integers(6, max(7, size // 6)))
        a, b = rng.uniform(0, 255, (2, 3))
        yy, xx = np.mgrid[0:size, 0:size]
        mask = (((yy // cell) + (xx // cell)) % 2).astype(np.float32)[..., None]
        bg = a[None, None] * (1 - mask) + b[None, None] * mask
    elif kind == 1:  # hard stripes
        period = int(rng.integers(5, max(6, size // 8)))
        a, b = rng.uniform(0, 255, (2, 3))
        t = (np.arange(size) // period) % 2
        row = a[None] * (1 - t)[:, None] + b[None] * t[:, None]
        bg = (
            np.tile(row[None, :, :], (size, 1, 1))
            if rng.random() < 0.5
            else np.tile(row[:, None, :], (1, size, 1))
        )
        bg = bg.astype(np.float32)
    elif kind == 2:  # concentric circles
        bg = np.ones((size, size, 3), np.float32) * rng.uniform(0, 255, 3)
        c = (int(rng.uniform(0.2, 0.8) * size), int(rng.uniform(0.2, 0.8) * size))
        col = tuple(float(v) for v in rng.uniform(0, 255, 3))
        for r in range(int(size * 0.7), 0, -int(rng.integers(8, 20))):
            col = tuple(float(v) for v in rng.uniform(0, 255, 3))
            raster.circle(bg, c, r, col, -1)
    else:  # dense skin-tone blob field (training shows at most ONE blob)
        bg = _background(rng, size)
        for _ in range(int(rng.integers(5, 10))):
            b0 = rng.uniform(80, 230)
            col = (b0, b0 * rng.uniform(0.72, 0.92), b0 * rng.uniform(0.55, 0.8))
            c = (int(rng.uniform(0, size)), int(rng.uniform(0, size)))
            ax = (
                int(rng.uniform(size * 0.05, size * 0.25)),
                int(rng.uniform(size * 0.05, size * 0.25)),
            )
            raster.ellipse(bg, c, ax, rng.uniform(0, 180), 0, 360, col, -1)
    return np.clip(bg, 0, 255).astype(np.float32)


def ood_render_scene(
    rng: np.random.Generator, size: int = 128, family: str = "pose"
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One single-face OOD scene; same return contract as render_scene."""
    if family not in OOD_FAMILIES:
        raise ValueError(f"unknown OOD family {family!r} (use {OOD_FAMILIES})")

    p = sample_identity_ood(rng) if family == "appearance" else sample_identity(rng)
    canvas = (
        _ood_background(rng, size)
        if family == "background"
        else _background(rng, size)
    )

    patch = 160
    img, a, lm, hbox = render_face_patch(rng, p, patch)
    if family == "pose":
        rot = rng.uniform(32, 50) * (1 if rng.random() < 0.5 else -1)
        frac = (
            rng.uniform(0.10, 0.15)
            if rng.random() < 0.5
            else rng.uniform(0.80, 0.90)
        )
    else:  # in-distribution placement; the OOD axis is elsewhere
        rot = rng.uniform(-25, 25)
        frac = rng.uniform(0.20, 0.70)
    scale = frac * size / (2 * patch * 0.27)
    # Keep the (possibly near-full-frame) face centered enough to stay
    # inside the canvas — recall failures should be the family's doing,
    # not truncation's.
    lo, hi = (0.35, 0.65) if frac > 0.7 else (0.18, 0.82)
    ccx = rng.uniform(lo * size, hi * size)
    ccy = rng.uniform(lo * size, hi * size)
    tx, ty = ccx - patch / 2, ccy - patch * 0.44
    lm_o, box_o = place_face(canvas, img, a, lm, hbox, scale, rot, tx, ty)

    boxes = np.zeros((MAX_GT, 4), np.float32)
    lms = np.zeros((MAX_GT, 5, 2), np.float32)
    valid = np.zeros((MAX_GT,), bool)
    boxes[0], lms[0], valid[0] = box_o, lm_o, True

    # --- photometric pipeline, family-dependent ----------------------------
    if family == "illumination":
        gain = rng.uniform(0.30, 0.50) if rng.random() < 0.5 else rng.uniform(1.40, 1.80)
        bias = rng.uniform(45, 80) * (1 if rng.random() < 0.5 else -1)
        lo_c, hi_c = (0.70, 0.88) if rng.random() < 0.5 else (1.12, 1.30)
        cast = rng.uniform(lo_c, hi_c, 3)
        canvas = canvas * gain * cast[None, None] + bias
        t = np.linspace(-1, 1, size, dtype=np.float32)
        gx, gy = np.meshgrid(t, t)
        direction = rng.uniform(-1, 1, 2)
        shade = 1 + 0.45 * (gx * direction[0] + gy * direction[1])
        canvas = canvas * shade[..., None]
    else:
        gain = rng.uniform(0.7, 1.25)
        bias = rng.uniform(-20, 30)
        cast = rng.uniform(0.94, 1.06, 3)
        canvas = canvas * gain * cast[None, None] + bias

    if family == "degradation":
        canvas = raster.gaussian_blur(canvas, rng.uniform(1.8, 3.2))
        canvas = canvas + rng.normal(0, rng.uniform(9, 20), canvas.shape)
        canvas = np.clip(canvas, 0, 255)
        quality = int(rng.integers(8, 23))
        canvas = raster.jpeg_roundtrip(canvas.astype(np.uint8), quality)
    else:
        if rng.random() < 0.4:
            canvas = raster.gaussian_blur(canvas, rng.uniform(0.4, 1.2))
        if rng.random() < 0.5:
            canvas = canvas + rng.normal(0, rng.uniform(1, 6), canvas.shape)

    return (
        np.clip(canvas, 0, 255).astype(np.float32),
        boxes,
        lms,
        valid,
    )


def ood_scene_batch(
    rng: np.random.Generator, batch: int, size: int = 128, family: str = "pose"
):
    """Batched :func:`ood_render_scene` (same contract as scene_batch)."""
    imgs = np.empty((batch, size, size, 3), np.float32)
    boxes = np.empty((batch, MAX_GT, 4), np.float32)
    lms = np.empty((batch, MAX_GT, 5, 2), np.float32)
    valid = np.empty((batch, MAX_GT), bool)
    for b in range(batch):
        imgs[b], boxes[b], lms[b], valid[b] = ood_render_scene(rng, size, family)
    return imgs, boxes, lms, valid

"""The procedural face-scene generator: the detector and recognizer curriculum.

Counterpart of ``facerecognition_tpu/training/synthetic_faces.py``: the same
identities, faces, backgrounds, scenes and aligned identity samples, drawn
from a ``numpy.random.Generator`` in the JAX module's order, so a seed gives
the same geometry, labels and generator state in both packages. Where the
JAX module calls OpenCV, this one calls the port's rasteriser
(``training/raster``, host C++ that releases the GIL); how its pixels
compare with OpenCV's is in ROADMAP.md ("Known differences of the
renderer"). Everything here runs on the host; the card takes the rendered
batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from facerecognition_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE
from facerecognition_tpu_torch.training import raster

MAX_GT = 4  # static per-image ground-truth slots (matches train_detector)


@dataclasses.dataclass(frozen=True)
class SceneRanges:
    """Geometric/photometric sampling ranges for :func:`render_scene`.

    The defaults are the v3 curriculum (what `detector_v3_128` trained on).
    ``RANGES_V4`` widens exactly the two axes the round-4 OOD eval found
    under-covered (`docs/OOD_EVAL.json`: pose 88.5%, illumination 87.5%
    recall): in-plane rotation / face fraction and gain/bias/cast/vignette.
    The appearance, background and degradation OOD families are
    intentionally NOT folded in — they stay held-out generality probes.
    """

    rot: float = 30.0  # max |in-plane rotation| in degrees
    frac_single: tuple[float, float] = (0.16, 0.80)  # single-face width frac
    gain: tuple[float, float] = (0.55, 1.35)
    bias: tuple[float, float] = (-30.0, 45.0)
    cast: tuple[float, float] = (0.9, 1.1)  # per-channel color gain
    vignette_p: float = 0.3
    vignette: tuple[float, float] = (0.25, 0.25)  # directional shade strength


RANGES_V3 = SceneRanges()
RANGES_V4 = SceneRanges(
    rot=55.0,
    frac_single=(0.09, 0.92),
    gain=(0.28, 1.85),
    bias=(-85.0, 85.0),
    cast=(0.68, 1.32),
    vignette_p=0.5,
    vignette=(0.10, 0.50),
)
# "v3+v4": per-scene 50/50 mixture (scene_batch) — consolidation training
# that keeps v3-envelope density while covering the widened extremes.
SCENE_RANGES = {
    "v3": RANGES_V3,
    "v4": RANGES_V4,
    "v3+v4": (RANGES_V3, RANGES_V4),
}

# Canonical landmark layout inside the rendered patch, as fractions of the
# face half-width r relative to the face center: [left eye, right eye, nose,
# left mouth corner, right mouth corner]. Matches the ARCFACE_TEMPLATE
# proportions (ops/umeyama.py:19-28) so aligned crops look like real aligned
# faces.
_LM_LAYOUT = np.array(
    [
        [-0.42, -0.30],
        [0.42, -0.30],
        [0.00, 0.12],
        [-0.32, 0.55],
        [0.32, 0.55],
    ],
    np.float32,
)


@dataclasses.dataclass
class FaceParams:
    """Identity-defining appearance/geometry (fixed per identity)."""

    skin: np.ndarray  # RGB float
    aspect: float  # head ellipse height / width
    eye_dx: float  # eye half-spacing / r
    eye_y: float  # eye row offset / r (negative = above center)
    eye_w: float  # eye half-width / r
    eye_h: float  # eye half-height / r
    iris: np.ndarray  # iris RGB
    brow_color: np.ndarray
    brow_thick: float  # / r
    brow_lift: float  # distance above the eyes / r
    nose_len: float  # nose tip offset below eye row / r
    nose_shade: float  # 0..1 shading strength
    mouth_w: float  # mouth half-width / r
    mouth_y: float  # mouth row offset / r
    lip: np.ndarray  # lip RGB
    hair: np.ndarray  # hair RGB
    hair_top: float  # hair cap thickness / r (0 = bald)
    fringe: float  # fringe reach toward the eyes, 0..1
    hair_side: float  # how far the hair drops along the sides / r
    jaw: float  # chin narrowing 0..1
    glasses: bool
    headset: bool
    shirt: np.ndarray  # torso RGB


def sample_identity(rng: np.random.Generator) -> FaceParams:
    """Draw one identity's parameters (wide, loosely realistic ranges)."""
    # Skin across light..dark tones, roughly along a melanin axis.
    base = rng.uniform(70, 235)
    skin = np.array(
        [
            base * rng.uniform(0.98, 1.06),
            base * rng.uniform(0.72, 0.92),
            base * rng.uniform(0.55, 0.82),
        ]
    )
    dark_hair = rng.random() < 0.75
    hair = (
        rng.uniform(15, 70, 3)
        if dark_hair
        else np.array(
            [rng.uniform(120, 230), rng.uniform(90, 190), rng.uniform(40, 140)]
        )
    )
    return FaceParams(
        skin=np.clip(skin, 30, 250),
        aspect=rng.uniform(1.15, 1.45),
        eye_dx=rng.uniform(0.36, 0.48),
        eye_y=rng.uniform(-0.36, -0.24),
        eye_w=rng.uniform(0.13, 0.20),
        eye_h=rng.uniform(0.05, 0.10),
        iris=rng.uniform(15, 90, 3),
        brow_color=np.clip(hair * rng.uniform(0.6, 1.0), 10, 255),
        brow_thick=rng.uniform(0.03, 0.09),
        brow_lift=rng.uniform(0.13, 0.24),
        nose_len=rng.uniform(0.35, 0.50),
        nose_shade=rng.uniform(0.2, 0.7),
        mouth_w=rng.uniform(0.24, 0.38),
        mouth_y=rng.uniform(0.50, 0.62),
        lip=np.array(
            [rng.uniform(120, 200), rng.uniform(60, 110), rng.uniform(60, 110)]
        ),
        hair=hair,
        hair_top=rng.uniform(0.0, 0.55) if rng.random() < 0.9 else 0.0,
        fringe=rng.uniform(0.0, 0.9),
        hair_side=rng.uniform(0.0, 1.3),
        jaw=rng.uniform(0.0, 0.5),
        glasses=rng.random() < 0.18,
        headset=rng.random() < 0.12,
        shirt=rng.uniform(20, 200, 3),
    )


def render_face_patch(
    rng: np.random.Generator, p: FaceParams, patch: int = 160
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Render one face on a transparent patch.

    Returns (img (P, P, 3) f32 RGB, alpha (P, P) f32 0..1, lm (5, 2) px,
    head_box (4,) xyxy px). The head box is the tight ellipse bound — the
    detector's GT box convention.
    """
    s = patch
    cx, cy = s * 0.5, s * 0.44
    r = s * 0.27  # face half-width
    ry = r * p.aspect
    img = np.zeros((s, s, 3), np.float32)
    alpha = np.zeros((s, s), np.float32)
    # The strokes are recorded in order and drawn by one native call at the
    # end (nothing reads the patch before then).
    draw = raster.DrawList()
    IMG, ALPHA = 0, 1

    def ellipse(center, axes, color, mask=True, thickness=-1, angle=0.0):
        draw.ellipse(
            IMG,
            (int(round(center[0])), int(round(center[1]))),
            (max(1, int(round(axes[0]))), max(1, int(round(axes[1])))),
            angle,
            0,
            360,
            tuple(float(c) for c in color),
            thickness,
        )
        if mask:
            draw.ellipse(
                ALPHA,
                (int(round(center[0])), int(round(center[1]))),
                (max(1, int(round(axes[0]))), max(1, int(round(axes[1])))),
                angle,
                0,
                360,
                1.0,
                thickness,
            )

    # Torso / shoulders (so heads don't float on backgrounds).
    ellipse((cx, cy + ry + s * 0.33), (s * 0.42, s * 0.30), p.shirt)
    # Shirt collar triangle.
    collar = p.shirt * 0.5 + 120
    draw.fill_poly(
        IMG,
        (
            np.array(
                [
                    [cx - r * 0.45, cy + ry * 0.95],
                    [cx + r * 0.45, cy + ry * 0.95],
                    [cx, cy + ry * 1.45],
                ],
                np.int32,
            )
        ),
        tuple(float(c) for c in collar),
    )
    # Neck.
    ellipse((cx, cy + ry * 0.95), (r * 0.38, ry * 0.40), p.skin * 0.96)

    # Ears.
    ear_y = cy + p.eye_y * r * 0.3
    ellipse((cx - r * 0.98, ear_y), (r * 0.14, r * 0.24), p.skin * 0.97)
    ellipse((cx + r * 0.98, ear_y), (r * 0.14, r * 0.24), p.skin * 0.97)

    # Head. Jaw narrowing approximated by a second, narrower lower ellipse.
    ellipse((cx, cy), (r, ry), p.skin)
    if p.jaw > 0:
        ellipse(
            (cx, cy + ry * 0.18),
            (r * (1 - 0.18 * p.jaw), ry * 0.92),
            p.skin,
            mask=False,
        )

    # Cheek/forehead shading: one soft darker ellipse on a random side.
    side = 1 if rng.random() < 0.5 else -1
    shade = np.clip(p.skin * rng.uniform(0.82, 0.95), 0, 255)
    ellipse(
        (cx + side * r * 0.45, cy + ry * 0.1),
        (r * 0.5, ry * 0.7),
        shade,
        mask=False,
    )
    # Re-assert base skin in the center so shading reads as a gradient.
    ellipse((cx - side * r * 0.15, cy), (r * 0.55, ry * 0.75), p.skin, mask=False)

    # Hair BEFORE the facial features (the forehead-reveal repaints skin over
    # the face interior — features must come after or they'd be erased).
    eye_row = cy + p.eye_y * r
    if p.hair_top > 0:
        hr = r * 1.06
        hry = ry * 1.08
        draw.ellipse(
            IMG,
            (int(cx), int(cy)),
            (int(hr), int(hry)),
            0,
            180,
            360,
            tuple(float(c) for c in p.hair),
            -1,
        )
        draw.ellipse(
            ALPHA,
            (int(cx), int(cy)),
            (int(hr), int(hry)),
            0,
            180,
            360,
            1.0,
            -1,
        )
        # Reveal forehead: skin ellipse whose top edge sets hairline height.
        hairline = cy - ry * (1 - p.hair_top * 0.5)
        fringe_drop = p.fringe * (eye_row - p.brow_lift * r * 1.4 - hairline)
        ellipse(
            (cx, (hairline + fringe_drop + cy + ry) / 2),
            (r * 0.92, (cy + ry - hairline - fringe_drop) / 2),
            p.skin,
            mask=False,
        )
        if p.hair_side > 0:
            for sgn in (-1, 1):
                draw.ellipse(
                    IMG,
                    (int(cx + sgn * r * 0.92), int(cy + ry * (p.hair_side - 0.6))),
                    (int(r * 0.18), int(ry * 0.55 * min(p.hair_side, 1.0) + 2)),
                    0,
                    0,
                    360,
                    tuple(float(c) for c in p.hair),
                    -1,
                )
                draw.ellipse(
                    ALPHA,
                    (int(cx + sgn * r * 0.92), int(cy + ry * (p.hair_side - 0.6))),
                    (int(r * 0.18), int(ry * 0.55 * min(p.hair_side, 1.0) + 2)),
                    0,
                    0,
                    360,
                    1.0,
                    -1,
                )

    lm = _LM_LAYOUT.copy()
    lm[:, 0] = cx + lm[:, 0] * r * (p.eye_dx / 0.42)
    lm[:, 1] = cy + lm[:, 1] * r
    # Per-identity vertical tweaks.
    lm[0, 1] = lm[1, 1] = cy + p.eye_y * r
    lm[2, 1] = cy + (p.eye_y + p.nose_len) * r
    lm[3, 1] = lm[4, 1] = cy + p.mouth_y * r
    lm[3, 0] = cx - p.mouth_w * r
    lm[4, 0] = cx + p.mouth_w * r

    ex_l, ex_r = lm[0, 0], lm[1, 0]
    ey = lm[0, 1]
    ew, eh = p.eye_w * r, p.eye_h * r

    # Brows.
    for ex in (ex_l, ex_r):
        draw.line(
            IMG,
            (int(ex - ew * 1.2), int(ey - p.brow_lift * r)),
            (int(ex + ew * 1.2), int(ey - p.brow_lift * r - rng.uniform(-2, 2))),
            tuple(float(c) for c in p.brow_color),
            max(1, int(p.brow_thick * r * 2)),
        )
    # Eyes: sclera, iris, pupil.
    blink = rng.random() < 0.05
    for ex in (ex_l, ex_r):
        if blink:
            draw.line(
                IMG,
                (int(ex - ew), int(ey)),
                (int(ex + ew), int(ey)),
                (40, 30, 30),
                2,
            )
            continue
        ellipse((ex, ey), (ew, eh), (235, 232, 228), mask=False)
        gaze = rng.uniform(-0.3, 0.3) * ew
        ellipse((ex + gaze, ey), (eh * 0.9, eh * 0.9), p.iris, mask=False)
        ellipse((ex + gaze, ey), (eh * 0.45, eh * 0.45), (12, 10, 10), mask=False)

    # Nose: shading stroke + nostrils + tip highlight.
    nx, ny = lm[2]
    nose_c = np.clip(p.skin * (1 - 0.25 * p.nose_shade), 0, 255)
    draw.line(
        IMG,
        (int(nx), int(ey + eh)),
        (int(nx), int(ny)),
        tuple(float(c) for c in nose_c),
        max(1, int(r * 0.07)),
    )
    for sgn in (-1, 1):
        ellipse(
            (nx + sgn * r * 0.10, ny + r * 0.02),
            (r * 0.035, r * 0.025),
            np.clip(p.skin * 0.55, 0, 255),
            mask=False,
        )

    # Mouth: lips + darker center line; expression = openness/curve jitter.
    mw = p.mouth_w * r
    my = lm[3, 1]
    openness = rng.uniform(0.04, 0.14)
    ellipse((cx, my), (mw, openness * r + r * 0.045), p.lip, mask=False)
    draw.line(
        IMG,
        (int(cx - mw), int(my)),
        (int(cx + mw), int(my + rng.uniform(-1.5, 1.5))),
        tuple(float(c) for c in np.clip(p.lip * 0.55, 0, 255)),
        max(1, int(r * 0.035)),
    )

    # Accessories.
    if p.glasses:
        gc = tuple(float(c) for c in rng.uniform(10, 80, 3))
        for ex in (ex_l, ex_r):
            draw.ellipse(
                IMG,
                (int(ex), int(ey)),
                (int(ew * 1.5), int(eh * 2.2)),
                0, 0, 360, gc, 2,
            )
        draw.line(IMG, (int(ex_l + ew * 1.5), int(ey)), (int(ex_r - ew * 1.5), int(ey)), gc, 2)
    if p.headset:
        hc = tuple(float(c) for c in rng.uniform(10, 60, 3))
        for sgn in (-1, 1):
            draw.ellipse(
                IMG,
                (int(cx + sgn * r * 1.02), int(ear_y)),
                (int(r * 0.16), int(r * 0.26)),
                0, 0, 360, hc, -1,
            )
            draw.ellipse(
                ALPHA,
                (int(cx + sgn * r * 1.02), int(ear_y)),
                (int(r * 0.16), int(r * 0.26)),
                0, 0, 360, 1.0, -1,
            )
        draw.ellipse(
            IMG, (int(cx), int(cy - ry * 0.1)), (int(r * 1.1), int(ry * 1.05)),
            0, 200, 340, hc, 3,
        )

    draw.run(img, alpha)
    head_box = np.array([cx - r, cy - ry, cx + r, cy + ry], np.float32)
    return img, alpha, lm.astype(np.float32), head_box


def _background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random scene background (studio grays, gradients, noise, texture)."""
    kind = rng.random()
    if kind < 0.35:  # solid (incl. the bright studio gray of real portraits)
        col = rng.uniform(0, 255) * np.ones(3) + rng.uniform(-20, 20, 3)
        bg = np.ones((size, size, 3), np.float32) * col
    elif kind < 0.6:  # linear gradient
        a, b = rng.uniform(0, 255, (2, 3))
        t = np.linspace(0, 1, size, dtype=np.float32)
        if rng.random() < 0.5:
            t2 = np.tile(t[:, None], (1, size))
        else:
            t2 = np.tile(t[None, :], (size, 1))
        bg = (a[None, None] * (1 - t2[..., None]) + b[None, None] * t2[..., None])
    elif kind < 0.85:  # low-frequency blobs (defocused room)
        small = rng.uniform(0, 255, (rng.integers(2, 6), rng.integers(2, 6), 3))
        bg = raster.resize_cubic(small.astype(np.float32), (size, size))
    else:  # busy texture
        bg = rng.uniform(0, 255, (size, size, 3)).astype(np.float32)
        bg = raster.gaussian_blur(bg, rng.uniform(0.8, 2.5))
    # Optional distractor shapes (hard negatives living in the background).
    for _ in range(rng.integers(0, 4)):
        col = tuple(float(c) for c in rng.uniform(0, 255, 3))
        c = (int(rng.uniform(0, size)), int(rng.uniform(0, size)))
        ax = (int(rng.uniform(3, size * 0.3)), int(rng.uniform(3, size * 0.3)))
        if rng.random() < 0.5:
            raster.ellipse(bg, c, ax, rng.uniform(0, 180), 0, 360, col, -1)
        else:
            raster.rectangle(
                bg, (c[0] - ax[0], c[1] - ax[1]), (c[0] + ax[0], c[1] + ax[1]),
                col, -1,
            )
    return np.clip(bg, 0, 255)


def _skin_blob_negative(rng: np.random.Generator, bg: np.ndarray) -> None:
    """Paste a featureless skin-colored ellipse — a hard negative that keeps
    the detector from firing on any skin-toned region."""
    size = bg.shape[0]
    base = rng.uniform(80, 230)
    col = (base, base * rng.uniform(0.72, 0.92), base * rng.uniform(0.55, 0.8))
    c = (int(rng.uniform(0, size)), int(rng.uniform(0, size)))
    ax = (int(rng.uniform(size * 0.06, size * 0.3)),
          int(rng.uniform(size * 0.06, size * 0.3)))
    raster.ellipse(bg, c, ax, rng.uniform(0, 180), 0, 360, col, -1)


def place_face(
    canvas: np.ndarray,
    img: np.ndarray,
    alpha: np.ndarray,
    lm: np.ndarray,
    head_box: np.ndarray,
    scale: float,
    rot_deg: float,
    tx: float,
    ty: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Affine-place a rendered patch onto the canvas (in-place).

    Returns (lm (5,2), box (4,)) in canvas coordinates. The GT box is the
    axis-aligned envelope of the rotated head ellipse box.
    """
    patch = img.shape[0]
    size = canvas.shape[0]
    m = raster.rotation_matrix((patch / 2, patch / 2), rot_deg, scale)
    m[0, 2] += tx  # translate after the center-rotate/scale
    m[1, 2] += ty
    warped = raster.warp_affine(img, m, (size, size))
    a = raster.warp_affine(alpha, m, (size, size))
    a3 = a[..., None]
    canvas *= 1 - a3
    canvas += warped * a3

    ones = np.ones((5, 1), np.float32)
    lm_h = np.concatenate([lm, ones], 1)  # (5, 3)
    lm_out = lm_h @ m.T.astype(np.float32)  # (5, 2)
    x1, y1, x2, y2 = head_box
    corners = np.array(
        [[x1, y1, 1], [x2, y1, 1], [x1, y2, 1], [x2, y2, 1]], np.float32
    )
    c_out = corners @ m.T.astype(np.float32)
    box = np.array(
        [c_out[:, 0].min(), c_out[:, 1].min(), c_out[:, 0].max(), c_out[:, 1].max()],
        np.float32,
    )
    return lm_out.astype(np.float32), box


def render_scene(
    rng: np.random.Generator,
    size: int = 128,
    max_faces: int = 1,
    p_face: float = 0.92,
    identities: list[FaceParams] | None = None,
    ranges: SceneRanges | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One scene: background + 0..max_faces faces + photometric pipeline.

    Returns (img (S, S, 3) f32 RGB 0..255, boxes (MAX_GT, 4), lms
    (MAX_GT, 5, 2), valid (MAX_GT,) bool). ``ranges`` selects the sampling
    envelope (default v3; the RNG draw sequence under the default is
    byte-identical to the pre-SceneRanges generator, so seed-pinned evals
    and goldens are unaffected).
    """
    rr = RANGES_V3 if ranges is None else ranges
    max_faces = min(max_faces, MAX_GT)  # GT arrays have MAX_GT slots
    canvas = _background(rng, size)
    boxes = np.zeros((MAX_GT, 4), np.float32)
    lms = np.zeros((MAX_GT, 5, 2), np.float32)
    valid = np.zeros((MAX_GT,), bool)

    if rng.random() < 0.25:
        _skin_blob_negative(rng, canvas)

    if rng.random() < p_face:
        n = int(rng.integers(1, max_faces + 1)) if max_faces > 1 else 1
        patch = 160
        slot = 0
        for _ in range(n * 5):
            if slot >= n:
                break
            p = (
                identities[rng.integers(0, len(identities))]
                if identities
                else sample_identity(rng)
            )
            img, a, lm, hbox = render_face_patch(rng, p, patch)
            # Face width fraction of the frame: surveillance-scale small
            # faces up to near-full-frame tight crops (a portrait cropped to
            # the head puts the face at ~0.8 of the image — the v3 detector
            # mislocalized those until the curriculum covered them).
            # Multi-face scenes keep the v3 fraction window (0.16-0.34)
            # regardless of envelope: frac_single widens only the
            # single-face range, so v4's 0.09 floor must not leak into
            # crowd-scene statistics (ADVICE r4).
            frac_lo, frac_hi = (
                rr.frac_single if n == 1 else (0.16, 0.34)
            )
            frac = rng.uniform(frac_lo, frac_hi)
            scale = frac * size / (2 * patch * 0.27)
            # v3: ±30° covers the real-photo robustness matrix's rotation
            # sweep (docs/DETECTOR.md); v4 widens to ±55° for the OOD pose
            # family (the v2 curriculum stopped at ±22°).
            rot = rng.uniform(-rr.rot, rr.rot)
            # Pick the face-center target in frame coords; the patch center
            # stays fixed under raster.rotation_matrix, so translate by
            # (target - patch_center).
            ccx = rng.uniform(0.12 * size, 0.88 * size)
            ccy = rng.uniform(0.12 * size, 0.88 * size)
            tx, ty = ccx - patch / 2, ccy - patch * 0.44
            trial = canvas.copy()
            lm_o, box_o = place_face(trial, img, a, lm, hbox, scale, rot, tx, ty)
            # Require the face center inside the frame and overlap control.
            bcx = (box_o[0] + box_o[2]) / 2
            bcy = (box_o[1] + box_o[3]) / 2
            if not (0 <= bcx < size and 0 <= bcy < size):
                continue
            if slot:
                prev = boxes[:slot]
                ix1 = np.maximum(prev[:, 0], box_o[0])
                iy1 = np.maximum(prev[:, 1], box_o[1])
                ix2 = np.minimum(prev[:, 2], box_o[2])
                iy2 = np.minimum(prev[:, 3], box_o[3])
                inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
                area = (box_o[2] - box_o[0]) * (box_o[3] - box_o[1])
                if (inter / max(area, 1e-6)).max() > 0.1:
                    continue
            canvas = trial
            boxes[slot] = box_o
            lms[slot] = lm_o
            valid[slot] = True
            slot += 1

    # partial occlusion: an opaque bar/rectangle clipping a face region
    # (sunglasses / hand / foreground object — real-photo failure mode the
    # v2 curriculum never showed the detector)
    if valid.any() and rng.random() < 0.25:
        fb = boxes[int(rng.integers(0, int(valid.sum())))]
        bw, bh = fb[2] - fb[0], fb[3] - fb[1]
        if bw > 4 and bh > 4:
            ow = rng.uniform(0.25, 0.6) * bw
            oh = rng.uniform(0.12, 0.35) * bh
            ox = rng.uniform(fb[0] - 0.1 * bw, fb[2] - 0.4 * ow)
            oy = rng.uniform(fb[1], fb[3] - oh)
            color = rng.uniform(10, 220, 3)
            x1, y1 = int(max(ox, 0)), int(max(oy, 0))
            x2 = int(min(ox + ow, size))
            y2 = int(min(oy + oh, size))
            if x2 > x1 and y2 > y1:
                canvas[y1:y2, x1:x2] = color[None, None]

    # --- photometric pipeline (applies to the whole scene) -----------------
    # brightness / contrast / color cast
    gain = rng.uniform(*rr.gain)
    bias = rng.uniform(*rr.bias)
    cast = rng.uniform(rr.cast[0], rr.cast[1], 3)
    canvas = canvas * gain * cast[None, None] + bias
    # vignette / directional light
    if rng.random() < rr.vignette_p:
        # Degenerate interval skips the draw so the v3 RNG stream is
        # byte-identical to the pre-SceneRanges generator.
        strength = (
            rr.vignette[0]
            if rr.vignette[0] == rr.vignette[1]
            else rng.uniform(*rr.vignette)
        )
        t = np.linspace(-1, 1, size, dtype=np.float32)
        gx, gy = np.meshgrid(t, t)
        direction = rng.uniform(-1, 1, 2)
        shade = 1 + strength * (gx * direction[0] + gy * direction[1])
        canvas = canvas * shade[..., None]
    # blur (defocus / motion approximation)
    if rng.random() < 0.45:
        canvas = raster.gaussian_blur(canvas, rng.uniform(0.4, 1.6))
    # sensor noise
    if rng.random() < 0.6:
        canvas = canvas + rng.normal(0, rng.uniform(1, 8), canvas.shape)
    canvas = np.clip(canvas, 0, 255)
    # JPEG compression artifacts (webcam / recompressed uploads): block
    # ringing changes local statistics in a way gaussian noise does not.
    if rng.random() < 0.3:
        quality = int(rng.integers(25, 90))
        canvas = raster.jpeg_roundtrip(canvas.astype(np.uint8), quality)
    return canvas.astype(np.float32), boxes, lms, valid


def scene_batch(
    rng: np.random.Generator,
    batch: int,
    size: int = 128,
    max_faces: int = 1,
    p_face: float = 0.92,
    identities: list[FaceParams] | None = None,
    ranges: SceneRanges | tuple[SceneRanges, ...] | None = None,
):
    """Batched :func:`render_scene` — drop-in for detector training.

    ``ranges`` may be a tuple of envelopes: each scene then draws one
    uniformly (the "v3+v4" consolidation mixture).
    """
    imgs = np.empty((batch, size, size, 3), np.float32)
    boxes = np.empty((batch, MAX_GT, 4), np.float32)
    lms = np.empty((batch, MAX_GT, 5, 2), np.float32)
    valid = np.empty((batch, MAX_GT), bool)
    pool = ranges if isinstance(ranges, (tuple, list)) else None
    for b in range(batch):
        rr = pool[int(rng.integers(0, len(pool)))] if pool else ranges
        imgs[b], boxes[b], lms[b], valid[b] = render_scene(
            rng, size, max_faces, p_face, identities, rr
        )
    return imgs, boxes, lms, valid


def render_aligned_identity_sample(
    rng: np.random.Generator, p: FaceParams, out_size: int = 112
) -> np.ndarray:
    """Render one ALIGNED sample of an identity (what the embedder sees
    after detect→align at inference). Pose/photometrics vary per call.

    Uses the exact ARCFACE_TEMPLATE mapping (ops/umeyama.py:19-28 — the
    published 5-point standard) so training data matches serving alignment.
    """
    patch = 160
    img, a, lm, hbox = render_face_patch(rng, p, patch)
    bg = _background(rng, patch)
    a3 = a[..., None]
    scene = bg * (1 - a3) + img * a3
    # Random small pose perturbation of the landmarks BEFORE alignment (the
    # aligner will mostly undo it — residual is realistic alignment jitter).
    jitter = rng.normal(0, patch * 0.008, (5, 2)).astype(np.float32)
    src = lm + jitter
    dst = np.asarray(ARCFACE_TEMPLATE, np.float32) * (out_size / 112.0)
    m, _ = raster.estimate_affine_partial(src, dst)
    out = raster.warp_affine(scene, m, (out_size, out_size))
    # photometrics
    gain = rng.uniform(0.6, 1.3)
    bias = rng.uniform(-25, 35)
    cast = rng.uniform(0.92, 1.08, 3)
    out = out * gain * cast[None, None] + bias
    if rng.random() < 0.35:
        out = raster.gaussian_blur(out, rng.uniform(0.4, 1.3))
    if rng.random() < 0.5:
        out = out + rng.normal(0, rng.uniform(1, 7), out.shape)
    return np.clip(out, 0, 255).astype(np.float32)


def identity_dataset(
    n_identities: int,
    samples_per_identity: int,
    out_size: int = 112,
    seed: int = 0,
    workers: int = 8,
) -> tuple[np.ndarray, np.ndarray]:
    """Render an (N*K, S, S, 3) aligned synthetic-identity dataset + labels.

    The recognition-at-scale substitute for CelebA (BASELINE.md quality rows)
    in this dataset-free environment.
    """
    from concurrent.futures import ThreadPoolExecutor

    ids = [
        sample_identity(np.random.default_rng(seed * 100003 + i))
        for i in range(n_identities)
    ]

    def render_one(args):
        i, k = args
        r = np.random.default_rng((seed, i, k))
        return i * samples_per_identity + k, render_aligned_identity_sample(
            r, ids[i], out_size
        ), i

    total = n_identities * samples_per_identity
    imgs = np.empty((total, out_size, out_size, 3), np.uint8)  # RAM-frugal
    labels = np.empty((total,), np.int32)
    jobs = [(i, k) for i in range(n_identities) for k in range(samples_per_identity)]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for idx, img, lab in pool.map(render_one, jobs):
            imgs[idx] = img
            labels[idx] = lab
    return imgs, labels

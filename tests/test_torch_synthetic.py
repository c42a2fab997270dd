"""The port's procedural renderer against OpenCV and the JAX renderer.

``training/raster`` (host C++) is held to cv2 (5.0) primitive by
primitive: the drawing functions bit for bit wherever the renderer draws,
the resampling within stated bounds. ``training/synthetic_faces`` and
``ood_faces`` are held to the JAX modules seed by seed: the same generator
state after every call, the same geometry, ``valid`` and labels, pixels
within ``tools/scene_fixture``'s bounds (scenes that took the JPEG step
apart). Then the port's versions of the renderer's own contracts
(``tests/test_synthetic_faces.py``, ``tests/test_ood.py``) and the
committed fixture.
"""

from __future__ import annotations

import threading

import cv2
import numpy as np
import pytest

from facerecognition_tpu.training import ood_faces as jax_ood
from facerecognition_tpu.training import synthetic_faces as jax_sf
from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.tools import scene_fixture
from facerecognition_tpu_torch.training import ood_faces, raster, synthetic_faces
from facerecognition_tpu_torch.training.ood_faces import (
    OOD_FAMILIES,
    ood_render_scene,
    ood_scene_batch,
    sample_identity_ood,
)
from facerecognition_tpu_torch.training.synthetic_faces import (
    MAX_GT,
    RANGES_V3,
    RANGES_V4,
    SCENE_RANGES,
    SceneRanges,
    identity_dataset,
    render_aligned_identity_sample,
    render_scene,
    sample_identity,
    scene_batch,
)

DRAWS = 250  # seeded draws per primitive kind


def _color(rng, cn):
    return tuple(float(c) for c in rng.uniform(0, 255, 3)) if cn == 3 else float(rng.uniform(0, 1))


def _canvas(rng, cn, dtype):
    s = int(rng.integers(40, 170))
    shape = (s, s, 3) if cn == 3 else (s, s)
    img = rng.uniform(0, 255, shape).astype(dtype)
    return img, img.copy(), s


def _ellipse_fill(rng, s):
    c = (int(rng.integers(-40, s + 40)), int(rng.integers(-40, s + 40)))
    ax = (int(rng.integers(0, s)), int(rng.integers(0, s)))
    ang = float(rng.uniform(0, 360))
    return lambda m, img, col: m.ellipse(img, c, ax, ang, 0, 360, col, -1)


def _ellipse_arc_fill(rng, s):
    # arcs whose whole ellipse lies inside the canvas, as the renderer's hair
    ax = (int(rng.integers(0, s // 2 - 2)), int(rng.integers(0, s // 2 - 2)))
    r = max(ax)
    c = (int(rng.integers(r, s - r)), int(rng.integers(r, s - r)))
    start, end = ((180, 360), (200, 340))[int(rng.integers(0, 2))]
    ang = float(rng.uniform(0, 360))
    return lambda m, img, col: m.ellipse(img, c, ax, ang, start, end, col, -1)


def _ellipse_outline(rng, s):
    c = (int(rng.integers(-20, s + 20)), int(rng.integers(-20, s + 20)))
    ax = (int(rng.integers(1, s)), int(rng.integers(1, s)))
    start, end = ((0, 360), (180, 360), (200, 340))[int(rng.integers(0, 3))]
    th = int(rng.integers(1, 4))
    ang = float(rng.uniform(0, 360))
    return lambda m, img, col: m.ellipse(img, c, ax, ang, start, end, col, th)


def _triangle(rng, s):
    # the collar: inside the canvas across, below its bottom edge at most
    pts = np.stack([rng.integers(0, s, 3), rng.integers(0, s + s // 2, 3)], 1).astype(np.int32)

    def draw(m, img, col):
        if m is cv2:
            cv2.fillPoly(img, [pts], col)
        else:
            raster.fill_poly(img, pts, col)

    return draw


def _line(rng, s):
    th = int(rng.integers(1, 8))
    lo, hi = (-30, s + 30) if th == 1 else (4, s - 4)
    p1 = tuple(int(v) for v in rng.integers(lo, hi, 2))
    p2 = tuple(int(v) for v in rng.integers(lo, hi, 2))
    return lambda m, img, col: m.line(img, p1, p2, col, th)


def _rectangle(rng, s):
    p1 = tuple(int(v) for v in rng.integers(-30, s + 30, 2))
    p2 = tuple(int(v) for v in rng.integers(-30, s + 30, 2))
    return lambda m, img, col: m.rectangle(img, p1, p2, col, -1)


def _circle(rng, s):
    c = tuple(int(v) for v in rng.integers(-30, s + 30, 2))
    r = int(rng.integers(1, s))
    return lambda m, img, col: m.circle(img, c, r, col, -1)


BIT_EQUAL = {
    "ellipse_fill": _ellipse_fill,
    "ellipse_arc_fill": _ellipse_arc_fill,
    "ellipse_outline": _ellipse_outline,
    "fill_poly": _triangle,
    "line": _line,
    "rectangle": _rectangle,
    "circle": _circle,
}


@pytest.mark.parametrize("kind", sorted(BIT_EQUAL))
def test_drawing_bit_equal_to_cv2(kind):
    """Each drawing primitive on 3-channel and 1-channel (the alpha, the
    colour's first component), float32 and float64 canvases, where the
    renderer draws: the same pixels as cv2."""
    rng = np.random.default_rng(sorted(BIT_EQUAL).index(kind))
    for _ in range(DRAWS):
        cn = 3 if rng.random() < 0.7 else 1
        dtype = np.float32 if rng.random() < 0.6 else np.float64
        a, b, s = _canvas(rng, cn, dtype)
        col = _color(rng, cn)
        draw = BIT_EQUAL[kind](rng, s)
        draw(cv2, a, col)
        draw(raster, b, col)
        np.testing.assert_array_equal(a, b)


def test_ellipse_polygon_equals_cv2_ellipse2poly():
    """The polygon under every ellipse: OpenCV's float table of sines at
    whole degrees, each point rounded half to even, repeats dropped, as
    ``cv2.ellipse2Poly`` gives it (this pins the table, the angle
    normalisation and the arc's end)."""
    rng = np.random.default_rng(11)
    for _ in range(400):
        c = tuple(int(v) for v in rng.integers(-50, 200, 2))
        ax = tuple(int(v) for v in rng.integers(0, 3000, 2))
        ang = int(rng.integers(-400, 400))
        start, end = (int(v) for v in rng.integers(-400, 400, 2))
        delta = int(rng.choice([1, 5, 18, 30, 90]))
        want = cv2.ellipse2Poly(c, ax, ang, start, end, delta)
        pts = np.rint(raster.ellipse2poly(c, ax, ang, start, end, delta)).astype(np.int64)
        keep = np.ones(len(pts), bool)
        keep[1:] = (pts[1:] != pts[:-1]).any(axis=1)
        np.testing.assert_array_equal(pts[keep], want)


def _edge(mask: np.ndarray) -> np.ndarray:
    """Pixels of a mask with a neighbour (8-connected) on the other side."""
    p = np.pad(mask, 1, mode="edge")
    h, w = mask.shape
    out = np.zeros_like(mask)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] != mask
    return out


def _crossing_line(rng, s):
    th = int(rng.integers(2, 8))
    p1 = tuple(int(v) for v in rng.integers(-60, s + 60, 2))
    p2 = tuple(int(v) for v in rng.integers(-60, s + 60, 2))
    return lambda m, img: m.line(img, p1, p2, 1.0, th)


def _crossing_triangle(rng, s):
    pts = rng.integers(-60, s + 60, (3, 2)).astype(np.int32)
    return lambda m, img: cv2.fillPoly(img, [pts], 1.0) if m is cv2 else raster.fill_poly(img, pts, 1.0)


def _crossing_arc(rng, s):
    c = (int(rng.integers(-40, s + 40)), int(rng.integers(-40, s + 40)))
    ax = (int(rng.integers(1, s)), int(rng.integers(1, s)))
    start, end = ((180, 360), (200, 340))[int(rng.integers(0, 2))]
    ang = float(rng.uniform(0, 360))
    return lambda m, img: m.ellipse(img, c, ax, ang, start, end, 1.0, -1)


# Where the port's fills do not follow OpenCV 5 bit for bit (none of them
# drawn by the renderer, whose strokes stay inside the face patch): the
# most pixels seen to differ in one call over 600 seeded calls on a 128²
# canvas, a bound with margin, and every differing pixel on the boundary
# of one of the two drawings.
EDGE_CASES = {
    "thick_line_crossing_border": (_crossing_line, 209, 300),
    "triangle_crossing_sides": (_crossing_triangle, 118, 200),
    "arc_fill_crossing_border": (_crossing_arc, 39, 80),
}


@pytest.mark.parametrize("kind", sorted(EDGE_CASES))
def test_drawing_disagreement_only_at_edges(kind):
    make, _seen, bound = EDGE_CASES[kind]
    rng = np.random.default_rng(100 + sorted(EDGE_CASES).index(kind))
    for _ in range(200):
        a = np.zeros((128, 128), np.float32)
        b = a.copy()
        draw = make(rng, 128)
        draw(cv2, a)
        draw(raster, b)
        diff = a != b
        assert diff.sum() <= bound
        assert not (diff & ~(_edge(a > 0) | _edge(b > 0))).any()


def test_rotation_matrix_and_warp_bit_equal_to_cv2():
    """getRotationMatrix2D, and warpAffine INTER_LINEAR with the constant 0
    border: float32 (OpenCV 5's fma path) and float64 (fixed-point sample
    positions, the 32-step weight table) bit for bit."""
    rng = np.random.default_rng(7)
    for t in range(60):
        ang, sc = rng.uniform(-60, 60), rng.uniform(0.05, 1.2)
        m = cv2.getRotationMatrix2D((80.0, 80.0), ang, sc)
        np.testing.assert_array_equal(m, raster.rotation_matrix((80.0, 80.0), ang, sc))
        m[0, 2] += rng.uniform(-80, 60)
        m[1, 2] += rng.uniform(-80, 60)
        dtype = np.float32 if t % 2 else np.float64
        shape = (160, 160, 3) if t % 3 else (160, 160)
        src = rng.uniform(0, 255, shape).astype(dtype)
        size = int(rng.choice([112, 128, 160]))
        want = cv2.warpAffine(src, m, (size, size), flags=cv2.INTER_LINEAR)
        got = raster.warp_affine(src, m, (size, size))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,bound", [(np.float32, 2e-4), (np.float64, 1e-9)])
def test_gaussian_blur_within_bound(dtype, bound):
    """GaussianBlur(img, (0, 0), sigma): OpenCV's kernel (size and taps),
    reflect-101 border; the summation order differs (largest seen: 9.2e-5
    levels in float32, 2.3e-13 in float64)."""
    rng = np.random.default_rng(8)
    for sigma in rng.uniform(0.4, 3.2, 40):
        n = int(round(sigma * 8 + 1)) | 1
        np.testing.assert_allclose(raster.gaussian_kernel(sigma),
                                   cv2.getGaussianKernel(n, sigma, cv2.CV_64F).ravel(), rtol=1e-14)
        src = rng.uniform(0, 255, (128, 128, 3)).astype(dtype)
        got = raster.gaussian_blur(src, sigma)
        assert got.dtype == dtype
        assert np.abs(got - cv2.GaussianBlur(src, (0, 0), sigma)).max() <= bound


def test_resize_cubic_within_bound():
    """resize INTER_CUBIC of the 2-5 px blob grid to the canvas (A = -0.75,
    replicated border); largest seen 3.5e-4 levels."""
    rng = np.random.default_rng(9)
    for _ in range(80):
        small = rng.uniform(0, 255, (int(rng.integers(2, 6)), int(rng.integers(2, 6)), 3)).astype(np.float32)
        size = int(rng.choice([96, 128, 160]))
        got = raster.resize_cubic(small, (size, size))
        assert np.abs(got - cv2.resize(small, (size, size), interpolation=cv2.INTER_CUBIC)).max() <= 1e-3


def test_estimate_affine_partial_matches_cv2():
    """estimateAffinePartial2D on the renderer's landmarks: the same RANSAC
    inliers; the least-squares similarity on them within 1e-4 of cv2's
    Levenberg-Marquardt refinement (largest seen 2.1e-5)."""
    rng = np.random.default_rng(10)
    dst = np.asarray(synthetic_faces.ARCFACE_TEMPLATE, np.float32)
    for _ in range(300):
        p = sample_identity(rng)
        _, _, lm, _ = synthetic_faces.render_face_patch(rng, p, 160)
        src = lm + rng.normal(0, 160 * 0.008, (5, 2)).astype(np.float32)
        want, want_mask = cv2.estimateAffinePartial2D(src, dst)
        got, mask = raster.estimate_affine_partial(src, dst)
        np.testing.assert_array_equal(mask, want_mask)
        assert np.abs(got - want).max() <= 1e-4


def test_raster_refuses_what_it_cannot_draw(tmp_path, monkeypatch):
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(TypeError):
        raster.ellipse(img, (4, 4), (2, 2), 0, 0, 360, (1, 2, 3), -1)
    with pytest.raises(TypeError):
        raster.line(np.zeros((8, 16, 3), np.float32)[:, ::2], (0, 0), (4, 4), (1, 1, 1), 1)
    with pytest.raises(TypeError):
        raster.resize_cubic(np.zeros((3, 3, 3)), (8, 8))
    # A source that does not compile raises; nothing stands in for it.
    (tmp_path / "raster.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_loaded", {})
    raster._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed"):
            raster.circle(np.zeros((8, 8), np.float32), (4, 4), 2, 1.0, -1)
    finally:
        raster._lib.cache_clear()


# -- scenes against the JAX renderer ------------------------------------------


@pytest.fixture
def jpeg_calls(monkeypatch):
    """Counts the port's JPEG steps."""
    calls: list = []
    real = raster.jpeg_roundtrip

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(raster, "jpeg_roundtrip", counted)
    return calls


def _check_pixels(ours, ref, jpeg: bool):
    d = np.abs(ours.astype(np.float64) - ref)
    if jpeg:
        assert d.max() <= scene_fixture.JPEG_MAX_ABS and d.mean() <= scene_fixture.JPEG_MEAN_ABS
    else:
        assert d.max() <= scene_fixture.NON_JPEG_MAX_ABS


def _check_geometry(ours, ref):
    for got, want in zip(ours[1:3], ref[1:3]):
        assert np.abs(got - want).max() <= scene_fixture.GEOMETRY_ABS
    np.testing.assert_array_equal(ours[3], ref[3])


@pytest.mark.parametrize("ranges", ["v3", "v4", "v3+v4"])
def test_scenes_match_jax(ranges, jpeg_calls):
    """``render_scene`` scene by scene and ``scene_batch`` (the v3+v4 mixture
    draws its envelope per scene): generator state after each call, boxes,
    landmarks, ``valid``, pixels."""
    seed = {"v3": 0, "v4": 1, "v3+v4": 2}[ranges]
    r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
    if ranges == "v3+v4":
        for _ in range(4):
            want = jax_sf.scene_batch(r_jax, 6, 128, 2, ranges=jax_sf.SCENE_RANGES[ranges])
            got = scene_batch(r_port, 6, 128, 2, ranges=SCENE_RANGES[ranges])
            assert r_jax.bit_generator.state == r_port.bit_generator.state
            _check_geometry(got, want)
            assert np.abs(got[0] - want[0]).mean() <= scene_fixture.JPEG_MEAN_ABS
        return
    for _ in range(30):
        before = len(jpeg_calls)
        want = jax_sf.render_scene(r_jax, 128, 2, 0.92, None, jax_sf.SCENE_RANGES[ranges])
        got = render_scene(r_port, 128, 2, 0.92, None, SCENE_RANGES[ranges])
        assert r_jax.bit_generator.state == r_port.bit_generator.state
        _check_geometry(got, want)
        _check_pixels(got[0], want[0], len(jpeg_calls) > before)


@pytest.mark.parametrize("family", OOD_FAMILIES)
def test_ood_scenes_match_jax(family, jpeg_calls):
    r_jax, r_port = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(6):
        before = len(jpeg_calls)
        want = jax_ood.ood_scene_batch(r_jax, 1, 128, family)
        got = ood_scene_batch(r_port, 1, 128, family)
        assert r_jax.bit_generator.state == r_port.bit_generator.state
        _check_geometry(got, want)
        _check_pixels(got[0][0], want[0][0], len(jpeg_calls) > before)


def test_aligned_samples_match_jax():
    ids = [jax_sf.sample_identity(np.random.default_rng(i)) for i in range(12)]
    for seed in range(40):
        r_jax, r_port = np.random.default_rng(seed), np.random.default_rng(seed)
        want = jax_sf.render_aligned_identity_sample(r_jax, ids[seed % 12], 112)
        got = render_aligned_identity_sample(r_port, ids[seed % 12], 112)
        assert r_jax.bit_generator.state == r_port.bit_generator.state
        d = np.abs(got.astype(np.float64) - want)
        assert d.max() <= scene_fixture.ALIGNED_MAX_ABS and d.mean() <= scene_fixture.ALIGNED_MEAN_ABS


def test_identity_dataset_matches_jax():
    want_imgs, want_labels = jax_sf.identity_dataset(4, 3, out_size=64, seed=1, workers=2)
    got_imgs, got_labels = identity_dataset(4, 3, out_size=64, seed=1, workers=3)
    np.testing.assert_array_equal(got_labels, want_labels)
    assert got_imgs.dtype == np.uint8
    d = np.abs(got_imgs.astype(np.int16) - want_imgs)
    # truncation to uint8 turns a sub-level difference into at most one level
    assert d.max() <= scene_fixture.ALIGNED_MAX_ABS + 1
    assert d.mean() <= scene_fixture.ALIGNED_MEAN_ABS + 0.01


def test_threads_render_what_one_thread_renders():
    """The rasteriser drops the GIL and holds no state: scenes rendered from
    several threads at once are the scenes rendered one after another."""
    seq = [scene_batch(np.random.default_rng(s), 4, 96, 2, ranges=RANGES_V4) for s in range(4)]
    out: dict = {}

    def work(s):
        out[s] = scene_batch(np.random.default_rng(s), 4, 96, 2, ranges=RANGES_V4)

    threads = [threading.Thread(target=work, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in range(4):
        for a, b in zip(seq[s], out[s]):
            np.testing.assert_array_equal(a, b)


def test_fixture_matches_jax_renderer():
    """The committed reference set is what the JAX renderer draws (bit for
    bit), with its JPEG flags and generator states; the port's render of it
    stays within the bounds ``chip_smoke.py`` holds it to on the card."""
    ref, record = scene_fixture.load()
    assert record["spec"] == scene_fixture.SPEC
    calls: list = []
    real = jax_sf.cv2.imencode

    def imencode(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    jax_sf.cv2.imencode = imencode
    try:
        arrays, states = scene_fixture.render_set(jax_sf, jax_ood, scene_fixture.SPEC, calls)
    finally:
        jax_sf.cv2.imencode = real
    assert states == record["states"]
    assert sorted(arrays) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(arrays[key], ref[key])
    ours, our_states = scene_fixture.render_port()
    worst = scene_fixture.compare(ours, our_states, ref, record)
    assert worst["jpeg_scenes"] >= 1


# -- the renderer's contracts (the port's versions of the JAX tests) ----------


class TestScenes:
    def test_batch_shapes_and_ranges(self, rng):
        imgs, boxes, lms, valid = scene_batch(rng, 8, 96, max_faces=2)
        assert imgs.shape == (8, 96, 96, 3)
        assert boxes.shape == (8, MAX_GT, 4)
        assert lms.shape == (8, MAX_GT, 5, 2)
        assert valid.shape == (8, MAX_GT)
        assert imgs.min() >= 0 and imgs.max() <= 255

    def test_landmarks_inside_gt_box(self, rng):
        checked = 0
        for _ in range(20):
            img, boxes, lms, valid = render_scene(rng, 128, max_faces=1)
            for j in range(MAX_GT):
                if not valid[j]:
                    continue
                x1, y1, x2, y2 = boxes[j]
                pad = 0.25 * (x2 - x1)
                assert (lms[j, :, 0] > x1 - pad).all()
                assert (lms[j, :, 0] < x2 + pad).all()
                assert (lms[j, :, 1] > y1 - pad).all()
                assert (lms[j, :, 1] < y2 + pad).all()
                assert lms[j, 0, 0] < lms[j, 1, 0]
                checked += 1
        assert checked >= 10

    def test_face_probability(self, rng):
        _, _, _, valid = scene_batch(rng, 40, 64, p_face=0.0)
        assert not valid.any()
        _, _, _, valid = scene_batch(rng, 40, 64, p_face=1.0)
        assert valid[:, 0].mean() > 0.9

    def test_multi_face_no_heavy_overlap(self, rng):
        found = 0
        for _ in range(30):
            _, boxes, _, valid = render_scene(rng, 128, max_faces=3, p_face=1.0)
            n = int(valid.sum())
            if n < 2:
                continue
            found += 1
            b = boxes[valid]
            for i in range(n):
                for j in range(i + 1, n):
                    ix = max(0, min(b[i, 2], b[j, 2]) - max(b[i, 0], b[j, 0]))
                    iy = max(0, min(b[i, 3], b[j, 3]) - max(b[i, 1], b[j, 1]))
                    area = (b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
                    assert ix * iy / area < 0.35
        assert found >= 3


class TestIdentities:
    def test_identity_determinism(self):
        a = sample_identity(np.random.default_rng(7))
        b = sample_identity(np.random.default_rng(7))
        assert np.allclose(a.skin, b.skin) and a.aspect == b.aspect

    def test_aligned_sample_shape(self, rng):
        s = render_aligned_identity_sample(rng, sample_identity(rng), 112)
        assert s.shape == (112, 112, 3)
        assert s.min() >= 0 and s.max() <= 255

    def test_identity_dataset_layout(self):
        imgs, labels = identity_dataset(4, 3, out_size=64, seed=1, workers=2)
        assert imgs.shape == (12, 64, 64, 3) and imgs.dtype == np.uint8
        assert (np.bincount(labels) == 3).all()
        imgs2, _ = identity_dataset(4, 3, out_size=64, seed=1, workers=4)
        np.testing.assert_array_equal(imgs, imgs2)

    def test_default_ranges_are_v3_and_stream_stable(self):
        assert SceneRanges() == RANGES_V3
        assert SCENE_RANGES["v3"] is RANGES_V3
        assert SCENE_RANGES["v4"] is RANGES_V4
        a = render_scene(np.random.default_rng(11), 96, 2, 0.92)
        b = render_scene(np.random.default_rng(11), 96, 2, 0.92, ranges=RANGES_V3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)

    def test_v4_ranges_widen_pose_and_illumination_only(self):
        assert RANGES_V4.rot > RANGES_V3.rot
        assert RANGES_V4.frac_single[0] < RANGES_V3.frac_single[0]
        assert RANGES_V4.frac_single[1] > RANGES_V3.frac_single[1]
        assert RANGES_V4.gain[0] < RANGES_V3.gain[0] < RANGES_V3.gain[1] < RANGES_V4.gain[1]
        assert RANGES_V4.bias[0] < RANGES_V3.bias[0] < RANGES_V3.bias[1] < RANGES_V4.bias[1]
        assert RANGES_V4.cast[0] < RANGES_V3.cast[0] < RANGES_V3.cast[1] < RANGES_V4.cast[1]
        assert RANGES_V4.rot >= 50
        assert RANGES_V4.frac_single[0] <= 0.10 and RANGES_V4.frac_single[1] >= 0.90
        assert RANGES_V4.gain[0] <= 0.30 and RANGES_V4.gain[1] >= 1.80
        assert RANGES_V4.bias[0] <= -80 and RANGES_V4.bias[1] >= 80
        assert RANGES_V4.cast[0] <= 0.70 and RANGES_V4.cast[1] >= 1.30
        assert RANGES_V4.vignette[1] >= 0.45
        imgs, boxes, lms, valid = scene_batch(np.random.default_rng(12), 4, 96, 2, 0.92, ranges=RANGES_V4)
        assert imgs.shape == (4, 96, 96, 3)
        assert imgs.min() >= 0 and imgs.max() <= 255


@pytest.mark.parametrize("family", OOD_FAMILIES)
def test_ood_families_render_valid_single_face_scenes(family):
    img, boxes, lms, valid = ood_render_scene(np.random.default_rng(0), 128, family)
    assert img.shape == (128, 128, 3) and img.dtype == np.float32
    assert 0 <= img.min() and img.max() <= 255
    assert boxes.shape == (MAX_GT, 4) and lms.shape == (MAX_GT, 5, 2)
    assert valid[0] and not valid[1:].any()
    x1, y1, x2, y2 = boxes[0]
    assert x2 > x1 and y2 > y1
    assert 0 <= (x1 + x2) / 2 < 128 and 0 <= (y1 + y2) / 2 < 128


def test_ood_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown OOD family"):
        ood_render_scene(np.random.default_rng(0), 128, "nope")


def test_ood_identity_outside_training_ranges():
    rng = np.random.default_rng(1)
    for _ in range(16):
        p = sample_identity_ood(rng)
        assert p.aspect < 1.15 or p.aspect > 1.45
        assert p.glasses
        assert p.hair.min() > 150 and p.hair.max() / p.hair.min() < 1.15
        assert p.skin[1] >= 0.90 * p.skin[0]


def test_ood_batch_contract():
    imgs, boxes, lms, valid = ood_scene_batch(np.random.default_rng(2), 3, 96, "background")
    assert imgs.shape == (3, 96, 96, 3)
    assert valid[:, 0].all()
    assert ood_faces.MAX_GT == MAX_GT

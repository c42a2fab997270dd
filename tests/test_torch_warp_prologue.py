"""The ``warp_sample`` kernel's per-slot prologue and the fused model inputs, on the CPU.

``csrc/warp_sample.cu`` computes each slot's map itself from the raw
landmarks: scale and clamp, the Umeyama closed form, ``invert_affine``,
``warp_coefficients`` and, for the crowd window, the origin and the cropped
map. ``prologue`` below is that code in numpy float32 scalars, operation for
operation as the kernel writes it; it must give the plain version's bits, so
the kernel can be held to the plain version bit for bit on the card. The
plain version takes its sums over the five points left to right
(``umeyama.sum_left``) and divides by tensors, so its rounding does not
depend on a reduction order or on the device; it still meets the JAX bounds.
"""

import importlib
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu_torch.ops import umeyama as tumeyama
from facerecognition_tpu_torch.ops import warp_mxu as twarp
from facerecognition_tpu_torch.ops import warp_sample as ws
from facerecognition_tpu_torch.ops.image import normalize_imagenet_style

jimage = importlib.import_module("facerecognition_tpu.ops.image")
jumeyama = importlib.import_module("facerecognition_tpu.ops.umeyama")
jwarp = importlib.import_module("facerecognition_tpu.ops.warp_mxu")

f32 = np.float32


def T(a):
    return torch.from_numpy(np.array(a))


# -- the kernel's prologue, in float32 scalars ------------------------------------


def fma64(a, b, c):
    """``fma64`` of the kernel: the float64 product and sum, rounded to float32."""
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def nmax(a, b):
    return a if a != a else b if b != b else max(a, b)


def nmin(a, b):
    return a if a != a else b if b != b else min(a, b)


def sum5(v):
    s = v[0]
    for x in v[1:]:
        s = f32(s + x)
    return s


def umeyama(src, dst):
    sx, sy, dx, dy = src[0::2], src[1::2], dst[0::2], dst[1::2]
    five = f32(5)
    mu_sx, mu_sy = sum5(sx) / five, sum5(sy) / five
    mu_dx, mu_dy = sum5(dx) / five, sum5(dy) / five
    scx, scy = [x - mu_sx for x in sx], [y - mu_sy for y in sy]
    dcx, dcy = [x - mu_dx for x in dx], [y - mu_dy for y in dy]
    a = sum5([p * q for p, q in zip(dcx, scx)]) / five
    b = sum5([p * q for p, q in zip(dcx, scy)]) / five
    c = sum5([p * q for p, q in zip(dcy, scx)]) / five
    d = sum5([p * q for p, q in zip(dcy, scy)]) / five
    cs, sn = a + d, c - b
    r = np.sqrt(cs * cs + sn * sn)
    degenerate = r == 0
    cos = f32(1) if degenerate else cs / r
    sin = f32(0) if degenerate else sn / r
    var_src = sum5([x * x + y * y for x, y in zip(scx, scy)]) / five
    scale = r / nmax(var_src, f32(1e-12))
    l00, l01, l10, l11 = scale * cos, scale * -sin, scale * sin, scale * cos
    t0 = mu_dx - (l00 * mu_sx + l01 * mu_sy)
    t1 = mu_dy - (l10 * mu_sx + l11 * mu_sy)
    return [l00, l01, t0, l10, l11, t1]


def invert_affine(m):
    a, b, tx, c, d, ty = m
    if not abs(a * d - b * c) > f32(1e-8):
        a, b, c, d = f32(1), f32(0), f32(0), f32(1)
    swap = abs(c) > abs(a)
    p00, p01 = (c, d) if swap else (a, b)
    p10, p11 = (a, b) if swap else (c, d)
    one = f32(1)
    r00 = one / p00
    low = p10 * r00
    r11 = one / (p11 - low * p01)
    x1_low = -low * r11
    x1_c0, x1_c1 = (r11, x1_low) if swap else (x1_low, r11)

    def from_one(x1):
        return fma64(-p01, x1, one) * r00

    def from_zero(x1):
        return (-p01 * x1) * r00

    ia = from_zero(x1_c0) if swap else from_one(x1_c0)
    ib = from_one(x1_c1) if swap else from_zero(x1_c1)
    ic, id_ = x1_c0, x1_c1
    return [ia, ib, -fma64(ib, ty, ia * tx), ic, id_, -fma64(id_, ty, ic * tx)]


def coefficients(inv):
    m00, m01, m02, m10, m11, m12 = inv
    tiny = f32(-1e-6) if m00 < 0 else f32(1e-6)
    m00_safe = tiny if abs(m00) < f32(1e-6) else m00
    bb = m10 / m00_safe
    return [m00, m01, m02, fma64(-bb, m01, m11), bb, fma64(-bb, m02, m12)]


def window(ms, h, w, out_size, win):
    """(x0, y0, the cropped map)."""
    inv = invert_affine(ms)
    c = f32((out_size - 1) / 2.0)
    half = f32((win - 1) / 2.0)
    cx = (inv[0] * c + inv[1] * c) + inv[2]
    cy = (inv[3] * c + inv[4] * c) + inv[5]

    def origin(v, hi):
        v = np.rint(v - half)
        o = 0 if v != v else int(v)  # the card's float -> int64: NaN gives 0
        return min(max(o, 0), hi)

    x0, y0 = origin(cx, w - win), origin(cy, h - win)
    ox, oy = f32(x0), f32(y0)
    ms = list(ms)
    ms[2] = ms[2] + (ms[0] * ox + ms[1] * oy)
    ms[5] = ms[5] + (ms[3] * ox + ms[4] * oy)
    return x0, y0, ms


def prologue(lm, out_size, h, w, win=0, det_size=None):
    """One slot: (m00, m01, m02, aa, bb, cc, x0, y0) as the kernel computes
    them from its ten landmark values."""
    tmpl = [f32(v) for v in ws._template(out_size)]
    if det_size is None:
        sx = sy = f32(1)
        lo, hx, hy = f32(-np.inf), f32(np.inf), f32(np.inf)
    else:
        (sx, sy), (lo, hx, hy) = ws._frame_scale(h, w, det_size)
        sx, sy, lo, hx, hy = map(f32, (sx, sy, lo, hx, hy))
    pts = []
    for k, v in enumerate(np.asarray(lm, np.float32).reshape(10)):
        x = k % 2 == 0
        pts.append(nmin(nmax(v * (sx if x else sy), lo), hx if x else hy))
    ms = umeyama(pts, tmpl)
    x0 = y0 = 0
    if win:
        x0, y0, ms = window(ms, h, w, out_size, win)
    return coefficients(invert_affine(ms)) + [f32(x0), f32(y0)]


def mirror(landmarks, out_size, h, w, window_=None, det_size=None):
    win = min(window_, h, w) if window_ else 0
    rows = [prologue(lm, out_size, h, w, win, det_size) for lm in landmarks.reshape(-1, 10)]
    return np.array(rows, np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# -- landmarks ---------------------------------------------------------------------


def _faces(rng, n, side, lo=0.3, hi=0.9, angle=0.5):
    template = tumeyama.ARCFACE_TEMPLATE - tumeyama.ARCFACE_TEMPLATE.mean(0)
    ang = rng.uniform(-angle, angle, n)
    rot = np.stack(
        [np.stack([np.cos(ang), -np.sin(ang)], -1), np.stack([np.sin(ang), np.cos(ang)], -1)], -2
    )
    lm = np.einsum("bij,nj->bni", rot, template) * rng.uniform(lo, hi, (n, 1, 1))
    lm = lm + rng.uniform(30, side - 30, (n, 1, 2)) + rng.normal(0, 1.0, (n, 5, 2))
    return lm.astype(np.float32)


def _rotated(theta_deg, scale=1.0, shift=(100.0, 90.0)):
    t = np.deg2rad(theta_deg)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    lm = (tumeyama.ARCFACE_TEMPLATE - 56.0) @ rot.T * scale + np.array(shift)
    return lm.astype(np.float32)


def _special_slots():
    """One slot per edge case of the prologue, with frame-pixel landmarks
    for a 256² frame."""
    tmpl = tumeyama.ARCFACE_TEMPLATE
    return {
        "coincident (scale 0)": np.full((5, 2), 7.0, np.float32),
        "|det| <= 1e-8": (tmpl * 1e5).astype(np.float32),
        "no pivot swap (20 deg)": _rotated(20.0),
        "pivot swap (60 deg)": _rotated(60.0),
        # exactly 90 degrees, no shift: a = -d exactly, so cos = 0 and the
        # inverse's m00 = 0 takes the guard
        "m00 = 0 (90 deg)": np.stack([-tmpl[:, 1], tmpl[:, 0]], -1).astype(np.float32),
        "window at the left/top": _rotated(5.0, 1.2, (20.0, 25.0)),
        "window at the right/bottom": _rotated(-5.0, 1.2, (236.0, 240.0)),
        "window at the right/top": _rotated(10.0, 1.0, (245.0, 12.0)),
        "window at the left/bottom": _rotated(-10.0, 1.0, (8.0, 250.0)),
    }


# -- the plain prologue against JAX ------------------------------------------------


def test_umeyama_in_left_to_right_order_meets_the_jax_bounds(rng):
    """tests/test_torch_ops.py's bounds, 1e-5 on the linear part and 1e-4 px
    on the translation, hold with the sums written out left to right; and
    the sums are left to right: the float32 mirror gives the same bits."""
    # tests/test_torch_ops.py's faces (scale 0.5-2 of the template, shifted
    # up to 150 px): translations of a few hundred pixels, as the bound says
    ang = rng.uniform(-0.5, 0.5, 64)
    rot = np.stack(
        [np.stack([np.cos(ang), -np.sin(ang)], -1), np.stack([np.sin(ang), np.cos(ang)], -1)], -2
    )
    lm = np.einsum("bij,nj->bni", rot, tumeyama.ARCFACE_TEMPLATE)
    lm = lm * rng.uniform(0.5, 2.0, (64, 1, 1)) + rng.uniform(0, 150.0, (64, 1, 2))
    faces = (lm + rng.normal(0, 2.0, lm.shape)).astype(np.float32)
    src = np.concatenate([faces, rng.uniform(0, 256, (8, 5, 2)).astype(np.float32)])
    tmpl = jnp.asarray(jumeyama.ARCFACE_TEMPLATE)
    ref = np.asarray(jumeyama.umeyama_batch(jnp.asarray(src), tmpl))
    got = tumeyama.umeyama_batch(T(src), T(tumeyama.ARCFACE_TEMPLATE)).numpy()
    np.testing.assert_allclose(got[:, :, :2], ref[:, :, :2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, :, 2], ref[:, :, 2], atol=1e-4, rtol=0)
    flat = [f32(v) for v in tumeyama.ARCFACE_TEMPLATE.reshape(10)]
    mine = np.array([umeyama(list(s.reshape(10)), flat) for s in src], np.float32)
    np.testing.assert_array_equal(_bits(got.reshape(-1, 6)), _bits(mine))


def test_window_slots_match_jax(rng):
    """The window origins equal the JAX function's (its SVD and our closed
    form differ by ~1e-5 px, far from a rounding edge on these faces), and
    the cropped maps agree to the umeyama bounds."""
    h = w = 256
    lm = _faces(rng, 12, 256).reshape(3, 4, 5, 2)
    lm[0, 0] += 30.0 - lm[0, 0].mean(0)  # clamped at the top-left
    lm[0, 1] += 230.0 - lm[0, 1].mean(0)  # clamped at the bottom-right
    ms_c, origin, win = twarp.window_slots(T(lm), h, w, 112, 160)
    jl = jnp.asarray(lm.reshape(-1, 5, 2))
    jms = jwarp.umeyama_batch(jl, jnp.asarray(jumeyama.ARCFACE_TEMPLATE))
    jinv = np.stack([np.asarray(jumeyama.invert_affine(m)) for m in jms])
    ctr = np.array([55.5, 55.5, 1.0], np.float32)
    start = np.round(jinv @ ctr - 79.5).astype(np.int64)
    ref = np.stack([np.clip(start[:, 0], 0, w - win), np.clip(start[:, 1], 0, h - win)], 1)
    np.testing.assert_array_equal(origin.numpy(), ref)
    assert origin[0].tolist() == [0, 0] and origin[1].tolist() == [96, 96]
    ref_c = np.asarray(jms).copy()
    ref_c[:, :, 2] += np.einsum("bij,bj->bi", ref_c[:, :, :2], ref.astype(np.float32))
    np.testing.assert_allclose(ms_c.numpy()[:, :, :2], ref_c[:, :, :2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(ms_c.numpy()[:, :, 2], ref_c[:, :, 2], atol=1e-3, rtol=0)


# -- the kernel's prologue against the plain version, bit for bit -----------------


@pytest.mark.parametrize("window_", [None, 160, 96])
@pytest.mark.parametrize("det_size", [None, 128])
def test_prologue_mirror_gives_the_plain_bits(rng, window_, det_size):
    """Seeded faces (some past the frame's edge) and every special slot, from
    frame pixels (the public functions) or detector pixels (embedder_input:
    scaled by 256 / 128 and clamped into the frame)."""
    h = w = 256
    faces = _faces(rng, 40, 256, lo=0.3, hi=1.4)
    faces[:4] += rng.uniform(-40, 40, (4, 1, 2)).astype(np.float32) * [[1, -1]]
    special = np.stack(list(_special_slots().values()))
    lm = np.concatenate([faces, special])
    if det_size is not None:
        lm = (lm * (det_size / h)).astype(np.float32)
    lm = lm.reshape(-1, 1, 5, 2)
    plain = ws.slot_parameters_plain((lm.shape[0], h, w, 3), T(lm), 112, window_, det_size)
    mine = mirror(lm, 112, h, w, window_, det_size)
    np.testing.assert_array_equal(_bits(plain.numpy()), _bits(mine))
    # the cases are what they say
    names = list(_special_slots())
    got = dict(zip(names, plain.numpy()[len(faces):]))
    if det_size is None and not window_:
        # scale 0 and a vanishing determinant: the identity guard (the
        # translation stays the landmarks' own)
        for name in ("coincident (scale 0)", "|det| <= 1e-8"):
            np.testing.assert_array_equal(got[name][[0, 1, 3, 4]], [1, 0, 1, 0])
            assert np.isfinite(got[name]).all()
        assert got["m00 = 0 (90 deg)"][0] == 0.0 and np.isfinite(got["m00 = 0 (90 deg)"]).all()
    if window_ == 160 and det_size is None:
        assert got["window at the left/top"][6:].tolist() == [0, 0]
        assert got["window at the right/bottom"][6:].tolist() == [96, 96]
        assert got["window at the right/top"][6:].tolist() == [96, 0]
        assert got["window at the left/bottom"][6:].tolist() == [0, 96]


def test_pivot_branches_are_both_taken():
    swap = [abs(m[1, 0]) > abs(m[0, 0]) for m in tumeyama.umeyama_batch(
        T(np.stack([_rotated(20.0), _rotated(60.0)])), T(tumeyama.ARCFACE_TEMPLATE)
    ).numpy()]
    assert swap == [False, True]


@pytest.mark.parametrize("frac", [0.5, 1.5, -0.5, 2.5])
def test_window_origin_round_half_to_even(frac):
    """A map whose inverse image of the output centre minus (win - 1) / 2 is
    an exact half: the origin rounds to even, in the plain version and the
    mirror alike."""
    win, out_size, h, w = 160, 112, 400, 400
    target = 100.0 + frac  # cx - 79.5
    tx = -(target + 79.5 - 55.5)  # identity linear part: minv's translation is -t
    ms = np.array([[[1.0, 0.0, tx], [0.0, 1.0, tx - 3.0]]], np.float32)
    origin, ms_c = twarp.window_origin(T(ms), h, w, out_size, win)
    x0, y0, mine_c = window([f32(v) for v in ms.reshape(6)], h, w, out_size, win)
    assert origin[0].tolist() == [x0, y0]
    assert x0 == int(np.rint(target)) and x0 % 2 == 0
    np.testing.assert_array_equal(_bits(ms_c.numpy().reshape(6)), _bits(mine_c))


def test_fma64_is_not_a_single_rounding():
    """a * b + c with the exact value just above a float32 midpoint and
    within half a float64 ulp of it: rounded once it goes up, rounded to
    float64 first it lands on the midpoint and ties to even. ``umeyama.fma``
    and the mirror (the kernel's fma64) take the float64 way."""
    a = f32(1 + 2.0**-12)
    b = f32((1 - 4095 * 2.0**-24) * 2.0**-24)
    c = f32(1.0)
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    mid = Fraction(1) + Fraction(1, 2**24)
    assert mid < exact < mid + Fraction(1, 2**53)  # single rounding: 1 + 2^-23
    assert fma64(a, b, c) == f32(1.0)
    plain = tumeyama.fma(T(np.array([a])), T(np.array([b])), T(np.array([c])))
    assert plain.item() == 1.0


# -- the model inputs on the CPU ----------------------------------------------------


def _frames(rng, b, side):
    coarse = rng.integers(0, 256, (b, side // 8, side // 8, 3))
    return np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2).astype(np.uint8)


@pytest.mark.parametrize("fast", [True, False])
def test_detector_input_is_the_normalised_resize(rng, fast):
    """The composition it replaces, bit for bit; against JAX within the
    resize test's bounds (1e-3 / 0.5 level) in the input's units (/ 127.5)."""
    frames = _frames(rng, 2, 96)
    got = ws.detector_input(T(frames), 64, fast)
    small = twarp.bilinear_resize_mxu_batch(T(frames), 64, 64, fast)
    torch.testing.assert_close(got, small / 127.5 - 1.0, atol=0.0, rtol=0.0)
    ref = np.asarray(
        jwarp.bilinear_resize_mxu_batch(jnp.asarray(frames.astype(np.float32)), 64, 64, fast)
    ) / 127.5 - 1.0
    np.testing.assert_allclose(got.numpy(), ref, atol=(0.5 if fast else 1e-3) / 127.5)


@pytest.mark.parametrize("window_", [None, 64])
@pytest.mark.parametrize("fast", [True, False])
def test_embedder_input_is_the_normalised_alignment(rng, fast, window_):
    """Landmarks in detector pixels (64²) on 96² frames, some outside: the
    engine's scale and clamp, the warp, normalize_imagenet_style, bit for
    bit; against JAX (its clip, warp and normalize) within the align test's
    bounds (1.5 / 0.01 levels with bf16 weights, 0.02 / 1e-3 without) in the
    input's units (/ 127.5)."""
    b, m, side, det = 2, 3, 96, 64
    frames = _frames(rng, b, side)
    lm = (_faces(rng, b * m, side, lo=0.3, hi=0.6) * (det / side)).reshape(b, m, 5, 2)
    lm[0, 0, 0] = [-2.0, det + 3.0]
    got = ws.embedder_input(T(frames), T(lm), det, 40, window_, fast)
    scale = torch.tensor([side / det, side / det])
    lms = torch.minimum(torch.clamp(T(lm) * scale, min=0.0), torch.tensor([side - 1.0] * 2))
    if window_:
        aligned = twarp.align_crop_mxu_window(T(frames), lms, 40, window_, fast)
    else:
        rep = T(frames).repeat_interleave(m, 0)
        aligned = twarp.align_crop_mxu_batch(rep, lms.reshape(-1, 5, 2), 40, fast)
    torch.testing.assert_close(got, normalize_imagenet_style(aligned), atol=0.0, rtol=0.0)
    jl = jnp.clip(jnp.asarray(lm) * jnp.float32(side / det), 0.0, jnp.array([side - 1.0] * 2))
    jf = jnp.asarray(frames.astype(np.float32))
    if window_:
        ja = jwarp.align_crop_mxu_window(jf, jl, 40, window_, fast)
    else:
        ja = jwarp.align_crop_mxu_batch(jnp.repeat(jf, m, 0), jl.reshape(-1, 5, 2), 40, fast)
    ref = np.asarray(jimage.normalize_imagenet_style(ja))
    diff = np.abs(got.numpy() - ref) * 127.5
    if fast:
        assert diff.max() <= 1.5 and diff.mean() < 0.01, (diff.max(), diff.mean())
    else:
        assert diff.max() < 0.02 and diff.mean() < 1e-3, (diff.max(), diff.mean())


def test_model_inputs_launch_nothing_on_the_cpu(rng):
    frames = T(_frames(rng, 1, 64))
    lm = T(_faces(rng, 1, 64, lo=0.3, hi=0.5).reshape(1, 1, 5, 2))
    before = ws.launches.count
    ws.detector_input(frames, 32)
    ws.embedder_input(frames, lm, 64, 40)
    ws.slot_parameters(frames, lm, 40)
    assert ws.launches.count == before


def test_wrappers_check_their_arguments():
    """Shapes and types are checked before any launch (``meta`` tensors: the
    checks run, nothing else does)."""
    frames = torch.empty(2, 64, 64, 3, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="landmarks must be"):
        ws._check_landmarks(frames, torch.empty(2, 5, 2, device="meta"))
    with pytest.raises(ValueError, match="landmark sets"):
        ws._check_landmarks(frames, torch.empty(3, 1, 5, 2, device="meta"))
    with pytest.raises(TypeError, match="uint8 or float32"):
        ws._check_frames(torch.empty(2, 64, 64, 3, dtype=torch.int32, device="meta"))
    with pytest.raises(NotImplementedError, match="int8"):
        ws.detector_input(frames, 32, fast="int8")

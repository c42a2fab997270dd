"""The design of the ``warp_sample`` kernel, checked on the CPU.

``csrc/warp_sample.cu`` computes the two-pass functions of ``ops/warp_mxu.py``
by sampling four source pixels per output pixel. ``four_tap`` below is that
formula in PyTorch, written as the kernel writes it (two column taps, two row
taps each, the same roundings); it is held against the two-pass plain
version here so a wrong design fails before it reaches the card. With bf16
weights (``fast``) every product is exact, so the two must agree bit for
bit; in float32 the products round, and the matrix products may add in
another order: within 1e-3 levels.
"""

import numpy as np
import pytest
import torch

from facerecognition_tpu_torch.ops import warp_mxu as wm
from facerecognition_tpu_torch.ops import warp_sample as ws
from facerecognition_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE, fma, invert_affine


def _bf16(x):
    return x.bfloat16().float()


def four_tap(frames, coef, frame_of, origin, region, out_h, out_w, fast, ypos=None, xpos=None):
    """The kernel's formula: slot s samples frame ``frame_of[s]``'s region
    (``region`` (H, W) at ``origin[s]`` (x0, y0)) with coefficients
    ``coef[s]``, or, with position tables, resizes frame s."""
    frames = frames.float()
    s = len(frame_of)
    lo, hi_h = wm.inside_bounds(region[0])
    _, hi_w = wm.inside_bounds(region[1])
    ii = torch.arange(out_h, dtype=torch.float32)[None, :, None].expand(s, out_h, out_w)
    jj = torch.arange(out_w, dtype=torch.float32)[None, None, :].expand(s, out_h, out_w)
    if xpos is None:
        m00, m01, m02, aa, bb, cc = (c[:, None, None] for c in coef.unbind(1))
        xs = fma(m00, jj, m01 * ii) + m02
    else:
        xs = xpos[None, None, :].expand(s, out_h, out_w)

    def weight(pos, tap, hi):
        w = torch.clamp(1.0 - (pos - tap).abs(), min=0.0) * ((pos >= lo) & (pos <= hi))
        return _bf16(w) if fast else w

    out = torch.zeros(s, out_h, out_w, 3)
    f = frame_of[:, None, None]
    for t in (0, 1):
        x = torch.floor(xs) + t
        ok_x = (xs >= lo) & (xs <= hi_w) & (x >= 0) & (x < region[1])
        wx = weight(xs, x, hi_w) * ok_x
        if ypos is None:
            big_y = fma(aa, ii, bb * x) + cc
        else:
            big_y = ypos[None, :, None].expand(s, out_h, out_w)
        mid = torch.zeros(s, out_h, out_w, 3)
        for u in (0, 1):
            y = torch.floor(big_y) + u
            ok = ok_x & (big_y >= lo) & (big_y <= hi_h) & (y >= 0) & (y < region[0])
            wy = weight(big_y, y, hi_h) * ok
            gy = (y.clamp(0, region[0] - 1) + origin[:, 1, None, None]).long()
            gx = (x.clamp(0, region[1] - 1) + origin[:, 0, None, None]).long()
            px = frames[f, gy, gx]
            px = _bf16(px) if fast else px
            mid = fma(wy[..., None], px, mid)
        mid = _bf16(mid) if fast else mid
        out = fma(wx[..., None], mid, out)
    return out


def _frames(rng, b, h, w):
    coarse = rng.integers(0, 256, (b, h // 8 + 1, w // 8 + 1, 3))
    img = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :h, :w]
    noise = rng.integers(-20, 21, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def _landmarks(rng, b, m, h, w, scale=(0.5, 1.1)):
    template = ARCFACE_TEMPLATE - ARCFACE_TEMPLATE.mean(0)
    ang = rng.uniform(-0.5, 0.5, (b, m))
    rot = np.stack(
        [np.stack([np.cos(ang), -np.sin(ang)], -1), np.stack([np.sin(ang), np.cos(ang)], -1)], -2
    )
    lm = np.einsum("bmij,nj->bmni", rot, template) * rng.uniform(*scale, (b, m, 1, 1))
    # some faces reach past the frame's edge: zero border on both sides
    lm = lm + rng.uniform([-10, -10], [w + 10, h + 10], (b, m, 1, 2))
    return torch.as_tensor(lm.astype(np.float32))


def _check(got, ref, fast):
    if fast:
        torch.testing.assert_close(got, ref, atol=0.0, rtol=0.0)
    else:
        assert (got - ref).abs().max().item() <= 1e-3


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", [(64, 80), (96, 96)])
def test_four_taps_give_the_two_pass_align_warp(rng, fast, shape):
    """Every slot from its whole frame (the repeat path and the one-face
    path): frame s // M for slot s."""
    h, w = shape
    b, m = 3, 2
    frames = torch.as_tensor(_frames(rng, b, h, w))
    lms = _landmarks(rng, b, m, h, w)
    ms = wm.align_matrices(lms.reshape(-1, 5, 2), 48)
    coef = wm.warp_coefficients(invert_affine(ms))
    frame_of = torch.arange(b).repeat_interleave(m)
    origin = torch.zeros(b * m, 2, dtype=torch.long)
    got = four_tap(frames, coef, frame_of, origin, (h, w), 48, 48, fast)
    ref = wm.align_crop_mxu_batch(frames.repeat_interleave(m, 0), lms.reshape(-1, 5, 2), 48, fast)
    _check(got, ref, fast)
    _check(got, ws.align_crop(frames, lms, 48, fast), fast)  # the wrapper's plain route


@pytest.mark.parametrize("fast", [False, True])
def test_four_taps_give_the_two_pass_window_warp(rng, fast):
    """The crowd window: each slot reads its crop in place, zero outside."""
    b, m, side = 2, 3, 120
    frames = torch.as_tensor(_frames(rng, b, side, side))
    lms = _landmarks(rng, b, m, side, side, scale=(0.3, 0.5))
    ms_c, origin, win = wm.window_slots(lms, side, side, 40, 64)
    coef = wm.warp_coefficients(invert_affine(ms_c))
    frame_of = torch.arange(b).repeat_interleave(m)
    got = four_tap(frames, coef, frame_of, origin, (win, win), 40, 40, fast)
    ref = wm.align_crop_mxu_window(frames, lms, 40, 64, fast)
    _check(got, ref, fast)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape, out", [((64, 64), (32, 32)), ((50, 70), (40, 90))])
def test_four_taps_give_the_two_pass_resize(rng, fast, shape, out):
    """The resize: shared, edge-clamped position tables."""
    frames = torch.as_tensor(_frames(rng, 2, *shape))
    ypos = wm.resize_positions(shape[0], out[0], "cpu")
    xpos = wm.resize_positions(shape[1], out[1], "cpu")
    origin = torch.zeros(2, 2, dtype=torch.long)
    got = four_tap(frames, None, torch.arange(2), origin, shape, *out, fast, ypos, xpos)
    _check(got, wm.bilinear_resize_mxu_batch(frames, *out, fast), fast)


@pytest.mark.parametrize("fast", [False, True])
def test_four_taps_give_the_two_pass_affine_warp(rng, fast):
    """An arbitrary similarity with a shear of the row taps and samples
    outside the frame."""
    frames = torch.as_tensor(_frames(rng, 2, 40, 56))
    theta = np.array([0.3, -0.7])
    s = np.array([1.3, 0.6])
    ms = np.zeros((2, 2, 3), np.float32)
    ms[:, 0, 0], ms[:, 0, 1] = s * np.cos(theta), -s * np.sin(theta)
    ms[:, 1, 0], ms[:, 1, 1] = s * np.sin(theta), s * np.cos(theta)
    ms[:, :, 2] = [[4.0, -6.0], [10.0, 12.0]]
    ms = torch.as_tensor(ms)
    coef = wm.warp_coefficients(invert_affine(ms))
    origin = torch.zeros(2, 2, dtype=torch.long)
    got = four_tap(frames, coef, torch.arange(2), origin, (40, 56), 30, 44, fast)
    _check(got, wm.affine_warp_mxu_batch(frames, ms, 30, 44, 16, fast), fast)

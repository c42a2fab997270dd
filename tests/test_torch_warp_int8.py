"""The int8 warp mode (JAX's ``fast="int8"``) and the batch helpers
(``detect_best_face_batch``, ``align_crop_batch``) of the port against the
JAX package on the CPU.

The int8 mode's arithmetic is integer but for three float32 products with
float32(1/127) (XLA's division by 127) and their roundings, so the plain
version gives JAX's bits given JAX's matrices; through the landmarks the
closed-form Umeyama moves sample positions by ~1e-5 px, which can flip a
rounded weight: a bound in levels is stated there. Inputs come from numpy
seeds.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.models.detector_net import anchor_centers
from facerecognition_tpu_torch.models.detector_net import detect_best_face_batch
from facerecognition_tpu_torch.ops import warp_mxu as twarp
from facerecognition_tpu_torch.ops import warp_sample as ws
from facerecognition_tpu_torch.ops.image import align_crop, align_crop_batch

# ``facerecognition_tpu.ops`` re-exports functions named like its modules.
jwarp = importlib.import_module("facerecognition_tpu.ops.warp_mxu")
jimage = importlib.import_module("facerecognition_tpu.ops.image")
jdet = importlib.import_module("facerecognition_tpu.models.detector_net")
from facerecognition_tpu.ops.umeyama import ARCFACE_TEMPLATE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def T(a):
    return torch.from_numpy(np.array(a))


def _maps(rng, b, scale=(0.5, 1.6)):
    th = rng.uniform(-0.4, 0.4, b)
    sc = rng.uniform(*scale, b)
    ms = np.zeros((b, 2, 3), np.float32)
    ms[:, 0, 0], ms[:, 0, 1] = sc * np.cos(th), -sc * np.sin(th)
    ms[:, 1, 0], ms[:, 1, 1] = sc * np.sin(th), sc * np.cos(th)
    ms[:, :, 2] = rng.uniform(-10, 10, (b, 2))
    return ms


def _landmarks(rng, b, m, h, w):
    template = ARCFACE_TEMPLATE - ARCFACE_TEMPLATE.mean(0)
    ang = rng.uniform(-0.4, 0.4, (b, m))
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    lm = np.einsum("bmij,nj->bmni", rot, template) * rng.uniform(0.4, 0.9, (b, m, 1, 1))
    return (lm + rng.uniform([0.3 * w, 0.3 * h], [0.7 * w, 0.7 * h], (b, m, 1, 2))).astype(np.float32)


@pytest.mark.parametrize("pixels", ["uint8", "float"])
def test_int8_warp_equals_jax_given_its_matrices(rng, pixels):
    """``affine_warp_mxu_batch(fast="int8")`` bit for bit, uint8-valued
    frames and float frames with x.5 levels (rounded half to even), over
    several chunks (B > chunk)."""
    b, h, w = 20, 48, 60
    if pixels == "uint8":
        imgs = rng.integers(0, 256, (b, h, w, 3)).astype(np.float32)
    else:
        imgs = rng.uniform(-30, 290, (b, h, w, 3)).astype(np.float32)
        imgs[:, ::3] = np.floor(imgs[:, ::3]) + 0.5  # ties: 2.5 → 2, 3.5 → 4
    ms = _maps(rng, b)
    want = np.asarray(jwarp.affine_warp_mxu_batch(jnp.asarray(imgs), jnp.asarray(ms), 40, 36, 16, "int8"))
    got = twarp.affine_warp_mxu_batch(T(imgs), T(ms), 40, 36, 16, "int8").numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper's CPU route is the plain version
    np.testing.assert_array_equal(ws.affine_warp(T(imgs), T(ms), 40, 36, fast="int8").numpy(), want)


def test_int8_warp_tie_rounding(rng):
    """Half-pixel sample positions make each weight 0.5: round(63.5) is 64
    on both taps, so Σwq is 128, not 127 (the level is not divided back by
    the sum). Pinned against JAX and against the integer formula."""
    imgs = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.float32)
    ms = np.tile(np.array([[[1.0, 0.0, -0.5], [0.0, 1.0, -0.5]]], np.float32), (2, 1, 1))
    want = np.asarray(jwarp.affine_warp_mxu_batch(jnp.asarray(imgs), jnp.asarray(ms), 12, 12, 16, "int8"))
    got = twarp.affine_warp_mxu_batch(T(imgs), T(ms), 12, 12, 16, "int8").numpy()
    np.testing.assert_array_equal(got, want)
    # position i + 0.5 samples pixels i and i + 1 with weights 64 and 64
    p = imgs.astype(np.int64)
    mid127 = 64 * p[:, :12, :13] + 64 * p[:, 1:13, :13]
    r = np.float32(1.0) / np.float32(127.0)
    mid = np.clip(np.round(mid127.astype(np.float32) * r), 0, 255).astype(np.int64)
    out = (64 * mid[:, :, :12] + 64 * mid[:, :, 1:13]).astype(np.float32) * r
    np.testing.assert_array_equal(got, out)


def test_int8_align_through_landmarks_within_bound(rng):
    """``align_crop_mxu_batch`` and ``align_crop_mxu_window`` in the int8
    mode from landmarks: the closed-form Umeyama moves positions by ~1e-5
    px, which flips a rounded weight now and then (a level of a mid pixel,
    then up to 2 levels of the output): at most 2.02 levels anywhere, a mean
    below 0.01 (measured: 1.38 / 0.00043 whole-frame, 1.94 / 0.00039 window;
    under 0.1% of values differ)."""
    b, h, w = 6, 96, 96
    frames = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    lms = _landmarks(rng, b, 2, h, w)
    want = np.asarray(jwarp.align_crop_mxu_batch(jnp.asarray(frames), jnp.asarray(lms[:, 0]), 56, "int8"))
    got = ws.align_crop(T(frames), T(lms[:, :1]), 56, fast="int8").numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.02 and diff.mean() < 0.01, (diff.max(), diff.mean())
    want = np.asarray(jwarp.align_crop_mxu_window(jnp.asarray(frames), jnp.asarray(lms), 48, 64, "int8"))
    got = ws.align_crop_window(T(frames), T(lms), 48, 64, fast="int8").numpy()
    diff = np.abs(got - want)
    assert diff.max() <= 2.02 and diff.mean() < 0.01, (diff.max(), diff.mean())


def test_int8_resize_is_the_bf16_resize(rng):
    """JAX's resize takes "int8" as a true value (its bf16 path); so does
    the port's, and the detector input with it."""
    frames = rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    want = np.asarray(jwarp.bilinear_resize_mxu_batch(jnp.asarray(frames), 20, 28, "int8"))
    got = ws.bilinear_resize(T(frames), 20, 28, fast="int8").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ws.detector_input(T(frames), 32, fast="int8").numpy(),
                                  ws.detector_input(T(frames), 32, fast=True).numpy())


def test_int8_embedder_input_is_the_plain_composition(rng):
    frames = T(rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8))
    lms = T(_landmarks(rng, 2, 2, 32, 32))  # detector pixels (32²)
    got = ws.embedder_input(frames, lms, 32, 40, None, fast="int8")
    want = ws.embedder_input_plain(frames, lms, 32, 40, None, fast="int8")
    assert torch.equal(got, want)
    aligned = ws.align_crop(frames, ws.scale_landmarks(lms, 64, 64, 32), 40, fast="int8")
    assert torch.equal(got, (aligned / 255.0 - 0.5) / 0.5)


# -- the batch helpers -----------------------------------------------------------


def test_detect_best_face_batch_equals_jax_vmap(rng):
    """The port's batched argmax decode against JAX's ``vmap``: the argmax
    anchor's landmarks and score equal, boxes within 1e-4 px (XLA fuses
    cx ± w/2); ties go to the first anchor."""
    anchors = anchor_centers(128)
    raw = rng.normal(size=(5, len(anchors), 15)).astype(np.float32)
    raw[..., 0] *= 6.0
    raw[1, [7, 300], 0] = 50.0  # a tie at a saturated logit: the first anchor
    box, lm, score = detect_best_face_batch(T(raw), T(anchors))
    jbox, jlm, jscore = jdet.detect_best_face_batch(jnp.asarray(raw), jnp.asarray(anchors))
    np.testing.assert_allclose(box.numpy(), np.asarray(jbox), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lm.numpy(), np.asarray(jlm), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(score.numpy(), np.asarray(jscore))


def test_align_crop_batch_equals_jax_vmap(rng):
    """The batched gather alignment against JAX's ``vmap``: within 0.01
    levels (the closed-form Umeyama; ``align_crop``'s own bound in
    ``test_torch_staged.py``), and bit for bit with the port's one-image
    ``align_crop`` of each image."""
    frames = rng.integers(0, 256, (4, 80, 72, 3)).astype(np.uint8)
    lms = _landmarks(rng, 4, 1, 80, 72)[:, 0]
    got = align_crop_batch(T(frames), T(lms), 64)
    want = np.asarray(jimage.align_crop_batch(jnp.asarray(frames), jnp.asarray(lms), 64))
    assert np.abs(got.numpy() - want).max() <= 0.01
    for n in range(4):
        assert torch.equal(got[n], align_crop(T(frames[n]), T(lms[n]), 64))

"""Port ops against the JAX ops: Umeyama, affine inverse, resize, warp.

Inputs are made with numpy from a seed and handed to both; JAX runs on the
CPU. Tolerances are in the ops' own units (pixels or intensity levels).
"""

import importlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# ``facerecognition_tpu.ops`` re-exports functions named like its modules.
jimage = importlib.import_module("facerecognition_tpu.ops.image")
jumeyama = importlib.import_module("facerecognition_tpu.ops.umeyama")
jwarp = importlib.import_module("facerecognition_tpu.ops.warp_mxu")
from facerecognition_tpu_torch.ops import image as timage
# the port's ``ops`` binds the function ``umeyama``, as JAX's does
tumeyama = importlib.import_module("facerecognition_tpu_torch.ops.umeyama")
from facerecognition_tpu_torch.ops import warp_mxu as twarp


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _face_landmarks(rng, n, lo=0.5, hi=2.0, shift=150.0, noise=2.0):
    """Template landmarks scaled, rotated, shifted and jittered (frame px)."""
    ang = rng.uniform(-0.5, 0.5, n)
    rot = np.stack(
        [np.stack([np.cos(ang), -np.sin(ang)], -1), np.stack([np.sin(ang), np.cos(ang)], -1)], -2
    )
    lm = np.einsum("bij,nj->bni", rot, jumeyama.ARCFACE_TEMPLATE)
    lm = lm * rng.uniform(lo, hi, (n, 1, 1)) + rng.uniform(0, shift, (n, 1, 2))
    return (lm + rng.normal(0, noise, lm.shape)).astype(np.float32)


def test_template_is_the_same():
    np.testing.assert_array_equal(tumeyama.ARCFACE_TEMPLATE, jumeyama.ARCFACE_TEMPLATE)


def test_umeyama_matches_jax(rng):
    src = np.concatenate(
        [
            _face_landmarks(rng, 64),
            rng.uniform(0, 256, (8, 5, 2)).astype(np.float32),  # arbitrary point sets
            np.full((1, 5, 2), 7.0, np.float32),  # coincident: scale 0
            np.stack([np.zeros(5), np.arange(5) * 10.0], -1)[None].astype(np.float32),  # collinear
        ]
    )
    tmpl = jnp.asarray(jumeyama.ARCFACE_TEMPLATE)
    ref = np.asarray(jumeyama.umeyama_batch(jnp.asarray(src), tmpl))
    got = tumeyama.umeyama_batch(T(src), T(jumeyama.ARCFACE_TEMPLATE)).numpy()
    # Linear part within 1e-5. The translation is mu_dst - A·mu_src with
    # terms of a few hundred pixels, where float32 spacing is 3e-5: each
    # side is a few ulps from the float64 solution, so it is held to 1e-4 px.
    np.testing.assert_allclose(got[:, :, :2], ref[:, :, :2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, :, 2], ref[:, :, 2], atol=1e-4, rtol=0)
    one = tumeyama.umeyama(T(src[0]), T(jumeyama.ARCFACE_TEMPLATE)).numpy()
    np.testing.assert_allclose(one, got[0], atol=0, rtol=0)


def test_invert_affine_matches_jax(rng):
    src = _face_landmarks(rng, 64)
    tmpl = jnp.asarray(jumeyama.ARCFACE_TEMPLATE)
    ms = np.asarray(jumeyama.umeyama_batch(jnp.asarray(src), tmpl))
    ms = np.concatenate([ms, np.zeros((1, 2, 3), np.float32)])  # singular: identity guard
    ms[-1, :, 2] = [5.0, -3.0]
    ref = np.asarray(jax.vmap(jumeyama.invert_affine)(jnp.asarray(ms)))
    got = tumeyama.invert_affine(T(ms)).numpy()
    np.testing.assert_allclose(got[:, :, :2], ref[:, :, :2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[:, :, 2], ref[:, :, 2], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[-1], [[1, 0, -5], [0, 1, 3]])


def test_normalize_matches_jax(rng):
    img = rng.integers(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    ref = np.asarray(jimage.normalize_imagenet_style(jnp.asarray(img)))
    np.testing.assert_allclose(timage.normalize_imagenet_style(T(img)).numpy(), ref, atol=1e-7)


@pytest.mark.parametrize(
    "shape, out", [((96, 80, 3), (37, 61)), ((40, 50), (128, 128)), ((3, 64, 48, 3), (128, 100))]
)
def test_bilinear_resize_matches_jax_and_cv2(rng, shape, out):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got = timage.bilinear_resize(T(img), *out).numpy()
    ref = np.asarray(jimage.bilinear_resize(jnp.asarray(img), *out))
    np.testing.assert_allclose(got, ref, atol=1e-3)
    frames = img if len(shape) == 4 else img[None]
    gots = got if len(shape) == 4 else got[None]
    for f, g in zip(frames, gots):
        # cv2 interpolates uint8 in fixed point; within one level.
        cv = cv2.resize(f, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
        assert np.abs(np.rint(g).reshape(cv.shape) - cv.astype(np.float32)).max() <= 1.0


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape, out", [((4, 96, 80, 3), (40, 52)), ((2, 256, 256, 3), (128, 128))])
def test_bilinear_resize_mxu_matches_jax(rng, fast, shape, out):
    img = rng.integers(0, 256, shape).astype(np.float32)
    ref = np.asarray(jwarp.bilinear_resize_mxu_batch(jnp.asarray(img), *out, fast))
    got = twarp.bilinear_resize_mxu_batch(T(img), *out, fast).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 if not fast else 0.5)


def _warp_inputs(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (6, 96, 80, 3)).astype(np.float32)
    lm = _face_landmarks(rng, 6, lo=0.5, hi=0.9, shift=20.0, noise=1.5)
    ms = np.asarray(jwarp.umeyama_batch(jnp.asarray(lm), jnp.asarray(jwarp.ARCFACE_TEMPLATE)))
    return imgs, lm, ms


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_affine_warp_mxu_matches_jax(fast, seed):
    """Same matrices in: fast=False within 1e-3 level, fast=True within
    0.5 level (both come out equal up to float32 rounding of the sums)."""
    imgs, _, ms = _warp_inputs(seed)
    ref = np.asarray(
        jwarp.affine_warp_mxu_batch(jnp.asarray(imgs), jnp.asarray(ms), 112, 112, 16, fast)
    )
    got = twarp.affine_warp_mxu_batch(T(imgs), T(ms), 112, 112, 16, fast).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3 if not fast else 0.5)
    chunked = twarp.affine_warp_mxu_batch(T(imgs), T(ms), 112, 112, 4, fast).numpy()
    np.testing.assert_array_equal(chunked, got)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_align_crop_mxu_matches_jax(fast, seed):
    """From landmarks, each side solves its own similarity: the port in
    closed form, JAX by a 2x2 SVD. The matrices differ by ~5e-7 relative,
    which moves sample positions by ~1e-5 px. On pixel noise that is up to
    ~0.01 level in float32; with bf16 weights a rare weight rounds the other
    way, up to about one level at those pixels (ROADMAP Queue 3)."""
    imgs, lm, _ = _warp_inputs(seed)
    ref = np.asarray(jwarp.align_crop_mxu_batch(jnp.asarray(imgs), jnp.asarray(lm), 112, fast))
    got = twarp.align_crop_mxu_batch(T(imgs), T(lm), 112, fast).numpy()
    diff = np.abs(got - ref)
    if fast:
        assert diff.max() <= 1.5 and diff.mean() < 0.01, (diff.max(), diff.mean())
    else:
        assert diff.max() < 0.02 and diff.mean() < 1e-3, (diff.max(), diff.mean())


def test_affine_warp_rejects_int8_mode(rng):
    """The int8 mode is ported (``test_torch_warp_int8.py`` holds it to
    JAX); a mode that is none of False, True and "int8" is refused."""
    imgs = np.zeros((1, 8, 8, 3), np.float32)
    ms = np.eye(2, 3, dtype=np.float32)[None]
    with pytest.raises(ValueError, match="False, True or 'int8'"):
        twarp.affine_warp_mxu_batch(T(imgs), T(ms), 8, 8, fast="int4")
    assert twarp.affine_warp_mxu_batch(T(imgs), T(ms), 8, 8, fast="int8").shape == (1, 8, 8, 3)

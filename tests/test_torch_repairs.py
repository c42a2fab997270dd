"""Faults of the port against the JAX reference, each pinned by a test.

NaN ordering in the top-k, the streaming kernel's row cap, ``auto`` with
k > 32, the host resize of ``MicroBatcher``, the detector's input size
without weights, ``Gallery.add``'s normalisation, and the detector's
``backend`` parameter, its warning for an uncalibrated checkpoint and
``build_detector_net``'s default arch.
"""

import os
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.engine import Gallery as JGallery
from facerecognition_tpu.models.detector_net import build_detector_net as j_build_detector_net
from facerecognition_tpu.ops.matcher import cosine_topk as j_cosine_topk
from facerecognition_tpu.ops.pallas_topk import pallas_cosine_topk
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JFaceDetector
from facerecognition_tpu_torch.apps.serving import MicroBatcher
from facerecognition_tpu_torch.inference.engine import Gallery
from facerecognition_tpu_torch.models.detector_net import build_detector_net
from facerecognition_tpu_torch.ops import matcher
from facerecognition_tpu_torch.ops import stream_topk as st
from facerecognition_tpu_torch.ops.image import bilinear_resize_u8
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR, FaceDetector


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def test_order_key_is_lax_top_k_order():
    """Total order: -NaN < -inf < -1 < -0 < +0 < 1 < +inf < +NaN; equal keys
    go lowest index first."""
    x = np.array([1.0, np.nan, np.inf, -0.0, 0.0, -np.inf, np.nan, -1.0, 0.0], np.float32)
    x = np.concatenate([x, -np.abs(np.array([np.nan], np.float32))])  # a negative NaN
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), len(x))
    vals, idx = matcher.topk_lowest_index(T(x)[None], len(x))
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(ref_v))  # NaNs compare equal here


def _nan_inputs(rng, b=4, n=300, d=32):
    q = rng.normal(size=(b, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    q[1, 3] = np.nan  # every score of query 1 is NaN
    g[7, 0] = np.nan  # every query's score against row 7 is NaN
    return q, g


@pytest.mark.parametrize("k", [1, 5, 9])
def test_nan_scores_rank_as_jax(rng, k):
    """A NaN query and a NaN gallery row: JAX's indices through
    ``cosine_topk``, ``auto_cosine_topk`` and ``stream_topk_reference``
    (before, the port raised in ``reshape``), scores within 1e-5 with NaN
    where JAX has NaN."""
    q, g = _nan_inputs(rng)
    rs, ri = j_cosine_topk(jnp.asarray(q), jnp.asarray(g), k)
    ps, pi = pallas_cosine_topk(jnp.asarray(q), jnp.asarray(g), k=k, tile=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(pi), np.asarray(ri))
    for fn in (
        lambda: matcher.cosine_topk(T(q), T(g), k),
        lambda: matcher.auto_cosine_topk(T(q), T(g), k),
        lambda: st.stream_topk_reference(T(q), T(g), k),
        lambda: st.stream_topk(T(q), T(g), k),
    ):
        s, i = fn()
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)  # NaN == NaN
    assert i[1].tolist() == list(range(k)) and (i[[0, 2, 3], 0] == 7).all()


def test_nan_gallery_row_with_n_valid(rng):
    q, g = _nan_inputs(rng)
    rs, ri = j_cosine_topk(jnp.asarray(q), jnp.asarray(g), 4, False, 200)
    s, i = matcher.cosine_topk(T(q), T(g), 4, False, 200)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)


@pytest.mark.parametrize("b, n", [(4, 4_300_000), (128, 4_194_304), (1, 2**31 - 1)])
def test_stream_topk_takes_galleries_past_the_old_cap(b, n):
    """Above 4,194,304 rows of 512 the element count passes 2^31; the
    wrapper's checks accept it (meta tensors: nothing is allocated), and
    the plan covers every row in int-sized splits."""
    q = torch.empty(b, 512, device="meta")
    g = torch.empty(n, 512, device="meta")
    st._check(q, g, 5)
    for sms in (1, 132):
        p = st.plan(b, n, 5, sms)
        assert p.rows_per_split < 2**31 and p.rows_per_split % st.TILE_ROWS == 0
        assert (p.n_split - 1) * p.rows_per_split < n <= p.n_split * p.rows_per_split


def test_stream_topk_refuses_rows_past_int32():
    with pytest.raises(ValueError, match="2\\*\\*31"):
        st._check(torch.empty(2, 8, device="meta"), torch.empty(2**31, 8, device="meta"), 3)


def test_auto_takes_dense_for_k_above_the_kernel(rng, monkeypatch):
    """``auto`` on a card gallery past the memory switch picks the kernel
    only for k <= 32; k = 33 stays dense, as JAX serves it."""
    monkeypatch.setattr(matcher, "DENSE_SCORES_MAX_BYTES", 0)
    picked = []

    def fake_stream(q, g, k):
        picked.append(k)
        return matcher.cosine_topk(q, g, k)

    monkeypatch.setattr(st, "stream_topk", fake_stream)

    class CardTensor(torch.Tensor):
        """A CPU tensor that reports the card as its device."""

        @property
        def device(self):
            return torch.device("cuda", 0)

    q = T(rng.normal(size=(2, 16)).astype(np.float32))
    g = T(rng.normal(size=(40, 16)).astype(np.float32)).as_subclass(CardTensor)
    ref = matcher.cosine_topk(q, g.as_subclass(torch.Tensor), 33)
    s, i = matcher.auto_cosine_topk(q, g, 33)
    assert picked == [] and torch.equal(i, ref[1])
    matcher.auto_cosine_topk(q, g, 32)
    assert picked == [32]


@pytest.mark.parametrize("shape", [(480, 640), (720, 1280), (150, 170), (200, 200)])
def test_micro_batcher_resize_is_cv2_bit_for_bit(shape):
    """The host resize is OpenCV's uint8 INTER_LINEAR exactly (it differed by
    one level in 10-13% of the values before)."""
    frame = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3)).astype(np.uint8)
    ref = cv2.resize(frame, (256, 256), interpolation=cv2.INTER_LINEAR)
    batcher = MicroBatcher(None, frame_size=(256, 256))
    try:
        np.testing.assert_array_equal(batcher._prepare(frame), ref)
    finally:
        batcher.close()


@pytest.mark.parametrize(
    "shape, out", [((150, 170), (128, 96)), ((512, 512), (256, 256)), ((33, 47), (17, 11)), ((64, 64), (200, 13))]
)
def test_u8_resize_is_cv2_at_other_shapes(shape, out):
    """Down- and upscales, an exact 2x (OpenCV's area path) and odd widths."""
    img = np.random.default_rng(7).integers(0, 256, (*shape, 3)).astype(np.uint8)
    ref = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(bilinear_resize_u8(T(img), *out).numpy(), ref)


def test_detector_without_weights_at_other_sizes_names_blazeface():
    """JAX builds a random-init BlazeFaceNet there; the port must not load
    the 128² checkpoint for another input size, and builds a seeded
    random-init BlazeFaceNet with that size's anchors instead."""
    det = FaceDetector(input_size=96, device="cpu")
    assert det.arch == "blaze" and det._calibration is None
    assert type(det.net).__name__ == "BlazeFaceNet"
    assert det.anchors.shape == (504, 3)  # 12² · 2 + 6² · 6
    with torch.no_grad():
        assert det.net(torch.zeros(1, 96, 96, 3)).shape == (1, 504, 15)
    assert det.detect_all(np.zeros((96, 96, 3), np.uint8)) is not None
    assert FaceDetector(input_size=128, device="cpu").input_size == 128


def test_gallery_add_normalises_as_jax(rng):
    """``add`` divides by ||e|| + 1e-12 and ``add_many`` by max(||e||,
    1e-12), as the JAX methods; they differ for small norms."""
    small = (rng.normal(size=8) * 1e-7).astype(np.float32)
    big = rng.normal(size=(3, 8)).astype(np.float32)
    jg, pg = JGallery(8), Gallery(8, device="cpu")
    for g in (jg, pg):
        g.add("small", small)
        g.add_many(["a", "b", "c"], big)
        g.add_many(["tiny"], small[None] * 1e-3)
    np.testing.assert_array_equal(pg.matrix.numpy(), np.asarray(jg.matrix))
    assert pg.names == jg.names


SYNTHETIC = os.path.join(ASSETS_DIR, "detector_synthetic_128.msgpack")  # no calibration
CALIBRATED = os.path.join(ASSETS_DIR, "detector_v2_128.msgpack")


def test_detector_takes_the_blazeface_backend_first():
    """``backend`` is the first parameter, as in JAX: ``"blazeface"`` builds
    and is kept, anything else raises ``ValueError`` in both packages."""
    det = FaceDetector(backend="blazeface", device="cpu")
    assert det.backend == "blazeface"
    assert FaceDetector("blazeface", 0.5, device="cpu").confidence_threshold == 0.5
    for make in (FaceDetector, JFaceDetector):
        with pytest.raises(ValueError, match="mtcnn"):
            make("mtcnn", device="cpu") if make is FaceDetector else make("mtcnn")


@pytest.mark.parametrize("make", [FaceDetector, JFaceDetector], ids=["port", "jax"])
def test_uncalibrated_checkpoint_warns(make):
    """A checkpoint without a ``calibration`` key warns with JAX's text; a
    calibrated one does not."""
    kw = {"device": "cpu"} if make is FaceDetector else {}
    with pytest.warns(UserWarning, match="no 'calibration' key"):
        det = make(weights=SYNTHETIC, **kw)
    assert det._calibration is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        det = make(weights=CALIBRATED, **kw)
    assert det._calibration is not None


def test_build_detector_net_defaults_to_blaze():
    """Without an argument both packages build a BlazeFaceNet."""
    assert type(build_detector_net()) is type(build_detector_net("blaze"))
    assert type(build_detector_net()).__name__ == type(j_build_detector_net()).__name__ == "BlazeFaceNet"

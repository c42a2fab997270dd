"""The port's LBPH recognizer against the JAX package on the CPU.

The plain versions of the two kernels (``ops/lbph_hist``, ``ops/chi2_nn``)
and ``models/lbph.LBPHModel`` get the same numpy inputs as the JAX
functions. Bounds: LBP codes and histograms bit for bit (the plain version
follows XLA's CPU graph, ``tap_plan``; histograms are counts times the
float32 reciprocal of the cell size, as XLA folds the division); distances
within 1e-5 relative (16k terms summed in another order); nearest rows and
labels equal, on data whose margins exceed that bound. The kernel's own row
sum (``chi2_distances_kernel_order``) is held to the same bound, and shown
to give equal rows equal distances wherever they lie.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.models import lbph as jl
from facerecognition_tpu.models import lbph_tools as jtools
from facerecognition_tpu_torch.models import lbph as pl
from facerecognition_tpu_torch.models import lbph_tools as ptools
from facerecognition_tpu_torch.ops import chi2_nn as cn
from facerecognition_tpu_torch.ops import lbph_hist as lh

CONFIGS = [(1, 8), (2, 8), (3, 8), (1, 4), (2, 4), (1, 10), (2, 16)]


def T(a):
    return torch.from_numpy(np.array(a, np.float32))


def _images(rng):
    """Flat patches (the diagonal taps' rounding decides their bits),
    uniform noise, and blocky images with flat runs and edges."""
    flat = [np.full((14, 14), v, np.uint8) for v in (1, 7, 50, 100, 128, 200, 201, 255)]
    noise = [rng.integers(0, 256, (40, 44)).astype(np.uint8) for _ in range(2)]
    blocks = [
        np.repeat(np.repeat(rng.integers(0, 256, (16, 16)), b, 0), b, 1)[:48, :48].astype(np.uint8)
        for b in (2, 3, 5)
    ]
    return flat + noise + blocks + [(rng.random((30, 30)) * 255).astype(np.float32)]


@pytest.mark.parametrize("radius,neighbors", CONFIGS)
def test_codes_equal_jax(rng, radius, neighbors):
    for img in _images(rng):
        want = np.asarray(jl.lbp_code_image(jnp.asarray(img), radius, neighbors))
        got = lh.lbp_code_image(T(img), radius, neighbors).numpy()
        np.testing.assert_array_equal(got, want)


def test_flat_patches_need_the_fused_sums(monkeypatch):
    """On flat patches the diagonal taps miss the centre by ~1e-5, so a
    plain sum of rounded products gives other bits than XLA's graph at
    radius 3: the plan's fused multiply-adds are what make them equal."""
    img = np.full((14, 14), 201, np.uint8)
    want = np.asarray(jl.lbp_code_image(jnp.asarray(img), 3, 8))
    np.testing.assert_array_equal(lh.lbp_code_image(T(img), 3, 8).numpy(), want)
    plan = lh.tap_plan(3, 8)
    assert any(op != lh.ADD for ops in plan.ops for op in ops)
    unfused = lh.TapPlan(plan.offsets, plan.weights, tuple((lh.ADD,) * 3 for _ in plan.ops))
    monkeypatch.setattr(lh, "tap_plan", lambda radius, neighbors: unfused)
    assert (lh.lbp_code_image(T(img), 3, 8).numpy() != want).all()


def test_radius_one_plan_fuses_only_exact_products():
    """At radius 1 every diagonal product but the corner's is shared between
    two neighbours, so XLA fuses only the corner's, by 0.5 (exact): the
    codes are those of a plain sum of rounded products."""
    plan = lh.tap_plan(1, 8)
    for n in (1, 3, 5, 7):
        steps = [(0, plan.ops[n][0]), (2, plan.ops[n][1]), (3, plan.ops[n][2])]
        fused = [
            (1 if op == lh.FMA_RIGHT else 0) if term == 0 else term
            for term, op in steps
            if op != lh.ADD
        ]
        assert [plan.weights[n][t] for t in fused] == [0.5]


@pytest.mark.parametrize("radius,neighbors,gx,gy", [(1, 8, 8, 8), (2, 8, 5, 4), (1, 8, 7, 3), (1, 4, 3, 3)])
def test_histograms_equal_jax(rng, radius, neighbors, gx, gy):
    imgs = rng.integers(0, 256, (3, 100, 100)).astype(np.float32)
    imgs[1, 20:70, 10:60] = 128.0  # a flat region
    want = np.stack([
        np.asarray(jl.lbph_features(jnp.asarray(x), radius, neighbors, gx, gy, 2**neighbors))
        for x in imgs
    ])
    got = lh.lbph_hist(T(imgs), radius, neighbors, gx, gy).numpy()
    np.testing.assert_array_equal(got, want)
    one = pl.lbph_features(T(imgs[0]), radius, neighbors, gx, gy, 2**neighbors).numpy()
    np.testing.assert_array_equal(one, want[0])


def test_histograms_multiply_by_the_reciprocal(rng):
    """XLA folds the division by a cell's pixel count into a product with
    its float32 reciprocal; at 448-pixel cells a true division rounds some
    bins otherwise."""
    imgs = rng.integers(0, 256, (2, 100, 100)).astype(np.float32)
    want = np.stack([np.asarray(jl.lbph_features(jnp.asarray(x), 1, 8, 7, 3, 256)) for x in imgs])
    got = lh.lbph_hist(T(imgs), 1, 8, 7, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = got * 448  # exact: the counts times 448 · float32(1/448) round back
    counts = torch.round(counts)
    divided = (counts / torch.full_like(counts, 448.0)).numpy()
    assert (divided != want).any()


def test_golden_fixture():
    rec = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "lbph_golden.npz"))
    feats = lh.lbph_hist(T(rec["image"][None]), 2, 8, 5, 4)[0]
    np.testing.assert_allclose(feats.numpy(), rec["features"], atol=1e-6)
    d = pl.chi2_alt_distances(feats, T(rec["gallery"])).numpy()
    np.testing.assert_allclose(d, rec["distances"], rtol=1e-5)


def test_cell_without_pixels_raises():
    with pytest.raises(ValueError, match="no pixel"):
        lh.lbph_hist(torch.zeros(1, 10, 10), 1, 8, 9, 9)


def _histograms(rng, n, f=4096, zero_share=0.6):
    h = np.abs(rng.normal(size=(n, f))).astype(np.float32)
    h[rng.random((n, f)) < zero_share] = 0.0  # empty bins, as LBP histograms have
    return h


def test_chi2_distances_equal_jax(rng):
    q, g = _histograms(rng, 3), _histograms(rng, 50)
    want = np.asarray(jl._chi2_batch(jnp.asarray(q), jnp.asarray(g)))
    got = cn.chi2_distances(T(q), T(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        cn.chi2_alt_distances(T(q[0]), T(g)).numpy(),
        np.asarray(jl.chi2_alt_distances(jnp.asarray(q[0]), jnp.asarray(g))),
        rtol=1e-5,
    )
    # the kernel's summation order, and a ragged F (zero terms past the end)
    for f in (4096, 1000):
        k = cn.chi2_distances_kernel_order(T(q[:, :f]), T(g[:, :f])).numpy()
        ref = np.asarray(jl._chi2_batch(jnp.asarray(q[:, :f]), jnp.asarray(g[:, :f])))
        np.testing.assert_allclose(k, ref, rtol=1e-5)


def test_kernel_order_is_the_same_for_every_row(rng):
    """A row's distance in the kernel's order does not depend on where the
    row lies: the same row at positions 3 and 41 gives the same bits."""
    q, g = _histograms(rng, 2), _histograms(rng, 50)
    g[41] = g[3]
    d = cn.chi2_distances_kernel_order(T(q), T(g)).numpy()
    assert (d[:, 3] == d[:, 41]).all()
    alone = cn.chi2_distances_kernel_order(T(q), T(g[41:42])).numpy()
    assert (alone[:, 0] == d[:, 41]).all()


def test_nearest_takes_the_lower_index(rng):
    q, g = _histograms(rng, 3), _histograms(rng, 40)
    g[30] = g[7]
    q[0] = g[7]  # distance 0 at rows 7 and 30
    q[1] = g[30] * 1.0001  # rows 7 and 30 tie, away from zero
    best, idx = cn.chi2_nn(T(q), T(g))
    assert idx.tolist()[:2] == [7, 7] and best[0].item() == 0.0
    d = np.asarray(jl._chi2_batch(jnp.asarray(q), jnp.asarray(g)))
    np.testing.assert_array_equal(idx.numpy(), np.argmin(d, axis=1))
    np.testing.assert_allclose(best.numpy(), d.min(axis=1), rtol=1e-5, atol=1e-7)
    best2, idx2, dists = cn.chi2_nn(T(q), T(g), return_distances=True)
    assert torch.equal(idx2, idx) and dists.shape == (3, 40)
    nan = dists.clone()
    nan[2, 11] = float("nan")
    assert cn.nearest(nan)[1][2].item() == 11  # NaN first, as np.argmin


def _striped(rng, n_classes=3, per_class=5, size=60):
    """Noise plus a per-class stripe period (tests/test_lbph.py's data)."""
    images, labels = [], []
    for c in range(n_classes):
        for _ in range(per_class):
            img = rng.integers(0, 100, (size, size)).astype(np.uint8)
            img[:: c + 2, :] = 220
            images.append(img)
            labels.append(c)
    return np.stack(images), np.array(labels)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(5)
    images, labels = _striped(rng)
    probes = []
    for c in range(3):
        img = rng.integers(0, 100, (60, 60)).astype(np.uint8)
        img[:: c + 2, :] = 220
        probes.append(img)
    jm, pm = jl.LBPHModel(), pl.LBPHModel(device="cpu")
    jm.train(images, labels)
    pm.train(images, labels)
    return images, labels, np.stack(probes), jm, pm


def test_model_train_predict_equal_jax(models):
    images, labels, probes, jm, pm = models
    np.testing.assert_array_equal(pm.histograms, jm.histograms)
    np.testing.assert_array_equal(pm.labels, jm.labels)
    for img in list(probes) + [images[0], images[7] // 2 + 10]:
        (jlab, jconf), (plab, pconf) = jm.predict(img), pm.predict(img)
        assert plab == jlab
        np.testing.assert_allclose(pconf, jconf, rtol=1e-5, atol=1e-6)
    jlabs, jconfs = jm.predict_batch(np.concatenate([probes, images]))
    plabs, pconfs = pm.predict_batch(np.concatenate([probes, images]), probe_chunk=4)
    np.testing.assert_array_equal(plabs, jlabs)
    np.testing.assert_allclose(pconfs, jconfs, rtol=1e-5, atol=1e-6)
    assert plabs.dtype == np.int64 and pconfs.dtype == np.float64


def test_predict_topk_keeps_the_tie_order(models):
    """Identities at equal distance come in the order they first appear in
    the training set (the JAX model's stable sort of its dict)."""
    images, labels, probes, _, _ = models
    extra = np.stack([images[0], images[0], images[5]])
    lab = np.concatenate([labels, [9, 4, 7]])  # 9 and 4 tie with label 0's image 0
    jm, pm = jl.LBPHModel(), pl.LBPHModel(device="cpu")
    for m in (jm, pm):
        m.train(np.concatenate([images, extra]), lab)
    for img in (images[0], probes[1]):
        want, got = jm.predict_topk(img, k=5), pm.predict_topk(img, k=5)
        assert [lab for lab, _ in got] == [lab for lab, _ in want]
        np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-5, atol=1e-6)
    assert [lab for lab, _ in pm.predict_topk(images[0], k=3)] == [0, 9, 4]
    assert len(pm.predict_topk(images[0], k=99)) == 6


def test_update_threshold_and_errors(models):
    images, labels, probes, _, _ = models
    jm, pm = jl.LBPHModel(threshold=1e-9), pl.LBPHModel(threshold=1e-9, device="cpu")
    with pytest.raises(RuntimeError, match="not trained"):
        pm.predict(images[0])
    for m in (jm, pm):
        m.train(images[:10], labels[:10])
        m.update(images[10:], labels[10:])
    np.testing.assert_array_equal(pm.histograms, jm.histograms)
    assert pm.predict(images[3] // 2 + 10)[0] == jm.predict(images[3] // 2 + 10)[0] == -1
    assert pm.predict(images[12])[0] == jm.predict(images[12])[0] == labels[12]
    with pytest.raises(ValueError, match="length mismatch"):
        pm.train(images, labels[:2])
    assert len(pm.histograms) == len(pm.labels) == len(images)


def test_save_load_across_packages(models, tmp_path):
    images, labels, probes, jm, pm = models
    pm.threshold = 1e6
    pm.save(tmp_path / "port.npz")
    pm.threshold = float("inf")
    j_loaded = jl.LBPHModel.load(tmp_path / "port.npz")
    assert j_loaded.threshold == 1e6 and j_loaded.radius == 1
    np.testing.assert_array_equal(j_loaded.histograms, jm.histograms)
    assert j_loaded.predict(probes[2])[0] == jm.predict(probes[2])[0]
    jm.save(tmp_path / "jax.npz")
    p_loaded = pl.LBPHModel.load(tmp_path / "jax", device="cpu")  # the suffix is optional
    np.testing.assert_array_equal(p_loaded.histograms, pm.histograms)
    assert p_loaded.predict(probes[2]) == pm.predict(probes[2])


def test_chunked_features_match_unchunked(models):
    images, _, _, _, pm = models
    whole = pm._compute_histograms(images)
    for chunk in (1, 4, 7):
        np.testing.assert_array_equal(pm._compute_histograms(images, chunk=chunk), whole)


def test_recognize_face_equal_jax(models):
    images, labels, probes, jm, pm = models
    names = {0: "ann", 1: "bo", 2: "cy"}
    for img in probes:
        for kw in ({}, {"label_map": names}, {"threshold": 1e-9}):
            want = jtools.recognize_face(jm, img, **kw)
            got = ptools.recognize_face(pm, img, **kw)
            assert {k: got[k] for k in ("identity", "label", "recognized")} == {
                k: want[k] for k in ("identity", "label", "recognized")
            }
            np.testing.assert_allclose(got["confidence"], want["confidence"], rtol=1e-5)
    assert pm.threshold == float("inf")  # restored after the call

"""The port's evaluation and explainability against the JAX package on the CPU.

The metrics (numpy in the port) against the JAX functions (sklearn-backed)
on seeded random inputs with ties, labels on one side only and unknown
(-1) predictions: equal within 1e-12 (the same float64 formulas), the ROC's
points and thresholds equal. ``evaluate_recognition_engine`` and
``generate_report`` on a JAX engine and a port engine with the same
weights: classification metrics, top-k, CMC and DIR equal, scores used as
thresholds within 1e-5, verification AUC/EER within 1e-6; the same
results give the same report. Grad-CAM and activation-CAM with and
without a target on a (1, 1, 1, 1) ResNet ArcFace (flax weights carried
over with convert.py): CAMs in [0, 1] within 1e-3, embeddings within 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from facerecognition_tpu.inference import evaluate as jev
from facerecognition_tpu.inference import explainability as jx
from facerecognition_tpu.inference import extract_embeddings as jee
from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.models.arcface import ArcFaceModel as JArcFace
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.inference import evaluate as pev
from facerecognition_tpu_torch.inference import explainability as px
from facerecognition_tpu_torch.inference import extract_embeddings as pee
from facerecognition_tpu_torch.inference.engine import RecognitionEngine
from facerecognition_tpu_torch.models.arcface import ArcFaceModel


def _labels(rng, n, c, unknown=0.0):
    y_true = rng.integers(0, c, n)
    y_pred = np.where(rng.random(n) < 0.6, y_true, rng.integers(0, c + 2, n))
    y_pred[rng.random(n) < unknown] = -1
    return y_true, y_pred


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compute_metrics_equals_sklearn(seed):
    rng = np.random.default_rng(seed)
    for n, c, unknown in ((50, 4, 0.0), (200, 12, 0.1), (7, 30, 0.3), (1, 1, 0.0)):
        y_true, y_pred = _labels(rng, n, c, unknown)
        got, want = pev.compute_metrics(y_true, y_pred), jev.compute_metrics(y_true, y_pred)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert pev.compute_metrics([0, 1, 2, 1], [0, 1, 2, 1])["f1_macro"] == 1.0
    assert pev.compute_metrics([0, 0], [1, 1]) == jev.compute_metrics([0, 0], [1, 1])


def _tied_scores(rng, n, c):
    return np.round(rng.random((n, c)), 1)  # few distinct values: many ties


def test_ranking_metrics_equal_jax(rng):
    scores, y = _tied_scores(rng, 60, 9), rng.integers(0, 9, 60)
    assert pev.top_k_accuracy(scores, y, (1, 3, 5)) == jev.top_k_accuracy(scores, y, (1, 3, 5))
    for rank in (3, 20):
        assert pev.cmc_curve(scores, y, rank) == jev.cmc_curve(scores, y, rank)
    known = rng.random(60) < 0.6
    for fars in ((0.1, 0.01), (0.5,)):
        assert pev.open_set_identification(scores, y, known, fars) == \
            jev.open_set_identification(scores, y, known, fars)
    assert pev.open_set_identification(scores, y, np.ones(60, bool))["dir_at_far_0.01"] is None
    y_pred = np.where(rng.random(60) < 0.7, y, (y + 1) % 9)
    top = scores.max(1)
    for kw in ({}, {"known_mask": known}, {"thresholds": np.array([0.2, 0.5, 0.5, 0.9])}):
        assert pev.threshold_sweep(y, y_pred, top, **kw) == jev.threshold_sweep(y, y_pred, top, **kw)


@pytest.mark.parametrize("case", ["ties", "separable", "two", "inverted"])
def test_roc_eer_equals_sklearn(rng, case):
    if case == "ties":
        truth = rng.integers(0, 2, 300)
        scores = np.round(rng.random(300) * 0.5 + truth * 0.3, 1)
    elif case == "separable":
        truth = np.r_[np.ones(300), np.zeros(300)]
        scores = np.r_[rng.normal(0.8, 0.05, 300), rng.normal(0.2, 0.05, 300)]
    elif case == "two":
        truth, scores = np.array([0, 1]), np.array([0.3, 0.7])
    else:
        truth = rng.integers(0, 2, 80)
        scores = rng.random(80) - truth * 0.4
    got, want = pev.roc_eer(truth, scores), jev.roc_eer(truth, scores)
    for k in ("fpr", "tpr", "thresholds"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("auc", "eer", "eer_threshold"):
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert np.isinf(got["thresholds"][0])


def test_plots(rng, tmp_path):
    roc = pev.roc_eer(rng.integers(0, 2, 50), rng.random(50))
    assert os.path.exists(pev.plot_roc_curve(roc, str(tmp_path / "roc.png")))
    y = rng.integers(0, 30, 100)
    path = pev.plot_confusion_matrix(y, np.where(rng.random(100) < 0.5, y, -1),
                                     [f"n{i}" for i in range(30)], str(tmp_path / "cm.png"))
    assert os.path.exists(path)


# -- the engine-level evaluation ---------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """The shipped ultraslim ArcFace in a JAX engine and a port engine (no
    detector: whole images), the same four identities enrolled."""
    ckpt = jee.default_arcface_checkpoint()
    j = JEngine(embedder=jee.load_arcface_model(ckpt), threshold=0.2)
    p = RecognitionEngine(embedder=pee.load_arcface_model(ckpt, device="cpu"), threshold=0.2,
                          device="cpu")
    rng = np.random.default_rng(8)
    names = [f"p{i}" for i in range(5)]
    base = {n: rng.integers(0, 256, (112, 112, 3), dtype=np.uint8) for n in names}
    for e in (j, p):
        for n in names[:4]:  # p4 is not enrolled: the open-set rows
            assert e.add_to_db(n, [base[n]])
    images, labels = [], []
    for i, n in enumerate(names):
        for _ in range(3):
            noisy = np.clip(base[n].astype(int) + rng.integers(-40, 40, base[n].shape), 0, 255)
            images.append(noisy.astype(np.uint8))
            labels.append(i)
    return j, p, np.stack(images), np.asarray(labels), names


def test_evaluate_recognition_engine_equals_jax(engines, tmp_path):
    j, p, images, labels, names = engines
    got = pev.evaluate_recognition_engine(p, images, labels, names, output_dir=str(tmp_path / "p"))
    want = jev.evaluate_recognition_engine(j, images, labels, names)
    assert got["metrics"] == pytest.approx(want["metrics"], abs=1e-12)
    for k in ("top_1_accuracy", "top_5_accuracy", "cmc"):
        assert got[k] == want[k], k
    assert got["open_set"].keys() == want["open_set"].keys()
    for k, v in want["open_set"].items():  # thresholds are scores: within 1e-5
        assert got["open_set"][k] == (pytest.approx(v, abs=1e-5) if "threshold" in k else v), k
    assert got["metrics"]["accuracy"] == pytest.approx(0.8)  # the unenrolled third is wrong
    for k in ("auc", "eer"):
        assert got["verification"][k] == pytest.approx(want["verification"][k], abs=1e-6)
    ts, jts = got["threshold_sweep"], want["threshold_sweep"]
    assert [r["accuracy"] for r in ts["sweep"]] == [r["accuracy"] for r in jts["sweep"]]
    np.testing.assert_allclose([r["threshold"] for r in ts["sweep"]],
                               [r["threshold"] for r in jts["sweep"]], atol=1e-4)
    for f in ("roc.png", "confusion.png"):
        assert os.path.exists(tmp_path / "p" / f)
    got["speed"] = pev.measure_latency_throughput(p, images[:8], batch_sizes=(8, 32))
    sp = got["speed"]
    assert sp["avg_latency_ms"] > 0 and sp["max_throughput"] > 0
    assert set(sp["throughput_img_per_s"]) == {8}  # 32 > the 8 images: skipped
    report = open(pev.generate_report(got, str(tmp_path / "report.md"))).read()
    assert "top_1_accuracy" in report and "AUC" in report and "## Speed" in report
    for res in (want, got):  # the same results give the same text
        assert open(pev.generate_report(res, str(tmp_path / "p.md"))).read() == \
            open(jev.generate_report(res, str(tmp_path / "j.md"))).read()


def test_closed_set_accuracy_ignores_engine_threshold(engines):
    _, p, images, labels, names = engines
    p.set_threshold(0.999)
    try:
        res = pev.evaluate_recognition_engine(p, images[:12], labels[:12], names)
    finally:
        p.set_threshold(0.2)
    assert res["metrics"]["accuracy"] == 1.0


# -- Grad-CAM and activation-CAM ---------------------------------------------------------------


class TinyJaxEmbedder(jee.Embedder):
    """A random (1, 1, 1, 1) ResNet ArcFace embedder (JAX)."""

    def __init__(self):
        config = jee.EmbedderConfig("arcface", 512, 112, jnp.float32, (1, 1, 1, 1))
        model = JArcFace(embedding_size=512, dtype=jnp.float32, stage_sizes=(1, 1, 1, 1))
        variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 112, 112, 3)))
        super().__init__(config, variables)


@pytest.fixture(scope="module")
def tiny():
    j = TinyJaxEmbedder()
    model = ArcFaceModel(512, (1, 1, 1, 1))
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, j.variables))
    p = pee.Embedder(pee.EmbedderConfig("arcface", 512, 112, (1, 1, 1, 1)), model, device="cpu")
    return j, p


def test_feature_map_reentry_equals_jax(tiny, rng):
    j, p = tiny
    x = rng.normal(size=(2, 112, 112, 3)).astype(np.float32)
    emb, fmap = j.model.apply(j.variables, jnp.asarray(x), return_feature_map=True)
    import torch

    with torch.no_grad():
        pemb, pfmap = p.model(torch.from_numpy(x), return_feature_map=True)
        again = p.model(None, feature_map=pfmap)
        plain = p.model(torch.from_numpy(x))
    np.testing.assert_allclose(pfmap.permute(0, 2, 3, 1).numpy(), np.asarray(fmap), atol=1e-4)
    np.testing.assert_allclose(pemb.numpy(), np.asarray(emb), atol=1e-4)
    np.testing.assert_allclose(again.numpy(), pemb.numpy(), atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), pemb.numpy(), atol=0)
    jagain = j.model.apply(j.variables, None, feature_map=fmap)
    np.testing.assert_allclose(np.asarray(jagain), np.asarray(emb), atol=1e-5)


def test_gradcam_equals_jax(tiny, rng):
    j, p = tiny
    img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
    target = rng.normal(size=512).astype(np.float32)
    jeng, peng = jx.ExplainabilityEngine(j), px.ExplainabilityEngine(p)
    outs = {}
    for name, t in (("plain", None), ("target", target)):
        got, want = peng.explain(img, target_embedding=t), jeng.explain(img, target_embedding=t)
        assert got["cam"].shape == (112, 112)
        assert 0.0 <= got["cam"].min() and got["cam"].max() <= 1.0
        np.testing.assert_allclose(got["cam"], want["cam"], atol=1e-3, err_msg=name)
        np.testing.assert_allclose(got["embedding"], want["embedding"], atol=1e-4)
        for k in ("overlay", "heatmap", "face"):
            assert got[k].shape == want[k].shape and got[k].dtype == np.uint8, k
            assert np.abs(got[k].astype(int) - want[k].astype(int)).max() <= 1, k
        outs[name] = got["cam"]
    assert not np.allclose(outs["plain"], outs["target"])  # a target changes the CAM
    cam, emb = px.GradCAM(p.model).generate(img, out_size=56)
    assert cam.shape == (56, 56) and emb.shape == (512,)


def test_activation_cam_equals_jax(tiny, rng):
    j, p = tiny
    img = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
    got = px.ActivationCAM(p.model).generate(img)
    want = jx.ActivationCAM(j.model, j.variables).generate(img)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)


def test_heatmap_and_overlay_equal_jax(rng):
    cam = rng.random((40, 40)).astype(np.float32)
    np.testing.assert_array_equal(px.cam_to_heatmap(cam), jx.cam_to_heatmap(cam))
    img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
    np.testing.assert_array_equal(px.overlay_heatmap(img, cam), jx.overlay_heatmap(img, cam))
    big = rng.integers(0, 256, (70, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(px.overlay_heatmap(big, cam), jx.overlay_heatmap(big, cam))


def test_explain_with_detector_and_paths(tiny, tmp_path):
    """A fixture file through the detector, the alignment and Grad-CAM in
    both packages."""
    from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    j, p = tiny
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "facerecognition_tpu_torch", "fixtures", "faces", "id3", "3_rgb.png")
    got = px.ExplainabilityEngine(p, FaceDetector(device="cpu")).explain(path)
    want = jx.ExplainabilityEngine(j, JDetector()).explain(path)
    assert np.abs(got["face"].astype(int) - want["face"].astype(int)).max() <= 1
    np.testing.assert_allclose(got["cam"], want["cam"], atol=1e-3)
    with pytest.raises(FileNotFoundError):
        px.ExplainabilityEngine(p).explain(str(tmp_path / "missing.png"))

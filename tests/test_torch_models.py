"""Port models against the flax models: DenseDetNet, ResNet/ArcFace, decode.

Weights are the shipped assets (read by the port's own reader) or flax
random initialisations carried across by ``convert.py``; inputs are numpy
from a seed. The bar for raw outputs is the one of tests/test_port_torch.py:
max |Δ| / max |ref| < 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.models.arcface import ArcFaceModel as JArcFace
from facerecognition_tpu.models.detector_net import (
    BlazeFaceNet as JBlazeFaceNet,
    DenseDetNet as JDenseDetNet,
    anchor_centers as j_anchor_centers,
    decode_predictions as j_decode,
    detect_best_face_batch as j_detect_best_face_batch,
)
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu.utils.serialization import load_variables as j_load_variables
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.inference.extract_embeddings import (
    default_arcface_checkpoint,
    load_arcface_checkpoint,
    load_arcface_model,
)
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.models.detector_net import (
    DenseDetNet,
    anchor_centers,
    build_detector_net,
    decode_predictions,
    detect_best_face,
)
from facerecognition_tpu_torch.preprocessing.face_detector import (
    FaceDetector,
    default_detector_checkpoint,
    load_detector_checkpoint,
)

REL = 1e-4


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def detector_assets():
    path = default_detector_checkpoint()
    assert os.path.basename(path) == "detector_v4_128.msgpack"
    variables = j_load_variables(path)
    jvars = {"params": variables["params"]}
    det = FaceDetector(confidence_threshold=0.0, min_face_size=0, device="cpu")
    return jvars, det


def test_detector_checkpoint_markers(detector_assets):
    _, det = detector_assets
    assert det.arch == "dense"
    np.testing.assert_allclose(det._calibration, (3.810025498963256, 3.9871831792455183))
    assert sum(p.numel() for p in det.net.parameters()) == 575_240
    arch, variables, cal = load_detector_checkpoint({"params": {}})
    assert arch == "blaze" and cal is None
    blaze = build_detector_net("blaze")
    flax_vars = JBlazeFaceNet().init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    assert sum(p.numel() for p in blaze.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(flax_vars)
    ) == 63_494


def test_anchor_centers_match():
    np.testing.assert_array_equal(anchor_centers(128), j_anchor_centers(128))
    assert anchor_centers(128).shape == (896, 3)


def test_dense_detnet_on_v4_asset(detector_assets):
    jvars, det = detector_assets
    rng = np.random.default_rng(0)
    frames = scene_batch(rng, 3, 128)[0]
    x = (frames / 127.5 - 1.0).astype(np.float32)
    ref = np.asarray(JDenseDetNet().apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = det.net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 896, 15)
    assert _rel_err(got, ref) < REL
    np.testing.assert_array_equal(got[:, :, 0].argmax(1), ref[:, :, 0].argmax(1))
    anchors = j_anchor_centers(128)
    jb, jl, js = (
        np.asarray(v) for v in j_detect_best_face_batch(jnp.asarray(ref), jnp.asarray(anchors))
    )
    tb, tl, ts = (v.numpy() for v in detect_best_face(torch.from_numpy(got), det.anchors))
    np.testing.assert_allclose(tl, jl, atol=1e-3)  # landmarks, px
    np.testing.assert_allclose(tb, jb, atol=1e-3)
    np.testing.assert_allclose(ts, js, atol=1e-5)


@pytest.mark.parametrize("size", [72, 96])
def test_dense_detnet_random_init_carried_across(size):
    """flax-initialised weights through convert.py; 72 puts an odd input
    under the stride-2 d3 conv (SAME pads (1, 1) there, (0, 1) on even)."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    jnet = JDenseDetNet()
    jvars = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(jnet.apply(jvars, jnp.asarray(x)))
    net = DenseDetNet()
    load_flax_variables(net, jax.tree_util.tree_map(np.asarray, jvars))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert _rel_err(got, ref) < REL


def test_decode_predictions_match(rng):
    raw = rng.normal(size=(2, 896, 15)).astype(np.float32)
    anchors = j_anchor_centers(128)
    decode = jax.vmap(j_decode, in_axes=(0, None))
    ref = [np.asarray(v) for v in decode(jnp.asarray(raw), jnp.asarray(anchors))]
    got = [v.numpy() for v in decode_predictions(torch.from_numpy(raw), torch.from_numpy(anchors))]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-6)


def test_arcface_ultraslim_on_its_asset():
    path = default_arcface_checkpoint()
    assert os.path.basename(path) == "arcface_synthid9k_ultraslim_512.msgpack"
    variables = j_load_variables(path)
    stages = tuple(int(v) for v in np.asarray(variables["stage_sizes"]))
    jvars = {k: variables[k] for k in ("params", "batch_stats")}
    x = np.random.default_rng(5).normal(size=(2, 112, 112, 3)).astype(np.float32)
    ref = np.asarray(JArcFace(embedding_size=512, stage_sizes=stages).apply(jvars, jnp.asarray(x)))
    model = load_arcface_checkpoint(path).eval()
    assert model.stage_sizes == stages == (1, 1, 1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 512)
    assert _rel_err(got, ref) < REL


def test_arcface_random_init_carried_across():
    """A flax-initialised (1,1,1,1) ArcFace (margin head included, which
    convert.py skips) with perturbed BN statistics."""
    x = np.random.default_rng(3).normal(size=(2, 112, 112, 3)).astype(np.float32)
    jmodel = JArcFace(num_classes=10, embedding_size=128, stage_sizes=(1, 1, 1, 1))
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.zeros((2,), jnp.int32))
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    rng = np.random.default_rng(7)
    jvars["batch_stats"] = jax.tree_util.tree_map(
        lambda v: (v + rng.uniform(0.5, 1.5, v.shape)).astype(np.float32), jvars["batch_stats"]
    )
    ref = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))
    model = ArcFaceModel(128, (1, 1, 1, 1))
    load_flax_variables(model, jvars)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert _rel_err(got, ref) < REL


def test_embedder_normalizes_and_resizes():
    emb = load_arcface_model(stage_sizes=(1, 1, 1, 1), device="cpu", seed=3)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 120, 100, 3)).astype(np.uint8)
    out = emb.embed_uint8(imgs)
    assert out.shape == (3, 512)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)
    again = load_arcface_model(stage_sizes=(1, 1, 1, 1), device="cpu", seed=3).embed_uint8(imgs)
    np.testing.assert_array_equal(out, again)  # the seed alone fixes the weights

"""BlazeFaceNet in the port against the flax model, on the shipped blaze
checkpoints and on flax initialisations carried across by ``convert.py``.

Raw outputs are held to tests/test_torch_models.py's bar: max |Δ| / max
|ref| < 1e-4 (the convolutions sum in another order). Through the detector
and the fused engine the bounds of tests/test_torch_crowd.py hold: boxes and
landmarks within 0.01 px, calibrated confidences within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.inference.extract_embeddings import load_arcface_model as j_load_arcface
from facerecognition_tpu.models.detector_net import BlazeFaceNet as JBlazeFaceNet
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu.utils.serialization import load_variables as j_load_variables
from facerecognition_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from facerecognition_tpu_torch.inference.engine import RecognitionEngine
from facerecognition_tpu_torch.inference.extract_embeddings import (
    default_arcface_checkpoint,
    load_arcface_model,
)
from facerecognition_tpu_torch.models.detector_net import BlazeFaceNet, anchor_centers
from facerecognition_tpu_torch.preprocessing.face_detector import (
    ASSETS_DIR,
    FaceDetector,
    random_blaze_net,
)

REL = 1e-4
V2 = f"{ASSETS_DIR}/detector_v2_128.msgpack"
SYNTHETIC = f"{ASSETS_DIR}/detector_synthetic_128.msgpack"


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def v2():
    variables = j_load_variables(V2)
    det = FaceDetector(weights=V2, confidence_threshold=0.0, min_face_size=0, device="cpu")
    return {"params": variables["params"]}, det


@pytest.mark.parametrize("path", [V2, SYNTHETIC], ids=["v2", "synthetic"])
def test_blaze_checkpoints_forward_as_flax(path):
    variables = j_load_variables(path)
    jvars = {"params": variables["params"]}
    det = FaceDetector(weights=path, device="cpu")
    assert det.arch == "blaze"
    frames = scene_batch(np.random.default_rng(4), 3, 128)[0]
    x = (frames / 127.5 - 1.0).astype(np.float32)
    ref = np.asarray(JBlazeFaceNet().apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = det.net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 896, 15)
    assert _rel_err(got, ref) < REL


def test_v2_calibration_and_leaves(v2):
    """The converter carries every flax leaf (depthwise kernels (5, 5, 1,
    cin) as (cin, 1, 5, 5)) and nothing else; the Platt calibration rides
    along."""
    jvars, det = v2
    np.testing.assert_allclose(det._calibration, (7.95680570602417, 7.140503406524658))
    sd = flax_to_state_dict(jvars)
    leaves = jax.tree_util.tree_leaves_with_path(jvars["params"])
    assert len(sd) == len(leaves) == len(det.net.state_dict())
    for path, leaf in leaves:
        names = [p.key for p in path]
        module = ".".join(names[:-1])
        got = sd[f"{module}.{'weight' if names[-1] == 'kernel' else 'bias'}"].numpy()
        want = np.asarray(leaf)
        if want.ndim == 4:
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(got, want)
        assert tuple(det.net.state_dict()[f"{module}.{'weight' if names[-1] == 'kernel' else 'bias'}"].shape) == got.shape
    dw = sd["b3.dw.weight"]
    assert dw.shape == (28, 1, 5, 5) and det.net.b3.dw.groups == 28


@pytest.mark.parametrize("size", [96, 160])
def test_blaze_random_init_carried_across(size):
    """flax-initialised weights through convert.py at other input sizes;
    the anchors follow the size."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32)
    jnet = JBlazeFaceNet()
    jvars = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = np.asarray(jnet.apply(jvars, jnp.asarray(x)))
    net = BlazeFaceNet()
    load_flax_variables(net, jax.tree_util.tree_map(np.asarray, jvars))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, anchor_centers(size).shape[0], 15)
    assert _rel_err(got, ref) < REL


def test_random_blaze_net_is_seeded():
    a, b, c = random_blaze_net(0), random_blaze_net(0), random_blaze_net(1)
    for (name, pa), pb, pc in zip(a.state_dict().items(), b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb)
        if name.endswith("weight"):
            assert not torch.equal(pa, pc)
            fan_in = pa[0].numel()
            assert abs(float(pa.std()) * fan_in**0.5 - 1.0) < 0.35


@pytest.mark.parametrize("size", [128, 200])
def test_blaze_detect_all_matches_jax(size):
    jdet = JDetector(weights=V2, confidence_threshold=0.0, min_face_size=0, max_faces=6)
    pdet = FaceDetector(weights=V2, confidence_threshold=0.0, min_face_size=0, max_faces=6,
                        device="cpu")
    frame = scene_batch(np.random.default_rng(size + 1), 1, size, max_faces=4)[0][0]
    frame = frame.astype(np.uint8)
    ref, got = jdet.detect_all(frame), pdet.detect_all(frame)
    assert len(got) == len(ref) == 6
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g["bbox"], r["bbox"], atol=0.01)
        np.testing.assert_allclose(g["landmarks"], r["landmarks"], atol=0.01)
        assert abs(g["confidence"] - r["confidence"]) < 1e-4


@pytest.mark.parametrize("max_faces", [1, 4])
def test_blaze_fused_engine_matches_jax(max_faces):
    """The fused path with the blaze backbone: identities equal, scores
    within 1e-3, boxes within 0.5 px (tests/test_torch_engine.py's bounds)."""
    rng = np.random.default_rng(31)
    rows = rng.normal(size=(40, 512)).astype(np.float32)
    names = [f"id{i:02d}" for i in range(40)]
    frames = scene_batch(rng, 2, 160, max_faces=max_faces)[0].astype(np.uint8)
    jeng = JEngine(embedder=j_load_arcface(default_arcface_checkpoint()),
                   detector=JDetector(weights=V2, confidence_threshold=0.0, min_face_size=0),
                   match_kernel="dense")
    peng = RecognitionEngine(
        embedder=load_arcface_model(default_arcface_checkpoint(), device="cpu"),
        detector=FaceDetector(weights=V2, confidence_threshold=0.0, min_face_size=0, device="cpu"),
        match_kernel="dense", device="cpu",
    )
    jeng.gallery.add_many(names, rows)
    peng.gallery.add_many(names, rows)
    ref = jeng.fused_recognize_frames(frames, k=3, max_faces=max_faces)
    got = peng.fused_recognize_frames(frames, k=3, max_faces=max_faces)
    for r, g in zip(ref, got):
        assert len(g["faces"]) == len(r["faces"])
        for gf, rf in zip(g["faces"], r["faces"]):
            assert gf["identity"] == rf["identity"]
            np.testing.assert_allclose([s for _, s in gf["top_k"]], [s for _, s in rf["top_k"]],
                                       atol=1e-3)
            np.testing.assert_allclose(gf["bbox"], rf["bbox"], atol=0.5)
            assert abs(gf["det_score"] - rf["det_score"]) < 1e-3


def test_no_shipped_checkpoint_gives_random_blaze(monkeypatch):
    """Without a shipped checkpoint the JAX detector builds a random-init
    BlazeFaceNet at 128² too, and so does the port."""
    from facerecognition_tpu_torch.preprocessing import face_detector

    monkeypatch.setattr(face_detector, "default_detector_checkpoint", lambda: None)
    det = face_detector.FaceDetector(device="cpu")
    assert det.arch == "blaze" and det._calibration is None
    assert det.anchors.shape == (896, 3)
    for a, b in zip(det.net.state_dict().values(), random_blaze_net(0).state_dict().values()):
        assert torch.equal(a, b)

"""The port's FaceNet backend against the JAX package on the CPU.

InceptionResnetV1 / FaceNetModel with flax-initialised weights carried
across by ``convert`` (batch statistics drawn from a seed so batch norm is
not the identity), a reference-layout torch checkpoint through the key map,
the fused engine with ``model_type="facenet"`` at one face and at
``max_faces=4`` against the JAX engine, ``SearchIndex``, the array
extraction helpers, and the detector's ``crop_face`` / ``visualize``. The
shipped 94 MB checkpoint is not read here. Bounds: embeddings within 1e-5
(float32 convolutions summing in another order), the ``block8`` map within
1e-4; the fused engine as ``tests/test_torch_crowd.py`` holds ArcFace
(top-k names equal where the JAX scores are more than 1e-3 apart, scores
within 1e-3, embedding cosine > 0.999); crops within 0.01 levels before the
uint8 cast (the gather warp's bound in ``tests/test_torch_staged.py``), so
at most one level after it.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference import extract_embeddings as jee
from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.models.facenet import FaceNetModel as JFaceNet
from facerecognition_tpu.models.port_torch import save_torch_checkpoint
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu_torch import convert
from facerecognition_tpu_torch.apps.serving import MicroBatcher
from facerecognition_tpu_torch.inference import engine as peng
from facerecognition_tpu_torch.inference import extract_embeddings as pee
from facerecognition_tpu_torch.models.facenet import FaceNetModel
from facerecognition_tpu_torch.models.inception_resnet_v1 import InceptionResnetV1
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

from torch_refs import TorchInceptionResnetV1

N_GALLERY = 40


@pytest.fixture(scope="module")
def variables():
    """Flax FaceNet variables (one jitted init; the weights do not depend on
    the input size) with seeded batch statistics and a 512 → 128
    projection for the projected model."""
    v = jax.jit(JFaceNet().init)(jax.random.PRNGKey(3), jnp.zeros((1, 80, 80, 3)))
    rng = np.random.default_rng(7)
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])

    def perturb(tree):
        if "mean" in tree:
            n = tree["mean"].shape
            return {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        return {k: perturb(t) for k, t in tree.items()}

    params = jax.tree_util.tree_map(np.asarray, v["params"])
    projected = dict(params, projection={
        "kernel": rng.normal(0, 0.05, (512, 128)).astype(np.float32),
        "bias": rng.normal(0, 0.05, 128).astype(np.float32),
    })
    return {"params": params, "batch_stats": perturb(stats)}, {
        "params": projected, "batch_stats": perturb(stats)}


def _port(variables, embedding_size):
    model = FaceNetModel(embedding_size)
    convert.load_flax_variables(model, variables)
    return model.eval()


@pytest.mark.parametrize("embedding_size", [512, 128])
def test_facenet_model_equals_flax(variables, embedding_size):
    v = variables[0] if embedding_size == 512 else variables[1]
    x = np.random.default_rng(embedding_size).normal(size=(2, 80, 80, 3)).astype(np.float32)
    want, want_map = JFaceNet(embedding_size=embedding_size).apply(
        v, jnp.asarray(x), return_feature_map=True)
    with torch.no_grad():
        got, got_map = _port(v, embedding_size)(torch.as_tensor(x), return_feature_map=True)
    assert got.shape == (2, embedding_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_map.permute(0, 2, 3, 1).numpy(), np.asarray(want_map), atol=1e-4)
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=1).numpy(), 1.0, atol=1e-6)


def test_module_names_are_facenet_pytorch_keys(variables):
    keys = set(_port(variables[0], 512).state_dict())
    for key in ("backbone.repeat_1.0.branch1.0.conv.weight", "backbone.mixed_7a.branch0.1.bn.running_var",
                "backbone.mixed_6a.branch0.conv.weight", "backbone.block8.conv2d.bias",
                "backbone.last_bn.running_mean", "backbone.conv2d_1a.bn.num_batches_tracked"):
        assert key in keys
    ref = {f"backbone.{k}" for k in TorchInceptionResnetV1().state_dict()}
    assert keys == ref


def test_small_inputs_raise(variables):
    model = InceptionResnetV1().eval()
    for shape in ((1, 74, 160, 3), (1, 160, 70, 3)):
        with pytest.raises(ValueError, match="75px"):
            model(torch.zeros(shape))
        with pytest.raises(ValueError, match="75px"):
            JFaceNet().apply(variables[0], jnp.zeros(shape))
    model(torch.zeros(1, 75, 75, 3))  # the smallest side it takes


def test_reference_torch_checkpoint_loads(tmp_path):
    """A facenet-pytorch layout under ``model.`` with its ``logits`` head, as
    the reference saves it: the port loads it through ``facenet_key``, the
    JAX package through ``facenet_wrapper_key_map``, and both embed like
    the reference module."""
    torch.manual_seed(0)
    ref = TorchInceptionResnetV1().eval()
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    state = {f"model.{k}": v for k, v in ref.state_dict().items()}
    state["model.logits.weight"] = torch.zeros(10, 512)
    path = str(tmp_path / "facenet.pth")
    save_torch_checkpoint(path, state)
    x = np.random.default_rng(1).uniform(0, 255, (2, 160, 160, 3)).astype(np.float32)
    with torch.no_grad():
        emb = ref(torch.as_tensor((x / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2))
        want = (emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)).numpy()
    got = pee.load_facenet_model(path, device="cpu").embed_uint8(x)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(jee.load_facenet_model(path).embed_uint8(x), got, atol=1e-5)
    assert convert.facenet_key("module.logits.bias") is None
    assert convert.facenet_key("projection.weight") == "projection.weight"
    assert convert.facenet_key("repeat_2.3.conv2d.weight") == "backbone.repeat_2.3.conv2d.weight"


def test_embedder_and_loaders():
    assert pee.default_facenet_checkpoint().endswith("facenet_synthid9k_512.msgpack")
    e = pee.load_facenet_model(None, device="cpu", seed=3)
    assert (e.config.model_type, e.config.input_size) == ("facenet", 160)
    again = pee.load_facenet_model(None, device="cpu", seed=3)
    x = np.random.default_rng(2).integers(0, 256, (2, 150, 170, 3)).astype(np.uint8)
    np.testing.assert_array_equal(e.embed_uint8(x), again.embed_uint8(x))  # seeded
    with pytest.raises(ValueError, match="unknown model_type"):
        pee.Embedder(pee.EmbedderConfig("mobilefacenet"), e.model, device="cpu")
    with pytest.raises(TypeError, match="FaceNetModel"):
        pee.Embedder(pee.EmbedderConfig("facenet"), torch.nn.Linear(1, 1), device="cpu")
    with pytest.raises(ValueError, match="unknown model_type"):
        peng.RecognitionEngine(model_type="lbph", device="cpu")


@pytest.fixture(scope="module")
def embedders(variables):
    """The same flax FaceNet weights in the JAX embedder and the port's."""
    v = jax.tree_util.tree_map(jnp.asarray, variables[0])
    j = jee.Embedder(jee.EmbedderConfig("facenet", 512, 160), v)
    p = pee.Embedder(pee.EmbedderConfig("facenet", 512, 160), _port(variables[0], 512), device="cpu")
    return j, p


def test_extraction_helpers_equal_jax(embedders, rng):
    j, p = embedders
    imgs = [rng.integers(0, 256, (160, 160, 3)).astype(np.uint8),
            rng.integers(0, 256, (120, 140, 3)).astype(np.uint8)]
    inputs = [imgs[0], "missing.jpg", imgs[1]]
    want, want_kept = jee.extract_embeddings_batch(inputs, j)
    got, kept = pee.extract_embeddings_batch(inputs, p)
    assert kept == want_kept == [0, 2]
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(pee.extract_embedding_single(imgs[1], p),
                               jee.extract_embedding_single(imgs[1], j), atol=1e-5)
    assert pee.extract_embedding_single("missing.jpg", p) is None
    assert pee.extract_embedding_single(imgs[0], p, preprocess=lambda im: None) is None
    labels = np.array([2, 0, 2, 0, 3])
    embs = rng.normal(size=(5, 8)).astype(np.float32)
    for n in (None, 6):
        np.testing.assert_allclose(pee.compute_prototypes_from_arrays(embs, labels, n),
                                   jee.compute_prototypes_from_arrays(embs, labels, n), atol=1e-6)


def test_search_index_equals_jax(rng, tmp_path):
    rows = rng.normal(size=(30, 16)).astype(np.float32)
    labels = np.arange(100, 130)
    queries = np.concatenate([rows[[4, 17]] * 2.0, rng.normal(size=(3, 16))]).astype(np.float32)
    want = jee.SearchIndex(rows, labels).search(queries, k=4)
    index = pee.build_faiss_index(rows, labels, device="cpu")
    got = index.search(queries, k=4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    assert got[1][0, 0] == 104 and got[1][1, 0] == 117 and len(index) == 30
    assert index.search(queries, k=99)[0].shape == (5, 30)
    index.save(str(tmp_path / "idx"))
    loaded = pee.SearchIndex.load(str(tmp_path / "idx"), device="cpu")
    np.testing.assert_array_equal(loaded.labels, labels)
    np.testing.assert_array_equal(loaded.search(queries, k=4)[1], want[1])
    j_loaded = jee.SearchIndex.load(str(tmp_path / "idx.npz"))
    np.testing.assert_array_equal(j_loaded.search(queries, k=4)[1], want[1])
    plain = pee.SearchIndex(rows, device="cpu").search(queries[:1], k=1)[1]
    assert plain.tolist() == [[4]]


@pytest.fixture(scope="module")
def fused_engines(embedders):
    """JAX and port engines with the same detector and FaceNet weights and a
    gallery of random rows in which each scene's slots are planted (their
    JAX embeddings), so every slot has a clear top-1."""
    j, p = embedders
    rng = np.random.default_rng(31)
    jeng = JEngine(embedder=j, detector=JDetector(confidence_threshold=0.0, min_face_size=0),
                   match_kernel="dense")
    peng_ = peng.RecognitionEngine(
        embedder=p, detector=FaceDetector(confidence_threshold=0.0, min_face_size=0, device="cpu"),
        match_kernel="stream", device="cpu")
    scenes = {m: scene_batch(np.random.default_rng(40 + m), 2, 256, max_faces=4)[0].astype(np.uint8)
              for m in (1, 4)}
    rows = rng.normal(size=(N_GALLERY, 512)).astype(np.float32)
    names = [f"id{i:02d}" for i in range(N_GALLERY)]
    jeng.gallery.add_many(names, rows)
    for m, frames in scenes.items():
        res = jeng.fused_recognize_frames(frames, k=3, max_faces=m)
        embs = [f["embedding"] for r in res for f in r["faces"]]
        names += [f"m{m}_{i}" for i in range(len(embs))]
        rows = np.concatenate([rows, np.stack(embs)])
    for e in (jeng, peng_):
        e.gallery = type(e.gallery)(512, **({} if e is jeng else {"device": "cpu"}))
        e.gallery.add_many(names, rows)
    return jeng, peng_, scenes


@pytest.mark.parametrize("max_faces", [1, 4])
def test_fused_facenet_matches_jax(fused_engines, max_faces):
    """160² alignment (the template scaled by 160/112) and the 160² crowd
    window, InceptionResnetV1, the streaming matcher's plain version."""
    jeng, peng_, scenes = fused_engines
    frames = scenes[max_faces]
    ref = jeng.fused_recognize_frames(frames, k=5, max_faces=max_faces)
    got = peng_.fused_recognize_frames(frames, k=5, max_faces=max_faces)
    assert len(got) == len(ref)
    for res, r in zip(got, ref):
        assert len(res["faces"]) == len(r["faces"]) == max_faces
        for g, f in zip(res["faces"], r["faces"]):
            assert g["identity"] == f["identity"] and g["identity"].startswith(f"m{max_faces}_")
            ref_scores = np.array([s for _, s in f["top_k"]])
            np.testing.assert_allclose([s for _, s in g["top_k"]], ref_scores, atol=1e-3)
            gap = np.full(len(ref_scores), np.inf)
            gap[:-1] = np.minimum(gap[:-1], ref_scores[:-1] - ref_scores[1:])
            gap[1:] = np.minimum(gap[1:], ref_scores[:-1] - ref_scores[1:])
            for (gn, _), (fn, _), clear in zip(g["top_k"], f["top_k"], gap > 1e-3):
                assert gn == fn or not clear
            np.testing.assert_allclose(g["bbox"], f["bbox"], atol=0.5)
            assert float(g["embedding"] @ f["embedding"]) > 0.999


def test_micro_batcher_serves_facenet(fused_engines):
    _, peng_, scenes = fused_engines
    frames = scenes[4]
    direct = peng_.fused_recognize_frames(frames, k=5, max_faces=4)
    batcher = MicroBatcher(peng_, frame_size=frames.shape[1:3], k=5, max_faces=4,
                           max_batch=len(frames), max_delay_ms=60_000)
    results = [None] * len(frames)

    def client(i):
        results[i] = batcher.submit(frames[i], timeout=120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.close()
    for res, d in zip(results, direct):
        assert [f["identity"] for f in res["faces"]] == [f["identity"] for f in d["faces"]]
        np.testing.assert_allclose(res["faces"][0]["embedding"], d["faces"][0]["embedding"], atol=1e-5)


def test_engine_from_embeddings_dir_takes_model_type(tmp_path, rng):
    g = peng.Gallery(512, device="cpu")
    g.add_many(["a", "b"], rng.normal(size=(2, 512)).astype(np.float32))
    g.save(str(tmp_path / "face_db.npy"))
    e = peng.create_engine_from_embeddings_dir(None, str(tmp_path), "facenet", threshold=0.2,
                                               detector=None, device="cpu")
    assert e.embedder.config.model_type == "facenet" and e.embedder.config.input_size == 160
    assert e.get_db_identities() == ["a", "b"] and e.threshold == 0.2
    res = e.recognize(rng.integers(0, 256, (160, 160, 3)).astype(np.uint8), k=2)
    assert res["status"] == "success" and len(res["top_k"]) == 2


@pytest.fixture(scope="module")
def detectors():
    return JDetector(confidence_threshold=0.0, min_face_size=0), FaceDetector(
        confidence_threshold=0.0, min_face_size=0, device="cpu")


def test_crop_face_equals_jax(detectors):
    jdet, pdet = detectors
    frame = scene_batch(np.random.default_rng(8), 1, 200, max_faces=3)[0][0].astype(np.uint8)
    for kw in ({}, {"bbox": [30.5, 40.0, 120.25, 150.0], "margin": 0.1, "target_size": 160}):
        want, got = jdet.crop_face(frame, **kw), pdet.crop_face(frame, **kw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    strict = FaceDetector(confidence_threshold=1.01, device="cpu")
    assert strict.crop_face(frame) is None


def test_visualize_equals_jax(detectors):
    jdet, pdet = detectors
    frame = scene_batch(np.random.default_rng(9), 1, 200, max_faces=3)[0][0].astype(np.uint8)
    dets = jdet.detect_all(frame)[:3]
    np.testing.assert_array_equal(pdet.visualize(frame, dets), jdet.visualize(frame, dets))
    drawn = pdet.visualize(frame)  # its own detections
    assert drawn.shape == frame.shape and (drawn != frame).any()

"""The whole slice: the port's fused one-face engine against the JAX engine.

Both get the shipped detector and ArcFace assets and the same 50-row
gallery, and the same rendered scenes. The JAX engine runs
``match_kernel='dense'`` (its ``'pallas'`` choice needs a TPU; the exact-N
dense top-k is the same function), the port runs its streaming kernel's
path (``'stream'``, the plain version on the CPU) and ``'dense'``.
"""

import threading

import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.inference.extract_embeddings import load_arcface_model as j_load_arcface
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu_torch.apps.serving import MicroBatcher
from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
from facerecognition_tpu_torch.inference.extract_embeddings import (
    default_arcface_checkpoint,
    load_arcface_model,
)
from facerecognition_tpu_torch.ops import stream_topk as st
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

N_GALLERY = 50


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    frames = scene_batch(rng, 4, 160)[0].astype(np.uint8)
    rows = rng.normal(size=(N_GALLERY, 512)).astype(np.float32)
    names = [f"id{i:02d}" for i in range(N_GALLERY)]
    return frames, rows, names


@pytest.fixture(scope="module")
def jax_results(scene):
    frames, rows, names = scene
    engine = JEngine(
        embedder=j_load_arcface(default_arcface_checkpoint()),
        detector=JDetector(confidence_threshold=0.0, min_face_size=0),
        match_kernel="dense",
    )
    engine.gallery.add_many(names, rows)
    return engine.fused_recognize_frames(frames, k=5)


def _port_engine(scene, match_kernel, confidence_threshold=0.0):
    _, rows, names = scene
    engine = RecognitionEngine(
        embedder=load_arcface_model(default_arcface_checkpoint(), device="cpu"),
        detector=FaceDetector(
            confidence_threshold=confidence_threshold, min_face_size=0, device="cpu"
        ),
        match_kernel=match_kernel,
        device="cpu",
    )
    engine.gallery.add_many(names, rows)
    return engine


@pytest.fixture(scope="module")
def port_stream(scene):
    return _port_engine(scene, "stream")


@pytest.mark.parametrize("match_kernel", ["stream", "dense", "auto"])
def test_fused_engine_matches_jax(scene, jax_results, port_stream, match_kernel):
    frames = scene[0]
    engine = port_stream if match_kernel == "stream" else _port_engine(scene, match_kernel)
    got = engine.fused_recognize_frames(frames, k=5)
    assert len(got) == len(jax_results) == len(frames)
    for ref, res in zip(jax_results, got):
        assert res["status"] == "success" and res["identity"] == ref["identity"]
        assert [n for n, _ in res["top_k"]] == [n for n, _ in ref["top_k"]]
        np.testing.assert_allclose(
            [s for _, s in res["top_k"]], [s for _, s in ref["top_k"]], atol=1e-3
        )
        assert abs(res["faces"][0]["det_score"] - ref["faces"][0]["det_score"]) < 1e-3
        np.testing.assert_allclose(res["bbox"], ref["bbox"], atol=0.5)  # px
        cos = float(res["embedding"] @ ref["embedding"])
        assert cos > 0.999, cos


def test_planted_frames_match_themselves(scene, port_stream):
    frames, rows, names = scene
    own = np.stack([r["embedding"] for r in port_stream.fused_recognize_frames(frames)])
    engine = _port_engine(scene, "stream")
    planted = [3, 17, 29, 41]
    engine.gallery.add_many([names[p] for p in planted], own)
    got = engine.fused_recognize_frames(frames, k=3)
    for res, p in zip(got, planted):
        assert res["top_k"][0][0] == names[p] and res["confidence"] > 0.999


def test_confidence_threshold_gives_no_face(scene):
    engine = _port_engine(scene, "stream", confidence_threshold=1.01)
    for res in engine.fused_recognize_frames(scene[0][:2]):
        assert res["identity"] == "No face" and res["faces"] == [] and res["bbox"] is None


def test_engine_rejects_unported_choices(scene, port_stream):
    engine = RecognitionEngine(embedder=port_stream.embedder, match_kernel="int8", device="cpu")
    assert engine.match_kernel == "int8"
    with pytest.raises(ValueError, match="unknown match_kernel"):
        RecognitionEngine(embedder=port_stream.embedder, match_kernel="pallas", device="cpu")
    with pytest.raises(ValueError, match="max_faces"):
        port_stream.fused_recognize_frames(scene[0][:1], max_faces=0)
    with pytest.raises(ValueError, match="non-empty gallery"):
        RecognitionEngine(
            embedder=port_stream.embedder, detector=port_stream.detector, device="cpu"
        ).fused_recognize_frames(scene[0][:1])


def test_micro_batcher_returns_the_direct_answers(scene, port_stream):
    frames = scene[0]
    requests = [frames[i % len(frames)] for i in range(6)]
    direct = port_stream.fused_recognize_frames(np.stack(requests), k=5)
    # One batch of all six, as the direct call: a batch of one runs other
    # convolution kernels and its embeddings differ in the fifth decimal.
    # The window is long and max_batch closes it as soon as the sixth arrives.
    batcher = MicroBatcher(
        port_stream, frame_size=frames.shape[1:3], k=5,
        max_batch=len(requests), max_delay_ms=60_000,
    )
    results = [None] * len(requests)

    def client(i):
        results[i] = batcher.submit(requests[i], timeout=60)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    for res, ref in zip(results, direct):
        assert res["identity"] == ref["identity"]
        assert [n for n, _ in res["top_k"]] == [n for n, _ in ref["top_k"]]
        np.testing.assert_allclose(
            [s for _, s in res["top_k"]], [s for _, s in ref["top_k"]], atol=1e-5
        )
        np.testing.assert_allclose(res["bbox"], ref["bbox"], atol=1e-3)
        np.testing.assert_allclose(res["embedding"], ref["embedding"], atol=1e-5)
    stats = batcher.stats()
    assert stats["requests"] == 6 and stats["batches"] == 1


def test_micro_batcher_resizes_like_cv2(scene):
    import cv2

    batcher = MicroBatcher(None, frame_size=(128, 96))
    try:
        frame = np.random.default_rng(2).integers(0, 256, (150, 170, 3)).astype(np.uint8)
        got = batcher._prepare(frame)
        ref = cv2.resize(frame, (96, 128), interpolation=cv2.INTER_LINEAR)
        assert got.dtype == np.uint8 and got.shape == (128, 96, 3)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    finally:
        batcher.close()


def test_gallery_device_copies_track_enrollment():
    g = Gallery(4, device="cpu")
    g.add_many(["a", "b", "c"], np.eye(3, 4, dtype=np.float32) * 2.0)
    store, n = g.device_store()
    assert n == 3 and store.shape[0] >= 64
    g.add("b", np.array([0, 0, 0, 5], np.float32))  # replace: one dirty row
    store, n = g.device_store()
    assert n == 3 and torch.equal(store[1], torch.tensor([0.0, 0.0, 0.0, 1.0]))
    assert torch.equal(g.matrix, store[:3])
    g.add_many(["d", "a"], np.ones((2, 4), np.float32))  # new row, repeated name
    assert g.names == ["a", "b", "c", "d"] and len(g) == 4
    np.testing.assert_allclose(g.matrix.numpy()[[0, 3]], 0.5)
    store, n = g.device_store()
    assert n == 4 and torch.equal(store[:4], g.matrix)


def test_stream_engine_on_cpu_takes_the_plain_version(scene, port_stream):
    before = st.launches.count
    port_stream.fused_recognize_frames(scene[0][:1])
    assert st.launches.count == before  # no kernel launch off the card

"""The crowd path (max_faces > 1) of the port against the JAX package.

NMS, the detector post-process, the window warp, ``FaceDetector.detect_all``
and the whole fused engine with several faces per frame. Inputs are made
with numpy from a seed and handed to both sides; JAX runs on the CPU. Each
test states its tolerance.
"""

import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.inference.extract_embeddings import load_arcface_model as j_load_arcface
from facerecognition_tpu.models.detector_net import anchor_centers
from facerecognition_tpu.models.detector_net import detect_faces as j_detect_faces
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu_torch.apps.serving import MicroBatcher
from facerecognition_tpu_torch.inference.engine import RecognitionEngine
from facerecognition_tpu_torch.inference.extract_embeddings import (
    default_arcface_checkpoint,
    load_arcface_model,
)
from facerecognition_tpu_torch.models.detector_net import detect_faces, detect_faces_batch
from facerecognition_tpu_torch.ops import detect_post as dp
from facerecognition_tpu_torch.ops import nms as tnms
from facerecognition_tpu_torch.ops import warp_mxu as twarp
from facerecognition_tpu_torch.ops import warp_sample as ws
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
from facerecognition_tpu_torch.utils.imageio import save_png

# ``facerecognition_tpu.ops`` re-exports functions named like its modules.
jnms = importlib.import_module("facerecognition_tpu.ops.nms")
jwarp = importlib.import_module("facerecognition_tpu.ops.warp_mxu")
jumeyama = importlib.import_module("facerecognition_tpu.ops.umeyama")


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _boxes(rng, k, spread=100.0, size=(5.0, 40.0)):
    xy = rng.uniform(0, spread, (k, 2))
    wh = rng.uniform(*size, (k, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# -- iou_matrix and nms_padded ------------------------------------------------


def test_iou_matrix_matches_jax(rng):
    a = _boxes(rng, 40)
    a[3] = [10, 10, 10, 30]  # zero width
    a[4] = [20, 20, 5, 5]  # inverted: area clamps to 0
    b = _boxes(rng, 25)
    ref = np.asarray(jnms.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tnms.iou_matrix(T(a), T(b)).numpy()
    # XLA may fuse a product and a sum into one FMA: an ulp apart
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    batched = tnms.iou_matrix(T(np.stack([a, a[::-1]])), T(np.stack([b, b])))
    np.testing.assert_array_equal(batched[0].numpy(), got)


def _nms_case(rng, case, k=64):
    boxes = _boxes(rng, k)
    scores = rng.uniform(0.05, 1.0, k).astype(np.float32)
    if case == "padding":  # the last third padded: score 0 or below
        scores[2 * k // 3 :] = rng.choice([0.0, -1.0], k - 2 * k // 3)
    elif case == "all_suppressed":  # one box repeated: a single survivor
        boxes[:] = boxes[0]
    elif case == "disjoint":  # a grid of separate boxes: all survive
        xy = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2)[:k] * 50.0
        boxes = np.concatenate([xy, xy + 20.0], 1).astype(np.float32)
    elif case == "ties":  # equal scores: the first maximum wins
        scores = np.round(scores * 4) / 4
    elif case == "all_padding":
        scores[:] = 0.0
    return boxes, scores


@pytest.mark.parametrize("case", ["random", "padding", "all_suppressed", "disjoint", "ties", "all_padding"])
@pytest.mark.parametrize("max_out", [1, 2, 4, 8, 16])
def test_nms_padded_matches_jax(rng, case, max_out):
    """Indices and validity equal; several frames batched in one call."""
    frames = [_nms_case(rng, case) for _ in range(3)]
    got_i, got_v = tnms.nms_padded(
        T(np.stack([f[0] for f in frames])), T(np.stack([f[1] for f in frames])), 0.3, max_out
    )
    for n, (boxes, scores) in enumerate(frames):
        ref_i, ref_v = jnms.nms_padded(jnp.asarray(boxes), jnp.asarray(scores), 0.3, max_out)
        np.testing.assert_array_equal(got_i[n].numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v[n].numpy(), np.asarray(ref_v))
    if case == "all_suppressed":
        assert got_v[:, 0].all() and not got_v[:, 1:].any()
    if case == "disjoint":
        assert got_v.all()
    if case == "all_padding":
        assert not got_v.any() and (got_i == -1).all()


# -- detect_faces -------------------------------------------------------------


def _raw(rng, b, a=896, saturate=True):
    raw = (rng.normal(size=(b, a, 15)) * 2.0).astype(np.float32)
    raw[..., 0] = (rng.normal(size=(b, a)) * 6.0).astype(np.float32)
    if saturate:
        # logits above ~17 give sigmoid 1.0f: ties the prefilter breaks by
        # the lowest anchor, as lax.top_k (ranking by logit would not)
        raw[0, 100:160, 0] = rng.uniform(20.0, 40.0, 60)
        raw[1, :, 0] = 30.0
    return raw


@pytest.mark.parametrize("max_faces", [1, 2, 4, 16])
def test_detect_faces_batch_matches_jax(rng, max_faces):
    """Validity and landmarks equal, scores equal, boxes within 1e-4 px
    (XLA fuses cx + w/2 terms into FMAs: an ulp at 100 px is 8e-6). An ulp
    of difference in a sigmoid could still swap two candidates whose scores
    are within an ulp at the prefilter's edge; these inputs have none."""
    anchors = anchor_centers(128)
    raw = _raw(rng, 3)
    got = detect_faces_batch(T(raw), T(anchors), 0.3, max_faces)
    for n in range(len(raw)):
        ref = j_detect_faces(jnp.asarray(raw[n]), jnp.asarray(anchors), 0.3, max_faces)
        np.testing.assert_array_equal(got[3][n].numpy(), np.asarray(ref[3]))
        np.testing.assert_allclose(got[0][n].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[1][n].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2][n].numpy(), np.asarray(ref[2]))
    one = detect_faces(T(raw[0]), T(anchors), 0.3, max_faces)
    for x, y in zip(one, got):
        np.testing.assert_array_equal(x.numpy(), y[0].numpy())


def test_detect_post_on_cpu_is_the_plain_version(rng):
    anchors = T(anchor_centers(128))
    raw = T(_raw(rng, 2))
    before = dp.launches.count
    got = dp.detect_post(raw, anchors, 0.3, 4)
    ref = detect_faces_batch(raw, anchors, 0.3, 4)
    assert dp.launches.count == before
    for x, y in zip(got, ref):
        assert torch.equal(x, y)


def test_detect_post_shared_memory_layout():
    """The shared-memory layout lives only in the kernel, which refuses
    what a block cannot hold (``chip_smoke.py`` shows the refusal on the
    card): the wrapper's checks are of shapes, types and devices only, so a
    prefilter too large for a block passes them."""
    raw = torch.empty(1, 40000, 15, device="meta")
    anchors = torch.empty(40000, 3, device="meta")
    dp._check(raw, anchors, 5000)
    assert not hasattr(dp, "smem_bytes")
    with pytest.raises(ValueError, match="max_faces"):
        dp._check(raw, anchors, 0)


# -- window warp ---------------------------------------------------------------


def _smooth(rng, shape):
    img = rng.normal(size=shape) * 60 + 128
    k = np.ones(7) / 7
    for ax in (0, 1):
        img = np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"), ax, img)
    return np.clip(img, 0, 255).astype(np.float32)


def _crowd_landmarks(rng, b, m, side, edge=False):
    template = jumeyama.ARCFACE_TEMPLATE - jumeyama.ARCFACE_TEMPLATE.mean(0)
    ang = rng.uniform(-0.4, 0.4, (b, m))
    rot = np.stack(
        [np.stack([np.cos(ang), -np.sin(ang)], -1), np.stack([np.sin(ang), np.cos(ang)], -1)], -2
    )
    lm = np.einsum("bmij,nj->bmni", rot, template) * rng.uniform(0.5, 0.9, (b, m, 1, 1))
    lm = lm + rng.uniform(50, side - 50, (b, m, 1, 2))
    if edge:  # windows that would leave the frame at each corner
        lm[0, 0] += 30.0 - lm[0, 0].mean(0)
        lm[0, 1] += side - 25.0 - lm[0, 1].mean(0)
    return lm.astype(np.float32)


@pytest.mark.parametrize("fast", [False, True])
def test_align_crop_mxu_window_matches_jax(rng, fast):
    """From landmarks, each side solves its own similarity (see
    tests/test_torch_ops.py's test_align_crop_mxu_matches_jax): the same
    bounds, 1.5 / 0.01 levels with bf16 weights, 0.02 / 1e-3 without."""
    imgs = np.stack([_smooth(rng, (256, 256, 3)) for _ in range(2)])
    lm = _crowd_landmarks(rng, 2, 3, 256, edge=True)
    ref = np.asarray(jwarp.align_crop_mxu_window(jnp.asarray(imgs), jnp.asarray(lm), 112, 160, fast))
    got = twarp.align_crop_mxu_window(T(imgs), T(lm), 112, 160, fast).numpy()
    assert got.shape == ref.shape == (6, 112, 112, 3)
    diff = np.abs(got - ref)
    if fast:
        assert diff.max() <= 1.5 and diff.mean() < 0.01, (diff.max(), diff.mean())
    else:
        assert diff.max() < 0.02 and diff.mean() < 1e-3, (diff.max(), diff.mean())
    # the wrapper takes the plain version for CPU tensors, and uint8 frames
    # give the same result as float32 ones
    u8 = np.rint(imgs).astype(np.uint8)
    np.testing.assert_array_equal(
        ws.align_crop_window(T(u8), T(lm), 112, 160, fast).numpy(),
        twarp.align_crop_mxu_window(T(u8.astype(np.float32)), T(lm), 112, 160, fast).numpy(),
    )


def test_window_origins_clamp_to_the_frame(rng):
    lm = _crowd_landmarks(rng, 1, 2, 256, edge=True)
    _, origin, win = twarp.window_slots(T(lm), 256, 256, 112, 160)
    assert win == 160
    assert origin[0].tolist() == [0, 0] and origin[1].tolist() == [96, 96]
    _, origin, win = twarp.window_slots(T(lm) * 0.5, 120, 130, 112, 160)
    assert win == 120 and (origin[:, 1] == 0).all()  # 120 rows: no room to move
    assert origin[:, 0].min() >= 0 and origin[:, 0].max() <= 10


# -- FaceDetector.detect_all / detect -----------------------------------------


@pytest.fixture(scope="module")
def detectors():
    return (
        JDetector(confidence_threshold=0.0, min_face_size=0, max_faces=6),
        FaceDetector(confidence_threshold=0.0, min_face_size=0, max_faces=6, device="cpu"),
    )


@pytest.mark.parametrize("size", [128, 200])
def test_detect_all_matches_jax(detectors, size):
    """Same faces in the same order: boxes and landmarks within 0.01 px,
    calibrated confidences within 1e-4 (the convolutions sum in another
    order)."""
    jdet, pdet = detectors
    frame = scene_batch(np.random.default_rng(size), 1, size, max_faces=4)[0][0].astype(np.uint8)
    ref, got = jdet.detect_all(frame), pdet.detect_all(frame)
    assert len(got) == len(ref) == 6
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g["bbox"], r["bbox"], atol=0.01)
        np.testing.assert_allclose(g["landmarks"], r["landmarks"], atol=0.01)
        assert abs(g["confidence"] - r["confidence"]) < 1e-4
    assert pdet.detect(frame)["bbox"] == max(
        got, key=lambda f: (f["bbox"][2] - f["bbox"][0]) * (f["bbox"][3] - f["bbox"][1])
    )["bbox"]


def test_detect_all_thresholds(detectors, tmp_path):
    _, pdet = detectors
    frame = scene_batch(np.random.default_rng(3), 1, 128, max_faces=4)[0][0].astype(np.uint8)
    strict = FaceDetector(confidence_threshold=1.01, device="cpu")
    assert strict.detect_all(frame) == [] and strict.detect(frame) is None
    gray = pdet.detect_all(frame.mean(-1))
    assert len(gray) == 6
    with pytest.raises(FileNotFoundError):
        pdet.detect_all("face.jpg")
    path = save_png(tmp_path / "frame.png", frame)  # a real file now decodes
    assert pdet.detect_all(path) == pdet.detect_all(frame)


# -- the fused engine ------------------------------------------------------------

N_GALLERY = 50


@pytest.fixture(scope="module")
def gallery_rows():
    rng = np.random.default_rng(21)
    rows = rng.normal(size=(N_GALLERY, 512)).astype(np.float32)
    return rows, [f"id{i:02d}" for i in range(N_GALLERY)]


@pytest.fixture(scope="module")
def jax_engine(gallery_rows):
    engine = JEngine(
        embedder=j_load_arcface(default_arcface_checkpoint()),
        detector=JDetector(confidence_threshold=0.0, min_face_size=0),
        match_kernel="dense",
    )
    engine.gallery.add_many(*gallery_rows[::-1])
    return engine


@pytest.fixture(scope="module")
def port_engine(gallery_rows):
    engine = RecognitionEngine(
        embedder=load_arcface_model(default_arcface_checkpoint(), device="cpu"),
        detector=FaceDetector(confidence_threshold=0.0, min_face_size=0, device="cpu"),
        match_kernel="stream",
        device="cpu",
    )
    engine.gallery.add_many(*gallery_rows[::-1])
    return engine


def _assert_same_faces(got, ref):
    """tests/test_torch_engine.py's bounds, per face: identities and top-k
    names equal, scores within 1e-3, det scores within 1e-3, boxes within
    0.5 px, embedding cosine > 0.999. Two gallery rows whose JAX scores are
    within 1e-3 of each other may come back in either order."""
    assert len(got) == len(ref)
    for res, r in zip(got, ref):
        assert res["status"] == "success" and res["identity"] == r["identity"]
        assert len(res["faces"]) == len(r["faces"])
        for g, f in zip(res["faces"], r["faces"]):
            assert g["identity"] == f["identity"]
            ref_scores = np.array([s for _, s in f["top_k"]])
            np.testing.assert_allclose([s for _, s in g["top_k"]], ref_scores, atol=1e-3)
            gap = np.full(len(ref_scores), np.inf)
            gap[:-1] = np.minimum(gap[:-1], ref_scores[:-1] - ref_scores[1:])
            gap[1:] = np.minimum(gap[1:], ref_scores[:-1] - ref_scores[1:])
            for (gn, _), (fn, _), clear in zip(g["top_k"], f["top_k"], gap > 1e-3):
                assert gn == fn or not clear
            assert abs(g["det_score"] - f["det_score"]) < 1e-3
            np.testing.assert_allclose(g["bbox"], f["bbox"], atol=0.5)
            assert float(g["embedding"] @ f["embedding"]) > 0.999


@pytest.mark.parametrize(
    "side, max_faces",
    [(256, 4), (160, 4), (256, 2), (160, 2), (256, 16), (128, 16)],
    ids=["window-M4", "repeat-M4", "window-M2", "repeat-M2", "window-M16", "repeat-M16"],
)
def test_fused_crowd_matches_jax(jax_engine, port_engine, side, max_faces):
    """Frames above 160² take the window path, others every slot from its
    whole frame (both sides switch at the same size)."""
    frames = scene_batch(np.random.default_rng(side + max_faces), 3, side, max_faces=4)[0]
    frames = frames.astype(np.uint8)
    ref = jax_engine.fused_recognize_frames(frames, k=5, max_faces=max_faces)
    got = port_engine.fused_recognize_frames(frames, k=5, max_faces=max_faces)
    _assert_same_faces(got, ref)
    assert all(len(r["faces"]) == max_faces for r in got)  # threshold 0: every slot


def test_crowd_thresholds_mask_slots(port_engine):
    frames = scene_batch(np.random.default_rng(9), 2, 256, max_faces=4)[0].astype(np.uint8)
    all_faces = port_engine.fused_recognize_frames(frames, k=3, max_faces=4)
    det = port_engine.detector
    det.confidence_threshold = 0.5
    try:
        kept = port_engine.fused_recognize_frames(frames, k=3, max_faces=4)
    finally:
        det.confidence_threshold = 0.0
    for a, b in zip(all_faces, kept):
        want = [f for f in a["faces"] if f["det_score"] >= 0.5]
        assert [f["bbox"] for f in b["faces"]] == [f["bbox"] for f in want]
        assert b["identity"] == (want[0]["identity"] if want else "No face")


def test_micro_batcher_serves_the_crowd(port_engine):
    """MicroBatcher(max_faces=4) returns what one direct call returns."""
    frames = scene_batch(np.random.default_rng(4), 5, 256, max_faces=4)[0].astype(np.uint8)
    direct = port_engine.fused_recognize_frames(frames, k=3, max_faces=4)
    batcher = MicroBatcher(
        port_engine, frame_size=(256, 256), k=3, max_faces=4,
        max_batch=len(frames), max_delay_ms=60_000,
    )
    results = [None] * len(frames)

    def client(i):
        results[i] = batcher.submit(frames[i], timeout=60)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    for res, ref in zip(results, direct):
        assert len(res["faces"]) == len(ref["faces"]) == 4
        for g, f in zip(res["faces"], ref["faces"]):
            assert [n for n, _ in g["top_k"]] == [n for n, _ in f["top_k"]]
            np.testing.assert_allclose(g["embedding"], f["embedding"], atol=1e-5)
    assert batcher.stats()["batches"] == 1


def test_one_face_slot_is_the_crowd_top_slot(port_engine):
    """max_faces=1 (argmax decode) gives the crowd path's first slot."""
    frames = scene_batch(np.random.default_rng(12), 2, 160, max_faces=1)[0].astype(np.uint8)
    one = port_engine.fused_recognize_frames(frames, k=3, max_faces=1)
    crowd = port_engine.fused_recognize_frames(frames, k=3, max_faces=2)
    for a, b in zip(one, crowd):
        np.testing.assert_allclose(a["bbox"], b["faces"][0]["bbox"], atol=1e-4)
        assert a["top_k"][0][0] == b["faces"][0]["top_k"][0][0]

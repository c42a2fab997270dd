"""The port's realtime and video app (``apps/realtime.py``), its JPEG
encoder and its Motion-JPEG AVI reader, on the CPU.

- ``synthetic_face_batch`` and ``SyntheticFrameSource`` draw the JAX
  package's frames bit for bit (same seeds, same clock);
- the AVI reader, on clips cv2 writes here (cv2 only in the test), gives
  cv2's ``fps`` and ``frame_count``; each frame is bit-equal to libjpeg's
  decode of its chunk (PIL), and its median |Δ| from cv2's own frame
  (FFmpeg's decoder, whose chroma upsampling and colour conversion round
  differently) is at most 1 level on flat and smooth frames; OpenDML
  ``AVIX`` parts are read; other containers and codecs raise
  ``FileNotFoundError``;
- the committed clip decodes to its stored libjpeg digests and pixels;
- ``encode_jpeg``: PIL decodes it, and its mean error against the source
  is within 1.25x that of ``cv2.imencode`` at the same quality;
- ``process_video``'s strides, tail padding and limits; the realtime
  worker's fused and staged paths, its MJPEG stream through the web app,
  ``CameraFrameSource`` on an injected capture; a ``RuntimeError`` of the
  fused path is raised, never answered from the staged path.
"""

import hashlib
import io
import json
import os
import struct
import time

import numpy as np
import pytest
from PIL import Image

from facerecognition_tpu_torch.apps import realtime as prt
from facerecognition_tpu_torch.data.native_decode import decode_mem
from facerecognition_tpu_torch.inference.engine import RecognitionEngine
from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
from facerecognition_tpu_torch.training.train_detector import MAX_GT, synthetic_face_batch
from facerecognition_tpu_torch.utils.imageio import encode_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "facerecognition_tpu_torch", "fixtures")
ENCODER_RATIO = 1.25  # encode_jpeg's mean error over cv2.imencode's, at most
# cv2's frames against libjpeg's, the same chunks: FFmpeg's YCbCr -> RGB
# rounds a level lower (median |Δ| 1) and its chroma upsampling differs
# where the chroma changes (the largest |Δ| measured: 2 flat, 5 smooth).
CV2_MAX_DIFF = {"flat": 2, "smooth": 6}


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.fixture(scope="module")
def embedder():
    """A random-init ArcFace (seed 0) with one block a stage, on the CPU,
    two intra-op threads (the test workers share the cores): the realtime
    contracts do not depend on the weights or the depth."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield load_arcface_model(None, stage_sizes=(1, 1, 1, 1), device="cpu")
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# Synthetic frames
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,batch,size,p_face,per_image", [
    (0, 3, 64, 0.9, 1), (1, 4, 96, 0.5, 2), (7, 2, 128, 1.0, MAX_GT), (12, 3, 48, 1.0, 3)])
def test_synthetic_face_batch_equals_jax(seed, batch, size, p_face, per_image):
    from facerecognition_tpu.training.train_detector import MAX_GT as J_MAX_GT
    from facerecognition_tpu.training.train_detector import synthetic_face_batch as jbatch

    assert MAX_GT == J_MAX_GT
    got = synthetic_face_batch(np.random.default_rng(seed), batch, size, p_face, per_image)
    want = jbatch(np.random.default_rng(seed), batch, size, p_face, per_image)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_synthetic_frame_source_equals_jax(monkeypatch):
    from facerecognition_tpu.apps import realtime as jrt

    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    ours, theirs = prt.SyntheticFrameSource(160, 120), jrt.SyntheticFrameSource(160, 120)
    for t in (0.0, 0.7, 3.2):
        clock[0] = 1000.0 + t
        np.testing.assert_array_equal(ours.read(), theirs.read())


# ---------------------------------------------------------------------------
# Motion-JPEG AVI reader
# ---------------------------------------------------------------------------


def write_clip(path, frames, fps=10.0, fourcc="MJPG"):
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))  # the writer takes BGR
    writer.release()
    return str(path)


def clip_frames(kind: str, n: int = 6, h: int = 48, w: int = 64) -> list:
    rng = np.random.default_rng(4)
    if kind == "flat":
        colors = rng.integers(30, 226, (n, 3), dtype=np.uint8)
        return [np.broadcast_to(c, (h, w, 3)).copy() for c in colors]
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([(xx * 3 + 10 * k) % 256, yy * 4 + 20, np.full_like(xx, 40 + 20 * k)],
                     -1).astype(np.uint8) for k in range(n)]


@pytest.mark.parametrize("kind,fps", [("flat", 10.0), ("smooth", 25.0)])
def test_avi_reader_matches_cv2_and_libjpeg(tmp_path, kind, fps):
    import cv2

    path = write_clip(tmp_path / "clip.avi", clip_frames(kind), fps)
    cap = cv2.VideoCapture(path)
    src = prt.VideoFileSource(path)
    assert src.fps == cap.get(cv2.CAP_PROP_FPS) == fps
    assert src.frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    with open(path, "rb") as f:
        data = f.read()
    chunks = prt.avi_frames(path)[2]
    for offset, size in chunks:
        ok, bgr = cap.read()
        got = src.read()
        assert ok and got.shape == (48, 64, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, pil_rgb(data[offset:offset + size]))
        diff = np.abs(got.astype(int) - bgr[:, :, ::-1].astype(int))
        assert np.median(diff) <= 1 and diff.max() <= CV2_MAX_DIFF[kind]
    assert src.read() is None and not cap.read()[0]
    src.release()
    assert src.read() is None


def _riff(fourcc: bytes, kind: bytes, body: bytes) -> bytes:
    payload = kind + body
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _hdrl(us_per_frame=40000, scale=1, rate=25) -> bytes:
    """An AVI header list of one 32x32 MJPG video stream of 5 frames."""
    avih = struct.pack("<14I", us_per_frame, 0, 0, 0, 3, 0, 1, 0, 32, 32, 0, 0, 0, 0)
    strh = (b"vidsMJPG" + struct.pack("<II", 0, 0) + struct.pack("<IIIIII", 0, scale, rate, 0, 5, 0)
            + bytes(16))
    strf = struct.pack("<IiiHH", 40, 32, 32, 1, 24) + b"MJPG" + bytes(20)
    return _riff(b"LIST", b"hdrl", _chunk(b"avih", avih) + _riff(
        b"LIST", b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)) + _riff(
        b"LIST", b"odml", _chunk(b"dmlh", struct.pack("<I", 5) + bytes(244))))


def test_avi_reader_reads_opendml_extensions(tmp_path):
    """An OpenDML file: frames in the first RIFF's movi and in an AVIX part
    (one odd-sized chunk, one empty dropped-frame chunk), its frame count
    from dmlh, its fps from strh's rate / scale."""
    frames = clip_frames("smooth", 5, 32, 32)
    jpegs = [encode_jpeg(f, 90) for f in frames]
    hdrl = _hdrl()
    movi1 = _riff(b"LIST", b"movi", b"".join(_chunk(b"00dc", j) for j in jpegs[:3]))
    movi2 = _riff(b"LIST", b"movi", _chunk(b"00dc", b"") + _chunk(b"ix00", bytes(24))
                  + b"".join(_chunk(b"00dc", j + b"\xff") for j in jpegs[3:]))
    data = _riff(b"RIFF", b"AVI ", hdrl + movi1) + _riff(b"RIFF", b"AVIX", movi2)
    path = tmp_path / "odml.avi"
    path.write_bytes(data)
    src = prt.VideoFileSource(str(path))
    assert src.fps == 25.0 and src.frame_count == 5
    got = [src.read() for _ in range(5)]
    assert src.read() is None
    src.release()
    for g, j in zip(got, jpegs):
        np.testing.assert_array_equal(g, decode_mem(j))


def test_avi_reader_refuses_other_files(tmp_path):
    frames = clip_frames("flat", 3)
    garbage = tmp_path / "x.avi"
    garbage.write_bytes(b"not a video")
    wav = tmp_path / "a.wav"
    wav.write_bytes(_riff(b"RIFF", b"WAVE", _chunk(b"fmt ", bytes(16))))
    empty = tmp_path / "e.avi"
    empty.write_bytes(_riff(b"RIFF", b"AVI ", b""))
    no_rate = tmp_path / "r.avi"  # neither strh nor avih gives a frame rate
    no_rate.write_bytes(_riff(b"RIFF", b"AVI ", _hdrl(us_per_frame=0, scale=0, rate=0) + _riff(
        b"LIST", b"movi", _chunk(b"00dc", encode_jpeg(frames[0], 90)))))
    paths = [str(garbage), str(wav), str(empty), str(no_rate), str(tmp_path / "missing.avi"),
             write_clip(tmp_path / "raw.avi", frames, fourcc="FFV1")]
    for path in paths:
        with pytest.raises(FileNotFoundError, match="cannot open video"):
            prt.VideoFileSource(path)


def test_committed_clip_decodes_to_its_digests():
    with open(os.path.join(FIXTURES, "faces_clip.json")) as f:
        meta = json.load(f)
    stored = np.load(os.path.join(FIXTURES, "faces_clip_pixels.npz"))
    path = os.path.join(FIXTURES, "faces_clip.avi")
    src = prt.VideoFileSource(path)
    assert src.fps == meta["fps"] and src.frame_count == len(meta["sha256"]) == 32
    for i, want in enumerate(meta["sha256"]):
        frame = src.read()
        assert frame.shape == (meta["side"], meta["side"], 3)
        assert hashlib.sha256(frame.tobytes()).hexdigest() == want, i
        if f"frame{i:02d}" in stored.files:
            np.testing.assert_array_equal(frame, stored[f"frame{i:02d}"])
    assert len(stored.files) == 4 and meta["identities"][:2] == ["id0", "id1"]
    assert sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES)
               if n.startswith("faces_clip")) < 2**20


def test_video_source_ends_on_undecodable_frames_and_raises_card_failures(monkeypatch):
    """An undecodable chunk ends the stream, as cv2's ``read()`` does; a
    failure of the card while decoding (``RuntimeError``) reaches the
    caller, so /video never answers with a timeline cut short."""
    path = os.path.join(FIXTURES, "faces_clip.avi")
    calls = []

    def decode(data, name=None):
        calls.append(name)
        if len(calls) == 2:
            raise OSError(f"{name}: JPEG: no frame header")
        return np.zeros((4, 4, 3), np.uint8)

    monkeypatch.setattr(prt.native_decode, "decode_mem", decode)
    src = prt.VideoFileSource(path)
    assert src.read() is not None and src.read() is None
    src.release()

    def card_failure(data, name=None):
        raise RuntimeError("JPEG: nvJPEG decode failed (status 6)")

    monkeypatch.setattr(prt.native_decode, "decode_mem", card_failure)
    src = prt.VideoFileSource(path)
    with pytest.raises(RuntimeError, match="status 6"):
        src.read()
    src.release()


# ---------------------------------------------------------------------------
# JPEG encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quality", [30, 80, 95])
@pytest.mark.parametrize("shape", [(256, 256), (77, 131)])
def test_encode_jpeg_decodes_and_errs_like_cv2(quality, shape):
    import cv2

    rng = np.random.default_rng(quality)
    img, *_ = synthetic_face_batch(rng, 1, max(shape), p_face=1.0)
    img = np.ascontiguousarray(img[0, :shape[0], :shape[1]].astype(np.uint8))
    data = encode_jpeg(img, quality)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    ours = pil_rgb(data)
    assert ours.shape == img.shape
    np.testing.assert_array_equal(decode_mem(data), ours)  # libjpeg either way
    ok, ref = cv2.imencode(".jpg", img[:, :, ::-1], [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    theirs = pil_rgb(ref.tobytes())
    err = np.abs(ours.astype(int) - img).mean()
    ref_err = np.abs(theirs.astype(int) - img).mean()
    assert err <= ENCODER_RATIO * ref_err, (err, ref_err)


def test_encode_jpeg_gray_and_bad_shapes():
    gray = np.tile(np.arange(40, dtype=np.uint8)[None] * 6, (24, 1))
    out = pil_rgb(encode_jpeg(gray, 90))
    assert out.shape == (24, 40, 3) and np.abs(out.astype(int) - gray[..., None]).max() <= 4
    for bad in (np.zeros((4, 4, 4), np.uint8), np.zeros((0, 4, 3), np.uint8), np.zeros(5, np.uint8)):
        with pytest.raises(ValueError):
            encode_jpeg(bad)


# ---------------------------------------------------------------------------
# process_video
# ---------------------------------------------------------------------------


class RecordingEngine:
    """The fused surface of an engine with a detector and a gallery; records
    each call's batch."""

    def __init__(self, error=None):
        self.detector = object()
        self.gallery = ["a"]
        self.calls = []
        self.error = error

    def fused_recognize_frames(self, frames, k=5, max_faces=1):
        if self.error is not None:
            raise self.error
        self.calls.append((frames.shape, max_faces))
        return [{"identity": "a", "confidence": float(f.mean()), "status": "success",
                 "bbox": None, "faces": []} for f in frames]


def test_process_video_strided_batches(tmp_path, embedder):
    path = write_clip(tmp_path / "c.avi", clip_frames("flat", 10, 64, 64))
    engine = RecognitionEngine(embedder=embedder, threshold=0.3, device="cpu")
    engine.add_to_db("p0", [np.random.default_rng(1).integers(0, 256, (112, 112, 3), dtype=np.uint8)])
    seen = []
    out = prt.process_video(engine, path, batch_size=4, every_n=2,
                            on_batch=lambda done, res: seen.append((done, len(res))))
    assert out["frames"] == 5 and len(out["results"]) == 5  # 10 frames, stride 2
    assert all(r["status"] == "success" for r in out["results"])
    assert out["fps"] > 0
    assert seen == [(4, 4), (5, 1)]  # a full batch, then the tail


def test_process_video_pads_the_fused_tail_and_limits(tmp_path):
    path = write_clip(tmp_path / "c.avi", clip_frames("smooth", 7))
    engine = RecordingEngine()
    out = prt.process_video(engine, path, batch_size=4, max_faces=2)
    assert out["frames"] == 7
    assert engine.calls == [((4, 48, 64, 3), 2)] * 2  # the tail of 3 padded to 4
    assert prt.process_video(engine, path, batch_size=8, max_frames=3)["frames"] == 3
    out0 = prt.process_video(engine, path, max_frames=0)
    assert out0["frames"] == 0 and out0["results"] == []
    with pytest.raises(ValueError, match="every_n"):
        prt.process_video(engine, path, every_n=0)


# ---------------------------------------------------------------------------
# Realtime worker and the MJPEG stream
# ---------------------------------------------------------------------------


def _wait_for_result(rt, seconds=30.0):
    deadline = time.time() + seconds
    while time.time() < deadline and rt.result["identity"] == "...":
        time.sleep(0.05)
    return rt.result


def test_synthetic_stream_and_result(embedder):
    engine = RecognitionEngine(embedder=embedder, threshold=0.99, device="cpu")
    rt = prt.RealtimeRecognizer(engine, source=prt.SyntheticFrameSource(320, 240))
    jpeg = rt.single_jpeg()
    assert jpeg[:2] == b"\xff\xd8" and pil_rgb(jpeg).shape == (240, 320, 3)
    result = _wait_for_result(rt)
    rt.stop()
    assert result["identity"] == "Unknown"  # an empty gallery: recognize() says "No database loaded"


def test_realtime_fused_path_with_a_detector(embedder):
    """Detector + gallery: one fused call a frame (max_faces=4), every face
    listed; the stream draws its boxes."""
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    detector = FaceDetector(confidence_threshold=0.5, device="cpu")
    engine = RecognitionEngine(embedder=embedder, detector=detector, threshold=-1.0, device="cpu")
    source = prt.SyntheticFrameSource(256, 256)
    engine.gallery.add("someone", np.ones(512, np.float32))
    rt = prt.RealtimeRecognizer(engine, detector=detector, source=source)
    frames = rt.frames()
    next(frames)
    result = _wait_for_result(rt)
    jpeg = next(frames)
    rt.stop()
    assert "faces" in result and result["identity"] in ("someone", "No face")
    assert len(result["faces"]) <= 4
    assert pil_rgb(jpeg).shape == (256, 256, 3)


def test_realtime_staged_path_aligns_with_the_gather_warp(embedder):
    """A detector the engine does not share takes the staged path: the
    face aligned by ops.image.align_crop from the detector's landmarks,
    then recognize()."""
    import torch

    from facerecognition_tpu_torch.ops.image import align_crop
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    detector = FaceDetector(confidence_threshold=0.0, device="cpu")
    engine = RecognitionEngine(embedder=embedder, threshold=-1.0, device="cpu")
    engine.gallery.add("x", np.ones(512, np.float32))
    frame = prt.SyntheticFrameSource(256, 256).read()
    det = detector.detect(frame)
    assert det is not None and det.get("landmarks") is not None
    rt = prt.RealtimeRecognizer(engine, detector=detector, source=prt.SyntheticFrameSource())
    got = rt._recognize(frame)
    face = align_crop(torch.as_tensor(frame.astype(np.float32)),
                      torch.as_tensor(np.asarray(det["landmarks"], np.float32)), 112).numpy()
    want = engine.recognize(np.asarray(face, np.uint8))
    assert got["bbox"] == det["bbox"] and got["identity"] == want["identity"] == "x"
    assert got["confidence"] == pytest.approx(want["confidence"], abs=1e-6)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_realtime_raises_a_runtime_error_and_falls_back_on_value_error(embedder):
    detector = object()
    engine = RecordingEngine(error=RuntimeError("CUDA error: launch failure"))
    engine.detector = detector
    staged = []
    engine.recognize = lambda face: staged.append(face) or {"identity": "staged", "confidence": 0.5}
    rt = prt.RealtimeRecognizer(engine, detector=None, source=prt.SyntheticFrameSource(64, 64))
    rt.detector = detector  # the engine's own detector: the fused path
    frame = np.zeros((64, 64, 3), np.uint8)
    with pytest.raises(RuntimeError, match="launch failure"):
        rt._recognize(frame)
    assert staged == []
    # the worker records the failure and stops
    rt.source = prt.SyntheticFrameSource(64, 64)
    frames = rt.frames()
    next(frames)
    rt._worker.join(timeout=30)
    assert not rt._worker.is_alive()
    assert rt.result["identity"] == "Error" and "launch failure" in rt.result["error"]
    rt.stop()
    # an expected refusal (ValueError) takes the staged path
    engine.error = ValueError("fused path needs a non-empty gallery")
    rt.detector = None  # no detector of its own: the whole frame is recognized
    assert rt._recognize(frame)["identity"] == "staged"


def test_video_feed_streams_decodable_parts(embedder):
    from facerecognition_tpu_torch.apps import web_app as pweb
    from facerecognition_tpu_torch.inference.database_builder import DatabaseBuilder

    engine = RecognitionEngine(embedder=embedder, device="cpu")
    registry = pweb.EngineRegistry(device="cpu")
    registry._engines["arcface"] = engine
    rt = prt.RealtimeRecognizer(engine, source=prt.SyntheticFrameSource(128, 96))
    app = pweb.create_app(registry, builder=DatabaseBuilder(device="cpu"), realtime=rt)
    captured = {}
    body = app({"PATH_INFO": "/video_feed", "REQUEST_METHOD": "GET"},
               lambda status, headers: captured.update(status=status, headers=dict(headers)))
    assert captured["headers"]["Content-Type"] == "multipart/x-mixed-replace; boundary=frame"
    for _, part in zip(range(3), body):
        head, jpeg = part.split(b"\r\n\r\n", 1)
        assert head == b"--frame\r\nContent-Type: image/jpeg"
        assert decode_mem(jpeg[:-2]).shape == (96, 128, 3)
    body.close()
    result = _wait_for_result(rt)
    assert result["identity"] == "Unknown"  # an empty gallery: recognize() says "No database loaded"
    stop = app({"PATH_INFO": "/stop_camera", "REQUEST_METHOD": "POST", "CONTENT_LENGTH": "0"},
               lambda *a: None)
    assert json.loads(b"".join(stop)) == {"status": "stopped"}


def test_camera_source_needs_an_injected_capture():
    with pytest.raises(RuntimeError, match="capture object"):
        prt.CameraFrameSource()

    class Capture:
        released = False

        def __init__(self):
            self.frames = [np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)]

        def read(self):
            return (True, self.frames.pop()) if self.frames else (False, None)

        def release(self):
            Capture.released = True

    src = prt.CameraFrameSource(Capture())
    bgr = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    np.testing.assert_array_equal(src.read(), bgr[:, ::-1, ::-1])  # mirrored, RGB
    assert src.read() is None
    src.release()
    assert Capture.released

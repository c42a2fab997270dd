"""Realtime video pipeline: frame source → detect → embed → match → overlay.

Counterpart of ``facerecognition_tpu/apps/realtime.py``: frame sources
(synthetic, an injected camera capture, Motion-JPEG AVI files), the batched
offline ``process_video`` and the ``RealtimeRecognizer`` worker behind the
web app's MJPEG stream. The port imports no cv2:

- ``VideoFileSource`` reads Motion-JPEG in an AVI (RIFF) container itself
  (``avi_frames``: the ``movi`` lists' ``##dc`` chunks, in ``AVIX``
  extensions too) and decodes each frame with ``data/native_decode``; any
  other container or codec raises ``FileNotFoundError``, as the JAX source
  does for a file cv2 cannot open;
- ``CameraFrameSource`` reads a capture object the caller passes in (such
  as a ``cv2.VideoCapture``);
- the stream's frames are encoded by ``utils/imageio.encode_jpeg``.

A failure of the fused path that is not an expected ``ValueError`` (a
kernel that does not build or launch) propagates: the worker records it in
``result`` and stops, it never answers from the staged path instead.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from facerecognition_tpu_torch.data import native_decode
from facerecognition_tpu_torch.utils.imageio import encode_jpeg

#: Codec tags (``strh`` handler or ``strf`` compression) read as Motion-JPEG.
MJPEG_TAGS = (b"MJPG", b"mjpg", b"JPEG", b"jpeg")


class SyntheticFrameSource:
    """Procedural frame source for environments without a camera: a moving
    synthetic face (the generator the detector trains on), the JAX source's
    frames for the same clock."""

    def __init__(self, width: int = 640, height: int = 480, fps: float = 30.0):
        self.width = width
        self.height = height
        self.fps = fps
        self._t0 = time.time()

    def read(self) -> Optional[np.ndarray]:
        from facerecognition_tpu_torch.training.train_detector import synthetic_face_batch

        t = time.time() - self._t0
        rng = np.random.default_rng(int(t * 2) % 1000)
        img, _, _, _ = synthetic_face_batch(rng, 1, min(self.height, self.width), p_face=1.0)
        frame = np.zeros((self.height, self.width, 3), np.uint8)
        s = img.shape[1]
        frame[:s, :s] = img[0].astype(np.uint8)
        return frame

    def release(self) -> None:
        pass


class CameraFrameSource:
    """A live camera through a capture object the caller opens, with
    ``read() -> (ok, bgr frame)`` and optionally ``release()`` (such as
    ``cv2.VideoCapture(0)``); frames come back mirrored and as RGB, as the
    JAX source's."""

    def __init__(self, capture=None):
        if capture is None:
            raise RuntimeError(
                "CameraFrameSource needs a capture object with read() -> (ok, BGR frame), "
                "such as a cv2.VideoCapture opened by the caller: the port opens no camera itself"
            )
        self.cap = capture

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self.cap.read()
        if not ok:
            return None
        return np.asarray(frame)[:, ::-1, ::-1].copy()  # mirror + BGR→RGB

    def release(self) -> None:
        release = getattr(self.cap, "release", None)
        if release is not None:
            release()


def _chunks(f, start: int, end: int):
    """(fourcc, list type or None, body offset, body size) of the RIFF
    chunks in [start, end)."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(12)
        if len(head) < 8:
            return
        cid, size = head[:4], struct.unpack("<I", head[4:8])[0]
        if cid in (b"RIFF", b"LIST"):
            yield cid, head[8:12], pos + 12, max(size - 4, 0)
        else:
            yield cid, None, pos + 8, size
        pos += 8 + size + (size & 1)


def avi_frames(path: str) -> tuple[float, int, list[tuple[int, int]]]:
    """Index a Motion-JPEG AVI: (fps from the video stream's ``strh`` rate
    and scale, as cv2 reads it, else ``avih``'s microseconds per frame;
    frame count from ``avih``'s total frames (``dmlh``'s where an OpenDML
    header gives one), [(offset, size)] of each non-empty ``##dc`` chunk of
    the video stream in every ``movi`` list, ``AVIX`` extensions included).
    Anything else, or a file that gives no frame rate, raises
    ``FileNotFoundError``."""
    fail = FileNotFoundError(f"cannot open video: {path}")
    try:
        f = open(path, "rb")
    except OSError as exc:
        raise fail from exc
    with f:
        file_size = os.fstat(f.fileno()).st_size
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise fail
        us_per_frame, total, odml_total = 0, 0, 0
        streams: list[tuple[bytes, bytes, float]] = []  # (type, codec, frame rate) per strl
        movi: list[tuple[int, int]] = []
        for cid, kind, off, size in _chunks(f, 0, file_size):
            if cid != b"RIFF" or kind not in (b"AVI ", b"AVIX"):
                continue
            for cid2, kind2, off2, size2 in _chunks(f, off, min(off + size, file_size)):
                if kind2 == b"movi":
                    movi.append((off2, min(off2 + size2, file_size)))
                elif kind2 == b"hdrl":
                    for cid3, kind3, off3, size3 in _chunks(f, off2, off2 + size2):
                        f.seek(off3)
                        if cid3 == b"avih" and size3 >= 20:
                            body = f.read(20)
                            us_per_frame = struct.unpack("<I", body[:4])[0]
                            total = struct.unpack("<I", body[16:20])[0]
                        elif kind3 == b"strl":
                            stype, codec, rate = b"", b"", 0.0
                            for cid4, _, off4, size4 in _chunks(f, off3, off3 + size3):
                                f.seek(off4)
                                if cid4 == b"strh" and size4 >= 28:
                                    body = f.read(28)
                                    stype, codec = body[:4], body[4:8]
                                    scale, rate_num = struct.unpack("<II", body[20:28])
                                    rate = rate_num / scale if scale else 0.0
                                elif cid4 == b"strf" and size4 >= 20 and stype == b"vids":
                                    compression = f.read(20)[16:20]
                                    codec = compression if compression in MJPEG_TAGS else codec
                            streams.append((stype, codec, rate))
                        elif kind3 == b"odml":
                            for cid4, _, off4, size4 in _chunks(f, off3, off3 + size3):
                                if cid4 == b"dmlh" and size4 >= 4:
                                    f.seek(off4)
                                    odml_total = struct.unpack("<I", f.read(4))[0]
        video = [i for i, (stype, _, _) in enumerate(streams) if stype == b"vids"]
        if not video or streams[video[0]][1] not in MJPEG_TAGS or not movi:
            raise fail
        tag = b"%02ddc" % video[0]
        frames = [
            (off, size)
            for start, end in movi
            for cid, _, off, size in _chunks(f, start, end)
            if cid == tag and size > 0 and off + size <= file_size
        ]
    fps = streams[video[0]][2] or (1e6 / us_per_frame if us_per_frame else 0.0)
    if not frames or not fps:
        raise fail
    return fps, odml_total or total or len(frames), frames


class VideoFileSource:
    """Frame source over a Motion-JPEG AVI file (``avi_frames``), frames as
    RGB uint8; ``fps`` and ``frame_count`` from its header."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self.fps, self.frame_count, self._frames = avi_frames(self.path)
        self._file = open(self.path, "rb")
        self._next = 0

    def read(self) -> Optional[np.ndarray]:
        if self._file is None or self._next >= len(self._frames):
            return None
        offset, size = self._frames[self._next]
        self._next += 1
        self._file.seek(offset)
        try:
            return native_decode.decode_mem(self._file.read(size), f"{self.path} frame {self._next - 1}")
        except OSError:
            # an undecodable frame ends the stream, as cv2's read() does; a
            # failure of the card (RuntimeError) reaches the caller
            return None

    def release(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def process_video(
    engine,
    source,
    batch_size: int = 32,
    every_n: int = 1,
    k: int = 5,
    max_faces: int = 1,
    max_frames: Optional[int] = None,
    on_batch: Optional[Callable[[int, list], None]] = None,
) -> dict:
    """Batched offline recognition over a video.

    Frames are accumulated into fixed-size batches and pushed through
    ``RecognitionEngine.fused_recognize_frames`` when the engine has a
    detector and a gallery, else through ``recognize_batch``. The tail batch
    is zero-padded to ``batch_size``, so every call has one shape, and the
    padding's results are dropped.

    Args:
      engine: a RecognitionEngine.
      source: a frame source (``read()``/``release()``) or a video path.
      every_n: process every n-th frame.
      on_batch: optional callback ``(frames_done, batch_results)``.

    Returns:
      ``{"results": [per-frame dicts], "frames": N, "elapsed_s": t,
      "fps": N/t}``; results align with the processed (strided) frames.
    """
    if every_n < 1:
        raise ValueError(f"every_n must be >= 1, got {every_n}")
    if max_frames is not None and max_frames <= 0:
        return {"results": [], "frames": 0, "elapsed_s": 0.0, "fps": 0.0}
    if isinstance(source, (str, bytes, os.PathLike)):
        source = VideoFileSource(source)
    use_fused = engine.detector is not None and len(engine.gallery) > 0

    def flush(batch: list) -> list:
        n = len(batch)
        if n == 0:
            return []
        if use_fused:
            frames = np.stack(batch)
            if n < batch_size:  # zero-pad: one shape for every call
                frames = np.concatenate(
                    [frames, np.zeros((batch_size - n, *frames.shape[1:]), frames.dtype)]
                )
            res = engine.fused_recognize_frames(frames, k=k, max_faces=max_faces)
        else:
            res = engine.recognize_batch(list(batch), k=k)
        return res[:n]

    results: list = []
    t0 = time.perf_counter()
    batch: list = []
    i = 0
    try:
        while True:
            frame = source.read()
            if frame is None:
                break
            if i % every_n == 0:
                batch.append(np.asarray(frame))
                if len(batch) == batch_size:
                    out = flush(batch)
                    results.extend(out)
                    if on_batch is not None:
                        on_batch(len(results), out)
                    batch = []
            i += 1
            if max_frames is not None and len(results) + len(batch) >= max_frames:
                break
        out = flush(batch)
        results.extend(out)
        if out and on_batch is not None:
            on_batch(len(results), out)
    finally:
        source.release()
    elapsed = time.perf_counter() - t0
    return {
        "results": results,
        "frames": len(results),
        "elapsed_s": elapsed,
        "fps": len(results) / elapsed if elapsed > 0 else 0.0,
    }


class RealtimeRecognizer:
    """Continuous recognition worker over a frame source.

    A worker thread runs detect→embed→match on the latest frame; the MJPEG
    generator overlays the latest result. ``min_interval`` throttles
    recognition (0: every frame the worker can take).
    """

    def __init__(self, engine, detector=None, source=None, min_interval: float = 0.0):
        self.engine = engine
        self.detector = detector
        self.source = source or SyntheticFrameSource()
        self.min_interval = min_interval
        self._lock = threading.Lock()
        self._result: dict = {"identity": "...", "confidence": 0.0, "bbox": None}
        self._latest_frame: Optional[np.ndarray] = None
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    # -- worker -------------------------------------------------------------

    def _recognize_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                frame = self._latest_frame
            if frame is None:
                time.sleep(0.01)
                continue
            t0 = time.time()
            try:
                result = self._recognize(frame)
            except Exception as exc:
                # the worker stops on a failure and says so; it is raised on
                with self._lock:
                    self._result = {"identity": "Error", "confidence": 0.0, "bbox": None,
                                    "error": f"{type(exc).__name__}: {exc}"}
                raise
            with self._lock:
                self._result = result
            dt = time.time() - t0
            if self.min_interval > dt:
                time.sleep(self.min_interval - dt)

    def _recognize(self, frame: np.ndarray) -> dict:
        # Fast path: one fused call when detector + gallery exist.
        if (
            self.detector is not None
            and getattr(self.engine, "detector", None) is self.detector
            and len(getattr(self.engine, "gallery", [])) > 0
        ):
            try:
                res = self.engine.fused_recognize_frames(frame[None], max_faces=4)[0]
                return {
                    "identity": res["identity"],
                    "confidence": res["confidence"],
                    "bbox": res["bbox"],
                    # every detected face, for the multi-face overlay
                    "faces": [
                        {
                            "identity": f["identity"],
                            "confidence": float(f["confidence"]),
                            "bbox": f["bbox"],
                        }
                        for f in res["faces"]
                    ],
                    "time_ms": None,
                }
            except ValueError:
                pass  # the engine's expected refusals: the staged path below
        bbox = None
        face = frame
        if self.detector is not None:
            det = self.detector.detect(frame)
            if det is None:
                return {"identity": "No face", "confidence": 0.0, "bbox": None}
            bbox = det["bbox"]
            if det.get("landmarks") is not None:
                from facerecognition_tpu_torch.ops.image import align_crop

                dev = self.engine.device
                face = align_crop(
                    torch.as_tensor(frame.astype(np.float32), device=dev),
                    torch.as_tensor(np.asarray(det["landmarks"], np.float32), device=dev),
                    self.engine.embedder.config.input_size,
                ).cpu().numpy()
            else:
                face = self.detector.crop_face(frame, bbox)
        res = self.engine.recognize(np.asarray(face, np.uint8))
        return {
            "identity": res.get("identity", "Unknown"),
            "confidence": float(res.get("confidence", 0.0)),
            "bbox": bbox,
            "time_ms": None,
        }

    # -- public API ---------------------------------------------------------

    def start(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._stop.clear()
            self._worker = threading.Thread(target=self._recognize_loop, daemon=True)
            self._worker.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the worker (waiting up to ``timeout`` s for its current frame)
        and release the source."""
        self._stop.set()
        worker = self._worker
        if worker is not None and worker is not threading.current_thread():
            worker.join(timeout)
        self.source.release()

    @property
    def result(self) -> dict:
        with self._lock:
            return dict(self._result)

    def frames(self) -> Iterator[bytes]:
        """MJPEG generator: JPEG frames with the recognition overlay."""
        self.start()
        while not self._stop.is_set():
            frame = self.source.read()
            if frame is None:
                break
            with self._lock:
                self._latest_frame = frame
                result = dict(self._result)
            out = frame.copy()
            boxes = [
                f["bbox"] for f in result.get("faces") or [] if f.get("bbox") is not None
            ] or ([result["bbox"]] if result.get("bbox") is not None else [])
            for bb in boxes:
                x1, y1, x2, y2 = (int(round(v)) for v in bb)
                x1, x2 = np.clip([x1, x2], 0, out.shape[1] - 1)
                y1, y2 = np.clip([y1, y2], 0, out.shape[0] - 1)
                out[y1:y2, x1 : x1 + 2] = (0, 255, 0)
                out[y1:y2, x2 - 1 : x2 + 1] = (0, 255, 0)
                out[y1 : y1 + 2, x1:x2] = (0, 255, 0)
                out[y2 - 1 : y2 + 1, x1:x2] = (0, 255, 0)
            yield _encode_jpeg(out)

    def single_jpeg(self) -> bytes:
        """One annotated frame (for tests and polling clients)."""
        return next(self.frames())


def _encode_jpeg(rgb: np.ndarray, quality: int = 80) -> bytes:
    return encode_jpeg(rgb, quality)

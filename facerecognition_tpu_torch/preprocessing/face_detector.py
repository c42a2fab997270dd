"""FaceDetector: the detector state the fused serving path reads, and
multi-face detection on one image.

Counterpart of ``facerecognition_tpu/preprocessing/face_detector.py``: the
checkpoint resolvers, what ``RecognitionEngine.fused_recognize_frames``
reads (net, anchors, Platt calibration, thresholds, input size, IoU
threshold), ``detect_all``/``detect``/``crop_face``/``visualize`` on an
image array, path or bytes, ``detect_batch`` over paths and
``compare_detectors``.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.models.detector_net import (
    anchor_centers,
    build_detector_net,
)
from facerecognition_tpu_torch.ops.detect_post import detect_post
from facerecognition_tpu_torch.ops.image import bilinear_resize, crop_with_margin
from facerecognition_tpu_torch.utils.imageio import load_image
from facerecognition_tpu_torch.utils.serialization import load_variables

#: Shipped checkpoints in preference order (same chain as the JAX package).
DEFAULT_CHECKPOINTS = (
    "detector_v4_128.msgpack",
    "detector_v3_128.msgpack",
    "detector_v2_128.msgpack",
    "detector_synthetic_128.msgpack",
)

ASSETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
)


def default_detector_checkpoint() -> Optional[str]:
    """Path of the best shipped detector checkpoint, or None."""
    for name in DEFAULT_CHECKPOINTS:
        path = os.path.join(ASSETS_DIR, name)
        if os.path.exists(path):
            return path
    return None


def load_detector_checkpoint(
    weights: Union[str, os.PathLike, Mapping],
) -> tuple[str, dict, Optional[tuple[float, float]]]:
    """Decode a checkpoint (path or loaded dict) into ``(arch, variables,
    calibration)``; the ``arch`` marker (absent: the original ``blaze``) and
    the Platt ``calibration`` (a, b) are popped out of the variables."""
    if isinstance(weights, (str, os.PathLike)):
        variables = load_variables(os.fspath(weights))
    else:
        variables = dict(weights)
    arch = "blaze"
    raw_arch = variables.pop("arch", None)
    if raw_arch is not None:
        arch = raw_arch.decode() if isinstance(raw_arch, bytes) else str(raw_arch)
    cal = variables.pop("calibration", None)
    if cal is not None:
        cal = (float(cal["a"]), float(cal["b"]))
    return arch, variables, cal


def random_blaze_net(seed: int = 0, dtype=torch.float32) -> torch.nn.Module:
    """A randomly initialised ``BlazeFaceNet`` (on the CPU, computing in
    ``dtype``), drawn from a ``torch.Generator`` seeded with ``seed``: flax's
    initialisers' family (LeCun-normal kernels, variance 1 / fan-in; zero
    biases), not flax's numbers, which come from JAX's PRNG."""
    gen = torch.Generator().manual_seed(seed)
    net = build_detector_net("blaze", dtype)
    with torch.no_grad():
        for conv in net.modules():
            if isinstance(conv, torch.nn.Conv2d):
                fan_in = conv.weight[0].numel()
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / fan_in**0.5)
                conv.bias.zero_()
    return net


class FaceDetector:
    """Detector net + anchors + thresholds on one device.

    ``weights``: checkpoint path or loaded variables; ``None`` takes the
    best shipped checkpoint at ``input_size`` 128 and, at any other size
    (the shipped checkpoints are 128²) or without one, a random-init
    ``BlazeFaceNet`` (``random_blaze_net()``, seed 0), as the JAX detector
    builds one there from ``PRNGKey(0)``. ``device=None`` means the CUDA card.
    ``iou_threshold`` and ``max_faces`` set the NMS of ``detect_all`` (the
    fused engine takes its own ``max_faces`` and this ``iou_threshold``).
    ``backend`` is ``"blazeface"``, the only one, as in the JAX detector; a
    checkpoint without Platt calibration warns, as there. ``dtype``
    (float32, bfloat16 or float16, or its name) is the net's compute dtype:
    its raw output, and so the post-process, stay float32.
    """

    def __init__(
        self,
        backend: str = "blazeface",
        confidence_threshold: float = 0.9,
        min_face_size: int = 20,
        select_largest: bool = True,
        input_size: int = 128,
        iou_threshold: float = 0.3,
        max_faces: int = 16,
        weights: Optional[Union[str, Mapping]] = None,
        dtype=torch.float32,
        device: DeviceLike = None,
    ):
        if backend != "blazeface":
            raise ValueError(
                f"backend {backend!r} not available — the TPU build ships the "
                "single 'blazeface' jitted backend (covers the reference's "
                "mtcnn/retinaface/opencv roles)"
            )
        self.backend = backend
        self.device = resolve_device(device)
        self.confidence_threshold = confidence_threshold
        self.min_face_size = min_face_size
        self.select_largest = select_largest
        self.input_size = input_size
        self.iou_threshold = iou_threshold
        self.max_faces = max_faces
        if weights is None and input_size == 128:
            weights = default_detector_checkpoint()
        if weights is None:
            self.arch, self._calibration = "blaze", None
            net = random_blaze_net(dtype=dtype)
        else:
            self.arch, variables, self._calibration = load_detector_checkpoint(weights)
            if self._calibration is None:
                warnings.warn(
                    "detector checkpoint has no 'calibration' key: raw "
                    "focal-loss scores are deflated, so absolute "
                    "confidence thresholds will under-detect. Fit one via "
                    "training.train_detector.fit_score_calibration.",
                    stacklevel=2,
                )
            net = build_detector_net(self.arch, dtype)
            load_flax_variables(net, variables)
        self.net = net.to(self.device).eval()
        self.dtype = self.net.dtype
        self.anchors = torch.as_tensor(anchor_centers(input_size), device=self.device)

    @torch.no_grad()
    def _run(self, image: np.ndarray):
        """Resize to the detector size, detect, and map back to image pixels:
        float64 boxes (M, 4), landmarks (M, 5, 2), calibrated scores (M,),
        valid (M,)."""
        h, w = image.shape[:2]
        s = self.input_size
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        if (h, w) != (s, s):
            img = bilinear_resize(img, s, s)
        with strict_fp32():
            raw = self.net(img[None] / 127.5 - 1.0)
            out = detect_post(raw, self.anchors, self.iou_threshold, self.max_faces)
        boxes, lms, scores, valid = (t[0].cpu().numpy() for t in out)
        boxes = boxes.astype(np.float64)
        lms = lms.astype(np.float64)
        scores = scores.astype(np.float64)
        if self._calibration is not None:
            a, b = self._calibration
            p = np.clip(scores, 1e-9, 1 - 1e-9)
            scores = 1.0 / (1.0 + np.exp(-(a * np.log(p / (1 - p)) + b)))
        sx, sy = w / s, h / s
        boxes[:, 0::2] *= sx
        boxes[:, 1::2] *= sy
        lms[..., 0] *= sx
        lms[..., 1] *= sy
        return boxes, lms, scores, valid

    def detect_all(self, image) -> list[dict]:
        """All faces of an image (array, path or encoded bytes) above the
        confidence threshold and minimum size, in NMS order (score
        descending): dicts of ``bbox``, ``landmarks``, ``confidence``."""
        boxes, lms, scores, valid = self._run(load_image(image))
        out = []
        for i in range(len(scores)):
            if not valid[i] or scores[i] < self.confidence_threshold:
                continue
            if min(boxes[i, 2] - boxes[i, 0], boxes[i, 3] - boxes[i, 1]) < self.min_face_size:
                continue
            out.append(
                {
                    "bbox": boxes[i].tolist(),
                    "landmarks": lms[i].tolist(),
                    "confidence": float(scores[i]),
                }
            )
        return out

    def detect(self, image) -> Optional[dict]:
        """One face: the largest by box area when ``select_largest``, else
        the most confident; None when ``detect_all`` finds none."""
        faces = self.detect_all(image)
        if not faces:
            return None
        if self.select_largest:
            faces.sort(
                key=lambda f: (f["bbox"][2] - f["bbox"][0]) * (f["bbox"][3] - f["bbox"][1]),
                reverse=True,
            )
        return faces[0]

    def detect_batch(self, image_paths: Sequence[str]):
        """``detect`` over many paths: one row per path (``image_path``,
        ``detected`` and, for a face, ``confidence``, ``x1``..``y2``,
        ``width``, ``height``), as a pandas DataFrame where pandas imports,
        else as a list of dicts. An unreadable path is a row with
        ``detected`` False."""
        rows = []
        for path in image_paths:
            try:
                det = self.detect(path)
            except OSError:
                det = None
            row = {"image_path": str(path), "detected": det is not None}
            if det is not None:
                x1, y1, x2, y2 = det["bbox"]
                row.update(confidence=det["confidence"], x1=x1, y1=y1, x2=x2, y2=y2,
                           width=x2 - x1, height=y2 - y1)
            rows.append(row)
        try:
            import pandas as pd
        except ImportError:
            return rows
        return pd.DataFrame(rows)

    def crop_face(
        self,
        image,
        bbox: Optional[Sequence[float]] = None,
        margin: float = 0.2,
        target_size: int = 112,
    ) -> Optional[np.ndarray]:
        """``bbox`` (or the ``detect`` face's) with a relative ``margin``,
        resized to ``target_size``²: uint8 (clipped), or None without a
        face."""
        img = load_image(image)
        if bbox is None:
            det = self.detect(img)
            if det is None:
                return None
            bbox = det["bbox"]
        out = crop_with_margin(
            torch.as_tensor(np.asarray(img, np.float32), device=self.device),
            torch.as_tensor(np.asarray(bbox, np.float32), device=self.device),
            margin,
            target_size,
        )
        return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8)

    def visualize(self, image, detections: Optional[list[dict]] = None) -> np.ndarray:
        """The image with each face's box (green, 2 px) and landmarks (red
        3x3 dots) drawn: RGB uint8."""
        img = load_image(image).copy()
        if detections is None:
            detections = self.detect_all(img)
        for det in detections:
            x1, y1, x2, y2 = (int(round(v)) for v in det["bbox"])
            x1, x2 = np.clip([x1, x2], 0, img.shape[1] - 1)
            y1, y2 = np.clip([y1, y2], 0, img.shape[0] - 1)
            img[y1:y2, x1 : x1 + 2] = (0, 255, 0)
            img[y1:y2, x2 - 1 : x2 + 1] = (0, 255, 0)
            img[y1 : y1 + 2, x1:x2] = (0, 255, 0)
            img[y2 - 1 : y2 + 1, x1:x2] = (0, 255, 0)
            for lx, ly in det.get("landmarks") or []:
                lx, ly = int(round(lx)), int(round(ly))
                if 1 <= lx < img.shape[1] - 1 and 1 <= ly < img.shape[0] - 1:
                    img[ly - 1 : ly + 2, lx - 1 : lx + 2] = (255, 0, 0)
        return img


def compare_detectors(image, backends: Sequence[FaceDetector], n_runs: int = 5) -> list[dict]:
    """Latency and detection of each configured detector on one image:
    ``backend`` ("blazeface@<input size>"), ``latency_ms`` (the mean of
    ``n_runs`` ``detect`` calls after one warm call; each call reads its
    result back to the host), ``detected``, ``confidence``."""
    img = load_image(image)
    results = []
    for det in backends:
        det.detect(img)  # warm: cuDNN plans, the kernel library
        t0 = time.perf_counter()
        for _ in range(n_runs):
            r = det.detect(img)
        dt = (time.perf_counter() - t0) / n_runs
        results.append({
            "backend": f"{det.backend}@{det.input_size}",
            "latency_ms": dt * 1e3,
            "detected": r is not None,
            "confidence": r["confidence"] if r else 0.0,
        })
    return results

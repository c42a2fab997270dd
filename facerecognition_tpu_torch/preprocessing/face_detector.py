"""FaceDetector: the detector state the fused serving path reads, and
multi-face detection on one image.

Counterpart of ``facerecognition_tpu/preprocessing/face_detector.py``: the
checkpoint resolvers, what ``RecognitionEngine.fused_recognize_frames``
reads (net, anchors, Platt calibration, thresholds, input size, IoU
threshold), and ``detect_all``/``detect`` on an image array. ``detect_batch``
(paths into a DataFrame), ``crop_face`` and ``visualize`` wait (ROADMAP
Queue 1), and so do image paths: the port reads no image files.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import numpy as np
import torch

from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.models.detector_net import (
    anchor_centers,
    build_detector_net,
)
from facerecognition_tpu_torch.ops.detect_post import detect_post
from facerecognition_tpu_torch.ops.image import bilinear_resize
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


def _as_rgb_uint8(image) -> np.ndarray:
    """An image array as RGB uint8 HWC, as the JAX ``load_image`` takes an
    array: gray is stacked to three channels, alpha dropped, floats in
    [0, 1] scaled by 255, then clipped and cast."""
    if not isinstance(image, np.ndarray):
        raise TypeError(
            f"expected an image array, got {type(image).__name__}; the port "
            "reads no image files"
        )
    arr = image
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    elif arr.ndim == 3 and arr.shape[2] == 4:
        arr = arr[:, :, :3]
    if arr.dtype == np.uint8:
        return arr
    if np.issubdtype(arr.dtype, np.floating) and arr.max() <= 1.0 + 1e-6:
        arr = arr * 255.0
    return np.clip(arr, 0, 255).astype(np.uint8)


class FaceDetector:
    """Detector net + anchors + thresholds on one device.

    ``weights``: checkpoint path or loaded variables; ``None`` takes the
    best shipped checkpoint. ``device=None`` means the CUDA card.
    ``iou_threshold`` and ``max_faces`` set the NMS of ``detect_all`` (the
    fused engine takes its own ``max_faces`` and this ``iou_threshold``).
    """

    def __init__(
        self,
        confidence_threshold: float = 0.9,
        min_face_size: int = 20,
        select_largest: bool = True,
        input_size: int = 128,
        iou_threshold: float = 0.3,
        max_faces: int = 16,
        weights: Optional[Union[str, Mapping]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.confidence_threshold = confidence_threshold
        self.min_face_size = min_face_size
        self.select_largest = select_largest
        self.input_size = input_size
        self.iou_threshold = iou_threshold
        self.max_faces = max_faces
        if weights is None:
            if input_size != 128:
                # The JAX detector builds a random-init BlazeFaceNet here.
                raise NotImplementedError(
                    f"input_size={input_size} without weights needs a random-init "
                    "BlazeFaceNet, which is not ported yet (ROADMAP Queue 1); the "
                    "shipped checkpoints are 128x128"
                )
            weights = default_detector_checkpoint()
            if weights is None:
                raise FileNotFoundError(f"no detector checkpoint in {ASSETS_DIR}")
        self.arch, variables, self._calibration = load_detector_checkpoint(weights)
        net = build_detector_net(self.arch)
        load_flax_variables(net, variables)
        self.net = net.to(self.device).eval()
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

    def detect_all(self, image: np.ndarray) -> list[dict]:
        """All faces above the confidence threshold and minimum size, in NMS
        order (score descending): dicts of ``bbox``, ``landmarks``,
        ``confidence``."""
        boxes, lms, scores, valid = self._run(_as_rgb_uint8(image))
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

    def detect(self, image: np.ndarray) -> Optional[dict]:
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

"""FaceDetector: the detector state the fused serving path reads.

Counterpart of ``facerecognition_tpu/preprocessing/face_detector.py``: the
checkpoint resolvers and the parts of ``FaceDetector`` that
``RecognitionEngine.fused_recognize_frames`` uses (net, anchors, Platt
calibration, confidence threshold, minimum face size, input size). The
staged ``detect``/``detect_all``/``detect_batch`` API waits (ROADMAP).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Union

import torch

from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.device import DeviceLike, resolve_device
from facerecognition_tpu_torch.models.detector_net import (
    anchor_centers,
    build_detector_net,
)
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


class FaceDetector:
    """Detector net + anchors + thresholds on one device.

    ``weights``: checkpoint path or loaded variables; ``None`` takes the
    best shipped checkpoint. ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        confidence_threshold: float = 0.9,
        min_face_size: int = 20,
        input_size: int = 128,
        weights: Optional[Union[str, Mapping]] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.confidence_threshold = confidence_threshold
        self.min_face_size = min_face_size
        self.input_size = input_size
        if weights is None:
            weights = default_detector_checkpoint()
            if weights is None:
                raise FileNotFoundError(f"no detector checkpoint in {ASSETS_DIR}")
        self.arch, variables, self._calibration = load_detector_checkpoint(weights)
        net = build_detector_net(self.arch)
        load_flax_variables(net, variables)
        self.net = net.to(self.device).eval()
        self.anchors = torch.as_tensor(anchor_centers(input_size), device=self.device)

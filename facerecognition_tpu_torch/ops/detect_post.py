"""The crowd path's detector post-process: the wrapper of ``csrc/detect_post.cu``.

One kernel launch does, per frame, what ``models.detector_net.
detect_faces_batch`` (the counterpart of the JAX ``detect_faces`` +
``nms_padded``) does in a few dozen: decode, top-K prefilter in
``lax.top_k``'s order, greedy NMS, fixed-shape outputs.

A tensor on the CPU takes the plain version, ``detect_faces_batch``. A CUDA
tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.models.detector_net import detect_faces_batch, prefilter_size

#: Kernel launches (one per call on a CUDA tensor).
launches = _build.LaunchCounter()


def _library() -> ctypes.CDLL:
    lib = _build.load("detect_post")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.detect_post_launch.argtypes = [
        ptr, ptr, i, i, i, i, ctypes.c_float, ptr, ptr, ptr, ptr, i, ptr,
    ]
    lib.detect_post_launch.restype = i
    return lib


def _check(raw: torch.Tensor, anchors: torch.Tensor, max_faces: int) -> None:
    if raw.device != anchors.device:
        raise ValueError(f"raw on {raw.device} but anchors on {anchors.device}")
    for name, t, shape in (("raw", raw, (None, None, 15)), ("anchors", anchors, (None, 3))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != len(shape) or (shape[-1] != t.shape[-1]):
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if raw.shape[1] != anchors.shape[0]:
        raise ValueError(f"{raw.shape[1]} anchors in raw, {anchors.shape[0]} in anchors")
    if raw.shape[0] < 1 or raw.shape[1] < 1 or max_faces < 1:
        raise ValueError("need a frame, an anchor and max_faces >= 1")


def detect_post(
    raw: torch.Tensor, anchors: torch.Tensor, iou_threshold: float, max_faces: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """raw (B, A, 15), anchors (A, 3) → boxes (B, M, 4), landmarks
    (B, M, 5, 2), scores (B, M) (0 where invalid), valid (B, M) bool, in the
    detector's input pixels; M = ``max_faces``."""
    if raw.device.type == "cpu" and anchors.device.type == "cpu":
        return detect_faces_batch(raw, anchors, iou_threshold, max_faces)
    _check(raw, anchors, max_faces)
    b, a, _ = raw.shape
    k = prefilter_size(a, max_faces)
    dev = raw.device
    boxes = torch.empty((b, max_faces, 4), dtype=torch.float32, device=dev)
    lms = torch.empty((b, max_faces, 5, 2), dtype=torch.float32, device=dev)
    scores = torch.empty((b, max_faces), dtype=torch.float32, device=dev)
    valid = torch.empty((b, max_faces), dtype=torch.bool, device=dev)
    lib = _library()
    err = lib.detect_post_launch(
        raw.data_ptr(), anchors.data_ptr(), b, a, k, max_faces, float(iou_threshold),
        boxes.data_ptr(), lms.data_ptr(), scores.data_ptr(), valid.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == -1:  # e.g. more anchors or candidates than a block's shared memory holds
        raise ValueError("detect_post kernel refused its arguments")
    if err:
        raise RuntimeError(f"detect_post kernel launch failed: CUDA error {err}")
    launches.add()
    return boxes, lms, scores, valid

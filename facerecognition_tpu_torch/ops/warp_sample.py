"""The warp and resize of the serving path: the wrapper of ``csrc/warp_sample.cu``.

The kernel computes the two-pass separable functions of ``ops/warp_mxu.py``
(the counterparts of ``facerecognition_tpu/ops/warp_mxu.py``'s XLA einsums)
by sampling four source pixels per output pixel instead of building the
interpolation matrices, and computes each slot's map itself from its raw
landmarks (scale and clamp, Umeyama, inverse, coefficients, crowd window)
in the plain version's order of operations. One launch per call, no
PyTorch operation around it.

Public functions:
- ``detector_input`` / ``embedder_input``: the model inputs of the fused
  serving path, normalised, written as planar NCHW memory and returned as an
  NHWC view (the models' ``permute(0, 3, 1, 2)`` then hands the convolutions
  a contiguous NCHW tensor);
- ``bilinear_resize``, ``align_crop``, ``align_crop_window``: the same
  kernel with the normalisation off, the counterparts of the JAX functions;
- ``affine_warp``: the kernel's matrix mode, each slot warped by a given
  forward map (``affine_warp_mxu_batch``; training's augmentation).

A tensor on the CPU takes the plain version (the composition of the plain
functions). A CUDA tensor launches the kernel or raises; nothing falls back.
uint8 frames are read as they are (no float copy); float32 frames are read
as float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.ops import warp_mxu
from facerecognition_tpu_torch.ops.image import normalize_imagenet_style
from facerecognition_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE, invert_affine

#: Kernel launches (one per call on a CUDA tensor).
launches = _build.LaunchCounter()

_INF = float("inf")


class _Args(ctypes.Structure):
    """``struct Args`` of ``csrc/warp_sample.cu``, field for field."""

    _fields_ = [
        ("frames", ctypes.c_void_p),
        ("landmarks", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("slot_params", ctypes.c_void_p),
        ("matrices", ctypes.c_void_p),
        *((name, ctypes.c_int) for name in (
            "frames_u8", "n_frames", "H", "W", "slots", "per_frame", "out_h", "out_w",
            "window", "fast", "normalize",
        )),
        *((name, ctypes.c_float) for name in (
            "lm_scale_x", "lm_scale_y", "lm_min", "lm_max_x", "lm_max_y",
        )),
        ("tmpl", ctypes.c_float * 10),
        *((name, ctypes.c_float) for name in (
            "norm_mul", "norm_sub", "norm_scale", "lo", "hi_h", "hi_w", "ratio_y", "ratio_x",
        )),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("warp_sample")
    lib.warp_sample_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.warp_sample_launch.restype = ctypes.c_int
    return lib


def _f32_reciprocal(d: float) -> float:
    """``1 / d`` in float32: what PyTorch multiplies by on the card when a
    float32 tensor is divided by the Python number ``d``."""
    return float(np.float32(1.0) / np.float32(d))


#: (mul, sub, scale) of ``((v * mul) - sub) * scale``: the detector's
#: ``v / 127.5 - 1.0`` and ``normalize_imagenet_style``'s ``(v / 255 - 0.5)
#: / 0.5``, as the card computes them.
DETECTOR_NORM = (_f32_reciprocal(127.5), 1.0, 1.0)
EMBEDDER_NORM = (_f32_reciprocal(255.0), 0.5, _f32_reciprocal(0.5))


def _check_fast(fast) -> None:
    if fast not in (True, False):
        raise NotImplementedError(
            "only fast=False/True are ported; the int8 warp mode is not "
            "(ROADMAP Queue 1)"
        )


def _check_frames(frames: torch.Tensor) -> None:
    if frames.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"frames must be uint8 or float32, got {frames.dtype}")
    if frames.ndim != 4 or frames.shape[3] != 3:
        raise ValueError(f"frames must be (B, H, W, 3), got {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")


def _check_landmarks(frames: torch.Tensor, landmarks: torch.Tensor) -> None:
    if landmarks.ndim != 4 or tuple(landmarks.shape[2:]) != (5, 2):
        raise ValueError(f"landmarks must be (B, M, 5, 2), got {tuple(landmarks.shape)}")
    if landmarks.shape[0] != frames.shape[0] or landmarks.shape[1] < 1:
        raise ValueError(
            f"{landmarks.shape[0]} landmark sets for {frames.shape[0]} frames"
        )
    if landmarks.device != frames.device:
        raise ValueError(f"landmarks on {landmarks.device}, frames on {frames.device}")


def _check_matrices(frames: torch.Tensor, ms: torch.Tensor) -> None:
    if ms.ndim != 3 or tuple(ms.shape[1:]) != (2, 3) or ms.shape[0] != frames.shape[0]:
        raise ValueError(
            f"matrices must be ({frames.shape[0]}, 2, 3) for {frames.shape[0]} frames, "
            f"got {tuple(ms.shape)}"
        )
    if ms.device != frames.device:
        raise ValueError(f"matrices on {ms.device}, frames on {frames.device}")


def _template(out_size: int) -> list[float]:
    """The template scaled to ``out_size``, as ``warp_mxu.align_matrices``
    scales it."""
    return (torch.as_tensor(ARCFACE_TEMPLATE) * (out_size / 112.0)).flatten().tolist()


def _launch(
    frames: torch.Tensor,
    out_h: int,
    out_w: int,
    fast: bool,
    landmarks: Optional[torch.Tensor] = None,
    window: int = 0,
    lm_scale: tuple[float, float] = (1.0, 1.0),
    lm_bounds: tuple[float, float, float] = (-_INF, _INF, _INF),
    norm: Optional[tuple[float, float, float]] = None,
    slot_params: Optional[torch.Tensor] = None,
    matrices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One launch: (S, 3, out_h, out_w) float32 planar, returned as the
    (S, out_h, out_w, 3) view. Without landmarks or matrices slot s resizes
    frame s; with (B, 2, 3) forward ``matrices`` slot s warps frame s by its
    map; with (B, M, 5, 2) landmarks slot s warps frame s // M, from its
    ``window``² crop when ``window`` > 0."""
    _check_frames(frames)
    b, h, w, _ = frames.shape
    device = frames.device
    if matrices is not None:
        if landmarks is not None or window:
            raise ValueError("matrices take the place of landmarks and a window")
        _check_matrices(frames, matrices)
        matrices = matrices.float().contiguous()
        per_frame, region = 1, (h, w)
    elif landmarks is None:
        per_frame, region = 1, (h, w)
    else:
        _check_landmarks(frames, landmarks)
        landmarks = landmarks.float().contiguous()
        per_frame = landmarks.shape[1]
        region = (window, window) if window else (h, w)
    slots = b * per_frame
    if out_h < 1 or out_w < 1 or slots < 1:
        raise ValueError(f"cannot warp {slots} slots to {out_h}x{out_w}")
    if slot_params is not None and (
        slot_params.shape != (slots, 8) or slot_params.dtype != torch.float32
        or slot_params.device != device or not slot_params.is_contiguous()
    ):
        raise ValueError(f"slot_params must be a contiguous ({slots}, 8) float32 tensor")
    out = torch.empty((slots, 3, out_h, out_w), dtype=torch.float32, device=device)
    lo, hi_h = warp_mxu.inside_bounds(region[0])
    _, hi_w = warp_mxu.inside_bounds(region[1])
    norm_mul, norm_sub, norm_scale = norm or (1.0, 0.0, 1.0)
    args = _Args(
        frames=frames.data_ptr(),
        landmarks=None if landmarks is None else landmarks.data_ptr(),
        out=out.data_ptr(),
        slot_params=None if slot_params is None else slot_params.data_ptr(),
        matrices=None if matrices is None else matrices.data_ptr(),
        frames_u8=int(frames.dtype == torch.uint8), n_frames=b, H=h, W=w,
        slots=slots, per_frame=per_frame, out_h=out_h, out_w=out_w,
        window=window, fast=int(fast), normalize=int(norm is not None),
        lm_scale_x=lm_scale[0], lm_scale_y=lm_scale[1], lm_min=lm_bounds[0],
        lm_max_x=lm_bounds[1], lm_max_y=lm_bounds[2],
        tmpl=(ctypes.c_float * 10)(*_template(out_h)),
        norm_mul=norm_mul, norm_sub=norm_sub, norm_scale=norm_scale,
        lo=lo, hi_h=hi_h, hi_w=hi_w, ratio_y=h / out_h, ratio_x=w / out_w,
    )
    err = _library().warp_sample_launch(
        ctypes.byref(args), device.index, torch.cuda.current_stream(device).cuda_stream
    )
    if err == -1:
        raise ValueError("warp_sample kernel refused its arguments")
    if err:
        raise RuntimeError(f"warp_sample kernel launch failed: CUDA error {err}")
    launches.add()
    return out.permute(0, 2, 3, 1)


def _frame_scale(h: int, w: int, det_size: int):
    """The engine's landmark map from detector pixels to frame pixels: the
    float32 scale (x, y) and the clamp into the frame (0, w - 1, h - 1)."""
    return (w / det_size, h / det_size), (0.0, w - 1.0, h - 1.0)


# -- plain versions ------------------------------------------------------------


def scale_landmarks(landmarks: torch.Tensor, h: int, w: int, det_size: int) -> torch.Tensor:
    """Landmarks in detector pixels → frame pixels, clamped into the frame,
    as the JAX engine's fused graph maps them."""
    (sx, sy), (_, hx, hy) = _frame_scale(h, w, det_size)
    dev = landmarks.device
    scale = torch.tensor([sx, sy], device=dev)
    hi = torch.tensor([hx, hy], device=dev)
    return torch.minimum(torch.clamp(landmarks * scale, min=0.0), hi)


def _align_plain(frames, landmarks, out_size, window, fast):
    if window:
        return warp_mxu.align_crop_mxu_window(frames, landmarks, out_size, window, fast)
    b, m = landmarks.shape[:2]
    rep = frames if m == 1 else frames.repeat_interleave(m, 0)
    return warp_mxu.align_crop_mxu_batch(rep, landmarks.reshape(b * m, 5, 2), out_size, fast)


def detector_input_plain(frames: torch.Tensor, size: int, fast: bool = True) -> torch.Tensor:
    return warp_mxu.bilinear_resize_mxu_batch(frames, size, size, fast) / 127.5 - 1.0


def embedder_input_plain(
    frames: torch.Tensor,
    landmarks: torch.Tensor,
    det_size: int,
    out_size: int = 112,
    window: Optional[int] = None,
    fast: bool = True,
) -> torch.Tensor:
    _, h, w, _ = frames.shape
    lms = scale_landmarks(landmarks, h, w, det_size)
    return normalize_imagenet_style(_align_plain(frames, lms, out_size, window, fast))


def slot_parameters_plain(
    frames_shape, landmarks: torch.Tensor, out_size: int, window: Optional[int] = None,
    det_size: Optional[int] = None,
) -> torch.Tensor:
    """Each slot's (m00, m01, m02, aa, bb, cc, x0, y0) as the plain version
    computes them: (B·M, 8) float32."""
    _, h, w, _ = frames_shape
    lms = landmarks if det_size is None else scale_landmarks(landmarks, h, w, det_size)
    b, m = lms.shape[:2]
    if window:
        ms, origin, _ = warp_mxu.window_slots(lms, h, w, out_size, window)
    else:
        ms = warp_mxu.align_matrices(lms.reshape(b * m, 5, 2), out_size)
        origin = torch.zeros((b * m, 2), dtype=torch.int64, device=lms.device)
    coef = warp_mxu.warp_coefficients(invert_affine(ms))
    return torch.cat([coef, origin.float()], 1)


def affine_slot_parameters_plain(ms: torch.Tensor) -> torch.Tensor:
    """Each slot's (m00, m01, m02, aa, bb, cc, 0, 0) from its forward map,
    as ``affine_warp_mxu_batch`` computes them: (B, 8) float32."""
    coef = warp_mxu.warp_coefficients(invert_affine(ms.float()))
    return torch.cat([coef, coef.new_zeros((coef.shape[0], 2))], 1)


# -- the wrappers ----------------------------------------------------------------


def bilinear_resize(
    images: torch.Tensor, out_h: int, out_w: int, fast: bool = False
) -> torch.Tensor:
    """``warp_mxu.bilinear_resize_mxu_batch``: (B, H, W, 3) → (B, out_h,
    out_w, 3) float32, cv2 half-pixel centres, edge clamp."""
    _check_fast(fast)
    if images.device.type == "cpu":
        return warp_mxu.bilinear_resize_mxu_batch(images, out_h, out_w, fast)
    return _launch(images, out_h, out_w, fast)


def align_crop(
    frames: torch.Tensor, landmarks: torch.Tensor, out_size: int = 112, fast: bool = False
) -> torch.Tensor:
    """Every slot warped from its whole frame: frames (B, H, W, 3),
    landmarks (B, M, 5, 2) in frame pixels → (B·M, out_size, out_size, 3),
    slot-major per frame. The plain version repeats each frame M times and
    takes ``align_crop_mxu_batch``; the kernel reads frame s // M for slot s."""
    _check_fast(fast)
    if frames.device.type == "cpu":
        return _align_plain(frames, landmarks, out_size, None, fast)
    return _launch(frames, out_size, out_size, fast, landmarks)


def align_crop_window(
    frames: torch.Tensor,
    landmarks: torch.Tensor,
    out_size: int = 112,
    window: int = 160,
    fast: bool = False,
) -> torch.Tensor:
    """``warp_mxu.align_crop_mxu_window``: each slot warped from its static
    ``window``² crop (zero outside it). frames (B, H, W, 3), landmarks
    (B, M, 5, 2) → (B·M, out_size, out_size, 3). The kernel reads the crop
    in place."""
    _check_fast(fast)
    if frames.device.type == "cpu":
        return _align_plain(frames, landmarks, out_size, window, fast)
    _, h, w, _ = frames.shape
    return _launch(frames, out_size, out_size, fast, landmarks, min(window, h, w))


def affine_warp(
    frames: torch.Tensor, ms: torch.Tensor, out_h: int, out_w: int, fast: bool = False
) -> torch.Tensor:
    """``warp_mxu.affine_warp_mxu_batch``: frames (B, H, W, 3) uint8 or
    float32, each warped by its (B, 2, 3) forward map (cv2.warpAffine
    convention) → (B, out_h, out_w, 3) float32, zero outside the frame. The
    kernel inverts each map in the launch (on the card an NHWC view of NCHW
    memory)."""
    _check_fast(fast)
    if frames.device.type == "cpu":
        return warp_mxu.affine_warp_mxu_batch(frames, ms, out_h, out_w, fast=fast)
    return _launch(frames, out_h, out_w, fast, matrices=ms)


def affine_slot_parameters(frames: torch.Tensor, ms: torch.Tensor, out_size: int) -> torch.Tensor:
    """Each slot's (m00, m01, m02, aa, bb, cc, 0, 0) as ``affine_warp``
    computes them, (B, 8) float32: from the kernel's prologue on the card (one
    launch, its output dropped), from the plain functions on the CPU."""
    if frames.device.type == "cpu":
        return affine_slot_parameters_plain(ms)
    params = torch.empty((frames.shape[0], 8), dtype=torch.float32, device=frames.device)
    _launch(frames, out_size, out_size, True, slot_params=params, matrices=ms)
    return params


def detector_input(frames: torch.Tensor, size: int, fast: bool = True) -> torch.Tensor:
    """The detector's input: ``bilinear_resize(frames, size, size, fast) /
    127.5 - 1.0``, (B, size, size, 3) float32 (on the card an NHWC view of
    NCHW memory)."""
    _check_fast(fast)
    if frames.device.type == "cpu":
        return detector_input_plain(frames, size, fast)
    return _launch(frames, size, size, fast, norm=DETECTOR_NORM)


def embedder_input(
    frames: torch.Tensor,
    landmarks: torch.Tensor,
    det_size: int,
    out_size: int = 112,
    window: Optional[int] = None,
    fast: bool = True,
) -> torch.Tensor:
    """The embedder's input: landmarks (B, M, 5, 2) in detector pixels
    (``det_size``²) scaled to the (B, H, W, 3) frames and clamped into them,
    each slot aligned from its whole frame (``window`` None) or from its
    ``window``² crop, then ``normalize_imagenet_style``: (B·M, out_size,
    out_size, 3) float32 (on the card an NHWC view of NCHW memory)."""
    _check_fast(fast)
    if frames.device.type == "cpu":
        return embedder_input_plain(frames, landmarks, det_size, out_size, window, fast)
    _, h, w, _ = frames.shape
    scale, bounds = _frame_scale(h, w, det_size)
    win = min(window, h, w) if window else 0
    return _launch(
        frames, out_size, out_size, fast, landmarks, win, scale, bounds, EMBEDDER_NORM
    )


def slot_parameters(
    frames: torch.Tensor, landmarks: torch.Tensor, out_size: int = 112,
    window: Optional[int] = None, det_size: Optional[int] = None,
) -> torch.Tensor:
    """Each slot's (m00, m01, m02, aa, bb, cc, x0, y0) as the warp computes
    them, (B·M, 8) float32: from the kernel's prologue on the card (one
    launch of the warp, its output dropped), from the plain functions on
    the CPU. ``det_size`` given: landmarks in detector pixels, as
    ``embedder_input`` takes them."""
    if frames.device.type == "cpu":
        return slot_parameters_plain(frames.shape, landmarks, out_size, window, det_size)
    _, h, w, _ = frames.shape
    scale, bounds = ((1.0, 1.0), (-_INF, _INF, _INF)) if det_size is None else _frame_scale(
        h, w, det_size
    )
    params = torch.empty(
        (landmarks.shape[0] * landmarks.shape[1], 8), dtype=torch.float32, device=frames.device
    )
    win = min(window, h, w) if window else 0
    _launch(frames, out_size, out_size, True, landmarks, win, scale, bounds, slot_params=params)
    return params

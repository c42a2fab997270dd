"""The warp and resize of the serving path: the wrapper of ``csrc/warp_sample.cu``.

The kernel computes the two-pass separable functions of ``ops/warp_mxu.py``
(the counterparts of ``facerecognition_tpu/ops/warp_mxu.py``'s XLA einsums)
by sampling four source pixels per output pixel instead of building the
interpolation matrices. Per-slot coefficients, resize positions and crop
windows come from the plain module's own code, so both sides sample the
same positions.

A tensor on the CPU takes the plain two-pass version. A CUDA tensor launches
the kernel or raises; nothing falls back. uint8 frames are read as they are
(no float copy); float32 frames are read as float32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.ops import warp_mxu
from facerecognition_tpu_torch.ops.umeyama import invert_affine

#: Kernel launches (one per call on a CUDA tensor).
launches = _build.LaunchCounter()

_MAX_PIXELS = 256 * 65535  # output pixels per slot: the kernel's grid


def _library() -> ctypes.CDLL:
    lib = _build.load("warp_sample")
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.warp_sample_launch.argtypes = [
        ptr, i, i, i, ptr, ptr, ptr, ptr, i, i, i, f, f, f, i, i, i, ptr, i, ptr,
    ]
    lib.warp_sample_launch.restype = i
    return lib


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


def _launch(
    frames: torch.Tensor,
    n_slots: int,
    out_h: int,
    out_w: int,
    fast: bool,
    region: tuple[int, int],
    coef: torch.Tensor | None = None,
    src: torch.Tensor | None = None,
    ypos: torch.Tensor | None = None,
    xpos: torch.Tensor | None = None,
) -> torch.Tensor:
    _check_frames(frames)
    device = frames.device
    for name, t in (("coef", coef), ("src", src), ("ypos", ypos), ("xpos", xpos)):
        if t is not None and (t.device != device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {device}")
    if not 1 <= out_h * out_w <= _MAX_PIXELS or n_slots < 1:
        raise ValueError(f"cannot warp {n_slots} slots to {out_h}x{out_w}")
    _, h, w, _ = frames.shape
    lo, hi_h = warp_mxu.inside_bounds(region[0])
    _, hi_w = warp_mxu.inside_bounds(region[1])
    out = torch.empty((n_slots, out_h, out_w, 3), dtype=torch.float32, device=device)
    lib = _library()

    def addr(t):
        return None if t is None else t.data_ptr()

    err = lib.warp_sample_launch(
        frames.data_ptr(), int(frames.dtype == torch.uint8), h, w,
        addr(coef), addr(src), addr(ypos), addr(xpos), n_slots, region[0], region[1],
        lo, hi_h, hi_w, out_h, out_w, int(fast), out.data_ptr(), device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err == -1:
        raise ValueError("warp_sample kernel refused its arguments")
    if err:
        raise RuntimeError(f"warp_sample kernel launch failed: CUDA error {err}")
    launches.add()
    return out


def _slots(
    frames: torch.Tensor,
    ms: torch.Tensor,
    origin: torch.Tensor,
    frame_of: torch.Tensor,
    region: tuple[int, int],
    out_h: int,
    out_w: int,
    fast: bool,
) -> torch.Tensor:
    """Launch the affine mode: slot s samples frame ``frame_of[s]``'s region
    at ``origin[s]`` (x0, y0) under the forward map ``ms[s]``."""
    coef = warp_mxu.warp_coefficients(invert_affine(ms.float())).contiguous()
    src = torch.cat([frame_of[:, None], origin], 1).int().contiguous()
    return _launch(frames, ms.shape[0], out_h, out_w, fast, region, coef=coef, src=src)


@functools.lru_cache(maxsize=64)
def _resize_tables(h: int, w: int, out_h: int, out_w: int, device: torch.device):
    """The resize's row and column positions, made once per shape: they
    depend on nothing else, and making them is ten small launches."""
    return (
        warp_mxu.resize_positions(h, out_h, device),
        warp_mxu.resize_positions(w, out_w, device),
    )


def bilinear_resize(
    images: torch.Tensor, out_h: int, out_w: int, fast: bool = False
) -> torch.Tensor:
    """``warp_mxu.bilinear_resize_mxu_batch``: (B, H, W, 3) → (B, out_h,
    out_w, 3) float32, cv2 half-pixel centres, edge clamp."""
    _check_fast(fast)
    if images.device.type == "cpu":
        return warp_mxu.bilinear_resize_mxu_batch(images, out_h, out_w, fast)
    b, h, w, _ = images.shape
    ypos, xpos = _resize_tables(h, w, out_h, out_w, images.device)
    return _launch(images, b, out_h, out_w, fast, (h, w), ypos=ypos, xpos=xpos)


def align_crop(
    frames: torch.Tensor, landmarks: torch.Tensor, out_size: int = 112, fast: bool = False
) -> torch.Tensor:
    """Every slot warped from its whole frame: frames (B, H, W, 3),
    landmarks (B, M, 5, 2) → (B·M, out_size, out_size, 3), slot-major per
    frame. The plain version repeats each frame M times and takes
    ``align_crop_mxu_batch``; the kernel reads frame s // M for slot s."""
    _check_fast(fast)
    b, m = landmarks.shape[:2]
    lm = landmarks.reshape(b * m, 5, 2)
    if frames.device.type == "cpu":
        rep = frames if m == 1 else frames.repeat_interleave(m, 0)
        return warp_mxu.align_crop_mxu_batch(rep, lm, out_size, fast)
    _, h, w, _ = frames.shape
    ms = warp_mxu.align_matrices(lm, out_size)
    frame_of = torch.arange(b, device=frames.device).repeat_interleave(m)
    origin = torch.zeros((b * m, 2), dtype=torch.int64, device=frames.device)
    return _slots(frames, ms, origin, frame_of, (h, w), out_size, out_size, fast)


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
        return warp_mxu.align_crop_mxu_window(frames, landmarks, out_size, window, fast)
    b, h, w, _ = frames.shape
    m = landmarks.shape[1]
    ms_c, origin, win = warp_mxu.window_slots(landmarks, h, w, out_size, window)
    frame_of = torch.arange(b, device=frames.device).repeat_interleave(m)
    return _slots(frames, ms_c, origin, frame_of, (win, win), out_size, out_size, fast)

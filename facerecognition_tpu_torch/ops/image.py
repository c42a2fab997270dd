"""Image ops of the serving path: cv2-convention resizes and normalize.

Counterpart of ``facerecognition_tpu/ops/image.py``. Layout stays channel
last (HWC / NHWC) at the public functions, as in the JAX package.
"""

from __future__ import annotations

import torch


def bilinear_resize(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres and edge clamp (cv2.INTER_LINEAR).

    No antialiasing on downscale, as OpenCV. Takes HW, HWC or NHWC input and
    returns float32.
    """
    img = image.float()
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    batched = img.ndim == 4
    if not batched:
        img = img[None]
    h, w = img.shape[1], img.shape[2]
    dev = img.device
    ys = (torch.arange(out_h, device=dev, dtype=torch.float32) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, device=dev, dtype=torch.float32) + 0.5) * (w / out_w) - 0.5
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0f)[None, :, None, None]
    wx = (xs - x0f)[None, None, :, None]
    y0, x0 = y0f.long(), x0f.long()
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    top, bot = img[:, y0c], img[:, y1c]
    top = top[:, :, x0c] * (1.0 - wx) + top[:, :, x1c] * wx
    bot = bot[:, :, x0c] * (1.0 - wx) + bot[:, :, x1c] * wx
    out = top * (1.0 - wy) + bot * wy
    if not batched:
        out = out[0]
    return out[..., 0] if squeeze else out


#: OpenCV's fixed-point resize coefficients: weights in units of 2^-11
#: (``INTER_RESIZE_COEF_BITS``).
RESIZE_COEF_BITS = 11


def _cv2_taps(n_src: int, n_dst: int) -> tuple[torch.Tensor, torch.Tensor]:
    """First source tap and its fraction per destination index, as OpenCV
    computes them: ``(d + 0.5) * scale - 0.5`` in double, cast to float32,
    then floor and the float32 remainder."""
    scale = 1.0 / (n_dst / n_src)
    f = ((torch.arange(n_dst, dtype=torch.float64) + 0.5) * scale - 0.5).float()
    s = torch.floor(f)
    return s.long(), f - s


def _cv2_coefs(frac: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - f, f) in units of 2^-11, rounded half to even (``cvRound``)."""
    one = float(1 << RESIZE_COEF_BITS)
    return (
        torch.round((1.0 - frac) * one).int(),
        torch.round(frac * one).int(),
    )


def bilinear_resize_u8(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(image, (out_w, out_h), interpolation=cv2.INTER_LINEAR)``
    on a uint8 (H, W, C) image, bit for bit: OpenCV's fixed-point arithmetic
    (11-bit weights, a horizontal pass in int32, then the vertical pass as
    its SIMD code rounds it: ``((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >>
    16)``, plus 2, shifted right by 2). At the left and right edges the
    source column is clamped and its fraction set to 0; rows are clamped.
    Returns uint8 (out_h, out_w, C).
    """
    if image.dtype != torch.uint8 or image.ndim != 3:
        raise ValueError(f"expected a uint8 (H, W, C) image, got {image.dtype} {tuple(image.shape)}")
    h, w, _ = image.shape
    sx, fx = _cv2_taps(w, out_w)
    lo, hi = sx < 0, sx >= w - 1
    fx = torch.where(lo | hi, torch.zeros_like(fx), fx)
    sx = sx.clamp(0, w - 1)
    a0, a1 = _cv2_coefs(fx)
    sy, fy = _cv2_taps(h, out_h)
    b0, b1 = _cv2_coefs(fy)
    src = image.int()
    rows = src[:, sx] * a0[None, :, None] + src[:, (sx + 1).clamp(max=w - 1)] * a1[None, :, None]
    r0 = rows[sy.clamp(0, h - 1)] >> 4
    r1 = rows[(sy + 1).clamp(0, h - 1)] >> 4
    v = ((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def normalize_imagenet_style(
    image: torch.Tensor, mean: float = 0.5, std: float = 0.5
) -> torch.Tensor:
    """[0, 255] image → float in [-1, 1]: ``(x / 255 - mean) / std``."""
    x = image.float() / 255.0
    return (x - mean) / std

"""Image ops of the one-face path: cv2-convention resize and normalize.

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


def normalize_imagenet_style(
    image: torch.Tensor, mean: float = 0.5, std: float = 0.5
) -> torch.Tensor:
    """[0, 255] image → float in [-1, 1]: ``(x / 255 - mean) / std``."""
    x = image.float() / 255.0
    return (x - mean) / std

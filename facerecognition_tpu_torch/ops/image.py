"""Image ops: cv2-convention resizes, the exact gather warp, crops, color.

Counterpart of ``facerecognition_tpu/ops/image.py``. Layout stays channel
last (HWC / NHWC) at the public functions, as in the JAX package. The
staged API aligns faces with the exact gather warp here (``align_crop``);
the fused serving path takes the two-pass function of ``ops.warp_mxu``
(its kernel is ``ops.warp_sample``).
"""

from __future__ import annotations

import torch

from facerecognition_tpu_torch.ops.umeyama import (
    ARCFACE_TEMPLATE,
    fma,
    invert_affine,
    umeyama,
    umeyama_batch,
)


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


def _gather_bilinear(
    img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, mode: str = "constant"
) -> torch.Tensor:
    """Sample ``img`` (H, W, C) at float positions ``xs``/``ys`` (out_h,
    out_w) by bilinear interpolation; a batch (N, H, W, C) at (N, out_h,
    out_w) positions, image n at positions n. ``mode``: ``"constant"`` (taps
    outside the image read 0, cv2.BORDER_CONSTANT) or ``"edge"`` (clamped,
    cv2.BORDER_REPLICATE)."""
    h, w = img.shape[-3], img.shape[-2]
    batch = () if img.ndim == 3 else (torch.arange(img.shape[0], device=img.device)[:, None, None],)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        vals = img[batch + (yi.clamp(0, h - 1), xi.clamp(0, w - 1))]
        if mode == "edge":
            return vals
        valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))[..., None]
        return torch.where(valid, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))

    top = tap(y0i, x0i) * (1.0 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1.0 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1.0 - wy) + bot * wy


def affine_warp(image: torch.Tensor, m: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Warp ``image`` (H, W, C) by the forward affine ``m`` (2, 3) into
    (out_h, out_w, C), as ``cv2.warpAffine`` with INTER_LINEAR and a zero
    border: output pixel (x, y) samples the input at ``m^-1 (x, y)``. The
    sample positions are ``m00 x + m01 y + m02`` with the first product and
    the second fused into one rounding, as XLA on the CPU contracts them.
    A batch (N, H, W, C) with (N, 2, 3) maps warps image n by map n."""
    img = image.float()
    minv = invert_affine(m.float())[..., None, None]
    dev = img.device
    ys = torch.arange(out_h, device=dev, dtype=torch.float32)[:, None].expand(out_h, out_w)
    xs = torch.arange(out_w, device=dev, dtype=torch.float32)[None, :].expand(out_h, out_w)
    src_x = fma(minv[..., 0, 0, :, :], xs, minv[..., 0, 1, :, :] * ys) + minv[..., 0, 2, :, :]
    src_y = fma(minv[..., 1, 0, :, :], xs, minv[..., 1, 1, :, :] * ys) + minv[..., 1, 2, :, :]
    return _gather_bilinear(img, src_x, src_y)


def align_crop(image: torch.Tensor, landmarks: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """5-point alignment of one face: the Umeyama similarity from
    ``landmarks`` (5, 2) in (x, y) pixels onto the ArcFace template scaled
    to ``out_size``, then the exact gather warp."""
    template = torch.as_tensor(ARCFACE_TEMPLATE, device=image.device) * (out_size / 112.0)
    m = umeyama(landmarks.float(), template)
    return affine_warp(image, m, out_size, out_size)


def align_crop_batch(images: torch.Tensor, landmarks: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """``align_crop`` of every image at once (JAX's ``vmap``): images (N, H,
    W, C), landmarks (N, 5, 2) → (N, out_size, out_size, C) float32."""
    template = torch.as_tensor(ARCFACE_TEMPLATE, device=images.device) * (out_size / 112.0)
    ms = umeyama_batch(landmarks.float(), template)
    return affine_warp(images, ms, out_size, out_size)


def crop_with_margin(
    image: torch.Tensor, bbox: torch.Tensor, margin: float = 0.2, target_size: int = 112
) -> torch.Tensor:
    """Crop ``bbox`` [x1, y1, x2, y2] with a relative ``margin`` on each side
    and resize it to ``target_size``², out-of-image area zero: an affine warp
    with cv2.resize's half-pixel sample centres."""
    bbox = bbox.float()
    x1, y1, x2, y2 = bbox[0], bbox[1], bbox[2], bbox[3]
    bw, bh = x2 - x1, y2 - y1
    mx, my = bw * margin, bh * margin
    cx1, cy1 = x1 - mx, y1 - my
    cw, ch = bw + 2.0 * mx, bh + 2.0 * my
    sx = target_size / torch.clamp(cw, min=1e-6)
    sy = target_size / torch.clamp(ch, min=1e-6)
    zero = torch.zeros_like(sx)
    m = torch.stack([
        torch.stack([sx, zero, -cx1 * sx + 0.5 * sx - 0.5]),
        torch.stack([zero, sy, -cy1 * sy + 0.5 * sy - 0.5]),
    ])
    return affine_warp(image, m, target_size, target_size)


def rgb_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (the weights of ``cv2.COLOR_RGB2GRAY``)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=image.device)
    return image.float() @ w


def normalize_imagenet_style(
    image: torch.Tensor, mean: float = 0.5, std: float = 0.5
) -> torch.Tensor:
    """[0, 255] image → float in [-1, 1]: ``(x / 255 - mean) / std``."""
    x = image.float() / 255.0
    return (x - mean) / std

"""Two-pass separable affine warp and resize as interpolation-matrix products.

Counterpart of ``facerecognition_tpu/ops/warp_mxu.py`` (XLA einsums there,
not Pallas). A vertical 1-D resample followed by a horizontal one, each a
dense interpolation-matrix product (Catmull & Smith 1980); see the JAX
module for the derivation. These are the plain versions of the
``warp_sample`` kernel (``ops/warp_sample.py``), which computes the same
function by sampling four source pixels per output pixel, and computes the
per-slot coefficients, resize positions and crop windows below itself, in
the same order of operations (products and sums written out, no matrix
product or reduction whose order a library picks).

``fast=True`` mirrors JAX's bf16 operands with float32 results: operands
are rounded to bf16 and multiplied in float32 (TF32 off), which gives the
same products, since a product of two bf16 values is exact in float32.

``fast="int8"`` is JAX's integer mode of the warp: weights ``round(w·127)``,
pixels ``clip(round(p), 0, 255) − 128``, int32 sums; pass 1 gives ``acc +
128·Σwq`` (127 times the mid pixel), divided by 127 in float32 (XLA's
product with float32(1/127)), rounded half to even, clipped to [0, 255] and re-centred; pass 2 ends with ``(acc2 +
128·Σwq) / 127``. Every sum is an integer below 2^24, so it is exact in any
order; the sums run in float64 here (integer matrix products have no CUDA
kernel in PyTorch). The resize takes ``"int8"`` as JAX's does: a true value,
its bf16 path.
"""

from __future__ import annotations

import torch

from facerecognition_tpu_torch.ops.umeyama import (
    ARCFACE_TEMPLATE,
    fma,
    invert_affine,
    umeyama_batch,
)

#: The warp's modes: float32, bf16 operands (``True``) and int8 operands.
FAST_MODES = (False, True, "int8")


def check_fast(fast) -> None:
    """``fast`` must be one of ``FAST_MODES``."""
    if fast not in FAST_MODES:
        raise ValueError(f"fast must be False, True or 'int8', got {fast!r}")


def div127(x: torch.Tensor) -> torch.Tensor:
    """``x / 127.0`` in float32 as XLA computes it: a product with the
    float32 reciprocal of 127 (both devices multiply by the same tensor)."""
    return x * torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _interp_weights(positions: torch.Tensor, n_src: int) -> torch.Tensor:
    """Linear-interpolation weights: (..., P) positions → (..., P, n_src).

    At most two nonzeros per row; a position outside [-1, n_src] gets zero
    weight (constant-black border, cv2.BORDER_CONSTANT).
    """
    y = torch.arange(n_src, device=positions.device, dtype=torch.float32)
    w = torch.clamp(1.0 - (positions[..., None] - y).abs(), min=0.0)
    inside = (positions >= -1.0 + 1e-6) & (positions <= n_src - 1e-6)
    return w * inside[..., None].float()


def inside_bounds(n_src: int) -> tuple[float, float]:
    """The float32 bounds ``_interp_weights`` holds positions to, as the
    float32 values the comparisons use."""
    return (
        float(torch.tensor(-1.0 + 1e-6, dtype=torch.float32)),
        float(torch.tensor(n_src - 1e-6, dtype=torch.float32)),
    )


def warp_coefficients(minv: torch.Tensor) -> torch.Tensor:
    """(k, 2, 3) inverse maps → (k, 6) float32 ``m00, m01, m02, aa, bb, cc``:
    pass 2 samples column ``x_s = m00 j + m01 i + m02``, pass 1 samples
    column x at row ``Y = aa i + bb x + cc``."""
    m00, m01, m02 = minv[:, 0, 0], minv[:, 0, 1], minv[:, 0, 2]
    m10, m11, m12 = minv[:, 1, 0], minv[:, 1, 1], minv[:, 1, 2]
    # Rotations of 90° or more are unsupported; keep m00 away from 0 with
    # its sign so the shear coefficient stays finite.
    tiny = torch.where(m00 < 0, -1e-6, 1e-6)
    m00_safe = torch.where(m00.abs() < 1e-6, tiny, m00)
    bb = m10 / m00_safe
    # XLA fuses these products and sums into FMAs; rounding twice instead
    # moves a sample position by an ulp, which can flip a bf16 weight.
    aa = fma(-bb, m01, m11)
    cc = fma(-bb, m02, m12)
    return torch.stack([m00, m01, m02, aa, bb, cc], 1).float()


def _warp_from_inverse(
    imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int, fast: bool
) -> torch.Tensor:
    """Warp (k, H, W, C) images by (k, 2, 3) inverse (output → source) maps."""
    _, h, w, _ = imgs.shape
    dev = imgs.device
    m00, m01, m02, aa, bb, cc = warp_coefficients(minv).unbind(1)

    ii = torch.arange(out_h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    jj = torch.arange(out_w, device=dev, dtype=torch.float32)[None, :]
    # Pass 1 sampling positions Y (k, out_h, W); pass 2 x_s (k, out_h, out_w).
    ypos = fma(aa[:, None, None], ii, bb[:, None, None] * xx) + cc[:, None, None]
    wy = _interp_weights(ypos.transpose(1, 2), h)  # (k, W, out_h, H)
    xpos = fma(m00[:, None, None], jj, m01[:, None, None] * ii) + m02[:, None, None]
    wx = _interp_weights(xpos, w)  # (k, out_h, out_w, W)
    if fast == "int8":
        return _int8_passes(imgs, wy, wx)
    if fast:
        wy, wx, imgs = _bf16_round(wy), _bf16_round(wx), _bf16_round(imgs)
    mid = torch.einsum("kxiy,kyxc->kxic", wy, imgs)  # (k, W, out_h, C)
    if fast:
        mid = _bf16_round(mid)
    return torch.einsum("kijx,kxic->kijc", wx, mid)  # (k, out_h, out_w, C)


def _int8_passes(imgs: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """JAX's ``fast="int8"`` passes on the float weights ``wy`` (k, W, out_h,
    H) and ``wx`` (k, out_h, out_w, W): integer sums held in float64."""
    wyq = torch.round(wy * 127.0).double()
    wxq = torch.round(wx * 127.0).double()
    pc = torch.clamp(torch.round(imgs), 0.0, 255.0).double() - 128.0
    acc = torch.einsum("kxiy,kyxc->kxic", wyq, pc)
    mid127 = acc + 128.0 * wyq.sum(-1)[..., None]  # 127 x the mid pixel
    midc = torch.clamp(torch.round(div127(mid127.float())), 0.0, 255.0).double() - 128.0
    acc2 = torch.einsum("kijx,kxic->kijc", wxq, midc)
    return div127((acc2 + 128.0 * wxq.sum(-1)[..., None]).float())


def affine_warp_mxu_batch(
    images: torch.Tensor,
    ms: torch.Tensor,
    out_h: int,
    out_w: int,
    chunk: int = 16,
    fast: bool = False,
) -> torch.Tensor:
    """Batched affine warp by two interpolation-matrix products.

    Args:
      images: (B, H, W, C) frames, [0, 255].
      ms: (B, 2, 3) forward affine matrices (cv2.warpAffine convention).
      out_h, out_w: output size.
      chunk: images per step, bounding the (chunk, W, out_h, H) weights.
      fast: False (float32), True (bf16 operands with float32 products and
        sums) or "int8" (int8 operands, integer sums; see the module).

    Returns:
      (B, out_h, out_w, C) float32.
    """
    check_fast(fast)
    images = images.float()
    minv = invert_affine(ms.float())
    return torch.cat(
        [
            _warp_from_inverse(
                images[i : i + chunk], minv[i : i + chunk], out_h, out_w, fast
            )
            for i in range(0, images.shape[0], chunk)
        ]
    )


def resize_positions(n_src: int, n_dst: int, device) -> torch.Tensor:
    """Source positions of a resize (cv2 half-pixel centres), clamped to the
    edge pixels: (n_dst,) float32."""
    pos = (torch.arange(n_dst, device=device, dtype=torch.float32) + 0.5) * (n_src / n_dst) - 0.5
    return pos.clamp(0.0, n_src - 1.0)


def bilinear_resize_mxu_batch(
    images: torch.Tensor, out_h: int, out_w: int, fast: bool = False
) -> torch.Tensor:
    """Batched bilinear resize (cv2 half-pixel centres, edge clamp) as two
    shared-weight products. (B, H, W, C) → (B, out_h, out_w, C) float32.
    ``fast="int8"`` is a true value here, as in JAX: the bf16 path."""
    check_fast(fast)
    fast = bool(fast)
    _, h, w, _ = images.shape
    img = images.float()
    dev = img.device
    wy = _interp_weights(resize_positions(h, out_h, dev), h)  # (out_h, H)
    wx = _interp_weights(resize_positions(w, out_w, dev), w)  # (out_w, W)
    if fast:
        wy, wx, img = _bf16_round(wy), _bf16_round(wx), _bf16_round(img)
    mid = torch.einsum("iy,byxc->bixc", wy, img)
    if fast:
        mid = _bf16_round(mid)
    return torch.einsum("jx,bixc->bijc", wx, mid)


def align_matrices(landmarks: torch.Tensor, out_size: int) -> torch.Tensor:
    """(k, 5, 2) landmarks → (k, 2, 3) similarity maps onto the ArcFace
    template scaled to ``out_size``."""
    template = torch.as_tensor(ARCFACE_TEMPLATE, device=landmarks.device) * (
        out_size / 112.0
    )
    return umeyama_batch(landmarks.float(), template)


def align_crop_mxu_batch(
    images: torch.Tensor,
    landmarks: torch.Tensor,
    out_size: int = 112,
    fast: bool = False,
) -> torch.Tensor:
    """5-point alignment of each image onto the ArcFace template.

    images (B, H, W, C), landmarks (B, 5, 2) → (B, out_size, out_size, C).
    """
    ms = align_matrices(landmarks, out_size)
    return affine_warp_mxu_batch(images, ms, out_size, out_size, 32, fast)


def window_origin(
    ms: torch.Tensor, h: int, w: int, out_size: int, win: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slot's crop window from its (k, 2, 3) map onto the template:
    the (k, 2) int64 window origins (x0, y0) and the (k, 2, 3) maps from the
    crop. The window is centred on the inverse image of the output centre,
    rounded half to even, clamped into the (h, w) frame. The products are
    written out in a fixed order (no matrix product), as the
    ``warp_sample`` kernel's prologue takes them."""
    minv = invert_affine(ms)
    c = (out_size - 1) / 2.0
    half = (win - 1) / 2.0
    # centre of the sampled region: minv @ (c, c, 1)
    cx = minv[:, 0, 0] * c + minv[:, 0, 1] * c + minv[:, 0, 2]
    cy = minv[:, 1, 0] * c + minv[:, 1, 1] * c + minv[:, 1, 2]
    x0 = torch.round(cx - half).long().clamp(0, w - win)
    y0 = torch.round(cy - half).long().clamp(0, h - win)
    # Cropping moves source coordinates by -origin: dst = A src + t becomes
    # dst = A src' + (A origin + t).
    ox, oy = x0.float(), y0.float()
    ms_c = ms.clone()
    ms_c[:, 0, 2] = ms[:, 0, 2] + (ms[:, 0, 0] * ox + ms[:, 0, 1] * oy)
    ms_c[:, 1, 2] = ms[:, 1, 2] + (ms[:, 1, 0] * ox + ms[:, 1, 1] * oy)
    return torch.stack([x0, y0], 1), ms_c


def window_slots(
    landmarks: torch.Tensor, h: int, w: int, out_size: int, window: int
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Each slot's static crop window, for ``align_crop_mxu_window``.

    landmarks (B, M, 5, 2) in frame pixels → (the (B·M, 2, 3) maps from the
    crop onto the template, (B·M, 2) int64 window origins (x0, y0), the
    window side ``min(window, h, w)``); see ``window_origin``.
    """
    b, m = landmarks.shape[:2]
    win = min(window, h, w)
    ms = align_matrices(landmarks.reshape(b * m, 5, 2), out_size)
    origin, ms_c = window_origin(ms, h, w, out_size, win)
    return ms_c, origin, win


def align_crop_mxu_window(
    frames: torch.Tensor,
    landmarks: torch.Tensor,
    out_size: int = 112,
    window: int = 160,
    fast: bool = False,
) -> torch.Tensor:
    """Multi-face alignment: each slot warped from a static ``window``² crop
    of its frame (zero outside the crop), not from the whole frame.

    frames (B, H, W, C), landmarks (B, M, 5, 2) → (B·M, out_size, out_size,
    C) float32, slot-major per frame. Equal to the full-frame warp wherever
    the source sample lies inside the window (see the JAX function).
    """
    b, h, w, _ = frames.shape
    m = landmarks.shape[1]
    ms_c, origin, win = window_slots(landmarks, h, w, out_size, window)
    steps = torch.arange(win, device=frames.device)
    frame_of = torch.arange(b, device=frames.device).repeat_interleave(m)
    ys = (origin[:, 1, None] + steps)[:, :, None]  # (B·M, win, 1)
    xs = (origin[:, 0, None] + steps)[:, None, :]  # (B·M, 1, win)
    crops = frames.float()[frame_of[:, None, None], ys, xs]
    return affine_warp_mxu_batch(crops, ms_c, out_size, out_size, 32, fast)

"""Two-pass separable affine warp and resize as interpolation-matrix products.

Counterpart of ``facerecognition_tpu/ops/warp_mxu.py`` (XLA einsums there,
not Pallas, so plain PyTorch here). A vertical 1-D resample followed by a
horizontal one, each a dense interpolation-matrix product (Catmull & Smith
1980); see the JAX module for the derivation. On the card this runs as
batched cuBLAS products; a direct-sampling kernel is a later step.

``fast=True`` mirrors JAX's bf16 operands with float32 results: operands
are rounded to bf16 and multiplied in float32 (TF32 off), which gives the
same products, since a product of two bf16 values is exact in float32.
"""

from __future__ import annotations

import torch

from facerecognition_tpu_torch.ops.umeyama import (
    ARCFACE_TEMPLATE,
    fma,
    invert_affine,
    umeyama_batch,
)


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


def _warp_from_inverse(
    imgs: torch.Tensor, minv: torch.Tensor, out_h: int, out_w: int, fast: bool
) -> torch.Tensor:
    """Warp (k, H, W, C) images by (k, 2, 3) inverse (output → source) maps."""
    _, h, w, _ = imgs.shape
    dev = imgs.device
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

    ii = torch.arange(out_h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    jj = torch.arange(out_w, device=dev, dtype=torch.float32)[None, :]
    # Pass 1 sampling positions Y (k, out_h, W); pass 2 x_s (k, out_h, out_w).
    ypos = fma(aa[:, None, None], ii, bb[:, None, None] * xx) + cc[:, None, None]
    wy = _interp_weights(ypos.transpose(1, 2), h)  # (k, W, out_h, H)
    xpos = fma(m00[:, None, None], jj, m01[:, None, None] * ii) + m02[:, None, None]
    wx = _interp_weights(xpos, w)  # (k, out_h, out_w, W)
    if fast:
        wy, wx, imgs = _bf16_round(wy), _bf16_round(wx), _bf16_round(imgs)
    mid = torch.einsum("kxiy,kyxc->kxic", wy, imgs)  # (k, W, out_h, C)
    if fast:
        mid = _bf16_round(mid)
    return torch.einsum("kijx,kxic->kijc", wx, mid)  # (k, out_h, out_w, C)


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
      fast: bf16 operands with float32 products and sums.

    Returns:
      (B, out_h, out_w, C) float32.
    """
    if fast not in (True, False):
        raise NotImplementedError(
            "only fast=False/True are ported; the int8 warp mode waits for "
            "the crowd path (ROADMAP Queue 1)"
        )
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


def bilinear_resize_mxu_batch(
    images: torch.Tensor, out_h: int, out_w: int, fast: bool = False
) -> torch.Tensor:
    """Batched bilinear resize (cv2 half-pixel centres, edge clamp) as two
    shared-weight products. (B, H, W, C) → (B, out_h, out_w, C) float32."""
    _, h, w, _ = images.shape
    img = images.float()
    dev = img.device
    ypos = (torch.arange(out_h, device=dev, dtype=torch.float32) + 0.5) * (h / out_h) - 0.5
    xpos = (torch.arange(out_w, device=dev, dtype=torch.float32) + 0.5) * (w / out_w) - 0.5
    wy = _interp_weights(ypos.clamp(0.0, h - 1.0), h)  # (out_h, H)
    wx = _interp_weights(xpos.clamp(0.0, w - 1.0), w)  # (out_w, W)
    if fast:
        wy, wx, img = _bf16_round(wy), _bf16_round(wx), _bf16_round(img)
    mid = torch.einsum("iy,byxc->bixc", wy, img)
    if fast:
        mid = _bf16_round(mid)
    return torch.einsum("jx,bixc->bijc", wx, mid)


def align_crop_mxu_batch(
    images: torch.Tensor,
    landmarks: torch.Tensor,
    out_size: int = 112,
    fast: bool = False,
) -> torch.Tensor:
    """5-point alignment of each image onto the ArcFace template.

    images (B, H, W, C), landmarks (B, 5, 2) → (B, out_size, out_size, C).
    """
    template = torch.as_tensor(ARCFACE_TEMPLATE, device=images.device) * (
        out_size / 112.0
    )
    ms = umeyama_batch(landmarks.float(), template)
    return affine_warp_mxu_batch(images, ms, out_size, out_size, 32, fast)

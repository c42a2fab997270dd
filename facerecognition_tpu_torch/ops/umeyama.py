"""Closed-form Umeyama similarity transform, batched, in float32.

Counterpart of ``facerecognition_tpu/ops/umeyama.py``. The JAX function
takes a 2x2 SVD of the point-set covariance; for 2-D points the optimal
rotation and scale have a closed form, which avoids ``torch.linalg.svd``
(cuSOLVER on the card, slow for tiny batches):

with ``M = cov = [[a, b], [c, d]]``, ``r = hypot(a + d, c - b)``, the best
proper rotation has ``cos = (a + d) / r`` and ``sin = (c - b) / r``, and
``r = s1 + sign(det M) s2`` is the SVD's ``sum(s * d)``. ``M = 0`` (all
points coincident) gives scale 0, as the SVD path does.
"""

from __future__ import annotations

import numpy as np
import torch

# Canonical 112x112 ArcFace landmark template:
# left eye, right eye, nose, left mouth corner, right mouth corner.
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on every device. On the card PyTorch
    divides by a Python number as a product with its float32 reciprocal,
    which can round otherwise; a tensor divisor is divided by."""
    return x / torch.full_like(x, d)


def sum_left(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, left to right: ``(x0 + x1) + x2 + ...``. A
    reduction kernel picks its own order; this one is fixed, so the
    ``warp_sample`` kernel's prologue can repeat it."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


def umeyama_batch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity transforms mapping ``src`` onto ``dst``.

    Every sum over the points is taken left to right and divided by their
    count (``sum_left``, ``true_div``), so the result is the same bits on
    the CPU, on the card and in ``csrc/warp_sample.cu``'s prologue.

    Args:
      src: (B, N, 2) source landmarks.
      dst: (N, 2) or (B, N, 2) destination landmarks.

    Returns:
      (B, 2, 3) float32 ``M`` with ``dst ≈ src @ M[:, :, :2].T + M[:, :, 2]``.
    """
    src = src.float()
    dst = dst.to(src).expand_as(src)
    n = src.shape[-2]
    sx, sy = src[..., 0], src[..., 1]
    dx, dy = dst[..., 0], dst[..., 1]
    mu_sx, mu_sy = true_div(sum_left(sx), n), true_div(sum_left(sy), n)
    mu_dx, mu_dy = true_div(sum_left(dx), n), true_div(sum_left(dy), n)
    scx, scy = sx - mu_sx[..., None], sy - mu_sy[..., None]
    dcx, dcy = dx - mu_dx[..., None], dy - mu_dy[..., None]
    # cov[i, j] = mean over points of dst_c[:, i] * src_c[:, j]
    a = true_div(sum_left(dcx * scx), n)
    b = true_div(sum_left(dcx * scy), n)
    c = true_div(sum_left(dcy * scx), n)
    d = true_div(sum_left(dcy * scy), n)
    cs, sn = a + d, c - b
    # A correctly rounded square root on every device: PyTorch's float32
    # sqrt on the CPU can be an ulp off; rounding a float64 root to float32
    # cannot (an error below a float64 ulp never crosses a float32 midpoint).
    r = torch.sqrt((cs * cs + sn * sn).double()).float()
    degenerate = r == 0
    safe_r = torch.where(degenerate, torch.ones_like(r), r)
    cos = torch.where(degenerate, torch.ones_like(r), cs / safe_r)
    sin = torch.where(degenerate, torch.zeros_like(r), sn / safe_r)
    var_src = true_div(sum_left(scx * scx + scy * scy), n)
    scale = r / torch.clamp(var_src, min=1e-12)
    l00, l01 = scale * cos, scale * -sin
    l10, l11 = scale * sin, scale * cos
    t0 = mu_dx - (l00 * mu_sx + l01 * mu_sy)
    t1 = mu_dy - (l10 * mu_sx + l11 * mu_sy)
    return torch.stack(
        [torch.stack([l00, l01, t0], -1), torch.stack([l10, l11, t1], -1)], -2
    )


def umeyama(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """One (N, 2) point set → its (2, 3) similarity transform."""
    return umeyama_batch(src[None], dst)[0]


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add (the
    float32 product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert (..., 2, 3) affine matrices.

    Singularity guard as in the JAX function: a linear part with
    ``|det| <= 1e-8`` (degenerate landmarks) is replaced by the identity so
    the pipeline stays finite. The 2x2 inverse is the LU solve that
    ``jnp.linalg.inv`` runs (partial pivoting, pivots applied as
    reciprocals, fused multiply-adds where XLA fuses them), so it rounds as
    the reference does; warp positions, and bf16 weights, then agree.
    """
    m = m.float()
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    ok = (a * d - b * c).abs() > 1e-8
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    a, b = torch.where(ok, a, one), torch.where(ok, b, zero)
    c, d = torch.where(ok, c, zero), torch.where(ok, d, one)
    swap = c.abs() > a.abs()
    p00, p01 = torch.where(swap, c, a), torch.where(swap, d, b)
    p10, p11 = torch.where(swap, a, c), torch.where(swap, b, d)
    r00 = 1.0 / p00
    low = p10 * r00  # L = [[1, 0], [low, 1]]
    r11 = 1.0 / (p11 - low * p01)  # U = [[p00, p01], [0, p11 - low * p01]]
    # Column j solves L U x = P e_j: y = (1, -low) or (0, 1), then x1 = y1 / u11
    # and x0 = (y0 - p01 x1) / u00.
    x1_low = -low * r11
    x1_c0 = torch.where(swap, r11, x1_low)
    x1_c1 = torch.where(swap, x1_low, r11)
    from_one = lambda x1: fma(-p01, x1, one) * r00  # noqa: E731
    from_zero = lambda x1: (-p01 * x1) * r00  # noqa: E731
    x0_c0 = torch.where(swap, from_zero(x1_c0), from_one(x1_c0))
    x0_c1 = torch.where(swap, from_one(x1_c1), from_zero(x1_c1))
    ia, ib, ic, id_ = x0_c0, x0_c1, x1_c0, x1_c1
    itx = -fma(ib, ty, ia * tx)
    ity = -fma(id_, ty, ic * tx)
    return torch.stack(
        [torch.stack([ia, ib, itx], -1), torch.stack([ic, id_, ity], -1)], -2
    )

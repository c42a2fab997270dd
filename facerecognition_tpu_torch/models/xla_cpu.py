"""16-bit training on the CPU with the JAX package's arithmetic.

The JAX package trains a model built with ``dtype=bfloat16`` or ``float16``
through XLA's jitted CPU graph of the flax model and its VJP. A 16-bit
gradient moves by an ulp where one cotangent element rounds the other way,
and a convolution's reductions spread that ulp over every output it feeds,
so the port's CPU path computes the graph's own operations, in its order:

- Roundings. flax's ``nn.Conv(dtype=...)`` rounds its input, kernel and
  output, and each promotion of a 16-bit value to float32 is a convert whose
  transpose rounds the cotangent. XLA computes a 16-bit operation in float32
  and rounds its result; in bfloat16 it drops a rounding that only a float32
  convert reads (a convolution's float32 ``dx`` and ``dW``, a bias-free
  convolution's output read by a batch norm), in float16 it keeps them.
- Reductions. A sum over the rows of an NHWC array (the batch-norm
  statistics and their cotangents, sums of products too) accumulates
  sequentially in float32, row after row; a bfloat16 sum (a bias's
  gradient) rounds at every step.
- The batch norm (``HalfBatchNorm``): flax's ``_compute_stats`` and
  ``_normalize`` with ``use_fast_variance``, whose backward rounds the
  statistics' and the normalisation's cotangents each to the input's dtype
  and rounds their sum again (data-parallel ranks: ``layers.GlobalBatchNorm``
  with ``half``).

On the card none of this applies: cuDNN computes the convolutions and the
batch norms in the dtype with float32 accumulation, and rounds where its
kernels round (``models/layers.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def round_to(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and widened back to float32."""
    return t.to(dtype).float()


def _rows(t: torch.Tensor) -> np.ndarray:
    """(N, C, ...) → (N·..., C) float32 rows in NHWC order."""
    return np.ascontiguousarray(t.detach().movedim(1, -1).reshape(-1, t.shape[1]).numpy())


def _row_sum(rows: np.ndarray) -> torch.Tensor:
    """float32 column sums of (R, C) rows, accumulated row after row: numpy
    reduces over the strided axis that way (its pairwise summation runs
    only along the contiguous axis), and over a single column, which is
    contiguous, ``cumsum`` does."""
    if rows.shape[1] == 1:
        return torch.from_numpy(np.cumsum(rows, axis=0, dtype=np.float32)[-1])
    return torch.from_numpy(np.add.reduce(rows, axis=0, dtype=np.float32))


def channel_sum(t: torch.Tensor) -> torch.Tensor:
    """Per channel (dim 1) float32 sum, accumulated row after row."""
    return _row_sum(_rows(t))


def channel_dots(*pairs) -> list:
    """Per channel sums of ``a * b`` for each ``(a, b)`` of ``pairs``: the
    float32 products accumulated row after row in float32. (XLA fuses each
    step into an fma; the rounded product gives the same 16-bit gradients
    in every block of ``tests/test_torch_train_dtype.py``.)"""
    return [_row_sum(_rows(a) * _rows(b.expand_as(a))) for a, b in pairs]


def channel_sum_rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per channel sum in ``dtype``: in bfloat16 float32 adds, each rounded
    to it (XLA's bits); in float16 the float32 sum rounded once (XLA sums
    in another order, to the same accuracy)."""
    if dtype == torch.float16:
        return round_to(channel_sum(t), dtype)
    rows = torch.from_numpy(_rows(t))
    acc = torch.zeros(rows.shape[1])
    for row in rows:
        acc = round_to(acc + row, dtype)
    return acc


def rsqrt(t: torch.Tensor) -> torch.Tensor:
    """float32 ``1 / sqrt(t)`` correctly rounded (XLA's CPU ``rsqrt``, an
    estimate and two Newton steps, lands within an ulp of it)."""
    return torch.rsqrt(t.double()).float()


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once."""
    return (a.double() * b.double() + c.double()).float()


class RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to ``dtype`` (the
    transpose of a convert from ``dtype`` to float32)."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.dtype), None


class HalfConv(torch.autograd.Function):
    """A 16-bit convolution, forward and back.

    Forward: a float32 convolution of the rounded input and kernel, the
    output rounded, plus the rounded bias, rounded again; with
    ``float_out`` (bfloat16) the last rounding is dropped and the output is
    float32. Backward: the output's cotangent rounded, then float32
    convolutions of it against the rounded kernel (``dx``) and input
    (``dW``), rounded in float16 and kept float32 in bfloat16; the bias's
    gradient is the cotangent's sum in the dtype (``channel_sum_rounded``)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dtype, stride, padding, dilation, groups, float_out):
        xr, wr = round_to(x, dtype), round_to(weight, dtype)
        y = F.conv2d(xr, wr, None, stride, padding, dilation, groups)
        if bias is not None:
            y = round_to(y, dtype) + round_to(bias, dtype).view(1, -1, 1, 1)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (dtype, stride, padding, dilation, groups, bias is not None)
        return y if float_out else y.to(dtype)

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dtype, stride, padding, dilation, groups, has_bias = ctx.conf
        dy = round_to(dy, dtype)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, xr, wr, None, stride, padding, dilation, False, [0, 0], groups,
            (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        if dtype == torch.float16:
            dx = None if dx is None else round_to(dx, dtype)
            dw = None if dw is None else round_to(dw, dtype)
        db = channel_sum_rounded(dy, dtype) if has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None, None, None, None


def _bn_forward(x, scale, bias, eps: float):
    """flax's training-mode batch norm of ``x`` as XLA computes it: ``(y,
    mean, var, saved)``."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    inv = torch.tensor(1.0 / (x.numel() // x.shape[1]), dtype=torch.float32)
    s1 = channel_sum(x)
    mean, mean2 = s1 * inv, channel_dots((x, x))[0] * inv
    gap = mean2 - mean * mean
    var = torch.clamp(gap, min=0.0)
    rstd = rsqrt(var + eps)
    y = fma(x - mean.view(shape), (rstd * scale).view(shape), bias.view(shape))
    return y, mean, var, (x, scale, s1, mean, var, gap, rstd)


def _bn_backward(saved, dy, eps: float, half: torch.dtype):
    """XLA's graph of ``_bn_forward``'s VJP: ``(dx, dscale, dbias)``, the
    normalisation's and the statistics' cotangents rounded to ``half`` each
    and their sum rounded."""
    x, scale, s1, mean, var, gap, rstd = saved
    shape = [1, -1] + [1] * (x.ndim - 2)
    n = x.numel() // x.shape[1]
    inv = torch.tensor(1.0 / n, dtype=torch.float32)
    two = torch.tensor(2.0 / n, dtype=torch.float32)
    mul = rstd * scale
    d_bias = channel_sum(dy)
    d_mul, d_mean = channel_dots((x - mean.view(shape), dy), (dy, mul.view(shape)))
    # max(gap, 0)'s gradient: 1 above 0, 1/2 at 0, 0 below
    through = torch.where(gap > 0, 1.0, torch.where(gap == 0, 0.5, 0.0))
    d_var = ((d_mul * scale) * ((rstd / (var + eps)) * -0.5)) * through
    d_mean = -d_mean + (-d_var) * (s1 * two)
    stats = fma(x, (d_var * two).view(shape), (d_mean * inv).view(shape))
    dx = round_to(round_to(dy * mul.view(shape), half) + round_to(stats, half), half)
    return dx, rstd * d_mul, d_bias


class HalfBatchNorm(torch.autograd.Function):
    """Training-mode batch norm of a float32 ``x`` that holds 16-bit values
    (``half``): ``(y, mean, var)`` with flax's statistics (``E[x²] -
    E[x]²`` clipped at 0) and output ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``; the backward is XLA's graph of flax's VJP, the two
    uses' cotangents rounded to ``half`` each and their sum rounded."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, half: torch.dtype):
        y, mean, var, saved = _bn_forward(x, scale, bias, eps)
        ctx.save_for_backward(*saved)
        ctx.conf = (eps, half)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        return (*_bn_backward(ctx.saved_tensors, dy, *ctx.conf), None, None)

"""Training-mode layers shared by the port's models, with flax's semantics.

- ``as_compute_dtype`` and ``Conv2d``: the models' compute ``dtype`` (float32,
  bfloat16 or float16) as flax's ``nn.Conv(dtype=...)`` applies it. The
  parameters stay float32; the input, kernel and bias are rounded to the
  dtype, the convolution's output is rounded to it, and the bias add is
  rounded again (on the CPU a bias-free bf16 output stays float32: each is
  read only by a batch norm, and XLA's jitted graph drops that rounding).
  On the CPU the convolution is a float32 one of the rounded operands (XLA's
  CPU bits; PyTorch's own CPU bf16 convolution differs by an ulp here and
  there); on the card it is cuDNN's in the dtype (float32 accumulation).
- ``BatchNorm1d`` / ``BatchNorm2d``: a bfloat16 or float16 input is computed
  in float32 and the output is float32, as flax's with ``dtype=float32``.
  In training mode they normalise the batch by its biased variance, as both
  libraries do, and update the running statistics as flax's ``BatchNorm``
  does (``momentum`` 0.9 on the running value, the variance ``E[x²] -
  E[x]²`` of the batch clipped at 0, biased).
  ``torch.nn.BatchNorm`` would update ``running_var`` with the unbiased
  variance. In evaluation mode they are ``torch.nn.BatchNorm``. A 16-bit
  input on the CPU (``input_dtype``: a bf16 convolution hands its batch
  norm float32) takes flax's arithmetic as XLA's graph computes it, forward
  and back (``models/xla_cpu.py``).
- ``dropout``: flax's ``Dropout`` (keep with probability ``1 - p``, kept
  values divided by ``1 - p``) drawn from an explicit generator.
- ``init_like_flax``: flax's initialisers as distributions (the values
  cannot match: the generators differ): ``lecun_normal`` (a normal truncated
  at two standard deviations) on every convolution and linear weight,
  ``kaiming_normal`` (also truncated) where named, zero biases, unit scales.
- ``global_batch(shard)``: inside it a data-parallel rank computes as one
  process on the whole batch would: the batch norms take their statistics
  over every rank's rows (``GlobalBatchNorm``: the sums all-reduced in the
  forward, the gradient's sums in the backward, accumulated in float64 as
  the CPU's batch norm accumulates them; flax's running-statistics rule
  kept), and ``dropout`` draws the whole batch's mask and keeps this rank's
  rows. ``torch.nn.SyncBatchNorm`` would update ``running_var`` unbiased
  and takes no CPU tensors.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerecognition_tpu_torch.models.xla_cpu import HalfBatchNorm, HalfConv, round_to, rsqrt
from facerecognition_tpu_torch.parallel.collectives import BatchShard, all_reduce_sum

#: The compute dtypes a model takes, by name.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
#: The reduced-precision ones, which the batch norms widen to float32.
HALF_DTYPES = (torch.bfloat16, torch.float16)


def as_compute_dtype(dtype) -> torch.dtype:
    """``torch.float32`` / ``torch.bfloat16`` / ``torch.float16`` or the
    name of one → the torch dtype; anything else raises ``ValueError``."""
    if isinstance(dtype, str) and dtype in COMPUTE_DTYPES:
        return COMPUTE_DTYPES[dtype]
    if isinstance(dtype, torch.dtype) and dtype in COMPUTE_DTYPES.values():
        return dtype
    raise ValueError(f"unknown compute dtype {dtype!r}; have {sorted(COMPUTE_DTYPES)}")


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` as flax's ``nn.Conv(
    dtype=...)`` does (float32: ``nn.Conv2d`` itself). The weights stay in
    their own dtype; the output is in the compute dtype, except on the CPU
    for a bf16 convolution without bias: every one in the models feeds a
    float32 batch norm, and XLA's jitted graph hands that batch norm the
    float32 sum unrounded (its excess precision drops the round trip through
    bf16), so the output is that float32 sum. On the card cuDNN writes it in
    bf16 and the batch norm widens it: one rounding more than the CPU. The
    backward on the CPU rounds as XLA's graph does (``xla_cpu.HalfConv``);
    on the card it is cuDNN's in the dtype with float32 accumulation, which
    rounds the gradients once more."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = as_compute_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        args = (self.stride, self.padding, self.dilation, self.groups)
        if x.device.type == "cpu":  # XLA's bits: float32 sums of the rounded operands
            return HalfConv.apply(x, self.weight, self.bias, dt, *args,
                                  self.bias is None and dt == torch.bfloat16)
        y = F.conv2d(x.to(dt), self.weight.to(dt), None, *args)
        if self.bias is not None:
            y = y + self.bias.to(dt).view(1, -1, 1, 1)
        return y


#: flax's BatchNorm momentum: running = momentum * running + (1 - momentum) * batch.
FLAX_MOMENTUM = 0.9
#: Standard deviation of a standard normal truncated to [-2, 2] (flax's constant).
_TRUNC_STD = 0.87962566103423978


#: The data-parallel shard of the batch in flight (``global_batch``). A
#: process-wide value, not a context variable: a rematerialised forward runs
#: again in the autograd engine's thread of the card.
_shard: Optional[BatchShard] = None


@contextlib.contextmanager
def global_batch(shard: Optional[BatchShard]):
    """Batch norms and dropout inside the block act on the global batch of
    which this rank holds ``shard`` (nothing changes for None or one rank)."""
    global _shard
    prev, _shard = _shard, shard if shard is not None and shard.world > 1 else None
    try:
        yield
    finally:
        _shard = prev


class GlobalBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the rows of every rank: ``(y, mean,
    E[x²])`` of a rank's (N, C, ...) ``x``, with ``n`` elements a channel
    over all ranks. The forward all-reduces each channel's sum and sum of
    squares, then the sum of squared deviations (the biased variance, two
    passes); the backward all-reduces the sums of ``dy`` and ``dy·x̂`` that
    ``dx`` needs. ``weight``'s and ``bias``'s gradients are this rank's sums
    (the step sums gradients over the ranks). Sums accumulate in float64.
    ``half``: the dtype of a 16-bit input on the CPU, whose ``dx`` rounds as
    flax's VJP does (``xla_cpu.HalfBatchNorm``): the normalisation's and the
    statistics' cotangents each to ``half``, then their sum."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, n: int, half: Optional[torch.dtype] = None):
        dims = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        sums = all_reduce_sum(torch.stack([torch.sum(x, dims, dtype=torch.float64),
                                           torch.sum(x * x, dims, dtype=torch.float64)]))
        mean = sums[0] / n
        xc = x - mean.to(x.dtype).view(shape)
        var = all_reduce_sum(torch.sum(xc * xc, dims, dtype=torch.float64)) / n
        invstd = torch.rsqrt(var + eps).to(x.dtype)
        xhat = xc * invstd.view(shape)
        sq = sums[1] / n
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.n, ctx.half = n, half
        ctx.mark_non_differentiable(mean, sq)
        return xhat * weight.view(shape) + bias.view(shape), mean, sq

    @staticmethod
    def backward(ctx, dy, _mean, _sq):
        xhat, invstd, weight = ctx.saved_tensors
        dims = [0] + list(range(2, dy.ndim))
        shape = [1, -1] + [1] * (dy.ndim - 2)
        local = torch.stack([torch.sum(dy, dims, dtype=torch.float64),
                             torch.sum(dy * xhat, dims, dtype=torch.float64)])
        g = all_reduce_sum(local) / ctx.n
        mul = (weight * invstd).view(shape)
        stats = g[0].to(dy.dtype).view(shape) + xhat * g[1].to(dy.dtype).view(shape)
        if ctx.half is None:
            dx = mul * (dy - stats)
        else:
            dx = round_to(round_to(dy * mul, ctx.half) + round_to(-mul * stats, ctx.half), ctx.half)
        return dx, local[1].to(weight.dtype), local[0].to(weight.dtype), None, None, None


class _FlaxTrainStats:
    #: Off while a rematerialised forward runs again in the backward pass, so
    #: each step updates the running statistics once.
    update_stats = True
    def __init__(self, *args, input_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        #: The dtype of the values the batch norm reads (its convolution's
        #: compute dtype): a bf16 convolution on the CPU hands it float32.
        self.input_dtype = as_compute_dtype(input_dtype)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        keep = FLAX_MOMENTUM
        self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
        self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)

    def _global_forward(self, x: torch.Tensor, shard: BatchShard, half) -> torch.Tensor:
        """Training mode over the global batch (``GlobalBatchNorm``)."""
        n = x.numel() // x.shape[1] * shard.world
        y, mean, sq = GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, n, half)
        var = torch.clamp(sq - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                self._update_running(mean.to(x.dtype), var.to(x.dtype))
        return y

    def _flax_normalize(self, x, mean, var) -> torch.Tensor:
        """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
        shape = [1, -1] + [1] * (x.ndim - 2)
        mul = rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.dtype if x.dtype in HALF_DTYPES else self.input_dtype
        if x.dtype in HALF_DTYPES:
            x = x.float()
        # A 16-bit input on the CPU: XLA's graph of flax's BatchNorm, whose
        # backward rounds each use's cotangent to the input's dtype.
        xla = half in HALF_DTYPES and x.device.type == "cpu"
        if not self.training:
            if xla:
                return self._flax_normalize(x, self.running_mean, self.running_var)
            return super().forward(x)
        if _shard is not None:
            return self._global_forward(x, _shard, half if xla else None)
        if xla:
            y, mean, var = HalfBatchNorm.apply(x, self.weight, self.bias, self.eps, half)
            if self.update_stats:
                with torch.no_grad():
                    self._update_running(mean, var)
            return y
        if self.update_stats:
            dims = [0] + list(range(2, x.ndim))
            with torch.no_grad():
                xd = x.detach()
                mean = xd.mean(dims)
                var = torch.clamp((xd * xd).mean(dims) - mean * mean, min=0.0)
                self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm1d(_FlaxTrainStats, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxTrainStats, nn.BatchNorm2d):
    pass


def set_stat_updates(module: nn.Module, on: bool) -> None:
    """Turn the training-mode running-statistics update of every batch norm
    in ``module`` on or off."""
    for m in module.modules():
        if isinstance(m, _FlaxTrainStats):
            m.update_stats = on


def dropout(
    x: torch.Tensor, p: float, training: bool, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """flax ``nn.Dropout(p)``: the identity outside training or at p = 0."""
    if not training or p <= 0.0:
        return x
    keep_prob = 1.0 - p
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    if _shard is not None:  # the global batch's draws, this rank's rows
        draws = torch.rand((_shard.total,) + tuple(x.shape[1:]), generator=generator, device=x.device)
        keep = _shard.take(draws) < keep_prob
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * math.prod(weight.shape[2:])


def truncated_normal_(weight: torch.Tensor, scale: float, generator=None) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    std = math.sqrt(scale / _fan_in(weight)) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_like_flax(
    module: nn.Module,
    generator: Optional[torch.Generator] = None,
    kaiming: Iterable[str] = (),
) -> nn.Module:
    """Re-initialise ``module``'s convolutions, linear layers and batch norms
    as the flax model initialises its counterparts; the linear layers named in
    ``kaiming`` take ``kaiming_normal`` (scale 2). A module with its own
    ``reset_flax`` (the ArcFace margin head) is handed the generator."""
    kaiming = set(kaiming)
    for name, m in module.named_modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            truncated_normal_(m.weight, 2.0 if name in kaiming else 1.0, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
        elif hasattr(m, "reset_flax"):
            m.reset_flax(generator)
    return module

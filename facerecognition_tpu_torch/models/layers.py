"""Training-mode layers shared by the port's models, with flax's semantics.

- ``BatchNorm1d`` / ``BatchNorm2d``: in training mode they normalise the
  batch by its biased variance, as both libraries do, and update the running
  statistics as flax's ``BatchNorm`` does (``momentum`` 0.9 on the running
  value, the variance ``E[x²] - E[x]²`` of the batch clipped at 0, biased).
  ``torch.nn.BatchNorm`` would update ``running_var`` with the unbiased
  variance. In evaluation mode they are ``torch.nn.BatchNorm``.
- ``dropout``: flax's ``Dropout`` (keep with probability ``1 - p``, kept
  values divided by ``1 - p``) drawn from an explicit generator.
- ``init_like_flax``: flax's initialisers as distributions (the values
  cannot match: the generators differ): ``lecun_normal`` (a normal truncated
  at two standard deviations) on every convolution and linear weight,
  ``kaiming_normal`` (also truncated) where named, zero biases, unit scales.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

#: flax's BatchNorm momentum: running = momentum * running + (1 - momentum) * batch.
FLAX_MOMENTUM = 0.9
#: Standard deviation of a standard normal truncated to [-2, 2] (flax's constant).
_TRUNC_STD = 0.87962566103423978


class _FlaxTrainStats:
    #: Off while a rematerialised forward runs again in the backward pass, so
    #: each step updates the running statistics once.
    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.update_stats:
            dims = [0] + list(range(2, x.ndim))
            with torch.no_grad():
                xd = x.detach()
                mean = xd.mean(dims)
                var = torch.clamp((xd * xd).mean(dims) - mean * mean, min=0.0)
                keep = FLAX_MOMENTUM
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
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

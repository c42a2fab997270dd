"""InceptionResnetV1, the FaceNet backbone, inference forward.

Counterpart of ``facerecognition_tpu/models/inception_resnet_v1.py``. Module
names are facenet-pytorch's state-dict keys (``repeat_1.0.branch1.0.conv``,
``mixed_7a.branch0.1``), so a reference torch checkpoint loads as it is and
``convert.flax_module_name`` maps the flax tree onto them by rule. Input is
NHWC, as in the JAX package; concatenations on the channel axis keep NHWC's
order. Convolutions are VALID unless padded explicitly, the pools are VALID
3x3/2 max pools and a mean, and batch norm uses eps 1e-3 (facenet-pytorch's,
not ResNet's 1e-5). Dropout is the identity at inference; in training mode
``dropout`` (0.6) is flax's, drawn from the generator the forward is given,
and the batch norms update their running statistics as flax's do
(``models/layers.py``). ``dtype`` is the convolutions' compute dtype (the
flax field): each ``BasicConv2d``'s batch norm returns float32, a residual
block's ``scale * conv2d(up)`` joins the float32 sum as XLA's jitted graph
computes it (``_residual``), and ``last_linear`` and ``last_bn`` are
float32.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerecognition_tpu_torch.models.layers import (
    BatchNorm1d,
    BatchNorm2d,
    Conv2d,
    as_compute_dtype,
    dropout,
)
from facerecognition_tpu_torch.models.xla_cpu import RoundGrad

BN_EPS = 1e-3
#: Below this side the VALID reduction chain reaches a zero-size map at
#: ``mixed_7a`` (the JAX model raises there too).
MIN_INPUT = 75

Size = Union[int, Sequence[int]]


class BasicConv2d(nn.Module):
    """Conv (no bias) → BN → ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Size, stride: int = 1, padding: Size = 0,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False,
                           compute_dtype=dtype)
        self.bn = BatchNorm2d(cout, eps=BN_EPS, input_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


def _residual(x: torch.Tensor, scale: float, up: torch.Tensor) -> torch.Tensor:
    """``x + scale * up`` for a float32 ``x`` and the block's ``conv2d``
    output ``up``, as XLA's jitted graph computes it: in 16 bits the weakly
    typed ``scale`` is rounded to ``up``'s dtype; in bfloat16 the product
    stays float32 (its rounding to bfloat16 is dropped before the float32
    sum), though its cotangent is rounded to bfloat16 (the convert's
    transpose), in float16 the product is rounded, then widened."""
    if up.dtype == torch.float32:
        return x + scale * up
    scale = float(torch.tensor(scale, dtype=up.dtype))
    if up.dtype == torch.bfloat16:
        return x + RoundGrad.apply(scale * up.float(), torch.bfloat16)
    return x + scale * up


class Block35(nn.Module):
    """Inception-A residual block, 256 channels."""

    def __init__(self, scale: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(256, 32, 1, dtype=dtype)
        self.branch1 = nn.Sequential(BasicConv2d(256, 32, 1, dtype=dtype),
                                     BasicConv2d(32, 32, 3, padding=1, dtype=dtype))
        self.branch2 = nn.Sequential(
            BasicConv2d(256, 32, 1, dtype=dtype),
            BasicConv2d(32, 32, 3, padding=1, dtype=dtype),
            BasicConv2d(32, 32, 3, padding=1, dtype=dtype),
        )
        self.conv2d = Conv2d(96, 256, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x)], 1)
        return F.relu(_residual(x, self.scale, self.conv2d(up)))


class Block17(nn.Module):
    """Inception-B residual block, 896 channels."""

    def __init__(self, scale: float = 1.0, dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.branch0 = BasicConv2d(896, 128, 1, dtype=dtype)
        self.branch1 = nn.Sequential(
            BasicConv2d(896, 128, 1, dtype=dtype),
            BasicConv2d(128, 128, (1, 7), padding=(0, 3), dtype=dtype),
            BasicConv2d(128, 128, (7, 1), padding=(3, 0), dtype=dtype),
        )
        self.conv2d = Conv2d(256, 896, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = torch.cat([self.branch0(x), self.branch1(x)], 1)
        return F.relu(_residual(x, self.scale, self.conv2d(up)))


class Block8(nn.Module):
    """Inception-C residual block, 1792 channels; the last has no ReLU."""

    def __init__(self, scale: float = 1.0, no_relu: bool = False, dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.no_relu = no_relu
        self.branch0 = BasicConv2d(1792, 192, 1, dtype=dtype)
        self.branch1 = nn.Sequential(
            BasicConv2d(1792, 192, 1, dtype=dtype),
            BasicConv2d(192, 192, (1, 3), padding=(0, 1), dtype=dtype),
            BasicConv2d(192, 192, (3, 1), padding=(1, 0), dtype=dtype),
        )
        self.conv2d = Conv2d(384, 1792, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = torch.cat([self.branch0(x), self.branch1(x)], 1)
        out = _residual(x, self.scale, self.conv2d(up))
        return out if self.no_relu else F.relu(out)


class Mixed6a(nn.Module):
    """Reduction-A: 256 → 896 channels, spatial /2."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.branch0 = BasicConv2d(256, 384, 3, stride=2, dtype=dtype)
        self.branch1 = nn.Sequential(
            BasicConv2d(256, 192, 1, dtype=dtype),
            BasicConv2d(192, 192, 3, padding=1, dtype=dtype),
            BasicConv2d(192, 256, 3, stride=2, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), _maxpool(x)], 1)


class Mixed7a(nn.Module):
    """Reduction-B: 896 → 1792 channels, spatial /2."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.branch0 = nn.Sequential(BasicConv2d(896, 256, 1, dtype=dtype),
                                     BasicConv2d(256, 384, 3, stride=2, dtype=dtype))
        self.branch1 = nn.Sequential(BasicConv2d(896, 256, 1, dtype=dtype),
                                     BasicConv2d(256, 256, 3, stride=2, dtype=dtype))
        self.branch2 = nn.Sequential(
            BasicConv2d(896, 256, 1, dtype=dtype),
            BasicConv2d(256, 256, 3, padding=1, dtype=dtype),
            BasicConv2d(256, 256, 3, stride=2, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x), _maxpool(x)], 1)


class InceptionResnetV1(nn.Module):
    """(B, H, W, 3) normalized NHWC, H, W >= 75 → (B, 512), the ``last_bn``
    output (callers L2-normalise); with ``return_feature_map`` also the
    ``block8`` map (B, 1792, h, w) NCHW, which Grad-CAM taps."""

    def __init__(self, dropout: float = 0.6, dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.dtype = dt = as_compute_dtype(dtype)
        self.conv2d_1a = BasicConv2d(3, 32, 3, stride=2, dtype=dt)
        self.conv2d_2a = BasicConv2d(32, 32, 3, dtype=dt)
        self.conv2d_2b = BasicConv2d(32, 64, 3, padding=1, dtype=dt)
        self.conv2d_3b = BasicConv2d(64, 80, 1, dtype=dt)
        self.conv2d_4a = BasicConv2d(80, 192, 3, dtype=dt)
        self.conv2d_4b = BasicConv2d(192, 256, 3, stride=2, dtype=dt)
        self.repeat_1 = nn.Sequential(*[Block35(0.17, dt) for _ in range(5)])
        self.mixed_6a = Mixed6a(dt)
        self.repeat_2 = nn.Sequential(*[Block17(0.10, dt) for _ in range(10)])
        self.mixed_7a = Mixed7a(dt)
        self.repeat_3 = nn.Sequential(*[Block8(0.20, dtype=dt) for _ in range(5)])
        self.block8 = Block8(no_relu=True, dtype=dt)
        self.last_linear = nn.Linear(1792, 512, bias=False)
        self.last_bn = BatchNorm1d(512, eps=BN_EPS)

    def forward(self, x: torch.Tensor, return_feature_map: bool = False, generator=None):
        if x.shape[1] < MIN_INPUT or x.shape[2] < MIN_INPUT:
            raise ValueError(
                f"InceptionResnetV1 needs inputs >= {MIN_INPUT}px, got "
                f"{tuple(x.shape[1:3])} (the FaceNet contract is 160x160)"
            )
        entry = self.conv2d_1a.conv.weight.dtype if self.dtype == torch.float32 else self.dtype
        x = x.to(entry).permute(0, 3, 1, 2)
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = _maxpool(x)
        x = self.conv2d_4b(self.conv2d_4a(self.conv2d_3b(x)))
        x = self.repeat_3(self.mixed_7a(self.repeat_2(self.mixed_6a(self.repeat_1(x)))))
        fmap = self.block8(x)
        pooled = dropout(fmap.mean(dim=(2, 3)), self.dropout, self.training, generator)
        emb = self.last_bn(self.last_linear(pooled))
        return (emb, fmap) if return_feature_map else emb

"""MobileFaceNet: a small face-embedding backbone (depthwise-separable
bottlenecks with PReLU and a global depthwise convolution).

Counterpart of ``facerecognition_tpu/models/mobilefacenet.py`` (arXiv
1804.07573's table 1 configuration). Module names are the flax ones, so
``convert.flax_to_state_dict`` carries its variables across: depthwise
kernels HWIO (I = 1, ``feature_group_count``) become OIHW ``weight``s of
``Conv2d(groups=...)``, and each ``ConvBlock``'s PReLU slopes, flax's
``prelu`` parameter, stay a ``prelu`` parameter. Batch norms are the port's
flax-statistics ``BatchNorm1d`` / ``BatchNorm2d`` (momentum 0.9, eps 1e-5).

Input: (B, 112, 112, 3) normalised NHWC. Output: (B, embedding_size), not
normalised (callers L2-normalise). ``MobileFaceNetArcFace`` adds the port's
``ArcMarginProduct`` head with ``ArcFaceModel``'s contract, so
``training.steps.make_arcface_train_step`` trains it. ``dtype`` is the
convolutions' compute dtype (the flax field): the batch norms return
float32, so the PReLUs, the residual sums, ``fc`` and its batch norm run in
float32, as JAX's type promotion has them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from facerecognition_tpu_torch.models.arcface import ArcMarginProduct, Margin
from facerecognition_tpu_torch.models.layers import (
    BatchNorm1d,
    BatchNorm2d,
    Conv2d,
    as_compute_dtype,
)

BN_EPS = 1e-5
#: (expansion, output channels, blocks, stride of the first block) per stage.
STAGES = ((2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1), (4, 128, 1, 2), (2, 128, 2, 1))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``where(x >= 0, x, alpha * x)`` with one slope per channel (NCHW)."""
    return torch.where(x >= 0, x, alpha.view(1, -1, *([1] * (x.ndim - 2))) * x)


class ConvBlock(nn.Module):
    """Convolution (no bias, "same" padding), batch norm, then PReLU unless
    ``linear`` (a bottleneck's projection)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, strides: int = 1,
                 groups: int = 1, linear: bool = False, dtype=torch.float32):
        super().__init__()
        pad = kernel // 2
        self.linear = linear
        self.conv = Conv2d(cin, features, kernel, strides, pad, groups=groups, bias=False,
                           compute_dtype=dtype)
        self.bn = BatchNorm2d(features, eps=BN_EPS, input_dtype=dtype)
        self.prelu = None if linear else nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.linear else prelu(x, self.prelu)


class Bottleneck(nn.Module):
    """MobileNetV2's inverted residual with PReLU (expansion t)."""

    def __init__(self, cin: int, features: int, strides: int = 1, expansion: int = 2,
                 dtype=torch.float32):
        super().__init__()
        hidden = cin * expansion
        self.residual = strides == 1 and cin == features
        self.expand = ConvBlock(cin, hidden, 1, dtype=dtype)
        self.dw = ConvBlock(hidden, hidden, 3, strides, groups=hidden, dtype=dtype)
        self.project = ConvBlock(hidden, features, 1, linear=True, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.dw(self.expand(x)))
        return x + y if self.residual else y


class MobileFaceNet(nn.Module):
    """(B, S, S, 3) NHWC → (B, embedding_size); the global depthwise
    convolution spans the last map, 7x7 at 112²."""

    def __init__(self, embedding_size: int = 512, input_size: int = 112, dtype=torch.float32):
        super().__init__()
        self.dtype = dt = as_compute_dtype(dtype)
        self.conv1 = ConvBlock(3, 64, 3, 2, dtype=dt)
        self.dw_conv = ConvBlock(64, 64, 3, 1, groups=64, dtype=dt)
        cin = 64
        for i, (t, c, n, s) in enumerate(STAGES):
            for b in range(n):
                self.add_module(f"stage{i}_{b}", Bottleneck(cin, c, s if b == 0 else 1, t, dt))
                cin = c
        self.conv2 = ConvBlock(cin, 512, 1, dtype=dt)
        side = input_size
        for stride in (2, 2, 2, 2):  # conv1 and the stages' strides: 112 → 7
            side = (side - 1) // stride + 1
        self.gdconv = Conv2d(512, 512, side, groups=512, bias=False, compute_dtype=dt)
        self.gdbn = BatchNorm2d(512, eps=BN_EPS, input_dtype=dt)
        self.fc = nn.Linear(512, embedding_size, bias=False)
        self.fc_bn = BatchNorm1d(embedding_size, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        entry = self.fc.weight.dtype if self.dtype == torch.float32 else self.dtype
        x = self.dw_conv(self.conv1(x.to(entry).permute(0, 3, 1, 2)))
        for i, (_, _, n, _) in enumerate(STAGES):
            for b in range(n):
                x = getattr(self, f"stage{i}_{b}")(x)
        x = self.gdbn(self.gdconv(self.conv2(x)))
        return self.fc_bn(self.fc(x.flatten(1)))


class MobileFaceNetArcFace(nn.Module):
    """MobileFaceNet with the ArcFace margin head (``ArcFaceModel``'s
    contract): embeddings without labels, ``(logits, embeddings)`` with
    them."""

    def __init__(self, num_classes: int = 0, embedding_size: int = 512, scale: float = 64.0,
                 margin: float = 0.5, easy_margin: bool = False, input_size: int = 112,
                 dtype=torch.float32):
        super().__init__()
        self.backbone = MobileFaceNet(embedding_size, input_size, dtype)
        self.dtype = self.backbone.dtype
        self.arcface = (
            ArcMarginProduct(num_classes, embedding_size, scale, margin, easy_margin)
            if num_classes > 0 else None
        )

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                margin_override: Optional[Margin] = None,
                generator: Optional[torch.Generator] = None):
        emb = self.backbone(x)  # no dropout: ``generator`` is the step's contract
        if labels is None:
            return emb
        if self.arcface is None:
            raise ValueError("labels given to a MobileFaceNetArcFace without a margin head")
        return self.arcface(emb, labels, margin_override), emb

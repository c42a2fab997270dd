"""ResNet backbone (torchvision v1.5 Bottleneck) for the ArcFace embedder.

Counterpart of ``facerecognition_tpu/models/resnet.py`` for any
``stage_sizes``. Input is NHWC, as in the JAX package; module names follow
the flax ones (``layer1_0``, ``downsample_conv``) so ``convert.py`` carries
weights across by name. In training mode (``module.train()``) the batch
norms update their running statistics as flax's do (``models/layers.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerecognition_tpu_torch.models.layers import BatchNorm2d

BN_EPS = 1e-5


class Bottleneck(nn.Module):
    """1x1 → 3x3 (strided) → 1x1 with expansion 4, optional projection."""

    def __init__(self, cin: int, width: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(width * 4, eps=BN_EPS)
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, width * 4, 1, stride=stride, bias=False)
            self.downsample_bn = BatchNorm2d(width * 4, eps=BN_EPS)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet50Backbone(nn.Module):
    """ResNet → global-average-pooled 2048-d features. (B, H, W, 3) → (B, 2048);
    with ``return_feature_map`` also the layer-4 map before pooling, NCHW
    (B, 2048, H/32, W/32)."""

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=BN_EPS)
        self.blocks = []
        cin = 64
        for stage, (n_blocks, width, stride) in enumerate(
            zip(self.stage_sizes, (64, 128, 256, 512), (1, 2, 2, 2))
        ):
            for block in range(n_blocks):
                name = f"layer{stage + 1}_{block}"
                self.add_module(
                    name,
                    Bottleneck(cin, width, stride if block == 0 else 1, block == 0),
                )
                self.blocks.append(name)
                cin = width * 4

    def forward(self, x: torch.Tensor, return_feature_map: bool = False):
        x = x.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        # MaxPool2d pads with -inf, as the JAX model pads before its pool.
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        pooled = x.mean(dim=(2, 3))
        return (pooled, x) if return_feature_map else pooled

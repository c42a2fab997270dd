"""ArcFace embedder, inference forward: backbone → BN → FC → BN.

Counterpart of ``ArcFaceModel`` in ``facerecognition_tpu/models/arcface.py``
with ``labels=None``. Dropout is the identity at inference; the margin head
is training-only and is not part of this model.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from facerecognition_tpu_torch.models.resnet import BN_EPS, ResNet50Backbone


class ArcFaceModel(nn.Module):
    """(B, S, S, 3) normalized NHWC → (B, embedding_size) un-normalized."""

    def __init__(self, embedding_size: int = 512, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.backbone = ResNet50Backbone(stage_sizes)
        self.bn1 = nn.BatchNorm1d(2048, eps=BN_EPS)
        self.fc = nn.Linear(2048, embedding_size)
        self.bn2 = nn.BatchNorm1d(embedding_size, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.fc(self.bn1(self.backbone(x))))

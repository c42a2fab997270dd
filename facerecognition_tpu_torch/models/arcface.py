"""ArcFace embedder, inference forward: backbone → BN → FC → BN.

Counterpart of ``ArcFaceModel`` in ``facerecognition_tpu/models/arcface.py``
with ``labels=None``. Dropout is the identity at inference; the margin head
is training-only and is not part of this model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from facerecognition_tpu_torch.models.resnet import BN_EPS, ResNet50Backbone


class ArcFaceModel(nn.Module):
    """(B, S, S, 3) normalized NHWC → (B, embedding_size) un-normalized.

    ``return_feature_map=True`` also returns the backbone's layer-4 map
    (NCHW); ``feature_map=`` embeds straight from such a map by its spatial
    mean, skipping the backbone (the Grad-CAM re-entry of the JAX model,
    whose map is NHWC)."""

    def __init__(self, embedding_size: int = 512, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.backbone = ResNet50Backbone(stage_sizes)
        self.bn1 = nn.BatchNorm1d(2048, eps=BN_EPS)
        self.fc = nn.Linear(2048, embedding_size)
        self.bn2 = nn.BatchNorm1d(embedding_size, eps=BN_EPS)

    def forward(
        self,
        x: Optional[torch.Tensor],
        return_feature_map: bool = False,
        feature_map: Optional[torch.Tensor] = None,
    ):
        fmap = None
        if feature_map is not None:
            feats = feature_map.float().mean(dim=(2, 3))
        elif return_feature_map:
            feats, fmap = self.backbone(x, return_feature_map=True)
        else:
            feats = self.backbone(x)
        emb = self.bn2(self.fc(self.bn1(feats)))
        return (emb, fmap) if return_feature_map else emb

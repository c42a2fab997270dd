"""FaceNet embedder, inference forward: InceptionResnetV1 → optional
projection → L2 normalisation.

Counterpart of ``FaceNetModel`` in ``facerecognition_tpu/models/facenet.py``.
The triplet loss and the miners belong to training, which is not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from facerecognition_tpu_torch.models.inception_resnet_v1 import InceptionResnetV1


class FaceNetModel(nn.Module):
    """(B, S, S, 3) normalized NHWC → (B, embedding_size) unit rows; a Linear
    ``projection`` maps the backbone's 512 to ``embedding_size`` when they
    differ."""

    def __init__(self, embedding_size: int = 512):
        super().__init__()
        self.embedding_size = embedding_size
        self.backbone = InceptionResnetV1()
        self.projection = nn.Linear(512, embedding_size) if embedding_size != 512 else None

    def forward(self, x: torch.Tensor, return_feature_map: bool = False):
        emb, fmap = self.backbone(x, return_feature_map=True)
        if self.projection is not None:
            emb = self.projection(emb)
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        return (emb, fmap) if return_feature_map else emb

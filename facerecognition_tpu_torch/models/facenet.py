"""FaceNet: InceptionResnetV1 → optional projection → L2 normalisation, the
triplet loss and the online miners.

Counterpart of ``facerecognition_tpu/models/facenet.py``. The miners pick
the JAX package's indices: one (B, B) distance matrix (pairwise squared
distances as the JAX matcher computes them), masked argmin/argmax, which
take the first index on ties in PyTorch as in JAX (``ops/matcher.
pairwise_sq_dists``, the JAX matcher's expression). In training mode
(``module.train()``) the backbone's dropout and batch norms follow flax
(``models/layers.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from facerecognition_tpu_torch.models.inception_resnet_v1 import InceptionResnetV1
from facerecognition_tpu_torch.ops.matcher import pairwise_sq_dists


class FaceNetModel(nn.Module):
    """(B, S, S, 3) normalized NHWC → (B, embedding_size) unit rows; a Linear
    ``projection`` maps the backbone's 512 to ``embedding_size`` when they
    differ."""

    def __init__(self, embedding_size: int = 512, dropout: float = 0.6):
        super().__init__()
        self.embedding_size = embedding_size
        self.backbone = InceptionResnetV1(dropout)
        self.projection = nn.Linear(512, embedding_size) if embedding_size != 512 else None

    def forward(
        self,
        x: torch.Tensor,
        return_feature_map: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        emb, fmap = self.backbone(x, return_feature_map=True, generator=generator)
        if self.projection is not None:
            emb = self.projection(emb)
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        return (emb, fmap) if return_feature_map else emb


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(((a - b) ** 2).sum(-1), min=1e-16))


def triplet_loss(
    anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor, margin: float = 0.5
) -> torch.Tensor:
    """``nn.TripletMarginLoss(margin, p=2)`` (mean), distances clamped at
    1e-16 under the root as the JAX function does."""
    return torch.clamp(_dist(anchor, positive) - _dist(anchor, negative) + margin, min=0.0).mean()


def _masks(labels: torch.Tensor):
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(labels.shape[0], dtype=torch.bool, device=labels.device)
    return same & ~eye, ~same


def mine_semi_hard(embeddings: torch.Tensor, labels: torch.Tensor, margin: float = 0.5):
    """Semi-hard mining over a (B, D) batch: for every ordered (anchor,
    positive) pair, the farthest negative inside ``d(a,p) < d(a,n) < d(a,p) +
    margin``, else the nearest negative. Returns (anchor, positive, negative,
    valid), each (B·B,), rows with ``valid`` False being padding."""
    b = embeddings.shape[0]
    d = torch.sqrt(torch.clamp(pairwise_sq_dists(embeddings, embeddings), min=1e-16))
    pos_mask, neg_mask = _masks(labels)
    d_an = d[:, None, :]
    d_ap = d[:, :, None]
    band = (d_an > d_ap) & (d_an < d_ap + margin) & neg_mask[:, None, :]
    band_scores = torch.where(band, d_an, torch.tensor(-1e9, device=d.device))
    best_in_band = torch.argmax(band_scores, dim=-1)
    has_band = band.any(-1)
    neg_scores = torch.where(neg_mask, d, torch.tensor(1e9, device=d.device))
    hardest_neg = torch.argmin(neg_scores, dim=-1)
    neg_idx = torch.where(has_band, best_in_band, hardest_neg[:, None])
    ar = torch.arange(b, device=d.device)
    anchor_idx = ar[:, None].expand(b, b)
    pos_idx = ar[None, :].expand(b, b)
    valid = pos_mask & neg_mask.any(-1)[:, None]
    return anchor_idx.reshape(-1), pos_idx.reshape(-1), neg_idx.reshape(-1), valid.reshape(-1)


def mine_batch_hard(embeddings: torch.Tensor, labels: torch.Tensor):
    """Batch-hard mining: per anchor its farthest positive and nearest
    negative. Returns (anchor, positive, negative, valid), each (B,)."""
    b = embeddings.shape[0]
    d = torch.sqrt(torch.clamp(pairwise_sq_dists(embeddings, embeddings), min=1e-16))
    pos_mask, neg_mask = _masks(labels)
    hardest_pos = torch.argmax(torch.where(pos_mask, d, torch.tensor(-1e9, device=d.device)), -1)
    hardest_neg = torch.argmin(torch.where(neg_mask, d, torch.tensor(1e9, device=d.device)), -1)
    anchor_idx = torch.arange(b, device=d.device)
    valid = pos_mask.any(-1) & neg_mask.any(-1)
    return anchor_idx, hardest_pos, hardest_neg, valid


def masked_triplet_loss(
    embeddings: torch.Tensor,
    anchor_idx: torch.Tensor,
    pos_idx: torch.Tensor,
    neg_idx: torch.Tensor,
    valid: torch.Tensor,
    margin: float = 0.5,
) -> torch.Tensor:
    """Triplet loss over mined (padded) index triples, mean over valid rows."""
    a, p, n = embeddings[anchor_idx], embeddings[pos_idx], embeddings[neg_idx]
    per = torch.clamp(_dist(a, p) - _dist(a, n) + margin, min=0.0)
    per = torch.where(valid, per, torch.zeros((), dtype=per.dtype, device=per.device))
    return per.sum() / torch.clamp(valid.float().sum(), min=1.0)

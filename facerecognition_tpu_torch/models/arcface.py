"""ArcFace model: backbone → BN → Dropout → FC → BN, and the margin head.

Counterpart of ``facerecognition_tpu/models/arcface.py``. With
``labels=None`` the forward returns embeddings (the inference contract);
with labels it returns ``(logits, embeddings)``, the logits from the
additive-angular-margin head ``arcface`` (``ArcMarginProduct``, a (C, D)
``weight``), which exists when ``num_classes`` > 0. In training mode
(``module.train()``) dropout is flax's, drawn from the generator the forward
is given, and the batch norms update their running statistics as flax's do
(``models/layers.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from facerecognition_tpu_torch.models.layers import BatchNorm1d, dropout
from facerecognition_tpu_torch.models.resnet import BN_EPS, ResNet50Backbone
from facerecognition_tpu_torch.ops.matcher import l2_normalize

Margin = Union[float, torch.Tensor]


def arc_margin_logits(
    embeddings: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    scale: float = 64.0,
    margin: Margin = 0.5,
    easy_margin: bool = False,
) -> torch.Tensor:
    """Additive angular margin logits: ``s * cos(θ + m)`` on the true class,
    ``s * cos θ`` elsewhere, with the easy-margin gate (cos θ > 0) or the
    θ + m > π fallback (cos θ - m·sin(π - m)). ``margin`` may be a tensor
    (the margin schedule). embeddings (B, D), weight (C, D), labels (B,)
    → (B, C)."""
    cosine = l2_normalize(embeddings, dim=1) @ l2_normalize(weight, dim=1).T
    sine = torch.sqrt(torch.clamp(1.0 - cosine**2, 1e-7, 1.0))
    m = torch.as_tensor(margin, dtype=torch.float32, device=cosine.device)
    phi = cosine * torch.cos(m) - sine * torch.sin(m)  # cos(θ + m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        th = torch.cos(math.pi - m)
        mm = torch.sin(math.pi - m) * m
        phi = torch.where(cosine > th, phi, cosine - mm)
    one_hot = F.one_hot(labels.long(), weight.shape[0]).to(cosine.dtype)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * scale


class ArcMarginProduct(nn.Module):
    """The margin head: owns the (C, D) class ``weight`` (flax's
    ``xavier_uniform``: U(±sqrt(6 / (C + D))))."""

    def __init__(
        self,
        num_classes: int,
        embedding_size: int = 512,
        scale: float = 64.0,
        margin: float = 0.5,
        easy_margin: bool = False,
    ):
        super().__init__()
        self.scale = scale
        self.margin = margin
        self.easy_margin = easy_margin
        self.weight = nn.Parameter(torch.empty(num_classes, embedding_size))
        self.reset_flax()

    def reset_flax(self, generator: Optional[torch.Generator] = None) -> None:
        bound = math.sqrt(6.0 / sum(self.weight.shape))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, embeddings, labels, margin_override: Optional[Margin] = None):
        return arc_margin_logits(
            embeddings, self.weight, labels, self.scale,
            self.margin if margin_override is None else margin_override, self.easy_margin,
        )


class ArcFaceModel(nn.Module):
    """(B, S, S, 3) normalized NHWC → (B, embedding_size) un-normalized.

    ``return_feature_map=True`` also returns the backbone's layer-4 map
    (NCHW); ``feature_map=`` embeds straight from such a map by its spatial
    mean, skipping the backbone (the Grad-CAM re-entry of the JAX model,
    whose map is NHWC). ``labels=`` (with ``num_classes`` > 0) returns
    ``(logits, embeddings)``; ``margin_override`` replaces the head's margin
    (a float or a 0-d tensor)."""

    def __init__(
        self,
        embedding_size: int = 512,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        num_classes: int = 0,
        scale: float = 64.0,
        margin: float = 0.5,
        easy_margin: bool = False,
        dropout: float = 0.5,
    ):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.dropout = dropout
        self.backbone = ResNet50Backbone(stage_sizes)
        self.bn1 = BatchNorm1d(2048, eps=BN_EPS)
        self.fc = nn.Linear(2048, embedding_size)
        self.bn2 = BatchNorm1d(embedding_size, eps=BN_EPS)
        self.arcface = (
            ArcMarginProduct(num_classes, embedding_size, scale, margin, easy_margin)
            if num_classes > 0 else None
        )

    def forward(
        self,
        x: Optional[torch.Tensor],
        labels: Optional[torch.Tensor] = None,
        return_feature_map: bool = False,
        feature_map: Optional[torch.Tensor] = None,
        margin_override: Optional[Margin] = None,
        generator: Optional[torch.Generator] = None,
    ):
        fmap = None
        if feature_map is not None:
            feats = feature_map.float().mean(dim=(2, 3))
        elif return_feature_map:
            feats, fmap = self.backbone(x, return_feature_map=True)
        else:
            feats = self.backbone(x)
        feats = dropout(self.bn1(feats), self.dropout, self.training, generator)
        emb = self.bn2(self.fc(feats))
        if labels is None:
            return (emb, fmap) if return_feature_map else emb
        if self.arcface is None:
            raise ValueError("labels given to an ArcFaceModel without a margin head (num_classes=0)")
        return self.arcface(emb, labels, margin_override), emb


#: Backbone stages in the order ``freeze_mask`` freezes them.
FREEZE_ORDER = ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")


def freeze_mask(names, freeze_ratio: float = 0.8) -> dict[str, bool]:
    """``{parameter name: trainable}`` over the port's parameter names: the
    first ``int(6 * freeze_ratio)`` of the backbone's stages (conv1, bn1,
    layer1..4, in order) are frozen; the embedding head and the margin head
    always train. ``names``: a model, a state dict or parameter names."""
    if isinstance(names, nn.Module):
        names = [n for n, _ in names.named_parameters()]
    frozen = set(FREEZE_ORDER[: int(len(FREEZE_ORDER) * freeze_ratio)])
    out = {}
    for name in names:
        parts = name.split(".")
        out[name] = not (
            len(parts) >= 3 and parts[0] == "backbone" and parts[1].split("_")[0] in frozen
        )
    return out

"""Single-stage face detector: the two backbones, anchors and decode.

Counterpart of ``facerecognition_tpu/models/detector_net.py``: the ``dense``
arch (``DenseDetNet``, shipped as ``assets/detector_v4_128.msgpack``), the
``blaze`` arch (``BlazeFaceNet``, the older ``detector_v2_128`` and
``detector_synthetic_128`` checkpoints), and the post-process:
the one-face argmax decode and the crowd path's decode → top-K → NMS (whose
card version is the ``ops.detect_post`` kernel). Input and output keep
the JAX layout: (B, S, S, 3) normalized NHWC → (B, A, 15) raw predictions,
A = (S/8)²·2 + (S/16)²·6 anchors ordered (y, x, anchor). Each anchor
predicts [logit, dcx, dcy, w, h, 5 × (lx, ly)] relative to its centre.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from facerecognition_tpu_torch.ops.matcher import topk_lowest_index
from facerecognition_tpu_torch.ops.nms import nms_padded


def _same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``padding='SAME'``: total pad ``(ceil(n/s) - 1)·s + k - n``, the
    extra pixel at the end. A stride-2 3x3 conv on an even input pads (0, 1),
    where torch's ``padding=1`` would pad (1, 1)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((math.ceil(n / stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _SameConv(nn.Conv2d):
    """Conv2d with flax's SAME padding (no implicit padding of its own)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__(cin, cout, kernel, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_same_pad(x, self.kernel_size[0], self.stride[0]))


class DenseDetNet(nn.Module):
    """Plain 3x3/5x5 convolution detector backbone with two heads."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 32, 5, stride=2, padding=2)  # S/2
        self.c1 = _SameConv(32, 48, 3)
        self.d1 = _SameConv(48, 64, 3, 2)  # S/4
        self.c2 = _SameConv(64, 64, 3)
        self.d2 = _SameConv(64, 96, 3, 2)  # S/8
        self.c3 = _SameConv(96, 96, 3)
        self.c4 = _SameConv(96, 96, 3)
        self.d3 = _SameConv(96, 128, 3, 2)  # S/16
        self.c5 = _SameConv(128, 128, 3)
        self.head1 = nn.Conv2d(96, 2 * 15, 1)
        self.head2 = nn.Conv2d(128, 6 * 15, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(self.stem(x))
        x = F.relu(self.c1(x))
        x = F.relu(self.d1(x))
        x = F.relu(self.c2(x))
        x = F.relu(self.d2(x))
        x = F.relu(self.c3(x))
        f1 = F.relu(self.c4(x))
        x = F.relu(self.d3(f1))
        f2 = F.relu(self.c5(x))
        b = x.shape[0]
        # NHWC before the reshape keeps the flax anchor order (y, x, anchor).
        out1 = self.head1(f1).permute(0, 2, 3, 1).reshape(b, -1, 15)
        out2 = self.head2(f2).permute(0, 2, 3, 1).reshape(b, -1, 15)
        return torch.cat([out1, out2], dim=1)


class BlazeBlock(nn.Module):
    """Depthwise 5x5 (``groups=cin``, symmetric padding 2) + pointwise 1x1,
    plus a shortcut: a 2x2 max-pool at stride 2 when the block strides, then
    zero channels up to ``features``; ReLU of the sum."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.strides = strides
        self.extra = features - cin
        self.dw = nn.Conv2d(cin, cin, 5, stride=strides, padding=2, groups=cin)
        self.pw = nn.Conv2d(cin, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw(self.dw(x))
        if self.strides == 2:
            x = F.max_pool2d(x, 2, 2)
        if self.extra:
            x = F.pad(x, (0, 0, 0, 0, 0, self.extra))
        return F.relu(x + y)


class BlazeFaceNet(nn.Module):
    """BlazeFace-style backbone (depthwise blocks) with the same two heads
    and the same input/output contract as ``DenseDetNet``."""

    # (name, features, stride) of each block after the stem
    BLOCKS = (
        ("b1", 24, 1), ("b2", 28, 1), ("b3", 32, 2), ("b4", 36, 1), ("b5", 42, 1),
        ("b6", 48, 2), ("b7", 56, 1), ("b8", 64, 1),  # S/8: small faces
        ("b9", 88, 2), ("b10", 96, 1), ("b11", 96, 1),  # S/16: large faces
    )

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(3, 24, 5, stride=2, padding=2)  # S/2
        cin = 24
        for name, features, stride in self.BLOCKS:
            setattr(self, name, BlazeBlock(cin, features, stride))
            cin = features
        self.head1 = nn.Conv2d(64, 2 * 15, 1)
        self.head2 = nn.Conv2d(96, 6 * 15, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(self.stem(x))
        for name, _, _ in self.BLOCKS:
            x = getattr(self, name)(x)
            if name == "b8":
                f1 = x
        b = x.shape[0]
        # NHWC before the reshape keeps the flax anchor order (y, x, anchor).
        out1 = self.head1(f1).permute(0, 2, 3, 1).reshape(b, -1, 15)
        out2 = self.head2(x).permute(0, 2, 3, 1).reshape(b, -1, 15)
        return torch.cat([out1, out2], dim=1)


DETECTOR_ARCHS = {"blaze": BlazeFaceNet, "dense": DenseDetNet}


def build_detector_net(arch: str = "blaze") -> nn.Module:
    """Detector backbone by the checkpoint's ``arch`` name."""
    try:
        return DETECTOR_ARCHS[arch]()
    except KeyError:
        raise ValueError(
            f"unknown detector arch {arch!r}; have {sorted(DETECTOR_ARCHS)}"
        ) from None


def anchor_centers(input_size: int) -> np.ndarray:
    """(A, 3) anchors: centre x, centre y, base size, in input pixels."""
    out = []
    for grid, n_anchor, base in (
        (input_size // 8, 2, input_size / 8),
        (input_size // 16, 6, input_size / 4),
    ):
        step = input_size / grid
        ys, xs = np.mgrid[0:grid, 0:grid]
        c = np.stack([(xs + 0.5) * step, (ys + 0.5) * step], -1).reshape(-1, 2)
        c = np.repeat(c, n_anchor, axis=0)
        s = np.full((len(c), 1), base, np.float32)
        out.append(np.concatenate([c, s], -1))
    return np.concatenate(out).astype(np.float32)


def decode_predictions(raw: torch.Tensor, anchors: torch.Tensor):
    """Raw predictions (..., 15) with their anchors (..., 3), e.g. (B, A, 15)
    with (A, 3) → scores (..., ), xyxy boxes (..., 4) and landmarks
    (..., 5, 2), in input pixels."""
    cx0, cy0, base = anchors[..., 0], anchors[..., 1], anchors[..., 2]
    scores = torch.sigmoid(raw[..., 0])
    cx = cx0 + raw[..., 1] * base * 0.5
    cy = cy0 + raw[..., 2] * base * 0.5
    w = torch.exp(torch.clamp(raw[..., 3], -4.0, 4.0)) * base
    h = torch.exp(torch.clamp(raw[..., 4], -4.0, 4.0)) * base
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    lm = raw[..., 5:15].reshape(*raw.shape[:-1], 5, 2) * base[..., None, None] * 0.5
    landmarks = lm + torch.stack([cx0, cy0], -1)[..., None, :]
    return scores, boxes, landmarks


def prefilter_size(n_anchors: int, max_faces: int) -> int:
    """Candidates kept before NMS: 8 per output slot, at least 64, as the
    JAX ``detect_faces``."""
    return min(n_anchors, max(64, 8 * max_faces))


def detect_faces_batch(
    raw: torch.Tensor, anchors: torch.Tensor, iou_threshold: float, max_faces: int = 16
):
    """Full post-process of each frame: decode → top-K prefilter → NMS.

    raw (B, A, 15), anchors (A, 3) → boxes (B, M, 4), landmarks (B, M, 5, 2),
    scores (B, M) (0 where invalid), valid (B, M), M = ``max_faces``. The
    prefilter ranks the sigmoid scores in ``lax.top_k``'s order (value
    descending, index ascending): logits above about 17 all round to 1.0 and
    tie, and the lowest anchors win. Invalid slots carry the top candidate's
    box and landmarks, as the JAX function's ``maximum(keep_idx, 0)``.
    """
    scores, boxes, landmarks = decode_predictions(raw, anchors)
    k = prefilter_size(scores.shape[1], max_faces)
    top_s, top_i = topk_lowest_index(scores, k)
    top_i = top_i.long()
    top_boxes = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    top_lm = torch.gather(landmarks, 1, top_i[..., None, None].expand(-1, -1, 5, 2))
    keep, valid = nms_padded(top_boxes, top_s, iou_threshold, max_faces)
    safe = torch.clamp(keep, min=0).long()
    out_s = torch.gather(top_s, 1, safe)
    return (
        torch.gather(top_boxes, 1, safe[..., None].expand(-1, -1, 4)),
        torch.gather(top_lm, 1, safe[..., None, None].expand(-1, -1, 5, 2)),
        torch.where(valid, out_s, torch.zeros_like(out_s)),
        valid,
    )


def detect_faces(raw: torch.Tensor, anchors: torch.Tensor, iou_threshold: float, max_faces: int = 16):
    """``detect_faces_batch`` of one frame's raw (A, 15): boxes (M, 4),
    landmarks (M, 5, 2), scores (M,), valid (M,)."""
    return tuple(t[0] for t in detect_faces_batch(raw[None], anchors, iou_threshold, max_faces))


def detect_best_face(raw: torch.Tensor, anchors: torch.Tensor):
    """The single best face per image: argmax of the logit, one-anchor decode.

    raw (B, A, 15) → box (B, 4) xyxy, landmarks (B, 5, 2), score (B,). Greedy
    NMS's first pick is the score argmax, so this is the top slot of the full
    post-process without its top-k and NMS. Ties go to the first anchor, as
    ``jnp.argmax``.
    """
    i = torch.argmax(raw[..., 0], dim=-1)
    r = torch.gather(raw, 1, i[:, None, None].expand(-1, 1, raw.shape[-1]))[:, 0]
    scores, boxes, landmarks = decode_predictions(r, anchors[i])
    return boxes, landmarks, scores

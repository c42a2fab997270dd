"""Greedy NMS over fixed-size padded candidate sets, batched over frames.

Counterpart of ``facerecognition_tpu/ops/nms.py``: a fixed K candidates per
frame (padding rows score <= 0) in, a fixed ``max_out`` picks with a
validity mask out, so shapes never depend on the data. The JAX functions
take one frame (the engine ``vmap``s them); these take a leading batch
dimension. On the card the whole detector post-process runs as one kernel
(``ops.detect_post``); this is its plain version's NMS.
"""

from __future__ import annotations

import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of [x1, y1, x2, y2] boxes: (..., A, 4) x (..., B, 4) →
    (..., A, B)."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0.0) * torch.clamp(a[..., 3] - a[..., 1], min=0.0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.3,
    max_out: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of each frame's padded candidates.

    Args:
      boxes: (B, K, 4) [x1, y1, x2, y2].
      scores: (B, K); padding rows must score <= 0.
      iou_threshold: a pick suppresses candidates with IoU >= this.
      max_out: picks per frame.

    Returns:
      (indices, valid): (B, max_out) int32 indices into the K candidates
      (-1 where invalid) and a bool mask (False: fewer survivors). Each step
      picks the first maximum of the live scores, as ``jnp.argmax``.
    """
    bsz, k = scores.shape
    iou = iou_matrix(boxes, boxes)  # (B, K, K)
    ninf = torch.tensor(float("-inf"), device=scores.device)
    alive = torch.where(scores > 0, scores, ninf)
    cols = torch.arange(k, device=scores.device)
    rows = torch.arange(bsz, device=scores.device)
    out_idx, out_valid = [], []
    for _ in range(max_out):
        best = torch.argmax(alive, dim=1)
        keep = alive[rows, best] > 0.0
        out_idx.append(torch.where(keep, best, -1))
        out_valid.append(keep)
        suppress = (iou[rows, best] >= iou_threshold) | (cols[None, :] == best[:, None])
        alive = torch.where(keep[:, None] & suppress, ninf, alive)
    return torch.stack(out_idx, 1).int(), torch.stack(out_valid, 1)

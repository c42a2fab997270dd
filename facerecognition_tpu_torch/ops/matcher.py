"""Gallery matching: cosine scores plus an exact top-k, lowest index on ties.

Counterpart of ``facerecognition_tpu/ops/matcher.py``. The dense path
materialises the (B, N) score matrix; the streaming kernel
(``ops.stream_topk``) never does.
"""

from __future__ import annotations

from typing import Optional

import torch

from facerecognition_tpu_torch.device import strict_fp32

#: Above this many bytes of (B, N) float32 scores, ``auto`` picks the
#: streaming kernel on the card (same switch as the JAX package: memory,
#: not row count).
DENSE_SCORES_MAX_BYTES = 2 << 30  # 2 GiB


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim``."""
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys that order float32 scores as ``lax.top_k`` does: IEEE total
    order (-NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN), with every NaN
    of one sign on one key, so NaNs tie among themselves and go lowest index
    first. ``csrc/stream_topk.cu`` (``order_key``) computes the same keys."""
    bits = scores.float().contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    nan_key = torch.where(bits >= 0, 0x7FFFFFFF, -0x7FFFFFFF).to(torch.int32)
    return torch.where(torch.isnan(scores), nan_key, key)


def topk_lowest_index(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``scores`` in (value descending, index ascending)
    order — ``lax.top_k``'s order, NaN above +inf (``order_key``).
    ``torch.topk`` does not promise an order among equal values, so it only
    finds the k-th key here; the entries above it and the lowest-index
    entries equal to it are then taken.

    Returns (values (B, k), int32 indices (B, k)).
    """
    keys = order_key(scores)
    kth = torch.topk(keys, k, dim=1).values[:, -1:]
    above = keys > kth
    equal = keys == kth
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (equal & (torch.cumsum(equal, dim=1) <= need))
    idx = take.nonzero()[:, 1].reshape(scores.shape[0], k)  # ascending per row
    order = torch.sort(torch.gather(keys, 1, idx), dim=1, descending=True, stable=True).indices
    idx = torch.gather(idx, 1, order)
    return torch.gather(scores, 1, idx), idx.int()


def cosine_topk(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int = 5,
    normalized: bool = False,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine matches of each query (B, D) against the gallery (N, D).

    ``normalized``: both inputs are unit rows already. ``n_valid``: rows
    ``>= n_valid`` (capacity padding) score -inf so they never win; the
    caller keeps ``k <= n_valid``. Returns (scores, int32 indices), (B, k).
    """
    q = queries.float()
    g = gallery.float()
    if not normalized:
        q, g = l2_normalize(q), l2_normalize(g)
    with strict_fp32():
        scores = q @ g.T
    if n_valid is not None:
        pad = torch.arange(scores.shape[1], device=scores.device) >= n_valid
        scores = scores.masked_fill(pad[None, :], float("-inf"))
    return topk_lowest_index(scores, k)


def auto_cosine_topk(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    k: int = 5,
    kernel: str = "auto",
    normalized: bool = False,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk``, or the streaming kernel when the dense score matrix
    would pressure device memory.

    ``kernel``: ``'auto'`` (the streaming kernel for a CUDA gallery whose
    (B, N) scores exceed ``DENSE_SCORES_MAX_BYTES``, with no ``n_valid`` and
    ``k <= ops.stream_topk.MAX_K``), ``'dense'``, or ``'stream'``. The
    kernel has no mask, so ``'stream'`` with ``n_valid`` is rejected: pass
    the exact-size gallery.
    """
    if kernel not in ("auto", "dense", "stream"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if kernel == "auto":
        # local: ops.stream_topk imports this module
        from facerecognition_tpu_torch.ops.stream_topk import MAX_K

        scores_bytes = queries.shape[0] * gallery.shape[0] * 4
        kernel = (
            "stream"
            if n_valid is None
            and k <= MAX_K
            and gallery.device.type == "cuda"
            and scores_bytes > DENSE_SCORES_MAX_BYTES
            else "dense"
        )
    if kernel == "stream":
        if n_valid is not None:
            raise ValueError(
                "n_valid masking is not supported by the streaming kernel; "
                "pass the exact-size gallery instead"
            )
        # local: ops.stream_topk imports this module
        from facerecognition_tpu_torch.ops.stream_topk import stream_topk

        return stream_topk(queries, gallery, k)
    return cosine_topk(queries, gallery, k, normalized, n_valid)

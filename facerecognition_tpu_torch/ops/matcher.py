"""Gallery matching: cosine scores plus an exact top-k, lowest index on ties.

Counterpart of ``facerecognition_tpu/ops/matcher.py``. The dense path
materialises the (B, N) score matrix; the streaming kernels
(``ops.stream_topk`` on float32 rows, ``ops.int8_topk`` on int8 codes)
never do. The int8 path here (``cosine_topk_int8``) is the int8 kernel's
plain version.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import strict_fp32
from facerecognition_tpu_torch.ops.umeyama import sum_left

#: Above this many bytes of (B, N) float32 scores, ``auto`` picks the
#: streaming kernel on the card (same switch as the JAX package: memory,
#: not row count).
DENSE_SCORES_MAX_BYTES = 2 << 30  # 2 GiB
#: float32(1 / 127). XLA rewrites the JAX ``/ 127.0`` into a product with
#: this reciprocal; a float32 tensor keeps the product the same on the CPU
#: and the card (PyTorch on the card would fold a Python divisor itself).
INV_127 = np.float32(1.0) / np.float32(127.0)
#: Gallery rows per float64 block of ``int8_scores`` (bounds its memory).
INT8_BLOCK_ROWS = 1 << 18


#: Width of the windows ``l2_normalize_windowed`` sums in.
SUM_WINDOW = 32


def cosine_similarity(a, b) -> float:
    """Scalar cosine similarity of two vectors, 0.0 when either is zero
    (host helper, as the JAX ``cosine_similarity``)."""
    a = np.asarray(a, dtype=np.float32).reshape(-1)
    b = np.asarray(b, dtype=np.float32).reshape(-1)
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def l2_normalize(
    x: torch.Tensor, dim: int = -1, eps: float = 1e-12, *, axis: Optional[int] = None
) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim`` (``axis``, the JAX function's
    name for it, is taken as well)."""
    if axis is not None:
        dim = axis
    n = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(n, min=eps)


def l2_normalize_windowed(x: torch.Tensor) -> torch.Tensor:
    """``l2_normalize`` of (B, D) rows with the sum of squares in a fixed
    order: each window of ``SUM_WINDOW`` columns left to right, then the
    window sums left to right (a ragged last window is padded with zeros,
    which add nothing). This is the order XLA's CPU reduction takes for
    widths that are multiples of 32, so the int8 path's query scales are
    JAX's bits there, and the same bits on the CPU and the card: a reduction
    kernel would pick its own order, and a scale an ulp off moves every
    score of its query."""
    x = x.float()
    sq = x * x
    sq = torch.nn.functional.pad(sq, (0, -sq.shape[1] % SUM_WINDOW))
    windows = sq.reshape(sq.shape[0], -1, SUM_WINDOW)
    total = sum_left(sum_left(windows))
    # float32 sqrt on the CPU can be an ulp off; a float64 root rounded once is not
    norm = torch.sqrt(total.double()).float()
    return x / torch.clamp(norm, min=1e-12)[:, None]


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


def quantize_embeddings_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: ``(codes, scale)`` with
    ``x ≈ codes * (scale / 127)`` row-wise. Codes are ``round(x / max(scale,
    1e-12) * 127)``, half to even, divided by a tensor (a true division on
    the CPU and the card); zero rows get scale 0 and zero codes."""
    x = x.float()
    scale = torch.amax(torch.abs(x), dim=-1)
    safe = torch.clamp(scale, min=1e-12)[:, None]
    return torch.round(x / safe * 127.0).to(torch.int8), scale


def quantize_embeddings_int8_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host (numpy) twin of ``quantize_embeddings_int8``: galleries quantize
    on the host and ship only the codes."""
    x = np.asarray(x, np.float32)
    scale = np.max(np.abs(x), axis=-1)
    safe = np.maximum(scale, 1e-12)[:, None]
    return np.round(x / safe * 127.0).astype(np.int8), scale.astype(np.float32)


def int8_scores(
    q_codes: torch.Tensor, q_scale: torch.Tensor, g_codes: torch.Tensor, g_scale: torch.Tensor
) -> torch.Tensor:
    """Dequantised (B, N) scores ``((float)acc * (q_scale * r)) * (g_scale *
    r)``, r = ``INV_127``, each product rounded in float32 in that order, as
    the JAX graph computes them. ``acc``, the integer product of the codes,
    is taken in float64 in blocks of gallery rows: every partial sum is an
    integer below 2^53, so it is exact on both devices in any order, and it
    is converted to float32 once, as JAX's ``acc.astype(float32)``."""
    r = torch.tensor(INV_127, device=q_codes.device)
    qr = (q_scale.float() * r)[:, None]
    q64 = q_codes.double()
    out = torch.empty((q_codes.shape[0], g_codes.shape[0]), device=q_codes.device)
    for lo in range(0, g_codes.shape[0], INT8_BLOCK_ROWS):
        hi = min(lo + INT8_BLOCK_ROWS, g_codes.shape[0])
        acc = (q64 @ g_codes[lo:hi].double().T).float()
        out[:, lo:hi] = acc * qr * (g_scale[lo:hi].float() * r)[None, :]
    return out


def cosine_topk_int8(
    queries: torch.Tensor,
    gallery_q: torch.Tensor,
    gallery_scale: torch.Tensor,
    k: int = 5,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine matches of queries (B, D) against an int8-quantized
    gallery: codes (N, D) and scales (N,) from ``quantize_embeddings_int8``.

    The queries are L2-normalised (``l2_normalize_windowed``) and quantized
    per row, the scores are
    ``int8_scores``, rows ``>= n_valid`` score -inf (the caller keeps
    ``k <= n_valid``), and the top-k is ``lax.top_k``'s order. This is the
    plain version of ``ops.int8_topk``. Returns (scores, int32 indices),
    (B, k).
    """
    qq, qs = quantize_embeddings_int8(l2_normalize_windowed(queries))
    scores = int8_scores(qq, qs, gallery_q, gallery_scale)
    if n_valid is not None:
        pad = torch.arange(scores.shape[1], device=scores.device) >= n_valid
        scores = scores.masked_fill(pad[None, :], float("-inf"))
    return topk_lowest_index(scores, k)


def compute_prototypes(
    embeddings: torch.Tensor, labels: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """Per-class mean embedding, L2-normalised (zero rows for empty
    classes): (N, D) embeddings with (N,) labels in [0, num_classes) →
    (num_classes, D)."""
    emb = embeddings.float()
    labels = labels.long()
    sums = torch.zeros((num_classes, emb.shape[1]), device=emb.device).index_add_(0, labels, emb)
    counts = torch.zeros(num_classes, device=emb.device).index_add_(
        0, labels, torch.ones(emb.shape[0], device=emb.device)
    )
    means = sums / torch.clamp(counts[:, None], min=1.0)
    norms = torch.sqrt(torch.sum(means * means, dim=-1, keepdim=True))
    return torch.where(norms > 1e-12, means / torch.clamp(norms, min=1e-12), means)


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances ``||a||² + ||b||² - 2ab``, clamped at 0."""
    a, b = a.float(), b.float()
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    with strict_fp32():
        d2 = a2 + b2.T - 2.0 * (a @ b.T)
    return torch.clamp(d2, min=0.0)

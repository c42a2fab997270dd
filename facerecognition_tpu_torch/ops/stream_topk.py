"""Streaming exact top-k cosine search: the wrapper of ``csrc/stream_topk.cu``.

Counterpart of ``facerecognition_tpu/ops/pallas_topk.py``
(``pallas_cosine_topk``): queries and gallery rows are L2-normalised and the
k best gallery rows per query are returned, scores descending with ties to
the lowest index, without the (B, N) score matrix ever reaching device
memory. The queries are normalised here; the kernel divides each score by
its gallery row's norm, which it sums while the row streams through, so the
gallery is read once and not copied.

A tensor on the CPU takes the plain version, ``stream_topk_reference``. A
CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.device import strict_fp32
from facerecognition_tpu_torch.ops.matcher import l2_normalize, topk_lowest_index

MAX_K = 32
#: Score and index of a slot no gallery row fills (k > N), as the Pallas
#: wrapper returns them.
UNFILLED_SCORE = -1e30
UNFILLED_INDEX = 0

#: Kernel launches of ``stream_topk`` (one per call on a CUDA tensor).
launches = _build.LaunchCounter()


def _library() -> ctypes.CDLL:
    lib = _build.load("stream_topk")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.stream_topk_plan.argtypes = [i, i, i, i, ip, ip, ip]
    lib.stream_topk_plan.restype = i
    lib.stream_topk_launch.argtypes = [ptr, ptr, i, i, i, i, i, i, ptr, ptr, ptr, ptr, i, ptr]
    lib.stream_topk_launch.restype = i
    return lib


def stream_topk_reference(
    queries: torch.Tensor, gallery: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: dense scores, then the top-k by (-score, index).

    Slots beyond the gallery size get (``UNFILLED_SCORE``, ``UNFILLED_INDEX``).
    Returns (float32 scores (B, k), int32 indices (B, k)).
    """
    q = l2_normalize(queries.float())
    g = l2_normalize(gallery.float())
    with strict_fp32():
        scores = q @ g.T
    kk = min(k, g.shape[0])
    vals, idx = topk_lowest_index(scores, kk)
    if kk < k:
        b = q.shape[0]
        vals = torch.cat([vals, vals.new_full((b, k - kk), UNFILLED_SCORE)], 1)
        idx = torch.cat([idx, idx.new_full((b, k - kk), UNFILLED_INDEX)], 1)
    return vals, idx


def _check(queries: torch.Tensor, gallery: torch.Tensor, k: int) -> None:
    if queries.device != gallery.device:
        raise ValueError(
            f"queries on {queries.device} but gallery on {gallery.device}"
        )
    for name, t in (("queries", queries), ("gallery", gallery)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    (b, d), (n, dg) = queries.shape, gallery.shape
    if d != dg:
        raise ValueError(f"query width {d} != gallery width {dg}")
    if d % 4:
        raise ValueError(f"embedding width must be a multiple of 4, got {d}")
    if b < 1 or n < 1:
        raise ValueError("need at least one query and one gallery row")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if max(b, n) * d >= 2**31:
        raise ValueError("row count times width must stay below 2**31")


def stream_topk(
    queries: torch.Tensor, gallery: torch.Tensor, k: int = 5
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine matches of queries (B, D) in the gallery (N, D).

    Returns (float32 scores (B, k), int32 indices (B, k)), scores descending,
    ties to the lowest index; slots beyond N hold (-1e30, 0).
    """
    if queries.device.type == "cpu" and gallery.device.type == "cpu":
        return stream_topk_reference(queries, gallery, k)
    _check(queries, gallery, k)
    device = gallery.device
    b, d = queries.shape
    n = gallery.shape[0]
    q = l2_normalize(queries).contiguous()
    lib = _library()
    n_split, rows_per_split, n_cand = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    if lib.stream_topk_plan(
        b, n, k, sm_count,
        ctypes.byref(n_split), ctypes.byref(rows_per_split), ctypes.byref(n_cand),
    ):
        raise ValueError(f"stream_topk cannot plan B={b}, N={n}, k={k}")
    cand_s = torch.empty((b, n_cand.value), dtype=torch.float32, device=device)
    cand_i = torch.empty((b, n_cand.value), dtype=torch.int32, device=device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.stream_topk_launch(
        q.data_ptr(), gallery.data_ptr(), b, n, d, k,
        n_split.value, rows_per_split.value,
        cand_s.data_ptr(), cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        device.index, stream,
    )
    if err:
        raise RuntimeError(f"stream_topk kernel launch failed: CUDA error {err}")
    launches.add()
    return out_s, out_i

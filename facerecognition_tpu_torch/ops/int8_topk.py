"""Exact top-k over an int8-quantized gallery: the wrapper of ``csrc/int8_topk.cu``.

Counterpart of ``facerecognition_tpu/ops/matcher.py``'s ``cosine_topk_int8``,
the capacity mode for galleries of 10^6 rows and more: the gallery is held
as int8 codes plus a float32 scale per row (a quarter of its float32 bytes),
and the (B, N) score matrix never reaches device memory. The queries are
L2-normalised and quantized here, on their device, with the plain version's
own functions (``ops.matcher``), so the kernel and the plain version see
the same codes; the kernel then computes the exact int32 products, the
dequantisation in the plain version's order of roundings and the top-k in
``lax.top_k``'s order, and its result equals the plain version's bit for bit.
The work split is ``ops.stream_topk.plan``.

A tensor on the CPU takes the plain version, ``ops.matcher.
cosine_topk_int8``. A CUDA tensor launches the kernel or raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.ops.matcher import (
    cosine_topk_int8,
    int8_scores,
    l2_normalize_windowed,
    quantize_embeddings_int8,
    topk_lowest_index,
)
from facerecognition_tpu_torch.ops.stream_topk import MAX_K, MAX_ROWS, plan

#: Calls of ``int8_topk_codes`` on CUDA tensors. Each call launches two
#: kernels on the caller's stream: ``int8_partial`` and ``topk_merge``.
launches = _build.LaunchCounter()

#: Row widths in bytes that the kernel's tensor maps take; a narrower
#: multiple of 4 is padded with zero codes per call (see ``_padded``).
ROW_ALIGN = 16


def _library() -> ctypes.CDLL:
    lib = _build.load("int8_topk")
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_topk_launch.argtypes = [
        ptr, ptr, ptr, ll, ptr, i, i, i, i, i, i, i, i, i, ptr, ptr, ptr, ptr, i, ptr,
    ]
    lib.int8_topk_launch.restype = i
    return lib


def int8_topk_codes_reference(
    q_codes: torch.Tensor,
    q_scale: torch.Tensor,
    g_codes: torch.Tensor,
    g_scale: torch.Tensor,
    k: int,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version on codes: ``int8_scores`` of the live rows, then the
    top-k by (-score, index). Returns (float32 (B, k), int32 (B, k))."""
    n = g_codes.shape[0] if n_valid is None else n_valid
    return topk_lowest_index(int8_scores(q_codes, q_scale, g_codes[:n], g_scale[:n]), k)


def _check(q_codes, q_scale, g_codes, g_scale, k: int, n_valid: int) -> None:
    devices = {t.device for t in (q_codes, q_scale, g_codes, g_scale)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    for name, t, dtype, ndim in (
        ("query codes", q_codes, torch.int8, 2),
        ("query scales", q_scale, torch.float32, 1),
        ("gallery codes", g_codes, torch.int8, 2),
        ("gallery scales", g_scale, torch.float32, 1),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim:
            raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    (b, d), (n, dg) = q_codes.shape, g_codes.shape
    if d != dg:
        raise ValueError(f"query width {d} != gallery width {dg}")
    if d % 4 or d < 4:
        raise ValueError(f"embedding width must be a positive multiple of 4, got {d}")
    if q_scale.shape[0] != b or g_scale.shape[0] != n:
        raise ValueError("one scale per row is needed")
    if b < 1 or b > MAX_ROWS:
        raise ValueError(f"need 1 to 2**31 - 1 queries, got {b}")
    if not 1 <= n_valid <= n or n_valid > MAX_ROWS:
        raise ValueError(f"n_valid must be in [1, {n}] and below 2**31, got {n_valid}")
    if not 1 <= k <= min(MAX_K, n_valid):
        raise ValueError(f"k must be in [1, min({MAX_K}, n_valid={n_valid})], got {k}")


def _padded(codes: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` rows, their width padded with zero codes to a
    multiple of ``ROW_ALIGN`` bytes when it is not one (zero codes add
    nothing to the integer products): TMA reads rows whose stride is a
    multiple of 16 bytes. The shipped models' width, 512, needs no copy."""
    d = codes.shape[1]
    if d % ROW_ALIGN == 0:
        return codes
    return F.pad(codes[:rows], (0, -d % ROW_ALIGN))


def int8_topk_codes(
    q_codes: torch.Tensor,
    q_scale: torch.Tensor,
    g_codes: torch.Tensor,
    g_scale: torch.Tensor,
    k: int = 5,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of quantized queries (B, D) int8 with scales (B,) against the
    gallery codes (capacity, D) int8 with scales (capacity,); only rows
    below ``n_valid`` (default: all) are read, and ``k <= n_valid``.

    Returns (float32 scores (B, k), int32 indices (B, k)), scores
    descending, ties to the lowest row, NaN above +inf.
    """
    n_valid = g_codes.shape[0] if n_valid is None else int(n_valid)
    if all(t.device.type == "cpu" for t in (q_codes, q_scale, g_codes, g_scale)):
        return int8_topk_codes_reference(q_codes, q_scale, g_codes, g_scale, k, n_valid)
    _check(q_codes, q_scale, g_codes, g_scale, k, n_valid)
    device = g_codes.device
    b = q_codes.shape[0]
    qq = _padded(q_codes, b)
    gq = _padded(g_codes, n_valid)
    lib = _library()
    p = plan(b, n_valid, k, torch.cuda.get_device_properties(device).multi_processor_count)
    cand = torch.empty((2, b * p.n_cand), dtype=torch.int32, device=device)
    out_s = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)
    err = lib.int8_topk_launch(
        qq.data_ptr(), q_scale.data_ptr(), gq.data_ptr(), gq.stride(0), g_scale.data_ptr(),
        b, n_valid, qq.shape[1], k, p.width, p.groups, p.n_split, p.rows_per_split, p.n_cand,
        cand[0].data_ptr(), cand[1].data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    if err == -1:
        raise ValueError(f"int8_topk kernel refused the plan {p}")
    if err == -2:
        raise RuntimeError("int8_topk: the driver could not encode the TMA tensor maps")
    if err:
        raise RuntimeError(f"int8_topk kernel launch failed: CUDA error {err}")
    launches.add()
    return out_s, out_i


def quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalise and quantize float queries on their device, as the plain
    ``cosine_topk_int8`` does."""
    return quantize_embeddings_int8(l2_normalize_windowed(queries))


def int8_topk(
    queries: torch.Tensor,
    gallery_q: torch.Tensor,
    gallery_scale: torch.Tensor,
    k: int = 5,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_int8`` (float queries (B, D), gallery codes and scales)
    by the kernel on CUDA tensors and by the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (queries, gallery_q, gallery_scale)):
        return cosine_topk_int8(queries, gallery_q, gallery_scale, k, n_valid)
    qq, qs = quantize_queries(queries)
    return int8_topk_codes(qq, qs, gallery_q, gallery_scale, k, n_valid)

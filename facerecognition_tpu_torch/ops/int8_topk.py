"""Exact top-k over an int8-quantized gallery: the wrapper of ``csrc/int8_topk.cu``.

Counterpart of ``facerecognition_tpu/ops/matcher.py``'s ``cosine_topk_int8``,
the capacity mode for galleries of 10^6 rows and more: the gallery is held
as int8 codes plus a float32 scale per row (a quarter of its float32 bytes),
and the (B, N) score matrix never reaches device memory. ``int8_topk`` on
float queries is one call into the library, which launches three kernels
on the caller's stream: ``int8_quantize`` (the plain version's L2
normalisation and quantization, ``quantize_queries``, in its order of
roundings, into a workspace), ``int8_partial`` (the exact int32 products,
the dequantisation in the plain version's order of roundings and a
filtered top-k per split) and ``topk_merge``; no PyTorch operation touches
the queries. Its result equals the plain version's bit for bit. Callers that
hold codes use ``int8_topk_codes``. The work split is ``ops.stream_topk.plan``.

A tensor on the CPU takes the plain version, ``ops.matcher.
cosine_topk_int8``. A CUDA tensor launches the kernels or raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
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

#: Calls that launched kernels on CUDA tensors: ``int8_topk`` launches
#: ``int8_quantize``, ``int8_partial`` and ``topk_merge``;
#: ``int8_topk_codes`` the last two; ``int8_quantize`` the first.
launches = _build.LaunchCounter()

#: The widest query group: at B = 128 two groups of 64 ran about 10% faster
#: than one of 128 on the card (PERF.md), whose epilogue holds twice the
#: elements a thread.
MAX_WIDTH = 64

#: Row widths in bytes that the kernel's tensor maps take; a narrower
#: multiple of 4 is padded with zero codes (see ``_padded``).
ROW_ALIGN = 16

def _library() -> ctypes.CDLL:
    lib = _build.load("int8_topk")
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_topk_launch.argtypes = [
        ptr, ptr, ptr, ptr, ll, ptr, i, i, i, i, i, i, i, i, i, i, ptr, ptr, ptr, ptr, i, ptr,
    ]
    lib.int8_topk_launch.restype = i
    lib.int8_quantize_launch.argtypes = [ptr, i, i, ptr, ptr, i, ptr]
    lib.int8_quantize_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


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


def _check_tensor(name: str, t: torch.Tensor, dtype, ndim: int, rows: bool = False) -> None:
    """A kernel input's type, rank, layout and alignment. With ``rows``, a
    matrix whose rows are contiguous but lie apart (a view of the first
    columns of wider rows, as ``int8_quantize`` gives) is taken too."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not (t.is_contiguous() or (rows and t.stride(-1) == 1 and t.stride(0) >= t.shape[1])):
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_queries(queries: torch.Tensor) -> None:
    """``int8_quantize``'s conditions on float queries."""
    _check_tensor("queries", queries, torch.float32, 2)
    b, d = queries.shape
    if d % 4 or d < 4:
        raise ValueError(f"embedding width must be a positive multiple of 4, got {d}")
    if b < 1 or b > MAX_ROWS:
        raise ValueError(f"need 1 to 2**31 - 1 queries, got {b}")


def _check(queries, q_scale, g_codes, g_scale, k: int, n_valid: int) -> None:
    """The kernels' conditions on their inputs: int8 query codes with their
    scales, or float32 queries when ``q_scale`` is None."""
    tensors = [t for t in (queries, q_scale, g_codes, g_scale) if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    if q_scale is None:
        _check_queries(queries)
    else:
        _check_tensor("query codes", queries, torch.int8, 2, rows=True)
        _check_tensor("query scales", q_scale, torch.float32, 1)
    _check_tensor("gallery codes", g_codes, torch.int8, 2)
    _check_tensor("gallery scales", g_scale, torch.float32, 1)
    (b, d), (n, dg) = queries.shape, g_codes.shape
    if d != dg:
        raise ValueError(f"query width {d} != gallery width {dg}")
    if d % 4 or d < 4:
        raise ValueError(f"embedding width must be a positive multiple of 4, got {d}")
    if (q_scale is not None and q_scale.shape[0] != b) or g_scale.shape[0] != n:
        raise ValueError("one scale per row is needed")
    if b < 1 or b > MAX_ROWS:
        raise ValueError(f"need 1 to 2**31 - 1 queries, got {b}")
    if not 1 <= n_valid <= n or n_valid > MAX_ROWS:
        raise ValueError(f"n_valid must be in [1, {n}] and below 2**31, got {n_valid}")
    if not 1 <= k <= min(MAX_K, n_valid):
        raise ValueError(f"k must be in [1, min({MAX_K}, n_valid={n_valid})], got {k}")


def _padded(codes: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` rows, contiguous, their width padded with zero
    codes to a multiple of ``ROW_ALIGN`` bytes when it is not one (zero
    codes add nothing to the integer products): TMA reads rows whose stride
    is a multiple of 16 bytes. The shipped models' width, 512, needs no
    copy."""
    d = codes.shape[1]
    if d % ROW_ALIGN == 0:
        return codes.contiguous()
    return F.pad(codes[:rows], (0, -d % ROW_ALIGN))


def _launch(queries, q_codes, q_scale, g_codes, g_scale, k: int, n_valid: int):
    """One call into the library: ``int8_quantize`` of float ``queries``
    into the workspace (when given; else ``q_codes``/``q_scale`` are used),
    then ``int8_partial`` and ``topk_merge``."""
    device = g_codes.device
    b = (queries if queries is not None else q_codes).shape[0]
    d = g_codes.shape[1]
    dims = d + (-d % ROW_ALIGN)
    gq = _padded(g_codes, n_valid)
    p = plan(b, n_valid, k, _sm_count(device.index), MAX_WIDTH)
    codes_bytes = _aligned(b * dims) if queries is not None else 0
    scale_bytes = _aligned(b * 4) if queries is not None else 0
    cand_bytes = b * p.n_cand * 4
    ws = torch.empty(codes_bytes + scale_bytes + 2 * cand_bytes, dtype=torch.uint8, device=device)
    base = ws.data_ptr()
    if queries is not None:
        qq, qs = base, base + codes_bytes
    else:
        qq, qs = q_codes.data_ptr(), q_scale.data_ptr()
    cand = base + codes_bytes + scale_bytes
    out_s = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)
    err = _library().int8_topk_launch(
        None if queries is None else queries.data_ptr(), qq, qs, gq.data_ptr(), gq.stride(0),
        g_scale.data_ptr(), b, n_valid, d, dims, k, p.width, p.groups, p.n_split,
        p.rows_per_split, p.n_cand, cand, cand + cand_bytes, out_s.data_ptr(), out_i.data_ptr(),
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
    return _launch(None, _padded(q_codes, q_codes.shape[0]), q_scale, g_codes, g_scale, k, n_valid)


def quantize_queries(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalise and quantize float queries on their device, as the plain
    ``cosine_topk_int8`` does: the plain version of ``int8_quantize``."""
    return quantize_embeddings_int8(l2_normalize_windowed(queries))


def int8_quantize(queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_queries`` of (B, D) float32 queries by the ``int8_quantize``
    kernel on a CUDA tensor (codes (B, D), a view of rows padded to 16
    bytes, which ``int8_topk_codes`` takes; scales (B,)) and by the plain
    version on a CPU tensor."""
    if queries.device.type == "cpu":
        return quantize_queries(queries)
    _check_queries(queries)
    b, d = queries.shape
    codes = torch.empty((b, d + (-d % ROW_ALIGN)), dtype=torch.int8, device=queries.device)
    scales = torch.empty(b, dtype=torch.float32, device=queries.device)
    err = _library().int8_quantize_launch(
        queries.data_ptr(), b, d, codes.data_ptr(), scales.data_ptr(), queries.device.index,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"int8_quantize kernel launch failed: error {err}")
    launches.add()
    return codes[:, :d], scales


def int8_topk(
    queries: torch.Tensor,
    gallery_q: torch.Tensor,
    gallery_scale: torch.Tensor,
    k: int = 5,
    n_valid: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_int8`` (float queries (B, D), gallery codes and scales)
    by the kernels on CUDA tensors (float32 queries, contiguous, 16-byte
    aligned) and by the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (queries, gallery_q, gallery_scale)):
        return cosine_topk_int8(queries, gallery_q, gallery_scale, k, n_valid)
    n_valid = gallery_q.shape[0] if n_valid is None else int(n_valid)
    _check(queries, None, gallery_q, gallery_scale, k, n_valid)
    return _launch(queries, None, None, gallery_q, gallery_scale, k, n_valid)

"""Streaming exact top-k cosine search: the wrapper of ``csrc/stream_topk.cu``.

Counterpart of ``facerecognition_tpu/ops/pallas_topk.py``
(``pallas_cosine_topk``): queries and gallery rows are L2-normalised and the
k best gallery rows per query are returned, scores descending with ties to
the lowest index, without the (B, N) score matrix ever reaching device
memory. The kernel's prologue normalises the queries; its main pass divides
each score by its gallery row's norm, which it sums while the row streams
through, so the gallery is read once and not copied. The work split is
planned here (``plan``) and passed to the kernel.

A tensor on the CPU takes the plain version, ``stream_topk_reference``. A
CUDA tensor launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.device import strict_fp32
from facerecognition_tpu_torch.ops.matcher import l2_normalize, topk_lowest_index

MAX_K = 32
#: Row counts (queries and gallery rows) stay below this: the kernel's row
#: indices are int32; its offsets and split bounds are 64-bit.
MAX_ROWS = 2**31 - 1
#: Score and index of a slot no gallery row fills (k > N), as the Pallas
#: wrapper returns them.
UNFILLED_SCORE = -1e30
UNFILLED_INDEX = 0

#: Calls of ``stream_topk`` on a CUDA tensor. Each call launches three
#: kernels on the caller's stream: ``split_queries``, ``topk_partial`` and
#: ``topk_merge``.
launches = _build.LaunchCounter()

# The kernel's tiling (csrc/stream_topk.cu): a block's two consumer
# warpgroups take 64 gallery rows each of a 128-row tile; the queries are
# cut into groups of one of these widths. The kernel itself chooses its
# ring's depth from the shared memory each width takes.
TILE_ROWS = 128
CONSUMERS = 2
QUERY_WIDTHS = (8, 16, 32, 64, 128)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut: the grid is (n_split, groups)."""

    width: int  # queries per group (the wgmma N), padded with zero rows
    groups: int  # query groups
    n_split: int  # contiguous runs of gallery rows, one block each per group
    rows_per_split: int  # a multiple of TILE_ROWS
    n_cand: int  # candidates per query pass 1 writes and pass 2 reads


def _list_len(k: int) -> int:
    return 8 if k <= 8 else 16 if k <= 16 else 32


@functools.lru_cache(maxsize=256)
def plan(b: int, n: int, k: int, sm_count: int, max_width: int = QUERY_WIDTHS[-1]) -> Plan:
    """Cut B queries x N gallery rows for ``sm_count`` SMs: about one block
    per SM, each over whole 128-row tiles. The widest query group shrinks as
    k grows, so the accumulators and the top-k lists fit the registers, and
    is at most ``max_width``."""
    if b < 1 or n < 1 or not 1 <= k <= MAX_K or sm_count < 1 or max_width not in QUERY_WIDTHS:
        raise ValueError(f"stream_topk cannot plan B={b}, N={n}, k={k}, SMs={sm_count}")
    widest = min(max_width, {8: 128, 16: 64, 32: 32}[_list_len(k)])
    groups = -(-b // widest)
    per_group = -(-b // groups)
    width = next(w for w in QUERY_WIDTHS if w >= per_group)
    n_tiles = -(-n // TILE_ROWS)
    split = max(1, min(n_tiles, -(-sm_count // groups)))
    if n_tiles * TILE_ROWS > MAX_ROWS:  # rows_per_split is a C int
        split = max(split, 2)
    rows_per_split = -(-n_tiles // split) * TILE_ROWS
    n_split = -(-n // rows_per_split)
    return Plan(width, groups, n_split, rows_per_split, n_split * CONSUMERS * k)


def _library() -> ctypes.CDLL:
    lib = _build.load("stream_topk")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.stream_topk_launch.argtypes = [
        ptr, ptr, i, i, i, i, i, i, i, i, i, ptr, ptr, ptr, ptr, ptr, i, ptr,
    ]
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
    if max(b, n) > MAX_ROWS:
        raise ValueError(f"row counts must stay below 2**31, got B={b}, N={n}")


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
    lib = _library()
    p = plan(b, n, k, torch.cuda.get_device_properties(device).multi_processor_count)
    # one scratch: the split queries, then the candidates' scores and indices
    q_elems, c_elems = 2 * p.groups * p.width * d, b * p.n_cand
    scratch = torch.empty(q_elems + 2 * c_elems, dtype=torch.float32, device=device)
    cand_s = scratch[q_elems:q_elems + c_elems].view(torch.int32)  # score keys
    cand_i = scratch[q_elems + c_elems:].view(torch.int32)
    out_s = torch.empty((b, k), dtype=torch.float32, device=device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.stream_topk_launch(
        queries.data_ptr(), gallery.data_ptr(), b, n, d, k,
        p.width, p.groups, p.n_split, p.rows_per_split, p.n_cand,
        scratch.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), device.index, stream,
    )
    if err == -1:
        raise ValueError(f"stream_topk kernel refused the plan {p}")
    if err == -2:
        raise RuntimeError("stream_topk: the driver could not encode the TMA tensor maps")
    if err:
        raise RuntimeError(f"stream_topk kernel launch failed: CUDA error {err}")
    launches.add()
    return out_s, out_i

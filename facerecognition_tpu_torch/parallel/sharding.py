"""Sharded gallery search and the sharding helpers.

Counterpart of ``facerecognition_tpu/parallel/sharding.py``. The (N, D)
gallery is cut row-wise into the mesh's ``gallery`` axis (padded to a
multiple of its size with zero rows); each shard's device takes its local
top-k with the port's kernels, and the candidates are merged:

- float32 rows: ``ops.stream_topk`` over the shard's valid rows (a row
  slice: the kernel has no ``n_valid``);
- int8 codes (``quantize=True``; codes and scales quantised on the host by
  ``quantize_embeddings_int8_np``): ``ops.int8_topk`` with the shard's
  ``n_valid``.

The merge runs first over the process's own shards, then, when a
``torch.distributed`` group of more than one rank is up, over the ranks'
candidates gathered rank-major. It keeps the kernels' total order: score
descending, the lower global index first, NaNs as ``csrc/order_key.cuh``
ranks them (``ops.matcher.order_key``). So every rank's result is
one ``stream_topk`` / ``int8_topk`` over the whole gallery, with JAX's
sentinels: a slot no real row fills (k > n_real) scores -1e30, and every
index is clamped to ``n_real - 1``.

On a CUDA tensor each local top-k launches its kernel (or raises); on the
CPU the wrappers take their plain versions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from facerecognition_tpu_torch.ops.int8_topk import int8_topk
from facerecognition_tpu_torch.ops.matcher import order_key, quantize_embeddings_int8_np
from facerecognition_tpu_torch.ops.stream_topk import stream_topk
from facerecognition_tpu_torch.parallel.collectives import all_gather_cat, broadcast_
from facerecognition_tpu_torch.parallel.mesh import Mesh

#: The score of a slot no real row fills.
SENTINEL = -1e30


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> Sequence[torch.Tensor]:
    """Every rank's copies of ``tensors`` (in place) made rank 0's, when a
    group of more than one rank is up (the mesh's ranks are the group's)."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        for t in tensors:
            broadcast_(t, 0)
    return tensors


def shard_batch(array: torch.Tensor, mesh: Mesh, axis: str = "data") -> list[torch.Tensor]:
    """This process's shards of a batch along ``axis``: for each of its
    positions on the axis, that position's equal slice of the leading
    dimension, on its device."""
    n = mesh.shape[axis]
    if array.shape[0] % n:
        raise ValueError(f"{array.shape[0]} rows do not split over {n} {axis!r} shards")
    rows = array.shape[0] // n
    return [array[p * rows:(p + 1) * rows].to(d.device) for p, d in mesh.local(axis)]


def _local_shards(rows: torch.Tensor, mesh: Mesh, axis: str) -> list[tuple[int, torch.Tensor]]:
    """(global offset, rows on the shard's device) of this process's shards
    of a (N_padded, ...) tensor; a view that is not 16-byte aligned (the
    kernels' condition) is copied."""
    n = mesh.shape[axis]
    if rows.shape[0] % n:
        raise ValueError(f"{rows.shape[0]} gallery rows do not split over {n} {axis!r} shards")
    size = rows.shape[0] // n
    out = []
    for p, d in mesh.local(axis):
        part = rows[p * size:(p + 1) * size]
        if part.device != d.device:
            part = part.to(d.device)
        elif part.data_ptr() % 16:
            part = part.clone()
        out.append((p * size, part))
    return out


def _merge(scores: torch.Tensor, idx: torch.Tensor, k: int):
    """The k best of candidate lists laid out in ascending global order of
    their sources: a stable sort of the kernels' order keys, so equal keys
    keep their positions, the lower position being the lower global index
    (no host synchronisation)."""
    if scores.shape[1] < k:
        raise ValueError(f"k={k} exceeds the {scores.shape[1]} candidates of the shards")
    pos = torch.sort(order_key(scores), dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(scores, 1, pos), torch.gather(idx, 1, pos)


def _sharded_topk(queries, shards, k: int, n_real: int, local_topk):
    """Each shard's local top-k (``local_topk(q, rows, k, valid)``), the
    process's merge, then the ranks' merge; indices clamped to n_real - 1."""
    b = queries.shape[0]
    out_dev = shards[0][1].device
    cand_s, cand_i = [], []
    for offset, rows in shards:
        n_local = rows.shape[0]
        k_local = min(k, n_local)
        valid = max(0, min(n_local, n_real - offset))
        s = torch.full((b, k_local), SENTINEL, device=out_dev)
        i = torch.full((b, k_local), n_real - 1, dtype=torch.int64, device=out_dev)
        if valid:
            kv = min(k_local, valid)
            ls, li = local_topk(queries.to(rows.device), rows, kv, valid)
            s[:, :kv] = ls.to(out_dev)
            i[:, :kv] = li.to(out_dev).long() + offset
        cand_s.append(s)
        cand_i.append(i)
    vals, idx = _merge(torch.cat(cand_s, 1), torch.cat(cand_i, 1), min(k, sum(c.shape[1] for c in cand_s)))
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        world = dist.get_world_size()
        vals = all_gather_cat(vals[None])  # (W, B, k') rank-major
        idx = all_gather_cat(idx[None])
        vals = vals.permute(1, 0, 2).reshape(b, world * vals.shape[2])
        idx = idx.permute(1, 0, 2).reshape(b, world * idx.shape[2])
        vals, idx = _merge(vals, idx, k)
    elif vals.shape[1] < k:
        raise ValueError(f"k={k} exceeds the {vals.shape[1]} candidates of the shards")
    return vals, idx.clamp(0, n_real - 1)


def _f32_topk(q, rows, k, valid):
    return stream_topk(q, rows[:valid], k)


def _int8_topk(q, rows, k, valid):
    codes, scales = rows
    return int8_topk(q, codes, scales, k, n_valid=valid)


class _Int8Rows:
    """A shard of int8 codes with its scales."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor):
        self.codes, self.scales = codes, scales
        self.shape, self.device = codes.shape, codes.device

    def __iter__(self):
        return iter((self.codes, self.scales))


def sharded_topk(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    mesh: Mesh,
    k: int = 5,
    axis: str = "gallery",
    n_real: Optional[int] = None,
):
    """Exact top-k cosine search over a gallery cut row-wise into the
    mesh's ``axis`` (N divisible by its size; rows >= ``n_real`` are
    padding). Every rank passes the whole gallery and searches its own
    shards. Returns (float32 scores (B, k), int64 global indices (B, k))."""
    n_real = gallery.shape[0] if n_real is None else int(n_real)
    return _sharded_topk(queries.float(), _local_shards(gallery, mesh, axis), k, n_real, _f32_topk)


def _int8_shards(codes: torch.Tensor, scales: torch.Tensor, mesh: Mesh, axis: str) -> list:
    return [
        (off, _Int8Rows(c, s))
        for (off, c), (_, s) in zip(_local_shards(codes, mesh, axis), _local_shards(scales, mesh, axis))
    ]


def sharded_topk_int8(
    queries: torch.Tensor,
    gallery_codes: torch.Tensor,
    gallery_scales: torch.Tensor,
    mesh: Mesh,
    k: int = 5,
    axis: str = "gallery",
    n_real: Optional[int] = None,
):
    """``sharded_topk`` over int8 codes (N, D) and scales (N,): the queries
    are normalised and quantised by the kernel (``int8_topk``)."""
    n_real = gallery_codes.shape[0] if n_real is None else int(n_real)
    shards = _int8_shards(gallery_codes, gallery_scales, mesh, axis)
    return _sharded_topk(queries.float(), shards, k, n_real, _int8_topk)


class ShardedGallery:
    """A gallery cut over a mesh axis for searches of a million and more
    identities. The host keeps the names; each process keeps only its own
    shards, on their devices. Rows are padded to a multiple of the axis size
    with zero rows, which never win."""

    def __init__(self, mesh: Mesh, axis: str = "gallery", dim: int = 512, quantize: bool = False):
        self.mesh = mesh
        self.axis = axis
        self.dim = dim
        self.quantize = quantize  # int8 codes: 4x the rows a card holds
        self.names: list[str] = []
        self._shards: list = []
        self._n_real = 0

    def __len__(self) -> int:
        return self._n_real

    @property
    def axis_size(self) -> int:
        return self.mesh.shape[self.axis]

    def set_all(self, names: list[str], matrix: np.ndarray) -> None:
        """Load the whole gallery: L2-normalise (numpy, as JAX), pad, keep
        this process's shards (int8 codes and scales with ``quantize``)."""
        n = len(names)
        matrix = np.asarray(matrix)
        if matrix.shape != (n, self.dim):
            raise ValueError(f"matrix {matrix.shape} for {n} names of width {self.dim}")
        norm = matrix / np.maximum(np.linalg.norm(matrix, axis=1, keepdims=True), 1e-12)
        pad = (-n) % self.axis_size
        if pad:
            norm = np.concatenate([norm, np.zeros((pad, self.dim), norm.dtype)])
        self.names = list(names)
        self._n_real = n
        if self.quantize:
            codes, scale = quantize_embeddings_int8_np(norm)
            self._shards = _int8_shards(
                torch.from_numpy(codes), torch.from_numpy(scale), self.mesh, self.axis
            )
        else:
            rows = torch.from_numpy(np.ascontiguousarray(norm, np.float32))
            self._shards = _local_shards(rows, self.mesh, self.axis)

    def topk(self, queries, k: int = 5):
        """The global top-``min(k, len)`` (numpy scores, indices); an empty
        gallery gives (B, 0) arrays."""
        b = len(queries)
        if self._n_real == 0 or not self._shards:
            return np.zeros((b, 0)), np.zeros((b, 0), int)
        q = torch.as_tensor(np.asarray(queries, np.float32))
        k_eff = min(k, self._n_real)
        fn = _int8_topk if self.quantize else _f32_topk
        s, i = _sharded_topk(q, self._shards, k_eff, self._n_real, fn)
        return s.cpu().numpy(), i.cpu().numpy()

"""Chi-square nearest neighbour: the wrapper of ``csrc/chi2_nn.cu`` and its
plain version.

``chi2_nn`` computes, for (B, F) query histograms against (N, F) gallery
histograms, the HISTCMP_CHISQR_ALT distance of the JAX package's
``chi2_alt_distances`` (``models/lbph.py``), ``2·Σ_f where(q+g > 0,
(q−g)² / max(q+g, 1e-20), 0)``, and each query's nearest row: its distance
and its index, the lowest index on equal distances (``np.argmin``; NaN
first, as numpy). Optionally also the (B, N) distances.

The kernel sums each row's terms in a fixed order, whatever the row's place
in the gallery (``chi2_distances_kernel_order`` repeats it), so two equal
rows give equal distances and the tie goes to the lower index. Against the
plain version, which sums in PyTorch's order, distances agree to ~1e-6
relative.

A tensor on the CPU takes the plain version. A CUDA tensor launches the
kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from facerecognition_tpu_torch import _build

#: Kernel calls (each launches the distance kernel and the merge).
launches = _build.LaunchCounter()

#: Terms the kernel sums into one partial before adding it to the row's
#: total (``csrc/chi2_nn.cu``'s ``KF``).
CHUNK = 32
#: Gallery rows and queries of one block (``TN`` and ``TB``).
TILE_ROWS, TILE_QUERIES = 128, 32
#: (B, rows, F) elements the plain version holds at a time.
PLAIN_ELEMENTS = 1 << 25


def _terms(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, 1, F) and (1, n, F) → the (B, n, F) chi-square-alt terms."""
    num = (q - g) ** 2
    den = q + g
    return torch.where(den > 0, num / torch.clamp(den, min=1e-20), torch.zeros((), device=q.device))


def chi2_alt_distances(query: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(F,) query, (N, F) gallery → (N,) float32 distances."""
    return chi2_distances(query[None], gallery)[0]


def chi2_distances(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(B, F) queries, (N, F) gallery → (B, N) float32 distances, in row
    chunks of at most ``PLAIN_ELEMENTS`` terms."""
    q = queries.float()[:, None, :]
    g = gallery.float()
    b, f = queries.shape
    rows = max(1, PLAIN_ELEMENTS // max(1, b * f))
    out = torch.empty((b, g.shape[0]), dtype=torch.float32, device=g.device)
    for n0 in range(0, g.shape[0], rows):
        out[:, n0 : n0 + rows] = 2.0 * _terms(q, g[None, n0 : n0 + rows]).sum(-1)
    return out


def chi2_distances_kernel_order(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(B, N) distances summed in the kernel's order: per row, the terms of
    each ``CHUNK`` features left to right into a partial, the partials left
    to right into the total, times 2. Features past F count as zero terms."""
    q = queries.float()
    g = gallery.float()
    f = q.shape[1]
    pad = (-f) % CHUNK
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
        g = torch.nn.functional.pad(g, (0, pad))
    b, n = q.shape[0], g.shape[0]
    terms = _terms(q[:, None, :], g[None]).reshape(b, n, -1, CHUNK)
    part = terms[..., 0]
    for k in range(1, CHUNK):
        part = part + terms[..., k]
    total = torch.zeros((b, n), dtype=torch.float32, device=g.device)
    for c in range(part.shape[-1]):
        total = total + part[..., c]
    return 2.0 * total


def nearest(dists: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's minimum and its index, lowest index first, NaN first (as
    ``np.argmin``; distances are never -inf): (B,) float32, (B,) int64."""
    key = torch.where(torch.isnan(dists), torch.full_like(dists, float("-inf")), dists)
    idx = torch.argmin(key, dim=1)  # the first of equal minima
    return torch.gather(dists, 1, idx[:, None])[:, 0], idx


def chi2_nn_plain(
    queries: torch.Tensor, gallery: torch.Tensor, return_distances: bool = False
):
    d = chi2_distances(queries, gallery)
    best, idx = nearest(d)
    return (best, idx, d) if return_distances else (best, idx)


# -- the wrapper ----------------------------------------------------------------


def _library() -> ctypes.CDLL:
    lib = _build.load("chi2_nn")
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.chi2_nn_launch.argtypes = [ptr, ptr, i, ll, i, ptr, ptr, ptr, ptr, ptr, i, ptr]
    lib.chi2_nn_launch.restype = i
    return lib


def chi2_nn(
    queries: torch.Tensor, gallery: torch.Tensor, return_distances: bool = False
):
    """(B, F) queries, (N, F) gallery, float32 → each query's nearest
    distance (B,) float32 and row (B,) int64, and with ``return_distances``
    the (B, N) distances."""
    if queries.device.type == "cpu" and gallery.device.type == "cpu":
        return chi2_nn_plain(queries, gallery, return_distances)
    for name, t in (("queries", queries), ("gallery", gallery)):
        if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")
    if queries.device != gallery.device:
        raise ValueError(f"queries on {queries.device}, gallery on {gallery.device}")
    b, f = queries.shape
    n = gallery.shape[0]
    if gallery.shape[1] != f or b < 1 or n < 1 or f < 1:
        raise ValueError(f"cannot match {tuple(queries.shape)} against {tuple(gallery.shape)}")
    dev = queries.device
    tiles = -(-n // TILE_ROWS)
    best = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int64, device=dev)
    dists: Optional[torch.Tensor] = (
        torch.empty((b, n), dtype=torch.float32, device=dev) if return_distances else None
    )
    part_val = torch.empty((b, tiles), dtype=torch.float32, device=dev)
    part_idx = torch.empty((b, tiles), dtype=torch.int32, device=dev)
    err = _library().chi2_nn_launch(
        queries.data_ptr(), gallery.data_ptr(), b, n, f,
        None if dists is None else dists.data_ptr(), best.data_ptr(), idx.data_ptr(),
        part_val.data_ptr(), part_idx.data_ptr(),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err == -1:
        raise ValueError("chi2_nn kernel refused its arguments")
    if err:
        raise RuntimeError(f"chi2_nn kernel launch failed: CUDA error {err}")
    launches.add()
    return (best, idx, dists) if return_distances else (best, idx)

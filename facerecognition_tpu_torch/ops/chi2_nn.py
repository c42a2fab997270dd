"""Chi-square nearest neighbour: the wrapper of ``csrc/chi2_nn.cu`` and its
plain version.

``chi2_nn`` computes, for (B, F) query histograms against (N, F) gallery
histograms, the HISTCMP_CHISQR_ALT distance of the JAX package's
``chi2_alt_distances`` (``models/lbph.py``), ``2·Σ_f where(q+g > 0,
(q−g)² / max(q+g, 1e-20), 0)``, and each query's nearest row: its distance
and its index, the lowest index on equal distances (``np.argmin``; NaN
first, as numpy). Optionally also the (B, N) distances.

The kernels sum each row's terms in a fixed order, whatever the row's place
in the gallery (``chi2_distances_kernel_order`` repeats it), so two equal
rows give equal distances and the tie goes to the lower index. Against the
plain version, which sums in PyTorch's order, distances agree to ~1e-6
relative. They visit only the bins that are non-zero on one side at least
(``chi2_row_stats``: per row a mask of them per 32 features, and its sum);
the nearest row comes from a filter over the bins non-zero on both sides
and an exact rescoring of the rows it cannot rule out, with bounds whose
constants ``filter_margin`` gives and whose arithmetic ``filter_bounds``
repeats (the derivation is in ``csrc/chi2_nn.cu``).

A tensor on the CPU takes the plain version. A CUDA tensor launches the
kernels or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from facerecognition_tpu_torch import _build

#: Kernel calls: each launches the queries' stats and either the filter and
#: the rescoring or, with ``return_distances``, the exact pass and the merge.
launches = _build.LaunchCounter()
#: ``chi2_row_stats`` calls on CUDA tensors (one kernel each).
stats_launches = _build.LaunchCounter()

#: Terms the kernels sum into one partial before adding it to the row's
#: total, and the features of one mask word (``csrc/chi2_nn.cu``'s ``KF``).
CHUNK = 32
#: (B, rows, F) elements the plain version holds at a time.
PLAIN_ELEMENTS = 1 << 25
#: A row is regular when every bin is 0 or in [2^-60, 2^60]; the filter's
#: bounds hold for regular rows and pairs (``csrc/chi2_nn.cu``).
REGULAR_MIN, REGULAR_MAX = 2.0**-60, 2.0**60


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


def row_stats_plain(x: torch.Tensor, rows: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, F) rows → their masks (N, ceil(F / 32)) int32, bit k of word c
    set where feature 32c + k is not 0 (NaN and ±inf count), and their sums
    (N,) float64, NaN for a row that is not regular; ``rows`` rows at a
    time."""
    n, f = x.shape
    masks = torch.empty((n, -(-f // CHUNK)), dtype=torch.int32, device=x.device)
    sums = torch.empty(n, dtype=torch.float64, device=x.device)
    bits = torch.arange(CHUNK, dtype=torch.int32, device=x.device)
    for n0 in range(0, n, rows):
        part = x[n0 : n0 + rows].float()
        nz = torch.nn.functional.pad(part != 0, (0, (-f) % CHUNK)).reshape(part.shape[0], -1, CHUNK)
        # distinct bits, bit 31 as -2^31: their int32 sum is their OR, never overflowing
        masks[n0 : n0 + rows] = (nz.int() << bits).sum(-1, dtype=torch.int32)
        regular = ((part == 0) | ((part >= REGULAR_MIN) & (part <= REGULAR_MAX))).all(1)
        sums[n0 : n0 + rows] = torch.where(regular, part.sum(1, dtype=torch.float64),
                                           torch.full((), float("nan"), dtype=torch.float64,
                                                      device=x.device))
    return masks, sums


def filter_margin(f: int) -> tuple[float, float, float, float]:
    """The constants of the filter's bounds at F = ``f`` (``csrc/chi2_nn.cu``
    derives them): (rel, abs0, down, up), where |d' − d| ≤ rel·T + abs0
    and the fixed-order distance lies in [max(0, d' − rel·T − abs0)·down −
    abs0, (d' + rel·T + abs0)·up + abs0], with a relative slack of 1e-4."""
    chunks = -(-f // CHUNK)

    def gamma(n: int, u: float) -> float:
        return n * u / (1.0 - n * u)

    u, ud, slack = 2.0**-24, 2.0**-53, 1.0 + 1e-4
    rel = (2.0 * gamma(40 + chunks, u) + 2.0 * gamma(f + 3, ud)) * slack
    exact = gamma(35 + chunks, u) * slack
    return rel, f * 2.0**-80, 1.0 - exact, 1.0 + exact


def filter_bounds(p: torch.Tensor, sq: torch.Tensor, sg: torch.Tensor, margin) -> tuple:
    """The kernels' float64 bounds (``bounds_of``) on the fixed-order distance
    from the filter's float32 P and the rows' sums: (lo, hi), (-inf, inf)
    where d' is not finite. Broadcasts."""
    rel, abs0, down, up = margin
    t = sq + sg
    dp = 2.0 * (t - 4.0 * p.double())
    m = t * rel + abs0
    lo = torch.clamp(dp - m, min=0.0) * down - abs0
    hi = (dp + m) * up + abs0
    finite = torch.isfinite(dp)
    return (torch.where(finite, lo, -torch.inf), torch.where(finite, hi, torch.inf))


def chi2_nn_plain(
    queries: torch.Tensor, gallery: torch.Tensor, return_distances: bool = False
):
    d = chi2_distances(queries, gallery)
    best, idx = nearest(d)
    return (best, idx, d) if return_distances else (best, idx)


# -- the wrapper ----------------------------------------------------------------


class _Args(ctypes.Structure):
    """``struct Chi2Args`` of ``csrc/chi2_nn.cu``, field for field."""

    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "q", "g", "qmask", "qsum", "gmask", "gsum", "dists", "best", "idx", "part_val",
            "part_idx", "filt", "tile_hi", "tile_lo", "candidates",
        )),
        ("N", ctypes.c_longlong),
        *((name, ctypes.c_int) for name in ("B", "F", "C", "exact")),
        *((name, ctypes.c_double) for name in ("rel", "abs0", "down", "up")),
    ]


def _library() -> ctypes.CDLL:
    lib = _build.load("chi2_nn")
    ptr, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.chi2_nn_launch.argtypes = [ctypes.POINTER(_Args), i, ptr]
    lib.chi2_nn_launch.restype = i
    lib.chi2_stats_launch.argtypes = [ptr, ll, i, ptr, ptr, i, ptr]
    lib.chi2_stats_launch.restype = i
    lib.chi2_tile_rows.restype = i
    lib.chi2_rescore_split.restype = i
    return lib


def _check(err: int, what: str) -> None:
    if err == -1:
        raise ValueError(f"{what} kernel refused its arguments")
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _float_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D float32 tensor")


def chi2_row_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, F) float32 rows → (masks (N, ceil(F / 32)) int32, sums (N,)
    float64): ``row_stats_plain``'s, by a kernel on a CUDA tensor (sums in
    another order: within float64 roundings)."""
    if x.device.type == "cpu":
        return row_stats_plain(x)
    _float_rows("rows", x)
    n, f = x.shape
    masks = torch.empty((n, -(-f // CHUNK)), dtype=torch.int32, device=x.device)
    sums = torch.empty(n, dtype=torch.float64, device=x.device)
    if n == 0:
        return masks, sums
    _check(_library().chi2_stats_launch(
        x.data_ptr(), n, f, masks.data_ptr(), sums.data_ptr(), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream), "chi2_stats")
    stats_launches.add()
    return masks, sums


def chi2_nn(
    queries: torch.Tensor,
    gallery: torch.Tensor,
    return_distances: bool = False,
    gallery_stats: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    candidates: Optional[torch.Tensor] = None,
):
    """(B, F) queries, (N, F) gallery, float32 → each query's nearest
    distance (B,) float32 and row (B,) int64, and with ``return_distances``
    the (B, N) distances. ``gallery_stats`` is ``chi2_row_stats(gallery)``
    (computed in the call when not given); ``candidates``, a (B,) int32
    tensor on the card, receives the rows each query rescored (not with
    ``return_distances``)."""
    if queries.device.type == "cpu" and gallery.device.type == "cpu":
        return chi2_nn_plain(queries, gallery, return_distances)
    _float_rows("queries", queries)
    _float_rows("gallery", gallery)
    if queries.device != gallery.device:
        raise ValueError(f"queries on {queries.device}, gallery on {gallery.device}")
    b, f = queries.shape
    n = gallery.shape[0]
    if gallery.shape[1] != f or b < 1 or n < 1 or f < 1:
        raise ValueError(f"cannot match {tuple(queries.shape)} against {tuple(gallery.shape)}")
    dev = queries.device
    lib = _library()
    chunks, tiles = -(-f // CHUNK), -(-n // lib.chi2_tile_rows())
    gmask, gsum = chi2_row_stats(gallery) if gallery_stats is None else gallery_stats
    if (gmask.shape != (n, chunks) or gmask.dtype != torch.int32 or gsum.shape != (n,)
            or gsum.dtype != torch.float64 or gmask.device != dev or gsum.device != dev
            or not gmask.is_contiguous()):
        raise ValueError("gallery_stats must be chi2_row_stats(gallery)")
    if candidates is not None and (candidates.shape != (b,) or candidates.dtype != torch.int32
                                   or candidates.device != dev):
        raise ValueError("candidates must be a (B,) int32 tensor beside the queries")

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    best, idx = empty(b), empty(b, torch.int64)
    qmask, qsum = empty((b, chunks), torch.int32), empty(b, torch.float64)
    if return_distances:  # chi2_exact's nearest row per tile, merged
        work = {"dists": empty((b, n)), "part_val": empty((b, tiles)),
                "part_idx": empty((b, tiles), torch.int32)}
    else:  # chi2_filter's P and bounds; chi2_rescore's nearest row per block, merged
        split = lib.chi2_rescore_split()
        work = {"filt": empty((b, n)), "tile_hi": empty((b, tiles), torch.float64),
                "tile_lo": empty((b, tiles), torch.float64), "part_val": empty((b, split)),
                "part_idx": empty((b, split), torch.int32)}
        if candidates is not None:
            work["candidates"] = candidates
    rel, abs0, down, up = filter_margin(f)
    args = _Args(
        q=queries.data_ptr(), g=gallery.data_ptr(), qmask=qmask.data_ptr(),
        qsum=qsum.data_ptr(), gmask=gmask.data_ptr(), gsum=gsum.data_ptr(),
        best=best.data_ptr(), idx=idx.data_ptr(),
        **{k: t.data_ptr() for k, t in work.items()},
        N=n, B=b, F=f, C=chunks, exact=int(return_distances),
        rel=rel, abs0=abs0, down=down, up=up,
    )
    _check(lib.chi2_nn_launch(
        ctypes.byref(args), dev.index, torch.cuda.current_stream(dev).cuda_stream), "chi2_nn")
    launches.add()
    return (best, idx, work["dists"]) if return_distances else (best, idx)

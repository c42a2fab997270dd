"""LBPH features: the wrapper of ``csrc/lbph_hist.cu`` and its plain version.

``lbph_hist`` computes, for (B, H, W) float32 gray images, what the JAX
package's ``lbph_features`` (``models/lbph.py``: ``lbp_code_image`` then
``spatial_histogram``) computes per image: the circular, bilinearly sampled
LBP code of every interior pixel, and each cell's 2^P-bin histogram times
the reciprocal of the cell's pixel count, cells row-major, remainder pixels
dropped. (B, grid_y·grid_x·2^P) float32.

Bits, not only values: a diagonal tap ``w1·a + w2·b + w3·c + w4·d`` misses
the centre of a flat region by ~1e-5 at 200, far above the bit test's eps,
so the code depends on how the sum rounds. ``tap_plan`` rebuilds the graph
XLA's CPU backend compiles: weights rounded to float32, products by 1
dropped, identical products shared between neighbours, and LLVM's
contraction of an add into a fused multiply-add, which takes a product
only where that product has no other use (the left one first). Both
versions here follow the plan, so the codes are JAX's bit for bit. The
histogram is an integer count; XLA turns the division by the pixel count
into a product with its float32 reciprocal, and so do both versions.

A tensor on the CPU takes the plain version. A CUDA tensor launches the
kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.ops.umeyama import fma

#: Kernel launches (one per call on a CUDA tensor).
launches = _build.LaunchCounter()

#: Neighbours the kernel takes (codes up to 2^16 bins per cell).
MAX_NEIGHBORS = 16
#: How a neighbour's running sum takes its next term (``TapPlan.ops``).
ADD, FMA_LEFT, FMA_RIGHT = 0, 1, 2
_EPS = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class TapPlan:
    """Per neighbour n: four taps at ``offsets[n][i]`` (dy, dx) weighted by
    float32 ``weights[n][i]``, summed in three steps. ``ops[n][0]`` joins
    terms 0 and 1: ``ADD`` (both products rounded, then added),
    ``FMA_LEFT`` (fma(w0, tap0, w1·tap1)) or ``FMA_RIGHT`` (fma(w1, tap1,
    w0·tap0)); ``ops[n][1]``/``[2]`` add term 2, then 3, to the sum:
    ``ADD`` or ``FMA_RIGHT`` (fma(w, tap, sum))."""

    offsets: tuple
    weights: tuple
    ops: tuple


@lru_cache(maxsize=None)
def tap_plan(radius: int, neighbors: int) -> TapPlan:
    """The plan of XLA's CPU graph of ``lbp_code_image(radius, neighbors)``."""
    taps = []
    for n in range(neighbors):
        x = radius * math.cos(2.0 * math.pi * n / neighbors)
        y = -radius * math.sin(2.0 * math.pi * n / neighbors)
        fx, fy = math.floor(x), math.floor(y)
        cx, cy = math.ceil(x), math.ceil(y)
        tx, ty = x - fx, y - fy
        ws = [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty]
        taps.append(list(zip(((fy, fx), (fy, cx), (cy, fx), (cy, cx)), map(np.float32, ws))))

    def term(off, w):  # a product by 1 is dropped; equal products are one node
        return ("tap", off) if w == 1.0 else ("mul", off, w.tobytes())

    sums = {}
    for t in taps:
        s1 = ("add", term(*t[0]), term(*t[1]))
        s2 = ("add", s1, term(*t[2]))
        for s in (s1, s2, ("add", s2, term(*t[3]))):
            sums[s] = None
    uses: dict = {}
    for s in sums:
        for operand in s[1:]:
            uses[operand] = uses.get(operand, 0) + 1

    def single(node) -> bool:
        return node[0] == "mul" and uses[node] == 1

    ops = []
    for t in taps:
        a, b, c, d = (term(*x) for x in t)
        ops.append((
            FMA_LEFT if single(a) else FMA_RIGHT if single(b) else ADD,
            FMA_RIGHT if single(c) else ADD,
            FMA_RIGHT if single(d) else ADD,
        ))
    return TapPlan(
        tuple(tuple(off for off, _ in t) for t in taps),
        tuple(tuple(float(w) for _, w in t) for t in taps),
        tuple(ops),
    )


# -- plain versions ---------------------------------------------------------------


def _f64(w: float) -> torch.Tensor:
    """A weight as a float64 scalar tensor, for ``ops.umeyama.fma``."""
    return torch.tensor(w, dtype=torch.float64)


def lbp_code_image(gray: torch.Tensor, radius: int = 1, neighbors: int = 8) -> torch.Tensor:
    """Extended LBP codes of (..., H, W) gray images: (..., H - 2r, W - 2r)
    int32 in [0, 2^neighbors), summed as ``tap_plan`` says."""
    img = gray.float()
    h, w = img.shape[-2:]
    r = radius
    plan = tap_plan(radius, neighbors)

    def tap(dy, dx):
        return img[..., r + dy : h - r + dy, r + dx : w - r + dx]

    center = tap(0, 0)
    code = torch.zeros(center.shape, dtype=torch.int32, device=img.device)
    for n in range(neighbors):
        (o0, o1, o2, o3), (w0, w1, w2, w3), (op0, op1, op2) = (
            plan.offsets[n], plan.weights[n], plan.ops[n]
        )
        a, b = tap(*o0), tap(*o1)
        if op0 == FMA_LEFT:
            t = fma(a, _f64(w0), b * w1)
        elif op0 == FMA_RIGHT:
            t = fma(b, _f64(w1), a * w0)
        else:
            t = a * w0 + b * w1
        for op, off, wk in ((op1, o2, w2), (op2, o3, w3)):
            t = fma(tap(*off), _f64(wk), t) if op == FMA_RIGHT else t + tap(*off) * wk
        bit = (t > center) | ((t - center).abs() < _EPS)
        code |= bit.int() << n
    return code


def cell_size(h: int, w: int, radius: int, grid_x: int, grid_y: int) -> tuple[int, int]:
    """(rows, cols) of a histogram cell of an (h, w) image's code image."""
    ch, cw = (h - 2 * radius) // grid_y, (w - 2 * radius) // grid_x
    if ch < 1 or cw < 1:
        raise ValueError(
            f"a {h}x{w} image at radius {radius} has no pixel in a cell of a "
            f"{grid_y}x{grid_x} grid"
        )
    return ch, cw


def _reciprocal(n: int) -> float:
    """float32(1 / n): XLA folds the division by the pixel count into a
    product with it."""
    return float(np.float32(1.0) / np.float32(n))


def spatial_histogram(
    code: torch.Tensor, grid_x: int = 8, grid_y: int = 8, num_patterns: int = 256
) -> torch.Tensor:
    """Cell histograms of (..., H, W) code images, concatenated row-major:
    (..., grid_y·grid_x·num_patterns) float32, each cell's counts times
    float32(1 / its pixel count); remainder pixels dropped."""
    h, w = code.shape[-2:]
    ch, cw = h // grid_y, w // grid_x
    lead = code.shape[:-2]
    cells = code[..., : ch * grid_y, : cw * grid_x].reshape(-1, grid_y, ch, grid_x, cw)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(cells.shape[0], grid_y * grid_x, ch * cw)
    offset = torch.arange(grid_y * grid_x, device=code.device)[None, :, None] * num_patterns
    counts = torch.zeros(
        (cells.shape[0], grid_y * grid_x * num_patterns), dtype=torch.float32, device=code.device
    )
    bins = (cells.long() + offset).flatten(1)
    counts.scatter_add_(1, bins, torch.ones(bins.shape, dtype=torch.float32, device=code.device))
    inv = torch.tensor(_reciprocal(ch * cw), device=code.device)
    return (counts * inv).reshape(*lead, -1)


def lbph_features_plain(
    images: torch.Tensor, radius: int = 1, neighbors: int = 8, grid_x: int = 8, grid_y: int = 8
) -> torch.Tensor:
    """(B, H, W) gray images → (B, grid_y·grid_x·2^neighbors) histograms."""
    cell_size(images.shape[-2], images.shape[-1], radius, grid_x, grid_y)
    code = lbp_code_image(images, radius, neighbors)
    return spatial_histogram(code, grid_x, grid_y, 2**neighbors)


# -- the wrapper ----------------------------------------------------------------


class _Args(ctypes.Structure):
    """``struct LbphArgs`` of ``csrc/lbph_hist.cu``, field for field."""

    _fields_ = [
        ("images", ctypes.c_void_p),
        ("plan", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        *((name, ctypes.c_int) for name in (
            "B", "H", "W", "radius", "neighbors", "grid_x", "grid_y", "cell_h", "cell_w",
        )),
        ("inv_cell", ctypes.c_float),
    ]


@lru_cache(maxsize=None)
def plan_words(radius: int, neighbors: int) -> np.ndarray:
    """``tap_plan`` as the kernel reads it: (neighbors, 16) int32, per
    neighbour dy[4], dx[4], the weights' float32 bits[4], ops[3], 0
    (read-only: cached)."""
    plan = tap_plan(radius, neighbors)
    words = np.zeros((neighbors, 16), np.int32)
    for n in range(neighbors):
        words[n, 0:4] = [dy for dy, _ in plan.offsets[n]]
        words[n, 4:8] = [dx for _, dx in plan.offsets[n]]
        words[n, 8:12] = np.asarray(plan.weights[n], np.float32).view(np.int32)
        words[n, 12:15] = plan.ops[n]
    words.flags.writeable = False
    return words


def _library() -> ctypes.CDLL:
    lib = _build.load("lbph_hist")
    lib.lbph_hist_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.lbph_hist_launch.restype = ctypes.c_int
    return lib


def lbph_hist(
    images: torch.Tensor, radius: int = 1, neighbors: int = 8, grid_x: int = 8, grid_y: int = 8
) -> torch.Tensor:
    """(B, H, W) float32 gray images → (B, grid_y·grid_x·2^neighbors)
    float32 LBPH features, equal bit for bit to ``lbph_features_plain``."""
    if images.device.type == "cpu":
        return lbph_features_plain(images, radius, neighbors, grid_x, grid_y)
    if images.dtype != torch.float32 or images.ndim != 3 or not images.is_contiguous():
        raise ValueError(
            f"images must be a contiguous (B, H, W) float32 tensor, got "
            f"{tuple(images.shape)} {images.dtype}"
        )
    if not 1 <= neighbors <= MAX_NEIGHBORS or radius < 1:
        raise ValueError(f"the kernel takes radius >= 1 and 1-{MAX_NEIGHBORS} neighbours")
    b, h, w = images.shape
    ch, cw = cell_size(h, w, radius, grid_x, grid_y)
    bins = 2**neighbors
    out = torch.empty((b, grid_y * grid_x * bins), dtype=torch.float32, device=images.device)
    if b == 0:
        return out
    dev = images.device
    plan = plan_words(radius, neighbors)  # read by the launcher on the host
    args = _Args(
        images=images.data_ptr(), plan=plan.ctypes.data, out=out.data_ptr(), B=b, H=h, W=w,
        radius=radius, neighbors=neighbors, grid_x=grid_x, grid_y=grid_y, cell_h=ch, cell_w=cw, inv_cell=_reciprocal(ch * cw),
    )
    err = _library().lbph_hist_launch(
        ctypes.byref(args), dev.index, torch.cuda.current_stream(dev).cuda_stream
    )
    if err == -1:
        raise ValueError("lbph_hist kernel refused its arguments")
    if err:
        raise RuntimeError(f"lbph_hist kernel launch failed: CUDA error {err}")
    launches.add()
    return out

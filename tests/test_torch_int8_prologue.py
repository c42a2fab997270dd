"""The int8 kernel's two new procedures, mirrored in numpy on the CPU.

``csrc/int8_topk.cu`` runs only on the card, where ``chip_smoke.py`` holds
it bit for bit against its plain versions. Here:

- ``int8_quantize``'s arithmetic, written element by element in the
  kernel's order (squares, each 32-column window summed left to right, the
  window sums left to right, a float64 root rounded once, true divisions, a
  max that keeps NaN, half-to-even codes, code 0 for NaN), must equal the
  plain ``quantize_queries`` and JAX's ``quantize_embeddings_int8(
  l2_normalize(x))`` bit for bit, codes and scales;
- ``int8_partial``'s filtered fold (ping-pong consumers over whole 128-row
  tiles, a per-query k-th key taken before each tile and its float
  threshold as a first test, a bound from the tile's own rows in a
  consumer's first tile, after an overflow and in every tile after an
  overflow past a consumer's first tile, compaction buffers of
  ``cap`` entries filled in any order, further rounds against the updated
  lists) followed by the merge must equal ``int8_topk_codes_reference``
  exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.ops import matcher as jm
from facerecognition_tpu_torch.ops import int8_topk as it
from facerecognition_tpu_torch.ops import matcher as m
from facerecognition_tpu_torch.ops import stream_topk as st

F32 = np.float32
TILE_ROWS = 128  # csrc/int8_topk.cu
BUF_ENTRIES = 2016
UNFILLED = (-1e30, 0)


def quantize_mirror(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``int8_quantize`` on (B, D) float32 rows, one element at a time in the
    kernel's order (vectorised over rows only)."""
    x = np.asarray(x, F32)
    b, d = x.shape
    total = np.zeros(b, F32)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        for w in range(0, d, 32):
            part = np.zeros(b, F32)
            for j in range(w, min(d, w + 32)):
                part = part + x[:, j] * x[:, j]
            total = total + part
        norm = np.sqrt(total.astype(np.float64)).astype(F32)
        safe = np.where(norm < F32(1e-12), F32(1e-12), norm)  # a NaN stays
        y = x / safe[:, None]
        scale = np.zeros(b, F32)
        for j in range(d):
            a = np.abs(y[:, j])
            scale = np.where((a > scale) | np.isnan(a), a, scale)
        qsafe = np.where(scale < F32(1e-12), F32(1e-12), scale)
        c = (y / qsafe[:, None]) * F32(127.0)
        codes = np.where(np.isnan(c), F32(0), np.rint(c)).astype(np.int8)
    return codes, scale


def _tie_row(d: int, odd=(1, 3, 5, 7)) -> np.ndarray:
    """Integer entries whose squares sum to a power of 4, so the normalised
    row is exact, with a maximum of 254 and entries 2n + 1 whose codes are
    exactly n + 0.5 before rounding (half to even sends them both ways)."""
    row = np.zeros(d, np.int64)
    vals = [254, *odd]
    rest = 4 ** 9 - sum(v * v for v in vals)
    while rest:
        v = min(254, int(np.sqrt(rest)))
        vals.append(v)
        rest -= v * v
    assert len(vals) <= d
    row[: len(vals)] = vals
    return row.astype(F32)


def _edge_rows(rng, d: int) -> np.ndarray:
    x = rng.normal(size=(24, d)).astype(F32)
    x[1] = 0.0  # zero row: scale 0, zero codes
    x[2, 3] = np.nan  # NaN row
    x[3, 5] = np.inf
    x[4, 0] = -np.inf
    x[5] = _tie_row(d)
    x[6] = -_tie_row(d, (9, 11, 13))
    x[7] *= 1e-20  # squares below the normal range
    x[8] *= 1e19  # squares that overflow to inf
    x[9, :] = 0.0
    x[9, d - 1] = 3.0  # one nonzero in a ragged last window
    return x


@pytest.mark.parametrize("d", [96, 128, 132, 512])
def test_quantize_mirror_equals_plain(rng, d):
    x = _edge_rows(rng, d)
    mq, ms = quantize_mirror(x)
    pq, ps = it.quantize_queries(torch.from_numpy(x))
    np.testing.assert_array_equal(mq, pq.numpy())
    np.testing.assert_array_equal(ms, ps.numpy())  # NaN where the plain scale is NaN
    finite = ~np.isnan(ms)
    np.testing.assert_array_equal(ms[finite].view(np.int32), ps.numpy()[finite].view(np.int32))
    # the constructed ties: exact halves before rounding, both directions
    y5 = x[5] / F32(512.0)
    half = (y5 / y5.max()) * F32(127.0)
    assert list(half[1:5]) == [0.5, 1.5, 2.5, 3.5]
    assert list(mq[5, 1:5]) == [0, 2, 2, 4]
    assert list(mq[6, 1:4]) == [-4, -6, -6]  # -4.5, -5.5, -6.5
    assert not mq[1].any() and ms[1] == 0.0
    assert np.isnan(ms[2:5]).all() and not mq[2:5].any()


@pytest.mark.parametrize("d", [96, 128, 512])
def test_quantize_mirror_equals_jax(rng, d):
    x = _edge_rows(rng, d)
    mq, ms = quantize_mirror(x)
    jq, js = jm.quantize_embeddings_int8(jm.l2_normalize(jnp.asarray(x)))
    np.testing.assert_array_equal(mq, np.asarray(jq))
    np.testing.assert_array_equal(ms, np.asarray(js))


KEY_NEG_INF = -0x7F800001  # order_key(-inf)
KEY_POS_INF = 0x7F800000  # order_key(+inf)


def key_score(key: int) -> F32:
    bits = key if key >= 0 else key ^ 0x7FFFFFFF
    return np.array(bits, np.int32).view(F32)[()]


def threshold_of(kth: int) -> F32:
    """``threshold_of`` of csrc/int8_topk.cu: the float every score whose
    key reaches ``kth`` is at least (NaN scores are always looked at)."""
    return key_score(min(max(kth, KEY_NEG_INF), KEY_POS_INF))


def test_threshold_is_a_lower_bound_of_the_keys_it_admits():
    """Every score whose key passes a k-th key (strictly or equal) passes
    the float test ``!(score < threshold_of(kth))``: ±0, ±inf, NaNs of both
    signs, subnormals and the ends of the key range."""
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-38, -3.5, 2.0], F32)
    nans = np.array([0x7FC00000, 0x7FFFFFFF, -0x00400000], np.int32).view(F32)
    rng = np.random.default_rng(3)
    scores = np.concatenate([special, nans, rng.normal(size=200).astype(F32)])
    keys = m.order_key(torch.from_numpy(scores)).numpy().astype(np.int64)
    kths = sorted(set(keys.tolist()) | {-(2**31), 2**31 - 1, -(2**31 - 1), KEY_NEG_INF, KEY_POS_INF})
    for kth in kths:
        t = threshold_of(kth)
        with np.errstate(invalid="ignore"):
            near = ~(scores < t)
        assert not ((keys >= kth) & ~near).any(), kth


def _insert(lst, key, row, kmax):
    """``insert`` of csrc/int8_topk.cu on a Python list kept best first."""
    lst.append((key, row))
    lst.sort(key=lambda e: (-e[0], e[1]))
    del lst[kmax:]


def tile_bound(keys_c, t0, hi, k):
    """``tile_bound`` of csrc/int8_topk.cu for one query: lane p of warp w
    holds tile rows 16w + p (+ 8, + 64, + 72); the k-th best of the eight
    lanes' bests, the largest over the four warps."""
    best = []
    for w in range(4):
        lanes = []
        for p in range(8):
            rows = [t0 + 16 * w + p + o for o in (0, 8, 64, 72)]
            live = [keys_c[r] for r in rows if r < hi]
            lanes.append(max(live) if live else -(2**31))
        best.append(sorted(lanes, reverse=True)[k - 1])
    return max(best)


def filtered_fold_mirror(qq, qs, gq, gs, k, n_valid, sm_count, order_rng):
    """``int8_partial`` + ``topk_merge`` as the kernel runs them, with the
    compaction buffers filled in a random order (the atomics' order)."""
    b = qq.shape[0]
    p = st.plan(b, n_valid, k, sm_count, it.MAX_WIDTH)
    kmax = 8 if k <= 8 else 16 if k <= 16 else 32
    cap = min(TILE_ROWS, BUF_ENTRIES // p.width)
    r = F32(1.0) / F32(127.0)
    acc = qq.astype(np.int64) @ gq[:n_valid].astype(np.int64).T
    with np.errstate(invalid="ignore"):
        scores = (acc.astype(F32) * (qs * r).astype(F32)[:, None]) * (gs[:n_valid] * r).astype(F32)[None, :]
    keys = m.order_key(torch.from_numpy(np.ascontiguousarray(scores))).numpy().astype(np.int64)
    cands = [[] for _ in range(b)]
    for g in range(p.groups):
        cols = range(g * p.width, min(b, (g + 1) * p.width))
        for s in range(p.n_split):
            lo, hi = s * p.rows_per_split, min(n_valid, (s + 1) * p.rows_per_split)
            tiles = list(range(lo, hi, TILE_ROWS))
            for cons in range(2):
                lists = {c: [] for c in cols}
                kth = {c: -(2**31) for c in cols}
                overflowed = False
                for t0 in tiles[cons::2]:
                    rows = np.arange(t0, min(t0 + TILE_ROWS, hi))
                    placed = {c: np.zeros(len(rows), bool) for c in cols}
                    later = False
                    while True:
                        more = False
                        # the first tile (lists empty), rounds after an overflow and
                        # every tile after an overflow past the consumer's first tile
                        bounded = kmax == 8 and (later or t0 == tiles[cons] or overflowed)
                        for c in cols:
                            kc = keys[c, rows]
                            lo = tile_bound(keys[c], t0, hi, k) if bounded else -(2**31)
                            t = max(threshold_of(kth[c]), threshold_of(lo))
                            with np.errstate(invalid="ignore"):
                                near = ~(scores[c, rows] < t)
                            ok = ((kc > kth[c]) | (later & (kc == kth[c]))) & (kc >= lo) & near
                            idx = np.flatnonzero(ok & ~placed[c])
                            order_rng.shuffle(idx)
                            for e in idx[:cap]:
                                placed[c][e] = True
                            more |= len(idx) > cap
                            # the owner folds after the barrier; its k-th key is new
                            for e in idx[:cap]:
                                _insert(lists[c], int(kc[e]), int(rows[e]), kmax)
                        for c in cols:
                            kth[c] = lists[c][k - 1][0] if len(lists[c]) >= k else -(2**31)
                        later = True
                        if not more:
                            break
                        overflowed |= t0 != tiles[cons]
                for c in cols:
                    cands[c] += lists[c][:k]
    out_s = np.empty((b, k), F32)
    out_i = np.empty((b, k), np.int32)
    for c in range(b):
        best = sorted(cands[c], key=lambda e: (-e[0], e[1]))[:k]
        best += [None] * (k - len(best))
        for j, e in enumerate(best):
            if e is None:
                out_s[c, j], out_i[c, j] = UNFILLED
            else:
                bits = np.int32(e[0])
                bits = bits if bits >= 0 else bits ^ np.int32(0x7FFFFFFF)
                out_s[c, j] = np.array(bits, np.int32).view(F32)
                out_i[c, j] = e[1]
    return out_s, out_i


def _gallery(rng, kind: str, n: int, d: int):
    if kind == "random":
        g = rng.normal(size=(n, d)).astype(F32)
        return m.quantize_embeddings_int8_np(g)
    base = rng.integers(1, 128, d).astype(np.int8)  # positive codes: positive products
    gq = np.broadcast_to(base, (n, d)).copy()
    if kind == "rising":  # every row scores above all rows before it
        gs = (F32(0.5) + np.arange(n, dtype=F32) * F32(2.0**-14)).astype(F32)
    else:  # "equal": every score ties, the lowest rows win
        gs = np.full(n, F32(0.25))
    return gq, gs


@pytest.mark.parametrize("kind, b, n, d, k, n_valid, sm", [
    ("random", 8, 3000, 64, 5, 3000, 4),
    ("random", 100, 2000, 64, 5, 1900, 3),  # two groups of W = 64: cap 32
    ("random", 40, 2500, 32, 16, 2500, 5),  # W = 64: cap 32
    ("random", 3, 900, 32, 32, 700, 2),
    ("random", 130, 700, 32, 1, 700, 2),  # two query groups
    ("rising", 100, 1500, 32, 8, 1500, 3),  # every row passes: rounds at cap 32
    ("rising", 20, 1200, 32, 32, 1100, 2),
    ("equal", 30, 1000, 32, 5, 1000, 3),
    ("nan", 12, 1500, 64, 5, 1400, 3),
])
def test_filtered_fold_equals_plain(rng, kind, b, n, d, k, n_valid, sm):
    gq, gs = _gallery(rng, "random" if kind == "nan" else kind, n, d)
    q = rng.normal(size=(b, d)).astype(F32)
    if kind in ("rising", "equal"):
        q = np.abs(q) + 0.1  # positive codes against positive codes
    if kind == "nan":
        gs = gs.copy()
        gs[[17, 600]] = np.nan  # NaN scales rank first
        q[1, 4] = np.nan  # a NaN query: every score NaN, rows 0.. first
    qq, qs = it.quantize_queries(torch.from_numpy(q))
    ws, wi = it.int8_topk_codes_reference(qq, qs, torch.from_numpy(gq), torch.from_numpy(gs), k, n_valid)
    es, ei = filtered_fold_mirror(qq.numpy(), qs.numpy(), gq, gs, k, n_valid, sm, np.random.default_rng(1))
    np.testing.assert_array_equal(ei, wi.numpy())
    np.testing.assert_array_equal(es, ws.numpy())
    if kind == "rising":
        assert (wi.numpy()[:, 0] == n_valid - 1).all()
    if kind == "equal":
        assert (wi.numpy() == np.arange(k)).all()
    if kind == "nan":
        assert wi.numpy()[1].tolist() == list(range(k))


def test_int8_topk_checks_float_queries():
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")  # noqa: E731
    gq, gs = meta(100, 512, dt=torch.int8), meta(100)
    it._check(meta(2, 512), None, gq, gs, 5, 100)
    with pytest.raises(TypeError, match="queries must be torch.float32"):
        it._check(meta(2, 512, dt=torch.float16), None, gq, gs, 5, 100)
    with pytest.raises(ValueError, match="width"):
        it._check(meta(2, 256), None, gq, gs, 5, 100)
    with pytest.raises(ValueError, match="contiguous"):
        it._check(meta(512, 2).T, None, gq, gs, 5, 100)


def test_int8_topk_codes_takes_int8_quantize_codes():
    """``int8_quantize`` gives its (B, D) codes as a view of rows padded to
    16 bytes; at D = 132 they pass ``int8_topk_codes``'s checks and go to
    the kernel padded with zero codes."""
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")  # noqa: E731
    view = meta(4, 144, dt=torch.int8)[:, :132]
    it._check(view, meta(4), meta(100, 132, dt=torch.int8), meta(100), 5, 100)
    with pytest.raises(ValueError, match="contiguous"):  # columns apart are refused
        it._check(meta(264, 4, dt=torch.int8).T[:, ::2], meta(4), meta(100, 132, dt=torch.int8),
                  meta(100), 5, 100)
    with pytest.raises(ValueError, match="gallery codes must be contiguous"):
        it._check(meta(4, 132, dt=torch.int8), meta(4), meta(100, 144, dt=torch.int8)[:, :132],
                  meta(100), 5, 100)
    rows = torch.arange(4 * 144).reshape(4, 144).remainder(251).sub(125).to(torch.int8)
    for d in (132, 128):
        got = it._padded(rows[:, :d], 4)
        assert got.is_contiguous() and got.shape == (4, -(-d // 16) * 16)
        assert torch.equal(got[:, :d], rows[:, :d]) and not got[:, d:].any()

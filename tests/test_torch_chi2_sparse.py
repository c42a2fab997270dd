"""The arithmetic of ``csrc/chi2_nn.cu``, mirrored in plain PyTorch on the CPU.

The kernels visit only the bins that are non-zero on one side at least
(per row a 32-bit mask of them per chunk of 32 features), and find each
query's nearest row with a filter over the bins non-zero on both sides
(d' = 2 (S_q + S_g - 4 sum qg / (q + g))) whose bounds rule rows out, then
rescore the rest exactly in the fixed order. These tests hold:

(a) the masks and row sums (``row_stats_plain``, the kernels' ``chi2_stats``);
(b) the skipping direct form, element by element, against
    ``chi2_distances_kernel_order`` bit for bit;
(c) the filter + rescoring against the exact kernel-order argmin (value and
    index) on real LBPH histograms and random rows: a planted probe, duplicated
    and near-duplicated rows, all-zero rows, NaN and infinite bins, hundreds of
    equal rows;
(d) the stated margin (``filter_margin``) against the filter's error, with the
    reciprocal off by up to two ulps either way (``rcp.approx`` of a pair);
(e) the JAX package's ``_chi2_batch`` argmin where its two best rows are clear.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from facerecognition_tpu.models.lbph import _chi2_batch
from facerecognition_tpu_torch.ops import chi2_nn as cn
from facerecognition_tpu_torch.ops.lbph_hist import lbph_features_plain

CHUNK = cn.CHUNK


def lbph_rows(rng, identities: int, samples: int) -> torch.Tensor:
    """LBPH histograms (r 1, 8 neighbours, 8x8 cells: F = 16384) of 100²
    faces made as chip_smoke.py makes them: a blocky pattern per identity,
    integer noise per sample."""
    coarse = rng.integers(30, 226, (identities, 13, 13)).astype(np.float32)
    base = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :100, :100]
    noise = rng.integers(-12, 13, (identities, samples, 100, 100))
    faces = np.clip(base[:, None] + noise, 0, 255).reshape(-1, 100, 100).astype(np.float32)
    return lbph_features_plain(torch.from_numpy(faces))


def sparse_rows(rng, n: int, f: int, density: float = 0.3) -> torch.Tensor:
    """Non-negative rows, ``density`` of the bins non-zero, values k/144."""
    x = rng.integers(1, 20, (n, f)) / 144.0 * (rng.random((n, f)) < density)
    return torch.from_numpy(x.astype(np.float32))


def skipping_distances(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, N) distances as the kernels sum them: per chunk, only the bins of
    mask_q | mask_g, in ascending order, into a partial from +0; the
    partials left to right into the total; times 2."""
    qm, _ = cn.row_stats_plain(q)
    gm, _ = cn.row_stats_plain(g)
    union = qm[:, None, :] | gm[None, :, :]  # (B, N, C)
    pad = (-q.shape[1]) % CHUNK
    qp = torch.nn.functional.pad(q, (0, pad)).reshape(q.shape[0], 1, -1, CHUNK)
    gp = torch.nn.functional.pad(g, (0, pad)).reshape(1, g.shape[0], -1, CHUNK)
    part = torch.zeros(union.shape, dtype=torch.float32)
    for k in range(CHUNK):
        visited = ((union >> k) & 1).bool()
        term = cn._terms(qp[..., k], gp[..., k])
        part = torch.where(visited, part + term, part)
    total = torch.zeros(union.shape[:2], dtype=torch.float32)
    for c in range(union.shape[2]):
        total = total + part[..., c]
    return 2.0 * total


def _nudge(r: torch.Tensor, rng) -> torch.Tensor:
    """r moved by up to two ulps up or down at random: the kernel's
    reciprocal of a pair, fl(s1 * rcp.approx(fl(s0 s1))) (rcp.approx.f32 is
    within 1 ulp, PTX ISA; the two products round once each)."""
    out = r
    for _ in range(2):
        way = torch.from_numpy(rng.integers(-1, 2, r.shape)).float()
        out = torch.where(way > 0, torch.nextafter(out, torch.tensor(np.inf)),
                          torch.where(way < 0, torch.nextafter(out, torch.tensor(-np.inf)), out))
    return out


def filter_sums(q: torch.Tensor, g: torch.Tensor, rng) -> torch.Tensor:
    """The filter's float32 P (B, N): per chunk, over the query's non-zero
    bins in ascending order, part = fma(q g, 1 / (q + g), part) (the fma
    through float64, the reciprocal off by up to two ulps); the partials
    left to right."""
    pad = (-q.shape[1]) % CHUNK
    qp = torch.nn.functional.pad(q, (0, pad)).reshape(q.shape[0], 1, -1, CHUNK)
    gp = torch.nn.functional.pad(g, (0, pad)).reshape(1, g.shape[0], -1, CHUNK)
    part = torch.zeros((q.shape[0], g.shape[0], qp.shape[2]), dtype=torch.float32)
    for k in range(CHUNK):
        qv, gv = qp[..., k], gp[..., k]
        r = _nudge(1.0 / (qv + gv), rng)
        fused = ((qv * gv).double() * r.double() + part.double()).float()
        part = torch.where(qv != 0, fused, part)
    total = torch.zeros(part.shape[:2], dtype=torch.float32)
    for c in range(part.shape[2]):
        total = total + part[..., c]
    return total


def filtered_nearest(q: torch.Tensor, g: torch.Tensor, rng):
    """The filter + rescoring: U, the least upper bound over the rows; the
    rows whose lower bound is <= U rescored exactly (the kernel order); the
    nearest of them, NaN first, then the smaller distance, the lower index.
    Also the candidates per query."""
    _, qs = cn.row_stats_plain(q)
    _, gs = cn.row_stats_plain(g)
    lo, hi = cn.filter_bounds(filter_sums(q, g, rng), qs[:, None], gs[None, :],
                              cn.filter_margin(q.shape[1]))
    cand = lo <= hi.min(1, keepdim=True).values
    exact = cn.chi2_distances_kernel_order(q, g)
    rescored = torch.where(cand, exact, torch.full_like(exact, float("inf")))
    best, idx = cn.nearest(rescored)
    return best, idx, cand.sum(1)


def assert_same_nearest(got, want):
    best, idx = got[:2]
    wbest, widx = want
    np.testing.assert_array_equal(idx.numpy(), widx.numpy())
    np.testing.assert_array_equal(best.numpy(), wbest.numpy())  # NaN where NaN


# (a) -------------------------------------------------------------------------


@pytest.mark.parametrize("f", [96, 100, 16384])
def test_row_stats_pack_nonzero_bins(f):
    rng = np.random.default_rng(f)
    x = sparse_rows(rng, 6, f)
    x[1, 3], x[2, f - 1], x[3, 0], x[4, 33] = np.nan, np.inf, -np.inf, -1.0
    x[5] = 0.0
    x[0, 7] = -0.0  # a zero
    masks, sums = cn.row_stats_plain(x)
    bits = np.zeros((6, -(-f // CHUNK) * CHUNK), bool)
    bits[:, :f] = (x != 0).numpy()
    words = (bits.reshape(6, -1, CHUNK) * (1 << np.arange(CHUNK, dtype=np.uint64))).sum(-1)
    np.testing.assert_array_equal(masks.numpy().view(np.uint32), words.astype(np.uint32))
    assert masks.dtype == torch.int32 and masks.shape == (6, -(-f // CHUNK))
    assert sums.dtype == torch.float64
    regular = [0, 5]
    np.testing.assert_array_equal(sums[regular].numpy(), x[regular].double().sum(1).numpy())
    assert torch.isnan(sums[1:5]).all()  # NaN, inf, -inf, a negative bin
    assert torch.equal(cn.chi2_row_stats(x)[0], masks)  # the wrapper on the CPU


def test_row_stats_regular_range():
    """A non-zero bin outside [2^-60, 2^60] makes the row irregular."""
    x = torch.zeros(4, 40)
    x[0, 1], x[1, 1], x[2, 1], x[3, 1] = 2.0**-60, 2.0**60, 2.0**-61, 2.0**61
    _, sums = cn.row_stats_plain(x)
    assert not torch.isnan(sums[:2]).any() and torch.isnan(sums[2:]).all()


@pytest.mark.parametrize("rows", [1, 4, 7])
def test_row_stats_by_chunks_of_rows(rows):
    """The stats taken a few rows at a time equal those of all rows at once."""
    rng = np.random.default_rng(rows)
    x = sparse_rows(rng, 9, 100)
    x[2, 5], x[6, 40] = np.nan, -1.0
    masks, sums = cn.row_stats_plain(x)
    cmasks, csums = cn.row_stats_plain(x, rows=rows)
    assert torch.equal(cmasks, masks)
    np.testing.assert_array_equal(csums.numpy(), sums.numpy())


def test_cpu_model_keeps_no_gallery_stats():
    """On the CPU the plain version reads no stats, so the model makes none
    (train, update, the histograms setter); its answers stand."""
    from facerecognition_tpu_torch.models.lbph import LBPHModel

    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (6, 40, 40)).astype(np.uint8)
    model = LBPHModel(grid_x=4, grid_y=4, device="cpu")
    model.train(images[:4], [0, 0, 1, 1])
    assert model._stats is None
    model.update(images[4:], [2, 2])
    assert model._stats is None and model._gallery.shape[0] == 6
    model.histograms = model.histograms
    assert model._stats is None
    assert model.predict(images[5]) == (2, 0.0)


# (b) -------------------------------------------------------------------------


@pytest.mark.parametrize("f", [96, 100, 16384])
def test_skipping_direct_form_is_kernel_order_bit_for_bit(f):
    rng = np.random.default_rng(1 + f)
    if f == 16384:
        rows = lbph_rows(rng, 6, 3)
        q, g = rows[[0, 4, 9]], rows
    else:
        q, g = sparse_rows(rng, 5, f), sparse_rows(rng, 70, f, 0.2)
        g[3] = 0.0
        q[1] = g[7]
    got = skipping_distances(q, g)
    want = cn.chi2_distances_kernel_order(q, g)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))


# (c) -------------------------------------------------------------------------


def _kernel_order_nearest(q, g):
    return cn.nearest(cn.chi2_distances_kernel_order(q, g))


def test_filter_on_lbph_histograms():
    """Planted, duplicated, near-duplicated and fresh probes on real
    histograms; few rows are rescored."""
    rng = np.random.default_rng(3)
    g = lbph_rows(rng, 40, 5)  # 200 rows
    fresh = lbph_rows(rng, 2, 1)
    g[150] = g[20]  # duplicated rows: the lower index wins
    near = g[61].clone()
    cell = near[:256].nonzero()[:, 0]
    near[cell[0]] += 2 / 144.0  # two counts moved between bins of one cell
    near[cell[1]] -= 1 / 144.0
    near[cell[2]] -= 1 / 144.0
    q = torch.stack([g[7], g[20], near, fresh[0], fresh[1], g[61]])
    got = filtered_nearest(q, g, rng)
    want = _kernel_order_nearest(q, g)
    assert_same_nearest(got, want)
    assert got[1][:3].tolist() == [7, 20, 61] and got[0][0] == 0.0 and got[0][2] > 0.0
    assert int(got[2].max()) <= 10, got[2]


@pytest.mark.parametrize("seed", range(4))
def test_filter_on_random_rows(seed):
    rng = np.random.default_rng(10 + seed)
    f = [96, 100, 300, 1000][seed]
    g = sparse_rows(rng, 300, f, 0.25)
    q = sparse_rows(rng, 6, f, 0.25)
    q[0] = g[11]
    q[1] = g[12] * 1.0001  # a near-duplicate by scale
    g[200] = g[12]
    assert_same_nearest(filtered_nearest(q, g, rng), _kernel_order_nearest(q, g))


def test_filter_with_zero_rows():
    rng = np.random.default_rng(21)
    g = sparse_rows(rng, 50, 100)
    g[[4, 9]] = 0.0
    q = sparse_rows(rng, 3, 100)
    q[1] = 0.0  # an all-zero query: its nearest is the lowest all-zero row
    q[2] = g[30] * 0.0 + 1 / 144.0  # dense
    got = filtered_nearest(q, g, rng)
    assert_same_nearest(got, _kernel_order_nearest(q, g))
    assert got[1][1] == 4 and got[0][1] == 0.0


def test_filter_with_nan_and_infinite_bins():
    """A NaN bin adds nothing to the distance (where(q + g > 0, ...)); an
    infinite one makes it NaN, which ranks first. Rows and queries that are
    not regular are rescored, so the NaN-first rule holds."""
    rng = np.random.default_rng(22)
    g = sparse_rows(rng, 60, 100)
    q = sparse_rows(rng, 4, 100)
    q[0] = g[5]
    g[40, 3] = np.nan  # row 40: the NaN bin's term is 0
    g[41, 7] = np.inf  # row 41: q[:, 7] > 0 gives a NaN distance
    q[1, 7] = 0.5
    q[2] = g[40]
    q[3] = g[6]
    q[3, 9] = np.inf  # a query with an infinite bin: NaN against every row with g9 != -q9
    got = filtered_nearest(q, g, rng)
    want = _kernel_order_nearest(q, g)
    assert_same_nearest(got, want)
    assert got[1][1] == 41 and torch.isnan(got[0][1])
    assert int(got[2][3]) == 60  # every row rescored


def test_filter_with_hundreds_of_equal_rows():
    """300 rows equal to the probe: every one is a candidate (the kernel
    rescores them all, on the card), and the lowest index wins."""
    rng = np.random.default_rng(23)
    g = sparse_rows(rng, 400, 200)
    g[50:350] = g[49]
    q = torch.stack([g[49], g[10]])
    got = filtered_nearest(q, g, rng)
    assert_same_nearest(got, _kernel_order_nearest(q, g))
    assert got[1][0] == 49 and int(got[2][0]) >= 301


# (d) -------------------------------------------------------------------------


@settings(max_examples=40, deadline=None, database=None)
@given(
    f=st.sampled_from([32, 33, 96, 700]),
    density=st.floats(0.05, 1.0),
    scale=st.sampled_from([2.0**-50, 1e-3, 1.0, 1e6, 2.0**50]),
    seed=st.integers(0, 2**31 - 1),
)
def test_margin_bounds_the_filter_error(f, density, scale, seed):
    """The fixed-order distance lies within the bounds of the filter's d'
    for regular rows of any scale and density."""
    rng = np.random.default_rng(seed)
    vals = rng.lognormal(0.0, 2.0, (9, f)) * (rng.random((9, f)) < density)
    x = torch.from_numpy(np.clip(vals * scale, 2.0**-59, 2.0**59) * (vals > 0)).float()
    q, g = x[:3], x[3:]
    g[0] = q[0]  # distance 0
    _, qs = cn.row_stats_plain(q)
    _, gs = cn.row_stats_plain(g)
    assert not torch.isnan(qs).any() and not torch.isnan(gs).any()
    lo, hi = cn.filter_bounds(filter_sums(q, g, rng), qs[:, None], gs[None, :], cn.filter_margin(f))
    d = cn.chi2_distances_kernel_order(q, g).double()
    assert bool((lo <= d).all()) and bool((d <= hi).all()), (lo - d, hi - d)


def test_margin_constants():
    """At the LBPH width the bound is about 0.017 on T = 128."""
    rel, abs0, down, up = cn.filter_margin(16384)
    assert 0.0080 < rel * 128 < 0.0090
    assert abs0 < 1e-19 and 0 < 1 - down < 4e-5 and up - 1 == pytest.approx(1 - down)


# (e) -------------------------------------------------------------------------


def test_filtered_nearest_matches_jax_argmin():
    rng = np.random.default_rng(5)
    g = lbph_rows(rng, 30, 4)
    q = torch.cat([g[[3, 50, 77]], lbph_rows(rng, 3, 1)])
    jd = np.asarray(_chi2_batch(jnp.asarray(q.numpy()), jnp.asarray(g.numpy())))
    top2 = np.sort(jd, axis=1)[:, :2]
    clear = top2[:, 1] - top2[:, 0] > 1e-5 * top2[:, 1]
    assert clear.sum() >= 4
    best, idx, _ = filtered_nearest(q, g, rng)
    np.testing.assert_array_equal(idx.numpy()[clear], jd.argmin(1)[clear])
    np.testing.assert_allclose(best.numpy(), jd.min(1), rtol=1e-5, atol=1e-6)

"""The streaming top-k kernel's plan and arithmetic, checked on the CPU.

The CUDA kernel (``facerecognition_tpu_torch/csrc/stream_topk.cu``) runs only
on the card; ``chip_smoke.py`` holds it against ``stream_topk_reference``
there. What surrounds it is checked here: the work split that the wrapper
plans (every gallery row in exactly one split, the candidate lists that pass
2 merges) and the three-product tf32 split that the kernel's score product
uses in place of float32 FMAs.
"""

import numpy as np
import pytest
import torch

from facerecognition_tpu_torch.device import strict_fp32
from facerecognition_tpu_torch.ops import stream_topk as st
from facerecognition_tpu_torch.ops.matcher import l2_normalize, topk_lowest_index

BATCHES = (1, 5, 8, 9, 32, 100, 128, 129, 256, 300, 512, 1000)
ROWS = (1, 3, 127, 128, 129, 1000, 10_001, 100_000, 1_000_000)


def _splits(p, n):
    """The [begin, end) gallery rows of each split, as pass 1 reads them."""
    r = p.rows_per_split
    return [(s * r, min(n, (s + 1) * r)) for s in range(p.n_split)]


@pytest.mark.parametrize("sm_count", [1, 8, 132])
@pytest.mark.parametrize("k", [1, 5, 8, 9, 16, 17, 32])
def test_plan_covers_the_gallery_exactly_once(k, sm_count):
    widest = 128 if k <= 8 else 64 if k <= 16 else 32
    for b in BATCHES:
        for n in ROWS:
            p = st.plan(b, n, k, sm_count)
            splits = _splits(p, n)
            assert len(splits) == p.n_split >= 1
            assert splits[0][0] == 0 and splits[-1][1] == n
            for (lo, hi), (nxt, _) in zip(splits, splits[1:] + [(n, n)]):
                assert lo < hi == nxt  # contiguous, none empty
            assert p.rows_per_split % st.TILE_ROWS == 0
            assert p.n_split <= max(1, -(-sm_count // p.groups))  # about one block per SM
            assert p.width in st.QUERY_WIDTHS and p.width <= widest
            assert p.groups * p.width >= b > (p.groups - 1) * p.width  # no empty group
            assert p.n_cand == p.n_split * st.CONSUMERS * k


@pytest.mark.parametrize("b, n, k", [(0, 5, 1), (1, 0, 1), (1, 5, 0), (1, 5, 33)])
def test_plan_refuses_what_the_kernel_cannot_run(b, n, k):
    with pytest.raises(ValueError):
        st.plan(b, n, k, 132)


def _kernel_decomposition(q, g, k, p):
    """The kernel's two passes in plain torch: each split's two consumers
    keep a list of the k best of their 64-row halves of every 128-row tile,
    written where pass 1 writes them; pass 2 merges n_cand per query."""
    b, n = q.shape[0], g.shape[0]
    with strict_fp32():
        scores = l2_normalize(q) @ l2_normalize(g).T
    cand_s = torch.full((b, p.n_cand), float("-inf"))
    cand_i = torch.full((b, p.n_cand), 2**31 - 1, dtype=torch.int64)
    for s, (lo, hi) in enumerate(_splits(p, n)):
        for c in range(st.CONSUMERS):
            rows = torch.tensor([
                r for t0 in range(lo, hi, st.TILE_ROWS)
                for r in range(t0 + 64 * c, min(t0 + 64 * (c + 1), hi))
            ], dtype=torch.int64)
            if len(rows) == 0:
                continue
            kk = min(k, len(rows))
            v, j = topk_lowest_index(scores[:, rows], kk)
            at = (s * st.CONSUMERS + c) * k
            cand_s[:, at:at + kk] = v
            cand_i[:, at:at + kk] = rows[j]
    out_s = torch.full((b, k), st.UNFILLED_SCORE)
    out_i = torch.full((b, k), st.UNFILLED_INDEX, dtype=torch.int32)
    for qi in range(b):
        order = np.lexsort((cand_i[qi].numpy(), -cand_s[qi].numpy()))[:k]
        filled = cand_i[qi, order] != 2**31 - 1
        out_s[qi, : int(filled.sum())] = cand_s[qi, order][filled]
        out_i[qi, : int(filled.sum())] = cand_i[qi, order][filled].int()
    return out_s, out_i


@pytest.mark.parametrize(
    "b, n, k, sm_count",
    [(3, 1, 5, 132), (4, 3, 5, 132), (7, 300, 10, 4), (9, 1000, 5, 132),
     (300, 700, 5, 132), (40, 2000, 16, 16), (2, 129, 32, 132)],
)
def test_plan_and_merge_give_the_plain_top_k(b, n, k, sm_count):
    rng = np.random.default_rng(b * 1000 + n)
    q = torch.from_numpy(rng.normal(size=(b, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
    if n > 2:
        g[n - 1] = g[n // 3]  # duplicate rows in different splits or halves
        q[0] = g[n // 3]
    p = st.plan(b, n, k, sm_count)
    s, i = _kernel_decomposition(q, g, k, p)
    rs, ri = st.stream_topk_reference(q, g, k)
    torch.testing.assert_close(i, ri, rtol=0, atol=0)
    torch.testing.assert_close(s, rs, rtol=0, atol=0)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round away the low 13 mantissa bits, to nearest
    with ties away from zero (on the bit pattern, so for either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0**-10  # tf32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, one + ulp / 4, one + 3 * ulp / 4, -(one + ulp / 2), 0.0])
    want = torch.tensor([one + ulp, one, one + ulp, -(one + ulp), 0.0])
    assert torch.equal(tf32_rna(x), want)


def test_three_tf32_products_keep_float32_accuracy():
    """The kernel's score: q and g split into tf32 hi + lo, the products
    lo*hi + hi*lo + hi*hi summed per 32-dim chunk (exact here, rounded to
    float32), the chunk sums added in float32. It stays within 1e-6 of the
    float64 score and gives the plain version's top-k; one tf32 product
    (hi*hi) misses by more than 1e-5, which is why the kernel takes three."""
    rng = np.random.default_rng(0)
    b, n, d, chunk = 64, 2000, 512, 32
    q = l2_normalize(torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)))
    g = l2_normalize(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)))
    exact = q.double() @ g.double().T
    qh = tf32_rna(q)
    ql = tf32_rna(q - qh)
    gh = tf32_rna(g)
    gl = tf32_rna(g - gh)
    total = torch.zeros(b, n, dtype=torch.float32)
    for c0 in range(0, d, chunk):
        sl = slice(c0, c0 + chunk)
        part = (
            ql[:, sl].double() @ gh[:, sl].double().T
            + qh[:, sl].double() @ gl[:, sl].double().T
            + qh[:, sl].double() @ gh[:, sl].double().T
        )
        total = total + part.float()
    three = (total.double() - exact).abs().max().item()
    one = (qh.double() @ gh.double().T - exact).abs().max().item()
    assert b * n >= 10**5
    assert three <= 1e-6, three
    assert one > 1e-5, one

    k = 5
    rs, ri = st.stream_topk_reference(q, g, k)
    vals, idx = topk_lowest_index(total, k)
    torch.testing.assert_close(idx.int(), ri, rtol=0, atol=0)
    torch.testing.assert_close(vals, rs, rtol=0, atol=1e-6)

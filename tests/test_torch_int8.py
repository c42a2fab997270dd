"""The port's int8 matcher against the JAX package, and the int8 kernel's
arithmetic emulated in PyTorch.

Inputs are made with numpy from a seed and handed to both sides; JAX runs on
the CPU. Quantizer codes and scales must be bit-equal; the plain
``cosine_topk_int8`` gives JAX's indices on clustered data, at least 99% of
its scores bit-equal and all within 5e-4 (a flipped query code moves a score
by about q_scale * g_scale / 127, 2e-4 or less). The kernel itself runs only
on the card (``chip_smoke.py`` holds it bit for bit against the plain
version there); here its order of roundings and its launch plan are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.ops import matcher as jm
from facerecognition_tpu_torch.ops import int8_topk as it
from facerecognition_tpu_torch.ops import matcher as m
from facerecognition_tpu_torch.ops import stream_topk as st


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _clustered(rng, n_classes, d, b, noise=0.05):
    centers = rng.normal(size=(n_classes, d)).astype(np.float32)
    g = centers + noise * rng.normal(size=centers.shape).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = centers[:b] + noise * rng.normal(size=(b, d)).astype(np.float32)
    return q, g


@pytest.mark.parametrize("d", [128, 512])
def test_quantizers_match_jax(rng, d):
    x = rng.normal(size=(300, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[5] = 0.0  # a zero row: scale 0, zero codes
    x[6, 3] = 0.5 * (x[6].max() or 1.0)  # a tie at half a step somewhere
    jq, js = (np.asarray(a) for a in jm.quantize_embeddings_int8(jnp.asarray(x)))
    nq, ns = m.quantize_embeddings_int8_np(x)
    np.testing.assert_array_equal(nq, jq)
    np.testing.assert_array_equal(ns, js)
    np.testing.assert_array_equal(nq, jm.quantize_embeddings_int8_np(x)[0])
    tq, ts = m.quantize_embeddings_int8(T(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert not nq[5].any() and ns[5] == 0.0


@pytest.mark.parametrize("d", [128, 512])
def test_windowed_normalize_is_jax_bits(rng, d):
    """The int8 path's query normalisation sums as XLA's CPU reduction does
    at widths that are multiples of 32, so its scales are JAX's bits."""
    x = rng.normal(size=(500, d)).astype(np.float32)
    np.testing.assert_array_equal(
        m.l2_normalize_windowed(T(x)).numpy(), np.asarray(jm.l2_normalize(jnp.asarray(x)))
    )


@pytest.mark.parametrize("n_valid", [None, 150])
@pytest.mark.parametrize("d", [128, 512])
def test_cosine_topk_int8_matches_jax(rng, d, n_valid):
    q, g = _clustered(rng, 200, d, 64)
    gq, gs = m.quantize_embeddings_int8_np(g)
    nv = None if n_valid is None else np.int32(n_valid)
    js, ji = jm.cosine_topk_int8(jnp.asarray(q), jnp.asarray(gq), jnp.asarray(gs), 5, nv)
    s, i = m.cosine_topk_int8(T(q), T(gq), T(gs), 5, n_valid)
    js, ji = np.asarray(js), np.asarray(ji)
    np.testing.assert_array_equal(i.numpy(), ji)
    assert (s.numpy() == js).mean() >= 0.99
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=5e-4)
    if n_valid is not None:
        assert int(i.max()) < n_valid


def test_cosine_topk_int8_agrees_with_dense(rng):
    """As tests/test_matcher.py holds the JAX int8 path: top-1 equal to the
    float32 dense match on clustered data, scores within 2e-2."""
    q, g = _clustered(rng, 40, 128, 16)
    gq, gs = m.quantize_embeddings_int8_np(g)
    s_ref, i_ref = m.cosine_topk(T(q), T(g), 5)
    s_q, i_q = m.cosine_topk_int8(T(q), T(gq), T(gs), 5)
    np.testing.assert_array_equal(i_q[:, 0].numpy(), i_ref[:, 0].numpy())
    np.testing.assert_allclose(s_q.numpy(), s_ref.numpy(), atol=2e-2)


def test_int8_scores_products_are_exact(rng):
    """The plain product is exact: equal to an int64 product of the codes,
    converted once to float32."""
    qq = rng.integers(-127, 128, (9, 1040)).astype(np.int8)
    gq = rng.integers(-127, 128, (33, 1040)).astype(np.int8)
    gq[0] = 127
    qq[0] = 127  # the largest sum of D <= 1040 products, 16,774,160 < 2^24
    ones_q = torch.full((9,), 127.0)
    ones_g = torch.full((33,), 127.0)
    # scales of 127 make each r-scaled scale 127 * r, so the score is acc
    # times (127 r)^2; compare against int64 to float32 with the same factors
    acc = (qq.astype(np.int64) @ gq.astype(np.int64).T).astype(np.float32)
    f = np.float32(127.0) * m.INV_127
    want = (acc * f) * f
    got = m.int8_scores(T(qq), ones_q, T(gq), ones_g).numpy()
    np.testing.assert_array_equal(got, want)


def _kernel_emulation(qq, qs, gq, gs, k, n_valid):
    """The kernel's arithmetic, element by element in numpy float32: the
    int32 product, ``((float)acc * (qs * r)) * (gs * r)`` with each product
    rounded, rows < n_valid only, ranked by (order key desc, row asc)."""
    r = np.float32(1.0) / np.float32(127.0)
    acc = qq[:, :].astype(np.int32) @ gq[:n_valid].astype(np.int32).T
    qr = (qs * r).astype(np.float32)
    gr = (gs[:n_valid] * r).astype(np.float32)
    scores = (acc.astype(np.float32) * qr[:, None]).astype(np.float32) * gr[None, :]
    keys = m.order_key(torch.from_numpy(scores)).numpy().astype(np.int64)
    order = np.lexsort((np.broadcast_to(np.arange(n_valid), keys.shape), -keys), axis=1)[:, :k]
    return np.take_along_axis(scores, order, 1), order.astype(np.int32)


@pytest.mark.parametrize("b, n, d, k, n_valid", [
    (8, 3000, 512, 5, 2500),
    (5, 700, 132, 7, 700),
    (3, 3, 512, 3, 3),
    (4, 900, 64, 32, 600),
])
def test_kernel_dequant_order_equals_plain(rng, b, n, d, k, n_valid):
    q = rng.normal(size=(b, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[n - 1] = g[n // 3]  # duplicate rows: the lower index first
    q[0] = g[n // 3]
    q[1, 2] = np.nan  # a NaN query: every score NaN, rows 0..k-1
    gq, gs = m.quantize_embeddings_int8_np(g)
    gs[7 % n_valid] = np.nan  # a NaN gallery scale ranks first
    qq, qs = it.quantize_queries(T(q))
    es, ei = _kernel_emulation(qq.numpy(), qs.numpy(), gq, gs, k, n_valid)
    ps, pi = it.int8_topk_codes(qq, qs, T(gq), T(gs), k, n_valid)  # the plain version on the CPU
    np.testing.assert_array_equal(pi.numpy(), ei)
    np.testing.assert_array_equal(ps.numpy(), es)
    assert pi[1].tolist() == list(range(k))
    assert pi[2, 0] == 7 % n_valid
    # through the float-query entry point and the masked plain version too
    fs, fi = it.int8_topk(T(q), T(gq), T(gs), k, n_valid)
    np.testing.assert_array_equal(fi.numpy(), ei)
    np.testing.assert_array_equal(fs.numpy(), es)


@pytest.mark.parametrize("b, n, k", [(128, 1_000_000, 5), (1, 1_000_000, 5), (32, 100_000, 5),
                                     (7, 3, 3), (300, 12_345, 32), (40, 5_000, 16)])
def test_shared_plan_covers_the_live_rows_once(b, n, k):
    """int8_topk takes stream_topk's plan, its query groups at most
    ``MAX_WIDTH`` wide, over the n_valid live rows: every row in exactly one
    split, the splits whole 128-row tiles, the query groups covering B, and
    a width the kernel instantiates for that k."""
    p = st.plan(b, n, k, 132, it.MAX_WIDTH)
    covered = np.zeros(n, np.int32)
    for s in range(p.n_split):
        covered[s * p.rows_per_split:min(n, (s + 1) * p.rows_per_split)] += 1
    assert (covered == 1).all()
    assert p.rows_per_split % 128 == 0 and (p.n_split - 1) * p.rows_per_split < n
    assert p.groups * p.width >= b
    assert p.width in {8: (8, 16, 32, 64), 16: (8, 16, 32, 64), 32: (8, 16, 32)}[
        8 if k <= 8 else 16 if k <= 16 else 32
    ]
    assert p.n_cand == p.n_split * 2 * k


def test_padded_rows_are_zero_codes(rng):
    """A width that is not a multiple of 16 bytes is padded with zero codes,
    which leave every integer product as it was."""
    gq = torch.from_numpy(rng.integers(-127, 128, (10, 132)).astype(np.int8))
    padded = it._padded(gq, 6)
    assert padded.shape == (6, 144) and not padded[:, 132:].any()
    assert torch.equal(padded[:, :132], gq[:6])
    assert it._padded(torch.zeros(4, 512, dtype=torch.int8), 2).shape == (4, 512)


def test_int8_topk_checks_its_arguments():
    meta = lambda *s, dt=torch.int8: torch.zeros(*s, dtype=dt, device="meta")  # noqa: E731
    qq, qs = meta(2, 512), meta(2, dt=torch.float32)
    gq, gs = meta(100, 512), meta(100, dt=torch.float32)
    with pytest.raises(ValueError, match="k must be"):
        it._check(qq, qs, gq, gs, 6, 5)
    with pytest.raises(ValueError, match="n_valid"):
        it._check(qq, qs, gq, gs, 5, 101)
    with pytest.raises(TypeError, match="int8"):
        it._check(qs[:, None].expand(2, 512).contiguous(), qs, gq, gs, 5, 100)
    with pytest.raises(ValueError, match="width"):
        it._check(meta(2, 500), qs, gq, gs, 5, 100)
    with pytest.raises(ValueError, match="multiple of 4"):
        it._check(meta(2, 30), qs, meta(100, 30), gs, 5, 100)

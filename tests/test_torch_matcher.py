"""Port matcher against the JAX matcher and the Pallas kernel (interpret mode).

Indices must be exactly equal (ties resolve to the lowest index on both
sides); scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.ops.matcher import cosine_topk as j_cosine_topk
from facerecognition_tpu.ops.matcher import l2_normalize as j_l2_normalize
from facerecognition_tpu.ops.pallas_topk import pallas_cosine_topk
from facerecognition_tpu_torch.ops import matcher
from facerecognition_tpu_torch.ops import stream_topk as st


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _with_ties(rng, b, n, d):
    q = rng.normal(size=(b, d)).astype(np.float32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    g[n - 1] = g[n // 3]  # duplicate rows tie exactly
    g[n // 2] = g[n // 3] * 2.0  # same direction, same cosine up to rounding
    q[0] = g[n // 3]
    return q, g


def test_l2_normalize_matches_jax(rng):
    x = rng.normal(size=(5, 33)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_allclose(
        matcher.l2_normalize(T(x)).numpy(), np.asarray(j_l2_normalize(jnp.asarray(x))), atol=1e-7
    )


@pytest.mark.parametrize("n, n_valid", [(300, None), (300, 120), (5000, 4321)])
@pytest.mark.parametrize("normalized", [False, True])
def test_cosine_topk_matches_jax(rng, n, n_valid, normalized):
    q, g = _with_ties(rng, 6, n, 32)
    if normalized:
        q = np.asarray(j_l2_normalize(jnp.asarray(q)))
        g = np.asarray(j_l2_normalize(jnp.asarray(g)))
    k = 7
    rs, ri = j_cosine_topk(jnp.asarray(q), jnp.asarray(g), k, normalized, n_valid)
    s, i = matcher.cosine_topk(T(q), T(g), k, normalized, n_valid)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)
    assert i.dtype == torch.int32
    if n_valid is not None:
        assert (i.numpy() < n_valid).all()


def test_topk_lowest_index_on_heavy_ties():
    scores = torch.tensor([[0.5, 1.0, 0.5, 1.0, 0.5, -1.0], [0.0] * 6])
    vals, idx = matcher.topk_lowest_index(scores, 4)
    assert idx.tolist() == [[1, 3, 0, 2], [0, 1, 2, 3]]
    assert vals.tolist() == [[1.0, 1.0, 0.5, 0.5], [0.0] * 4]


# The four cases of tests/test_pallas_topk.py, plus k > n.
PALLAS_CASES = [
    dict(b=8, n=1024, d=128, k=5, tile=256),  # multi-tile
    dict(b=4, n=300, d=64, k=3, tile=128),  # ragged edge
    dict(b=2, n=64, d=32, k=4, tile=64),  # single tile
    dict(b=3, n=10, d=32, k=5, tile=8, negative=True),  # all-negative scores
    dict(b=3, n=3, d=32, k=5, tile=8, negative=True),  # k > n
]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: f"b{c['b']}n{c['n']}k{c['k']}")
def test_stream_topk_reference_matches_pallas(rng, case):
    q = rng.normal(size=(case["b"], case["d"])).astype(np.float32)
    g = rng.normal(size=(case["n"], case["d"])).astype(np.float32)
    if case.get("negative"):
        q = np.ones_like(q)
        g = -np.abs(g)
    rs, ri = pallas_cosine_topk(
        jnp.asarray(q), jnp.asarray(g), k=case["k"], tile=case["tile"], interpret=True
    )
    s, i = st.stream_topk_reference(T(q), T(g), case["k"])
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    s2, i2 = st.stream_topk(T(q), T(g), case["k"])
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    np.testing.assert_array_equal(s2.numpy(), s.numpy())


def test_stream_topk_reference_planted_ties_lowest_index(rng):
    q, g = _with_ties(rng, 4, 500, 64)
    s, i = st.stream_topk_reference(T(q), T(g), 3)
    top = i[0].tolist()
    assert sorted(top) == [500 // 3, 500 // 2, 500 - 1]
    assert top.index(500 // 3) < top.index(500 - 1)  # exact duplicate: lower first
    rs, ri = pallas_cosine_topk(jnp.asarray(q), jnp.asarray(g), k=3, tile=128, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5)


def test_auto_dispatch_rule(rng, monkeypatch):
    q = T(rng.normal(size=(2, 16)).astype(np.float32))
    g = T(rng.normal(size=(40, 16)).astype(np.float32))
    dense = matcher.cosine_topk(q, g, 3)
    # above the memory threshold a CPU gallery still stays dense
    monkeypatch.setattr(matcher, "DENSE_SCORES_MAX_BYTES", 0)
    monkeypatch.setattr(st, "stream_topk", lambda *a: pytest.fail("picked the kernel"))
    auto = matcher.auto_cosine_topk(q, g, 3)
    assert torch.equal(auto[1], dense[1])
    with pytest.raises(ValueError, match="n_valid"):
        matcher.auto_cosine_topk(q, g, 3, kernel="stream", n_valid=10)
    with pytest.raises(ValueError, match="unknown kernel"):
        matcher.auto_cosine_topk(q, g, 3, kernel="pallas")


def test_l2_normalize_takes_jax_axis_keyword():
    """Code ported from JAX passes ``axis=``; the port takes it as ``dim``."""
    x = np.random.default_rng(4).normal(size=(4, 6, 5)).astype(np.float32)
    x[1, 2] = 0.0
    for axis in (0, 1, -1):
        got = matcher.l2_normalize(T(x), axis=axis).numpy()
        np.testing.assert_array_equal(got, matcher.l2_normalize(T(x), dim=axis).numpy())
        np.testing.assert_allclose(got, np.asarray(j_l2_normalize(jnp.asarray(x), axis=axis)),
                                   rtol=0, atol=1e-6)

"""The port's multi-device layer against the JAX package on the CPU.

JAX runs on the suite's 8 virtual CPU devices (``tests/conftest.py``); the
port's meshes take ``torch.device("cpu")`` entries as virtual devices. The
mesh rules and the hybrid planner (synthetic device handles, as
``tests/test_multihost.py``) must equal JAX's; the sharded searches
(``sharded_topk``, ``sharded_topk_int8``, ``ShardedGallery``) must return
JAX's indices wherever JAX's scores are apart by more than the tolerance,
float32 scores within 1e-5 and int8 scores within the staged tests' 2e-3,
including N not a multiple of the shard count, shards with no valid row,
k above a shard's rows and k above the real rows. One test runs 2 gloo
ranks x 2 virtual shards each against JAX on 4 devices.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from facerecognition_tpu.parallel import ShardedGallery as JShardedGallery
from facerecognition_tpu.parallel import create_mesh as jcreate_mesh
from facerecognition_tpu.parallel import sharded_topk as jsharded_topk
from facerecognition_tpu.parallel import resolve_data_mesh as jresolve_data_mesh
from facerecognition_tpu.parallel import sharded_topk_int8 as jsharded_topk_int8
from facerecognition_tpu.parallel.multihost import _plan_hybrid as jplan_hybrid
from facerecognition_tpu_torch.ops.matcher import quantize_embeddings_int8_np
from facerecognition_tpu_torch.parallel import (
    ShardedGallery,
    create_mesh,
    resolve_data_mesh,
    shard_batch,
    sharded_topk,
    sharded_topk_int8,
)
from facerecognition_tpu_torch.parallel.launch import spawn_ranks
from facerecognition_tpu_torch.parallel.multihost import _plan_hybrid
from test_torch_dp_ranks import two_rank_search

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- meshes ---------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [{"gallery": -1}, {"data": 4, "gallery": 2}, {"data": -1, "gallery": 4},
                                   {"data": 8}, {"a": 2, "b": 2, "c": 2}])
def test_create_mesh_shapes_equal_jax(sizes):
    """The axis names, the shape mapping and the device order (ids
    row-major) of JAX's ``create_mesh`` on 8 devices."""
    want = jcreate_mesh(**sizes)
    got = create_mesh([CPU] * 8, **sizes)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)
    np.testing.assert_array_equal(ids(got.devices), ids(want.devices))


def test_create_mesh_refuses_what_jax_refuses():
    for sizes in ({"gallery": 3}, {"data": 3, "gallery": -1}, {"data": 2, "gallery": 2}):
        with pytest.raises(ValueError):
            jcreate_mesh(**sizes)
        with pytest.raises(ValueError, match="devices"):
            create_mesh([CPU] * 8, **sizes)


class FakeDev:
    """A synthetic device handle: an id and a slice index."""

    def __init__(self, id, slice_index):
        self.id = id
        self.slice_index = slice_index

    def __repr__(self):
        return f"d{self.id}s{self.slice_index}"


@pytest.mark.parametrize("case", [
    (lambda i: i % 2, {"data": 2}, {"gallery": 4}),
    (lambda i: i // 4, {"data": -1}, {"gallery": -1}),
    (lambda i: 0, None, {"gallery": 8}),
    (lambda i: i % 4, {"data": 2, "replica": 2}, {"gallery": 2}),
    (lambda i: (7 - i) // 2, {"data": -1}, {"x": 2}),
])
def test_plan_hybrid_equals_jax(case):
    """The same device grid (by id) and axis names as JAX's planner, slices
    outermost, arrival order interleaved."""
    slice_of, dcn, ici = case
    devs = [FakeDev(i, slice_of(i)) for i in range(8)]
    want, wnames = jplan_hybrid(devs, dcn, ici)
    got, names = _plan_hybrid(devs, dcn, ici)
    assert names == wnames and got.shape == want.shape
    ids = np.vectorize(lambda d: d.id)
    np.testing.assert_array_equal(ids(got), ids(want))


def test_plan_hybrid_refuses_what_jax_refuses():
    devs = [FakeDev(i, 0) for i in range(8)]
    uneven = [FakeDev(i, 0 if i < 5 else 1) for i in range(8)]
    for dcn, ici, ds in (({"data": 1}, None, devs), (None, {"gallery": 3}, devs),
                         ({"data": -1}, {"gallery": -1, "x": -1}, devs), (None, {"gallery": -1}, uneven)):
        with pytest.raises(ValueError):
            jplan_hybrid(ds, dcn, ici)
        with pytest.raises(ValueError):
            _plan_hybrid(ds, dcn, ici)


def test_resolve_data_mesh_without_a_group():
    """No group: None/0/1/False turn data parallelism off as in JAX, and
    "auto" is one device (JAX's "auto" takes every device of the process:
    ROADMAP's trainers' differences); a count above one names the ranks it
    needs (processes cannot be dropped). In a group: the 2-rank test below."""
    for n in (None, 0, 1, False):
        assert resolve_data_mesh(n, 12, CPU) is None and jresolve_data_mesh(n, 12) is None
    assert resolve_data_mesh("auto", 12, CPU) is None
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        resolve_data_mesh(4, 12, CPU)


def test_shard_batch_cuts_the_leading_dimension():
    mesh = create_mesh([CPU] * 4, data=2, gallery=2)
    x = torch.arange(12).reshape(6, 2)
    parts = shard_batch(x, mesh, "data")
    assert [p.tolist() for p in parts] == [x[:3].tolist(), x[3:].tolist()]
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(torch.zeros(5, 2), mesh, "data")


# -- sharded search ---------------------------------------------------------------


def _check(got, want, tol):
    """Scores within ``tol``; indices equal wherever JAX's scores are apart
    from their neighbours by more than ``tol`` (a near tie may order either
    way)."""
    (gs, gi), (ws, wi) = (np.asarray(a) for a in got), (np.asarray(a) for a in want)
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
    gap = np.full(ws.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], ws[:, :-1] - ws[:, 1:])
    gap[:, :-1] = np.minimum(gap[:, :-1], ws[:, :-1] - ws[:, 1:])
    apart = gap > tol
    np.testing.assert_array_equal(gi[apart], wi[apart])


def _gallery(rng, n, d):
    g = rng.normal(size=(n, d)).astype(np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("n, k", [(37, 5), (5, 3), (64, 9), (3, 7), (1, 1), (200, 32)])
def test_sharded_gallery_equals_jax(rng, quantize, n, k):
    """``ShardedGallery`` on 8 shards: N = 37 (not a multiple of 8), 5 and 3
    (shards with no valid row), 64 with k = 9 above a shard's 8 rows,
    k above N (``min(k, N)`` results), 200 x k 32."""
    d = 32
    g = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(7, d)).astype(np.float32)
    names = [f"id{i}" for i in range(n)]
    want_sg = JShardedGallery(jcreate_mesh(gallery=-1), dim=d, quantize=quantize)
    want_sg.set_all(names, g)
    got_sg = ShardedGallery(create_mesh([CPU] * 8, gallery=-1), dim=d, quantize=quantize)
    got_sg.set_all(names, g)
    assert len(got_sg) == n and got_sg.axis_size == 8
    _check(got_sg.topk(q, k), want_sg.topk(q, k), 2e-3 if quantize else 1e-5)


def test_sharded_gallery_on_a_two_axis_mesh(rng):
    """A 4 x 2 (data x gallery) mesh: the gallery axis carries the shards."""
    g = rng.normal(size=(11, 16)).astype(np.float32)
    q = rng.normal(size=(3, 16)).astype(np.float32)
    want_sg = JShardedGallery(jcreate_mesh(data=4, gallery=2), dim=16)
    want_sg.set_all(list("abcdefghijk"), g)
    got_sg = ShardedGallery(create_mesh([CPU] * 8, data=4, gallery=2), dim=16)
    got_sg.set_all(list("abcdefghijk"), g)
    _check(got_sg.topk(q, 4), want_sg.topk(q, 4), 1e-5)


def test_empty_sharded_gallery():
    sg = ShardedGallery(create_mesh([CPU] * 8, gallery=-1), dim=8)
    s, i = sg.topk(np.ones((2, 8), np.float32), 5)
    assert s.shape == (2, 0) and i.shape == (2, 0)
    with pytest.raises(ValueError, match="names of width"):
        sg.set_all(["a"], np.ones((1, 4), np.float32))


@pytest.mark.parametrize("n_real, k", [(40, 5), (13, 8), (6, 9), (2, 12)])
def test_sharded_topk_sentinels_equal_jax(rng, n_real, k):
    """``sharded_topk`` / ``sharded_topk_int8`` on a 40-row padded gallery
    with ``n_real`` real rows: k above a shard's 5 rows, k above
    ``n_real`` (slots score -1e30 and their indices clamp to n_real - 1)."""
    d, n = 16, 40
    g = _gallery(rng, n, d)
    g[n_real:] = 0.0
    q = rng.normal(size=(5, d)).astype(np.float32)
    jmesh, mesh = jcreate_mesh(gallery=-1), create_mesh([CPU] * 8, gallery=-1)
    want = jsharded_topk(jnp.asarray(q), jnp.asarray(g), jmesh, k, n_real=n_real)
    got = sharded_topk(torch.from_numpy(q), torch.from_numpy(g), mesh, k, n_real=n_real)
    _check(got, want, 1e-5)
    if k > n_real:
        assert (np.asarray(got[0])[:, n_real:] == -1e30).all()
        assert (np.asarray(got[1])[:, n_real:] == n_real - 1).all()
    codes, scales = quantize_embeddings_int8_np(g)
    want = jsharded_topk_int8(jnp.asarray(q), jnp.asarray(codes), jnp.asarray(scales), jmesh, k,
                              n_real=n_real)
    got = sharded_topk_int8(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(scales),
                            mesh, k, n_real=n_real)
    _check(got, want, 2e-3)


def test_sharded_topk_keeps_the_kernels_order(rng):
    """Equal scores in several shards: the lower global index first, as one
    ``stream_topk`` over the whole gallery; a NaN row ranks first."""
    from facerecognition_tpu_torch.ops.stream_topk import stream_topk

    g = _gallery(rng, 24, 8)
    g[[3, 9, 17, 21]] = g[0]  # five equal rows across four shards
    g[14] = np.nan
    q = g[:2] + 0.0
    mesh = create_mesh([CPU] * 8, gallery=-1)
    got_s, got_i = sharded_topk(torch.from_numpy(q), torch.from_numpy(g), mesh, 7)
    want_s, want_i = stream_topk(torch.from_numpy(q), torch.from_numpy(g), 7)
    assert torch.equal(got_i, want_i.long())
    assert torch.equal(got_s.isnan(), want_s.isnan())
    assert got_i[0, :6].tolist() == [14, 0, 3, 9, 17, 21]


# -- two gloo ranks ---------------------------------------------------------------


def test_two_gloo_ranks_equal_jax_on_four_devices(rng):
    """2 spawned ranks (gloo) x 2 virtual shards: each rank searches its own
    shards, the candidates are all-gathered, and every rank returns JAX's
    ``ShardedGallery`` result on 4 devices (float32 and int8)."""
    g = rng.normal(size=(27, 24)).astype(np.float32)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    for quantize in (False, True):
        want_sg = JShardedGallery(jcreate_mesh(jax.devices()[:4], gallery=4), dim=24, quantize=quantize)
        want_sg.set_all([str(i) for i in range(27)], g)
        results = spawn_ranks(two_rank_search, 2, g, q, quantize)
        for rank, per_rank in enumerate(results):
            for k, got in zip((1, 6), per_rank):
                _check(got, want_sg.topk(q, k), 2e-3 if quantize else 1e-5)
            # resolve_data_mesh over the group's ranks, as JAX's over 2 devices
            mesh = per_rank[2]
            assert mesh["shape"] == mesh["two"] == dict(jresolve_data_mesh(2, 12).shape) == {"data": 2}
            assert mesh["local"] == [(rank, rank)]
            assert "torchrun --nproc_per_node 3" in mesh["(3, 12)"]
            assert "does not divide the batch size 13" in mesh["('auto', 13)"]
    assert not dist.is_initialized()  # the ranks ran in their own processes

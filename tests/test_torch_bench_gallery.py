"""The port's large-gallery bench (``facerecognition_tpu_torch.bench_gallery``)
against the JAX root script ``bench_gallery.py``.

On the CPU at 2,000 x 64 rows, B 16, one batch a run: the draws; each
path's plain version against the JAX function the script times (dense
``cosine_topk``, ``cosine_topk_int8`` on ``quantize_embeddings_int8``'s
codes, ``pallas_cosine_topk`` in interpret mode, as
``tests/test_pallas_topk.py`` runs it): indices equal, scores within 1e-5
(int8 within 2e-3, as the staged tests hold it); the parity lines' values
against the script's; the JSON keys and metric names under the port's
mapping. One intra-op thread.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.ops.matcher import cosine_topk as j_cosine_topk
from facerecognition_tpu.ops.matcher import cosine_topk_int8 as j_cosine_topk_int8
from facerecognition_tpu.ops.matcher import quantize_embeddings_int8 as j_quantize
from facerecognition_tpu.ops.pallas_topk import pallas_cosine_topk
from facerecognition_tpu_torch import bench_gallery
from test_torch_measure_tools import dumped_keys

CPU = torch.device("cpu")
GALLERY, DIM, BATCH, ITERS, K = 2_000, 64, 16, 1, 5
ARGV = ["--device", "cpu", "--gallery", str(GALLERY), "--dim", str(DIM), "--batch", str(BATCH),
        "--iters", str(ITERS)]
#: JAX's path and parity names → the port's.
PATH_NAMES = {"pallas_stream": "stream_topk", "int8_mxu": "int8_topk", "dense_xla": "dense_torch"}
PARITY_NAMES = {"pallas_vs_dense_top1_agreement": "stream_vs_dense_top1_agreement",
                "int8_vs_dense_top1_agreement": "int8_vs_dense_top1_agreement"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_draws():
    """``bench_gallery.py:main``'s draws."""
    rng = np.random.default_rng(0)
    gal = rng.normal(size=(GALLERY, DIM)).astype(np.float32)
    gal /= np.maximum(np.linalg.norm(gal, axis=1, keepdims=True), 1e-12)
    return gal, rng.normal(size=(ITERS, BATCH, DIM)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    gal, queries = bench_gallery.draws(GALLERY, DIM, BATCH, ITERS)
    return gal, queries, bench_gallery.matchers(torch.as_tensor(gal))


def jax_path(name: str, q: np.ndarray, gal: np.ndarray):
    """The JAX script's matcher of ``name`` on one batch."""
    q, g = jnp.asarray(q), jnp.asarray(gal)
    if name == "pallas_stream":
        out = pallas_cosine_topk(q, g, K, interpret=True)
    elif name == "int8_mxu":
        out = j_cosine_topk_int8(q, *j_quantize(g), K)
    else:
        out = j_cosine_topk(q, g, K)
    return tuple(np.asarray(t) for t in out)


def test_draws_are_jax_inputs():
    """The gallery rows and the queries equal the JAX script's bit for bit."""
    gal, queries = bench_gallery.draws(GALLERY, DIM, BATCH, ITERS)
    ref_gal, ref_queries = jax_draws()
    np.testing.assert_array_equal(gal, ref_gal)
    np.testing.assert_array_equal(queries, ref_queries)


@pytest.mark.parametrize("jax_name", list(PATH_NAMES))
def test_paths_match_jax(jax_name, inputs):
    """Each path's plain version against the JAX function it stands for:
    indices equal, scores within 1e-5 (int8 within 2e-3)."""
    gal, queries, paths = inputs
    s, i = paths[PATH_NAMES[jax_name]](torch.as_tensor(queries[0]), K)
    ref_s, ref_i = jax_path(jax_name, queries[0], gal)
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_allclose(s.numpy(), ref_s, atol=2e-3 if jax_name == "int8_mxu" else 1e-5, rtol=0)


def test_parity_lines_match_jax(inputs):
    """The parity lines of ``bench_gallery.py:100-123`` on the first 64
    queries: the same agreement and, within 1e-5, the same score error."""
    gal, queries, paths = inputs
    q = queries[0][:bench_gallery.PARITY_QUERIES]
    ref_s, ref_i = jax_path("dense_xla", q, gal)
    ref = {}
    for jax_name, metric in (("pallas_stream", "pallas_vs_dense_top1_agreement"),
                             ("int8_mxu", "int8_vs_dense_top1_agreement")):
        s, i = jax_path(jax_name, q, gal)
        ref[PARITY_NAMES[metric]] = (float(np.mean(ref_i[:, 0] == i[:, 0])), float(np.max(np.abs(ref_s - s))))
    for line in bench_gallery.parity(paths, torch.as_tensor(q), K):
        value, err = ref[line["metric"]]
        assert line["value"] == value
        assert abs(line["max_score_err"] - err) <= 1e-5


@pytest.mark.parametrize("skip_dense", [False, True])
def test_main_lines_are_jax(skip_dense, capsys):
    """``main`` on the CPU: the header, the parity lines with the JAX
    lines' keys, then one line per path with the JAX timing line's keys
    and the metric names mapped (no dense line with ``--skip-dense``)."""
    out = bench_gallery.main(ARGV + (["--skip-dense"] if skip_dense else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"# gallery={GALLERY} dim={DIM} batch={BATCH} k={K} device=cpu")
    parity_keys, _, timing_keys = dumped_keys("bench_gallery.py", "main")
    parsed = [json.loads(line) for line in lines[1:]]
    assert [p["metric"] for p in parsed[:2]] == list(PARITY_NAMES.values())
    assert all(list(p) == parity_keys for p in parsed[:2])
    names = [n for j, n in PATH_NAMES.items() if not (skip_dense and j == "dense_xla")]
    assert [p["metric"] for p in parsed[2:]] == [f"gallery_match_qps_{n}_N{GALLERY}" for n in names]
    assert all(list(p) == timing_keys and p["value"] > 0 for p in parsed[2:])
    assert list(out["paths"]) == names and out["lines"] == parsed[:2]
    assert parsed[0]["value"] == 1.0 and parsed[1]["max_score_err"] < 0.02

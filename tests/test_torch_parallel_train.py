"""Data-parallel training of the port on the CPU: spawned gloo ranks against
the port's one-process step and JAX's step on a ``data`` mesh.

JAX's step on a mesh computes the one-device step over the global batch;
the port's ranks (``training/steps.py`` with a ``BatchShard``) must too:
batch norms over the global batch, mixup partners anywhere in it, the
FaceNet miners over the whole batch's embeddings, gradients summed over the
ranks. W = 2 and 4 ranks, given JAX's draws, against the one-process step
and JAX's step on 2 and 4 of the suite's virtual CPU devices, with
``test_torch_train_steps.py``'s tolerances: after three SGD steps every tensor within 2e-3 of its scale,
the losses within 5e-5 relative; FaceNet (adam) within 1e-4 of scale after
two steps. With the draws left to the generator (dropout, mixup), W ranks
draw what one process draws. Two trainer epochs at W = 2, with a save and a
resume, equal W = 1 from the same seed. The models are tiny (a (1,1,1,1)
ResNet at 32², a conv-BN embedder) to keep the spawned ranks short.
"""

import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facerecognition_tpu.models import arcface as jax_arcface
from facerecognition_tpu.parallel import create_mesh as jcreate_mesh
from facerecognition_tpu.parallel import replicate as jreplicate
from facerecognition_tpu.parallel import shard_batch as jshard_batch
from facerecognition_tpu.training import steps as jax_steps
from facerecognition_tpu.training import train_arcface as jax_train_arcface
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.parallel.launch import spawn_ranks
from facerecognition_tpu_torch.utils.imageio import save_png
from test_torch_dp_ranks import (
    B, C, EMB, FS, K, MIXUP, P, S, _rank_run, arc_config, run_facenet_trainer, run_port, run_trainer,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def scale_err(got, want) -> float:
    """max |got - want| / (max |want| + 1e-3)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-3))


class JaxTinyEmbed(nn.Module):
    """A FaceNet-shaped embedder (conv → BN → pool → dense → BN → L2)."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        bn = dict(momentum=0.9, epsilon=1e-3)
        x = nn.Conv(8, (3, 3), strides=(2, 2), padding="VALID", use_bias=False, name="conv")(x)
        x = nn.relu(nn.BatchNorm(use_running_average=not train, name="bn", **bn)(x))
        x = jnp.mean(x, axis=(1, 2))
        x = nn.Dense(16, use_bias=False, name="last_linear")(x)
        x = nn.BatchNorm(use_running_average=not train, name="last_bn", **bn)(x)
        return x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)


# -- JAX on a data mesh ---------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    arc_model = jax_arcface.ArcFaceModel(num_classes=C, embedding_size=EMB, stage_sizes=(1, 1, 1, 1),
                                         dropout=0.0, margin=0.3, easy_margin=False)
    arc_vars = jax.jit(lambda k, x, l: arc_model.init(k, x, labels=l))(
        jax.random.PRNGKey(0), jnp.zeros((2, S, S, 3)), jnp.zeros((2,), jnp.int32))
    fn_model = JaxTinyEmbed()
    fn_vars = fn_model.init(jax.random.PRNGKey(1), jnp.zeros((2, FS, FS, 3)))
    arc_batches = []
    for i in range(3):
        x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
        labels = rng.integers(0, C, B).astype(np.int32)
        _, rng_mix = jax.random.split(jax.random.PRNGKey(i))  # JAX's mixup draws
        rng_lam, rng_perm = jax.random.split(rng_mix)
        lam = float(jax.random.beta(rng_lam, MIXUP, MIXUP))
        perm = np.asarray(jax.random.permutation(rng_perm, B))
        arc_batches.append((x, labels, lam, perm))
    facenet_batches = [rng.normal(size=(P * K, FS, FS, 3)).astype(np.float32) for _ in range(2)]
    return {
        "arc_model": arc_model, "facenet_model": fn_model,
        "arc_vars": jax.tree_util.tree_map(np.asarray, arc_vars),
        "facenet_vars": jax.tree_util.tree_map(np.asarray, fn_vars),
        "arc_batches": arc_batches, "facenet_batches": facenet_batches,
        "pk_labels": np.repeat(np.arange(P), K).astype(np.int32),
    }


def _picklable(data):
    return {k: v for k, v in data.items() if not k.endswith("_model")}


def run_jax(data, world):
    """JAX's steps with the state replicated and each batch sharded over a
    ``world``-device ``data`` mesh."""
    mesh = jcreate_mesh(jax.devices()[:world], data=world)
    shard = functools.partial(jshard_batch, mesh=mesh)
    out = {}
    cfg = arc_config()
    jt = object.__new__(jax_train_arcface.ArcFaceTrainer)
    jt.config, jt.variables = cfg, data["arc_vars"]
    model = data["arc_model"]
    state = jreplicate(jax_steps.ArcFaceTrainState.create(
        apply_fn=model.apply, params=data["arc_vars"]["params"], batch_stats=data["arc_vars"]["batch_stats"],
        tx=jt._build_tx()), mesh)
    jstep = jax.jit(jax_steps.make_arcface_train_step(model, 0.1, MIXUP))
    metrics = []
    for i, (x, labels, _, _) in enumerate(data["arc_batches"]):
        state, m = jstep(state, shard(jnp.asarray(x)), shard(jnp.asarray(labels)), jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    out["arcface"] = {"metrics": metrics, "state": state}
    model = data["facenet_model"]
    for mining in ("semi_hard", "batch_hard"):
        tx = optax.adam(optax.exponential_decay(1e-2, 10, 0.5, staircase=True))
        state = jreplicate(jax_steps.ArcFaceTrainState.create(
            apply_fn=model.apply, params=data["facenet_vars"]["params"],
            batch_stats=data["facenet_vars"]["batch_stats"], tx=tx), mesh)
        jstep = jax.jit(jax_steps.make_facenet_train_step(model, 0.5, mining))
        metrics = []
        for i, x in enumerate(data["facenet_batches"]):
            state, m = jstep(state, shard(jnp.asarray(x)), shard(jnp.asarray(data["pk_labels"])),
                             jax.random.PRNGKey(10 + i))
            metrics.append({k: float(v) for k, v in m.items()})
        out[mining] = {"metrics": metrics, "state": state}
    return out


@pytest.fixture(scope="module")
def one_process(data):
    return run_port(None, _picklable(data))


def _compare_trees(got, want, tol):
    for tree in ("params", "batch_stats"):
        have = dict(jax.tree_util.tree_leaves_with_path(got[tree]))
        for path, value in jax.tree_util.tree_leaves_with_path(want[tree]):
            assert scale_err(have[path], value) < tol, (tree, path, scale_err(have[path], value))


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_steps_equal_one_process_and_jax_mesh(data, one_process, world):
    """Rank 0's metrics and variables after the steps (every rank holds the
    same: the gradients are summed, the statistics global)."""
    ranks = spawn_ranks(_rank_run, world, world, _picklable(data))
    dp = ranks[0]
    for other in ranks[1:]:  # the ranks hold the same model
        for case in dp:
            _compare_trees(other[case]["variables"], dp[case]["variables"], 1e-7)
    jx = run_jax(data, world)
    for case, tol in (("arcface", 2e-3), ("semi_hard", 1e-4), ("batch_hard", 1e-4)):
        for got, want, ref in zip(dp[case]["metrics"], jx[case]["metrics"], one_process[case]["metrics"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=5e-5)
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=5e-5)
            if case == "arcface":
                assert got["train_acc"] == want["train_acc"] == ref["train_acc"]
                np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=2e-4)
            else:
                assert got["n_triplets"] == want["n_triplets"] == ref["n_triplets"] > 0
        state = jx[case]["state"]
        _compare_trees(dp[case]["variables"], {"params": state.params, "batch_stats": state.batch_stats}, tol)
        _compare_trees(dp[case]["variables"], one_process[case]["variables"], tol)
    for case in ("arcface_draws", "facenet_draws"):  # the generator's draws
        for got, ref in zip(dp[case]["metrics"], one_process[case]["metrics"]):
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=5e-5)
        _compare_trees(dp[case]["variables"], one_process[case]["variables"], 2e-3)


# -- the trainers ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def faces(tmp_path_factory):
    """4 identities x 6 PNG faces at 40²."""
    root = tmp_path_factory.mktemp("dp_faces")
    rng = np.random.default_rng(3)
    for pid in range(4):
        os.makedirs(root / f"p{pid}")
        base = rng.integers(40, 200, 3)
        for i in range(6):
            img = rng.integers(0, 60, (40, 40, 3)).astype(np.int64)
            img[4 + pid * 6: 10 + pid * 6] += base
            save_png(str(root / f"p{pid}" / f"{i}.png"), np.clip(img, 0, 255).astype(np.uint8))
    return str(root)


def test_arcface_trainer_two_ranks_equal_one(faces, tmp_path, monkeypatch):
    """``train.num_devices="auto"`` in a 2-rank group: rank 0 writes the
    checkpoints and the history, both ranks resume from them, and two epochs
    (the same batches; augmentation, dropout and mixup drawn by the
    generator) end where one process ends: every tensor within 2e-3 of its
    scale, the train losses within 1e-3 relative (measured 7.3e-4 and
    1.6e-4: a random-init ArcFace head at scale 64 gives gradients of norm
    ~2,900 over 8 samples, and each step carries the rounding of the sums'
    order forward), the same checkpoint files."""
    import facerecognition_tpu_torch.training.train_arcface as ta

    monkeypatch.setattr(ta, "ArcFaceModel", functools.partial(ArcFaceModel, stage_sizes=(1, 1, 1, 1)))
    one = run_trainer(0, faces, str(tmp_path / "one"), "auto")
    assert one["shard"] is None
    ranks = spawn_ranks(run_trainer, 2, faces, str(tmp_path / "two"), "auto")
    for dp in ranks:
        assert dp["shard"].world == 2
        assert dp["files"] == one["files"]
        assert [len(h) for h in dp["history"]] == [len(h) for h in one["history"]] == [1, 2]
        for got_h, want_h in zip(dp["history"][1], one["history"][1]):
            np.testing.assert_allclose(got_h["train_loss"], want_h["train_loss"], rtol=1e-3)
        _compare_trees(dp["variables"], one["variables"], 2e-3)
    _compare_trees(ranks[1]["variables"], ranks[0]["variables"], 1e-7)


def test_facenet_trainer_two_ranks_equal_one(faces, tmp_path):
    """``FaceNetTrainer`` in a 2-rank group keeps the streaming loader (as
    JAX does on a mesh, ``data.resident: auto`` or not), each rank loading
    its rows of the P x K batch and mining over the whole batch: an epoch
    ends where one streaming process ends (adam, lr 1e-4, one step): the
    parameters within 2 lr and their float32 rounding (``test_torch_train_steps.py``'s adam bound:
    adam's first update moves an element by lr, and that of a gradient near
    0 may take either sign; one element measured 2 lr + 3e-9), the
    batch statistics within 2e-3 of their scale, the train loss within 1e-3
    relative, the same checkpoint files."""
    one = run_facenet_trainer(0, faces, str(tmp_path / "one"), "auto")
    assert one["shard"] is None and one["resident"]  # one card may keep the split resident
    ranks = spawn_ranks(run_facenet_trainer, 2, faces, str(tmp_path / "two"), "auto")
    for dp in ranks:
        assert dp["shard"].world == 2 and not dp["resident"]
        assert dp["files"] == one["files"]
        np.testing.assert_allclose(dp["history"][0]["train_loss"], one["history"][0]["train_loss"], rtol=1e-3)
        have = dict(jax.tree_util.tree_leaves_with_path(dp["variables"]["params"]))
        for path, value in jax.tree_util.tree_leaves_with_path(one["variables"]["params"]):
            assert np.abs(have[path] - value).max() <= 2 * 1e-4 + 1e-7, path  # + the float32 rounding
        _compare_trees({"params": {}, "batch_stats": dp["variables"]["batch_stats"]},
                       {"params": {}, "batch_stats": one["variables"]["batch_stats"]}, 2e-3)

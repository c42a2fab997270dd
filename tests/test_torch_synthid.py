"""The port's synthetic-identity ArcFace trainer (``training/train_synthid``)
on the CPU at a tiny size, against the JAX module where their numbers must
agree: the retrieval evaluation, the schedule and margin ramp, the cache and
resume errors, and the serving checkpoint both packages load."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facerecognition_tpu.inference.extract_embeddings import load_arcface_model as jax_load_arcface
from facerecognition_tpu.training import train_synthid as jts
from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
from facerecognition_tpu_torch.training import train_synthid as ts
from facerecognition_tpu_torch.utils.serialization import load_variables, save_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for PyTorch while this module runs: xdist's
    workers share the cores, and one thread fixes the order of the CPU's
    reductions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# The tiny recipe: 8 ids, 3 train + 2 validation samples each (one
# validation sample gives no verification pairs, which both packages
# refuse), B 16, one block a stage, one epoch.
TINY = dict(n_ids=8, train_per_id=3, val_per_id=2, batch_size=16, epochs=1, stage_sizes=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def tiny_cache(tmp_path_factory):
    """The tiny set rendered once, as an npz cache with its fingerprint."""
    path = str(tmp_path_factory.mktemp("synthid") / "tiny.npz")
    ts.load_or_render(ts.SynthIdConfig(**TINY, cache=path), log=lambda *_: None)
    return path


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_evaluate_retrieval_equals_jax():
    rng = np.random.default_rng(0)
    n_ids, d = 12, 16
    tr_labels = np.repeat(np.arange(n_ids), 4)
    va_labels = np.repeat(np.arange(n_ids), 3)
    protos = _unit(rng, n_ids, d)
    tr = _unit(rng, len(tr_labels), d) * 0.3 + protos[tr_labels]
    va = _unit(rng, len(va_labels), d) * 0.5 + protos[va_labels]
    tr /= np.linalg.norm(tr, axis=1, keepdims=True)
    va /= np.linalg.norm(va, axis=1, keepdims=True)
    want = jts.evaluate_retrieval(tr, tr_labels, va, va_labels, n_ids)
    got = ts.evaluate_retrieval(tr, tr_labels, va, va_labels, n_ids)
    assert sorted(got) == sorted(want)
    for key in ("top_1_accuracy", "top_5_accuracy", "auc", "eer"):
        assert got[key] == pytest.approx(want[key], abs=1e-12)
    assert got["eer_threshold"] == pytest.approx(want["eer_threshold"], rel=1e-6)
    assert got["cmc"]["ranks"] == list(want["cmc"]["ranks"])
    np.testing.assert_allclose(got["cmc"]["cmc"], want["cmc"]["cmc"], atol=1e-12)


def test_one_validation_sample_is_refused():
    with pytest.raises(ValueError, match="val_per_id"):
        ts.train_synthid(ts.SynthIdConfig(**{**TINY, "val_per_id": 1}), device="cpu")
    rng = np.random.default_rng(1)
    with pytest.raises(ValueError, match="verification pairs"):
        ts.evaluate_retrieval(_unit(rng, 8, 4), np.arange(8), _unit(rng, 4, 4), np.arange(4), 8)


def test_schedule_and_margin_ramp_match_jax():
    """The SGD chain's schedule (warmup min(total // 20 + 1, 500)) and the
    two-epoch margin ramp, count by count."""
    cfg = ts.SynthIdConfig(**TINY)
    total, spe = 90, 9
    model = ts.build_model(cfg)
    tx = ts.build_tx(model, cfg, total)
    want = optax.warmup_cosine_decay_schedule(0.0, cfg.lr, min(total // 20 + 1, 500), total)
    ramp = ts.margin_ramp(cfg.margin, 2 * spe)
    for c in range(total + 3):
        w = np.float32(want(jnp.asarray(c, jnp.int32)))
        assert abs(np.float32(tx.schedule(c)) - w) <= np.spacing(w)
        jm = cfg.margin * jnp.minimum(jnp.asarray(c, jnp.int32).astype(jnp.float32) / (2 * spe), 1.0)
        assert np.float32(ramp(c)) == np.float32(jm)
    assert tx.grad_clip == 5.0 and tx.weight_decay == cfg.weight_decay and tx.optimizer == "sgd"


def test_cache_fingerprint_errors(tmp_path, tiny_cache):
    with np.load(tiny_cache) as z:
        imgs, labels = z["imgs"], z["labels"]
        assert json.loads(str(z["fingerprint"])) == ts.dataset_fingerprint(ts.SynthIdConfig(**TINY))
    with pytest.raises(ValueError, match="rendered with"):
        ts.load_or_render(ts.SynthIdConfig(**{**TINY, "seed": 5}, cache=tiny_cache), log=lambda *_: None)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, imgs=imgs[:-1], labels=labels[:-1])
    with pytest.raises(ValueError, match="samples, expected"):
        ts.load_or_render(ts.SynthIdConfig(**TINY, cache=legacy), log=lambda *_: None)
    # the same errors in the JAX trainer
    with pytest.raises(ValueError, match="rendered with"):
        jts.train_synthid(jts.SynthIdConfig(**{**TINY, "seed": 5}, cache=tiny_cache), log=lambda *_: None)


def test_train_resume_and_stage_marker(tmp_path, tiny_cache):
    """It trains and evaluates; the crash checkpoint carries the
    ``stage_sizes`` marker; resuming at the last epoch retrains nothing and
    gives the same weights; another depth is refused."""
    ckpt = str(tmp_path / "crash.msgpack")
    cfg = ts.SynthIdConfig(**TINY, cache=tiny_cache, ckpt_path=ckpt)
    variables, history, final = ts.train_synthid(cfg, log=lambda *_: None, device="cpu")
    assert [h["epoch"] for h in history] == [0] and np.isfinite(history[0]["loss"])
    assert 0.0 <= final["top_1_accuracy"] <= 1.0 and 0.0 <= final["auc"] <= 1.0
    tree = load_variables(ckpt)
    assert tuple(np.asarray(tree["stage_sizes"])) == (1, 1, 1, 1)
    assert "arcface" in tree["params"]
    resumed, history2, _ = ts.train_synthid(ts.SynthIdConfig(**TINY, cache=tiny_cache, ckpt_path=ckpt,
                                                             resume=True), log=lambda *_: None, device="cpu")
    assert history2 == history
    np.testing.assert_array_equal(resumed["params"]["fc"]["kernel"], variables["params"]["fc"]["kernel"])
    other = ts.SynthIdConfig(**{**TINY, "stage_sizes": (2, 2, 2, 2)}, cache=tiny_cache, ckpt_path=ckpt, resume=True)
    with pytest.raises(ValueError, match="stage_sizes"):
        ts.train_synthid(other, log=lambda *_: None, device="cpu")


def test_main_checkpoint_loads_in_both_packages(tmp_path, tiny_cache):
    """``main()`` writes the serving checkpoint (margin head stripped,
    ``stage_sizes`` marker); both packages' ``load_arcface_model`` load it
    and embed the same images alike."""
    out, report = str(tmp_path / "synthid.msgpack"), str(tmp_path / "report.json")
    ts.main(["--n-ids", "8", "--train-per-id", "3", "--val-per-id", "2", "--batch-size", "16",
             "--epochs", "1", "--stage-sizes", "1,1,1,1", "--cache", tiny_cache, "--out", out,
             "--report", report, "--device", "cpu"])
    tree = load_variables(out)
    assert "arcface" not in tree["params"]
    assert tuple(np.asarray(tree["stage_sizes"])) == (1, 1, 1, 1)
    with open(report) as f:
        assert json.load(f)["config"]["n_ids"] == 8
    with np.load(tiny_cache) as z:
        faces = z["imgs"][:6]
    got = load_arcface_model(out, device="cpu").embed_uint8(faces)
    want = jax_load_arcface(out).embed_uint8(faces)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_step_takes_given_augmentation_draws():
    """``step_with_aug(draws=...)`` applies the given draws (as the tests
    feed JAX's): the step on draws taken from a generator equals the step
    that takes the same draws itself from the same generator state."""
    cfg = ts.SynthIdConfig(**TINY)
    images = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 112, 112, 3), np.uint8))
    labels = torch.arange(4)
    losses = []
    for given in (False, True):
        model = ts.build_model(cfg)
        state = ts.TrainState(model, ts.build_tx(model, cfg, 10))
        step = ts.make_step_with_aug(cfg, 5)
        gen = torch.Generator().manual_seed(3)
        draws = None
        if given:
            draws = ts.augment_draws(gen, 4, 112, ts.AUG_TIER)
            gen = torch.Generator().manual_seed(3)
            ts.augment_draws(gen, 4, 112, ts.AUG_TIER)  # the same stream position for dropout
        losses.append(float(step(state, images, labels, gen, draws=draws)["loss"]))
    assert losses[0] == losses[1]


def test_serving_checkpoint_of_resnet50_has_no_marker(tmp_path):
    variables = {"params": {"fc": {"kernel": np.zeros((2, 2), np.float32)}, "arcface": {"weight": np.zeros(1)}},
                 "batch_stats": {}}
    ckpt = ts.serving_checkpoint(variables, (3, 4, 6, 3))
    assert "stage_sizes" not in ckpt and "arcface" not in ckpt["params"]
    save_variables(str(tmp_path / "x.msgpack"), ckpt)

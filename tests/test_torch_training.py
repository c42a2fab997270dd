"""The port's training stack against the JAX package's on the CPU: config,
schedules and controllers, samplers, the loader and its PIL-equal
validation resize, the margin head and losses, training-mode forwards (flax's
biased running variance), initialisers, miners, checkpoints, both trainers
and the weight round trip between the packages. Tolerances are stated per
test; the steps themselves are in ``test_torch_train_steps.py``."""

import json
import math
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facerecognition_tpu.data.loader import BatchLoader as JaxBatchLoader
from facerecognition_tpu.data.loader import _load_resize as jax_load_resize
from test_torch_jax_native import jax_native_decoder
from facerecognition_tpu.data.sampler import ClassBalancedSampler as JaxClassBalanced
from facerecognition_tpu.data.sampler import PKSampler as JaxPK
from facerecognition_tpu.models import arcface as jax_arcface
from facerecognition_tpu.models import facenet as jax_facenet
from facerecognition_tpu.training import config as jax_config
from facerecognition_tpu.training import schedules as jax_schedules
from facerecognition_tpu.training import steps as jax_steps
from facerecognition_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from facerecognition_tpu_torch.data.datasets import FolderDataset
from facerecognition_tpu_torch.data.loader import BatchLoader, _load_resize, pil_bilinear_resize
from facerecognition_tpu_torch.data.sampler import ClassBalancedSampler, PKSampler
from facerecognition_tpu_torch.models import facenet
from facerecognition_tpu_torch.models.arcface import ArcFaceModel, arc_margin_logits, freeze_mask
from facerecognition_tpu_torch.models.layers import init_like_flax
from facerecognition_tpu_torch.training import config, schedules, steps
from facerecognition_tpu_torch.training.checkpoint import CheckpointManager
from facerecognition_tpu_torch.utils.imageio import save_png
from facerecognition_tpu_torch.utils.serialization import _host_tree, packb, save_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, and PyTorch's default of one thread a core in each of them
    oversubscribes it (a ResNet50 step then takes minutes). One thread
    also fixes the order of the CPU's reductions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """6 identities x 6 images at 72² (PNG, one JPEG each), none at the
    trainers' sizes, so every read resizes."""
    root = tmp_path_factory.mktemp("faces")
    rng = np.random.default_rng(0)
    for pid in range(6):
        pdir = root / f"person{pid}"
        pdir.mkdir()
        base = rng.integers(40, 200, 3)
        for i in range(6):
            img = rng.integers(0, 60, (72, 72, 3)).astype(np.int64)
            img[10 + pid * 6: 18 + pid * 6, :, :] += base
            img[:, 10 + pid * 8: 14 + pid * 8, :] += base
            img = np.clip(img, 0, 255).astype(np.uint8)
            if i == 5:
                Image.fromarray(img).save(pdir / f"{i}.jpg", quality=90)
            else:
                save_png(str(pdir / f"{i}.png"), img)
    return str(root)


# -- config, schedules, controllers, samplers ---------------------------------------


def test_config_functions_equal_jax(tmp_path):
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": [1, 2]}
    over = {"a": {"c": {"d": 5, "f": 6}}, "g": 7}
    assert config.deep_merge(base, over) == jax_config.deep_merge(base, over)
    dotted = ["a.b=3e-4", "a.c.x=true", "h.i=[1, 2]", "a.b2=null"]
    assert config.apply_dotted_overrides(base, dotted) == jax_config.apply_dotted_overrides(base, dotted)
    with pytest.raises(ValueError):
        config.apply_dotted_overrides(base, ["novalue"])
    path = str(tmp_path / "c.yaml")
    config.save_config(path, {"model": {"margin": 0.2}, "train": {"lr": 0.01}})
    got = config.load_config(path, ["train.lr=0.1"], base)
    assert got == jax_config.load_config(path, ["train.lr=0.1"], base)
    for name in ("arcface_config.yaml", "facenet_config.yaml"):
        p = os.path.join(REPO, "configs", name)
        assert config.load_config(p) == jax_config.load_config(p)


SCHEDULES = [
    dict(schedule="cosine", total_steps=120, warmup_steps=12),
    dict(schedule="cosine", total_steps=120, warmup_steps=0, min_lr=1e-4),
    dict(schedule="step", total_steps=120, warmup_steps=5, step_size=7, gamma=0.5),
    dict(schedule="step", total_steps=120, warmup_steps=0, step_size=30, gamma="3e-1"),
    dict(schedule="constant", warmup_steps=3, warmup_start_factor=0.25),
    dict(schedule="plateau"),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["schedule"] + str(kw.get("warmup_steps", 0)))
def test_build_schedule_equals_optax(kw):
    """Every step 0..150 within 1e-6 relative of optax's float32 value (both
    compute in float32; XLA's cos may differ from numpy's by an ulp)."""
    want = jax_schedules.build_schedule(0.01, **kw)
    got = schedules.build_schedule(0.01, **kw)
    w = np.array([float(want(jnp.int32(c))) for c in range(150)])
    g = np.array([got(c) for c in range(150)])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_build_schedule_rejects_unknown():
    with pytest.raises(ValueError):
        schedules.build_schedule(0.1, "linear")


@pytest.mark.parametrize("mode", ["min", "max"])
def test_controllers_trace_jax(mode):
    metrics = [1.0, 0.9, 0.95, 0.95, 0.97, 0.8, 0.81, 0.82, 0.83, 0.84, 0.84, 0.7, 0.9, 0.9]
    port_p, jax_p = schedules.ReduceOnPlateau(0.5, 2, mode), jax_schedules.ReduceOnPlateau(0.5, 2, mode)
    port_e, jax_e = schedules.EarlyStopping(3, mode), jax_schedules.EarlyStopping(3, mode)
    for m in metrics:
        assert port_p.update(m) == jax_p.update(m)
        assert port_p.state_dict() == jax_p.state_dict()
        assert port_e(m) == jax_e(m)
        assert port_e.state_dict() == jax_e.state_dict()
    fresh = schedules.ReduceOnPlateau()
    fresh.load_state_dict(port_p.state_dict())
    assert fresh.state_dict() == port_p.state_dict()


def test_samplers_equal_jax(image_tree):
    index = FolderDataset(image_tree)
    a, b = iter(ClassBalancedSampler(index, 8, seed=3)), iter(JaxClassBalanced(index, 8, seed=3))
    for _ in range(5):
        np.testing.assert_array_equal(next(a), next(b))
    a, b = iter(PKSampler(index, 3, 4, seed=4)), iter(JaxPK(index, 3, 4, seed=4))
    for _ in range(5):
        np.testing.assert_array_equal(next(a), next(b))
    assert PKSampler(index, 3, 4).epoch_batches() == JaxPK(index, 3, 4).epoch_batches()
    with pytest.raises(ValueError):
        PKSampler(index, 7, 2)


# -- loader ------------------------------------------------------------------------


@pytest.mark.parametrize("size", [64, 80])
def test_batch_loader_equals_jax(image_tree, size):
    """The same batches as the JAX loader's native path, bit for bit, with
    every file resized (72² → 64² and 80²)."""
    jax_native_decoder()  # the suite's workers build it under one lock
    index = FolderDataset(image_tree)
    batches = [np.array([0, 5, 11, 35]), np.array([7, 7, 20]), np.arange(12)]
    port = BatchLoader(index, iter(batches), image_size=size, n_workers=2)
    ref = JaxBatchLoader(index, iter(batches), image_size=size, n_workers=2)
    assert ref._native is not None  # the JAX loader's native path, not PIL
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gi.shape[1:] == (size, size, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("size", [112, 128])
def test_batch_loader_per_file_equals_jax(size):
    """``use_native=False``: each file read alone (the single-file decoder,
    PIL's bilinear resize) gives the JAX loader's per-file PIL batches bit
    for bit, on the committed PNG fixtures (128², resized to 112² and read
    as they are at 128²)."""
    index = FolderDataset(os.path.join(os.path.dirname(__file__), "..",
                                       "facerecognition_tpu_torch", "fixtures", "faces"))
    png = np.array([i for i, p in enumerate(index.paths) if p.endswith(".png")])
    assert len(png) == 16
    batches = [png[:5], png[5:], png[[3, 3, 0]]]
    port = BatchLoader(index, iter(batches), image_size=size, n_workers=2, use_native=False)
    ref = JaxBatchLoader(index, iter(batches), image_size=size, n_workers=2, use_native=False)
    assert ref._native is None  # the JAX loader's per-file PIL path
    got, want = list(port), list(ref)
    port.stop()
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == np.uint8 and gi.shape[1:] == (size, size, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_batch_loader_zero_fills_other_formats(tmp_path, image_tree):
    """A row the decoder rejects (here a BMP, which the JAX loader reads with
    PIL) is zero-filled, with a warning."""
    import shutil

    root = tmp_path / "faces"
    shutil.copytree(image_tree, root)
    Image.new("RGB", (72, 72), (200, 10, 10)).save(root / "person0" / "9.bmp")
    index = FolderDataset(str(root))
    bmp = [i for i, p in enumerate(index.paths) if p.endswith(".bmp")]
    assert len(bmp) == 1
    loader = BatchLoader(index, iter([np.array([bmp[0], 1])]), image_size=64, n_workers=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (imgs, _), = list(loader)
    assert not imgs[0].any() and imgs[1].any()
    assert any("zero-filled" in str(w.message) for w in caught)


def test_benchmark_loader(image_tree):
    from facerecognition_tpu_torch.data.loader import benchmark_loader

    index = FolderDataset(image_tree)
    loader = BatchLoader(index, iter(ClassBalancedSampler(index, 4)), image_size=64, n_workers=1)
    out = benchmark_loader(loader, 3)
    loader.stop()
    assert out["images_per_sec"] > 0 and out["batches_per_sec"] > 0


@pytest.mark.parametrize("size", [40, 64, 112, 160])
def test_load_resize_equals_pil(image_tree, size):
    """``_load_resize`` gives PIL's ``Image.BILINEAR`` pixels (the JAX
    loader's) bit for bit, downscaling (antialiased) and upscaling, on PNG
    and JPEG files."""
    index = FolderDataset(image_tree)
    for path in index.paths[:8] + [p for p in index.paths if p.endswith(".jpg")][:2]:
        np.testing.assert_array_equal(_load_resize(path, size), jax_load_resize(path, size))


@pytest.mark.parametrize("shape", [(200, 150, 112, 112), (37, 53, 160, 160), (1000, 800, 112, 112),
                                   (5, 7, 3, 2), (64, 64, 64, 30)])
def test_pil_bilinear_resize_equals_pil(shape, rng):
    h, w, oh, ow = shape
    for img in (rng.integers(0, 256, (h, w, 3)), rng.integers(0, 256, (h, w))):
        img = img.astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        np.testing.assert_array_equal(pil_bilinear_resize(img, oh, ow), want)


# -- margin head, losses, mixup ---------------------------------------------------


@pytest.mark.parametrize("easy", [True, False])
@pytest.mark.parametrize("margin", [0.2, 0.5, 2.8, "tensor"])
def test_arc_margin_logits_equal_jax(easy, margin, rng):
    """Both branches, a margin past π − θ for most classes (2.8) and a 0-d
    tensor margin: within 2e-5 of the cosine, i.e. 1.28e-3 on logits scaled
    by 64 (the (16, 24) x (24, 10) products sum in another order)."""
    emb = rng.normal(size=(16, 24)).astype(np.float32)
    w = rng.normal(size=(10, 24)).astype(np.float32)
    emb[:5] = w[:5] * 3  # cos θ = 1 on their labels
    labels = np.asarray(list(range(10)) + [1, 2, 3, 4, 5, 6], np.int32)
    m = 0.35 if margin == "tensor" else margin
    want = jax_arcface.arc_margin_logits(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(labels),
                                         64.0, jnp.float32(m), easy)
    got = arc_margin_logits(torch.from_numpy(emb), torch.from_numpy(w), torch.from_numpy(labels),
                            64.0, torch.tensor(m) if margin == "tensor" else m, easy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=64 * 2e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_equals_jax(smoothing, rng):
    logits = (rng.normal(size=(12, 30)) * 10).astype(np.float32)
    labels = rng.integers(0, 30, 12)
    want = jax_steps.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = steps.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_mixup_batch_equals_jax(rng):
    """Given JAX's λ and permutation (drawn as ``mixup_batch`` splits its
    key), the mixed batch equals JAX's within 1e-6."""
    x = rng.normal(size=(8, 6, 6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want, perm, lam = jax_steps.mixup_batch(key, jnp.asarray(x), 0.4)
    k_lam, k_perm = jax.random.split(key)
    assert float(jax.random.beta(k_lam, 0.4, 0.4)) == float(lam)
    got = steps.mixup_batch(torch.from_numpy(x), float(lam), torch.from_numpy(np.asarray(perm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    lam2, perm2 = steps.mixup_draws(torch.Generator().manual_seed(0), 8, 0.4, "cpu")
    assert 0.0 <= lam2 <= 1.0 and sorted(perm2.tolist()) == list(range(8))


# -- training-mode forwards and initialisers ------------------------------------------


def _arc_jax(num_classes=10, emb=32, dropout=0.0, stages=(1, 1, 1, 1)):
    model = jax_arcface.ArcFaceModel(num_classes=num_classes, embedding_size=emb, stage_sizes=stages,
                                     dropout=dropout, margin=0.3, easy_margin=False)
    variables = jax.jit(lambda k, x, l: model.init(k, x, labels=l))(
        jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jnp.zeros((2,), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def arc_default():
    return _arc_jax()


def _arc_port(variables, num_classes=10, emb=32, dropout=0.0, stages=(1, 1, 1, 1)):
    model = ArcFaceModel(emb, stages, num_classes=num_classes, margin=0.3, easy_margin=False,
                         dropout=dropout)
    model.load_state_dict(flax_to_state_dict(variables, include_head=True), strict=True)
    return model


def _assert_stats(model: torch.nn.Module, batch_stats, rtol=1e-5, atol=1e-6):
    got = state_dict_to_flax(model.state_dict())["batch_stats"]
    want = jax.tree_util.tree_leaves_with_path(batch_stats)
    have = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(have) == len(want)
    for path, value in want:
        np.testing.assert_allclose(have[path], np.asarray(value), rtol=rtol, atol=atol, err_msg=str(path))


def _rel(got, want) -> float:
    """max |got - want| / (max |want| + 5e-3): relative to the tensor's
    scale, absolute for tensors near 0 (a running mean of zero-mean
    outputs holds rounding only)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 5e-3))


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("shape", [(6, 5, 5, 8), (6, 16)])
def test_train_batch_norm_equals_flax(eps, shape, rng):
    """One training-mode batch norm against flax's (momentum 0.9): the
    output within 2e-6, the running mean and the biased running variance
    within 1e-6; torch's own update (unbiased, n/(n-1)) would be 3-20% off
    here."""
    import flax.linen as nn

    from facerecognition_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d

    x = (rng.normal(size=shape) * 2 + 1).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=eps)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mutated = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = (BatchNorm2d if len(shape) == 4 else BatchNorm1d)(shape[-1], eps=eps).train()
    xt = torch.from_numpy(x)
    xt = xt.permute(0, 3, 1, 2) if len(shape) == 4 else xt
    got = port(xt)
    got = got.permute(0, 2, 3, 1) if len(shape) == 4 else got
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0, atol=2e-6)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=0, atol=1e-6)
    n = x.size // shape[-1]
    unbiased = 0.9 + 0.1 * x.reshape(-1, shape[-1]).var(0, ddof=1)
    assert np.abs(unbiased - np.asarray(stats["var"])).max() > 10 * (1 / (n - 1)) * 1e-3


def test_arcface_train_forward_equals_jax(arc_default, rng):
    """ResNet (1, 1, 1, 1) ArcFace from flax's initial variables,
    ``train=True``, dropout 0: embeddings, logits and every updated batch
    statistic within 2e-4 of their tensor's max (``_rel``) (measured 5-8e-5: each
    training-mode batch norm renormalises by statistics of 6 samples, which
    magnifies the convolutions' float32 rounding; eval mode agrees within
    2e-6 on the same inputs, and one batch norm alone within 2e-6 above)."""
    model, variables = arc_default
    x = rng.normal(size=(6, 64, 64, 3)).astype(np.float32)
    labels = np.asarray([0, 1, 2, 3, 1, 9], np.int32)
    (logits, emb), mutated = jax.jit(lambda v, x, l: model.apply(v, x, labels=l, train=True,
                                                                  mutable=["batch_stats"]))(
        variables, jnp.asarray(x), jnp.asarray(labels))
    port = _arc_port(variables).train()
    got_logits, got_emb = port(torch.from_numpy(x), labels=torch.from_numpy(labels))
    assert _rel(got_emb.detach(), emb) < 2e-4
    assert _rel(got_logits.detach(), logits) < 2e-4
    have = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(port.state_dict())["batch_stats"]))
    for path, value in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
        assert _rel(have[path], value) < 2e-4, path
    eval_emb = jax.jit(model.apply)(variables, jnp.asarray(x))
    assert _rel(_arc_port(variables).eval()(torch.from_numpy(x)).detach(), eval_emb) < 2e-6


def test_facenet_train_forward_equals_jax(rng):
    """InceptionResnetV1 (the shipped FaceNet weights) at 80², ``train=True``,
    dropout 0: embeddings within 1e-5, every updated BN statistic within
    1e-5 relative (eps 1e-3)."""
    from facerecognition_tpu.utils.serialization import load_variables

    raw = load_variables(os.path.join(REPO, "assets", "facenet_synthid9k_512.msgpack"))
    variables = {k: raw[k] for k in ("params", "batch_stats")}
    x = rng.normal(size=(4, 80, 80, 3)).astype(np.float32)
    jm = jax_facenet.FaceNetModel(dropout=0.0)
    emb, mutated = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    port = facenet.FaceNetModel(512, dropout=0.0)
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(emb), rtol=1e-5, atol=1e-5)
    _assert_stats(port, mutated["batch_stats"], rtol=1e-5, atol=1e-5)


def test_dropout_is_flax_dropout():
    from facerecognition_tpu_torch.models.layers import dropout

    x = torch.ones(2000, 50)
    y = dropout(x, 0.6, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.4) < 0.01
    assert torch.allclose(y[kept], torch.tensor(1 / 0.4))
    assert dropout(x, 0.6, False) is x and dropout(x, 0.0, True) is x


def test_initialisers_match_flax_distributions():
    """Per tensor (at least 1,000 values) the port's standard deviation within
    6% of flax's own init, the truncation at 2 x flax's scale, zero biases,
    unit BN scales, the margin weight inside xavier_uniform's bound."""
    _, variables = _arc_jax(num_classes=200, emb=64)
    want = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    port = init_like_flax(ArcFaceModel(64, (1, 1, 1, 1), num_classes=200),
                          torch.Generator().manual_seed(1), ("fc",))
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(port.state_dict())["params"]))
    assert set(got) == set(want)
    checked = 0
    for path, w in want.items():
        g, leaf = got[path], path[-1].key
        if leaf in ("bias",) or (leaf == "scale"):
            np.testing.assert_array_equal(g, np.asarray(w))
            continue
        if w.size < 1000:
            continue
        assert abs(g.std() / w.std() - 1) < 0.06, path
        if leaf == "kernel":
            fan_in = int(np.prod(w.shape[:-1]))
            scale = 2.0 if path[0].key == "fc" else 1.0
            assert np.abs(g).max() <= 2 * math.sqrt(scale / fan_in) / 0.87962566103423978 + 1e-6
        else:  # the margin weight
            assert np.abs(g).max() <= math.sqrt(6 / sum(w.shape))
        checked += 1
    assert checked >= 8
    irv1 = init_like_flax(facenet.FaceNetModel(512), torch.Generator().manual_seed(2))
    for name, p in irv1.named_parameters():
        if p.ndim >= 2 and p.numel() >= 1000:
            fan_in = p.shape[1] * int(np.prod(p.shape[2:]))
            assert abs(p.std().item() / math.sqrt(1 / fan_in) - 1) < 0.06, name


def test_freeze_mask_equals_jax(arc_default):
    _, variables = arc_default
    port = _arc_port(variables)
    for ratio in (0.0, 0.5, 0.8, 1.0):
        want = jax_arcface.freeze_mask(variables["params"], ratio)
        got = freeze_mask(port, ratio)
        flat = {"/".join(str(k.key) for k in p): v for p, v in jax.tree_util.tree_leaves_with_path(want)}
        for name, trainable in got.items():
            module = ".".join(name.split(".")[:-1])
            prefix = "/".join(module.split("."))
            assert any(k.startswith(prefix + "/") and v == trainable for k, v in flat.items()), name


# -- miners and triplet losses ------------------------------------------------------


def _mining_batch(rng, p=5, k=4, d=16):
    emb = rng.normal(size=(p * k, d)).astype(np.float32)
    emb[3] = emb[7]  # planted ties: equal distances from every anchor
    emb[10] = emb[11]
    emb[14] = emb[2]
    emb = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, np.repeat(np.arange(p), k).astype(np.int32)


@pytest.mark.parametrize("margin", [0.2, 0.5, 1.5])
def test_miners_equal_jax(margin, rng):
    """The miners' indices equal JAX's, ties included (first index, both
    libraries), and the masked loss within 1e-6."""
    emb, labels = _mining_batch(rng)
    je, jl = jnp.asarray(emb), jnp.asarray(labels)
    te, tl = torch.from_numpy(emb), torch.from_numpy(labels).long()
    for port_out, jax_out in ((facenet.mine_semi_hard(te, tl, margin), jax_facenet.mine_semi_hard(je, jl, margin)),
                              (facenet.mine_batch_hard(te, tl), jax_facenet.mine_batch_hard(je, jl))):
        for g, w in zip(port_out, jax_out):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        loss = facenet.masked_triplet_loss(te, *port_out, margin)
        want = jax_facenet.masked_triplet_loss(je, *jax_out, margin)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6, atol=1e-7)
    a, p, n = (emb[i::3][:5] for i in range(3))
    np.testing.assert_allclose(
        facenet.triplet_loss(*(torch.from_numpy(v) for v in (a, p, n)), margin).item(),
        float(jax_facenet.triplet_loss(jnp.asarray(a), jnp.asarray(p), jnp.asarray(n), margin)), rtol=1e-6)


def test_argmin_argmax_take_the_first_index():
    x = torch.tensor([[3.0, 1.0, 1.0, 5.0, 5.0]])
    assert torch.argmin(x, -1).item() == 1 and torch.argmax(x, -1).item() == 3


# -- checkpoints, weights --------------------------------------------------------------


def test_checkpoint_manager_contract(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"), keep_last_n=2)
    tree = {"model": {"w": torch.arange(4.0)}, "opt_state": {"count": 3, "state": {"mu": [torch.ones(2)]}},
            "step": 3}
    for e in range(4):
        ck.save(f"epoch_{e}", tree, {"epoch": e})
    ck.save("best", tree, {"epoch": 9, "x": np.float32(1.5)})
    names = sorted(os.listdir(ck.directory))
    assert names == ["ckpt_best", "ckpt_best.meta.json", "ckpt_epoch_2", "ckpt_epoch_2.meta.json",
                     "ckpt_epoch_3", "ckpt_epoch_3.meta.json"]
    assert ck.latest_epoch_tag() == "epoch_3" and ck.exists("best") and not ck.exists("epoch_0")
    got, meta = ck.restore("epoch_3")
    assert torch.equal(got["model"]["w"], tree["model"]["w"]) and meta == {"epoch": 3}
    assert got["opt_state"]["count"] == 3 and got["step"] == 3
    with pytest.raises(FileNotFoundError):
        ck.restore("last")


def test_save_variables_writes_flax_bytes(tmp_path):
    """The msgpack writer gives ``flax.serialization.msgpack_serialize``'s
    bytes, on a shipped checkpoint and on every leaf kind."""
    import flax.serialization

    from facerecognition_tpu.utils.serialization import load_variables

    v = load_variables(os.path.join(REPO, "assets", "arcface_synthid9k_ultraslim_512.msgpack"))
    assert packb(_host_tree(v)) == flax.serialization.msgpack_serialize(v)
    tree = {"b": {"x": np.arange(300, dtype=np.int64), "y": np.float32(3.5), "s": "k" * 40, "n": -5,
                  "m": -200, "big": 70000, "f": 1.5, "t": True, "none": None, "l": [1, 2, 3] * 7,
                  "e": np.zeros((0, 3), np.float32), "u": np.ones(1, np.uint8)}, "a": {}}
    assert packb(_host_tree(tree)) == flax.serialization.msgpack_serialize(tree)
    path = str(tmp_path / "w" / "t.msgpack")
    save_variables(path, {"params": {"w": torch.ones(2, 3)}})
    assert np.array_equal(load_variables(path)["params"]["w"], np.ones((2, 3), np.float32))


def test_state_dict_to_flax_inverts_on_shipped_assets():
    from facerecognition_tpu.utils.serialization import load_variables

    for name in ("arcface_synthid9k_ultraslim_512.msgpack", "facenet_synthid9k_512.msgpack"):
        raw = load_variables(os.path.join(REPO, "assets", name))
        v = {k: raw[k] for k in ("params", "batch_stats")}
        back = state_dict_to_flax(flax_to_state_dict(v, include_head=True))
        a = jax.tree_util.tree_leaves_with_path(v)
        b = jax.tree_util.tree_leaves_with_path(back)
        assert [p for p, _ in a] == [p for p, _ in b]
        assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


def test_port_weights_serve_in_jax(tmp_path, rng):
    """Port variables → ``save_variables`` → the JAX package's
    ``load_variables`` → JAX embeddings equal the port's within 1e-4; the
    port's loader reads the same file."""
    from facerecognition_tpu.utils.serialization import load_variables
    from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_checkpoint

    port = init_like_flax(ArcFaceModel(512, (1, 1, 1, 1), num_classes=20), torch.Generator().manual_seed(3),
                          ("fc",)).train()
    port(torch.from_numpy(rng.normal(size=(8, 112, 112, 3)).astype(np.float32)))  # move the BN stats
    variables = state_dict_to_flax(port.state_dict())
    variables["stage_sizes"] = np.asarray([1, 1, 1, 1], np.int32)
    path = str(tmp_path / "trained.msgpack")
    save_variables(path, variables)
    loaded = load_variables(path)
    x = rng.normal(size=(3, 112, 112, 3)).astype(np.float32)
    jm = jax_arcface.ArcFaceModel(num_classes=20, stage_sizes=(1, 1, 1, 1))
    want = jax.jit(jm.apply)({k: loaded[k] for k in ("params", "batch_stats")}, jnp.asarray(x))
    got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    served = load_arcface_checkpoint(path).eval()
    assert served.stage_sizes == (1, 1, 1, 1)
    np.testing.assert_allclose(served(torch.from_numpy(x)).detach().numpy(), got.detach().numpy(), atol=1e-6)


# -- trainers -----------------------------------------------------------------------------


def _arc_cfg(image_tree, ck, **train):
    return {
        "data": {"data_dir": image_tree, "image_size": 32, "val_frac": 0.25, "augmentation": "light",
                 "num_workers": 2, "min_images": 1},
        "train": {"batch_size": 12, "num_epochs": 2, "steps_per_epoch": 2, "lr": 0.01, "warmup_epochs": 0,
                  "early_stopping_patience": 50, **train},
        "eval": {"num_pairs": 60, "batch_size": 32},
        "checkpoint": {"dir": ck, "keep_last_n": 1, "save_every_epochs": 1},
    }


def test_arcface_trainer_checkpoint_resume(image_tree, tmp_path):
    """The JAX trainer test's contract (``tests/test_training.py``): two
    epochs, best/last written, history JSON, resume auto-extends and keeps
    the history; a third epoch; periodic checkpoints GC'd to keep_last_n;
    the exported variables serve."""
    from facerecognition_tpu_torch.training.train_arcface import ArcFaceTrainer

    cfg = _arc_cfg(image_tree, str(tmp_path / "ck"))
    trainer = ArcFaceTrainer(cfg, device="cpu")
    history = trainer.train()
    assert len(history) == 2 and all(np.isfinite(h["train_loss"]) for h in history)
    assert trainer.ckpt.exists("best") and trainer.ckpt.exists("last")
    with open(os.path.join(trainer.ckpt.directory, "training_history.json")) as f:
        assert json.load(f) == history
    assert trainer.state.step == 4 and trainer.global_step == 4

    t2 = ArcFaceTrainer(cfg, device="cpu")
    t2.resume("last")
    assert t2.epoch == 2 and t2.history == history
    assert t2.config["train"]["num_epochs"] > 2  # auto-extend
    assert t2.state.step == 4 and t2.state.tx.count == 4
    for a, b in zip(t2.model.state_dict().values(), trainer.model.state_dict().values()):
        assert torch.equal(a, b)
    t2.config["train"]["num_epochs"] = 3
    h2 = t2.train()
    assert len(h2) == 3
    assert sorted(n for n in os.listdir(t2.ckpt.directory) if n.startswith("ckpt_epoch_")) == [
        "ckpt_epoch_2", "ckpt_epoch_2.meta.json"]
    t3 = ArcFaceTrainer(cfg, device="cpu")
    t3.resume("last", reset_optimizer=True, extend_epochs=2)
    assert t3.config["train"]["num_epochs"] == 5 and t3.state.tx.count == 0


def test_arcface_trainer_rejects_data_parallel(image_tree, tmp_path):
    from facerecognition_tpu_torch.training.train_arcface import ArcFaceTrainer
    from facerecognition_tpu_torch.training.train_facenet import FaceNetTrainer

    # Without a torch.distributed group of that many ranks (torchrun), a
    # data-parallel count is refused: processes cannot be dropped as JAX
    # drops devices (the data-parallel trainers: test_torch_parallel_train.py).
    for n in (2, 8):
        with pytest.raises(ValueError, match="torch.distributed group of"):
            ArcFaceTrainer(_arc_cfg(image_tree, str(tmp_path / "a"), num_devices=n), device="cpu")
        with pytest.raises(ValueError, match="torch.distributed group of"):
            FaceNetTrainer({"data": {"data_dir": image_tree}, "train": {"num_devices": n}}, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ArcFaceTrainer(_arc_cfg(image_tree, str(tmp_path / "b")))


def test_validation_metrics_equal_jax(image_tree, rng):
    """``compute_verification_accuracy`` and both trainers' validation
    metrics (ver_acc, threshold, val_loss, val_acc; d(a,p), d(a,n)) equal the
    JAX trainers' on the same embeddings (the JAX ``validate`` run with its
    eval step returning them): within 1e-6."""
    from facerecognition_tpu.data.datasets import FolderDataset as JaxFolder
    from facerecognition_tpu.training import train_arcface as jta
    from facerecognition_tpu.training import train_facenet as jtf
    from facerecognition_tpu_torch.training import train_arcface as pta
    from facerecognition_tpu_torch.training import train_facenet as ptf

    index, jindex = FolderDataset(image_tree), JaxFolder(image_tree)
    emb = rng.normal(size=(len(index), 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = index.labels
    assert jta.compute_verification_accuracy(emb, labels, 300, 2) == pta.compute_verification_accuracy(
        emb, labels, 300, 2)
    w = rng.normal(size=(6, 16)).astype(np.float32)
    cfg = {"data": {"image_size": 32}, "eval": {"batch_size": 10, "num_pairs": 200},
           "train": {"seed": 1, "margin": 0.5}, "model": {"scale": 64.0}}
    chunks = iter(emb[i:i + 10] for i in range(0, len(emb), 10))

    jt = object.__new__(jta.ArcFaceTrainer)
    jt.config, jt.val_index = cfg, jindex
    jt.state = types.SimpleNamespace(params={"arcface": {"weight": jnp.asarray(w)}})
    jt._eval_step = lambda state, imgs: next(chunks)
    want = jt.validate()
    pt = object.__new__(pta.ArcFaceTrainer)
    pt.config = cfg
    pt.model = types.SimpleNamespace(arcface=types.SimpleNamespace(weight=torch.from_numpy(w)))
    got = pt.validation_metrics(emb, labels)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)

    chunks = iter(np.concatenate([emb[i:i + 10], np.zeros((10 - len(emb[i:i + 10]), 16), np.float32)])
                  for i in range(0, len(emb), 10))
    jf = object.__new__(jtf.FaceNetTrainer)
    jf.config, jf.val_index = cfg, jindex
    jf.state = None
    jf._eval_step = lambda state, imgs: next(chunks)
    want = jf.validate()
    pf = object.__new__(ptf.FaceNetTrainer)
    pf.config = cfg
    got = pf.validation_metrics(emb, labels)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_facenet_trainer_runs_and_warm_starts(image_tree, tmp_path):
    """A short FaceNetTrainer run (80², P 3 x K 2, resident split), then a
    batch_hard warm start from its checkpoint: weights carried over bit for
    bit, the optimizer fresh; a mismatched ``init_from`` raises."""
    from facerecognition_tpu_torch.training.train_facenet import FaceNetTrainer

    cfg = {
        "data": {"data_dir": image_tree, "image_size": 80, "val_frac": 0.34, "augmentation": "light",
                 "num_workers": 2, "min_images": 1},
        "train": {"p_identities": 3, "k_images": 2, "num_epochs": 1, "steps_per_epoch": 2, "lr": 1e-4},
        "eval": {"num_pairs": 40, "batch_size": 16},
        "checkpoint": {"dir": str(tmp_path / "fn"), "keep_last_n": 2},
    }
    trainer = FaceNetTrainer(cfg, device="cpu")
    history = trainer.train()
    assert len(history) == 1 and np.isfinite(history[0]["train_loss"])
    assert {"val_loss", "ver_acc", "d_ap", "d_an", "avg_triplets"} <= set(history[0])
    assert trainer._resident_data is not None and trainer.ckpt.exists("last")
    cfg2 = {**cfg, "train": {**cfg["train"], "mining": "batch_hard", "lr": 1e-5,
                             "init_from": f"{tmp_path / 'fn'}:last"},
            "checkpoint": {"dir": str(tmp_path / "fn2"), "keep_last_n": 2}}
    t2 = FaceNetTrainer(cfg2, device="cpu")
    restored, _ = trainer.ckpt.restore("last")
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, restored["model"][k]), k
    assert t2.state.step == 0 and t2.state.tx.count == 0
    save_variables(str(tmp_path / "wrong.msgpack"), {"params": {"x": np.zeros(3)}, "batch_stats": {}})
    cfg3 = {**cfg, "train": {**cfg["train"], "init_from": str(tmp_path / "wrong.msgpack")}}
    with pytest.raises(ValueError, match="does not match"):
        FaceNetTrainer(cfg3, device="cpu")

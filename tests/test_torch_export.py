"""The reference-layout ``.pth`` both ways: the port reads an ArcFace
checkpoint as the JAX loader does, writes the serving msgpack files as the
JAX exporter does, and exports a FaceNet training checkpoint to msgpack.

``convert.arcface_state_dict`` follows ``port_torch.arcface_key_map``'s
rules (torchvision's ``layer{s}.{b}``/``downsample.0/1`` renamed, the
backbone's ``fc``, the margin head and ``num_batches_tracked`` dropped); the
embeddings from a ResNet50 ``.pth`` must equal JAX ``load_arcface_model``'s
within 1e-4 (both in float32 on the CPU, convolutions summed in another
order). The export maps are held bit for bit to ``port_torch``'s.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference import extract_embeddings as jee
from facerecognition_tpu.models import port_torch
from facerecognition_tpu.models.arcface import ArcFaceModel as JaxArcFace
from facerecognition_tpu.utils.serialization import load_variables as jax_load_variables
from facerecognition_tpu_torch import convert
from facerecognition_tpu_torch.inference import extract_embeddings as pee
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR
from facerecognition_tpu_torch.scripts import export_facenet, export_torch
from facerecognition_tpu_torch.utils.serialization import load_variables

EMB_TOL = 1e-4
ULTRASLIM = f"{ASSETS_DIR}/arcface_synthid9k_ultraslim_512.msgpack"
FACENET = f"{ASSETS_DIR}/facenet_synthid9k_512.msgpack"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reference_arcface_pth(path: str, embedding_size: int, seed: int = 0) -> None:
    """A ResNet50 ArcFace in the reference's layout, as the JAX package
    writes it (``export_arcface_state_dict`` + ``save_torch_checkpoint``),
    from a seeded flax init with random batch-norm statistics, plus the
    torchvision classifier and the margin head the reference also saves."""
    variables = JaxArcFace(embedding_size=embedding_size).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 112, 112, 3)))
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape) if p[-1].key in ("scale", "var")
                      else rng.normal(0, 0.1, v.shape) if p[-1].key in ("bias", "mean")
                      else np.asarray(v)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, dict(variables)))
    sd = port_torch.export_arcface_state_dict(variables)
    sd["backbone.fc.weight"] = rng.normal(0, 1, (1000, 2048)).astype(np.float32)
    sd["backbone.fc.bias"] = np.zeros(1000, np.float32)
    sd["arcface.weight"] = rng.normal(0, 1, (7, embedding_size)).astype(np.float32)
    port_torch.save_torch_checkpoint(path, sd)


@pytest.mark.parametrize("embedding_size", [2048, 96])
def test_reference_pth_arcface_matches_jax(tmp_path, embedding_size):
    """The port's ArcFace loader reads a reference ResNet50 ``.pth`` (it
    raised ``ValueError: trailing bytes after msgpack object`` before), to
    JAX's embeddings; a square ``fc`` (2048) would hide a transposed
    weight behind the right shape, 96 would not."""
    path = str(tmp_path / "arcface.pth")
    reference_arcface_pth(path, embedding_size)
    x = np.random.default_rng(1).uniform(0, 255, (2, 112, 112, 3)).astype(np.float32)
    got_model = pee.load_arcface_model(path, embedding_size=embedding_size, device="cpu")
    assert got_model.config.stage_sizes == (3, 4, 6, 3)
    got = got_model.embed_uint8(x)
    want = np.asarray(jee.load_arcface_model(path, embedding_size=embedding_size).embed_uint8(x))
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_TOL)
    # the check sees a transposed fc: the same shapes, another embedding
    model = pee.load_arcface_checkpoint(path, embedding_size)
    with torch.no_grad():
        model.fc.weight.copy_(model.fc.weight.T.clone() if embedding_size == 2048 else model.fc.weight * 0.5)
    wrong = pee.Embedder(got_model.config, model, device="cpu").embed_uint8(x)
    assert np.abs(wrong - want).max() > 10 * EMB_TOL


def test_arcface_key_map():
    assert convert.arcface_key("backbone.layer2.3.downsample.0.weight") == \
        "backbone.layer2_3.downsample_conv.weight"
    assert convert.arcface_key("backbone.layer4.0.downsample.1.running_var") == \
        "backbone.layer4_0.downsample_bn.running_var"
    assert convert.arcface_key("backbone.conv1.weight") == "backbone.conv1.weight"
    for dropped in ("backbone.fc.weight", "arcface.weight", "bn1.num_batches_tracked"):
        assert convert.arcface_key(dropped) is None
    for kept in ("bn1.weight", "fc.bias", "bn2.running_mean"):
        assert convert.arcface_key(kept) == kept


def test_pth_with_pickled_objects_is_refused(tmp_path):
    """A reference checkpoint that pickles more than tensors beside its
    state dict (a numpy scalar, as trainers store a best accuracy): the JAX
    loader unpickles it (``weights_only=False``); the port loads tensors
    only and refuses it with torch's ``UnpicklingError`` naming the
    global, rather than run arbitrary pickled code."""
    sd = {"fc.weight": torch.zeros(2, 2)}
    path = str(tmp_path / "wrapped.pth")
    torch.save({"model_state_dict": sd, "best_acc": np.float64(0.9), "epoch": 3}, path)
    assert set(port_torch.load_torch_checkpoint(path)) == {"fc.weight"}
    with pytest.raises(pickle.UnpicklingError, match="[Ww]eights only"):
        convert.load_torch_checkpoint(path)
    torch.save({"model_state_dict": sd, "epoch": 3}, path)  # tensors and numbers only
    assert set(convert.load_torch_checkpoint(path)) == {"fc.weight"}


def test_export_maps_equal_jax():
    arc = load_variables(ULTRASLIM)
    arc.pop("stage_sizes")
    got, want = convert.export_arcface_state_dict(arc), port_torch.export_arcface_state_dict(arc)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    fn = load_variables(FACENET)
    for prefix in ("model.", ""):
        got = convert.export_facenet_state_dict(fn, prefix=prefix)
        want = port_torch.export_facenet_state_dict(fn, prefix=prefix)
        assert list(got) == list(want)
        assert all(np.array_equal(got[k].numpy(), want[k]) for k in got)


@pytest.mark.parametrize("model", ["arcface", "facenet"])
def test_export_torch_round_trip(tmp_path, model):
    """``scripts/export_torch``: msgpack → ``.pth`` → the port's loader
    gives the msgpack's embeddings exactly (an ultraslim ArcFace too: the
    loader counts its blocks); the file holds ``model_state_dict`` as the
    JAX script writes it."""
    ckpt = ULTRASLIM if model == "arcface" else FACENET
    out = str(tmp_path / f"{model}.pth")
    info = export_torch.main(["--model", model, "--ckpt", ckpt, "--out", out, "--device", "cpu"])
    assert set(torch.load(out, weights_only=True)) == {"model_state_dict"}
    load = pee.load_arcface_model if model == "arcface" else pee.load_facenet_model
    x = np.random.default_rng(3).uniform(0, 255, (2, 112, 112, 3)).astype(np.float32)
    a, b = (load(p, device="cpu").embed_uint8(x) for p in (ckpt, out))
    np.testing.assert_array_equal(a, b)
    if model == "arcface":
        assert info["stage_sizes"] == (1, 1, 1, 1)
        assert pee.load_arcface_model(out, device="cpu").config.stage_sizes == (1, 1, 1, 1)


def test_export_facenet_from_a_training_checkpoint(tmp_path):
    """``scripts/export_facenet``: the port's ``ckpt_best/`` → a msgpack
    that JAX's reader and the port's loader read to the same weights."""
    from facerecognition_tpu_torch.models.facenet import FaceNetModel
    from facerecognition_tpu_torch.training.checkpoint import CheckpointManager

    torch.manual_seed(0)
    model = FaceNetModel(512)
    CheckpointManager(str(tmp_path / "ck")).save(
        "best", {"model": model.state_dict(), "step": 7}, {"history": [{"epoch": 2, "val_loss": 0.5}]})
    out = str(tmp_path / "facenet.msgpack")
    meta = export_facenet.main(["--ckpt-dir", str(tmp_path / "ck"), "--tag", "best", "--out", out,
                                "--device", "cpu"])
    assert meta["history"][-1]["epoch"] == 2
    ours, theirs = load_variables(out), jax_load_variables(out)
    flat = convert.flax_to_state_dict(ours)
    assert set(ours) == {"params", "batch_stats"} == set(theirs)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(flat[k].numpy(), v.numpy() if not k.endswith("tracked") else 0)
    back = jax.tree_util.tree_leaves(theirs)
    assert sum(np.asarray(v).size for v in back) == sum(
        v.numel() for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked"))
    loaded = pee.load_facenet_model(out, device="cpu").model
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v) or k.endswith("num_batches_tracked")

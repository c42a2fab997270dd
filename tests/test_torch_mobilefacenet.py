"""MobileFaceNet of the port against the JAX model on the CPU.

A JAX random init at 112² (``PRNGKey(0)``) is carried across by
``convert.flax_to_state_dict`` (depthwise kernels HWIO with
``feature_group_count`` → OIHW with ``groups``, the PReLU slopes), and the
same numpy inputs go through both: the embedding in evaluation mode, the
training-mode forward with its batch statistics and running-statistics
update, and one ``make_arcface_train_step`` step of ``MobileFaceNetArcFace``
(SGD) against JAX's. Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facerecognition_tpu.models import mobilefacenet as jmfn
from facerecognition_tpu.training import steps as jax_steps
from facerecognition_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from facerecognition_tpu_torch.models.mobilefacenet import MobileFaceNet, MobileFaceNetArcFace
from facerecognition_tpu_torch.training import steps
from facerecognition_tpu_torch.training.optim import OptaxChain

B, EMB, C = 4, 64, 6


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


@pytest.fixture(scope="module")
def head_init():
    model = jmfn.MobileFaceNetArcFace(num_classes=C, embedding_size=EMB, margin=0.3)
    variables = jax.jit(lambda k, x, l: model.init(k, x, labels=l))(
        jax.random.PRNGKey(0), jnp.zeros((2, 112, 112, 3)), jnp.zeros((2,), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _backbone_vars(variables):
    return {k: variables[k]["backbone"] for k in ("params", "batch_stats")}


def test_convert_round_trip_and_layouts(head_init):
    """Every flax leaf comes back bit for bit; a depthwise kernel (3, 3, 1,
    C) becomes (C, 1, 3, 3), a PReLU slope stays ``prelu``."""
    _, variables = head_init
    sd = flax_to_state_dict(variables, include_head=True)
    model = MobileFaceNetArcFace(C, EMB, margin=0.3)
    model.load_state_dict(sd, strict=True)
    assert sd["backbone.stage0_0.dw.conv.weight"].shape == (128, 1, 3, 3)
    assert sd["backbone.gdconv.weight"].shape == (512, 1, 7, 7)
    assert torch.equal(sd["backbone.conv1.prelu"], torch.full((64,), 0.25))
    back = state_dict_to_flax(model.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value)


def test_embedding_eval_mode_equals_jax(head_init, rng):
    """Evaluation mode (running statistics): within 1e-5 of the embedding's
    scale (measured 1.4e-6)."""
    _, variables = head_init
    x = rng.normal(size=(B, 112, 112, 3)).astype(np.float32)
    want = np.asarray(jmfn.MobileFaceNet(embedding_size=EMB).apply(_backbone_vars(variables), jnp.asarray(x)))
    port = MobileFaceNet(EMB)
    port.load_state_dict(flax_to_state_dict(_backbone_vars(variables)), strict=True)
    got = port.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (B, EMB)
    assert scale_err(got, want) < 1e-5


def test_training_mode_equals_jax(head_init, rng):
    """Training mode: batch statistics over the batch, and flax's running
    statistics update (momentum 0.9, biased variance): the embedding within
    1e-4 of its scale, every running statistic within 1e-3 of its tensor's
    scale (training-mode batch norms over 4 samples magnify rounding through
    the 50 layers: measured at most 1.1e-4)."""
    _, variables = head_init
    x = rng.normal(size=(B, 112, 112, 3)).astype(np.float32)
    want, mutated = jmfn.MobileFaceNet(embedding_size=EMB).apply(
        _backbone_vars(variables), jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = MobileFaceNet(EMB)
    port.load_state_dict(flax_to_state_dict(_backbone_vars(variables)), strict=True)
    got = port.train()(torch.from_numpy(x))
    assert scale_err(got.detach().numpy(), want) < 1e-4
    stats = state_dict_to_flax(port.state_dict())["batch_stats"]
    have = dict(jax.tree_util.tree_leaves_with_path(stats))
    for path, value in jax.tree_util.tree_leaves_with_path(mutated["batch_stats"]):
        assert scale_err(have[path], value) < 1e-3, path


class _WithMarginArgument:
    """JAX's ``make_arcface_train_step`` passes ``margin_override`` to its
    model, which ``MobileFaceNetArcFace`` does not take: the step is given
    the model's ``apply`` without it (None: the head's own margin)."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, margin_override=None, **kwargs):
        assert margin_override is None
        return self.model.apply(variables, *args, **kwargs)


def _port_step(variables, x, labels, dtype):
    port = MobileFaceNetArcFace(C, EMB, margin=0.3)
    port.load_state_dict(flax_to_state_dict(variables, include_head=True), strict=True)
    port = port.to(dtype)
    pstate = steps.TrainState(port, OptaxChain(dict(port.named_parameters()), "sgd", lambda c: 0.05,
                                               momentum=0.9))
    metrics = steps.make_arcface_train_step(0.1)(
        pstate, torch.from_numpy(x).to(dtype), torch.from_numpy(labels).long())
    return metrics, state_dict_to_flax({k: v.float() if v.is_floating_point() else v
                                        for k, v in port.state_dict().items()})


def test_arcface_train_step_equals_jax(head_init, rng):
    """One ``make_arcface_train_step`` step (label smoothing 0.1, SGD with
    momentum): loss within 5e-5 relative, train accuracy equal, the
    gradients' norm within 2e-4 relative. Every parameter and batch
    statistic after the step within the larger of 2e-3 of its tensor's
    scale (``test_torch_train_steps.py``'s SGD tolerance) and twice the sum of the two float32
    steps' own errors against the same step in float64 (the port's, run in
    float64): training-mode batch norms over 4 samples through 50 layers
    leave some batch-norm biases' gradients mostly rounding (the worst
    measured 1.3e-2 of scale off JAX)."""
    model, variables = head_init
    x = rng.normal(size=(B, 112, 112, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)
    tx = optax.sgd(0.05, momentum=0.9)
    state = jax_steps.ArcFaceTrainState.create(apply_fn=model.apply, params=variables["params"],
                                               batch_stats=variables["batch_stats"], tx=tx)
    jstep = jax.jit(jax_steps.make_arcface_train_step(_WithMarginArgument(model), 0.1))
    state, jm = jstep(state, jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(0))

    pm, got = _port_step(variables, x, labels, torch.float32)
    _, exact = _port_step(variables, x, labels, torch.float64)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=5e-5)
    assert pm["train_acc"].item() == float(jm["train_acc"])
    np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-4)
    for tree in ("params", "batch_stats"):
        have = dict(jax.tree_util.tree_leaves_with_path(got[tree]))
        own = dict(jax.tree_util.tree_leaves_with_path(exact[tree]))
        for path, value in jax.tree_util.tree_leaves_with_path(getattr(state, tree)):
            bound = max(2e-3, 2 * (scale_err(have[path], own[path]) + scale_err(value, own[path])))
            assert scale_err(have[path], value) < bound, (tree, path)

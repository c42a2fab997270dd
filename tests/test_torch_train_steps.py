"""The port's train steps and optimizer chains against the JAX package's on
the CPU: three ArcFace steps from JAX's initial variables per optimizer
chain (``train_arcface._build_tx``: SGD with weight decay, an active clip
and a cosine warmup; adam; adamw; plateau with a written scale; freeze_ratio
0.5; the margin schedule), and two FaceNet steps per mining mode on a small
embedder of the same shape (conv → BN → pool → linear → BN → L2). Losses,
train accuracy, raw-gradient norms, parameters and batch statistics are
compared with the tolerances stated below."""

import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from facerecognition_tpu.models import arcface as jax_arcface
from facerecognition_tpu.training import steps as jax_steps
from facerecognition_tpu.training import train_arcface as jax_train_arcface
from facerecognition_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.models.layers import BatchNorm1d, BatchNorm2d, dropout
from facerecognition_tpu_torch.training import steps, train_arcface
from facerecognition_tpu_torch.training.optim import OptaxChain, global_norm
from facerecognition_tpu_torch.training.schedules import build_schedule

B, S, C, EMB = 8, 32, 10, 32
SPE = 3  # steps per epoch

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



def scale_err(got, want) -> float:
    """max |got - want| / (max |want| + 1e-3)."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-3))


def arc_config(**changes) -> dict:
    cfg = {
        "model": {"embedding_size": EMB, "scale": 64.0, "margin": 0.3, "easy_margin": False,
                  "dropout": 0.0, "freeze_ratio": 0.0},
        "train": {"num_epochs": 4, "steps_per_epoch": SPE, "optimizer": "sgd", "lr": 0.05, "momentum": 0.9,
                  "weight_decay": 5e-4, "schedule": "cosine", "warmup_epochs": 1, "step_size_epochs": 10,
                  "gamma": 0.1, "grad_clip": 0.5, "label_smoothing": 0.1, "mixup_alpha": 0.0,
                  "margin_warmup_epochs": 0, "margin_start": 0.0},
    }
    for key, value in changes.items():
        section, _, name = key.partition("__")
        cfg[section][name] = value
    return cfg


ARC_CASES = {
    "sgd": arc_config(),
    "adam": arc_config(train__optimizer="adam", train__lr=1e-3),
    "adamw": arc_config(train__optimizer="adamw", train__lr=1e-3, train__weight_decay=0.05),
    "plateau": arc_config(train__schedule="plateau", train__warmup_epochs=0),
    "freeze": arc_config(model__freeze_ratio=0.5),
    "margin": arc_config(train__margin_warmup_epochs=1, train__margin_start=0.05),
}


@pytest.fixture(scope="module")
def arc_init():
    m = arc_config()["model"]
    model = jax_arcface.ArcFaceModel(num_classes=C, embedding_size=EMB, stage_sizes=(1, 1, 1, 1),
                                     dropout=0.0, margin=m["margin"], easy_margin=m["easy_margin"])
    variables = jax.jit(lambda k, x, l: model.init(k, x, labels=l))(
        jax.random.PRNGKey(0), jnp.zeros((2, S, S, 3)), jnp.zeros((2,), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def jax_margin_schedule(cfg):
    """The JAX trainer's margin ramp (``train_arcface._setup_optimizer``)."""
    t = cfg["train"]
    if t["margin_warmup_epochs"] <= 0:
        return None
    m_final, m_start, warm = cfg["model"]["margin"], t["margin_start"], t["margin_warmup_epochs"] * SPE

    def schedule(step):
        frac = jnp.clip(step.astype(jnp.float32) / warm, 0, 1)
        return m_start + frac * (m_final - m_start)

    return schedule


@pytest.mark.parametrize("case", sorted(ARC_CASES))
def test_arcface_steps_equal_jax(case, arc_init, rng):
    """Three steps: loss within 5e-5 relative, train_acc equal, the raw
    gradients' norm within 2e-4 relative. Then, with SGD (plain, plateau,
    frozen, margin ramp), every parameter and batch statistic within 2e-3 of
    its tensor's scale (``scale_err``; measured at most 1.1e-3: the
    gradients agree within 1.5e-4 (below) and training-mode batch norms over
    8 samples magnify the difference step by step); with adam and adamw
    within 2·lr: their updates are ±lr·mu/sqrt(nu), and the gradients a
    batch norm zeroes (``fc.bias``, ``bn1.bias``: rounding of either sign)
    move by a whole lr (measured 0.77 and 0.99 lr), their batch statistics
    within 2e-3 of scale as SGD's (measured 4.5e-4 and 5.8e-4). Frozen
    tensors stay bit-equal to their start."""
    cfg = ARC_CASES[case]
    model, variables = arc_init
    jt = object.__new__(jax_train_arcface.ArcFaceTrainer)
    jt.config, jt.variables = cfg, variables
    state = jax_steps.ArcFaceTrainState.create(apply_fn=model.apply, params=variables["params"],
                                               batch_stats=variables["batch_stats"], tx=jt._build_tx())
    jstep = jax.jit(jax_steps.make_arcface_train_step(model, 0.1, 0.0, jax_margin_schedule(cfg)))

    port = ArcFaceModel(EMB, (1, 1, 1, 1), num_classes=C, margin=0.3, easy_margin=False, dropout=0.0)
    port.load_state_dict(flax_to_state_dict(variables, include_head=True), strict=True)
    start = copy.deepcopy(port.state_dict())
    pstate = steps.TrainState(port, train_arcface.build_tx(cfg, SPE, port))
    pstep = steps.make_arcface_train_step(0.1, 0.0, train_arcface.margin_schedule_of(cfg, SPE))
    if case == "plateau":
        jt.state = state
        jt._apply_plateau_scale(0.5)
        state = jt.state
        pstate.tx.scale = 0.5
    for i in range(3):
        x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
        labels = rng.integers(0, C, B).astype(np.int32)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(i))
        pm = pstep(pstate, torch.from_numpy(x), torch.from_numpy(labels).long())
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=5e-5)
        assert pm["train_acc"].item() == float(jm["train_acc"])
        np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=2e-4)
        if case == "sgd":
            assert float(jm["grad_norm"]) > cfg["train"]["grad_clip"]  # the clip is active
    assert pstate.step == int(state.step) == 3 and pstate.tx.count == 3
    got = state_dict_to_flax(port.state_dict())
    adam = cfg["train"]["optimizer"] != "sgd"
    for tree in ("params", "batch_stats"):
        have = dict(jax.tree_util.tree_leaves_with_path(got[tree]))
        for path, value in jax.tree_util.tree_leaves_with_path(getattr(state, tree)):
            if adam and tree == "params":
                assert np.abs(have[path] - np.asarray(value)).max() <= 2 * cfg["train"]["lr"], path
            else:
                assert scale_err(have[path], value) < 2e-3, (tree, path)
    if case == "freeze":
        trainable = train_arcface.freeze_mask(port, 0.5)
        frozen = [n for n, t in trainable.items() if not t]
        assert frozen and all(torch.equal(port.state_dict()[n], start[n]) for n in frozen)
        assert set(pstate.tx.names) == {n for n, t in trainable.items() if t}


def test_arcface_gradients_equal_jax(arc_init, rng):
    """The first step's gradients, tensor by tensor, within 5e-4 of the
    tensor's largest JAX gradient (measured at most 1.5e-4), except the two
    a training-mode batch norm makes zero (``fc.bias``, ``bn1.bias``: both
    below 1e-6 of the largest gradient, rounding only)."""
    model, variables = arc_init
    x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    labels = rng.integers(0, C, B).astype(np.int32)

    def loss_fn(params):
        (logits, _), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(x), labels=jnp.asarray(labels), train=True,
                                     mutable=["batch_stats"])
        return jax_steps.softmax_cross_entropy(logits, jnp.asarray(labels), 0.1)

    want = jax.jit(jax.grad(loss_fn))(variables["params"])
    port = ArcFaceModel(EMB, (1, 1, 1, 1), num_classes=C, margin=0.3, easy_margin=False, dropout=0.0)
    port.load_state_dict(flax_to_state_dict(variables, include_head=True), strict=True)
    state = steps.TrainState(port, OptaxChain(dict(port.named_parameters()), "sgd", lambda c: 0.0))
    grads, _ = steps.make_arcface_train_step(0.1).gradients(state, torch.from_numpy(x),
                                                            torch.from_numpy(labels).long())
    have = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax({**port.state_dict(), **grads})["params"]))
    largest = max(float(np.abs(np.asarray(v)).max()) for v in jax.tree_util.tree_leaves(want))
    zeroed = []
    for path, value in jax.tree_util.tree_leaves_with_path(want):
        value = np.asarray(value)
        if np.abs(value).max() < 1e-6 * largest:
            zeroed.append("/".join(str(p.key) for p in path))
            assert np.abs(have[path]).max() < 1e-6 * largest
            continue
        assert np.abs(have[path] - value).max() <= 5e-4 * np.abs(value).max(), path
    assert sorted(zeroed) == ["bn1/bias", "fc/bias"]


# -- the optimizer chain alone -----------------------------------------------------------


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("clip", [None, 0.1, 100.0])
def test_optax_chain_equals_optax(opt, clip, rng):
    """Five updates on a fixed tree: within 1e-6 relative of the optax chain
    (clip → decayed weights (SGD) → sgd/adam/adamw → scale); the clip scales
    by max_norm / norm only at or above max_norm, as optax's does."""
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    schedule = build_schedule(0.05, "cosine", 20, 4)
    jax_sched = optax.join_schedules(
        [optax.linear_schedule(0.005, 0.05, 4), optax.cosine_decay_schedule(0.05, 16)], [4])
    chain = [optax.clip_by_global_norm(clip)] if clip else []
    if opt == "sgd":
        chain += [optax.add_decayed_weights(1e-2), optax.sgd(jax_sched, momentum=0.9)]
    elif opt == "adam":
        chain += [optax.adam(jax_sched)]
    else:
        chain += [optax.adamw(jax_sched, weight_decay=0.05)]
    chain.append(optax.inject_hyperparams(optax.scale)(step_size=1.0))
    tx = optax.chain(*chain)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    jstate[-1].hyperparams["step_size"] = jnp.asarray(0.5)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    chain_t = OptaxChain(tparams, opt, schedule, momentum=0.9,
                         weight_decay={"sgd": 1e-2, "adam": 0.0, "adamw": 0.05}[opt], grad_clip=clip,
                         plateau=True)
    chain_t.scale = 0.5
    for i in range(5):
        grads = {k: rng.normal(size=s).astype(np.float32) * (3 if i % 2 else 0.01) for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        chain_t.update({k: torch.from_numpy(v) for k, v in grads.items()})
        for k in shapes:
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-7)
    restored = OptaxChain({k: v.clone() for k, v in tparams.items()}, opt, schedule, grad_clip=clip,
                          plateau=True)
    restored.load_state_dict(chain_t.state_dict())
    assert restored.count == 5 and restored.scale == 0.5


def test_clip_is_not_clip_grad_norm():
    """Below max_norm optax leaves the gradient alone; clip_grad_norm_ scales
    by max_norm / (norm + 1e-6) whenever norm > max_norm, and its factor at
    the limit differs from optax's."""
    g = {"w": torch.full((4,), 0.5)}  # norm 1.0
    p = {"w": torch.zeros(4)}
    for max_norm, want in ((1.0, 0.5), (2.0, 0.5), (0.5, 0.25)):
        p["w"].zero_()
        OptaxChain(p, "sgd", lambda c: -1.0, momentum=0.0, grad_clip=max_norm).update(g)
        assert torch.equal(p["w"], torch.full((4,), want))
    assert torch.equal(global_norm([g["w"]]), torch.tensor(1.0))


# -- FaceNet -------------------------------------------------------------------------------

P, K, FS = 4, 3, 24


class JaxTinyEmbed(nn.Module):
    """A FaceNet-shaped embedder small enough to compile in seconds."""

    @nn.compact
    def __call__(self, x, train: bool = False):
        bn = dict(momentum=0.9, epsilon=1e-3)
        x = nn.Conv(8, (3, 3), strides=(2, 2), padding="VALID", use_bias=False, name="conv")(x)
        x = nn.relu(nn.BatchNorm(use_running_average=not train, name="bn", **bn)(x))
        x = jnp.mean(x, axis=(1, 2))
        x = nn.Dense(16, use_bias=False, name="last_linear")(x)
        x = nn.BatchNorm(use_running_average=not train, name="last_bn", **bn)(x)
        return x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)


class TinyEmbed(torch.nn.Module):
    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p
        self.conv = torch.nn.Conv2d(3, 8, 3, stride=2, bias=False)
        self.bn = BatchNorm2d(8, eps=1e-3)
        self.last_linear = torch.nn.Linear(8, 16, bias=False)
        self.last_bn = BatchNorm1d(16, eps=1e-3)

    def forward(self, x, generator=None):
        x = torch.relu(self.bn(self.conv(x.permute(0, 3, 1, 2))))
        x = dropout(x.mean(dim=(2, 3)), self.p, self.training, generator)
        x = self.last_bn(self.last_linear(x))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)


@pytest.fixture(scope="module")
def tiny_init():
    model = JaxTinyEmbed()
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((2, FS, FS, 3)))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.mark.parametrize("mining", ["semi_hard", "batch_hard", "random"])
def test_facenet_steps_equal_jax(mining, tiny_init, rng):
    """Two steps with adam: loss within 1e-5 relative, the triplet count
    equal (the miners' indices, above and in ``test_torch_training``), the
    parameters and batch statistics within 1e-4 of their scale; ``random``
    is given JAX's negatives (``permutation(fold_in(rng, 1))``)."""
    model, variables = tiny_init
    schedule_j = optax.exponential_decay(1e-2, 10, 0.5, staircase=True)
    state = jax_steps.ArcFaceTrainState.create(apply_fn=model.apply, params=variables["params"],
                                               batch_stats=variables["batch_stats"], tx=optax.adam(schedule_j))
    jstep = jax.jit(jax_steps.make_facenet_train_step(model, 0.5, mining))
    port = TinyEmbed()
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    pstate = steps.TrainState(port, OptaxChain(dict(port.named_parameters()), "adam",
                                               build_schedule(1e-2, "step", 100, step_size=10, gamma=0.5)))
    pstep = steps.make_facenet_train_step(0.5, mining)
    labels = np.repeat(np.arange(P), K).astype(np.int32)
    for i in range(2):
        x = rng.normal(size=(P * K, FS, FS, 3)).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        state, jm = jstep(state, jnp.asarray(x), jnp.asarray(labels), key)
        negatives = torch.from_numpy(np.asarray(jax.random.permutation(jax.random.fold_in(key, 1), P * K)))
        pm = pstep(pstate, torch.from_numpy(x), torch.from_numpy(labels).long(), negatives=negatives)
        np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        assert pm["n_triplets"].item() == float(jm["n_triplets"]) > 0
    got = state_dict_to_flax(port.state_dict())
    for tree in ("params", "batch_stats"):
        have = dict(jax.tree_util.tree_leaves_with_path(got[tree]))
        for path, value in jax.tree_util.tree_leaves_with_path(getattr(state, tree)):
            assert scale_err(have[path], value) < 1e-4, (tree, path)


def test_remat_step_equals_plain_step(rng):
    """``remat`` recomputes the forward in the backward pass with the same
    dropout draws and updates the batch statistics once: the same loss,
    parameters and statistics as the plain step (within 1e-6)."""
    torch.manual_seed(0)
    base = TinyEmbed(p=0.3)
    x = torch.from_numpy(rng.normal(size=(P * K, FS, FS, 3)).astype(np.float32))
    labels = torch.arange(P).repeat_interleave(K)
    out = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        state = steps.TrainState(model, OptaxChain(dict(model.named_parameters()), "adam",
                                                   build_schedule(1e-2, "constant")))
        step = steps.make_facenet_train_step(0.5, "semi_hard", remat=remat)
        gen = torch.Generator().manual_seed(7)
        losses = [step(state, x, labels, gen)["loss"].item() for _ in range(2)]
        out.append((losses, model.state_dict()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for k, v in out[0][1].items():
        torch.testing.assert_close(out[1][1][k], v, rtol=1e-6, atol=1e-7)


def test_unknown_mining_raises():
    with pytest.raises(ValueError):
        steps.make_facenet_train_step(mining="hardest")

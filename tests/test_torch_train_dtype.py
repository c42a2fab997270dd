"""Training in the models' compute dtype (bfloat16 / float16) against the JAX
package on the CPU.

JAX trains a model built with ``dtype=`` through XLA's jitted CPU graph of
the flax model and its VJP. The port's CPU path computes that graph's
operations in its order (``models/xla_cpu.py``): the convolutions' and batch
norms' roundings (a bf16 convolution's ``dx`` and ``dW`` stay float32, its
output's cotangent is rounded; a batch norm rounds its statistics' and its
normalisation's cotangents apart, then their sum), the batch-norm sums row
after row in float32 (products fused), a bf16 bias gradient rounded at
every step (float16: summed in float32, rounded once).

The blocks. Each block gets a seeded input and a seeded cotangent; its
output and its gradients (the input's and every parameter's) are held to
``jax.vjp`` of the flax block under ``jit`` (batch statistics as
arguments, as in a train step). A gradient element *moves* when it is more
than 2^-12 of its tensor's largest from JAX's (a sixteenth of a bf16 ulp, half
a float16 ulp of the largest); the share that moves is pooled over the
block's gradients. What is left (measured, below) is where the two
libraries' float32 convolutions sum in another order. A rare 16-bit flip
that this causes moves a training-mode batch norm's statistics and,
through them, every cotangent of its channel, so blocks of more than one
layer in training mode, whole steps and data-parallel ranks are held to a
float64 truth instead (``assert_as_close_to_truth``): pooled over the
tensors, the port's error is 0.5x to 2x JAX's 16-bit error, which a port
computing in float32 and a zero update both fail (``assert_discriminates``).
"""

import functools

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from facerecognition_tpu.models import arcface as jarc
from facerecognition_tpu.models import facenet as jfacenet
from facerecognition_tpu.models import inception_resnet_v1 as jinc
from facerecognition_tpu.models import mobilefacenet as jmbf
from facerecognition_tpu.models import resnet as jres
from facerecognition_tpu.training import steps as jax_steps
from facerecognition_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from facerecognition_tpu_torch.models import arcface as parc
from facerecognition_tpu_torch.models import facenet as pfacenet
from facerecognition_tpu_torch.models import inception_resnet_v1 as pinc
from facerecognition_tpu_torch.models import mobilefacenet as pmbf
from facerecognition_tpu_torch.models import resnet as pres
from facerecognition_tpu_torch.models.layers import BatchNorm2d, Conv2d
from facerecognition_tpu_torch.training import ArcFaceTrainState, steps
from facerecognition_tpu_torch.training.optim import OptaxChain

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
#: A gradient element moves when it is this far from JAX's, over its tensor's largest.
MOVE = 2.0 ** -12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the blocks ------------------------------------------------------------------------


class JConvBN(fnn.Module):
    dtype: object
    bias: bool = False

    @fnn.compact
    def __call__(self, x, train: bool = False):
        y = fnn.Conv(64, (3, 3), padding=((1, 1), (1, 1)), use_bias=self.bias, dtype=self.dtype,
                     name="conv")(x)
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5,
                             dtype=jnp.float32, name="bn")(y)


class ConvBN(torch.nn.Module):
    """``Conv2d`` into ``BatchNorm2d``."""

    def __init__(self, dtype, bias=False):
        super().__init__()
        self.conv = Conv2d(32, 64, 3, 1, 1, bias=bias, compute_dtype=dtype)
        self.bn = BatchNorm2d(64, eps=1e-5, input_dtype=dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class JHead(jarc.ArcFaceModel):
    """The ArcFace model from its feature map: bn1 → fc → bn2 → margin head."""

    def __call__(self, fmap, train: bool = False):
        labels = jnp.arange(fmap.shape[0]) % self.num_classes
        return super().__call__(None, labels=labels, train=train, feature_map=fmap)[0]


class Head(parc.ArcFaceModel):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.backbone = None  # the feature map enters after it

    def forward(self, fmap):
        labels = torch.arange(fmap.shape[0]) % self.arcface.weight.shape[0]
        return super().forward(None, labels=labels, feature_map=fmap)[0]


#: name: (flax block of a dtype, the port's, the input's NHWC shape)
BLOCKS = {
    "conv_bn": (lambda d: JConvBN(d), lambda d: ConvBN(d), (8, 16, 16, 32)),
    "conv_bias_bn": (lambda d: JConvBN(d, True), lambda d: ConvBN(d, True), (8, 16, 16, 32)),
    "bottleneck": (lambda d: jres.Bottleneck(16, 2, True, d),
                   lambda d: pres.Bottleneck(32, 16, 2, True, d), (4, 16, 16, 32)),
    "block35": (lambda d: jinc.Block35(0.17, d), lambda d: pinc.Block35(0.17, d), (2, 8, 8, 256)),
    "block17": (lambda d: jinc.Block17(0.1, d), lambda d: pinc.Block17(0.1, d), (2, 6, 6, 896)),
    "block8": (lambda d: jinc.Block8(0.2, dtype=d), lambda d: pinc.Block8(0.2, dtype=d),
               (2, 3, 3, 1792)),
    "mixed6a": (lambda d: jinc.Mixed6a(d), lambda d: pinc.Mixed6a(d), (2, 9, 9, 256)),
    "mobilefacenet_dw": (lambda d: jmbf.Bottleneck(64, 1, 2, dtype=d),
                         lambda d: pmbf.Bottleneck(64, 64, 1, 2, d), (4, 14, 14, 64)),
    "arcface_head": (lambda d: JHead(num_classes=10, embedding_size=32, stage_sizes=(1, 1, 1, 1),
                                     dropout=0.0, dtype=d),
                     lambda d: Head(32, (1, 1, 1, 1), num_classes=10, dropout=0.0, dtype=d),
                     (8, 2, 2, 2048)),
}


def _seeded_stats(tree, rng):
    if "mean" in tree:
        n = tree["mean"].shape
        return {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return {k: _seeded_stats(t, rng) for k, t in tree.items()}


@functools.lru_cache(maxsize=None)
def _variables(name, dtype):
    _, _, shape = BLOCKS[name]
    module = BLOCKS[name][0](DTYPES[dtype][1])
    return jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0), jnp.zeros(shape)))


def _init(name, dtype) -> dict:
    """The flax block's initial variables (one init per block and dtype)."""
    return jax.tree_util.tree_map(np.copy, _variables(name, dtype))


def block_gradients(name, dtype, train, port_dtypes=None):
    """The flax block's output and gradients (``jax.vjp`` under ``jit``) and
    the port block's in each of ``port_dtypes`` (default ``(dtype,)``;
    ``"float64"``: the float32 block run in float64), from one seeded input,
    cotangent and set of variables: ``{"jax": {...}, dtype: {...}}``, each
    ``{"out", "dx", parameter name: array}`` (NHWC, float64)."""
    jblock, pblock, shape = BLOCKS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(size=shape).astype(np.float32)
    module = jblock(DTYPES[dtype][1])
    v = _init(name, dtype)
    v["params"] = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32) if a.ndim == 1 else a, v["params"])
    stats = _seeded_stats(v.get("batch_stats", {}), rng)

    def apply(params, stats, x):
        if train:
            return module.apply({"params": params, "batch_stats": stats}, x, train=True,
                                mutable=["batch_stats"])[0]
        return module.apply({"params": params, "batch_stats": stats}, x, train=False)

    ct = rng.normal(size=jax.eval_shape(apply, v["params"], stats, x).shape).astype(np.float32)

    def vjp(params, stats, x, ct):
        out, back = jax.vjp(lambda p, x: apply(p, stats, x), params, x)
        return out, back(ct.astype(out.dtype))

    out, (dparams, dx) = jax.jit(vjp)(v["params"], stats, jnp.asarray(x), jnp.asarray(ct))
    grads = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, dparams)}, include_head=True)
    result = {"jax": {"out": np.asarray(out, np.float64), "dx": np.asarray(dx, np.float64),
                      **{k: np.asarray(g, np.float64) for k, g in grads.items()}}}
    for pdt in port_dtypes or (dtype,):
        block = pblock(DTYPES[pdt][0] if pdt in DTYPES else "float32")
        block.load_state_dict(flax_to_state_dict({"params": v["params"], "batch_stats": stats},
                                                 include_head=True), strict=True)
        if pdt == "float64":
            block = block.double()
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        tx = (tx.double() if pdt == "float64" else tx).requires_grad_(True)
        y = block.train(train)(tx)
        tct = torch.from_numpy(ct)
        tct = tct.permute(0, 3, 1, 2) if y.ndim == 4 else tct
        names, params = zip(*block.named_parameters())
        got = torch.autograd.grad(y, [tx, *params], tct.to(y.dtype))
        nhwc = [t.detach().double() for t in (y, got[0])]
        nhwc = [t.permute(0, 2, 3, 1) if t.ndim == 4 else t for t in nhwc]
        result[pdt] = {"out": nhwc[0].numpy(), "dx": nhwc[1].numpy(),
                       **{n: g.detach().double().numpy() for n, g in zip(names, got[1:])}}
    return result


def pooled_share(got, want) -> float:
    """The share of all gradient elements (``dx`` and the parameters') more
    than ``MOVE`` of their tensor's largest from JAX's. A gradient that a
    training-mode batch norm makes zero (below 1e-6 of the block's largest:
    a bias ahead of it) is rounding on both sides and must stay below that."""
    names = [k for k in want if k != "out"]
    largest = max(np.abs(want[k]).max() for k in names)
    n = total = 0
    for k in names:
        if np.abs(want[k]).max() < 1e-6 * largest:
            assert np.abs(got[k]).max() < 1e-6 * largest, k
            continue
        n += int((np.abs(got[k] - want[k]) > MOVE * np.abs(want[k]).max()).sum())
        total += want[k].size
    return n / total


#: (dtype, mode): the bound on the pooled share that moves, with the shares
#: measured over the blocks below, this code / the code before this repair.
BOUNDS = {
    # exact (0 in every block) / 0.31-0.59
    ("bfloat16", "eval"): 1e-3,
    # single layers (the convolution into its batch norm, the float32 head):
    # 0 and 0 / 0.67 and 0
    ("bfloat16", "train"): 1e-3,
    # 0 to 9.0e-4 / 0 to 3.7e-2 (float16 kept every rounding before too: the
    # batch norm's eval-mode product and the Inception blocks' scale moved)
    ("float16", "eval"): 2e-3,
    # single layers: 1.1e-3, 1.8e-3 (with bias), 0 (the head) / 3.7e-2, 3.9e-2, 0
    ("float16", "train"): 5e-3,
}
#: Blocks of more than one layer, which training holds to a float64 truth.
DEEP = ("bottleneck", "block35", "block17", "block8", "mixed6a", "mobilefacenet_dw")


def _block_cases():
    for name in BLOCKS:
        for dtype in ("bfloat16", "float16"):
            for mode in ("eval", "train"):
                # no model has a biased bf16 convolution read by a batch norm:
                # XLA drops its output's last rounding there, the port keeps it
                # (ROADMAP.md, "Known rounding differences, continued")
                if not (mode == "train" and name in DEEP) and (name, dtype) != ("conv_bias_bn", "bfloat16"):
                    yield name, dtype, mode


@pytest.mark.parametrize("name,dtype,mode", list(_block_cases()))
def test_block_backward_equals_flax(name, dtype, mode):
    """The block's 16-bit output and backward against flax's under ``jit``:
    the output within 2^-12 of its largest in all but 1e-3 of its elements,
    and the pooled share of gradient elements that move under ``BOUNDS``
    (the shares measured with this code and with the code before the
    repair stand beside each bound)."""
    r = block_gradients(name, dtype, mode == "train")
    got, want = r[dtype], r["jax"]
    out = np.abs(got["out"] - want["out"]) > MOVE * np.abs(want["out"]).max()
    assert out.mean() < 1e-3, out.mean()
    assert pooled_share(got, want) <= BOUNDS[dtype, mode], pooled_share(got, want)


def rms_errors(got, truth) -> dict:
    """Each tensor's root-mean-square distance from the float64 truth."""
    return {k: float(np.sqrt(np.mean((got[k] - truth[k]) ** 2))) for k in truth}


def assert_as_close_to_truth(got, reference, truth, skip=("out",)):
    """Against the float64 truth, each tensor's RMS error in units of that
    tensor's RMS (at least 1e-3 of the largest tensor's RMS): pooled over
    the tensors (the root of the sum of squares), ``got``'s error is within
    0.5x to 2x ``reference``'s (JAX's, in the dtype); per tensor it is at
    most 4x JAX's, or 1e-3. The pooled lower side fails a port that
    computes in float32 (its error is below 1e-2 of JAX's), the pooled
    upper side a zero update (``assert_discriminates``). Per tensor the
    ratio is a ratio of two draws of the same noise, not a bound: over four
    inputs of the whole ArcFace step its range was 0.44-2.75 (the 32
    elements of ``bn2``'s bias) while the pooled ratio stayed 0.90-1.03."""
    keys = [k for k in truth if k not in skip]
    rms = {k: float(np.sqrt(np.mean(truth[k] ** 2))) for k in keys}
    unit = 1e-3 * max(rms.values())
    ep, ej = rms_errors(got, truth), rms_errors(reference, truth)
    mine = {k: ep[k] / max(rms[k], unit) for k in keys}
    jaxs = {k: ej[k] / max(rms[k], unit) for k in keys}
    pooled = np.sqrt(sum(v * v for v in mine.values()) / sum(v * v for v in jaxs.values()))
    assert 0.5 <= pooled <= 2.0, pooled
    bad = {k: (mine[k], jaxs[k]) for k in keys if mine[k] > max(4 * jaxs[k], 1e-3)}
    assert not bad, bad


def assert_discriminates(wrong, reference, truth, skip=("out",)):
    """``assert_as_close_to_truth`` fails ``wrong`` (the port computing in
    float32) and a step whose parameter updates are zero."""
    zero = {k: v if k.startswith("stats/") or k == "out" else np.zeros_like(v)
            for k, v in reference.items()}
    for bad in (wrong, zero):
        with pytest.raises(AssertionError):
            assert_as_close_to_truth(bad, reference, truth, skip)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", DEEP)
def test_training_blocks_as_close_to_float64_as_jax(name, dtype):
    """Blocks of more than one layer in training mode against the float32
    block run in float64, by ``assert_as_close_to_truth`` (measured: the
    pooled ratio to JAX's error 0.96-1.003, per tensor 0.66-1.06; the
    float32 block's pooled error below 1e-3 of JAX's; JAX's largest error
    0.017-0.19 of its tensor's RMS). Elementwise they cannot agree: a
    convolution that sums in another order flips a 16-bit rounding now and
    then, which moves a training-mode batch norm's statistics and so every
    cotangent of its channel (the share that moves is 0 to 0.16 over seeds
    and shapes)."""
    r = block_gradients(name, dtype, True, (dtype, "float64", "float32"))
    assert_as_close_to_truth(r[dtype], r["jax"], r["float64"])
    assert_discriminates(r["float32"], r["jax"], r["float64"])


# -- whole steps ----------------------------------------------------------------------

B, S, C, EMB = 8, 32, 10, 32


def _flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.array(v, np.float64)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_step(kind, dtype, variables, x, labels):
    """One JAX step with SGD at rate 1 from ``variables``: the update (the
    gradient, negated) and the new batch statistics, flat by flax path."""
    jdt = DTYPES[dtype][1]
    if kind == "arcface":
        model = jarc.ArcFaceModel(num_classes=C, embedding_size=EMB, stage_sizes=(1, 1, 1, 1),
                                  dropout=0.0, margin=0.3, dtype=jdt)
        step = jax_steps.make_arcface_train_step(model, 0.1)
    else:
        model = jfacenet.FaceNetModel(dropout=0.0, dtype=jdt)
        step = jax_steps.make_facenet_train_step(model, 0.5, "semi_hard")
    state = jax_steps.ArcFaceTrainState.create(apply_fn=model.apply, params=variables["params"],
                                               batch_stats=variables["batch_stats"], tx=optax.sgd(1.0))
    new, metrics = jax.jit(step)(state, jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(0))
    params, before = _flat(new.params), _flat(variables["params"])
    return {**{k: params[k] - before[k] for k in params}, **_flat({"stats": new.batch_stats})}, metrics


def port_model(kind, dtype):
    dt = "float32" if dtype == "float64" else dtype
    if kind == "arcface":
        model = parc.ArcFaceModel(EMB, (1, 1, 1, 1), num_classes=C, margin=0.3, dropout=0.0, dtype=dt)
    else:
        model = pfacenet.FaceNetModel(dropout=0.0, dtype=dt)
    return model.double() if dtype == "float64" else model


def port_step(kind, dtype, variables, x, labels, **step_kw):
    """The port's step in ``dtype`` (``"float64"``: the float32 model in
    float64) with SGD at rate 1 from ``variables``, through
    ``ArcFaceTrainState``: the update and the new batch statistics, flat by
    flax path, and the metrics."""
    state = ArcFaceTrainState.create(
        apply_fn=port_model(kind, dtype), params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=lambda p: OptaxChain(p, "sgd", lambda count: 1.0, momentum=0.0))
    before = _flat(state.params)
    x = torch.from_numpy(x).double() if dtype == "float64" else torch.from_numpy(x)
    labels = torch.from_numpy(labels).long()
    if kind == "arcface":
        metrics = steps.make_arcface_train_step(0.1)(state, x, labels, **step_kw)
    else:
        metrics = steps.make_facenet_train_step(0.5, "semi_hard", **step_kw)(state, x, labels)
    params = _flat(state.params)
    return {**{k: params[k] - before[k] for k in params}, **_flat({"stats": state.batch_stats})}, metrics


@pytest.fixture(scope="module")
def step_inputs():
    """JAX's ArcFace (1,1,1,1) variables (one jitted init: flax keeps them
    float32 in every dtype) and the FaceNet variables of a seeded port model
    in the flax layout (JAX's jitted InceptionResnetV1 init alone costs a
    40 s compile); a batch each."""
    rng = np.random.default_rng(19)
    model = jarc.ArcFaceModel(num_classes=C, embedding_size=EMB, stage_sizes=(1, 1, 1, 1), dropout=0.0)
    arc = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k, x, l: model.init(k, x, labels=l))(
        jax.random.PRNGKey(0), jnp.zeros((2, S, S, 3)), jnp.zeros((2,), jnp.int32)))
    torch.manual_seed(19)
    facenet = state_dict_to_flax(pfacenet.FaceNetModel(dropout=0.0).state_dict())
    return {
        "arcface": (arc, rng.normal(size=(B, S, S, 3)).astype(np.float32),
                    rng.integers(0, C, B).astype(np.int32)),
        "facenet": (facenet, rng.normal(size=(4, 112, 112, 3)).astype(np.float32),
                    np.array([0, 0, 1, 1], np.int32)),
    }


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["arcface", "facenet"])
def test_step_as_close_to_float64_as_jax(kind, dtype, step_inputs):
    """One step (ArcFace (1,1,1,1) at 32², B 8; FaceNet InceptionResnetV1 at
    112², semi-hard, P 2 x K 2: at 80² its last blocks' batch norms see 4
    values a channel) with SGD at rate 1 from the same variables, the
    updated parameters and batch statistics against the port's float64
    step by ``assert_as_close_to_truth`` (measured, ArcFace / FaceNet: the
    pooled ratio to JAX's error 1.03 / 1.00 in bf16, 1.13 / 1.04 in
    float16, per tensor 0.53-2.75; the float32 step's pooled error at most
    0.022 of JAX's; JAX's largest error 0.49 / 0.58 of its tensor's RMS in
    bf16, 0.17 / 0.23 in float16). The loss is within 1% of JAX's
    (measured at most 2.7e-3). Elementwise, whole steps cannot agree: one
    16-bit flip moves a training-mode batch norm's statistics, and so the
    whole batch."""
    variables, x, labels = step_inputs[kind]
    truth, _ = port_step(kind, "float64", variables, x, labels)
    want, jm = jax_step(kind, dtype, variables, x, labels)
    got, pm = port_step(kind, dtype, variables, x, labels)
    assert set(got) == set(want) == set(truth)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=1e-2)
    assert_as_close_to_truth(got, want, truth, skip=())
    assert_discriminates(port_step(kind, "float32", variables, x, labels)[0], want, truth, skip=())


def test_parameters_stay_float32_in_16_bits(step_inputs):
    """A bf16 model's parameters, gradients by name, metrics and optimizer
    state are float32, as flax's ``param_dtype``; its eval step gives
    float32 unit rows."""
    variables, x, labels = step_inputs["arcface"]
    state = ArcFaceTrainState.create(apply_fn=port_model("arcface", "bfloat16"),
                                     params=variables["params"], batch_stats=variables["batch_stats"],
                                     tx=lambda p: OptaxChain(p, "sgd", lambda c: 0.1))
    grads, metrics = steps.make_arcface_train_step(0.1).gradients(
        state, torch.from_numpy(x), torch.from_numpy(labels).long())
    assert {g.dtype for g in grads.values()} == {torch.float32}
    assert {t.dtype for t in state.model.state_dict().values() if t.is_floating_point()} == {torch.float32}
    assert all(m.dtype == torch.float32 for m in metrics.values())
    state.apply_gradients(grads=grads)
    assert {t.dtype for t in state.tx.state["trace"]} == {torch.float32}
    emb = steps.make_arcface_eval_step()(state, torch.from_numpy(x))
    assert emb.dtype == torch.float32
    torch.testing.assert_close(emb.norm(dim=1), torch.ones(B), rtol=0, atol=1e-6)


def test_remat_bf16_step_is_bit_equal(step_inputs):
    """A bf16 FaceNet ``remat`` step (dropout 0.6 from one generator)
    recomputes the same 16-bit forward: loss, parameters and statistics
    equal the plain step's bit for bit."""
    variables, x, labels = step_inputs["facenet"]
    out = []
    for remat in (False, True):
        model = pfacenet.FaceNetModel(dropout=0.6, dtype="bfloat16")
        state = ArcFaceTrainState.create(apply_fn=model, params=variables["params"],
                                         batch_stats=variables["batch_stats"],
                                         tx=lambda p: OptaxChain(p, "sgd", lambda c: 0.1))
        step = steps.make_facenet_train_step(0.5, "semi_hard", remat=remat)
        metrics = step(state, torch.from_numpy(x), torch.from_numpy(labels).long(),
                       torch.Generator().manual_seed(3))
        out.append((metrics["loss"], model.state_dict()))
    assert torch.equal(out[0][0], out[1][0])
    for k, v in out[0][1].items():
        assert torch.equal(out[1][1][k], v), k


def test_arcface_train_state_equals_jax(step_inputs):
    """``ArcFaceTrainState.create`` from JAX's variables: ``params`` and
    ``batch_stats`` are the flax trees it was given; after three float32
    steps (SGD, clipped at 0.5) they equal ``state_dict_to_flax`` of the module and JAX's
    ``ArcFaceTrainState`` after the same steps within 2e-3 of scale (the
    tolerance of ``test_torch_train_steps``); ``apply_gradients`` takes a
    flax-layout tree as well as gradients by name."""
    variables, x, labels = step_inputs["arcface"]
    model = jarc.ArcFaceModel(num_classes=C, embedding_size=EMB, stage_sizes=(1, 1, 1, 1),
                              dropout=0.0, margin=0.3)
    jstate = jax_steps.ArcFaceTrainState.create(apply_fn=model.apply, params=variables["params"],
                                                batch_stats=variables["batch_stats"], tx=optax.chain(optax.clip_by_global_norm(0.5), optax.sgd(0.05)))
    state = ArcFaceTrainState.create(apply_fn=port_model("arcface", "float32"),
                                     params=variables["params"], batch_stats=variables["batch_stats"],
                                     tx=lambda p: OptaxChain(p, "sgd", lambda c: 0.05, momentum=0.0, grad_clip=0.5))
    assert isinstance(state, steps.TrainState) and state.apply_fn is state.model and state.step == 0
    for tree in ("params", "batch_stats"):
        got, want = _flat(getattr(state, tree)), _flat(variables[tree])
        assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    jstep = jax.jit(jax_steps.make_arcface_train_step(model, 0.1))
    pstep = steps.make_arcface_train_step(0.1)
    for i in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(labels), jax.random.PRNGKey(i))
        pstep(state, torch.from_numpy(x), torch.from_numpy(labels).long())
    assert state.step == int(jstate.step) == 3
    for tree in ("params", "batch_stats"):
        got = _flat(getattr(state, tree))
        mine = _flat(state_dict_to_flax(state.model.state_dict())[tree])
        assert got.keys() == mine.keys() and all(np.array_equal(got[k], mine[k]) for k in got)
        for k, v in _flat(getattr(jstate, tree)).items():
            assert np.abs(got[k] - v).max() <= 2e-3 * (np.abs(v).max() + 1e-3), (tree, k)
    by_name, _ = pstep.gradients(state, torch.from_numpy(x), torch.from_numpy(labels).long())
    tree = state_dict_to_flax({**state.model.state_dict(), **by_name})["params"]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert state.apply_gradients(grads=tree) is state and state.step == 4
    after = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.load_state_dict(before)
    state.apply_gradients(grads=by_name)
    for k, v in state.model.state_dict().items():  # within the clip norm's summation order
        torch.testing.assert_close(v, after[k], rtol=1e-6, atol=1e-9)


def test_data_parallel_bf16_as_close_as_one_process(step_inputs):
    """Two gloo ranks training the bf16 ArcFace (three steps of the
    trainer's SGD chain with mixup, each rank half of the batch) against
    one process, both held to the one-process float64 run by
    ``assert_as_close_to_truth`` with one process in JAX's place
    (measured: pooled ratio 1.03, per tensor 0.83-1.25; a float32 run's
    pooled error 5e-4 of one process's, which the bound fails). The ranks'
    batch norms (``layers.GlobalBatchNorm`` with ``half``) sum in float64
    over the ranks and round the cotangents as one process does; a bf16
    flip where their sums or a convolution's order differ moves the
    batch's statistics, so they cannot equal one process within
    ``test_torch_parallel_train``'s float32 tolerances."""
    from test_torch_dp_ranks import _rank_run_dtype, run_port_dtype

    from facerecognition_tpu_torch.parallel.launch import spawn_ranks

    variables, _, _ = step_inputs["arcface"]
    rng = np.random.default_rng(23)
    batches = [(rng.normal(size=(B, S, S, 3)).astype(np.float32), rng.integers(0, C, B).astype(np.int32),
                float(rng.beta(0.4, 0.4)), rng.permutation(B)) for _ in range(3)]
    data = {"arc_vars": variables, "arc_batches": batches}
    flat = lambda run: {**_flat({"p": run["variables"]["params"]}),  # noqa: E731
                        **_flat({"s": run["variables"]["batch_stats"]})}
    truth = flat(run_port_dtype(None, data, "float64"))
    one = flat(run_port_dtype(None, data, "bfloat16"))
    ranks = spawn_ranks(_rank_run_dtype, 2, 2, data, "bfloat16")
    assert flat(ranks[0]).keys() == truth.keys()
    for r in ranks:
        assert_as_close_to_truth(flat(r), one, truth, skip=())
    with pytest.raises(AssertionError):  # the bound fails a float32 run
        assert_as_close_to_truth(flat(run_port_dtype(None, data, "float32")), one, truth, skip=())

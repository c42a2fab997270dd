"""The models' compute dtype (bfloat16 / float16) against the JAX package on
the CPU.

flax's ``nn.Conv(dtype=...)`` rounds its input, kernel and bias to the dtype,
rounds the convolution's output to it and rounds the bias add again; the
batch norms compute in float32; JAX's type promotion decides the rest. The
port's plain path (``models/layers.Conv2d`` on the CPU) is a float32
convolution of the rounded operands, then the same roundings, which gives
XLA's bits for one convolution. Under ``jit`` XLA also drops a bfloat16
rounding whose result only a float32 operation reads (a bias-free
convolution into its batch norm, a residual block's ``scale * up`` into its
float32 sum, with the scale rounded to bfloat16); float16 keeps them. The
port's CPU path does the same (a bias-free bf16 ``Conv2d`` returns its
float32 sum, ``inception_resnet_v1._residual``).

Each operation gives XLA's jitted bits but for rare flips: the two float32
convolutions sum in another order, so a sum within a float32 ulp of a
rounding boundary rounds the other way (a float16 3x3 depthwise convolution
fed JAX's own input flips 1.5e-4 of its outputs; 1x1 and dense ones are bit
for bit). The random-init networks amplify each flip, so at a model's output
the port stays close to JAX in its dtype but no tolerance there can tell the
dtypes apart: MobileFaceNet's and BlazeFaceNet's float16 outputs are as far
from JAX's float16 (mean 1.1e-3 / 6.2e-4 of the mean) as JAX's float16 is
from its float32 (1.1e-3 / 7.3e-4). The tolerances below are the measured
errors (max |Δ| over max |JAX|) with a margin of three to four; beside each,
JAX's own bf16-vs-float32 and bf16-vs-float16 gaps on the same input:

- a single convolution, with and without bias, grouped or not: bit for bit;
- ArcFace (1,1,1,1): 1.5e-3 in bf16, 1e-3 in float16 (measured 3.7e-4,
  1.6e-4; gaps 5.1e-3, 5.3e-3);
- FaceNet at 80²: 8e-3, 1.5e-3 (measured 2.7e-3, 3.0e-4; gaps 4.3e-3,
  4.3e-3);
- MobileFaceNet: 2.5e-2, 6e-3 (measured 6.9e-3, 1.5e-3; gaps 9.0e-3,
  8.8e-3);
- DenseDetNet / BlazeFaceNet raw outputs, bf16 to the end: 2e-2 / 2.5e-2
  in bf16, 3e-3 / 4e-3 in float16 (measured 4.9e-3 / 7.9e-3 and 6.1e-4 /
  9.9e-4; gaps 7.6e-3 / 1.0e-2 and 8.0e-3 / 1.0e-2).

What tells the dtypes apart is each block fed JAX's own input (captured from
the jitted model): the share of its outputs that move by more than 1e-5 of
the block's largest is at most 3.4e-2 over a model's blocks in the right
dtype (FaceNet float16; 1.7e-5 to 2.1e-2 elsewhere) and at least 0.345 in
float32 or the other 16-bit dtype (0.48 to 0.98 elsewhere).

The bf16 fused engine (shipped v4 detector and ultraslim ArcFace, both bf16)
against the JAX engine built the same way: the same detector slots, the
same top-k names where the JAX scores are more than 1e-2 apart, scores
within 1e-2, boxes within 1 px, embedding cosine above 0.999. ``warp_sample``'s
plain bf16 / float16 model inputs equal the float32 ones rounded.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference import explainability as jx
from facerecognition_tpu.inference import extract_embeddings as jee
from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.models.arcface import ArcFaceModel as JArcFace
from facerecognition_tpu.models.detector_net import BlazeFaceNet as JBlaze
from facerecognition_tpu.models.detector_net import DenseDetNet as JDense
from facerecognition_tpu.models.facenet import FaceNetModel as JFaceNet
from facerecognition_tpu.models.mobilefacenet import MobileFaceNet as JMobile
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.inference import engine as peng
from facerecognition_tpu_torch.inference import explainability as px
from facerecognition_tpu_torch.inference import extract_embeddings as pee
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.models.detector_net import BlazeFaceNet, DenseDetNet, build_detector_net
from facerecognition_tpu_torch.models.facenet import FaceNetModel
from facerecognition_tpu_torch.models.layers import Conv2d, as_compute_dtype
from facerecognition_tpu_torch.models.mobilefacenet import MobileFaceNet
from facerecognition_tpu_torch.ops import warp_sample
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}

#: name: (JAX model, port model, input shape, {dtype: tolerance of the scale})
MODELS = {
    "arcface": (lambda d: JArcFace(embedding_size=128, stage_sizes=(1, 1, 1, 1), dtype=d),
                lambda d: ArcFaceModel(128, (1, 1, 1, 1), dtype=d), (2, 112, 112, 3),
                {"bfloat16": 1.5e-3, "float16": 1e-3}),
    "facenet": (lambda d: JFaceNet(dtype=d), lambda d: FaceNetModel(dtype=d), (1, 80, 80, 3),
                {"bfloat16": 8e-3, "float16": 1.5e-3}),
    "mobilefacenet": (lambda d: JMobile(embedding_size=128, dtype=d),
                      lambda d: MobileFaceNet(128, dtype=d), (1, 112, 112, 3),
                      {"bfloat16": 2.5e-2, "float16": 6e-3}),
    "dense": (lambda d: JDense(dtype=d), lambda d: DenseDetNet(dtype=d), (2, 128, 128, 3),
              {"bfloat16": 2e-2, "float16": 3e-3}),
    "blaze": (lambda d: JBlaze(dtype=d), lambda d: BlazeFaceNet(dtype=d), (2, 128, 128, 3),
              {"bfloat16": 2.5e-2, "float16": 4e-3}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def scale_err(got, want) -> float:
    """max |got - want| / max |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def mean_err(got, want) -> float:
    """mean |got - want| / mean |want|."""
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).mean() / np.abs(want).mean())


# -- the dtype argument ------------------------------------------------------------


def test_dtype_names_and_refusals():
    for name, (dt, _) in {**DTYPES, "float32": (torch.float32, None)}.items():
        assert as_compute_dtype(name) is dt and as_compute_dtype(dt) is dt
    for bad in ("float64", torch.float64, "bf16", jnp.bfloat16, None, 16):
        with pytest.raises(ValueError, match="compute dtype"):
            as_compute_dtype(bad)
    with pytest.raises(ValueError):
        ArcFaceModel(64, (1, 1, 1, 1), dtype="float64")
    with pytest.raises(ValueError):
        build_detector_net("dense", "int8")
    with pytest.raises(ValueError):
        pee.EmbedderConfig(dtype=torch.float64)
    with pytest.raises(ValueError, match="computes in"):
        pee.Embedder(pee.EmbedderConfig("arcface", 128, 112, (1, 1, 1, 1), "bfloat16"),
                     ArcFaceModel(128, (1, 1, 1, 1)), device="cpu")
    frames = torch.zeros((1, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        warp_sample.detector_input(frames, 16, out_dtype="float64")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [
    # (input NHWC, features, kernel, stride, padding, bias, groups)
    ((2, 16, 16, 32), 64, 3, 1, 1, False, 1),
    ((2, 32, 32, 24), 48, 3, 2, 1, True, 1),
    ((2, 16, 16, 24), 24, 5, 1, 2, True, 24),
    ((2, 7, 7, 64), 64, 7, 1, 0, False, 64),
])
def test_single_conv_bit_equal(dtype, case):
    """One ``Conv2d`` in the dtype gives flax's ``nn.Conv(dtype=...)`` bits:
    input, kernel and bias rounded, the output rounded, the bias add rounded
    again (rounding once would differ at about 31% of the biased outputs).
    A bias-free bf16 one hands on its float32 sum, which rounds to flax's."""
    import flax.linen as nn

    shape, features, k, s, pad, bias, groups = case
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(k * 10 + s)
    x = rng.normal(size=shape).astype(np.float32)
    jconv = nn.Conv(features, (k, k), strides=(s, s), padding=((pad, pad), (pad, pad)),
                    use_bias=bias, feature_group_count=groups, dtype=jdt)
    params = {"kernel": rng.normal(0, 0.2, (k, k, shape[3] // groups, features)).astype(np.float32)}
    if bias:
        params["bias"] = rng.normal(0, 0.5, features).astype(np.float32)
    want = jconv.apply({"params": params}, jnp.asarray(x))
    assert want.dtype == jdt
    conv = Conv2d(shape[3], features, k, s, pad, groups=groups, bias=bias, compute_dtype=tdt)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(params["kernel"]).permute(3, 2, 0, 1))
        if bias:
            conv.bias.copy_(torch.from_numpy(params["bias"]))
    assert conv.weight.dtype == torch.float32
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == (torch.float32 if tdt == torch.bfloat16 and not bias else tdt)
    np.testing.assert_array_equal(got.to(tdt).float().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_conv_into_batch_norm_keeps_float32():
    """A bias-free bf16 convolution read by a float32 batch norm: XLA's
    jitted graph hands the batch norm the unrounded float32 sum, and so does
    ``Conv2d`` (within the batch norms' float32 rounding); rounded to bf16
    first, it is a bf16 ulp off."""
    import flax.linen as nn

    class ConvBN(nn.Module):
        @nn.compact
        def __call__(self, x):
            y = nn.Conv(64, (3, 3), padding=((1, 1), (1, 1)), use_bias=False, dtype=jnp.bfloat16)(x)
            return nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                                dtype=jnp.float32)(y)

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 16, 32)).astype(np.float32)
    module = ConvBN()
    v = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["batch_stats"] = _seeded_stats(v["batch_stats"], rng)
    want = np.asarray(jax.jit(module.apply)(v, jnp.asarray(x)))
    bn = torch.nn.BatchNorm2d(64, eps=1e-5).eval()
    with torch.no_grad():
        for name, leaf in (("weight", v["params"]["BatchNorm_0"]["scale"]),
                           ("bias", v["params"]["BatchNorm_0"]["bias"]),
                           ("running_mean", v["batch_stats"]["BatchNorm_0"]["mean"]),
                           ("running_var", v["batch_stats"]["BatchNorm_0"]["var"])):
            getattr(bn, name).copy_(torch.from_numpy(leaf))
    conv = Conv2d(32, 64, 3, 1, 1, bias=False, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(v["params"]["Conv_0"]["kernel"]).permute(3, 2, 0, 1))
        y = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        kept, rounded = (scale_err(bn(t).permute(0, 2, 3, 1).numpy(), want)
                         for t in (y, y.to(torch.bfloat16).float()))
    assert y.dtype == torch.float32
    assert kept < 1e-6 < 1e-3 < rounded


# -- the models ----------------------------------------------------------------------


def _seeded_stats(tree, rng):
    """Batch statistics drawn from ``rng``: means N(0, 0.1), variances
    U(0.5, 1.5)."""
    if "mean" in tree:
        n = tree["mean"].shape
        return {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return {k: _seeded_stats(t, rng) for k, t in tree.items()}


@pytest.fixture(scope="module")
def jax_models():
    """Each model's flax variables (one jitted init in bf16; flax keeps the
    parameters float32, so the float16 model takes the same ones) with
    batch statistics drawn from a seed, so batch norm is not the identity."""
    out = {}
    for name, (jmodel, _, shape, _) in MODELS.items():
        model = jmodel(jnp.bfloat16)
        v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0),
                                                                   jnp.zeros(shape)))
        if "batch_stats" in v:
            v["batch_stats"] = _seeded_stats(v["batch_stats"], np.random.default_rng(7))
        out[name] = v
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_models):
    """``run(name, dtype)``: the jitted JAX model's output on the seeded
    input and its captured intermediates (capturing leaves the output's bits
    as they are), one compile each."""
    cache = {}

    def run(name, dtype):
        if (name, dtype) not in cache:
            jmodel, _, shape, _ = MODELS[name]
            model = jmodel(DTYPES[dtype][1])
            x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
            out, state = jax.jit(lambda v, x: model.apply(
                v, x, capture_intermediates=True, mutable=["intermediates"]))(
                jax_models[name], jnp.asarray(x))
            cache[name, dtype] = x, np.asarray(out), state["intermediates"]
        return cache[name, dtype]

    return run


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_equals_flax(jax_models, jax_runs, name, dtype):
    """The JAX init carried across by ``convert.py`` into the port model of
    the same dtype (its parameters stay float32): the same seeded input
    gives JAX's output within the model's tolerance."""
    _, pmodel, shape, tols = MODELS[name]
    tdt = DTYPES[dtype][0]
    v = jax_models[name]
    x, want, _ = jax_runs(name, dtype)
    model = pmodel(dtype)
    load_flax_variables(model, v)
    assert model.dtype is tdt
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert scale_err(got.numpy(), want) < tols[dtype]
    full = pmodel("float32")
    load_flax_variables(full, v)
    with torch.no_grad():
        assert scale_err(got, full.eval()(torch.from_numpy(x))) > 1e-5  # not float32 after all


def _chain(names):
    """(block, the block whose output it reads) along ``names``."""
    return list(zip(names[1:], names))


#: name: (the port's and flax's module holding the blocks or None, whether a
#: block's input is the ReLU of the previous one's output, the blocks).
BLOCKS = {
    "arcface": ("backbone", False, _chain(["layer1_0", "layer2_0", "layer3_0", "layer4_0"])),
    "facenet": ("backbone", False, _chain(["conv2d_1a", "conv2d_2a", "conv2d_2b"]) + _chain(
        ["conv2d_3b", "conv2d_4a", "conv2d_4b", *[f"repeat_1_{i}" for i in range(5)], "mixed_6a",
         *[f"repeat_2_{i}" for i in range(10)], "mixed_7a", *[f"repeat_3_{i}" for i in range(5)],
         "block8"])),
    "mobilefacenet": (None, False, _chain(
        ["conv1", "dw_conv", *[f"stage{i}_{b}" for i, n in enumerate((5, 1, 6, 1, 2))
                               for b in range(n)], "conv2"])),
    "dense": (None, True, _chain(["stem", "c1", "d1", "c2", "d2", "c3", "c4", "d3", "c5"])),
    "blaze": (None, True, _chain(["stem"] + [f"b{i}" for i in range(1, 12)])),
}


def _moved_shares(model, name, inter):
    """Each block of the port ``model`` fed JAX's captured input: the share
    of its outputs more than 1e-5 of its largest away from JAX's, per block
    and over all the blocks."""
    holder, relu, pairs = BLOCKS[name]
    tree = inter[holder] if holder else inter
    shares, moved, total = [], 0, 0
    for block, source in pairs:
        xin = tree[source]["__call__"][0]
        x = torch.from_numpy(np.asarray(jax.nn.relu(xin) if relu else xin, np.float32))
        x = x.permute(0, 3, 1, 2)
        if xin.dtype != jnp.float32 and model.dtype != torch.float32:
            x = x.to(model.dtype)
        module = getattr(model, holder) if holder else model
        if block.startswith("repeat_"):  # flax's repeat_1_0 is the port's repeat_1[0]
            stage, index = block.split("_")[1:]
            module = getattr(module, f"repeat_{stage}")[int(index)]
        else:
            module = getattr(module, block)
        with torch.no_grad():
            got = module(x).float().permute(0, 2, 3, 1).numpy()
        want = np.asarray(tree[block]["__call__"][0], np.float32)
        n = int((np.abs(got - want) > 1e-5 * np.abs(want).max()).sum())
        shares.append(n / want.size)
        moved, total = moved + n, total + want.size
    return shares, moved / total


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_blocks_equal_flax_in_their_dtype(jax_models, jax_runs, name, dtype):
    """Each block fed the input JAX's jitted model gave it: in the dtype,
    under 0.1 of all the blocks' outputs move (measured 1.7e-5 to 3.4e-2)
    and under 0.25 of any block's (measured at most 0.169); the same blocks
    in float32 or in the other 16-bit dtype move over 0.3 (measured 0.345 to
    0.98), so the check tells a wrong precision."""
    _, pmodel, _, _ = MODELS[name]
    _, _, inter = jax_runs(name, dtype)
    other = "float16" if dtype == "bfloat16" else "bfloat16"
    for pdt in (dtype, "float32", other):
        model = pmodel(pdt)
        load_flax_variables(model, jax_models[name])
        shares, share = _moved_shares(model.eval(), name, inter)
        if pdt == dtype:
            assert share < 0.1 and max(shares) < 0.25, (share, max(shares))
        else:
            assert share > 0.3, (pdt, share)


def test_feature_maps_are_float32(jax_models):
    """The CAM feature maps of bf16 models are float32, as JAX's ``fmap``."""
    for model, shape, v in ((FaceNetModel(dtype="bfloat16"), (1, 80, 80, 3), "facenet"),
                            (ArcFaceModel(128, (1, 1, 1, 1), dtype="bfloat16"), (1, 112, 112, 3),
                             "arcface")):
        load_flax_variables(model, jax_models[v])
        x = torch.from_numpy(np.random.default_rng(2).normal(size=shape).astype(np.float32))
        with torch.no_grad():
            emb, fmap = model.eval()(x, return_feature_map=True)
        assert emb.dtype == fmap.dtype == torch.float32 and fmap.abs().max() > 0


def test_gradcam_on_bf16_arcface(jax_models):
    """``GradCAM`` and ``ActivationCAM`` on a bf16 ArcFace: the gradient of
    the score with respect to the float32 map, as JAX's; CAMs in [0, 1]
    within 2e-2 of JAX's (one bf16 flip moves a CAM pixel), embeddings
    within 1e-3."""
    v = jax_models["arcface"]
    jmodel = JArcFace(embedding_size=128, stage_sizes=(1, 1, 1, 1), dtype=jnp.bfloat16)
    model = ArcFaceModel(128, (1, 1, 1, 1), dtype="bfloat16")
    load_flax_variables(model, v)
    img = np.random.default_rng(3).integers(0, 256, (112, 112, 3)).astype(np.uint8)
    target = np.random.default_rng(4).normal(size=128).astype(np.float32)
    for t in (None, target):
        cam, emb = px.GradCAM(model).generate(img, t)
        jcam, jemb = jx.GradCAM(jmodel, v).generate(img, t)
        assert 0.0 <= cam.min() and cam.max() <= 1.0
        np.testing.assert_allclose(cam, jcam, atol=2e-2)
        assert scale_err(emb, jemb) < 1e-3
    cam, emb = px.ActivationCAM(model).generate(img)
    jcam, _ = jx.ActivationCAM(jmodel, v).generate(img)
    np.testing.assert_allclose(cam, jcam, atol=2e-2)


# -- the warp's model inputs ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_warp_inputs_round_the_float32_ones(dtype):
    """``detector_input``, ``embedder_input`` (align and window) and
    ``affine_warp`` in the dtype equal their float32 outputs rounded to it,
    ``fast`` off, on and int8 (the resize takes int8 as bf16)."""
    tdt = DTYPES[dtype][0]
    rng = np.random.default_rng(5)
    frames = torch.as_tensor(rng.integers(0, 256, (2, 96, 88, 3)).astype(np.uint8))
    lms = torch.as_tensor(rng.uniform(30, 100, (2, 3, 5, 2)).astype(np.float32))
    ms = torch.as_tensor(np.array([[[1.1, 0.2, -5.0], [-0.1, 0.9, 3.0]]] * 2, np.float32))
    for fast in (False, True, "int8"):
        calls = [
            lambda d: warp_sample.detector_input(frames, 48, fast is not False, out_dtype=d),
            lambda d: warp_sample.embedder_input(frames, lms, 128, 40, None, fast, out_dtype=d),
            lambda d: warp_sample.embedder_input(frames, lms, 128, 40, 64, fast, out_dtype=d),
            lambda d: warp_sample.affine_warp(frames, ms, 48, 40, fast, out_dtype=d),
        ]
        for call in calls:
            full, low = call(torch.float32), call(dtype)
            assert full.dtype == torch.float32 and low.dtype == tdt
            torch.testing.assert_close(low, full.to(tdt), rtol=0, atol=0)


def test_launch_counter_by_kind():
    """A wrapper's counter counts every launch and, where the launch names
    one, its kind (``warp_sample``: role and output dtype); reset clears
    both."""
    from facerecognition_tpu_torch import _build

    counter = _build.LaunchCounter()
    for kind in ("resize/bfloat16", "align/bfloat16", None, "resize/bfloat16"):
        counter.add(kind)
    assert counter.count == 4
    assert counter.by_kind() == {"resize/bfloat16": 2, "align/bfloat16": 1}
    counter.by_kind()["align/bfloat16"] = 9  # a copy
    assert counter.by_kind()["align/bfloat16"] == 1
    counter.reset()
    assert counter.count == 0 and counter.by_kind() == {}


# -- the slice as a whole: the bf16 engine ------------------------------------------


@pytest.fixture(scope="module")
def bf16_engines():
    """The JAX engine and the port's, each with the shipped ultraslim ArcFace
    and the shipped v4 detector in bf16, over the same gallery: random rows
    and each scene slot's JAX embedding planted."""
    ckpt = pee.default_arcface_checkpoint()
    assert os.path.basename(ckpt) == "arcface_synthid9k_ultraslim_512.msgpack"
    jeng = JEngine(embedder=jee.load_arcface_model(ckpt, dtype=jnp.bfloat16),
                   detector=JDetector(confidence_threshold=0.0, min_face_size=0, dtype=jnp.bfloat16),
                   match_kernel="dense")
    p = peng.RecognitionEngine(
        embedder=pee.load_arcface_model(ckpt, dtype=torch.bfloat16, device="cpu"),
        detector=FaceDetector(confidence_threshold=0.0, min_face_size=0, dtype="bfloat16",
                              device="cpu"),
        match_kernel="stream", device="cpu")
    assert p.embedder.config.dtype is p.detector.dtype is torch.bfloat16
    scenes = {m: scene_batch(np.random.default_rng(60 + m), 2, 256, max_faces=m)[0].astype(np.uint8)
              for m in (1, 4)}
    rng = np.random.default_rng(61)
    rows = rng.normal(size=(40, 512)).astype(np.float32)
    names = [f"id{i:02d}" for i in range(40)]
    jeng.gallery.add_many(names, rows)
    for m, frames in scenes.items():
        embs = [f["embedding"] for r in jeng.fused_recognize_frames(frames, k=3, max_faces=m)
                for f in r["faces"]]
        names += [f"m{m}_{i}" for i in range(len(embs))]
        rows = np.concatenate([rows, np.stack(embs)])
    jeng.gallery = type(jeng.gallery)(512)
    jeng.gallery.add_many(names, rows)
    p.gallery.add_many(names, rows)
    return jeng, p, scenes


@pytest.mark.parametrize("max_faces", [1, 4])
def test_bf16_engine_equals_jax(bf16_engines, max_faces):
    jeng, p, scenes = bf16_engines
    frames = scenes[max_faces]
    ref = jeng.fused_recognize_frames(frames, k=5, max_faces=max_faces)
    got = p.fused_recognize_frames(frames, k=5, max_faces=max_faces)
    assert len(got) == len(ref) == len(frames)
    for res, r in zip(got, ref):
        assert len(res["faces"]) == len(r["faces"]) == max_faces
        for g, f in zip(res["faces"], r["faces"]):
            assert g["identity"] == f["identity"] and g["identity"].startswith(f"m{max_faces}_")
            ref_scores = np.array([s for _, s in f["top_k"]])
            np.testing.assert_allclose([s for _, s in g["top_k"]], ref_scores, atol=1e-2)
            gap = np.full(len(ref_scores), np.inf)
            gap[:-1] = np.minimum(gap[:-1], ref_scores[:-1] - ref_scores[1:])
            gap[1:] = np.minimum(gap[1:], ref_scores[:-1] - ref_scores[1:])
            for (gn, _), (fn, _), clear in zip(g["top_k"], f["top_k"], gap > 1e-2):
                assert gn == fn or not clear
            np.testing.assert_allclose(g["bbox"], f["bbox"], atol=1.0)
            np.testing.assert_allclose(g["det_score"], f["det_score"], atol=1e-2)
            assert float(g["embedding"] @ f["embedding"]) > 0.999


def test_bf16_detect_all_equals_jax(bf16_engines):
    """The staged detector in bf16: the same faces, boxes within 1 px."""
    jeng, p, scenes = bf16_engines
    for frame in scenes[4]:
        want = jeng.detector.detect_all(frame)
        got = p.detector.detect_all(frame)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1.0)
            np.testing.assert_allclose(g["confidence"], w["confidence"], atol=1e-2)

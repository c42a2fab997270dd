"""The port's detector trainer against the JAX one on the CPU: anchor
targets, the loss, Adam steps through BlazeFaceNet and DenseDetNet, the
schedule, the curriculum's producers, score calibration and evaluation."""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from facerecognition_tpu.models.detector_net import anchor_centers as jax_anchor_centers
from facerecognition_tpu.models.detector_net import build_detector_net as jax_build_net
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JaxFaceDetector
from facerecognition_tpu.training import train_detector as jtd
from facerecognition_tpu.training.synthetic_faces import RANGES_V4 as JAX_RANGES_V4
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.models.detector_net import anchor_centers, build_detector_net
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
from facerecognition_tpu_torch.training import synthetic_faces
from facerecognition_tpu_torch.training import train_detector as td
from facerecognition_tpu_torch.training.schedules import warmup_cosine_decay
from facerecognition_tpu_torch.utils.serialization import load_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for PyTorch while this module runs: xdist's
    workers share the cores, and one thread fixes the order of the CPU's
    reductions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")


def _gt_batch(rng, b: int, size: int = 128):
    """Drawn GT faces with padding rows of junk."""
    gb = np.zeros((b, td.MAX_GT, 4), np.float32)
    gl = np.zeros((b, td.MAX_GT, 5, 2), np.float32)
    gv = np.zeros((b, td.MAX_GT), bool)
    for i in range(b):
        for g in range(td.MAX_GT):
            if rng.random() < 0.6:
                x1, y1 = rng.uniform(0, size * 0.8, 2)
                w, h = rng.uniform(size / 16, size / 2, 2)
                gb[i, g] = [x1, y1, x1 + w, y1 + h]
                gl[i, g] = rng.uniform(0, size, (5, 2))
                gv[i, g] = True
            else:
                gb[i, g] = rng.uniform(-5, 5, 4)
                gl[i, g] = rng.uniform(-5, 5, (5, 2))
    return gb, gl, gv


def _jax_targets(anchors, gb, gl, gv):
    return jax.vmap(lambda b, l, v: jtd.assign_targets(jnp.asarray(anchors), b, l, v))(
        jnp.asarray(gb), jnp.asarray(gl), jnp.asarray(gv)
    )


def test_assign_targets_matches_jax_vmap():
    """Drawn GTs with padding rows, and two valid GTs whose best anchor is
    the same (XLA's scatter gives it to the later GT; so does the port)."""
    rng = np.random.default_rng(0)
    anchors = jax_anchor_centers(128)
    gb, gl, gv = _gt_batch(rng, 8)
    gb[0, 1] = gb[0, 0] + 0.01  # same best anchor, slightly different targets
    gl[0, 1] = gl[0, 0] + 0.5
    gv[0, :2] = True
    gb[1, 2], gl[1, 2], gv[1, 2] = gb[1, 3], gl[1, 3], gv[1, 3] = gb[1, 0], gl[1, 0], True
    want = _jax_targets(anchors, gb, gl, gv)
    got = td.assign_targets(torch.as_tensor(anchors), torch.as_tensor(gb), torch.as_tensor(gl),
                            torch.as_tensor(gv))
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    np.testing.assert_array_equal(got["cls"].numpy(), np.asarray(want["cls"]))
    np.testing.assert_allclose(got["reg"].numpy(), np.asarray(want["reg"]), rtol=1e-6, atol=1e-6)


def test_detection_loss_matches_jax():
    rng = np.random.default_rng(1)
    anchors = jax_anchor_centers(128)
    gb, gl, gv = _gt_batch(rng, 6)
    raw = rng.normal(0, 1.5, (6, len(anchors), 15)).astype(np.float32)
    tj = _jax_targets(anchors, gb, gl, gv)
    losses, metrics = jax.vmap(jtd.detection_loss)(jnp.asarray(raw), tj)
    tp = td.assign_targets(torch.as_tensor(anchors), torch.as_tensor(gb), torch.as_tensor(gl),
                           torch.as_tensor(gv))
    loss, pm = td.detection_loss(torch.as_tensor(raw), tp)
    np.testing.assert_allclose(float(loss), float(jnp.mean(losses)), rtol=1e-6)
    for k in ("cls_loss", "reg_loss", "n_pos"):
        np.testing.assert_allclose(float(pm[k]), float(jnp.mean(metrics[k])), rtol=1e-6)
    x = torch.linspace(-3, 3, 61)
    np.testing.assert_allclose(td.smooth_l1(x).numpy(), np.asarray(jtd.smooth_l1(jnp.asarray(x.numpy()))))


# Parameters after three Adam steps: a gradient near zero (rounding in
# either package) moves its parameter by up to ±lr per step, so the bound
# is 3 lr for those few; everything else agrees far closer.
@pytest.mark.parametrize("arch", ["blaze", "dense"])
def test_three_train_steps_match_jax(arch):
    size, lr = 32, 1e-3
    rng = np.random.default_rng(2)
    imgs, gb, gl, gv = td.synthetic_face_batch(rng, 4, size, max_per_image=2)
    norm = imgs / 127.5 - 1.0
    net = jax_build_net(arch)
    anchors = jax_anchor_centers(size)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    state = train_state.TrainState.create(apply_fn=net.apply, params=variables["params"], tx=optax.adam(lr))
    jstep = jtd.make_detector_train_step(net, jnp.asarray(anchors))

    pnet = build_detector_net(arch)
    load_flax_variables(pnet, {"params": jax.device_get(variables["params"])})
    pstate = td.detector_train_state(pnet, lambda count: lr)
    pstep = td.make_detector_train_step(pnet, torch.as_tensor(anchor_centers(size)))
    for _ in range(3):
        state, jm = jstep(state, jnp.asarray(norm), jnp.asarray(gb), jnp.asarray(gl), jnp.asarray(gv))
        pm = pstep(pstate, torch.as_tensor(norm), torch.as_tensor(gb), torch.as_tensor(gl), torch.as_tensor(gv))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert pstate.step == 3
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(state.params))
    got = td.net_variables(pnet)["params"]
    diffs = []
    for path, value in want:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        diffs.append(np.abs(leaf - np.asarray(value)))
    worst = max(float(d.max()) for d in diffs)
    close = np.mean(np.concatenate([(d <= 1e-5).ravel() for d in diffs]))
    assert worst <= 3 * lr + 1e-6
    assert close >= 0.99


def test_warmup_cosine_schedule_equals_optax():
    """Every count of short runs: the warmup bit for bit, the cosine within
    one float32 ulp (XLA's float32 cos is its own approximation; the port
    rounds the float64 cosine of the same float32 argument, which agreed
    bit for bit at 99.5% of 24k counts)."""
    for lr, warmup, steps in ((7e-4, 30, 300), (0.05, 1, 20), (1.5e-3, 200, 4000)):
        want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)
        got = warmup_cosine_decay(0.0, lr, warmup, steps)
        counts = list(range(0, min(steps, 400) + 5)) + [steps - 1, steps, steps + 3]
        values = np.asarray(jax.vmap(want)(jnp.asarray(counts, jnp.int32)))
        for c, w in zip(counts, values):
            g = np.float32(got(c))
            if c < warmup:
                assert g == w, (lr, c)
            else:
                assert abs(g - w) <= np.spacing(w), (lr, c)


def test_producer_death_raises_not_hangs(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("render exploded")

    monkeypatch.setattr(synthetic_faces, "scene_batch", boom)
    with pytest.raises(RuntimeError, match="producer") as err:
        td.train_detector_curriculum(
            td.CurriculumConfig(input_size=64, batch_size=4, steps=2, prefetch_threads=2), device="cpu"
        )
    assert "render exploded" in str(err.value.__cause__)


def _stub_scenes(monkeypatch, n: int, module=synthetic_faces, seed: int = 0):
    """A detector stub whose detections carry logits with P(tp | z) =
    sigmoid(2.5 z + 1), and ``module``'s scenes replaced by one GT at
    [10, 10, 50, 50]."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n) * 1.5 - 1.0
    y = rng.random(n) < 1 / (1 + np.exp(-(2.5 * z + 1.0)))

    class Stub:
        input_size = 128
        confidence_threshold = 0.5
        _calibration = (1.0, 0.0)

        def __init__(self):
            self.i = 0

        def detect_all(self, img):
            assert img.dtype == np.uint8
            i, self.i = self.i, self.i + 1
            if i >= n:
                return []
            box = [10, 10, 50, 50] if y[i] else [200, 200, 240, 240]
            return [{"bbox": box, "confidence": 1 / (1 + np.exp(-z[i])), "landmarks": None}]

    def fake_render(rng_, size, max_faces, p_face=0.8, ranges=None):
        boxes = np.zeros((4, 4), np.float32)
        boxes[0] = [10, 10, 50, 50]
        valid = np.zeros(4, bool)
        valid[0] = True
        return np.zeros((size, size, 3), np.float32), boxes, np.zeros((4, 5, 2), np.float32), valid

    monkeypatch.setattr(module, "render_scene", fake_render)
    return Stub()


def test_irls_recovers_logistic_params(monkeypatch):
    """The calibration fit recovers a known logistic (a, b), and gives JAX's
    numbers bit for bit on the same detections."""
    import facerecognition_tpu.training.synthetic_faces as jax_sf

    stub = _stub_scenes(monkeypatch, 4000)
    a, b = td.fit_score_calibration(stub, n_scenes=4000)
    assert abs(a - 2.5) < 0.4 and abs(b - 1.0) < 0.3
    # the threshold and calibration are the detector's again
    assert stub.confidence_threshold == 0.5 and stub._calibration == (1.0, 0.0)
    assert jtd.fit_score_calibration(_stub_scenes(monkeypatch, 4000, jax_sf), n_scenes=4000) == (a, b)


def test_calibration_fit_restores_detector_on_error(monkeypatch):
    stub = _stub_scenes(monkeypatch, 10)

    def broken(img):
        raise OSError("card lost")

    stub.detect_all = broken
    with pytest.raises(OSError):
        td.fit_score_calibration(stub, n_scenes=3)
    assert stub.confidence_threshold == 0.5 and stub._calibration == (1.0, 0.0)


def test_evaluate_detector_matches_jax():
    """The shipped v4 detector on 16 held-out v4 scenes in both packages:
    the same ground truth, recall within one face."""
    path = os.path.join(ASSETS, "detector_v4_128.msgpack")
    kw = dict(n_scenes=16, seed=778, max_faces=2)
    want = jtd.evaluate_detector(JaxFaceDetector(weights=path), ranges=JAX_RANGES_V4, **kw)
    got = td.evaluate_detector(FaceDetector(weights=path, device="cpu"), ranges=synthetic_faces.RANGES_V4, **kw)
    assert got["n_gt"] == want["n_gt"] > 0
    assert abs(got["recall"] - want["recall"]) <= 1 / want["n_gt"] + 1e-9
    assert abs(got["mean_iou"] - want["mean_iou"]) < 0.02
    assert abs(got["fp_per_image"] - want["fp_per_image"]) <= 1 / 16 + 1e-9


def test_curriculum_warm_start_runs_and_serves():
    """A few curriculum steps on the CPU from the shipped v3 weights (arch
    and calibration popped), as the v4 recipe starts: finite losses, one
    queue wait per step, and weights the detector loads."""
    init = load_variables(os.path.join(ASSETS, "detector_v3_128.msgpack"))
    arch = init.pop("arch")
    init.pop("calibration", None)
    arch = arch.decode() if isinstance(arch, bytes) else str(arch)
    timings: dict = {}
    cfg = td.CurriculumConfig(input_size=64, batch_size=4, steps=3, lr=7e-4, prefetch_threads=2,
                              arch=arch, ranges="v4", max_faces=2)
    variables, history = td.train_detector_curriculum(cfg, log_every=1, init_variables=init, device="cpu",
                                                      timings=timings)
    assert [h["step"] for h in history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert len(timings["wait_s"]) == 3
    det = FaceDetector(input_size=64, weights={**variables, "arch": arch}, device="cpu",
                       confidence_threshold=0.0)
    assert isinstance(det.detect_all(np.zeros((64, 64, 3), np.uint8)), list)
    moved = [np.abs(variables["params"][k]["kernel"] - init["params"][k]["kernel"]).max()
             for k in variables["params"]]
    assert max(moved) > 0


def test_train_detector_synthetic_runs():
    cfg = td.DetectorTrainConfig(input_size=64, batch_size=4, steps=2, lr=1e-3)
    variables, history = td.train_detector_synthetic(cfg, log_every=1, device="cpu")
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    net = build_detector_net("blaze")
    load_flax_variables(net, variables)


def test_flax_initialisation_statistics():
    """Kernels drawn as flax's LeCun truncated normal (std 1/sqrt(fan_in),
    cut at two), biases zero."""
    net = td.init_detector_net("dense", 0)
    w = net.c5.weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in**0.5 - 1.0) < 0.05
    assert float(w.abs().max()) * fan_in**0.5 <= 2.0 / 0.87962566103423978 + 1e-4
    assert float(net.c5.bias.detach().abs().max()) == 0.0

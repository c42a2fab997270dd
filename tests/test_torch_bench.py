"""The port's end-to-end bench (``facerecognition_tpu_torch.bench``) against
the JAX root script ``bench.py``.

On the CPU at B 2 with a 64-row gallery and one batch a run: the port's
draws against JAX's (``scene_batch`` of seed 0, then the gallery rows);
each mode's batch on JAX's frames against the JAX public functions composed
as ``bench.py``'s ``one_batch`` composes them, and its carried checksum
against ``bench.build_pipeline`` itself; the align step
(``embedder_input``) against JAX's clip and align for each ``--warp``;
the detection sanity against JAX's calibration; the JSON keys against
``bench.py``'s ``json.dumps``; the two refusals. Tolerances: the aligned
faces at most 2 levels, mean under 0.01; detector scores 1e-4; match scores 1e-3
(2e-3 with the int8 warp: ROADMAP's known rounding differences, as
``tests/test_torch_warp_int8.py``); indices equal wherever JAX's own gap
to a neighbouring score exceeds that tolerance; the checksum 1e-3·(1 +
|c|). One intra-op thread.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.extract_embeddings import load_arcface_checkpoint as j_load_arcface
from facerecognition_tpu.models.detector_net import anchor_centers as j_anchor_centers
from facerecognition_tpu.models.detector_net import detect_best_face_batch as j_best_face
from facerecognition_tpu.models.detector_net import detect_faces_batch as j_detect_faces
from facerecognition_tpu.ops.image import normalize_imagenet_style as j_normalize
from facerecognition_tpu.ops.matcher import auto_cosine_topk as j_auto_topk
from facerecognition_tpu.ops.matcher import cosine_topk as j_cosine_topk
from facerecognition_tpu.ops.matcher import l2_normalize as j_l2_normalize
from facerecognition_tpu.ops.umeyama import ARCFACE_TEMPLATE as J_TEMPLATE
from facerecognition_tpu.ops.warp_mxu import align_crop_mxu_batch as j_align
from facerecognition_tpu.ops.warp_mxu import align_crop_mxu_window as j_align_window
from facerecognition_tpu.ops.warp_mxu import bilinear_resize_mxu_batch as j_resize
from facerecognition_tpu.training.synthetic_faces import scene_batch as j_scene_batch
from facerecognition_tpu_torch import bench
from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
from facerecognition_tpu_torch.ops.warp_sample import embedder_input
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
from facerecognition_tpu_torch.tools.scene_fixture import JPEG_MAX_ABS
from test_torch_measure_tools import dumped_keys, jax_script

CPU = torch.device("cpu")
B, GALLERY = 2, 64
DET_TOL = 1e-4
CHECKSUM_REL = 1e-3
#: (warp, max_faces, frame, ablate): the one-face path in the three warp
#: modes, the repeat path (M 2 at 160²), the window path (M 4 at 256²),
#: each ablation.
MODES = {
    "bf16": ("bf16", 1, 160, ""),
    "int8": ("int8", 1, 160, ""),
    "f32": ("f32", 1, 160, ""),
    "repeat": ("bf16", 2, 160, ""),
    "window": ("bf16", 4, 256, ""),
    "ablate_detect": ("bf16", 1, 160, "detect"),
    "ablate_warp": ("bf16", 2, 160, "warp"),
    "ablate_match": ("bf16", 1, 160, "match"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jbench():
    """The JAX root script, loaded from its file."""
    return jax_script("bench.py")


def jax_draws(m: int, frame: int, noise: bool = False):
    """``bench.py:main``'s draws: frames (float32), unit gallery rows,
    ground-truth faces."""
    rng = np.random.default_rng(0)
    if noise:
        frames, n_gt = rng.integers(0, 256, (B, frame, frame, 3)).astype(np.float32), B
    else:
        frames, _, _, valid = j_scene_batch(rng, B, frame, max_faces=m, p_face=1.0)
        frames, n_gt = frames.astype(np.float32), int(np.asarray(valid).sum())
    gal = rng.normal(size=(GALLERY, 512)).astype(np.float32)
    gal /= np.linalg.norm(gal, axis=1, keepdims=True)
    return frames, gal, n_gt


@pytest.fixture(scope="module")
def jax_models(jbench):
    """The JAX bench's detector (``load_detector``) and embedder
    (``EMBEDDER_WEIGHTS``), their forwards jitted."""
    net, det_vars, cal = jbench.load_detector(128)
    model, variables = j_load_arcface(jbench.EMBEDDER_WEIGHTS)
    return {
        "det": jax.jit(lambda x: net.apply(det_vars, x)),
        "emb": jax.jit(lambda x: model.apply(variables, x)),
        "calibration": cal,
    }


@pytest.fixture(scope="module")
def port_models():
    """The port bench's detector and embedder on the CPU, loaded once."""
    path = bench.embedder_weights()
    return FaceDetector(device=CPU), load_arcface_model(path, device=CPU)


def jax_one_batch(models, frames, gal, m: int, ablate: str, warp_mode):
    """``bench.py``'s ``one_batch`` (lines 122-202) from the JAX public
    functions, plus the embeddings' top-6 scores (the neighbour of the
    fifth)."""
    frames, gal = jnp.asarray(frames), jnp.asarray(gal)
    bsz, h = frames.shape[0], frames.shape[1]
    anchors = jnp.asarray(j_anchor_centers(128))
    if ablate == "detect":
        lm = jnp.broadcast_to(jnp.asarray(J_TEMPLATE) * (h / 112.0), (bsz, 5, 2))
        det_scores = jnp.ones((bsz,), jnp.float32)
    else:
        raw = models["det"](j_resize(frames, 128, 128, True) / 127.5 - 1.0)
        if m == 1:
            _, lms, det_scores = j_best_face(raw, anchors)
        else:
            _, lms, det_scores, _ = j_detect_faces(raw, anchors, 0.3, m)
        lm = jnp.clip(lms * (h / 128), 0.0, h - 1.0)
    if ablate == "warp":
        aligned = j_resize(frames, 112, 112, True)
        if m > 1:
            aligned = jnp.repeat(aligned, m, axis=0)
    elif m == 1:
        aligned = j_align(frames, lm, 112, warp_mode)
    elif h > 160:
        aligned = j_align_window(frames, lm, 112, 160, warp_mode)
    else:
        aligned = j_align(jnp.repeat(frames, m, axis=0), lm.reshape(bsz * m, 5, 2), 112, warp_mode)
    emb = j_l2_normalize(models["emb"](j_normalize(aligned)).astype(jnp.float32))
    if ablate == "match":
        scores, idx = emb[:, :5], jnp.zeros((emb.shape[0], 5), jnp.int32)
        top6 = np.concatenate([np.asarray(scores), np.full((emb.shape[0], 1), -np.inf, np.float32)], 1)
    else:
        scores, idx = j_auto_topk(emb, gal, 5, normalized=True)
        top6 = np.asarray(j_cosine_topk(emb, gal, 6, normalized=True)[0])
    return np.asarray(scores), np.asarray(idx), np.asarray(det_scores), top6


def assert_top5_close(scores, idx, ref_scores, ref_idx, ref_top6, tol: float):
    """Scores within ``tol``; each index equal to the reference's wherever
    the reference's score at that rank is more than ``tol`` from both of its
    neighbours (the sixth best included)."""
    np.testing.assert_allclose(scores, ref_scores, atol=tol, rtol=0)
    gaps = np.abs(np.diff(ref_top6, axis=1))  # (S, 5): rank j to j + 1
    apart = np.minimum(np.concatenate([np.full((len(gaps), 1), np.inf), gaps[:, :4]], 1), gaps)
    firm = apart > tol
    assert firm.any()
    np.testing.assert_array_equal(np.asarray(idx)[firm], np.asarray(ref_idx)[firm])


@pytest.mark.parametrize("m,frame,noise", [(1, 160, False), (2, 160, False), (4, 256, False),
                                           (1, 160, True)])
def test_draws_are_jax_inputs(m, frame, noise):
    """The port's draws render JAX's frames within the renderer's JPEG
    bound (``tools/scene_fixture``), draw JAX's gallery rows bit for bit and
    count JAX's ground-truth faces."""
    frames, gal, n_gt = bench.draws(B, frame, m, GALLERY, noise)
    ref_frames, ref_gal, ref_n = jax_draws(m, frame, noise)
    assert frames.dtype == np.float32 and frames.shape == ref_frames.shape
    assert np.abs(frames - ref_frames).max() <= (0 if noise else JPEG_MAX_ABS)
    np.testing.assert_array_equal(gal, ref_gal)
    assert n_gt == ref_n


@pytest.mark.parametrize("mode", list(MODES))
def test_one_batch_matches_jax(mode, jax_models, port_models):
    """Each mode's batch on JAX's frames: detector scores, match scores and
    indices against ``bench.py``'s composition of the JAX functions."""
    warp, m, frame, ablate = MODES[mode]
    frames, gal, _ = jax_draws(m, frame)
    p = bench.Pipeline(m, ablate, bench.WARP_MODES[warp], CPU, *port_models)
    scores, idx, det = p.one_batch(torch.as_tensor(frames), torch.as_tensor(gal))
    ref_s, ref_i, ref_d, ref_top6 = jax_one_batch(jax_models, frames, gal, m, ablate,
                                                  bench.WARP_MODES[warp])
    assert scores.shape == (B * m, 5) and idx.dtype == torch.int32
    np.testing.assert_allclose(det.numpy(), ref_d, atol=DET_TOL, rtol=0)
    assert_top5_close(scores.numpy(), idx.numpy(), ref_s, ref_i, ref_top6, 2e-3 if warp == "int8" else 1e-3)


@pytest.mark.parametrize("warp", list(bench.WARP_MODES))
@pytest.mark.parametrize("m,frame", [(1, 160), (2, 160), (4, 256)])
def test_embedder_input_matches_jax_align(warp, m, frame, port_models):
    """The batch's align step, ``embedder_input`` from landmarks in detector
    pixels, against ``bench.py:153-190`` on the same landmarks (scaled by
    h / 128, clipped into the frame, aligned from the frame, the repeated
    frames or the 160² window, then ``normalize_imagenet_style``), for each
    ``--warp``: at most 2 levels (the closed-form Umeyama's ~1e-5 px can
    flip a rounding), mean under 0.01 level. The warp modes themselves are
    further apart than that mean, so the score checks above, whose
    tolerance they fit inside, do not have to tell them apart."""
    frames, _, _ = jax_draws(m, frame)
    # landmarks in detector pixels from the port's own decode
    lms = bench.Pipeline(m, "", True, CPU, *port_models).detect(torch.as_tensor(frames))[0]
    mode = bench.WARP_MODES[warp]
    got = embedder_input(torch.as_tensor(frames), lms, 128, 112, 160 if m > 1 and frame > 160 else None,
                         mode).numpy()
    jframes = jnp.asarray(frames)
    jlm = jnp.clip(jnp.asarray(lms.numpy()) * (frame / 128), 0.0, frame - 1.0)
    if m == 1:
        ref = j_align(jframes, jlm[:, 0], 112, mode)
    elif frame > 160:
        ref = j_align_window(jframes, jlm, 112, 160, mode)
    else:
        ref = j_align(jnp.repeat(jframes, m, axis=0), jlm.reshape(B * m, 5, 2), 112, mode)
    levels = np.abs(got - np.asarray(j_normalize(ref))) * 127.5
    assert levels.max() <= 2.0 and levels.mean() < 0.01, (levels.max(), levels.mean())


@pytest.mark.parametrize("mode", list(MODES))
def test_checksum_matches_jax_build_pipeline(mode, jbench, port_models):
    """The port's carried checksum after one batch against the JAX script's
    own ``build_pipeline(M, 1, ablate, warp_mode)`` on the same inputs."""
    warp, m, frame, ablate = MODES[mode]
    frames, gal, _ = jax_draws(m, frame)
    ref = float(jbench.build_pipeline(m, 1, ablate, bench.WARP_MODES[warp])(
        jnp.asarray(frames[None]), jnp.asarray(gal)))
    p = bench.Pipeline(m, ablate, bench.WARP_MODES[warp], CPU, *port_models)
    got = float(p.step(torch.zeros(()), torch.as_tensor(frames), torch.as_tensor(gal)))
    assert abs(got - ref) <= CHECKSUM_REL * (1 + abs(ref)), (got, ref)


@pytest.mark.parametrize("m,frame", [(1, 160), (4, 256)])
def test_mean_det_score_matches_jax(m, frame, jax_models, port_models):
    """The detection sanity (crowd decode at M 4, Platt calibration) on
    JAX's frames against ``bench.py:288-307``."""
    frames, _, _ = jax_draws(m, frame)
    raw = jax_models["det"](j_resize(jnp.asarray(frames), 128, 128, True) / 127.5 - 1.0)
    _, _, ds, _ = j_detect_faces(raw, jnp.asarray(j_anchor_centers(128)), 0.3, 4)
    best = np.clip(np.asarray(ds[:, 0]), 1e-9, 1 - 1e-9)
    a, b = jax_models["calibration"]
    z = np.log(best / (1 - best))
    ref = float(np.mean(1.0 / (1.0 + np.exp(-(a * z + b)))))
    got = bench.Pipeline(1, "", True, CPU, *port_models).mean_det_score(torch.as_tensor(frames))
    assert abs(got - ref) <= DET_TOL, (got, ref)


@pytest.mark.parametrize("m,ablate,noise", [(1, "", False), (4, "", False), (1, "detect", False),
                                            (2, "warp", True), (1, "match", False)])
def test_json_keys_are_jax(m, ablate, noise):
    """The line's keys are ``bench.py:main``'s, in its order, with the
    crowd keys at M > 1, ``ablate`` when given and ``mean_det_score`` unless
    the frames are noise."""
    (keys,) = dumped_keys("bench.py", "main")
    crowd = {"max_faces", "frames_per_sec", "ms_per_frame", "gt_faces_per_frame", "slots_per_sec"}
    absent = (set() if m > 1 else crowd) | (set() if ablate else {"ablate"}) | (
        {"mean_det_score"} if noise else set())
    line = bench.report([10.0, 9.0], B, 1, GALLERY, 160, m, 3, True, ablate, None if noise else 0.9)
    assert list(line) == [k for k in keys if k not in absent]
    assert line["metric"] == bench.METRIC and line["unit"] == "faces/s"
    assert line["value"] == round((B if m == 1 else 3) / 9e-3, 1)


@pytest.mark.parametrize("argv", [["--unroll", "2"], ["--ablate", "detect", "--max-faces", "2"]])
def test_refusals_say_why(argv, capsys):
    """``--unroll`` other than 1 and ``--ablate detect`` with more than one
    face are refused by name before anything is drawn."""
    with pytest.raises(SystemExit):
        bench.main(argv + ["--device", "cpu"])
    err = capsys.readouterr().err
    assert ("--unroll" if "--unroll" in argv else "--ablate detect") in err
    if "--max-faces" in argv:
        with pytest.raises(ValueError, match="--max-faces"):
            bench.Pipeline(2, "detect", True, CPU)


def test_main_on_the_cpu_prints_the_line_last(capsys):
    """``main`` on the CPU: a ``#`` line, then the JSON line, last, whose
    keys are JAX's one-face keys, with finite checksums."""
    out = bench.main(["--device", "cpu", "--batch", "2", "--iters", "1", "--gallery", "64"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("# rounds_ms=")
    line = json.loads(lines[-1])
    assert line == out["line"] and len(out["rounds_ms"]) == 3
    (keys,) = dumped_keys("bench.py", "main")
    assert list(line) == [k for k in keys if k in ("metric", "value", "unit", "vs_baseline", "gallery",
                                                   "frame", "trained_weights", "mean_det_score")]
    assert line["trained_weights"] is True and 0.5 < line["mean_det_score"] <= 1.0
    assert all(np.isfinite(out["checksums"]))

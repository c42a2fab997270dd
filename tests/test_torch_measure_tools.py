"""The port's measurement and robustness tools against the JAX scripts.

``scripts/profile_pipeline``, ``scripts/bench_embed``,
``examples/serving_bench``, ``examples/realtime_bench`` and
``scripts/detector_robustness`` of ``facerecognition_tpu_torch``, on the CPU
at small sizes: each profile stage against the JAX function it times (JAX's
``scene_batch`` frames, seed 0; the shipped detector and ultraslim ArcFace),
the embedder variants given JAX's weights, the serving tool's answers
against the JAX engine, the realtime chain against the JAX script's
``one_frame``, the robustness transforms against the JAX module's
``variants`` and its detection table against JAX's. The
JSON keys are read from the JAX scripts' source. Tolerances are stated per
test; one intra-op thread.
"""

import ast
import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.extract_embeddings import (
    default_arcface_checkpoint as j_default_arcface,
)
from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.inference.extract_embeddings import (
    load_arcface_checkpoint as j_load_arcface,
)
from facerecognition_tpu.inference.extract_embeddings import (
    load_arcface_model as j_load_arcface_model,
)
from facerecognition_tpu.models.arcface import ArcFaceModel as JArcFace
from facerecognition_tpu.models.detector_net import anchor_centers as j_anchor_centers
from facerecognition_tpu.models.detector_net import build_detector_net as j_build_detector_net
from facerecognition_tpu.models.detector_net import detect_best_face as j_detect_best_face
from facerecognition_tpu.models.detector_net import detect_faces_batch as j_detect_faces_batch
from facerecognition_tpu.ops.image import normalize_imagenet_style as j_normalize
from facerecognition_tpu.ops.matcher import cosine_topk as j_cosine_topk
from facerecognition_tpu.ops.matcher import l2_normalize as j_l2_normalize
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JFaceDetector
from facerecognition_tpu.preprocessing.face_detector import (
    default_detector_checkpoint as j_default_detector,
)
from facerecognition_tpu.preprocessing.face_detector import (
    load_detector_checkpoint as j_load_detector,
)
from facerecognition_tpu.training.synthetic_faces import scene_batch as j_scene_batch
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.data.native_decode import decode_mem
from facerecognition_tpu_torch.examples import realtime_bench, serving_bench
from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
from facerecognition_tpu_torch.scripts import bench_embed, detector_robustness, profile_pipeline
from facerecognition_tpu_torch.training import raster
from facerecognition_tpu_torch.training.synthetic_faces import scene_batch

jwarp = importlib.import_module("facerecognition_tpu.ops.warp_mxu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_script(rel: str):
    """A JAX script loaded from its file (``scripts/`` and ``examples/`` are
    not packages)."""
    spec = importlib.util.spec_from_file_location(rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def dumped_keys(rel: str, func: str) -> list[list[str]]:
    """The literal keys of each dict passed to ``json.dumps`` in ``func`` of
    a JAX script, in order."""
    tree = ast.parse(open(os.path.join(REPO, rel)).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    out = []
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            out.append([k.value for k in node.args[0].keys])
    return out


@pytest.fixture(scope="module")
def models():
    """The shipped detector and ultraslim ArcFace, in both packages."""
    arch, det_vars, _ = j_load_detector(j_default_detector())
    jmodel, jvars = j_load_arcface(j_default_arcface())
    detector, embedder = profile_pipeline.load_models(CPU)
    return {"jdet": (j_build_detector_net(arch), det_vars), "jemb": (jmodel, jvars),
            "detector": detector, "embedder": embedder}


# -- profile_pipeline ---------------------------------------------------------


@pytest.fixture(scope="module")
def stages(models):
    """The port's stages at B 4 on JAX's frames and a 256-row gallery."""
    frames = j_scene_batch(np.random.default_rng(0), 4, 160, max_faces=1, p_face=1.0)[0]
    gal = np.random.default_rng(1).normal(size=(256, 512)).astype(np.float32)
    stages = profile_pipeline.build_stages(4, 256, extra=True, device=CPU, detector=models["detector"],
                                           embedder=models["embedder"],
                                           inputs=(frames.astype(np.float32), gal))
    stages["gallery"] = gal / np.linalg.norm(gal, axis=1, keepdims=True)
    return stages


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _run(stage):
    fn, inputs = stage
    with torch.no_grad():
        return fn(*inputs), [_np(t) for t in inputs]


def test_profile_frames_are_jax_scene_batch():
    """The port's draws render JAX's frames (seed 0) within the renderer's
    bound for scenes with a JPEG step (tools/scene_fixture)."""
    from facerecognition_tpu_torch.tools.scene_fixture import JPEG_MAX_ABS

    frames, gal = profile_pipeline.draws(2, 8)
    rng = np.random.default_rng(0)
    ref = j_scene_batch(rng, 2, 160, max_faces=1, p_face=1.0)[0]
    assert np.abs(frames - ref).max() <= JPEG_MAX_ABS
    np.testing.assert_array_equal(gal, rng.normal(size=(8, 512)).astype(np.float32))


@pytest.mark.parametrize("fast", [True, False])
def test_profile_resize_matches_jax(stages, fast):
    """``resize_160_to_det`` (bf16 operands) and ``x_resize_f32`` against
    ``bilinear_resize_mxu_batch``: within 0.5 level with bf16 operands, 1e-3
    in float32 (test_torch_ops)."""
    got, (frames,) = _run(stages["resize_160_to_det" if fast else "x_resize_f32"])
    ref = np.asarray(jwarp.bilinear_resize_mxu_batch(jnp.asarray(frames), 128, 128, fast))
    np.testing.assert_allclose(got.numpy(), ref, atol=0.5 if fast else 1e-3)


def test_profile_detector_matches_jax(stages, models):
    """``detector_fwd`` against the flax net: max error under 1e-4 of the
    largest output (test_torch_models)."""
    got, (small,) = _run(stages["detector_fwd"])
    net, variables = models["jdet"]
    ref = np.asarray(net.apply(variables, jnp.asarray(small) / 127.5 - 1.0))
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-4


def test_profile_decode_nms_matches_jax(stages):
    """``decode_nms`` (max_faces 4): validity and scores equal, boxes and
    landmarks within 1e-4 px (test_torch_crowd)."""
    got, (raw,) = _run(stages["decode_nms"])
    ref = j_detect_faces_batch(jnp.asarray(raw), jnp.asarray(j_anchor_centers(128)), 0.3, 4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-4, rtol=0)


def test_profile_align_matches_jax(stages):
    """``warp_align_112`` against ``align_crop_mxu_batch`` with bf16
    operands, from the same landmarks: max 1.5 levels, mean under 0.01
    (test_torch_ops)."""
    got, (frames, lm) = _run(stages["warp_align_112"])
    ref = np.asarray(jwarp.align_crop_mxu_batch(jnp.asarray(frames), jnp.asarray(lm), 112, True))
    diff = np.abs(got.numpy() - ref)
    assert diff.max() <= 1.5 and diff.mean() < 0.01, (diff.max(), diff.mean())


def test_profile_embed_matches_jax(stages, models):
    """``embed_resnet50`` against the flax ArcFace on the same faces: max
    error under 1e-4 of the largest output (test_torch_models)."""
    got, (aligned,) = _run(stages["embed_resnet50"])
    model, variables = models["jemb"]
    ref = np.asarray(model.apply(variables, j_normalize(jnp.asarray(aligned))))
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 1e-4


def test_profile_match_stages_match_jax(stages):
    """``match_topk`` against ``cosine_topk(normalized=True)`` on the unit
    gallery: indices equal, scores within 1e-5; the extras: the product
    within 1e-5, ``torch.topk``, the blocked top-k and ``approx_max_k``
    (exact off the TPU) all JAX's top-k."""
    got, (emb,) = _run(stages["match_topk"])
    gal = stages["gallery"]
    ref_s, ref_i = j_cosine_topk(jnp.asarray(emb), jnp.asarray(gal), 5, True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_s), atol=1e-5)
    scores, _ = _run(stages["x_match_matmul_only"])
    np.testing.assert_allclose(scores.numpy(), emb @ gal.T, atol=1e-5)
    s = jnp.asarray(_run(stages["x_topk_lax"])[1][0])
    lax_v, lax_i = jax.lax.top_k(s, 5)
    approx_v, approx_i = jax.lax.approx_max_k(s, 5, recall_target=0.99)
    np.testing.assert_array_equal(np.asarray(approx_i), np.asarray(lax_i))
    for name in ("x_topk_lax", "x_topk_blocked", "x_topk_approx"):
        v, i = _run(stages[name])[0]
        np.testing.assert_array_equal(i.numpy(), np.asarray(lax_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(lax_v))


def test_profile_json_keys_equal_jax(models, capsys):
    """The stage names, without and with ``--extra``, are JAX's, in order."""
    src = open(os.path.join(REPO, "scripts", "profile_pipeline.py")).read()
    tree = ast.parse(src)
    names = [n.slice.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
             and getattr(n.value, "id", None) == "stages" and isinstance(n.slice, ast.Constant)]
    assert names == list(profile_pipeline.STAGES + profile_pipeline.EXTRA)
    for extra in (False, True):
        out = profile_pipeline.profile(2, 1, 16, extra=extra, device=CPU, detector=models["detector"],
                                       embedder=models["embedder"])
        want = profile_pipeline.STAGES + (profile_pipeline.EXTRA if extra else ())
        assert tuple(out) == want and all(np.isfinite(v) and v > 0 for v in out.values())


def test_profile_main_prints_the_json_line(capsys):
    stages = profile_pipeline.main(["--batch", "2", "--iters", "1", "--gallery", "16", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    assert list(json.loads(last)) == list(stages) == list(profile_pipeline.STAGES)


# -- bench_embed ----------------------------------------------------------------


@pytest.mark.parametrize("stage_sizes", [(1, 1, 1, 1), (2, 2, 2, 2)])
def test_bench_embed_forward_matches_jax(stage_sizes):
    """Each variant's timed forward given JAX's ``init`` weights through
    convert.py: max error under 1e-4 of the largest output."""
    x = bench_embed.frames(2, CPU)
    jmodel = JArcFace(embedding_size=512, dtype=jnp.float32, stage_sizes=stage_sizes)
    jvars = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 112, 112, 3)))
    ref = np.asarray(j_l2_normalize(jmodel.apply(jvars, j_normalize(jnp.asarray(x.numpy()))).astype(jnp.float32)))
    model = bench_embed.variant_model(stage_sizes)
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, jvars))
    with torch.no_grad():
        got = bench_embed.variant_forward(model, CPU)(x).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_bench_embed_json_keys_equal_jax(capsys):
    rows = bench_embed.main(["--batch", "2", "--iters", "1", "--variants", "1,1,1,1", "--device", "cpu"])
    (keys,) = dumped_keys("scripts/bench_embed.py", "main")
    assert [list(r) for r in rows] == [keys] == [list(bench_embed.REPORT_KEYS)]
    assert rows[0]["stage_sizes"] == [1, 1, 1, 1] and rows[0]["img_per_sec"] > 0


# -- serving_bench / realtime_bench -------------------------------------------------


def test_serving_bench_answers_equal_the_engine():
    """Three clients x six requests at 128² on the CPU: the JAX script's
    keys, every request answered, and each warm-up answer equal to the JAX
    engine's fused call on the decoded upload (the shipped detector at
    threshold 0.3 and ArcFace, the same 32 gallery rows; the engine test's
    tolerances: top-5 names equal, cosines within 1e-3, box within 0.5 px)
    and to the served engine's own call."""
    out = serving_bench.run(clients=3, requests=6, frame=128, port=0, gallery=32, device=CPU,
                            log=lambda *_: None)
    report = out["report"]
    (keys,) = dumped_keys("examples/serving_bench.py", "main")
    assert list(report) == keys == list(serving_bench.REPORT_KEYS)
    assert report["failed"] == report["shed_429"] == 0 and report["throughput_rps"] > 0
    frame = decode_mem(out["jpegs"][0])
    rows = np.random.default_rng(0).normal(size=(32, 512)).astype(np.float32)
    jengine = JEngine(embedder=j_load_arcface_model(j_default_arcface()),
                      detector=JFaceDetector(confidence_threshold=0.3), match_kernel="dense")
    jengine.gallery.add_many([f"id_{i}" for i in range(32)], rows)
    jref = jengine.fused_recognize_frames(frame[None], k=5)[0]
    for ans in out["answers"]:
        assert ans["identity"] == jref["identity"]
        assert [n for n, _ in ans["top_k"]] == [n for n, _ in jref["top_k"]]
        np.testing.assert_allclose([s for _, s in ans["top_k"]], [s for _, s in jref["top_k"]], atol=1e-3)
        np.testing.assert_allclose(ans["bbox"], jref["bbox"], atol=0.5)
    ref = out["engine"].fused_recognize_frames(frame[None])[0]
    for ans in out["answers"]:
        assert ans["identity"] == ref["identity"]
        np.testing.assert_allclose(ans["bbox"], ref["bbox"], atol=1e-3)
        np.testing.assert_allclose(ans["confidence"], ref["confidence"], atol=1e-5)
        assert [n for n, _ in ans["top_k"]] == [n for n, _ in ref["top_k"]]


def test_realtime_latency_chain_equals_the_engine_parts(models):
    """Three 72 x 128 frames: the JAX script's keys; each frame's top-5 rows
    and cosines of the port's chain against the JAX script's ``one_frame``
    (its public functions under one ``jit``, the same weights, gallery and
    frames, its own carry): indices equal, cosines within 1e-5 (the match
    stage's tolerance; measured under 5e-7)."""
    out = realtime_bench.latency(3, 72, 128, 32, CPU, models["detector"], models["embedder"])
    (keys,) = dumped_keys("examples/realtime_bench.py", "main")
    assert list(realtime_bench.LATENCY_KEYS) == keys
    assert out["value"] > 0 and np.isfinite(out["carry"])
    gal, imgs = (jnp.asarray(t.numpy()) for t in realtime_bench.staged(3, 72, 128, 32, CPU))
    det_net, det_vars = models["jdet"]
    model, variables = models["jemb"]
    anchors = jnp.asarray(j_anchor_centers(128))
    h, w = 72, 128

    @jax.jit
    def one_frame(frame):
        small = jwarp.bilinear_resize_mxu_batch(frame[None], 128, 128)[0]
        raw = det_net.apply(det_vars, (small / 127.5 - 1.0)[None])[0]
        _, lms, det_score = j_detect_best_face(raw, anchors)
        lm = jnp.clip(lms * jnp.array([w / 128, h / 128]), 0.0, jnp.array([w - 1.0, h - 1.0]))
        aligned = jwarp.align_crop_mxu_batch(frame[None], lm[None], 112)
        emb = j_l2_normalize(model.apply(variables, j_normalize(aligned)).astype(jnp.float32))
        scores, idx = j_cosine_topk(emb, gal, 5, normalized=True)
        return scores[0, 0] + det_score, scores[0], idx[0]

    carry = jnp.float32(0.0)
    for i in range(3):
        carry, scores, idx = one_frame(imgs[i] + carry * 1e-12)
        assert out["top5"][i] == np.asarray(idx).tolist(), i
        np.testing.assert_allclose(out["scores"][i], np.asarray(scores), atol=1e-5, rtol=0)


def test_realtime_mjpeg_result_is_a_fused_answer():
    """``--mjpeg`` over a 96 x 128 ring: the JAX script's keys, and the
    recognizer's last result equal to the engine's fused call on one of the
    ring's frames."""
    embedder = load_arcface_model(stage_sizes=(1, 1, 1, 1), device=CPU)
    out = realtime_bench.mjpeg(3, 96, 128, CPU, embedder=embedder, wait_s=120)
    (keys,) = dumped_keys("examples/realtime_bench.py", "mjpeg_bench")
    assert list(realtime_bench.MJPEG_KEYS) == keys and out["value"] > 0
    res = out["result"]
    answers = out["engine"].fused_recognize_frames(out["ring"], max_faces=4)
    assert any(a["identity"] == res["identity"] and np.allclose(a["bbox"], res["bbox"], atol=1e-3)
               for a in answers)


# -- detector_robustness --------------------------------------------------------


@pytest.fixture(scope="module")
def photo():
    """A rendered 256² scene with one face (the port's renderer) and its
    box: the stand-in for the JAX script's photo."""
    imgs, boxes, _, valid = scene_batch(np.random.default_rng(3), 1, 256, max_faces=1, p_face=1.0)
    assert valid[0, 0]
    return imgs[0].astype(np.uint8), boxes[0, 0].astype(np.float32)


@pytest.fixture(scope="module")
def jax_cases(photo):
    """The JAX module's ``variants`` of the photo (BGR in, as cv2 reads it),
    each turned to RGB."""
    module = jax_script("scripts/detector_robustness.py")
    img, gt = photo
    module.GT_BOX = gt
    return [(g, n, np.ascontiguousarray(im[..., ::-1]), b) for g, n, im, b in module.variants(img[..., ::-1])]


def test_robustness_variants_equal_jax(photo, jax_cases):
    """Names and boxes equal; every image bit for bit except JPEG (encoder
    and decoder differ from OpenCV's: at most 48 levels at a pixel, mean
    under 1.5, the renderer's bound)."""
    img, gt = photo
    cases = list(detector_robustness.variants(img, gt))
    assert [(g, n) for g, n, _, _ in cases] == [(g, n) for g, n, _, _ in jax_cases]
    for (g, n, got, box), (_, _, ref, ref_box) in zip(cases, jax_cases):
        np.testing.assert_allclose(box, ref_box, rtol=1e-6, err_msg=n)
        assert got.shape == ref.shape, n
        diff = np.abs(got.astype(int) - ref.astype(int))
        if g == "jpeg":
            assert diff.max() <= 48 and diff.mean() < 1.5, (n, diff.max(), diff.mean())
        else:
            assert not diff.any(), n


def test_raster_u8_calls_equal_cv2():
    """warpAffine (reflect), INTER_AREA at 0.3x / 0.5x / 2x and GaussianBlur
    at sigma 2 / 4 on a noise image against cv2 5.0.0 (the version the tests
    run), all bit for bit; the warp also at a width under 16 (only OpenCV's
    scalar loop), on one channel and at a scale."""
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).integers(0, 256, (201, 301, 3), dtype=np.uint8)
    h, w = img.shape[:2]
    for src, deg, scale in ((img, -30, 1.0), (img, 15, 1.0), (img[:50, :15], 7.3, 1.0),
                            (img[..., 0], -61, 0.8)):
        sh, sw = src.shape[:2]
        m = cv2.getRotationMatrix2D((sw / 2, sh / 2), deg, scale)
        np.testing.assert_array_equal(raster.rotation_matrix((sw / 2, sh / 2), deg, scale), m)
        np.testing.assert_array_equal(raster.warp_affine_u8_reflect(src, m, (sw, sh)),
                                      cv2.warpAffine(src, m, (sw, sh), borderMode=cv2.BORDER_REFLECT))
    for s in (0.3, 0.5, 2.0):
        size = (int(w * s), int(h * s))
        np.testing.assert_array_equal(raster.resize_area_u8(img, size),
                                      cv2.resize(img, size, interpolation=cv2.INTER_AREA))
    even = img[:200, :300]
    np.testing.assert_array_equal(raster.resize_area_u8(even, (150, 100)),
                                  cv2.resize(even, (150, 100), interpolation=cv2.INTER_AREA))
    for sigma in (2.0, 4.0):
        np.testing.assert_array_equal(raster.gaussian_blur_u8(img, sigma), cv2.GaussianBlur(img, (0, 0), sigma))


def test_robustness_table_equals_jax(photo, jax_cases):
    """The detection table's non-JPEG rows equal JAX's (the shipped detector
    at threshold 0.5 on the CPU); the JPEG rows, from other bytes, keep
    JAX's ``detected``."""
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    img, gt = photo
    got = detector_robustness.evaluate(FaceDetector(confidence_threshold=0.5, device=CPU),
                                       detector_robustness.variants(img, gt))
    ref = jax_script("scripts/detector_robustness.py")
    jdet = JFaceDetector(confidence_threshold=0.5)
    want = []
    for g, n, im, box in jax_cases:
        dets = jdet.detect_all(im)
        best = max([(ref._iou(np.asarray(d["bbox"], np.float32), box), float(d["confidence"]))
                    for d in dets], default=(0.0, 0.0))
        want.append(dict(group=g, name=n, detected=bool(best[0] >= 0.5), iou=round(float(best[0]), 3),
                         conf=round(best[1], 3), n_dets=len(dets)))
    for a, b in zip(got, want):
        if a["group"] == "jpeg":
            assert a["detected"] == b["detected"], (a, b)
        else:
            assert a == b
    assert "recall@IoU0.5" in detector_robustness.report(got)


def test_robustness_main_refuses_a_missing_photo(tmp_path):
    missing = str(tmp_path / "none.jpg")
    with pytest.raises(FileNotFoundError, match="none.jpg"):
        detector_robustness.main(["--image", missing, "--device", "cpu"])
    path, gt = detector_robustness.ground_truth()
    assert path.endswith("anh1.jpg") and gt.tolist() == [285, 140, 665, 640]

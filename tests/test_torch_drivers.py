"""The port's drivers against the JAX scripts on the CPU.

The top-level JAX scripts are not a package: they are loaded from their
files and run as their command lines would run them. At small sizes:

- ``render_id_folders``: the same files, pixels within the renderer's
  aligned-sample bounds (``tools/scene_fixture``: the similarity fit, then
  the truncation to uint8, one level more);
- ``lbph_scale_eval``'s reading (``load_gray`` + ``bilinear_resize_u8``)
  equal to the JAX script's ``cv2.imread(IMREAD_GRAYSCALE)`` +
  ``cv2.resize`` on a rendered folder;
- ``facenet_ab_eval`` and ``examples/evaluate_model`` against the JAX
  scripts' outputs (top-1 and every metric of the results equal);
- the detector drivers: a short ``train_detector_v4`` run whose saved,
  calibrated checkpoint the JAX package loads, calibrates and evaluates to
  the port's numbers (Platt parameters within 2% on 40 scenes, a fifth of
  whose JPEG step another encoder takes; quality equal).

The evaluations' reports against the JAX scripts' are in
``tests/test_torch_evals.py``.
"""

import importlib.util
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR
from facerecognition_tpu_torch.tools import scene_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULTRASLIM = os.path.join(ASSETS_DIR, "arcface_synthid9k_ultraslim_512.msgpack")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: six workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_script(rel: str, argv: list):
    """Run ``python <rel> <argv>`` (a JAX script) in this process; returns
    what its ``main`` returns."""
    spec = importlib.util.spec_from_file_location("jax_" + os.path.basename(rel)[:-3],
                                                  os.path.join(REPO, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = sys.argv
    sys.argv = [rel] + [str(a) for a in argv]
    try:
        return module.main()
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def id_folders(tmp_path_factory):
    """4 identities x 4 aligned samples at 160², rendered by the port."""
    from facerecognition_tpu_torch.scripts.render_id_folders import render_id_folders

    out = str(tmp_path_factory.mktemp("ids"))
    render_id_folders(out, n_ids=4, per_id=4, size=160, seed=3, workers=2, log=None)
    return out


def test_render_id_folders_matches_jax_script(tmp_path):
    from facerecognition_tpu_torch.scripts.render_id_folders import main

    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    main(["--out", ours, "--n-ids", "3", "--per-id", "3", "--size", "64", "--seed", "2"])
    jax_script("scripts/render_id_folders.py", ["--out", theirs, "--n-ids", 3, "--per-id", 3,
                                                "--size", 64, "--seed", 2])
    files = sorted(os.path.relpath(os.path.join(d, f), ours) for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == 9 and files[0] == os.path.join("id_00000", "000.png")
    for f in files:
        a, b = (cv2.imread(os.path.join(root, f)).astype(int) for root in (ours, theirs))
        d = np.abs(a - b)
        assert d.max() <= scene_fixture.ALIGNED_MAX_ABS + 1
        assert d.mean() <= scene_fixture.ALIGNED_MEAN_ABS + 0.01


def test_lbph_reads_what_the_jax_script_reads(id_folders):
    from facerecognition_tpu_torch.scripts.lbph_scale_eval import load_split

    train, train_labels, probe, probe_labels = load_split(id_folders, 4, 3, 1, 100, workers=2)
    want = []
    for d in sorted(os.listdir(id_folders)):
        for f in sorted(os.listdir(os.path.join(id_folders, d))):
            img = cv2.imread(os.path.join(id_folders, d, f), cv2.IMREAD_GRAYSCALE)
            want.append(cv2.resize(img, (100, 100)))
    want = np.stack(want).reshape(4, 4, 100, 100)
    np.testing.assert_array_equal(train, want[:, :3].reshape(-1, 100, 100))
    np.testing.assert_array_equal(probe, want[:, 3])
    np.testing.assert_array_equal(train_labels, np.repeat(np.arange(4), 3))
    np.testing.assert_array_equal(probe_labels, np.arange(4))


def test_facenet_ab_eval_matches_jax_script(id_folders, tmp_path):
    from facerecognition_tpu_torch.scripts.facenet_ab_eval import main

    facenet = os.path.join(ASSETS_DIR, "facenet_synthid9k_512.msgpack")
    ours = main([facenet, "--data-dir", id_folders, "--max-images", "12", "--device", "cpu"])
    jax_script("scripts/facenet_ab_eval.py", [facenet, "--data-dir", id_folders, "--max-images", 12,
                                              "--out", tmp_path / "jax.json"])
    with open(tmp_path / "jax.json") as f:
        assert ours == json.load(f)


def test_evaluate_model_matches_jax_script(id_folders, tmp_path):
    from facerecognition_tpu_torch.examples.evaluate_model import evaluate_model, main

    spec = importlib.util.spec_from_file_location("jax_evaluate_model",
                                                  os.path.join(REPO, "examples", "evaluate_model.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    args = ["--data-dir", id_folders, "--checkpoint", ULTRASLIM]
    module.main(args + ["--output-dir", str(tmp_path / "jax")])
    ours = main(args + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    with open(tmp_path / "jax" / "results.json") as f:
        want = json.load(f)
    got = json.loads(json.dumps(ours, default=str))
    assert set(got) == set(want)
    for key in ("metrics", "top_1_accuracy", "top_5_accuracy", "cmc"):
        assert json.dumps(got[key], sort_keys=True) == json.dumps(want[key], sort_keys=True), key
    # the sweep's thresholds are the matches' scores: float32 sums in another order
    sweep, want_sweep = got["threshold_sweep"]["sweep"], want["threshold_sweep"]["sweep"]
    assert len(sweep) == len(want_sweep)
    for row, ref in zip(sweep, want_sweep):
        assert abs(row.pop("threshold") - ref.pop("threshold")) < 1e-5 and row == ref
    assert abs(got["verification"]["auc"] - want["verification"]["auc"]) < 1e-6
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    # without plots (no matplotlib on a card machine), through the stream matcher: the same results
    bare = evaluate_model(id_folders, checkpoint=ULTRASLIM, output_dir=str(tmp_path / "bare"),
                          match_kernel="stream", plots=False, device="cpu")
    assert sorted(os.listdir(tmp_path / "bare")) == ["report.md", "results.json"]
    assert bare["top_1_accuracy"] == ours["top_1_accuracy"] and bare["metrics"] == ours["metrics"]


def _small_detector_runs(monkeypatch, eval_scenes: int, cal_scenes: int) -> None:
    """The drivers' JAX-fixed sizes cut for the CPU: fewer evaluation and
    calibration scenes, a batch of 2 where no ``--batch`` is taken, one
    loader thread."""
    import functools

    from facerecognition_tpu_torch.scripts import train_detector_v3
    from facerecognition_tpu_torch.training import train_detector as td

    monkeypatch.setattr(train_detector_v3, "EVAL_SCENES", eval_scenes)
    monkeypatch.setattr(train_detector_v3, "CAL_SCENES", cal_scenes)
    monkeypatch.setattr(td, "CurriculumConfig",
                        functools.partial(td.CurriculumConfig, batch_size=2, prefetch_threads=1))


def test_detector_v4_driver_checkpoint_in_jax(tmp_path, monkeypatch):
    """Two curriculum steps from ``detector_v3_128`` on the CPU, the
    checkpoint saved, calibrated and evaluated; the JAX package reads the
    file, fits the same calibration and measures the same quality."""
    from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JaxDetector
    from facerecognition_tpu.training import synthetic_faces as jax_sf
    from facerecognition_tpu.training.train_detector import evaluate_detector, fit_score_calibration
    from facerecognition_tpu_torch.scripts import train_detector_v4

    _small_detector_runs(monkeypatch, eval_scenes=4, cal_scenes=40)
    out = str(tmp_path / "v4.msgpack")
    got = train_detector_v4.main(["--steps", "2", "--batch", "2", "--out", out, "--device", "cpu"])
    det = JaxDetector(weights=out, confidence_threshold=0.5)
    assert det.arch == "dense" and det._calibration is not None
    a, b = fit_score_calibration(det, n_scenes=40, ranges=jax_sf.SCENE_RANGES["v4"])
    # the fit's scenes take the JPEG step in another encoder (up to 34 levels
    # at a pixel), which moves the raw scores: 0.6% apart on 40 scenes
    np.testing.assert_allclose(got["calibration"], (a, b), rtol=0.02)
    np.testing.assert_allclose(det._calibration, got["calibration"], rtol=0, atol=1e-7)
    for ranges, key in ((None, "v3"), (jax_sf.RANGES_V4, "v4")):
        want = evaluate_detector(det, n_scenes=4, seed=778, ranges=ranges)
        assert got[key]["n_gt"] == want["n_gt"] and got[key]["recall"] == want["recall"]
        assert abs(got[key]["mean_iou"] - want["mean_iou"]) < 1e-3


@pytest.mark.parametrize("driver", ["train_detector_v3", "finetune_detector_v3"])
def test_detector_drivers_save_calibrated_checkpoints(tmp_path, monkeypatch, driver):
    """One step each (v3 from scratch, the fine-tune from ``--ckpt``): a
    DenseDetNet checkpoint with its calibration that the port's detector
    loads without the uncalibrated warning."""
    import importlib
    import warnings

    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    _small_detector_runs(monkeypatch, eval_scenes=2, cal_scenes=3)
    out = str(tmp_path / "det.msgpack")
    batch = ["--batch", "2"] if driver == "train_detector_v3" else []  # the fine-tune takes none
    got = importlib.import_module(f"facerecognition_tpu_torch.scripts.{driver}").main(
        ["--steps", "1", *batch, "--out", out, "--device", "cpu"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        det = FaceDetector(weights=out, device="cpu")
    assert det.arch == "dense" and det._calibration == pytest.approx(got["calibration"])

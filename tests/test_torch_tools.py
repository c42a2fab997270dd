"""The port's host tools against the JAX package's: profiling, the batch
grid, label maps, checkpoint inspection and training-log analysis (the
contracts of ``tests/test_utils.py`` and ``tests/test_pipeline_tools.py``
repeated on the port, and the same outputs as JAX on the same inputs), the
gray/resize reading of ``lbph_scale_eval`` probed against the sandbox's cv2,
and the int8 warp mode's message."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from facerecognition_tpu.scripts import create_label_map as jax_clm
from facerecognition_tpu.scripts import inspect_checkpoint as jax_ic
from facerecognition_tpu.scripts import visualize_logs as jax_vl
from facerecognition_tpu.utils.serialization import save_variables as jax_save_variables
from facerecognition_tpu_torch.data.visualize import visualize_batch
from facerecognition_tpu_torch.ops import warp_mxu, warp_sample
from facerecognition_tpu_torch.ops.image import bilinear_resize_u8
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR
from facerecognition_tpu_torch.scripts import create_label_map as clm
from facerecognition_tpu_torch.scripts import inspect_checkpoint as ic
from facerecognition_tpu_torch.scripts import visualize_logs as vl
from facerecognition_tpu_torch.utils import profiling
from facerecognition_tpu_torch.utils.imageio import encode_jpeg, load_gray, save_png


def test_throughput_counter():
    c = profiling.ThroughputCounter()
    c.record(10, 0.1)
    c.record(10, 0.2)
    s = c.stats()
    assert abs(s["items_per_sec"] - 20 / 0.3) < 1e-6
    assert s["p50_ms"] > 0
    with c.measure(5):
        pass
    assert c.stats()["n"] == 3
    assert profiling.ThroughputCounter().stats() == {"items_per_sec": 0.0, "p50_ms": 0.0,
                                                     "p95_ms": 0.0, "n": 0}


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` (torch.profiler) writes ``trace.json`` naming the ops of
    the block; on the card it records the kernels too (``chip_smoke.py``)."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.mm(a, a)
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    assert any("aten::mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_visualize_batch(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 32, 32, 3)).astype(np.uint8)
    out = visualize_batch(imgs, np.arange(6) % 3, ["a", "b", "c"], str(tmp_path / "b.png"),
                          augmented=imgs[::-1].copy())
    assert os.path.exists(out)
    one = visualize_batch(imgs[:1], np.zeros(1), None, str(tmp_path / "d" / "one.png"),
                          augmented=imgs[:1])
    assert os.path.exists(one)


def test_create_label_map_from_csv_and_dir(tmp_path):
    import pandas as pd

    csv = tmp_path / "map.csv"
    pd.DataFrame({"identity_id": ["a", "b"], "label": [0, 1]}).to_csv(csv, index=False)
    assert clm.create_label_map(str(csv), output_path=str(tmp_path / "lm.npy")) == {0: "a", 1: "b"}
    assert np.load(tmp_path / "lm.npy", allow_pickle=True).item() == {0: "a", 1: "b"}
    split = tmp_path / "split.csv"
    pd.DataFrame({"image_path": ["x/p1/0.png", "x/p2/1.png", "x/p1/2.png"], "label": [0, 1, 0]}).to_csv(
        split, index=False)
    got = clm.create_label_map(str(split), output_path=str(tmp_path / "lm_split.npy"))
    assert got == jax_clm.create_label_map(str(split), output_path=str(tmp_path / "jax.npy")) == {0: "p1", 1: "p2"}
    for person in ("zed", "amy"):
        d = tmp_path / "ds" / person
        d.mkdir(parents=True)
        save_png(d / "0.png", np.full((30, 30, 3), 7, np.uint8))
    m2 = clm.create_label_map(dataset_dir=str(tmp_path / "ds"), output_path=str(tmp_path / "lm2.npy"))
    assert m2 == jax_clm.create_label_map(dataset_dir=str(tmp_path / "ds"),
                                          output_path=str(tmp_path / "jax2.npy")) == {0: "amy", 1: "zed"}
    with pytest.raises(ValueError):
        clm.create_label_map(output_path=str(tmp_path / "nope.npy"))
    assert clm.main(["--csv", str(csv), "--output", str(tmp_path / "m.npy")]) == {0: "a", 1: "b"}


def test_inspect_checkpoint_msgpack_equals_jax(tmp_path):
    tree = {"params": {"layer": {"kernel": np.zeros((4, 8), np.float32)}}}
    path = str(tmp_path / "ck.msgpack")
    jax_save_variables(path, tree)
    info = ic.inspect(path)
    assert info["n_params"] == 32 and any("kernel" in line for line in info["lines"])
    for shipped in (path, os.path.join(ASSETS_DIR, "detector_v4_128.msgpack")):
        assert ic.inspect(shipped) == jax_ic.inspect(shipped)


def test_inspect_checkpoint_pth_and_training_checkpoint(tmp_path):
    from facerecognition_tpu_torch.convert import save_torch_checkpoint
    from facerecognition_tpu_torch.training.checkpoint import CheckpointManager

    sd = {"conv.weight": torch.zeros(4, 3, 3, 3), "bn.running_mean": torch.zeros(4),
          "bn.num_batches_tracked": torch.tensor(0)}
    pth = str(tmp_path / "m.pth")
    save_torch_checkpoint(pth, sd)
    got = ic.inspect(pth)
    assert got["n_params"] == 112
    assert got["lines"] == ["bn/num_batches_tracked  ()  torch.int64", "bn/running_mean  (4,)  torch.float32",
                            "conv/weight  (4, 3, 3, 3)  torch.float32"]
    # JAX reads the file into numpy: the same paths and shapes, numpy's dtype names
    want = jax_ic.inspect(pth)
    assert want["n_params"] == got["n_params"]
    assert [line.rsplit("  ", 1)[0] for line in want["lines"]] == [
        line.rsplit("  ", 1)[0] for line in got["lines"]]
    CheckpointManager(str(tmp_path / "ck")).save("last", {"model": sd, "opt_state": [torch.ones(3)], "step": 5})
    info = ic.main([str(tmp_path / "ck" / "ckpt_last")])
    assert info["n_params"] == 115
    assert "opt_state/0  (3,)  torch.float32" in info["lines"] and "step  None  int" in info["lines"]
    with pytest.raises(FileNotFoundError):
        ic.inspect(str(tmp_path))


def _histories(tmp_path):
    h1 = [{"epoch": i, "train_loss": 1.0 - i * 0.05, "ver_acc": 0.5 + i * 0.02} for i in range(10)]
    h2 = [{"epoch": i, "train_loss": 0.5 - (i - 10) * 0.03, "ver_acc": 0.7 - (i - 10) * 0.03}
          for i in range(10, 20)]
    p1, p2 = tmp_path / "h1.json", tmp_path / "h2.json"
    p1.write_text(json.dumps(h1))
    p2.write_text(json.dumps(h2))
    return [str(p1), str(p2)]


def test_visualize_logs_and_overfit(tmp_path):
    paths = _histories(tmp_path)
    merged = vl.merge_histories(paths)
    assert merged == jax_vl.merge_histories(paths) and len(merged) == 20
    result = vl.analyze_overfit(merged)
    assert result == jax_vl.analyze_overfit(merged)
    assert result["overfitting"] is True and result["best_epoch"] == 10
    assert vl.analyze_overfit(merged[:5]) == {"overfitting": False, "reason": "history too short"}
    assert os.path.exists(vl.plot_history(merged, str(tmp_path / "curves.png")))
    assert vl.main(paths + ["--output", str(tmp_path / "main.png")]) == result
    assert os.path.getsize(tmp_path / "main.png") > 0


def test_load_gray_png_is_cv2_imread_grayscale(tmp_path):
    """PNG: libpng's ``rgb_to_gray`` as OpenCV sets it, bit for bit (RGB
    noise, flat and saturated colours, and a gray file)."""
    rng = np.random.default_rng(0)
    a, b = np.meshgrid(np.arange(0, 256, 5), np.arange(0, 256, 7), indexing="ij")
    cases = [rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
             np.tile(np.arange(256, dtype=np.uint8)[:, None, None], (1, 8, 3)),
             np.stack([a, b, np.full_like(a, 255)], -1).astype(np.uint8)]
    for i, img in enumerate(cases):
        path = str(tmp_path / f"{i}.png")
        save_png(path, img)
        np.testing.assert_array_equal(load_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    gray = rng.integers(0, 256, (20, 30), dtype=np.uint8)
    save_png(tmp_path / "g.png", gray)
    np.testing.assert_array_equal(load_gray(str(tmp_path / "g.png")), gray)


def test_load_gray_jpeg_is_cv2_imread_grayscale(tmp_path):
    """JPEG: OpenCV reads libjpeg's grayscale output, the Y plane as stored
    (a gray of the decoded colours is up to 11 levels off on rendered
    faces); the port's decoder hands out the same plane: bit for bit with
    this sandbox's libjpeg, for 4:2:0 (the port's encoder), 4:4:4 and
    progressive (PIL) and gray (cv2) files."""
    from PIL import Image

    from facerecognition_tpu_torch.training.synthetic_faces import render_scene

    rng = np.random.default_rng(1)
    for i in range(3):
        img = render_scene(rng, 96 + 8 * i, 1, 1.0)[0].astype(np.uint8)
        paths = [str(tmp_path / f"{i}_{k}.jpg") for k in range(4)]
        with open(paths[0], "wb") as f:
            f.write(encode_jpeg(img, quality=90))
        Image.fromarray(img).save(paths[1], quality=95, subsampling=0)
        Image.fromarray(img).save(paths[2], quality=80, progressive=True)
        cv2.imwrite(paths[3], cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
        for path in paths:
            np.testing.assert_array_equal(load_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("src, dst", [((160, 160), 100), ((112, 112), 100), ((64, 64), 100),
                                      ((37, 53), 100), ((218, 178), 100)])
def test_gray_resize_is_cv2_resize(src, dst):
    """``cv2.resize`` INTER_LINEAR on one uint8 channel, 11-bit weights:
    ``bilinear_resize_u8`` bit for bit, down and up."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src, dtype=np.uint8)
    got = bilinear_resize_u8(torch.from_numpy(img)[..., None], dst, dst)[..., 0].numpy()
    np.testing.assert_array_equal(got, cv2.resize(img, (dst, dst)))


def test_int8_warp_mode_message():
    """The int8 warp mode runs through both wrappers (the resize takes it as
    JAX does: its bf16 path), and a mode that is none of False, True and
    "int8" is refused by name."""
    frames = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(1, 8, 8, 3)
    ms = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]])
    got = warp_sample.affine_warp(frames, ms, 8, 8, fast="int8")
    assert torch.equal(got, warp_mxu.affine_warp_mxu_batch(frames, ms, 8, 8, fast="int8"))
    assert torch.equal(got, frames)  # the identity map keeps every level
    assert torch.equal(warp_sample.bilinear_resize(frames, 4, 4, fast="int8"),
                       warp_sample.bilinear_resize(frames, 4, 4, fast=True))
    for call in (lambda: warp_mxu.affine_warp_mxu_batch(frames, ms, 8, 8, fast="int4"),
                 lambda: warp_sample.affine_warp(frames, ms, 8, 8, fast="int4"),
                 lambda: warp_sample.bilinear_resize(frames, 4, 4, fast="bf16")):
        with pytest.raises(ValueError, match="False, True or 'int8'"):
            call()

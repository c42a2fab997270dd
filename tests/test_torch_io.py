"""The port's checkpoint reader, imports, device rule and kernel guards.

The reader must decode the shipped flax msgpack assets leaf for leaf as
``flax.serialization.msgpack_restore`` does, without flax or msgpack.
"""

import os
import subprocess
import sys

import flax.serialization
import numpy as np
import pytest
import torch

from facerecognition_tpu_torch import _build
from facerecognition_tpu_torch.convert import flax_to_state_dict
from facerecognition_tpu_torch.ops import detect_post as dp
from facerecognition_tpu_torch.ops import stream_topk as st
from facerecognition_tpu_torch.ops import warp_mxu
from facerecognition_tpu_torch.ops import warp_sample as ws
from facerecognition_tpu_torch.utils.serialization import load_variables, unpackb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = ("detector_v4_128.msgpack", "arcface_synthid9k_ultraslim_512.msgpack")


def _assert_tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for key in b:
            _assert_tree_equal(a[key], b[key], f"{path}/{key}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("name", ASSETS)
def test_reader_matches_flax_on_shipped_assets(name):
    path = os.path.join(REPO, "assets", name)
    with open(path, "rb") as f:
        ref = flax.serialization.msgpack_restore(f.read())
    _assert_tree_equal(load_variables(path), ref)


def test_reader_matches_flax_on_every_leaf_kind(rng):
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(5,)),
        "i32": rng.integers(-9, 9, size=(2, 2, 2)).astype(np.int32),
        "u8": rng.integers(0, 255, size=(7,)).astype(np.uint8),
        "bool": np.array([True, False]),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(2.5),
        "nested": {
            "ints": {"pos": 7, "neg": -3, "big": 2**40, "negbig": -(2**33)},
            "float": 3.8100254,
            "text": "dense" * 10,
            "flag": True,
            "none": None,
        },
        "list": [1, 2.0, "x"],
    }
    ref = flax.serialization.msgpack_restore(flax.serialization.msgpack_serialize(tree))
    got = unpackb(flax.serialization.msgpack_serialize(tree))
    _assert_tree_equal(got, ref)


def test_reader_rejects_truncated_data():
    data = flax.serialization.msgpack_serialize({"a": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError):
        unpackb(data[:-3])


def test_convert_layouts():
    variables = {
        "params": {
            "conv": {"kernel": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5),
                     "bias": np.ones(5, np.float32)},
            "fc": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "bn": {"scale": np.full(3, 2.0, np.float32), "bias": np.zeros(3, np.float32)},
            "arcface": {"weight": np.zeros((7, 3), np.float32)},
        },
        "batch_stats": {"bn": {"mean": np.ones(3, np.float32), "var": np.full(3, 4.0, np.float32)}},
    }
    sd = flax_to_state_dict(variables)
    assert sd["conv.weight"].shape == (5, 4, 2, 3)  # HWIO → OIHW
    np.testing.assert_array_equal(
        sd["conv.weight"].numpy(), variables["params"]["conv"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), variables["params"]["fc"]["kernel"].T)
    assert sd["bn.weight"].tolist() == [2.0] * 3
    assert sd["bn.running_var"].tolist() == [4.0] * 3
    assert sd["bn.num_batches_tracked"].item() == 0
    assert not any(k.startswith("arcface") for k in sd)


def test_port_imports_nothing_of_jax():
    """Importing every module of the port and chip_smoke leaves jax, flax,
    msgpack, cv2, PIL and the JAX package out of sys.modules, and yaml,
    sklearn, matplotlib and pandas too (imported inside the functions that
    need them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import facerecognition_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = ('jax', 'flax', 'msgpack', 'cv2', 'PIL', 'facerecognition_tpu',\n"
        "       'yaml', 'sklearn', 'matplotlib', 'pandas')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n"
        "print(sorted(m.split('.')[-1] for m in sys.modules if m.startswith(p.__name__ + '.ops.')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    )
    bad, ops = out.stdout.strip().splitlines()
    assert bad == "[]", out.stdout + out.stderr
    for wrapper in ("stream_topk", "warp_sample", "detect_post"):
        assert f"'{wrapper}'" in ops, ops


def test_csrc_does_not_include_torch_headers():
    for name in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src = f.read()
        assert "torch/extension.h" not in src and "#include <torch" not in src, name


def _entry_points():
    from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
    from facerecognition_tpu_torch.inference.extract_embeddings import load_arcface_model
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training import train_detector as td
    from facerecognition_tpu_torch.training import train_synthid as ts

    return {
        "FaceDetector": lambda: FaceDetector(),
        "Embedder": lambda: load_arcface_model(stage_sizes=(1, 1, 1, 1)),
        "Gallery": lambda: Gallery(16),
        "RecognitionEngine": lambda: RecognitionEngine(),
        "train_detector_curriculum": lambda: td.train_detector_curriculum(
            td.CurriculumConfig(input_size=64, batch_size=2, steps=1, prefetch_threads=1)
        ),
        "train_detector_synthetic": lambda: td.train_detector_synthetic(
            td.DetectorTrainConfig(input_size=64, batch_size=2, steps=1)
        ),
        "train_synthid": lambda: ts.train_synthid(
            ts.SynthIdConfig(n_ids=2, train_per_id=1, val_per_id=2, batch_size=2, epochs=1,
                             stage_sizes=(1, 1, 1, 1)),
            log=lambda *_: None,
        ),
    }


@pytest.mark.parametrize("entry", ["FaceDetector", "Embedder", "Gallery", "RecognitionEngine",
                                   "train_detector_curriculum", "train_detector_synthetic",
                                   "train_synthid"])
def test_entry_points_default_to_the_card(entry):
    """No device argument means CUDA: without a card that raises, and asks
    for device='cpu'; nothing moves to the CPU silently. (A trainer returns
    weights, not a device: on a card it has run there.)"""
    make = _entry_points()[entry]
    if torch.cuda.is_available():
        assert getattr(make(), "device", torch.device("cuda")).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_find_nvcc_raises_without_toolkit(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@pytest.mark.parametrize(
    "q, g, k, error",
    [
        (torch.zeros(2, 8), torch.zeros(5, 8, device="meta"), 3, ValueError),  # mixed devices
        (torch.zeros(2, 8, device="meta", dtype=torch.float64),
         torch.zeros(5, 8, device="meta", dtype=torch.float64), 3, TypeError),
        (torch.zeros(2, 8, device="meta"), torch.zeros(5, 8, device="meta"), 33, ValueError),
        (torch.zeros(2, 6, device="meta"), torch.zeros(5, 6, device="meta"), 3, ValueError),
        (torch.zeros(2, 8, device="meta"), torch.zeros(5, 4, device="meta"), 3, ValueError),
        (torch.zeros(2, 8, device="meta"), torch.zeros(8, 5, device="meta").T, 3, ValueError),
    ],
)
def test_stream_topk_checks_before_launch(q, g, k, error):
    before = st.launches.count
    with pytest.raises(error):
        st.stream_topk(q, g, k)
    assert st.launches.count == before


def test_stream_topk_off_cpu_never_takes_the_plain_path(tmp_path, monkeypatch):
    """A tensor that is not on the CPU goes to the kernel (here: its build,
    which fails without nvcc) and never to stream_topk_reference."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(st, "stream_topk_reference", lambda *a: pytest.fail("fell back"))
    q = torch.zeros(2, 8, device="meta")
    g = torch.zeros(5, 8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        st.stream_topk(q, g, 3)


def _meta_frames(dtype=torch.uint8, shape=(2, 32, 32, 3)):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda: ws.bilinear_resize(_meta_frames(torch.float64), 16, 16), TypeError),
        (lambda: ws.align_crop(_meta_frames(torch.int32), torch.zeros(2, 1, 5, 2, device="meta"), 8),
         TypeError),
        (lambda: ws.bilinear_resize(_meta_frames(shape=(2, 32, 32, 4)), 16, 16), ValueError),
        (lambda: ws.bilinear_resize(_meta_frames().transpose(1, 2), 16, 16), ValueError),
        (lambda: ws.bilinear_resize(_meta_frames(), 16, 16, fast="int8"), NotImplementedError),
        (lambda: ws.align_crop(_meta_frames(), torch.zeros(2, 3, 5, 2), 16), ValueError),  # mixed devices
        (lambda: ws.align_crop_window(_meta_frames(torch.float16), torch.zeros(2, 3, 5, 2, device="meta"), 16, 24),
         TypeError),
    ],
)
def test_warp_sample_checks_before_launch(call, error):
    before = ws.launches.count
    with pytest.raises(error):
        call()
    assert ws.launches.count == before


@pytest.mark.parametrize(
    "raw, anchors, error",
    [
        (torch.zeros(2, 10, 15), torch.zeros(10, 3, device="meta"), ValueError),  # mixed devices
        (torch.zeros(2, 10, 15, device="meta", dtype=torch.float64), torch.zeros(10, 3, device="meta"), TypeError),
        (torch.zeros(2, 10, 14, device="meta"), torch.zeros(10, 3, device="meta"), ValueError),
        (torch.zeros(2, 10, 15, device="meta"), torch.zeros(11, 3, device="meta"), ValueError),
        (torch.zeros(2, 15, 10, device="meta").mT, torch.zeros(10, 3, device="meta"), ValueError),
    ],
)
def test_detect_post_checks_before_launch(raw, anchors, error):
    before = dp.launches.count
    with pytest.raises(error):
        dp.detect_post(raw, anchors, 0.3, 4)
    assert dp.launches.count == before


def test_new_kernels_off_cpu_never_take_the_plain_path(tmp_path, monkeypatch):
    """Tensors that are not on the CPU go to the kernels (here: their build,
    which fails without nvcc), never to the plain two-pass warp or the plain
    post-process."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    for name in ("affine_warp_mxu_batch", "bilinear_resize_mxu_batch", "align_crop_mxu_batch",
                 "align_crop_mxu_window"):
        monkeypatch.setattr(warp_mxu, name, lambda *a, **k: pytest.fail("fell back"))
    monkeypatch.setattr(dp, "detect_faces_batch", lambda *a, **k: pytest.fail("fell back"))
    frames = _meta_frames()
    lms = torch.zeros(2, 3, 5, 2, device="meta")
    calls = [
        lambda: ws.bilinear_resize(frames, 16, 16, True),
        lambda: ws.align_crop(frames, lms, 16, True),
        lambda: ws.align_crop_window(frames, lms, 16, 24, True),
        lambda: dp.detect_post(torch.zeros(2, 10, 15, device="meta"), torch.zeros(10, 3, device="meta"), 0.3, 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()


def test_new_kernels_on_cpu_take_the_plain_path(rng):
    frames = torch.as_tensor(rng.integers(0, 256, (2, 32, 40, 3)).astype(np.uint8))
    before = (ws.launches.count, dp.launches.count)
    got = ws.bilinear_resize(frames, 16, 20, True)
    assert torch.equal(got, warp_mxu.bilinear_resize_mxu_batch(frames, 16, 20, True))
    raw = torch.as_tensor(rng.normal(size=(2, 896, 15)).astype(np.float32))
    from facerecognition_tpu_torch.models.detector_net import anchor_centers

    dp.detect_post(raw, torch.as_tensor(anchor_centers(128)), 0.3, 2)
    assert (ws.launches.count, dp.launches.count) == before


def _meta_maps(n=2, shape=(2, 3)):
    return torch.zeros((n, *shape), device="meta")


@pytest.mark.parametrize(
    "call, error",
    [
        (lambda: ws.affine_warp(_meta_frames(torch.float64), _meta_maps(), 16, 16), TypeError),
        (lambda: ws.affine_warp(_meta_frames(), _meta_maps(shape=(3, 3)), 16, 16), ValueError),
        (lambda: ws.affine_warp(_meta_frames(), _meta_maps(3), 16, 16), ValueError),
        (lambda: ws.affine_warp(_meta_frames(), torch.zeros(2, 2, 3), 16, 16), ValueError),  # mixed devices
        (lambda: ws.affine_warp(_meta_frames(), _meta_maps(), 16, 16, fast="int8"), NotImplementedError),
        (lambda: ws._launch(_meta_frames(), 16, 16, False, torch.zeros(2, 1, 5, 2, device="meta"),
                            matrices=_meta_maps()), ValueError),  # maps and landmarks together
    ],
)
def test_affine_warp_checks_before_launch(call, error):
    before = ws.launches.count
    with pytest.raises(error):
        call()
    assert ws.launches.count == before


def test_affine_warp_off_cpu_never_takes_the_plain_path(tmp_path, monkeypatch):
    """The training augmentation's warp on a tensor that is not on the CPU
    goes to the kernel (here its build, which fails without nvcc), never to
    the plain two-pass warp."""
    from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(warp_mxu, "affine_warp_mxu_batch", lambda *a, **k: pytest.fail("fell back"))
    before = ws.launches.count
    for call in (
        lambda: ws.affine_warp(_meta_frames(), _meta_maps(), 16, 16),
        lambda: ws.affine_slot_parameters(_meta_frames(), _meta_maps(), 16),
        lambda: apply_augment(_meta_frames(), augment_draws(None, 2, 32, "heavy", device="meta"), "heavy"),
    ):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert ws.launches.count == before

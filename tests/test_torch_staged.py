"""The staged API of the port against the JAX package: ``Gallery``
persistence and mutation, the engine's ``recognize`` / ``recognize_batch``
/ ``recognize_all`` / ``add_to_db`` / ``match``, and the exact gather warp
the staged path aligns with.

Both engines get the shipped detector and ArcFace assets and the same
rendered scenes (as tests/test_torch_engine.py builds them). Bounds:
identities and top-k names equal; confidences within 1e-3 for ``dense``
(the port solves Umeyama in closed form where JAX takes an SVD, which moves
the warp by about 1e-5 px, and the convolutions sum in another order) and
2e-3 for ``int8`` (an embedding that moves by 1e-4 can flip a query code,
which moves a score by up to 2e-4, besides the dense difference). The
gather warp: 1e-4 levels given the same matrix, 0.01 after the closed-form
Umeyama, 0.01 for the margin crop.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.inference.engine import Gallery as JGallery
from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
from facerecognition_tpu.inference.extract_embeddings import load_arcface_model as j_load_arcface
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training.synthetic_faces import scene_batch
from facerecognition_tpu_torch.inference import engine as peng
from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
from facerecognition_tpu_torch.inference.extract_embeddings import (
    batch_bucket,
    default_arcface_checkpoint,
    load_arcface_model,
)
from facerecognition_tpu_torch.ops import image as timage
from facerecognition_tpu_torch.ops import matcher as tm
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
from facerecognition_tpu_torch.utils.imageio import load_image, save_png, to_uint8

# ``facerecognition_tpu.ops`` re-exports functions named like its modules.
jimage = importlib.import_module("facerecognition_tpu.ops.image")
jmatcher = importlib.import_module("facerecognition_tpu.ops.matcher")
jimageio = importlib.import_module("facerecognition_tpu.utils.imageio")

DIM = 16


def T(a):
    return torch.from_numpy(np.array(a))  # writable copy


def _rows(rng, n, dim=DIM):
    return rng.normal(size=(n, dim)).astype(np.float32)


def _same_gallery(p, j):
    assert p.names == j.names
    np.testing.assert_array_equal(p._matrix, j._matrix)


# -- Gallery -------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["native", "npy"])
def test_gallery_save_load_crosses_with_jax(rng, tmp_path, fmt):
    names = [f"p{i}" for i in range(70)]  # past the first capacity of 64
    rows = _rows(rng, 70)
    p, j = Gallery(DIM, device="cpu"), JGallery(DIM)
    p.add_many(names, rows)
    j.add_many(names, rows)
    _same_gallery(p, j)
    # the .npy dict is re-normalized on load, on both sides alike
    for writer in (p, j):
        path = str(tmp_path / writer.__class__.__module__.split(".")[0] / (
            "db.npy" if fmt == "npy" else "db"))
        writer.save(path)
        loaded = Gallery.load(path, device="cpu")
        _same_gallery(loaded, JGallery.load(path))
        if fmt == "native":
            _same_gallery(loaded, j)
    assert loaded.device == torch.device("cpu") and loaded.dim == DIM
    if fmt == "npy":  # the suffix may be left out
        _same_gallery(Gallery.load(path[:-4], device="cpu"), JGallery.load(path))
    else:
        assert sorted(os.listdir(path)) == ["embeddings.npy", "names.json"]
    d = p.to_dict()
    assert list(d) == names and all(np.array_equal(d[n], j.to_dict()[n]) for n in names)
    _same_gallery(Gallery.from_dict(d, device="cpu"), JGallery.from_dict(d))


def test_gallery_load_refuses_a_corrupt_directory(rng, tmp_path):
    p = Gallery(DIM, device="cpu")
    p.add_many(["a", "b"], _rows(rng, 2))
    p.save(str(tmp_path))
    (tmp_path / "names.json").write_text('["a"]')
    with pytest.raises(ValueError, match="corrupt"):
        Gallery.load(str(tmp_path), device="cpu")


def test_gallery_mmap_then_mutate(rng, tmp_path):
    names = [f"p{i}" for i in range(10)]
    rows = _rows(rng, 10)
    src = JGallery(DIM)
    src.add_many(names, rows)
    src.save(str(tmp_path))
    on_disk = np.load(tmp_path / "embeddings.npy").copy()
    p = Gallery.load(str(tmp_path), mmap=True, device="cpu")
    j = JGallery.load(str(tmp_path), mmap=True)
    assert isinstance(p._store, np.memmap)
    np.testing.assert_array_equal(p.matrix.numpy(), j._matrix)  # reads straight from the map
    extra = _rows(rng, 3)
    for g in (p, j):
        g.add("new", extra[0])
        g.add("p3", extra[1])
        g.add_many(["p5", "x"], extra[1:])
        g.remove("p0")
    assert not isinstance(p._store, np.memmap)
    _same_gallery(p, j)
    np.testing.assert_array_equal(np.load(tmp_path / "embeddings.npy"), on_disk)  # file untouched
    p2 = Gallery.load(str(tmp_path), mmap=True, device="cpu")
    assert p2.remove("p9") and not isinstance(p2._store, np.memmap)


def test_gallery_remove_is_jax_swap_remove(rng):
    names = [f"p{i}" for i in range(8)]
    rows = _rows(rng, 8)
    p, j = Gallery(DIM, device="cpu"), JGallery(DIM)
    for g in (p, j):
        g.add_many(names, rows)
    for name in ("p2", "p7", "zzz", "p0", "p6"):
        assert p.remove(name) == j.remove(name)
        _same_gallery(p, j)
        assert p._index == j._index
    assert len(p) == 4 and p.remove("p2") is False


def _device_q(j):
    codes, scales, n = j.quantized_store()
    return np.asarray(codes), np.asarray(scales), n


def test_quantized_store_dirty_sync_matches_jax(rng):
    """Each padded copy keeps its own dirty rows: the int8 store syncs only
    rows changed since it was shipped, and equals a fresh quantization and
    the JAX store after every step."""
    p, j = Gallery(DIM, device="cpu"), JGallery(DIM)
    names = [f"p{i}" for i in range(40)]
    rows = _rows(rng, 40)
    for g in (p, j):
        g.add_many(names, rows)

    def same():
        codes, scales, n = p.quantized_store()
        jc, js, jn = _device_q(j)
        assert n == jn == len(p)
        np.testing.assert_array_equal(codes.numpy(), jc)
        np.testing.assert_array_equal(scales.numpy(), js)
        fresh_c, fresh_s = tm.quantize_embeddings_int8_np(p._store)
        np.testing.assert_array_equal(codes.numpy(), fresh_c)
        np.testing.assert_array_equal(scales.numpy(), fresh_s)
        q, s = p.quantized()
        np.testing.assert_array_equal(q.numpy(), fresh_c[: len(p)])
        np.testing.assert_array_equal(s.numpy(), fresh_s[: len(p)])
        assert not p._dirty_q

    same()
    shipped = p._device_qstore[0]
    new = _rows(rng, 3)
    for g in (p, j):
        g.add("p4", new[0])  # in place: one dirty row
        g.remove("p9")  # swap-remove: row 9 takes row 39
    assert p._dirty_q == {4, 9} and p._dirty_q == j._dirty_q
    p.device_store()  # syncing the float32 copy leaves the int8 set alone
    assert p._dirty_q == {4, 9} and not p._dirty_f32
    same()
    assert p._device_qstore[0] is shipped  # synced in place, not reshipped
    for g in (p, j):
        g.add_many([f"n{i}" for i in range(30)], _rows(np.random.default_rng(1), 30))
    assert p._device_qstore is None  # capacity grew past 64: reship
    same()


def test_device_store_syncs_rows_after_remove(rng):
    p = Gallery(DIM, device="cpu")
    p.add_many([f"p{i}" for i in range(10)], _rows(rng, 10))
    store, n = p.device_store()
    p.remove("p1")
    store2, n2 = p.device_store()
    assert store2 is store and n2 == 9
    np.testing.assert_array_equal(store2.numpy(), p._store)


# -- the gather warp ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def smooth_image():
    rng = np.random.default_rng(3)
    img = np.repeat(np.repeat(rng.integers(0, 256, (20, 19, 3)), 8, 0), 8, 1)
    return img[:160, :150].astype(np.float32)


def test_affine_warp_matches_jax(smooth_image):
    m = np.array([[0.9, 0.2, -10.3], [-0.21, 0.88, 5.7]], np.float32)
    ref = np.asarray(jimage.affine_warp(jnp.asarray(smooth_image), jnp.asarray(m), 112, 100))
    got = timage.affine_warp(T(smooth_image), T(m), 112, 100).numpy()
    assert got.shape == ref.shape == (112, 100, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_align_crop_matches_jax(smooth_image):
    lm = np.array([[50, 60], [95, 58], [72, 85], [55, 110], [92, 108]], np.float32)
    for size in (112, 160):
        ref = np.asarray(jimage.align_crop(jnp.asarray(smooth_image), jnp.asarray(lm), size))
        got = timage.align_crop(T(smooth_image), T(lm), size).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.01)


@pytest.mark.parametrize("bbox", [[30.5, 40.2, 120.7, 140.1], [3.3, -4.2, 99.9, 77.7]])
def test_crop_with_margin_matches_jax(smooth_image, bbox):
    bb = np.array(bbox, np.float32)
    ref = np.asarray(jimage.crop_with_margin(jnp.asarray(smooth_image), jnp.asarray(bb), 0.2, 112))
    got = timage.crop_with_margin(T(smooth_image), T(bb), 0.2, 112).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.01)


def test_gather_bilinear_edge_and_gray(smooth_image):
    ys, xs = np.meshgrid(np.linspace(-3, 163, 40), np.linspace(-2, 152, 30), indexing="ij")
    ys, xs = ys.astype(np.float32), xs.astype(np.float32)
    for mode in ("constant", "edge"):
        ref = np.asarray(jimage._gather_bilinear(
            jnp.asarray(smooth_image), jnp.asarray(xs), jnp.asarray(ys), mode))
        got = timage._gather_bilinear(T(smooth_image), T(xs), T(ys), mode).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        timage.rgb_to_grayscale(T(smooth_image)).numpy(),
        np.asarray(jimage.rgb_to_grayscale(jnp.asarray(smooth_image))), rtol=0, atol=1e-4)


def test_load_image_matches_jax(rng, tmp_path):
    class PILLike:
        def __init__(self, arr):
            self.arr = arr

        def convert(self, mode):
            assert mode == "RGB"
            return self.arr

    arrays = [
        rng.integers(0, 256, (9, 7, 3)).astype(np.uint8),
        rng.random((9, 7)).astype(np.float32),
        rng.uniform(-20, 300, (9, 7, 4)),
    ]
    for a in arrays:
        np.testing.assert_array_equal(load_image(a), jimageio.load_image(a))
        np.testing.assert_array_equal(to_uint8(a), jimageio.to_uint8(a))
    np.testing.assert_array_equal(load_image(PILLike(arrays[0])), arrays[0])
    with pytest.raises(FileNotFoundError):
        load_image("face.jpg")
    with pytest.raises(FileNotFoundError):
        jimageio.load_image("face.jpg")
    path = save_png(tmp_path / "face.png", arrays[0])  # a real file now decodes
    np.testing.assert_array_equal(load_image(path), jimageio.load_image(path))
    np.testing.assert_array_equal(load_image(str(path)), arrays[0])
    with pytest.raises(TypeError):
        load_image(3)


def test_numpy_helpers_match_jax(rng):
    a, b = rng.normal(size=(7, 12)).astype(np.float32), rng.normal(size=(5, 12)).astype(np.float32)
    assert tm.cosine_similarity(a[0], b[0]) == pytest.approx(jmatcher.cosine_similarity(a[0], b[0]), abs=1e-7)
    assert tm.cosine_similarity(np.zeros(3), a[0, :3]) == 0.0
    np.testing.assert_allclose(
        tm.pairwise_sq_dists(T(a), T(b)).numpy(),
        np.asarray(jmatcher.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-5)
    labels = np.array([0, 2, 2, 0, 1, 2, 0], np.int32)
    np.testing.assert_allclose(
        tm.compute_prototypes(T(a), T(labels), 4).numpy(),
        np.asarray(jmatcher.compute_prototypes(jnp.asarray(a), jnp.asarray(labels), 4)),
        rtol=0, atol=1e-6)


def test_batch_bucket():
    assert [batch_bucket(n) for n in (1, 2, 8, 9, 128, 129, 513, 1100)] == [
        1, 8, 8, 32, 128, 512, 1024, 1536]


# -- the staged engine ------------------------------------------------------------------------

N_GALLERY = 30


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(12)
    one = scene_batch(rng, 6, 160)[0].astype(np.uint8)
    crowd = scene_batch(rng, 2, 200, max_faces=4)[0].astype(np.uint8)
    rows = rng.normal(size=(N_GALLERY, 512)).astype(np.float32)
    return one, crowd, rows, [f"id{i:02d}" for i in range(N_GALLERY)]


def _engines(scenes, match_kernel):
    _, _, rows, names = scenes
    j = JEngine(
        embedder=j_load_arcface(default_arcface_checkpoint()),
        detector=JDetector(confidence_threshold=0.0, min_face_size=0),
        match_kernel=match_kernel,
    )
    p = RecognitionEngine(
        embedder=load_arcface_model(default_arcface_checkpoint(), device="cpu"),
        detector=FaceDetector(confidence_threshold=0.0, min_face_size=0, device="cpu"),
        match_kernel=match_kernel,
        device="cpu",
    )
    for e in (j, p):
        e.gallery.add_many(names, rows)
    return j, p


@pytest.fixture(scope="module", params=["dense", "int8"])
def engines(request, scenes):
    j, p = _engines(scenes, request.param)
    one = scenes[0]
    # enroll the first three scenes' faces on both sides, two images each
    for e in (j, p):
        for i in range(3):
            assert e.add_to_db(f"person{i}", [one[i], one[i][:, ::-1].copy()])
        assert not e.add_to_db("nobody", ["missing.jpg"])
    return request.param, j, p


def _tol(kind):
    return 1e-3 if kind == "dense" else 2e-3


def _same_match(got, ref, tol):
    name, score, top = got
    rname, rscore, rtop = ref
    assert name == rname
    assert abs(score - rscore) < tol
    assert [n for n, _ in top] == [n for n, _ in rtop]
    np.testing.assert_allclose([s for _, s in top], [s for _, s in rtop], rtol=0, atol=tol)


def test_add_to_db_enrolls_as_jax(engines):
    kind, j, p = engines
    assert p.get_db_identities() == j.gallery.names
    for i in range(3):
        row = p.gallery._index[f"person{i}"]
        cos = float(p.gallery._store[row] @ j.gallery._store[row])
        assert cos > 0.999
        assert abs(np.linalg.norm(p.gallery._store[row]) - 1.0) < 1e-5


def test_recognize_matches_jax(engines, scenes):
    kind, j, p = engines
    one = scenes[0]
    for img in one:
        ref, got = j.recognize(img, k=5), p.recognize(img, k=5)
        assert got["status"] == ref["status"] == "success"
        assert got["face_found"] == ref["face_found"]
        _same_match((got["identity"], got["confidence"], got["top_k"]),
                    (ref["identity"], ref["confidence"], ref["top_k"]), _tol(kind))
        assert float(got["embedding"] @ ref["embedding"]) > 0.999
    assert p.recognize(one[0])["identity"] == "person0"


def test_recognize_batch_matches_jax(engines, scenes):
    kind, j, p = engines
    one = scenes[0]
    inputs = [one[4], "missing.jpg", one[0], one[5]]
    ref, got = j.recognize_batch(inputs, k=3), p.recognize_batch(inputs, k=3)
    assert [g["status"] for g in got] == [r["status"] for r in ref] == [
        "success", "error", "success", "success"]
    assert got[1]["message"] == ref[1]["message"]
    for g, r in zip(got, ref):
        if r["status"] == "success":
            _same_match((g["identity"], g["confidence"], g["top_k"]),
                        (r["identity"], r["confidence"], r["top_k"]), _tol(kind))
    single = p.recognize(one[0], k=3)
    assert got[2]["identity"] == single["identity"] == "person0"


def test_recognize_all_matches_jax(engines, scenes):
    kind, j, p = engines
    for frame in scenes[1]:
        ref, got = j.recognize_all(frame, k=3, max_faces=6), p.recognize_all(frame, k=3, max_faces=6)
        assert got["status"] == ref["status"] == "success"
        assert len(got["faces"]) == len(ref["faces"]) == 6
        for g, r in zip(got["faces"], ref["faces"]):
            _same_match((g["identity"], g["confidence"], g["top_k"]),
                        (r["identity"], r["confidence"], r["top_k"]), _tol(kind))
            np.testing.assert_allclose(g["bbox"], r["bbox"], atol=0.01)
            assert abs(g["det_score"] - r["det_score"]) < 1e-4
            assert float(g["embedding"] @ r["embedding"]) > 0.999
    bad, jbad = p.recognize_all("missing.jpg"), j.recognize_all("missing.jpg")
    assert bad["status"] == "error" and bad["message"] == jbad["message"] == "invalid image"


def test_match_matches_jax(engines, rng):
    kind, j, p = engines
    q = rng.normal(size=(9, 512)).astype(np.float32)
    q[3] = p.gallery._store[p.gallery._index["id07"]] * 2.0
    for k in (1, 5):
        ref, got = j.match(q, k), p.match(q, k)
        for g, r in zip(got, ref):
            _same_match(g, r, 5e-4)  # the same rows: only int8 code flips differ
    assert got[3][0] == "id07"


def test_match_thresholds_and_empty_gallery(scenes):
    _, p = _engines(scenes, "int8")
    p.set_threshold(1.5)
    assert p.threshold == 1.5 and all(m[0] == "Unknown" for m in p.match(scenes[2][:3], 2))
    empty = RecognitionEngine(embedder=p.embedder, detector=p.detector, device="cpu")
    assert empty.match(scenes[2][:2]) == [("No database", 0.0, [])] * 2
    res = empty.recognize(scenes[0][0])
    assert res["status"] == "error" and res["message"] == "No database loaded"
    res = empty.recognize("missing.jpg")
    assert res["status"] == "error"
    assert res["message"] == "Cannot extract embedding (no face or invalid image)"


def test_whole_image_embedding_without_detector(scenes):
    j, p = _engines(scenes, "dense")
    j.detector = p.detector = None
    crop = scenes[0][1][20:132, 20:132]
    ref, got = j.recognize(crop), p.recognize(crop)
    assert got["face_found"] and ref["face_found"]
    _same_match((got["identity"], got["confidence"], got["top_k"]),
                (ref["identity"], ref["confidence"], ref["top_k"]), 1e-3)
    ref_b, got_b = j.recognize_batch([scenes[0][2]]), p.recognize_batch([scenes[0][2]])
    assert float(got_b[0]["embedding"] @ ref_b[0]["embedding"]) > 0.999


def test_engine_from_embeddings_dir(scenes, tmp_path):
    _, _, rows, names = scenes
    g = Gallery(512, device="cpu")
    g.add_many(names, rows)
    g.save(str(tmp_path / "face_db.npy"))
    (tmp_path / "broken.npy").write_bytes(b"not a gallery")
    e = peng.create_engine_from_embeddings_dir(
        default_arcface_checkpoint(), str(tmp_path), threshold=0.3, detector=None, device="cpu")
    assert e.get_db_identities() == names and e.threshold == 0.3 and e.detector is None
    e.save_db(str(tmp_path / "again"))
    assert Gallery.load(str(tmp_path / "again"), device="cpu").names == names

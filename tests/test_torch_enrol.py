"""The port's enrolment path against the JAX package on the CPU.

Folders of image files (the committed fixtures under
``facerecognition_tpu_torch/fixtures/faces`` and files written here) go
through the dataset indexes, the LBPH trainer and threshold search, the
gallery builder (``build_db``, CSV extraction, ``full_pipeline``), the
``DatabaseBuilder`` jobs, and the engine loaded from the built gallery, in
both packages. Bounds: dataset indexes, LBPH histograms, labels, label maps,
sweep rows and thresholds equal (the port's gray conversion is XLA's, bit
for bit); gallery rows cosine above 0.9999; engine identities equal and
confidences within 1e-3.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from facerecognition_tpu.data import datasets as jds
from facerecognition_tpu.inference import extract_embeddings as jee
from facerecognition_tpu.inference.engine import create_engine_from_embeddings_dir as j_create
from facerecognition_tpu.models import lbph_tools as jtools
from facerecognition_tpu.preprocessing.face_detector import FaceDetector as JDetector
from facerecognition_tpu.training import train_lbph as jtrain
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.data import datasets as pds
from facerecognition_tpu_torch.data import native_decode
from facerecognition_tpu_torch.inference import database_builder as pdb
from facerecognition_tpu_torch.inference import extract_embeddings as pee
from facerecognition_tpu_torch.inference.engine import create_engine_from_embeddings_dir as p_create
from facerecognition_tpu_torch.models import lbph_tools as ptools
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
from facerecognition_tpu_torch.tools.lbph_data import lbph_faces
from facerecognition_tpu_torch.training import train_lbph as ptrain
from facerecognition_tpu_torch.utils.imageio import load_image, save_png

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "facerecognition_tpu_torch", "fixtures")


def _same_index(p, j):
    assert p.paths == j.paths
    np.testing.assert_array_equal(p.labels, j.labels)
    assert p.label_names == j.label_names


# -- fixtures and datasets ------------------------------------------------------------------


def test_fixture_files_decode_to_their_pil_digests():
    """Every committed fixture decodes, in the port, to the pixels whose
    digest make_torch_fixtures.py stored (PIL's), and the stored JPEG
    arrays are those pixels."""
    import hashlib

    with open(os.path.join(FIXTURES, "faces.json")) as f:
        meta = json.load(f)
    arrays = np.load(os.path.join(FIXTURES, "faces_jpeg_pixels.npz"))
    assert len(meta["files"]) == 64 and len(arrays.files) == 48
    for rel, info in meta["files"].items():
        img = load_image(os.path.join(FIXTURES, rel))
        assert list(img.shape) == info["shape"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == info["sha256"], rel
        if rel in arrays.files:
            np.testing.assert_array_equal(img, arrays[rel])
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURES) for n in ns)
    assert total < 5 * 2**20


def test_folder_dataset_equals_jax(tmp_path):
    root = tmp_path / "people"
    for person, n in (("p10", 3), ("p2", 1), ("p1", 2), ("x", 0)):
        (root / person).mkdir(parents=True)
        for i in range(n):
            (root / person / f"{i}.png").write_bytes(b"")
    (root / "p1" / "notes.txt").write_text("not an image")
    (root / "stray.png").write_bytes(b"")
    for min_images in (1, 2, 4):
        _same_index(pds.FolderDataset(str(root), min_images), jds.FolderDataset(str(root), min_images))
    got = pds.FolderDataset(root)
    assert got.label_names == ["p1", "p2", "p10"] and got.num_classes == 3 and len(got) == 6


@pytest.mark.parametrize("layout", ["named", "person", "headerless"])
def test_csv_dataset_equals_jax(tmp_path, layout):
    rows = [("a/1.jpg", "id10"), ("b/2.jpg", "id2"), ("a/3.jpg", "id10"), ("c/4.jpg", "7")]
    header = {"named": "image_path,label\n", "person": "file,person\n", "headerless": ""}[layout]
    path = tmp_path / "data.csv"
    path.write_text(header + "".join(f"{p},{l}\n" for p, l in rows))
    for root in (None, "/data"):
        _same_index(pds.CSVDataset(str(path), root), jds.CSVDataset(str(path), root))
    assert len(pds.CSVDataset(str(path))) == 4


def test_splits_and_overlap_equal_jax():
    index = pds.DatasetIndex([f"f{i}" for i in range(40)], np.arange(40) % 7,
                             [f"n{i}" for i in range(7)])
    jindex = jds.DatasetIndex(index.paths, index.labels, index.label_names)
    for split in ("split_by_image", "split_by_identity"):
        for seed in (0, 3):
            for got, want in zip(getattr(pds, split)(index, 0.3, seed),
                                 getattr(jds, split)(jindex, 0.3, seed)):
                _same_index(got, want)
    train, val = pds.split_by_identity(index, 0.3)
    assert pds.check_identity_overlap(train, val) == set()
    train, val = pds.split_by_image(index, 0.5)
    with pytest.raises(ValueError, match="leakage"):
        pds.check_identity_overlap(train, val)
    assert pds.check_identity_overlap(train, val, raise_on_overlap=False) == \
        jds.check_identity_overlap(train, val, raise_on_overlap=False)


# -- LBPH -------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lbph_dir(tmp_path_factory):
    """8 identities x 4 gray 100² PNG faces (the chip run's generator), an
    RGB JPEG and a 90² PNG in one folder, and an unreadable file."""
    root = tmp_path_factory.mktemp("lbph")
    faces = lbph_faces(torch.Generator().manual_seed(5), 8, 4, "cpu").to(torch.uint8).numpy()
    for i in range(8):
        d = root / "data" / f"person{i + 1}"
        d.mkdir(parents=True)
        for s in range(4):
            save_png(d / f"{s}.png", faces[i * 4 + s])
    rng = np.random.default_rng(2)
    rgb = np.repeat(faces[0][..., None], 3, -1).astype(np.int64) + rng.integers(-9, 10, (100, 100, 3))
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(
        root / "data" / "person1" / "9.jpg", quality=92)
    save_png(root / "data" / "person2" / "8.png", faces[5][:90, 5:95])
    (root / "data" / "person3" / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    val = root / "val"
    probes = lbph_faces(torch.Generator().manual_seed(5), 8, 6, "cpu").to(torch.uint8).numpy()
    for i in range(0, 8, 2):
        d = val / f"person{i + 1}"
        d.mkdir(parents=True)
        save_png(d / "probe.png", probes[i * 6 + 5])
    return root


def test_lbph_loaders_equal_jax(lbph_dir):
    data = str(lbph_dir / "data")
    got, want = ptrain.load_faces_and_labels(data), jtrain.load_faces_and_labels(data)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and len(got[0]) == 34
    for cap in (2, 30):
        got, want = ptools.load_faces_capped(data, 100, cap), jtools.load_faces_capped(data, 100, cap)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]


@pytest.mark.parametrize("with_val", [False, True])
def test_train_lbph_from_directory_equals_jax(lbph_dir, tmp_path, with_val):
    data = str(lbph_dir / "data")
    val = str(lbph_dir / "val") if with_val else None
    out = {}
    for name, mod, kw in (("jax", jtrain, {}), ("port", ptrain, {"device": "cpu"})):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text("model_type: lbph\n")
        res = mod.train_lbph_from_directory(data, str(tmp_path / name), val_dir=val,
                                            config_path=str(cfg), **kw)
        out[name] = (res, np.load(res["model_path"]), cfg.read_text(),
                     np.load(res["label_map_path"], allow_pickle=True).item())
    (pres, pmodel, pcfg, pmap), (jres, jmodel, jcfg, jmap) = out["port"], out["jax"]
    for key in ("histograms", "labels", "radius", "neighbors", "grid_x", "grid_y", "threshold"):
        np.testing.assert_array_equal(pmodel[key], jmodel[key], err_msg=key)
    assert pmap == jmap
    assert pres["sweep"] == jres["sweep"] and pres["best"] == jres["best"]
    assert pres["optimal_threshold"] == jres["optimal_threshold"]
    assert pcfg == jcfg and "default_threshold" in pcfg
    with open(os.path.join(str(tmp_path / "port"), "optimal_threshold.txt")) as f:
        assert float(f.read()) == pres["optimal_threshold"]
    assert {k: pres[k] for k in ("n_images", "n_identities")} == {
        k: jres[k] for k in ("n_images", "n_identities")}


def test_evaluate_lbph_shares_the_gallery(lbph_dir):
    """``evaluate_lbph`` and the sweep predict with the model's own gallery
    and stats (not copied, not recomputed), at the thresholds given,
    whatever the model's own threshold, which is restored after."""
    from facerecognition_tpu.models.lbph import LBPHModel as JLBPH
    from facerecognition_tpu_torch.models.lbph import LBPHModel

    images, labels, _ = ptrain.load_faces_and_labels(str(lbph_dir / "data"))
    p = LBPHModel(threshold=1.0, device="cpu")
    j = JLBPH(threshold=1.0)
    p.train(images, labels)
    j.train(images, labels)
    gallery, stats = p._gallery, p._stats
    probes = images[::3] + np.float32(3.0)
    for thr in (20.0, 60.0, 400.0):
        got, want = ptrain.evaluate_lbph(p, probes, labels[::3], thr), \
            jtrain.evaluate_lbph(j, probes, labels[::3], thr)
        for key in ("accuracy", "coverage", "n_covered", "n_total"):
            assert got[key] == want[key], key
        np.testing.assert_array_equal(got["predictions"], want["predictions"])
        np.testing.assert_allclose(got["confidences"], want["confidences"], rtol=1e-5)
    thr, best, rows = ptrain.find_optimal_threshold(p, probes, labels[::3], thresholds=(5, 50, 500))
    assert [r["threshold"] for r in rows] == [5.0, 50.0, 500.0] and thr == best["threshold"]
    assert p.threshold == 1.0 and p._gallery is gallery and p._stats is stats


# -- the gallery builder ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_embedders():
    """The JAX tests' SmallEmbedder (a random ResNet50 ArcFace) and the
    same weights in the port, carried over with convert.py."""
    from tests.test_engine import SmallEmbedder

    j = SmallEmbedder()
    model = ArcFaceModel(512, (3, 4, 6, 3))
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, j.variables))
    p = pee.Embedder(pee.EmbedderConfig("arcface", 512, 112, (3, 4, 6, 3)), model, device="cpu")
    return j, p


@pytest.fixture(scope="module")
def people(tmp_path_factory):
    """Three people of the committed fixtures (JPEG baseline, progressive,
    gray and PNG each) plus an unreadable file and a person with none."""
    root = tmp_path_factory.mktemp("people")
    for person in ("id1", "id10", "id2"):
        shutil.copytree(os.path.join(FIXTURES, "faces", person), root / person)
    (root / "id2" / "9_broken.jpg").write_bytes(b"\xff\xd8\xff broken")
    (root / "empty").mkdir()
    return root


def _cos(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_build_db_equals_jax(small_embedders, people, tmp_path):
    j, p = small_embedders
    calls = []
    got = pee.build_db(str(people), p, output_path=str(tmp_path / "p" / "face_db.npy"),
                       progress=lambda i, n, who: calls.append((i, n, who)))
    want = jee.build_db(str(people), j, output_path=str(tmp_path / "j" / "face_db.npy"))
    assert list(got) == list(want) == ["id1", "id10", "id2"]
    assert calls == [(2, 4, "id1"), (3, 4, "id10"), (4, 4, "id2")]  # "empty" sorts first
    saved = np.load(tmp_path / "p" / "face_db.npy", allow_pickle=True).item()
    for name in want:
        assert _cos(got[name], want[name]) > 0.9999
        np.testing.assert_array_equal(saved[name], got[name])
        assert abs(np.linalg.norm(got[name]) - 1.0) < 1e-5


def test_csv_extraction_and_full_pipeline_equal_jax(small_embedders, people, tmp_path):
    """Eight images (JAX pads them to one batch bucket; under ten, so no
    t-SNE plot on either side)."""
    j, p = small_embedders
    csv = tmp_path / "set.csv"
    files = sorted(os.path.relpath(os.path.join(d, f), people)
                   for d, _, fs in os.walk(people) for f in fs if "id2" not in d)
    csv.write_text("image_path,identity\n" + "".join(f"{f},{f.split('/')[0]}\n" for f in files))
    embs, labels, names = pee.extract_embeddings_from_csv(str(csv), p, str(people))
    res = pee.full_pipeline(str(csv), p, str(tmp_path / "full"), str(people))
    jres = jee.full_pipeline(str(csv), j, str(tmp_path / "jfull"), str(people))
    assert len(embs) == res["n_embeddings"] == jres["n_embeddings"] == 8
    assert names == ["id1", "id10"] and res["n_classes"] == jres["n_classes"] == 2
    assert res["tsne_path"] is None and jres["tsne_path"] is None
    want = np.load(jres["embeddings_path"])
    np.testing.assert_array_equal(np.load(res["embeddings_path"]), embs)
    np.testing.assert_array_equal(labels, np.load(jres["embeddings_path"].replace("embeddings", "labels")))
    assert min(_cos(a, b) for a, b in zip(embs, want)) > 0.9999
    protos, jprotos = np.load(res["prototypes_path"]), np.load(jres["prototypes_path"])
    assert min(_cos(a, b) for a, b in zip(protos, jprotos)) > 0.9999
    _, top = pee.SearchIndex.load(res["index_path"], device="cpu").search(embs, k=2)
    _, jtop = jee.SearchIndex.load(jres["index_path"]).search(want, k=2)
    np.testing.assert_array_equal(top, jtop)


def test_visualize_tsne_writes_a_plot(tmp_path):
    from threadpoolctl import threadpool_limits

    rng = np.random.default_rng(6)
    with threadpool_limits(1):  # t-SNE's OpenMP threads crawl when test workers share the cores
        path = pee.visualize_tsne(rng.normal(size=(24, 8)).astype(np.float32), np.arange(24) % 5,
                                  str(tmp_path / "plots" / "tsne.png"), max_classes=3)
    assert os.path.getsize(path) > 0


def test_cli_db_mode(small_embedders, people, tmp_path, monkeypatch):
    """``--mode db`` writes face_db.npy (the loader is the shipped
    checkpoint's; here the small embedder is injected)."""
    data = tmp_path / "data"
    shutil.copytree(people / "id1", data / "id1")
    monkeypatch.setattr(pee, "load_arcface_model", lambda *a, **k: small_embedders[1])
    pee.main(["--mode", "db", "--data-dir", str(data), "--output", str(tmp_path), "--device", "cpu"])
    assert sorted(np.load(tmp_path / "face_db.npy", allow_pickle=True).item()) == ["id1"]
    with pytest.raises(SystemExit):
        pee.main(["--mode", "csv"])


# -- DatabaseBuilder: the contracts of the JAX builder's tests --------------------------------


def _make_dataset(tmp_path, rng, n_people=2, n_imgs=2, size=64):
    root = tmp_path / "data"
    for p in range(n_people):
        d = root / f"person{p}"
        d.mkdir(parents=True)
        for i in range(n_imgs):
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return str(root)


class TestDatabaseBuilder:
    def test_job_lifecycle_lbph(self, tmp_path, rng):
        data = _make_dataset(tmp_path, rng)
        builder = pdb.DatabaseBuilder(str(tmp_path / "out"), device="cpu")
        job = builder.create_job("lbph", data)
        assert job.status == "pending"
        builder.start_build(job).join(timeout=120)
        assert job.status == "completed", job.error
        assert job.progress == 1.0
        assert len(job.output_files) == 2 and all(os.path.exists(f) for f in job.output_files)
        d = job.to_dict()
        assert d["progress"] == 100.0 and d["elapsed_seconds"] >= 0
        assert builder.list_jobs() == [job.to_dict()] and builder.get_job(job.job_id) is job

    def test_job_failure_captured(self, tmp_path):
        builder = pdb.DatabaseBuilder(str(tmp_path / "out"), device="cpu")
        job = builder.create_job("lbph", "/nonexistent/dir")
        builder.start_build(job).join(timeout=60)
        assert job.status == "failed" and job.error
        assert "Traceback" in job.logs[-1]

    def test_unknown_model_type(self, tmp_path):
        builder = pdb.DatabaseBuilder(str(tmp_path))
        with pytest.raises(ValueError):
            builder.create_job("resnet", ".")

    def test_arcface_build_with_injected_embedder(self, tmp_path, rng, small_embedders):
        data = _make_dataset(tmp_path, rng, size=112)
        out = {}
        from facerecognition_tpu.inference.database_builder import DatabaseBuilder as JBuilder

        for name, builder, emb in (("port", pdb.DatabaseBuilder(str(tmp_path / "p"), "cpu"),
                                    small_embedders[1]),
                                   ("jax", JBuilder(str(tmp_path / "j")), small_embedders[0])):
            job = builder.create_job("arcface", data)
            builder.start_build(job, embedder=emb).join(timeout=300)
            assert job.status == "completed", job.error
            out[name] = np.load(job.output_files[0], allow_pickle=True).item()
        assert set(out["port"]) == set(out["jax"]) == {"person0", "person1"}
        for k in out["jax"]:
            assert _cos(out["port"][k], out["jax"][k]) > 0.9999

    def test_singleton(self):
        assert pdb.get_builder() is pdb.get_builder()


# -- the engine on the built gallery ----------------------------------------------------------


@pytest.fixture(scope="module")
def built_engines(people, tmp_path_factory):
    """ArcFace galleries built by each package's builder over the fixture
    people with the shipped detector and embedder, and the engines loaded
    from them."""
    from facerecognition_tpu.inference.database_builder import DatabaseBuilder as JBuilder

    out = tmp_path_factory.mktemp("built")
    jdet = JDetector()
    pdet = FaceDetector(device="cpu")
    pemb = pee.load_arcface_model(pee.default_arcface_checkpoint(), device="cpu")
    jemb = jee.load_arcface_model(jee.default_arcface_checkpoint())
    for builder, emb, det in ((pdb.DatabaseBuilder(str(out / "port"), "cpu"), pemb, pdet),
                              (JBuilder(str(out / "jax")), jemb, jdet)):
        job = builder.create_job("arcface", str(people))
        builder.start_build(job, embedder=emb, detector=det).join(timeout=600)
        assert job.status == "completed", job.error
    p = p_create(pee.default_arcface_checkpoint(), str(out / "port" / "arcface"), detector=pdet,
                 device="cpu", match_kernel="dense")
    j = j_create(jee.default_arcface_checkpoint(), str(out / "jax" / "arcface"), detector=jdet)
    return p, j


def test_engine_from_built_gallery_recognizes_paths(built_engines, people):
    p, j = built_engines
    assert p.gallery.names == j.gallery.names
    for a, b in zip(p.gallery._matrix, j.gallery._matrix):
        assert _cos(a, b) > 0.9999
    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(people) for f in fs)
    for path in paths:
        got, ref = p.recognize(path), j.recognize(path)
        assert got["status"] == ref["status"], path
        assert got.get("message") is None or got["status"] == "error" or not got["face_found"]
        if ref["status"] != "success":
            assert got["message"] == ref["message"]
            continue
        assert got["identity"] == ref["identity"] and got["face_found"] == ref["face_found"], path
        assert abs(got["confidence"] - ref["confidence"]) < 1e-3
    got, ref = p.recognize_batch(paths), j.recognize_batch(paths)
    assert [g["identity"] for g in got] == [r["identity"] for r in ref]
    assert [g["status"] for g in got] == [r["status"] for r in ref]
    one = p.recognize_all(paths[0], max_faces=4)
    assert one["status"] == "success" and one["faces"]
    assert p.add_to_db("again", paths[:2]) and j.add_to_db("again", paths[:2])
    assert _cos(p.gallery._matrix[-1], j.gallery._matrix[-1]) > 0.9999
    assert not p.add_to_db("nobody", ["missing.jpg", paths[-1]])  # the broken file


def test_detect_batch_and_compare_detectors(people):
    det = FaceDetector(device="cpu")
    jdet = JDetector()
    paths = [str(people / "id1" / "0_baseline.jpg"), "missing.jpg",
             str(people / "id2" / "3_rgb.png")]
    got, want = det.detect_batch(paths), jdet.detect_batch(paths)
    assert list(got.columns) == list(want.columns)
    assert got["detected"].tolist() == want["detected"].tolist() == [True, False, True]
    np.testing.assert_allclose(got[["x1", "y1", "x2", "y2"]].to_numpy(np.float64)[[0, 2]],
                               want[["x1", "y1", "x2", "y2"]].to_numpy(np.float64)[[0, 2]], atol=0.01)
    res = __import__("facerecognition_tpu_torch.preprocessing.face_detector",
                     fromlist=["compare_detectors"]).compare_detectors(paths[0], [det], n_runs=2)
    assert res[0]["backend"] == "blazeface@128" and res[0]["detected"] and res[0]["latency_ms"] > 0


def test_detect_batch_without_pandas(people, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pandas(name, *args, **kw):
        if name == "pandas":
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    rows = FaceDetector(device="cpu").detect_batch([str(people / "id1" / "3_rgb.png"), "missing.png"])
    assert isinstance(rows, list) and [r["detected"] for r in rows] == [True, False]
    assert set(rows[0]) >= {"image_path", "confidence", "x1", "y1", "x2", "y2", "width", "height"}


def test_decoder_reports_its_jpeg_backend():
    assert native_decode.jpeg_backend() in ("libjpeg", "nvjpeg")

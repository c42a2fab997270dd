"""The port's web app (``facerecognition_tpu_torch.apps.web_app``) on the CPU.

The JAX app's contracts (tests/test_apps.py) rewritten against the port's
``create_app``: pages, escaping, the 400 / 404 / 413 / 429 / 503 answers,
static traversal, template tokens, the builder routes and the download
guard, ``/recognize`` raw, multipart and multi-image, ``/stats``, ``/video``,
``draw_faces``, the Streamlit demo driven by a fake module; then the same
requests sent to the JAX app and to the port's app, each built on the same
weights (the JAX tests' ``SmallEmbedder`` carried over with convert.py, the
same LBPH training set): identities and JSON keys equal, ArcFace
confidences within 1e-3, LBPH distances within 1e-5 relative. A failing
kernel path is never answered from another path (``RuntimeError`` reaches
the caller, ``/recognize`` answers 500). Templates and static files are
the JAX app's, byte for byte.
"""

import io
import json
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
from PIL import Image

from facerecognition_tpu_torch.apps import web_app as pweb
from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.inference import extract_embeddings as pee
from facerecognition_tpu_torch.inference.database_builder import DatabaseBuilder
from facerecognition_tpu_torch.inference.engine import RecognitionEngine
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.utils.imageio import encode_png, load_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "facerecognition_tpu_torch", "fixtures")
CONF_TOL = 1e-3
LBPH_RTOL = 1e-5


# ---------------------------------------------------------------------------
# WSGI client
# ---------------------------------------------------------------------------


class Client:
    def __init__(self, app):
        self.app = app

    def request(self, method, path, body=b"", content_type=None, accept="application/json",
                query=""):
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path,
            "QUERY_STRING": query,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "HTTP_ACCEPT": accept,
        }
        if content_type:
            environ["CONTENT_TYPE"] = content_type
        captured = {}

        def start_response(status, headers):
            captured["status"] = status
            captured["headers"] = dict(headers)

        data = b"".join(self.app(environ, start_response))
        return captured["status"], captured["headers"], data

    def get_json(self, path):
        status, _, data = self.request("GET", path)
        return status, json.loads(data)

    def post_multipart(self, path, fields, accept="application/json", query=""):
        status, _, data = self.request("POST", path, *multipart(fields), accept=accept,
                                       query=query)
        try:
            return status, json.loads(data)
        except json.JSONDecodeError:
            return status, data


def multipart(fields, boundary="testboundary42"):
    parts = []
    for name, value in fields:
        if isinstance(value, tuple):
            filename, data = value
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                f'filename="{filename}"\r\nContent-Type: application/octet-stream\r\n\r\n'.encode()
                + data + b"\r\n"
            )
        else:
            parts.append(
                f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"\r\n\r\n'
                f"{value}\r\n".encode()
            )
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def png_bytes(rng, size=112):
    arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    return arr, encode_png(arr)


def fixture_file(person: str, kind: str = "3_rgb.png") -> bytes:
    with open(os.path.join(FIXTURES, "faces", person, kind), "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# The apps: the port's and the JAX package's, on the same weights
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's forwards: the test workers
    share the cores, and more threads each only oversubscribe them."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



@pytest.fixture(scope="module")
def small_embedders():
    """The JAX tests' SmallEmbedder and the same weights in the port."""
    from tests.test_engine import SmallEmbedder

    j = SmallEmbedder()
    model = ArcFaceModel(512, (3, 4, 6, 3))
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray, j.variables))
    p = pee.Embedder(pee.EmbedderConfig("arcface", 512, 112, (3, 4, 6, 3)), model, device="cpu")
    return j, p


@pytest.fixture(scope="module")
def lbph_set():
    """Gray 100² faces of four fixture identities, two files each, and the
    label map the trainer writes."""
    from facerecognition_tpu_torch.models.lbph_tools import gray_face

    people = ("id0", "id1", "id2", "id3")
    faces, labels = [], []
    for label, person in enumerate(people):
        for kind in ("0_baseline.jpg", "3_rgb.png"):
            faces.append(gray_face(load_image(os.path.join(FIXTURES, "faces", person, kind)), 100))
            labels.append(label)
    return np.stack(faces), np.asarray(labels), dict(enumerate(people))


def _enrol(engine):
    for person in ("id0", "id1", "id2", "id3"):
        engine.add_to_db(person, [load_image(fixture_file(person, "0_baseline.jpg"))])


@pytest.fixture(scope="module")
def port_app(small_embedders, lbph_set, tmp_path_factory):
    from facerecognition_tpu_torch.models.lbph import LBPHModel

    registry = pweb.EngineRegistry(device="cpu")
    engine = RecognitionEngine(embedder=small_embedders[1], threshold=0.3, device="cpu")
    _enrol(engine)
    lbph = LBPHModel(threshold=1e9, device="cpu")
    lbph.train(lbph_set[0], lbph_set[1])
    registry._engines.update(arcface=engine, facenet=None, lbph=lbph)
    registry.lbph_label_map = dict(lbph_set[2])
    builder = DatabaseBuilder(str(tmp_path_factory.mktemp("dbs")), device="cpu")
    return pweb.create_app(registry, builder=builder), registry, engine, builder


@pytest.fixture(scope="module")
def jax_app(small_embedders, lbph_set, tmp_path_factory):
    from facerecognition_tpu.apps.web_app import EngineRegistry, create_app
    from facerecognition_tpu.inference.database_builder import DatabaseBuilder as JBuilder
    from facerecognition_tpu.inference.engine import RecognitionEngine as JEngine
    from facerecognition_tpu.models.lbph import LBPHModel as JLBPH

    registry = EngineRegistry()
    engine = JEngine(embedder=small_embedders[0], threshold=0.3)
    _enrol(engine)
    lbph = JLBPH(threshold=1e9)
    lbph.train(lbph_set[0], lbph_set[1])
    registry._engines.update(arcface=engine, facenet=None, lbph=lbph)
    registry.lbph_label_map = dict(lbph_set[2])
    builder = JBuilder(str(tmp_path_factory.mktemp("jdbs")))
    return create_app(registry, builder=builder), registry, engine, builder


# ---------------------------------------------------------------------------
# Pages, escaping, answers
# ---------------------------------------------------------------------------


def test_home_get(port_app):
    status, _, data = Client(port_app[0]).request("GET", "/", accept="text/html")
    assert status == "200 OK"
    assert b"<form" in data


def test_recognize_post_names_the_enrolled_person(port_app):
    app, registry, engine, _ = port_app
    arr, png = png_bytes(np.random.default_rng(5))
    engine.add_to_db("tester", [arr])
    try:
        status, payload = Client(app).post_multipart(
            "/", [("image", ("t.png", png)), ("threshold", "0.3")])
    finally:
        engine.gallery.remove("tester")
    assert status == "200 OK"
    res = payload["results"]
    assert res["arcface"]["identity"] == "tester"
    assert res["facenet"]["status"] == "error"  # model not loaded
    assert res["lbph"]["status"] == "success"
    assert res["arcface"]["time_ms"] > 0


@pytest.mark.parametrize("fields", [[("threshold", "0.5")],
                                    [("threshold", "abc"), ("image", ("a.png", None))],
                                    [("image", ("a.gif", b"GIF89a not decodable"))]],
                         ids=["no-image", "bad-threshold", "not-jpeg-or-png"])
def test_home_post_bad_requests_are_400(port_app, fields):
    png = png_bytes(np.random.default_rng(57))[1]
    fields = [(n, (v[0], png) if isinstance(v, tuple) and v[1] is None else v) for n, v in fields]
    status, _ = Client(port_app[0]).post_multipart("/", fields)
    assert status.startswith("400")


def test_draw_faces_annotates_in_the_jax_colours():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (160, 160, 3), dtype=np.uint8)
    faces = [
        {"identity": "alice", "confidence": 0.91, "bbox": [20, 20, 80, 80], "det_score": 0.9},
        {"identity": "Unknown", "confidence": 0.1, "bbox": [90, 90, 150, 150], "det_score": 0.7},
    ]
    ref = img.copy()
    out = pweb.draw_faces(img, faces)
    assert out.shape == img.shape and out.dtype == np.uint8
    assert (out != img).any(), "annotation drew nothing"
    # box edges at cv2's thickness max(2, W // 320) = 2 in the JAX app's colours (BGR there)
    assert (out[50, 19:21] == (63, 181, 111)).all() and (out[50, 21] == img[50, 21]).all()
    assert (out[120, 149:151] == (224, 164, 59)).all()
    # no room above the first box (y1 - th - 6t <= 0): its label band goes
    # below it, from y2 + 4 to y2 + th + 6t, with dark glyph pixels in it
    band = out[84:121, 20:88]
    assert ((band == (63, 181, 111)).all(-1)).mean() > 0.5
    assert ((band == (21, 17, 15)).all(-1)).sum() > 50
    np.testing.assert_array_equal(img, ref)  # the input is not drawn on


def test_batch_html_view(port_app):
    app, _, engine, _ = port_app
    arr, png = png_bytes(np.random.default_rng(987123))
    engine.add_to_db("carl", [arr])
    try:
        status, _, data = Client(app).request(
            "POST", "/batch", *multipart([("model", "arcface"), ("images", ("c.png", png))]),
            accept="text/html")
    finally:
        engine.gallery.remove("carl")
    assert status == "200 OK"
    assert b"<table>" in data and b"carl" in data


def test_html_responses_escape_user_strings(port_app):
    """A hostile filename and model name come back escaped."""
    _, png = png_bytes(np.random.default_rng(55))
    evil = "<img src=x onerror=alert(1)>.png"
    status, _, data = Client(port_app[0]).request(
        "POST", "/batch", *multipart([("model", "arcface"), ("images", (evil, png))], "xssb"),
        accept="text/html")
    assert status == "200 OK"
    assert b"<img src=x onerror" not in data
    assert b"&lt;img" in data
    status, _, data = Client(port_app[0]).request(
        "POST", "/batch", *multipart([("model", "<script>x</script>")]), accept="text/html")
    assert b"<script>x" not in data


def test_batch_reports_undecodable_uploads(port_app):
    _, png = png_bytes(np.random.default_rng(56))
    status, payload = Client(port_app[0]).post_multipart(
        "/batch", [("model", "arcface"), ("images", ("ok.png", png)),
                   ("images", ("broken.png", b"not an image")),
                   ("images", ("anim.gif", b"GIF89a..."))])
    rows = {e["filename"]: e for e in payload["results"]}
    assert rows["broken.png"]["status"] == "error" and rows["anim.gif"]["status"] == "error"
    assert rows["ok.png"]["status"] == "success"


def test_batch_keeps_upload_order(port_app):
    app, _, engine, _ = port_app
    rng = np.random.default_rng(71)
    arr1, png1 = png_bytes(rng)
    _, png2 = png_bytes(rng)
    engine.add_to_db("b1", [arr1])
    try:
        status, payload = Client(app).post_multipart(
            "/batch", [("model", "arcface"), ("images", ("a.png", png1)), ("images", ("b.png", png2))])
    finally:
        engine.gallery.remove("b1")
    assert status == "200 OK"
    assert [r["filename"] for r in payload["results"]] == ["a.png", "b.png"]
    assert payload["results"][0]["identity"] == "b1"


def test_builder_routes(port_app, tmp_path):
    app, *_ = port_app
    c = Client(app)
    status, _ = c.post_multipart("/database-builder/build",
                                 [("dataset_dir", "/nope"), ("model_type", "lbph")])
    assert status.startswith("400")
    status, _ = c.post_multipart("/database-builder/build",
                                 [("dataset_dir", FIXTURES), ("model_type", "resnet")])
    assert status.startswith("400")
    data = tmp_path / "data"
    for person in ("id1", "id2"):
        (data / person).mkdir(parents=True)
        for kind in ("0_baseline.jpg", "3_rgb.png"):
            (data / person / kind).write_bytes(fixture_file(person, kind))
    status, payload = c.post_multipart("/database-builder/build",
                                       [("dataset_dir", str(data)), ("model_type", "lbph")])
    assert status == "200 OK"
    deadline = time.time() + 60
    while time.time() < deadline:
        status, s = c.get_json(f"/database-builder/status/{payload['job_id']}")
        if s["status"] in ("completed", "failed"):
            break
        time.sleep(0.1)
    assert s["status"] == "completed", s.get("error")
    assert len(s["output_files"]) == 2 and s["progress"] == 100.0
    status, _ = c.get_json("/database-builder/status/zzz")
    assert status.startswith("404")


def test_arcface_build_route_embeds_with_the_served_model(port_app, tmp_path):
    """An ArcFace job of the app embeds with the registry's engine, so the
    gallery it writes matches the app's own embeddings."""
    app, registry, engine, builder = port_app
    data = tmp_path / "data"
    (data / "id2").mkdir(parents=True)
    (data / "id2" / "3_rgb.png").write_bytes(fixture_file("id2"))
    status, payload = Client(app).post_multipart(
        "/database-builder/build", [("dataset_dir", str(data)), ("model_type", "arcface")])
    job = builder.get_job(payload["job_id"])
    deadline = time.time() + 60
    while job.status not in ("completed", "failed") and time.time() < deadline:
        time.sleep(0.1)
    assert job.status == "completed", job.error
    db = np.load(job.output_files[0], allow_pickle=True).item()
    want = engine.embedder.embed_uint8(load_image(fixture_file("id2"))[None].astype(np.float32))[0]
    assert float(db["id2"] @ want / np.linalg.norm(want)) > 0.9999


def test_download_job_reported_path_and_guard(port_app):
    app, _, _, builder = port_app
    target = os.path.join(builder.output_root, "probe", "file.npy")
    os.makedirs(os.path.dirname(target), exist_ok=True)
    np.save(target, np.arange(3))
    c = Client(app)
    status, _, data = c.request("GET", "/database-builder/download/" + target)
    assert status == "200 OK" and len(data) > 0
    status, _, _ = c.request("GET", "/database-builder/download/probe/file.npy")
    assert status == "200 OK"
    for escape in ("/etc/passwd", "../../etc/passwd"):
        status, _, _ = c.request("GET", "/database-builder/download/" + escape)
        assert status.startswith(("403", "404")), escape


def test_set_realtime_model_validation(port_app):
    c = Client(port_app[0])
    status, _ = c.post_multipart("/set_realtime_model", [("model", "nonsense")])
    assert status.startswith("400")
    status, _ = c.post_multipart("/set_realtime_model", [("model", "facenet")])
    assert status.startswith("400")  # not loaded
    status, payload = c.post_multipart("/set_realtime_model", [("model", "arcface")])
    assert status == "200 OK" and payload == {"status": "ok", "model": "arcface"}


def test_404(port_app):
    status, _ = Client(port_app[0]).get_json("/nope")
    assert status.startswith("404")


@pytest.mark.parametrize("accept", ["application/json", "text/html"])
def test_oversized_body_rejected(port_app, accept):
    app = pweb.create_app(port_app[1], builder=port_app[3], max_body_bytes=1024)
    status, _, data = Client(app).request(
        "POST", "/", *multipart([("image", ("big.png", bytes(4096)))]), accept=accept)
    assert status.startswith("413")
    assert b"limit" in data
    if accept == "text/html":
        assert b"<html" in data.lower()
    else:
        assert "limit" in json.loads(data)["error"]


def test_video_route_strides_and_errors(port_app, tmp_path):
    import cv2

    app, _, engine, _ = port_app
    rng = np.random.default_rng(11)
    path = str(tmp_path / "c.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 64))
    for _ in range(6):
        writer.write(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    writer.release()
    with open(path, "rb") as f:
        data = f.read()
    c = Client(app)
    status, out = c.post_multipart("/video", [("video", ("c.avi", data)), ("every_n", "2"),
                                              ("model", "arcface")])
    assert status.startswith("200"), out
    assert out["frames"] == 3  # 6 frames, stride 2
    assert len(out["timeline"]) == 3
    assert sum(out["identity_counts"].values()) == 3
    status, _ = c.post_multipart("/video", [("model", "arcface")])
    assert status.startswith("400")
    status, out = c.post_multipart("/video", [("video", ("x.mp4", b"not a video"))])
    assert status.startswith("400") and out["error"] == "unreadable video file"
    status, out = c.post_multipart("/video", [("video", ("c.avi", data)), ("every_n", ""),
                                              ("max_frames", "2")])
    assert status.startswith("200") and out["frames"] == 2  # a cleared field takes the default
    status, _ = c.post_multipart("/video", [("video", ("c.avi", data)), ("every_n", "abc")])
    assert status.startswith("400")
    status, _ = c.post_multipart("/video", [("video", ("c.avi", data)), ("model", "lbph")])
    assert status.startswith("400")
    status, _ = c.post_multipart("/video", [("video", ("c.avi", data)), ("model", "facenet")])
    assert status.startswith("503")


# ---------------------------------------------------------------------------
# Templates and static files
# ---------------------------------------------------------------------------


def test_templates_and_static_files_are_the_jax_apps():
    from facerecognition_tpu.apps import web_app as jweb

    for ours, theirs in ((pweb.TEMPLATES_DIR, jweb.TEMPLATES_DIR), (pweb.STATIC_DIR, jweb.STATIC_DIR)):
        names = sorted(os.path.relpath(os.path.join(d, n), theirs)
                       for d, _, ns in os.walk(theirs) for n in ns)
        assert names == sorted(os.path.relpath(os.path.join(d, n), ours)
                               for d, _, ns in os.walk(ours) for n in ns)
        for name in names:
            with open(os.path.join(ours, name), "rb") as a, open(os.path.join(theirs, name), "rb") as b:
                assert a.read() == b.read(), name


@pytest.mark.parametrize("path,js", [("/", b"/static/js/index.js"), ("/batch", b"/static/js/batch.js"),
                                     ("/realtime", b"/static/js/realtime.js"),
                                     ("/database-builder", b"/static/js/builder.js")])
def test_pages_reference_static_assets(port_app, path, js):
    status, _, body = Client(port_app[0]).request("GET", path, accept="text/html")
    assert status == "200 OK"
    assert b"/static/css/style.css" in body and js in body
    assert b'class="active"' in body  # nav highlights the current page


def test_static_served_with_content_type(port_app):
    c = Client(port_app[0])
    status, headers, body = c.request("GET", "/static/css/style.css")
    assert status == "200 OK" and headers["Content-Type"].startswith("text/css")
    assert b"--accent" in body
    status, headers, _ = c.request("GET", "/static/js/realtime.js")
    assert status == "200 OK" and "javascript" in headers["Content-Type"]


def test_js_drives_the_live_endpoints(port_app):
    c = Client(port_app[0])
    rt = c.request("GET", "/static/js/realtime.js")[2]
    assert all(p in rt for p in (b"/realtime_result", b"/set_realtime_model", b"/stop_camera"))
    bd = c.request("GET", "/static/js/builder.js")[2]
    assert all(p in bd for p in (b"/database-builder/build", b"/database-builder/status/",
                                 b"/database-builder/download/"))
    assert b"/video" in c.request("GET", "/static/js/batch.js")[2]


@pytest.mark.parametrize("path", ["/static/../web_app.py", "/static/../../inference/engine.py",
                                  "/static/../label_font.npz"])
def test_static_path_traversal_guarded(port_app, path):
    status, _, _ = Client(port_app[0]).request("GET", path)
    assert status.startswith("404")


def test_unknown_template_token_renders_empty():
    html = pweb.render_template("index.html", threshold="0.7")
    assert "{{" not in html
    assert 'value="0.7"' in html


# ---------------------------------------------------------------------------
# /recognize (MicroBatcher) and /stats
# ---------------------------------------------------------------------------


class FakeFusedEngine:
    """The engine surface MicroBatcher and get_batcher use; the identity
    is read from pixel [0, 0, 0]."""

    def __init__(self, delay=0.0, error=None):
        self.detector = object()
        self.gallery = ["a", "b", "c"]
        self.threshold = 0.5
        self.delay = delay
        self.error = error

    def fused_recognize_frames(self, frames, k=5, max_faces=1):
        if self.error is not None:
            raise self.error
        if self.delay:
            time.sleep(self.delay)
        out = []
        for f in np.asarray(frames):
            tag = f"id{int(f[0, 0, 0])}"
            face = {"identity": tag, "confidence": 0.9, "top_k": [(tag, 0.9)],
                    "bbox": [0, 0, 4, 4], "det_score": 0.95, "embedding": np.zeros(4, np.float32)}
            out.append({**face, "status": "success", "faces": [dict(face)]})
        return out


def _fused_app(**engine_kwargs):
    registry = pweb.EngineRegistry(device="cpu")
    eng = FakeFusedEngine(**engine_kwargs)
    registry._engines.update(arcface=eng, facenet=None, lbph=None)
    return pweb.create_app(registry, builder=DatabaseBuilder(device="cpu"),
                           batcher_opts={"frame_size": (8, 8), "max_delay_ms": 1.0}), eng


def const_png(v, size=16):
    return encode_png(np.full((size, size, 3), v, np.uint8))


def test_warmup_calls_the_card_from_the_batcher_thread():
    """--warmup runs the fused buckets 8 and 1 through the /recognize
    batcher, so that they run on its dispatcher thread, the one that serves
    the requests, before the first request."""
    app, eng = _fused_app()
    calls = []
    eng.embedder = types.SimpleNamespace(config=types.SimpleNamespace(input_size=8),
                                         embed_uint8=lambda x: calls.append(("embed", len(x))))
    fused = eng.fused_recognize_frames

    def traced(frames, k=5, max_faces=1):
        calls.append((threading.current_thread().name, len(frames)))
        return fused(frames, k, max_faces)

    eng.fused_recognize_frames = traced
    registry = pweb.EngineRegistry(device="cpu")
    registry._engines.update(arcface=eng, facenet=None, lbph=None)
    pweb.warmup(registry, app)
    assert calls == [("embed", 1), ("micro-batcher", 8), ("micro-batcher", 1)]
    batching = app.batcher("arcface").stats()
    assert (batching["requests"], batching["batches"]) == (9, 2)


def test_recognize_route_raw_body():
    app, _ = _fused_app()
    status, _, data = Client(app).request("POST", "/recognize", const_png(5),
                                          content_type="image/png")
    assert status == "200 OK", data
    payload = json.loads(data)
    assert payload["status"] == "success" and payload["model"] == "arcface"
    assert payload["identity"] == "id5"
    assert "embedding" not in payload and all("embedding" not in f for f in payload["faces"])
    assert payload["batching"]["requests"] >= 1


def test_recognize_route_multipart_and_multi_image():
    app, _ = _fused_app()
    status, payload = Client(app).post_multipart("/recognize", [("file", ("f.png", const_png(9)))])
    assert status == "200 OK" and payload["identity"] == "id9"
    status, payload = Client(app).post_multipart(
        "/recognize", [("file", (f"f{v}.png", const_png(v))) for v in (3, 7)]
        + [("image", ("f11.png", const_png(11)))])
    assert status == "200 OK", payload
    assert payload["count"] == 3
    assert [r["identity"] for r in payload["results"]] == ["id3", "id7", "id11"]
    assert all("embedding" not in f for r in payload["results"] for f in r["faces"])
    assert payload["batching"]["requests"] >= 4


@pytest.mark.parametrize("body,ctype,query,code", [
    (None, "multipart", "", "400"),  # one undecodable part fails the whole request
    (b"not an image", "application/octet-stream", "", "400"),
    (b"GIF89a....", "image/gif", "", "400"),
    (None, "image/png", "model=lbph", "400"),
], ids=["one-bad-part", "bad-body", "gif", "lbph"])
def test_recognize_route_refusals(body, ctype, query, code):
    app, _ = _fused_app()
    if ctype == "multipart":
        status, _, _ = Client(app).request(
            "POST", "/recognize", *multipart([("file", ("a.png", const_png(1))),
                                              ("file", ("b.png", b"junk"))]))
    else:
        status, _, _ = Client(app).request("POST", "/recognize", body or const_png(1),
                                           content_type=ctype, query=query)
    assert status.startswith(code)


def test_recognize_route_429_when_overloaded():
    registry = pweb.EngineRegistry(device="cpu")
    registry._engines["arcface"] = FakeFusedEngine(delay=0.8)
    app = pweb.create_app(registry, builder=DatabaseBuilder(device="cpu"), batcher_opts={
        "frame_size": (8, 8), "max_delay_ms": 1.0, "max_queue": 1})
    statuses, lock = [], threading.Lock()

    def hit():
        status, _, _ = Client(app).request("POST", "/recognize", const_png(2),
                                           content_type="image/png")
        with lock:
            statuses.append(status)

    first = threading.Thread(target=hit)
    first.start()
    time.sleep(0.3)  # the dispatcher is busy; the queue holds one
    rest = [threading.Thread(target=hit) for _ in range(3)]
    for t in rest:
        t.start()
    for t in [first] + rest:
        t.join(timeout=30)
    assert sum(s.startswith("429") for s in statuses) >= 1, statuses
    assert sum(s.startswith("200") for s in statuses) >= 2, statuses


def test_recognize_route_503_when_not_servable(port_app):
    """The module's engine has no detector: 503, not a crash."""
    status, _, data = Client(port_app[0]).request("POST", "/recognize", const_png(3),
                                                  content_type="image/png")
    assert status.startswith("503") and b"not servable" in data


def test_stats_reports_models_without_building(port_app):
    app, registry, engine, _ = port_app
    status, payload = Client(app).get_json("/stats")
    assert status == "200 OK" and payload["status"] == "ok"
    assert payload["platform"] == "cpu" and payload["device"] == "cpu"
    assert payload["models"]["arcface"]["loaded"] is True
    assert payload["models"]["arcface"]["gallery_size"] == len(engine.gallery)
    assert payload["models"]["arcface"]["match_kernel"] == "auto"
    assert payload["models"]["facenet"] == {"loaded": False}
    assert payload["models"]["lbph"] == {"loaded": True}


def test_healthz_alias_and_batching_stats():
    app, _ = _fused_app()
    Client(app).request("POST", "/recognize", const_png(1), content_type="image/png")
    status, payload = Client(app).get_json("/healthz")
    assert status == "200 OK"
    assert payload["models"]["arcface"]["batching"]["requests"] >= 1


# ---------------------------------------------------------------------------
# No fallback that hides a failed kernel
# ---------------------------------------------------------------------------


def test_recognize_route_answers_500_on_a_kernel_failure():
    app, _ = _fused_app(error=RuntimeError("nvcc failed on warp_sample.cu"))
    status, _, data = Client(app).request("POST", "/recognize", const_png(1),
                                          content_type="image/png")
    assert status.startswith("500")
    assert b"nvcc failed" in json.loads(data)["error"].encode()


def _served_status(app, path, body, content_type):
    """The status code that ``wsgiref``'s server answers one POST with."""
    from wsgiref.handlers import SimpleHandler

    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path, "QUERY_STRING": "",
               "CONTENT_TYPE": content_type, "CONTENT_LENGTH": str(len(body)),
               "SERVER_NAME": "localhost", "SERVER_PORT": "0", "SERVER_PROTOCOL": "HTTP/1.1"}
    out, err = io.BytesIO(), io.StringIO()
    SimpleHandler(io.BytesIO(body), out, err, environ, multithread=True).run(app)
    return out.getvalue().split(b"\r\n", 1)[0].split()[1].decode()


def test_decoder_failure_on_the_card_answers_500_not_400(monkeypatch):
    """A failure of the card while an upload is decoded (``decode_mem``'s
    ``RuntimeError``) is a server error on / and /recognize, never the 400
    of an undecodable upload."""
    from facerecognition_tpu_torch.data import native_decode

    def device_error(data, name=None):
        raise RuntimeError("JPEG: nvJPEG copy: an illegal memory access was encountered")

    app, _ = _fused_app()
    home = multipart([("image", ("a.png", const_png(1)))])
    frames = multipart([("file", ("a.png", const_png(1))), ("file", ("b.png", const_png(2)))])
    raw = (const_png(1), "image/png")
    with monkeypatch.context() as m:
        m.setattr(native_decode, "decode_mem", device_error)
        assert [_served_status(app, "/", *home), _served_status(app, "/recognize", *raw),
                _served_status(app, "/recognize", *frames)] == ["500"] * 3
    assert _served_status(app, "/recognize", *raw) == "200"
    assert _served_status(app, "/recognize", b"not an image", "image/png") == "400"
    assert _served_status(app, "/", *multipart([("image", ("x.png", b"not an image"))])) == "400"


class _Raising:
    """An engine whose kernel paths raise ``error``; its staged path would
    answer, and must not be asked."""

    def __init__(self, error, detector):
        self.error = error
        self.detector = detector
        self.gallery = ["a"]
        self.staged_calls = 0

    def recognize_all(self, image, k=5, max_faces=16):
        raise self.error

    def recognize(self, image, k=5):
        self.staged_calls += 1
        return {"status": "success", "identity": "staged", "confidence": 0.5, "top_k": []}


def test_recognize_with_model_raises_a_runtime_error_and_falls_back_on_value_error():
    registry = pweb.EngineRegistry(device="cpu")
    detector = types.SimpleNamespace(select_largest=True)
    engine = _Raising(RuntimeError("CUDA launch failed"), detector)
    registry._engines["arcface"] = engine
    image = np.zeros((32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="launch failed"):
        pweb.recognize_with_model(registry, "arcface", image)
    assert engine.staged_calls == 0
    engine.error = ValueError("recognize_all needs a detector")
    assert pweb.recognize_with_model(registry, "arcface", image)["identity"] == "staged"


def test_gradcam_and_decoder_failures_propagate(monkeypatch):
    from facerecognition_tpu_torch.data import native_decode

    registry = pweb.EngineRegistry(device="cpu")
    registry._engines["arcface"] = types.SimpleNamespace(embedder=None)
    import facerecognition_tpu_torch.inference.explainability as ex

    def boom(*a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(ex, "ExplainabilityEngine", boom)
    with pytest.raises(RuntimeError, match="build failed"):
        pweb.gradcam_overlays(registry, np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setattr(native_decode, "_lib", boom)
    with pytest.raises(RuntimeError, match="build failed"):
        pweb._decode_image(const_png(1))


def test_engine_registry_degrades_only_on_missing_files(monkeypatch):
    """No checkpoint configured: the shipped ones load; a path that does not
    exist reads as "Model not loaded"; a failed kernel build raises."""
    from facerecognition_tpu_torch.inference import engine as peng

    reg = pweb.EngineRegistry(device="cpu")
    for model in ("arcface", "facenet"):
        shipped = (pee.default_arcface_checkpoint() if model == "arcface"
                   else pee.default_facenet_checkpoint())
        assert (reg.get(model) is not None) == (shipped is not None)
    assert reg.get("lbph") is None
    assert pweb.EngineRegistry(arcface_ckpt="/nonexistent/path.msgpack", device="cpu").get("arcface") is None

    def boom(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(peng, "RecognitionEngine", boom)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pweb.EngineRegistry(device="cpu").get("arcface")


def test_main_refuses_pallas_and_serves_over_a_socket(monkeypatch, tmp_path):
    import http.client

    with pytest.raises(SystemExit):
        pweb.main(["--match-kernel", "pallas", "--device", "cpu"])
    monkeypatch.chdir(tmp_path)  # the default builder writes under ./databases
    servers = []
    thread = threading.Thread(target=pweb.main, kwargs=dict(
        argv=["--device", "cpu", "--port", "0", "--threads", "4"], ready=servers.append),
        daemon=True)
    thread.start()
    deadline = time.time() + 60
    while not servers and time.time() < deadline:
        time.sleep(0.05)
    server = servers[0]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["platform"] == "cpu"
        conn.close()
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()


# ---------------------------------------------------------------------------
# Streamlit demo, driven by a fake module
# ---------------------------------------------------------------------------


def _fake_streamlit(upload_bytes, record):
    st = types.ModuleType("streamlit")
    st.title = lambda *a, **k: record.setdefault("title", a)
    st.cache_resource = lambda fn: fn
    st.sidebar = types.SimpleNamespace(write=lambda *a, **k: None,
                                       slider=lambda label, lo, hi, value, step: value)
    st.file_uploader = lambda *a, **k: upload_bytes
    st.image = lambda *a, **k: None
    st.error = lambda msg: record.setdefault("error", msg)
    st.subheader = lambda s: record.setdefault("identity", s)
    st.write = lambda *a, **k: None
    st.table = lambda rows: record.setdefault("table", rows)
    return st


@pytest.fixture
def streamlit_env(monkeypatch, tmp_path, small_embedders):
    """An enrolled gallery on disk and the upload of the same image; the
    ArcFace loader (the app builds its engine with it, without
    ARCFACE_CKPT) gives the module's small embedder."""
    import sys

    from facerecognition_tpu_torch.inference import engine as peng

    monkeypatch.setitem(peng.LOADERS, "arcface", lambda ckpt, device=None: small_embedders[1])
    img = np.random.default_rng(0).integers(0, 256, (160, 160, 3)).astype("uint8")
    setup = RecognitionEngine(model_type="arcface", device="cpu")
    assert setup.add_to_db("alice", [img])
    db_path = str(tmp_path / "face_db.npy")
    setup.gallery.save(db_path)
    record = {}
    monkeypatch.setitem(sys.modules, "streamlit", _fake_streamlit(io.BytesIO(encode_png(img)), record))
    monkeypatch.setenv("FACE_DB", db_path)
    monkeypatch.setenv("FRT_DEVICE", "cpu")
    monkeypatch.delenv("ARCFACE_CKPT", raising=False)
    return record


def test_streamlit_recognize_path(streamlit_env, monkeypatch):
    from facerecognition_tpu_torch.apps import streamlit_app

    monkeypatch.setenv("FACE_DETECTOR", "off")
    streamlit_app.run()
    assert "error" not in streamlit_env, streamlit_env
    assert streamlit_env["identity"] == "alice"
    assert streamlit_env["table"][0]["identity"] == "alice"


def test_streamlit_builds_and_consults_the_detector(streamlit_env, monkeypatch):
    from facerecognition_tpu_torch.apps import streamlit_app
    from facerecognition_tpu_torch.preprocessing import face_detector as fd_mod

    calls = {"init": 0, "detect": 0}

    class FakeDetector:
        device = None

        def __init__(self, *a, **k):
            calls["init"] += 1
            import torch

            FakeDetector.device = torch.device(k.get("device") or "cpu")

        def detect(self, image):
            calls["detect"] += 1
            return None  # a miss: the engine embeds the whole image

    monkeypatch.setattr(fd_mod, "FaceDetector", FakeDetector)
    monkeypatch.delenv("FACE_DETECTOR", raising=False)
    streamlit_app.run()
    assert calls == {"init": 1, "detect": calls["detect"]} and calls["detect"] >= 1
    assert "error" not in streamlit_env, streamlit_env
    assert streamlit_env["identity"] == "alice"


def test_streamlit_empty_gallery_surfaces_error(streamlit_env, monkeypatch, tmp_path):
    from facerecognition_tpu_torch.apps import streamlit_app

    monkeypatch.setenv("FACE_DB", str(tmp_path / "missing.npy"))
    monkeypatch.setenv("FACE_DETECTOR", "off")
    streamlit_app.run()
    assert "identity" not in streamlit_env and "error" in streamlit_env


# ---------------------------------------------------------------------------
# The same requests to the JAX app and the port's app
# ---------------------------------------------------------------------------


def _keys(obj):
    """The nested JSON key structure of an answer (values dropped)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj[:1]]
    return None


def _same_result(p, j, what):
    assert _keys(p) == _keys(j), what
    assert p["status"] == j["status"] and p.get("identity") == j.get("identity"), what
    if p["status"] != "success":
        assert p == j, what
    elif p.get("model") == "lbph":
        np.testing.assert_allclose(p["confidence"], j["confidence"], rtol=LBPH_RTOL, err_msg=what)
        assert [n for n, _ in p["top_k"]] == [n for n, _ in j["top_k"]], what
        np.testing.assert_allclose([d for _, d in p["top_k"]], [d for _, d in j["top_k"]],
                                   rtol=LBPH_RTOL, err_msg=what)
    else:
        assert abs(p["confidence"] - j["confidence"]) <= CONF_TOL, what
        assert [n for n, _ in p.get("top_k", [])] == [n for n, _ in j.get("top_k", [])], what


@pytest.mark.parametrize("person,kind", [("id1", "3_rgb.png"), ("id2", "1_progressive.jpg"),
                                         ("id9", "0_baseline.jpg")])
def test_home_post_equals_jax(port_app, jax_app, person, kind):
    fields = [("image", (kind, fixture_file(person, kind))), ("threshold", "0.3")]
    ps, pp = Client(port_app[0]).post_multipart("/", fields)
    js, jp = Client(jax_app[0]).post_multipart("/", fields)
    assert ps == js == "200 OK"
    assert set(pp["results"]) == set(jp["results"])
    for m in pp["results"]:
        if "time_ms" in jp["results"][m]:
            jp["results"][m]["time_ms"] = pp["results"][m]["time_ms"]
        _same_result(pp["results"][m], jp["results"][m], f"{person}/{kind} {m}")


def test_batch_equals_jax(port_app, jax_app):
    fields = [("model", "arcface")] + [
        ("images", (f"{p}.png", fixture_file(p))) for p in ("id0", "id3", "id5")
    ] + [("images", ("broken.png", b"junk"))]
    ps, pp = Client(port_app[0]).post_multipart("/batch", fields)
    js, jp = Client(jax_app[0]).post_multipart("/batch", fields)
    assert ps == js == "200 OK"
    assert [r["filename"] for r in pp["results"]] == [r["filename"] for r in jp["results"]]
    for p, j in zip(pp["results"], jp["results"]):
        assert _keys(p) == _keys(j) and p["identity"] == j["identity"]
        if p["status"] == "success":
            assert abs(p["confidence"] - j["confidence"]) <= CONF_TOL
    ps, pp = Client(port_app[0]).post_multipart("/batch", [("model", "lbph"),
                                                           ("images", ("a.png", fixture_file("id2")))])
    js, jp = Client(jax_app[0]).post_multipart("/batch", [("model", "lbph"),
                                                          ("images", ("a.png", fixture_file("id2")))])
    jp["results"][0]["time_ms"] = pp["results"][0]["time_ms"]
    _same_result(pp["results"][0], jp["results"][0], "lbph batch")


def test_routes_answer_like_jax(port_app, jax_app):
    """Status and JSON keys of the other routes, request for request."""
    requests = [
        ("GET", "/nope", None), ("GET", "/database-builder/status/zzz", None),
        ("POST", "/set_realtime_model", [("model", "nonsense")]),
        ("POST", "/set_realtime_model", [("model", "arcface")]),
        ("POST", "/database-builder/build", [("dataset_dir", "/nope"), ("model_type", "lbph")]),
        ("POST", "/video", [("model", "arcface")]),
        ("POST", "/recognize", [("file", ("a.png", fixture_file("id1")))]),
    ]
    for method, path, fields in requests:
        if method == "GET":
            (ps, pp), (js, jp) = Client(port_app[0]).get_json(path), Client(jax_app[0]).get_json(path)
        else:
            ps, pp = Client(port_app[0]).post_multipart(path, fields)
            js, jp = Client(jax_app[0]).post_multipart(path, fields)
        assert ps == js and _keys(pp) == _keys(jp), (path, ps, js, pp, jp)
    (ps, pp), (js, jp) = Client(port_app[0]).get_json("/stats"), Client(jax_app[0]).get_json("/stats")
    assert ps == js == "200 OK" and pp["platform"] == jp["platform"] == "cpu"
    assert pp["models"]["arcface"].keys() == jp["models"]["arcface"].keys()


def test_video_route_equals_jax(port_app, jax_app, tmp_path):
    """The committed MJPEG clip through both apps (no detector: the staged
    batch path): frames, identities and confidences agree."""
    with open(os.path.join(FIXTURES, "faces_clip.avi"), "rb") as f:
        data = f.read()
    fields = [("video", ("clip.avi", data)), ("every_n", "4"), ("model", "arcface")]
    ps, pp = Client(port_app[0]).post_multipart("/video", fields)
    js, jp = Client(jax_app[0]).post_multipart("/video", fields)
    assert ps == js == "200 OK"
    assert pp["frames"] == jp["frames"] == 8
    assert [t["identity"] for t in pp["timeline"]] == [t["identity"] for t in jp["timeline"]]
    np.testing.assert_allclose([t["confidence"] for t in pp["timeline"]],
                               [t["confidence"] for t in jp["timeline"]], atol=CONF_TOL + 1e-4)
    assert pp["identity_counts"] == jp["identity_counts"] and pp.keys() == jp.keys()

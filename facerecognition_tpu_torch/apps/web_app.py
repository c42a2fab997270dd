"""Web app: the framework-free WSGI app of the JAX package, on the port.

Counterpart of ``facerecognition_tpu/apps/web_app.py``, with its routes,
templates and static files (``templates/``, ``static/``, byte for byte):

- ``GET/POST /``                 single image, the three-model compare and
                                 the Grad-CAM / activation-CAM overlays
- ``GET/POST /batch``            several uploads
- ``POST /video``                offline recognition of a Motion-JPEG AVI
- ``POST /recognize``            the serving API: per-model ``MicroBatcher``
                                 onto the fused call, raw or multipart bodies
- ``GET /stats``, ``/healthz``   loaded models, batching stats, the device
- ``GET /realtime``, ``/video_feed`` (MJPEG), ``/realtime_result``,
  ``POST /stop_camera``, ``/set_realtime_model``
- ``GET /database-builder``, ``POST /database-builder/build``,
  ``GET /database-builder/status/<id>``, ``/database-builder/download/<path>``
- ``GET /static/<path>``

The engines run on ``EngineRegistry``'s ``device`` (``None``: the CUDA
card). What differs from the JAX app: uploads are decoded by the port's
decoder only (JPEG and PNG; anything else is answered 400), images are
encoded by ``utils/imageio`` (PNG, and JPEG for the MJPEG stream), face
labels are drawn in numpy with a bitmap font rasterised from cv2's Hershey
simplex (``label_font.npz``; the glyphs' pixels differ from cv2's), builder
jobs embed with the registry's own model, and ``/stats`` names the device
from PyTorch. Only expected refusals (``ValueError``: no detector, an empty
gallery) fall back to another path; a kernel that fails to build or launch
raises (``/recognize`` answers 500).

    python -m facerecognition_tpu_torch.apps.web_app --port 8000 --gallery databases/arcface/face_db.npy
"""

from __future__ import annotations

import base64
import functools
import html
import json
import mimetypes
import os
import re
import threading
import time
from email.parser import BytesParser
from email.policy import HTTP
from typing import Any, Callable, Optional
from urllib.parse import parse_qs

import numpy as np
import torch

from facerecognition_tpu_torch.data import native_decode
from facerecognition_tpu_torch.device import DeviceLike, resolve_device
from facerecognition_tpu_torch.utils.imageio import encode_png

MODELS = ("arcface", "facenet", "lbph")


def esc(v) -> str:
    """HTML-escape user-controlled strings (filenames, identities,
    messages) before interpolating into response markup."""
    return html.escape(str(v), quote=True)


# ---------------------------------------------------------------------------
# Engine registry (lazy singletons)
# ---------------------------------------------------------------------------


class EngineRegistry:
    """The app's engines, built at first use on ``device``: ArcFace and
    FaceNet ``RecognitionEngine``s (the configured checkpoint, else the
    shipped one; None when there is none) with the gallery at
    ``gallery_path``, and the LBPH model at ``lbph_model_path`` with the
    ``label_map.npy`` beside it."""

    def __init__(
        self,
        arcface_ckpt: Optional[str] = None,
        facenet_ckpt: Optional[str] = None,
        lbph_model_path: Optional[str] = None,
        gallery_path: Optional[str] = None,
        detector=None,
        threshold: float = 0.5,
        match_kernel: str = "auto",
        device: DeviceLike = None,
    ):
        self.config = dict(
            arcface_ckpt=arcface_ckpt,
            facenet_ckpt=facenet_ckpt,
            lbph_model_path=lbph_model_path,
            gallery_path=gallery_path,
            threshold=threshold,
            match_kernel=match_kernel,
        )
        self.device = resolve_device(device)
        self.detector = detector
        self.lbph_label_map: dict[int, str] = {}
        self._engines: dict[str, Any] = {}
        self._lock = threading.Lock()

    def get(self, model_type: str):
        with self._lock:
            if model_type in self._engines:
                return self._engines[model_type]
            engine = self._build(model_type)
            self._engines[model_type] = engine
            return engine

    def _build(self, model_type: str):
        # A missing or unreadable checkpoint, gallery or model file reads as
        # "Model not loaded"; a failed kernel build (RuntimeError) raises.
        try:
            if model_type in ("arcface", "facenet"):
                from facerecognition_tpu_torch.inference.engine import Gallery, RecognitionEngine
                from facerecognition_tpu_torch.inference.extract_embeddings import (
                    default_arcface_checkpoint,
                    default_facenet_checkpoint,
                )

                ckpt = self.config[f"{model_type}_ckpt"]
                if not ckpt:
                    # the shipped trained checkpoints, so the app serves
                    # real weights out of the box
                    ckpt = (
                        default_arcface_checkpoint()
                        if model_type == "arcface"
                        else default_facenet_checkpoint()
                    )
                if not ckpt or not os.path.exists(ckpt):
                    # no trained weights: "Model not loaded", never a
                    # random-init net serving confident-looking identities
                    return None
                engine = RecognitionEngine(
                    model_type=model_type,
                    checkpoint_path=ckpt,
                    threshold=self.config["threshold"],
                    detector=self.detector,
                    match_kernel=self.config.get("match_kernel", "auto"),
                    device=self.device,
                )
                gp = self.config["gallery_path"]
                if gp and os.path.exists(gp):
                    engine.gallery = Gallery.load(gp, device=self.device)
                return engine
            if model_type == "lbph":
                from facerecognition_tpu_torch.models.lbph import LBPHModel

                path = self.config["lbph_model_path"]
                if path and os.path.exists(path):
                    model = LBPHModel.load(path, device=self.device)
                    # train_lbph writes label_map.npy next to the model:
                    # the UI shows names, not numeric labels
                    lm_path = os.path.join(os.path.dirname(os.path.abspath(path)), "label_map.npy")
                    if os.path.exists(lm_path):
                        raw = np.load(lm_path, allow_pickle=True)
                        # saved as an {int: name} dict
                        items = raw.item().items() if raw.ndim == 0 else enumerate(raw.tolist())
                        self.lbph_label_map = {int(k): str(v) for k, v in items}
                    return model
                return None
        except (OSError, ValueError):
            return None
        return None


# ---------------------------------------------------------------------------
# Request helpers
# ---------------------------------------------------------------------------


def _content_length(environ) -> int:
    """Tolerant Content-Length: malformed headers read as 0, not a 500."""
    try:
        return int(environ.get("CONTENT_LENGTH") or 0)
    except (TypeError, ValueError):
        return 0


def _parse_multipart(environ) -> dict[str, list]:
    """Minimal multipart/form-data parser on the stdlib email machinery."""
    ctype = environ.get("CONTENT_TYPE", "")
    body = environ["wsgi.input"].read(_content_length(environ))
    if not ctype.startswith("multipart/form-data"):
        return {k: [v[-1]] for k, v in parse_qs(body.decode(errors="ignore")).items()}
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + body
    )
    fields: dict[str, list] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name is None:
            continue
        filename = part.get_filename()
        payload = part.get_payload(decode=True)
        if filename:
            fields.setdefault(name, []).append({"filename": filename, "data": payload})
        else:
            fields.setdefault(name, []).append((payload or b"").decode(errors="ignore"))
    return fields


def _decode_image(data: bytes) -> Optional[np.ndarray]:
    """An upload as RGB uint8, None when it is not a JPEG or PNG the decoder
    reads. The decoder is built first, outside the ``except``: a build that
    fails raises, and so does a failure of the card or of memory while
    decoding (``RuntimeError``); neither is taken for an undecodable upload."""
    native_decode._lib()
    try:
        return native_decode.decode_mem(data)
    except OSError:
        return None


def _b64_png(rgb: np.ndarray) -> str:
    return base64.b64encode(encode_png(np.asarray(rgb, np.uint8))).decode()


# ---------------------------------------------------------------------------
# Recognition wrappers
# ---------------------------------------------------------------------------


def recognize_with_model(registry: EngineRegistry, model_type: str, image: np.ndarray) -> dict:
    engine = registry.get(model_type)
    if engine is None:
        return {"model": model_type, "status": "error", "message": "Model not loaded"}
    t0 = time.perf_counter()
    if model_type == "lbph":
        from facerecognition_tpu_torch.models.lbph_tools import gray_face

        # the JAX loaders' gray 100² face, bit for bit
        gray = gray_face(image, 100)
        label, conf = engine.predict(gray)
        topk = engine.predict_topk(gray, k=5)
        lm = registry.lbph_label_map  # numeric label → name when available
        name = lambda l: lm.get(int(l), str(l))  # noqa: E731
        result = {
            "model": model_type,
            "status": "success",
            "identity": name(label) if label >= 0 else "Unknown",
            "confidence": conf,  # LBPH: distance, lower = better
            "top_k": [(name(l), d) for l, d in topk],
        }
    else:
        faces = None
        if getattr(engine, "detector", None) is not None:
            # one recognize_all serves both the per-face drawing list and
            # the headline identity
            try:
                faces = engine.recognize_all(image)["faces"]
            except ValueError:
                faces = None
        if faces:
            # the headline face: detect()'s select_largest
            best = (
                max(
                    faces,
                    key=lambda f: (f["bbox"][2] - f["bbox"][0]) * (f["bbox"][3] - f["bbox"][1]),
                )
                if engine.detector.select_largest
                else faces[0]
            )
            result = {
                "model": model_type,
                "status": "success",
                "identity": best["identity"],
                "confidence": float(best["confidence"]),
                "top_k": [(n, float(s)) for n, s in best.get("top_k", [])],
                "faces": [
                    {
                        "identity": f["identity"],
                        "confidence": float(f["confidence"]),
                        "bbox": [float(v) for v in f["bbox"]],
                        "det_score": f["det_score"],
                    }
                    for f in faces
                ],
            }
        else:
            # no detections (or no detector): the staged recognize() and its
            # crop → resize chain
            res = engine.recognize(image)
            result = {
                "model": model_type,
                "status": res["status"],
                "identity": res["identity"],
                "confidence": res["confidence"],
                "top_k": [(n, float(s)) for n, s in res.get("top_k", [])],
            }
            if res.get("message"):
                result["message"] = res["message"]
    result["time_ms"] = (time.perf_counter() - t0) * 1e3
    return result


@functools.lru_cache(maxsize=None)
def _label_font() -> tuple[np.ndarray, np.ndarray, int, int]:
    """(glyphs (95, H, W) bool, advances (95,), baseline row, first code)."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "label_font.npz")) as z:
        width = int(z["width"])
        glyphs = np.unpackbits(z["bits"], axis=-1)[..., :width].astype(bool)
        return glyphs, z["advances"].copy(), int(z["baseline"]), int(z["first"])


def _text_size(label: str, t: int) -> tuple[int, int]:
    """(width, height above the baseline) of ``label`` at scale ``t``."""
    glyphs, advances, baseline, first = _label_font()
    codes = [min(max(ord(c) - first, 0), len(advances) - 1) for c in label]
    return int(sum(advances[c] for c in codes)) * t, baseline * t


def _fill(out: np.ndarray, x1: int, y1: int, x2: int, y2: int, color) -> None:
    """Fill [x1, x2] x [y1, y2] (inclusive), clipped to the image."""
    h, w = out.shape[:2]
    x1, x2 = max(x1, 0), min(x2, w - 1)
    y1, y2 = max(y1, 0), min(y2, h - 1)
    if x1 <= x2 and y1 <= y2:
        out[y1 : y2 + 1, x1 : x2 + 1] = color


def _put_text(out: np.ndarray, label: str, x: int, y: int, t: int, color) -> None:
    """Draw ``label`` with its baseline at row ``y`` from column ``x``, each
    glyph pixel a t x t square."""
    glyphs, advances, baseline, first = _label_font()
    h, w = out.shape[:2]
    for ch in label:
        c = min(max(ord(ch) - first, 0), len(advances) - 1)
        g = np.kron(glyphs[c], np.ones((t, t), bool))
        top = y - baseline * t
        ys, xs = np.nonzero(g)
        ys, xs = ys + top, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        out[ys[keep], xs[keep]] = color
        x += int(advances[c]) * t


def draw_faces(image: np.ndarray, faces: list[dict]) -> np.ndarray:
    """Annotate every detected face: box + identity label (green known,
    orange Unknown), at the JAX app's thickness, sizes and colours, drawn
    in numpy."""
    out = np.array(image, np.uint8, copy=True)
    t = max(2, image.shape[1] // 320)
    lo, hi = t // 2, (t - 1) // 2  # a t-wide line centred on the edge
    for f in faces:
        x1, y1, x2, y2 = (int(round(v)) for v in f["bbox"])
        known = f["identity"] not in ("Unknown", "No face", "No database")
        color = (63, 181, 111) if known else (224, 164, 59)  # RGB ok / warn
        _fill(out, x1 - lo, y1 - lo, x2 + hi, y1 + hi, color)
        _fill(out, x1 - lo, y2 - lo, x2 + hi, y2 + hi, color)
        _fill(out, x1 - lo, y1 - lo, x1 + hi, y2 + hi, color)
        _fill(out, x2 - lo, y1 - lo, x2 + hi, y2 + hi, color)
        label = f"{f['identity']} {f['confidence']:.2f}"
        tw, th = _text_size(label, t)
        ty = y1 - 4 * t if y1 - th - 6 * t > 0 else y2 + th + 4 * t
        _fill(out, x1, ty - th - 2 * t, x1 + tw + 2 * t, ty + 2 * t, color)
        _put_text(out, label, x1 + t, ty, t, (21, 17, 15))
    return out


def gradcam_overlays(registry: EngineRegistry, image: np.ndarray) -> dict[str, str]:
    """ArcFace Grad-CAM + FaceNet activation-CAM overlays as base64 PNG."""
    out = {}
    try:
        from facerecognition_tpu_torch.inference.explainability import (
            ExplainabilityEngine,
            FaceNetExplainabilityEngine,
        )

        # the explainability engines are kept on the registry
        cache = getattr(registry, "_explain_cache", None)
        if cache is None:
            cache = registry._explain_cache = {}
        arc = registry.get("arcface")
        if arc is not None:
            if "arcface" not in cache:
                cache["arcface"] = ExplainabilityEngine(arc.embedder, registry.detector)
            r = cache["arcface"].explain(image)
            if r is not None:
                out["arcface"] = _b64_png(r["overlay"])
        fn = registry.get("facenet")
        if fn is not None:
            if "facenet" not in cache:
                cache["facenet"] = FaceNetExplainabilityEngine(fn.embedder, registry.detector)
            r = cache["facenet"].explain(image)
            if r is not None:
                out["facenet"] = _b64_png(r["overlay"])
    except ValueError:
        pass
    return out


# ---------------------------------------------------------------------------
# Templates + static assets
# ---------------------------------------------------------------------------

_APP_DIR = os.path.dirname(os.path.abspath(__file__))
TEMPLATES_DIR = os.path.join(_APP_DIR, "templates")
STATIC_DIR = os.path.join(_APP_DIR, "static")

_TOKEN_RE = re.compile(r"\{\{\s*(\w+)\s*\}\}")
_template_cache: dict[str, tuple[int, str]] = {}


def _load_template(name: str) -> str:
    """Read a template from disk, cached by mtime (live-editable)."""
    path = os.path.join(TEMPLATES_DIR, name)
    mtime = os.stat(path).st_mtime_ns
    cached = _template_cache.get(name)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    with open(path, encoding="utf-8") as f:
        text = f.read()
    _template_cache[name] = (mtime, text)
    return text


def render_template(name: str, **ctx) -> str:
    """``{{ token }}`` substitution — no logic in templates; result
    fragments are rendered in Python with esc() applied to user strings.
    Unknown tokens render empty (nav_* active markers use this)."""
    return _TOKEN_RE.sub(lambda m: str(ctx.get(m.group(1), "")), _load_template(name))


def render_page(template: str, title: str, nav: str, **ctx) -> str:
    body = render_template(template, **ctx)
    return render_template(
        "base.html", title=title, body=body, **{f"nav_{nav}": 'class="active"'}
    )


# ---------------------------------------------------------------------------
# WSGI app
# ---------------------------------------------------------------------------


def create_app(
    registry: Optional[EngineRegistry] = None,
    builder=None,
    realtime=None,
    download_root: Optional[str] = None,
    max_body_bytes: int = 256 << 20,
    batcher_opts: Optional[dict] = None,
) -> Callable:
    """Build the WSGI application. All collaborators are injectable for
    testing; defaults construct the standard stack lazily."""
    from facerecognition_tpu_torch.inference.database_builder import get_builder

    registry = registry or EngineRegistry()
    builder = builder or get_builder(device=registry.device)
    download_root = os.path.abspath(download_root or builder.output_root)
    state = {"realtime": realtime, "realtime_model": "arcface", "batchers": {}}
    state_lock = threading.Lock()

    def get_batcher(model: str):
        """Lazy per-model MicroBatcher for /recognize. The engine is built
        outside ``state_lock`` (``registry.get`` has its own lock), so a
        first build does not stall the other routes."""
        b = state["batchers"].get(model)
        if b is not None:
            return b
        engine = registry.get(model)
        if engine is None or getattr(engine, "detector", None) is None or len(engine.gallery) == 0:
            return None
        from facerecognition_tpu_torch.apps.serving import MicroBatcher

        with state_lock:
            b = state["batchers"].get(model)
            if b is None:
                b = MicroBatcher(engine, **(batcher_opts or {}))
                state["batchers"][model] = b
            return b

    def get_realtime():
        with state_lock:
            if state["realtime"] is None:
                from facerecognition_tpu_torch.apps.realtime import RealtimeRecognizer

                engine = registry.get(state["realtime_model"])
                state["realtime"] = RealtimeRecognizer(engine, detector=registry.detector)
            return state["realtime"]

    def respond_json(start, payload, status="200 OK"):
        body = json.dumps(payload).encode()
        start(status, [("Content-Type", "application/json"), ("Content-Length", str(len(body)))])
        return [body]

    def respond_page(start, template, title, nav, status="200 OK", **ctx):
        page = render_page(template, title, nav, **ctx).encode()
        start(status, [("Content-Type", "text/html; charset=utf-8"),
                       ("Content-Length", str(len(page)))])
        return [page]

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        method = environ.get("REQUEST_METHOD", "GET")

        # Request-size guard: _parse_multipart buffers the whole body.
        if method == "POST" and _content_length(environ) > max_body_bytes:
            msg = (
                f"request body exceeds {max_body_bytes} byte "
                f"({max_body_bytes / (1 << 20):.0f} MB) limit"
            )
            if "text/html" in environ.get("HTTP_ACCEPT", ""):
                return respond_page(
                    start_response, "index.html", "Upload too large", "home",
                    status="413 Content Too Large", threshold="0.5",
                    results=f'<div class="result"><h3>Error</h3><p>{esc(msg)}</p></div>',
                )
            return respond_json(start_response, {"error": msg}, status="413 Content Too Large")

        # -- static assets (css/js) ---------------------------------------
        if path.startswith("/static/"):
            rel = path[len("/static/"):]
            full = os.path.abspath(os.path.join(STATIC_DIR, rel))
            # path-prefix guard, as the download route's
            if not full.startswith(STATIC_DIR + os.sep) or not os.path.isfile(full):
                return respond_json(start_response, {"error": "not found"}, "404 Not Found")
            ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
            with open(full, "rb") as f:
                data = f.read()
            start_response("200 OK", [("Content-Type", ctype), ("Content-Length", str(len(data))),
                                      ("Cache-Control", "no-cache")])
            return [data]

        # -- home: single image, 3-model compare --------------------------
        if path == "/":
            if method == "GET":
                return respond_page(start_response, "index.html", "Single image", "home",
                                    threshold="0.5")
            fields = _parse_multipart(environ)
            files = fields.get("image", [])
            if not files or not isinstance(files[0], dict):
                return respond_json(start_response, {"error": "no image uploaded"},
                                    "400 Bad Request")
            image = _decode_image(files[0]["data"])
            if image is None:
                return respond_json(start_response, {"error": "invalid image"}, "400 Bad Request")
            try:
                threshold = float((fields.get("threshold") or ["0.5"])[0])
            except ValueError:
                return respond_json(start_response, {"error": "invalid threshold"},
                                    "400 Bad Request")
            for m in ("arcface", "facenet"):
                eng = registry.get(m)
                if eng is not None:
                    eng.set_threshold(threshold)
            results = {m: recognize_with_model(registry, m, image) for m in MODELS}
            payload = {"results": results}
            if (fields.get("gradcam") or ["0"])[0] == "1":
                payload["gradcam"] = gradcam_overlays(registry, image)
            if "text/html" in environ.get("HTTP_ACCEPT", ""):
                cards = []
                for m, r in results.items():
                    ident = esc(r.get("identity", "?"))
                    cls = "id unknown" if ident in ("Unknown", "No face") else "id"
                    topk_rows = "".join(
                        f"<tr><td>{esc(n)}</td><td>{s:.4f}</td></tr>"
                        for n, s in r.get("top_k", [])[:5]
                    )
                    table = (
                        f"<table><tr><th>identity</th><th>score</th></tr>{topk_rows}</table>"
                        if topk_rows
                        else ""
                    )
                    msg = f"<div class=meta>{esc(r['message'])}</div>" if r.get("message") else ""
                    annotated = ""
                    if r.get("faces"):
                        annotated = (
                            '<br><img class=cam style="max-width:420px" '
                            f'src="data:image/png;base64,'
                            f'{_b64_png(draw_faces(image, r["faces"]))}">'
                        )
                        if len(r["faces"]) > 1:
                            face_rows = "".join(
                                f"<tr><td>{esc(f['identity'])}</td>"
                                f"<td>{f['confidence']:.4f}</td>"
                                f"<td>{f['det_score']:.2f}</td></tr>"
                                for f in r["faces"]
                            )
                            table += (
                                "<table><tr><th>face</th><th>confidence</th>"
                                f"<th>det score</th></tr>{face_rows}</table>"
                            )
                    cards.append(
                        f"<div class=result><h3>{m}</h3>"
                        f"<span class='{cls}'>{ident}</span> "
                        f"<span class=meta>confidence "
                        f"{r.get('confidence', 0):.4f} · "
                        f"{r.get('time_ms', 0):.1f} ms</span>"
                        f"{msg}{table}{annotated}</div>"
                    )
                cams = "".join(
                    f"<div class=result><h3>{m} class activation</h3>"
                    f'<img class=cam src="data:image/png;base64,{b64}"></div>'
                    for m, b64 in payload.get("gradcam", {}).items()
                )
                return respond_page(
                    start_response, "index.html", "Results", "home",
                    threshold=esc(threshold),
                    gradcam_checked="checked" if "gradcam" in payload else "",
                    results="".join(cards) + cams,
                )
            return respond_json(start_response, payload)

        # -- batch --------------------------------------------------------
        if path == "/batch":
            if method == "GET":
                return respond_page(start_response, "batch.html", "Batch", "batch")
            fields = _parse_multipart(environ)
            model = (fields.get("model") or ["arcface"])[0]
            files = [f for f in fields.get("images", []) if isinstance(f, dict)]
            images, names, failed = [], [], []
            for f in files:
                img = _decode_image(f["data"])
                if img is not None:
                    images.append(img)
                    names.append(f["filename"])
                else:
                    failed.append(f["filename"])  # report, don't drop
            engine = registry.get(model)
            if engine is None or model == "lbph":
                results = [recognize_with_model(registry, model, img) for img in images]
            else:
                t0 = time.perf_counter()
                batch = engine.recognize_batch(images)
                dt = (time.perf_counter() - t0) * 1e3 / max(len(images), 1)
                results = [
                    {
                        "model": model,
                        "status": r["status"],
                        "identity": r["identity"],
                        "confidence": r["confidence"],
                        "time_ms": dt,
                    }
                    for r in batch
                ]
            payload = {
                "results": [{"filename": n, **r} for n, r in zip(names, results)]
                + [
                    {"filename": n, "status": "error", "identity": "?", "message": "invalid image"}
                    for n in failed
                ]
            }
            if "text/html" in environ.get("HTTP_ACCEPT", ""):
                rows = "".join(
                    f"<tr><td>{esc(e['filename'])}</td>"
                    f"<td>{esc(e.get('identity', '?'))}"
                    f"</td><td>{e.get('confidence', 0):.4f}</td>"
                    f"<td>{e.get('time_ms', 0):.1f}</td></tr>"
                    for e in payload["results"]
                )
                table = (
                    f"<div class=result><h3>{esc(model)} · {len(names)} images"
                    "</h3><table><tr><th>file</th><th>identity</th>"
                    f"<th>confidence</th><th>ms/img</th></tr>{rows}</table>"
                    "</div>"
                )
                return respond_page(start_response, "batch.html", "Batch results", "batch",
                                    results=table)
            return respond_json(start_response, payload)

        if path == "/video" and method == "POST":
            # Offline video recognition: multipart field 'video' (a
            # Motion-JPEG AVI) + optional 'model', 'every_n', 'max_frames'.
            import tempfile

            from facerecognition_tpu_torch.apps.realtime import process_video

            fields = _parse_multipart(environ)
            files = [f for f in fields.get("video", []) if isinstance(f, dict)]
            if not files:
                return respond_json(start_response, {"error": "no video file uploaded"},
                                    status="400 Bad Request")
            model = (fields.get("model") or ["arcface"])[0]
            if model not in ("arcface", "facenet"):
                # LBPH has no detector / batched-embedding API
                return respond_json(start_response,
                                    {"error": f"model {model!r} does not support video"},
                                    status="400 Bad Request")
            engine = registry.get(model)
            if engine is None:
                return respond_json(start_response, {"error": f"model {model!r} not loaded"},
                                    status="503 Service Unavailable")

            def _int_field(name, default):
                raw = (fields.get(name) or [""])[0]
                try:
                    return int(raw) if str(raw).strip() else default
                except (TypeError, ValueError):
                    return None

            every_n = _int_field("every_n", 1)
            max_frames = _int_field("max_frames", 300)
            if every_n is None or max_frames is None:
                return respond_json(start_response,
                                    {"error": "every_n/max_frames must be integers"},
                                    status="400 Bad Request")
            max_frames = max(min(max_frames, 2000), 1)
            suffix = os.path.splitext(files[0]["filename"])[1] or ".avi"
            tmp = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
            try:
                tmp.write(files[0]["data"])
                tmp.close()
                try:
                    out = process_video(engine, tmp.name, every_n=max(every_n, 1),
                                        max_frames=max_frames)
                except FileNotFoundError:
                    return respond_json(start_response, {"error": "unreadable video file"},
                                        status="400 Bad Request")
            finally:
                try:
                    os.unlink(tmp.name)
                except OSError:
                    pass
            counts: dict[str, int] = {}
            timeline = []
            for r in out["results"]:
                ident = r.get("identity", "?")
                counts[ident] = counts.get(ident, 0) + 1
                timeline.append({"identity": ident,
                                 "confidence": round(float(r.get("confidence", 0)), 4)})
            return respond_json(start_response, {
                "model": model,
                "frames": out["frames"],
                "fps": round(out["fps"], 1),
                "identity_counts": dict(sorted(counts.items(), key=lambda kv: -kv[1])),
                "timeline": timeline,
            })

        # -- serving API: dynamic micro-batching ----------------------------
        if path == "/recognize" and method == "POST":
            # Concurrent requests coalesce into one fused detect → align →
            # embed → match call (apps/serving.MicroBatcher). Body: raw image
            # bytes, or multipart with one or more 'file'/'image' parts (N
            # frames per request → {'results': [...]}). Query: ?model=arcface.
            q = parse_qs(environ.get("QUERY_STRING", ""))
            model = (q.get("model") or ["arcface"])[0]
            if model not in ("arcface", "facenet"):
                return respond_json(start_response,
                                    {"error": f"model {model!r} does not support /recognize"},
                                    status="400 Bad Request")
            ctype = environ.get("CONTENT_TYPE", "")
            if ctype.startswith("multipart/"):
                fields = _parse_multipart(environ)
                bodies = [
                    f["data"]
                    for f in fields.get("file", []) + fields.get("image", [])
                    if isinstance(f, dict)
                ]
            else:
                bodies = [environ["wsgi.input"].read(_content_length(environ))]
            images = [_decode_image(d) for d in bodies]
            if not images or any(im is None for im in images):
                return respond_json(start_response,
                                    {"error": "no decodable image in request body"},
                                    status="400 Bad Request")
            batcher = get_batcher(model)
            if batcher is None:
                return respond_json(
                    start_response,
                    {"error": f"model {model!r} not servable (needs a "
                              "detector and an enrolled gallery)"},
                    status="503 Service Unavailable",
                )
            from facerecognition_tpu_torch.apps.serving import OverloadedError

            try:
                many = batcher.submit_many(images)
            except OverloadedError as exc:
                # bounded-queue load shedding: the client backs off
                return respond_json(start_response, {"error": str(exc), "retry": True},
                                    status="429 Too Many Requests")
            except TimeoutError as exc:
                return respond_json(start_response, {"error": f"recognition timed out: {exc}"},
                                    status="503 Service Unavailable")
            except Exception as exc:
                return respond_json(start_response, {"error": f"recognition failed: {exc}"},
                                    status="500 Internal Server Error")

            def strip(res: dict) -> dict:
                out = {k: v for k, v in res.items() if k != "embedding"}
                out["faces"] = [
                    {k: v for k, v in f.items() if k != "embedding"} for f in res.get("faces", [])
                ]
                return out

            if len(many) == 1:
                payload = strip(many[0])  # single-image shape
            else:
                payload = {"results": [strip(r) for r in many], "count": len(many)}
            payload["model"] = model
            payload["batching"] = batcher.stats()
            return respond_json(start_response, payload)

        # -- serving introspection ------------------------------------------
        if path in ("/stats", "/healthz") and method == "GET":
            dev = registry.device
            payload = {
                "status": "ok",
                "platform": "gpu" if dev.type == "cuda" else "cpu",
                "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "models": {},
            }
            # loaded engines only: a health poll never builds one
            for m, eng in list(registry._engines.items()):
                if eng is None or not hasattr(eng, "gallery"):
                    payload["models"][m] = {"loaded": eng is not None}
                    continue
                info = {
                    "loaded": True,
                    "gallery_size": len(eng.gallery),
                    "threshold": eng.threshold,
                    "match_kernel": getattr(eng, "match_kernel", None),
                }
                with state_lock:
                    b = state["batchers"].get(m)
                if b is not None:
                    info["batching"] = b.stats()
                payload["models"][m] = info
            return respond_json(start_response, payload)

        # -- realtime -----------------------------------------------------
        if path == "/realtime":
            return respond_page(start_response, "realtime.html", "Realtime", "realtime")

        if path == "/video_feed":
            rt = get_realtime()
            boundary = b"--frame"

            def stream():
                for jpeg in rt.frames():
                    yield boundary + b"\r\nContent-Type: image/jpeg\r\n\r\n" + jpeg + b"\r\n"

            start_response("200 OK", [("Content-Type", "multipart/x-mixed-replace; boundary=frame")])
            return stream()

        if path == "/realtime_result":
            rt = get_realtime()
            return respond_json(start_response, rt.result)

        if path == "/stop_camera" and method == "POST":
            with state_lock:
                if state["realtime"] is not None:
                    state["realtime"].stop()
                    state["realtime"] = None
            return respond_json(start_response, {"status": "stopped"})

        if path == "/set_realtime_model" and method == "POST":
            fields = _parse_multipart(environ)
            model = (fields.get("model") or ["arcface"])[0]
            if model not in ("arcface", "facenet"):
                return respond_json(start_response, {"error": f"unknown model {model}"},
                                    "400 Bad Request")
            engine = registry.get(model)
            if engine is None:
                return respond_json(start_response, {"error": f"model {model} not loaded"},
                                    "400 Bad Request")
            with state_lock:
                state["realtime_model"] = model
                if state["realtime"] is not None:
                    state["realtime"].engine = engine
            return respond_json(start_response, {"status": "ok", "model": model})

        # -- database builder --------------------------------------------
        if path == "/database-builder":
            return respond_page(start_response, "database_builder.html", "Database builder",
                                "builder")

        if path == "/database-builder/build" and method == "POST":
            fields = _parse_multipart(environ)
            dataset_dir = (fields.get("dataset_dir") or [""])[0]
            model_type = (fields.get("model_type") or ["arcface"])[0]
            if not dataset_dir or not os.path.isdir(dataset_dir):
                return respond_json(start_response,
                                    {"error": f"dataset_dir not found: {dataset_dir}"},
                                    "400 Bad Request")
            try:
                job = builder.create_job(model_type, dataset_dir)
            except ValueError as exc:
                return respond_json(start_response, {"error": str(exc)}, "400 Bad Request")
            # ArcFace and FaceNet galleries are embedded by the model the
            # app serves (the JAX app's job loads no checkpoint: random weights)
            engine = registry.get(model_type) if model_type != "lbph" else None
            builder.start_build(job, embedder=getattr(engine, "embedder", None),
                                detector=registry.detector)
            return respond_json(start_response, {"job_id": job.job_id})

        if path.startswith("/database-builder/status/"):
            job_id = path.rsplit("/", 1)[-1]
            job = builder.get_job(job_id)
            if job is None:
                return respond_json(start_response, {"error": "job not found"}, "404 Not Found")
            return respond_json(start_response, job.to_dict())

        if path.startswith("/database-builder/download/"):
            rel = path[len("/database-builder/download/"):]
            full = os.path.abspath(os.path.join(download_root, rel))
            if not os.path.isfile(full):
                # jobs report output_files as root-relative or absolute
                # paths: resolve those too, under the same prefix guard
                alt = os.path.abspath(rel)
                if os.path.isfile(alt):
                    full = alt
            if not full.startswith(download_root + os.sep):
                return respond_json(start_response, {"error": "forbidden"}, "403 Forbidden")
            if not os.path.isfile(full):
                return respond_json(start_response, {"error": "not found"}, "404 Not Found")
            ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
            with open(full, "rb") as f:
                data = f.read()
            start_response("200 OK", [("Content-Type", ctype), ("Content-Length", str(len(data)))])
            return [data]

        return respond_json(start_response, {"error": "not found"}, "404 Not Found")

    app.batcher = get_batcher  # the /recognize batcher of a model, for warmup()
    return app


def make_threaded_server(host: str, port: int, app: Callable):
    """A ``wsgiref`` server with a thread per request, so concurrent
    /recognize requests coalesce into micro-batches."""
    from socketserver import ThreadingMixIn
    from wsgiref.simple_server import WSGIServer, make_server

    class _ThreadedServer(ThreadingMixIn, WSGIServer):
        daemon_threads = True
        # socketserver's default listen backlog is 5: a concurrent client
        # burst would get connection resets before a request is read
        request_queue_size = 128

    return make_server(host, port, app, server_class=_ThreadedServer)


def warmup(registry: EngineRegistry, app: Callable) -> None:
    """Build the ArcFace and FaceNet engines and run ``embed_uint8`` and the
    fused buckets 1 and 8 once, so the first requests pay no kernel build.
    The buckets go through each servable model's /recognize batcher
    (``app`` is ``create_app``'s), whose dispatcher thread serves the
    requests: PyTorch keeps cuDNN's execution plans per thread and per
    shape, so buckets run on another thread would be planned again on the
    first requests. ``/stats`` counts the 9 blank frames as requests."""
    for m in ("arcface", "facenet"):
        eng = registry.get(m)
        if eng is None:
            continue
        size = eng.embedder.config.input_size
        eng.embedder.embed_uint8(np.zeros((1, size, size, 3), np.float32))
        if eng.detector is not None and len(eng.gallery) > 0:
            batcher = app.batcher(m)
            for bucket in (8, 1):
                batcher.submit_many([np.zeros((256, 256, 3), np.uint8)] * bucket)
            print(f"warmed {m} (incl. fused serving buckets 1/8 on the batcher thread)")
            continue
        print(f"warmed {m}")


def main(argv: Optional[list[str]] = None, ready: Optional[Callable] = None):
    """Serve the app. ``ready(server)``, when given, is called once the
    server is bound (its ``server_address`` holds the port)."""
    import argparse
    from wsgiref.simple_server import make_server

    from facerecognition_tpu_torch.inference.engine import MATCH_KERNELS

    parser = argparse.ArgumentParser(description="FaceRecognition web app (PyTorch/CUDA port)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--arcface-ckpt", default=None)
    parser.add_argument("--facenet-ckpt", default=None)
    parser.add_argument("--lbph-model", default=None)
    parser.add_argument("--gallery", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device; default: the CUDA card ('cpu' runs the plain path)")
    parser.add_argument(
        "--match-kernel",
        default="auto",
        choices=list(MATCH_KERNELS),
        help="gallery match path: stream = the streaming top-k kernel, "
        "int8 = 4x gallery capacity (scores ±1e-3)",
    )
    parser.add_argument(
        "--warmup",
        action="store_true",
        help="build the engines and kernels before serving",
    )
    parser.add_argument(
        "--threads",
        type=int,
        default=1,
        help="serve with a threaded WSGI server (>1) so concurrent "
        "/recognize requests coalesce into micro-batches; 1 = a sequential server",
    )
    args = parser.parse_args(argv)
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    device = resolve_device(args.device)
    # The detector is app wiring: recognize_all, face drawing, the fused
    # realtime path and aligned CAMs need it. Only a missing checkpoint file
    # leaves the app without one.
    try:
        detector = FaceDetector(confidence_threshold=0.5, device=device)
    except OSError as exc:
        print(f"warning: face detector unavailable ({exc})")
        detector = None
    registry = EngineRegistry(
        arcface_ckpt=args.arcface_ckpt,
        facenet_ckpt=args.facenet_ckpt,
        lbph_model_path=args.lbph_model,
        gallery_path=args.gallery,
        detector=detector,
        match_kernel=args.match_kernel,
        device=device,
    )
    app = create_app(registry)
    if args.warmup:
        warmup(registry, app)
    if args.threads > 1:
        server = make_threaded_server(args.host, args.port, app)
    else:
        server = make_server(args.host, args.port, app)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    if ready is not None:
        ready(server)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Render the port's image-file fixtures: a person-per-folder set of
synthetic faces as JPEG and PNG files, with each file's pixels as PIL reads
them.

Run from the repository root where the JAX package, PIL and cv2 are
installed (not on the card machine, which has no JAX):

    python3 make_torch_fixtures.py

It draws ``IDENTITIES`` identities with ``training.synthetic_faces.
sample_identity`` (seeded) and renders each ``len(KINDS)`` times with
``render_scene`` (one face, 128², the family the shipped detector and the
synthid9k embedders were trained on), one file of each kind: baseline JPEG
(4:2:0), progressive JPEG, gray JPEG and RGB PNG. It writes, under
``facerecognition_tpu_torch/fixtures/``:

- ``faces/id<i>/<k>_<kind>.<ext>``: the files;
- ``faces.json``: per file its shape and the SHA-256 of the RGB uint8
  array PIL's ``convert("RGB")`` gives (the JAX package's ``load_image``);
- ``faces_jpeg_pixels.npz``: those arrays in full for the JPEG files, for
  decoders whose IDCT differs from libjpeg's (nvJPEG) to be measured
  against;
- ``faces_clip.avi``: a Motion-JPEG AVI (``cv2.VideoWriter``, fourcc
  ``MJPG``) of ``CLIP_FRAMES`` 256² scenes, each with one face of a fixture
  identity (identity ``i % IDENTITIES`` in frame ``i``), at ``CLIP_FPS``;
- ``faces_clip.json`` and ``faces_clip_pixels.npz``: per frame the
  identity and the SHA-256 of its pixels as libjpeg decodes them, and
  those pixels for every ``CLIP_PIXELS_EVERY``-th frame;

- ``synthetic_scenes.npz`` and ``synthetic_scenes.json``: the procedural
  renderer's output for a seeded set (v3 and v4 scenes, one
  out-of-distribution scene per family and aligned identity samples,
  their pixels, boxes, landmarks, ``valid`` and which
  scenes took the JPEG step, and the generator state after each group;
  the set is ``facerecognition_tpu_torch.tools.scene_fixture.SPEC``), and
  the shipped ``detector_v4_128``'s ``evaluate_detector`` numbers on v3
  and v4 scenes at ``SPEC["evaluate"]``'s seed: the reference the port's
  renderer is held to on the card;

- ``evals.json``: the JAX evaluations' reports at the reduced sizes and
  seeds of ``facerecognition_tpu_torch.tools.eval_fixture.SPEC``
  (``write_evals``: ``scripts/ood_eval.py`` with the shipped
  ``detector_v4_128``, ``int8_agreement.py``, ``lbph_scale_eval.py`` and
  ``examples/compare_all_models.py`` on folders of ``render_id_folders.py``,
  each run as its own command line would run it); the port's drivers are
  held to them on the card;

and, under ``facerecognition_tpu_torch/apps/``, ``label_font.npz``: the
bitmap glyphs of printable ASCII that the web app draws its labels with,
rasterised from cv2's Hershey simplex font at scale 0.5, thickness 1.

    python3 make_torch_fixtures.py
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil

import numpy as np
from PIL import Image

from facerecognition_tpu.training.synthetic_faces import render_scene, sample_identity

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "facerecognition_tpu_torch", "fixtures")
IDENTITIES = 16
SIDE = 128
SEED = 20
CLIP_FRAMES, CLIP_SIDE, CLIP_FPS, CLIP_SEED = 32, 256, 12.0, 21
CLIP_PIXELS_EVERY = 8  # frames whose pixels are stored in full (the rest by digest)
FONT_PATH = os.path.join(os.path.dirname(ROOT), "apps", "label_font.npz")
KINDS = (
    ("baseline", "jpg", {"quality": 90}),
    ("progressive", "jpg", {"quality": 90, "progressive": True}),
    ("gray", "jpg", {"quality": 90}),
    ("rgb", "png", {}),
)


def encode(img: np.ndarray, kind: str, ext: str, options: dict) -> bytes:
    im = Image.fromarray(img)
    if kind == "gray":
        im = im.convert("L")
    buf = io.BytesIO()
    im.save(buf, format="JPEG" if ext == "jpg" else "PNG", **options)
    return buf.getvalue()


def pil_pixels(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def digest(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr, np.uint8).tobytes()).hexdigest()


def write_faces() -> list:
    """The face files, their digests and JPEG arrays; returns the drawn
    identities, so the clip shows the people of the files."""
    rng = np.random.default_rng(SEED)
    faces_dir = os.path.join(ROOT, "faces")
    shutil.rmtree(faces_dir, ignore_errors=True)
    index, jpeg_pixels, identities = {}, {}, []
    for i in range(IDENTITIES):
        ident = sample_identity(rng)
        identities.append(ident)
        person = f"id{i}"
        os.makedirs(os.path.join(faces_dir, person))
        for k, (kind, ext, options) in enumerate(KINDS):
            img, *_ = render_scene(rng, SIDE, max_faces=1, p_face=1.0, identities=[ident])
            data = encode(np.clip(img, 0, 255).astype(np.uint8), kind, ext, options)
            rel = f"faces/{person}/{k}_{kind}.{ext}"
            with open(os.path.join(ROOT, rel), "wb") as f:
                f.write(data)
            pixels = pil_pixels(data)
            index[rel] = {"shape": list(pixels.shape), "sha256": digest(pixels)}
            if ext == "jpg":
                jpeg_pixels[rel] = pixels
    with open(os.path.join(ROOT, "faces.json"), "w") as f:
        json.dump({"side": SIDE, "seed": SEED, "files": index}, f, indent=1, sort_keys=True)
    np.savez_compressed(os.path.join(ROOT, "faces_jpeg_pixels.npz"), **jpeg_pixels)
    return identities


def write_clip(identities: list) -> None:
    """The MJPEG AVI, its per-frame identities and libjpeg digests, and
    every ``CLIP_PIXELS_EVERY``-th decoded frame."""
    import cv2

    rng = np.random.default_rng(CLIP_SEED)
    path = os.path.join(ROOT, "faces_clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), CLIP_FPS, (CLIP_SIDE, CLIP_SIDE))
    assert writer.isOpened()
    for i in range(CLIP_FRAMES):
        img, *_ = render_scene(rng, CLIP_SIDE, max_faces=1, p_face=1.0,
                               identities=[identities[i % len(identities)]])
        writer.write(np.ascontiguousarray(np.clip(img, 0, 255).astype(np.uint8)[:, :, ::-1]))
    writer.release()
    # each frame as libjpeg decodes it (PIL), read from the file's chunks
    from facerecognition_tpu_torch.apps.realtime import avi_frames

    frames, names = {}, []
    with open(path, "rb") as f:
        data = f.read()
    for i, (offset, size) in enumerate(avi_frames(path)[2]):
        frames[f"frame{i:02d}"] = pil_pixels(data[offset:offset + size])
        names.append(f"id{i % len(identities)}")
    assert len(frames) == CLIP_FRAMES
    with open(os.path.join(ROOT, "faces_clip.json"), "w") as f:
        json.dump({"side": CLIP_SIDE, "fps": CLIP_FPS, "seed": CLIP_SEED, "identities": names,
                   "sha256": [digest(frames[k]) for k in sorted(frames)]}, f, indent=1)
    np.savez_compressed(os.path.join(ROOT, "faces_clip_pixels.npz"),
                        **{k: v for i, (k, v) in enumerate(sorted(frames.items()))
                           if i % CLIP_PIXELS_EVERY == 0})


def write_font() -> None:
    """Printable ASCII from cv2's Hershey simplex at scale 0.5, thickness 1
    (8-connected, not anti-aliased): glyph bitmaps on a common baseline and
    each character's advance."""
    import cv2

    font, scale = cv2.FONT_HERSHEY_SIMPLEX, 0.5
    (_, ascent), _ = cv2.getTextSize("Ag|", font, scale, 1)
    descent = max(cv2.getTextSize(c, font, scale, 1)[1] for c in "gjpqy|") + 1
    chars = [chr(c) for c in range(32, 127)]
    advances = [cv2.getTextSize(c * 2, font, scale, 1)[0][0] - cv2.getTextSize(c, font, scale, 1)[0][0]
                for c in chars]
    width = max(cv2.getTextSize(c, font, scale, 1)[0][0] for c in chars) + 2
    glyphs = np.zeros((len(chars), ascent + descent, width), bool)
    for i, c in enumerate(chars):
        canvas = np.zeros((ascent + descent, width), np.uint8)
        cv2.putText(canvas, c, (0, ascent), font, scale, 255, 1, cv2.LINE_8)
        glyphs[i] = canvas > 0
    np.savez_compressed(FONT_PATH, first=np.int32(32), baseline=np.int32(ascent),
                        advances=np.asarray(advances, np.int32), bits=np.packbits(glyphs, axis=-1),
                        width=np.int32(width))


def write_synthetic() -> None:
    """The renderer's fixture, rendered by the JAX package, and the shipped
    v4 detector's evaluation numbers on its scenes."""
    from facerecognition_tpu.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu.training import ood_faces, synthetic_faces
    from facerecognition_tpu.training.train_detector import evaluate_detector
    from facerecognition_tpu_torch.tools.scene_fixture import SPEC, render_set

    jpeg_calls: list = []
    cv2 = synthetic_faces.cv2
    real_imencode = cv2.imencode

    def imencode(*args, **kwargs):
        jpeg_calls.append(1)
        return real_imencode(*args, **kwargs)

    cv2.imencode = imencode  # ood_faces shares the module
    try:
        arrays, states = render_set(synthetic_faces, ood_faces, SPEC, jpeg_calls)
    finally:
        cv2.imencode = real_imencode
    np.savez_compressed(os.path.join(ROOT, "synthetic_scenes.npz"), **arrays)
    ev = SPEC["evaluate"]
    det = FaceDetector(weights=os.path.join(os.path.dirname(os.path.dirname(ROOT)), "assets",
                                            "detector_v4_128.msgpack"))
    evaluation = {
        r: evaluate_detector(det, n_scenes=ev["n_scenes"], seed=ev["seed"], max_faces=ev["max_faces"],
                             ranges=synthetic_faces.SCENE_RANGES[r])
        for r in ev["ranges"]
    }
    with open(os.path.join(ROOT, "synthetic_scenes.json"), "w") as f:
        json.dump({"spec": SPEC, "states": states, "detector_v4_128": evaluation}, f, indent=1)


def _run_script(rel: str, argv: list) -> None:
    """``python <rel> <argv>`` in this process: the top-level JAX scripts
    are not a package, and their ``main()`` reads ``sys.argv``."""
    import importlib.util
    import sys

    repo = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3], os.path.join(repo, rel))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = sys.argv
    sys.argv = [rel] + [str(a) for a in argv]
    try:
        module.main()
    finally:
        sys.argv = saved


def write_evals() -> None:
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from facerecognition_tpu_torch.tools.eval_fixture import FIXTURE, SPEC

    o, i8, lb, cm = SPEC["ood"], SPEC["int8"], SPEC["lbph"], SPEC["compare"]
    out = {"spec": SPEC}
    with tempfile.TemporaryDirectory(prefix="evals-") as tmp:
        path = os.path.join(tmp, "report.json")
        _run_script("scripts/ood_eval.py", ["--scenes", o["scenes"], "--ids", o["ids"], "--size", o["size"],
                                            "--weights", os.path.join("assets", o["weights"]), "--out", path])
        with open(path) as f:
            out["ood"] = json.load(f)
        _run_script("scripts/int8_agreement.py", ["--ids", i8["ids"], "--extend-to", i8["extend_to"],
                                                  "--seed", i8["seed"], "--batch", i8["batch"],
                                                  "--cache", "", "--out", path])
        with open(path) as f:
            out["int8"] = json.load(f)
        out["int8"]["checkpoint"] = os.path.basename(out["int8"]["checkpoint"])
        del out["int8"]["protocol"]
        d = os.path.join(tmp, "lbph")
        _run_script("scripts/render_id_folders.py", ["--out", d, "--n-ids", lb["n_ids"], "--per-id",
                                                     lb["train_per_id"] + lb["probe_per_id"],
                                                     "--size", lb["render_size"], "--seed", lb["seed"]])
        _run_script("scripts/lbph_scale_eval.py", ["--data-dir", d, "--n-ids", lb["n_ids"],
                                                   "--train-per-id", lb["train_per_id"],
                                                   "--probe-per-id", lb["probe_per_id"],
                                                   "--image-size", lb["image_size"], "--out", path])
        with open(path) as f:
            out["lbph"] = {k: v for k, v in json.load(f).items()
                           if k not in ("chi2_scan_qps", "probe_featurize_s", "train_s")}
        d = os.path.join(tmp, "compare")
        _run_script("scripts/render_id_folders.py", ["--out", d, "--n-ids", cm["n_ids"], "--per-id",
                                                     cm["per_id"], "--size", cm["size"], "--seed", cm["seed"]])
        _run_script("examples/compare_all_models.py", ["--data-dir", d, "--output", path,
                                                       "--max-images", cm["n_ids"] * cm["per_id"]])
        with open(path) as f:
            out["compare"] = {m: {k: v for k, v in row.items() if k != "ms_per_face"}
                              for m, row in json.load(f).items()}
    with open(FIXTURE, "w") as f:
        json.dump(out, f, indent=1)


def main() -> None:
    write_clip(write_faces())
    write_synthetic()
    write_evals()
    write_font()
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(ROOT) for n in ns)
    print(f"fixtures and font written; {total} bytes under {ROOT}")


if __name__ == "__main__":
    main()

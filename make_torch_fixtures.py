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
  against.
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


def main() -> None:
    rng = np.random.default_rng(SEED)
    faces_dir = os.path.join(ROOT, "faces")
    shutil.rmtree(faces_dir, ignore_errors=True)
    index, jpeg_pixels = {}, {}
    for i in range(IDENTITIES):
        ident = sample_identity(rng)
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
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(ROOT) for n in ns)
    print(f"{len(index)} files under {ROOT}: {total} bytes in all")


if __name__ == "__main__":
    main()

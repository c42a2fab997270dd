"""The procedural renderer's reference set: what it renders, and how the
port's renderer is held to the JAX renderer's pixels.

``make_torch_fixtures.py`` renders ``SPEC`` with the JAX package's
``synthetic_faces``/``ood_faces`` into ``fixtures/synthetic_scenes.npz``
(pixels, boxes, landmarks, ``valid``, the scenes that took the JPEG step)
and ``synthetic_scenes.json`` (the generator state after each group, and
the shipped ``detector_v4_128``'s ``evaluate_detector`` numbers). The CPU
tests and ``chip_smoke.py``'s ``synth`` phase render the same set with the
port's modules (``render_set``) and compare (``compare``) within the
renderer's bounds below; ROADMAP.md ("Known differences of the renderer")
says where they come from. Imports numpy only, so the JAX package can use
``render_set`` too.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fixtures")
NPZ = os.path.join(FIXTURES, "synthetic_scenes.npz")
JSON = os.path.join(FIXTURES, "synthetic_scenes.json")

SPEC = {
    "size": 64,
    "max_faces": 2,
    "scenes": [
        {"name": "v3", "ranges": "v3", "seed": 30, "batch": 8},
        {"name": "v4", "ranges": "v4", "seed": 31, "batch": 8},
    ],
    "ood_seed": 40,  # family i draws from default_rng(ood_seed + i)
    "aligned": {"seed": 50, "n": 8},  # identity i: sample_identity(default_rng(seed * 100003 + i))
    "evaluate": {"seed": 778, "n_scenes": 200, "max_faces": 2, "ranges": ["v3", "v4"]},
}

# The port's pixels against the JAX renderer's (levels of 0..255), as
# measured on the CPU over 1,000 scenes, 200 degradation scenes and 600
# aligned samples (the limits hold a margin over the largest seen):
GEOMETRY_ABS = 1e-4  # boxes and landmarks, px
NON_JPEG_MAX_ABS = 5e-4  # scenes without the JPEG step: blur/resize rounding (1.4e-4 seen)
JPEG_MAX_ABS = 48.0  # scenes with it: another encoder and decoder (34 seen)
JPEG_MEAN_ABS = 1.5  # their mean |difference| per scene (1.03 seen)
ALIGNED_MAX_ABS = 12.0  # aligned samples: the similarity's refinement (5.5 seen)
ALIGNED_MEAN_ABS = 3e-3  # their mean |difference| per sample (7.3e-4 seen)


def rng_state(rng: np.random.Generator) -> dict:
    """A PCG64 generator's state as plain ints (JSON-safe)."""
    st = rng.bit_generator.state
    return {"state": int(st["state"]["state"]), "inc": int(st["state"]["inc"]),
            "has_uint32": int(st["has_uint32"]), "uinteger": int(st["uinteger"])}


def render_set(sf, ood, spec: dict = SPEC, jpeg_calls: Optional[list] = None) -> tuple[dict, dict]:
    """Render ``spec`` with a package's ``synthetic_faces`` and ``ood_faces``
    modules: (arrays by name, generator states by group). ``jpeg_calls`` is
    a list the caller's JPEG step appends to; each scene's flag comes back
    in ``<group>_jpeg``."""
    size, max_faces = spec["size"], spec["max_faces"]
    arrays, states = {}, {}

    def jpeg_count() -> int:
        return len(jpeg_calls) if jpeg_calls is not None else 0

    for group in spec["scenes"]:
        rng = np.random.default_rng(group["seed"])
        flags = []
        render = sf.render_scene

        def flagged(*args, _render=render, **kwargs):
            before = jpeg_count()
            out = _render(*args, **kwargs)
            flags.append(jpeg_count() > before)
            return out

        sf.render_scene = flagged
        try:
            imgs, boxes, lms, valid = sf.scene_batch(
                rng, group["batch"], size, max_faces, ranges=sf.SCENE_RANGES[group["ranges"]]
            )
        finally:
            sf.render_scene = render
        name = group["name"]
        arrays.update({f"{name}_imgs": imgs, f"{name}_boxes": boxes, f"{name}_lms": lms,
                       f"{name}_valid": valid, f"{name}_jpeg": np.asarray(flags, bool)})
        states[name] = rng_state(rng)
    parts: dict = {"imgs": [], "boxes": [], "lms": [], "valid": [], "jpeg": []}
    for i, family in enumerate(ood.OOD_FAMILIES):
        rng = np.random.default_rng(spec["ood_seed"] + i)
        before = jpeg_count()
        out = ood.ood_render_scene(rng, size, family)
        for key, value in zip(("imgs", "boxes", "lms", "valid"), out):
            parts[key].append(value)
        parts["jpeg"].append(jpeg_count() > before)
        states[f"ood_{family}"] = rng_state(rng)
    arrays.update({f"ood_{k}": np.asarray(v) for k, v in parts.items()})
    al = spec["aligned"]
    samples = []
    for i in range(al["n"]):
        ident = sf.sample_identity(np.random.default_rng(al["seed"] * 100003 + i))
        rng = np.random.default_rng((al["seed"], i, 0))
        samples.append(sf.render_aligned_identity_sample(rng, ident, size))
        states[f"aligned_{i}"] = rng_state(rng)
    arrays["aligned_imgs"] = np.stack(samples)
    return arrays, states


def load() -> tuple[dict, dict]:
    """The committed fixture: (arrays, the JSON record)."""
    with np.load(NPZ) as z:
        arrays = {k: z[k] for k in z.files}
    with open(JSON) as f:
        return arrays, json.load(f)


def compare(ours: dict, states: dict, ref: dict, record: dict, extra_jpeg_abs: float = 0.0) -> dict:
    """Hold a render of ``SPEC`` to the reference: equal ``valid``, JPEG
    flags and generator states, geometry within ``GEOMETRY_ABS``, pixels
    within the bounds above (``extra_jpeg_abs`` added to the JPEG scenes'
    maximum, for a decoder whose IDCT differs from libjpeg's). Returns the
    measured worst cases; raises ``AssertionError`` naming the first
    failure."""
    out = {"non_jpeg_max_abs": 0.0, "jpeg_max_abs": 0.0, "jpeg_mean_abs": 0.0,
           "geometry_abs": 0.0, "aligned_max_abs": 0.0, "aligned_mean_abs": 0.0, "jpeg_scenes": 0}
    if states != record["states"]:
        bad = sorted(k for k in record["states"] if states.get(k) != record["states"][k])
        raise AssertionError(f"generator state differs after {bad}")
    for group in ["v3", "v4", "ood"]:
        for key in ("valid", "jpeg"):
            if not np.array_equal(ours[f"{group}_{key}"], ref[f"{group}_{key}"]):
                raise AssertionError(f"{group}: {key} differs")
        for key in ("boxes", "lms"):
            err = float(np.abs(ours[f"{group}_{key}"] - ref[f"{group}_{key}"]).max())
            out["geometry_abs"] = max(out["geometry_abs"], err)
            if err > GEOMETRY_ABS:
                raise AssertionError(f"{group}: {key} off by {err} px")
        for i, jpeg in enumerate(ref[f"{group}_jpeg"]):
            d = np.abs(ours[f"{group}_imgs"][i].astype(np.float64) - ref[f"{group}_imgs"][i])
            if jpeg:
                out["jpeg_scenes"] += 1
                out["jpeg_max_abs"] = max(out["jpeg_max_abs"], float(d.max()))
                out["jpeg_mean_abs"] = max(out["jpeg_mean_abs"], float(d.mean()))
                if d.max() > JPEG_MAX_ABS + extra_jpeg_abs or d.mean() > JPEG_MEAN_ABS:
                    raise AssertionError(f"{group} scene {i} (JPEG): max {d.max()} mean {d.mean()}")
            else:
                out["non_jpeg_max_abs"] = max(out["non_jpeg_max_abs"], float(d.max()))
                if d.max() > NON_JPEG_MAX_ABS:
                    raise AssertionError(f"{group} scene {i}: pixels off by {d.max()}")
    for i in range(len(ref["aligned_imgs"])):
        d = np.abs(ours["aligned_imgs"][i].astype(np.float64) - ref["aligned_imgs"][i])
        out["aligned_max_abs"] = max(out["aligned_max_abs"], float(d.max()))
        out["aligned_mean_abs"] = max(out["aligned_mean_abs"], float(d.mean()))
        if d.max() > ALIGNED_MAX_ABS or d.mean() > ALIGNED_MEAN_ABS:
            raise AssertionError(f"aligned sample {i}: max {d.max()} mean {d.mean()}")
    return out


def render_port(spec: dict = SPEC) -> tuple[dict, dict]:
    """``render_set`` with the port's renderer, its JPEG steps counted."""
    from facerecognition_tpu_torch.training import ood_faces, raster, synthetic_faces

    calls: list = []
    real = raster.jpeg_roundtrip

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    raster.jpeg_roundtrip = counted
    try:
        return render_set(synthetic_faces, ood_faces, spec, calls)
    finally:
        raster.jpeg_roundtrip = real

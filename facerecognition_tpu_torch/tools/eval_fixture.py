"""The evaluations' reference set at reduced size: what is run, and how the
port's numbers are held to the JAX package's.

``make_torch_fixtures.write_evals()`` runs the JAX evaluations
(``scripts/ood_eval.py``, ``int8_agreement.py``, ``lbph_scale_eval.py`` on
folders of ``render_id_folders.py``, ``examples/compare_all_models.py``) at
``SPEC``'s sizes and seeds in the sandbox and commits their reports as
``fixtures/evals.json``. ``run_reduced`` runs the port's drivers at the same
sizes and seeds (on the card in ``chip_smoke.py``'s ``evals`` phase, on the
CPU in ``tests/test_torch_evals.py``) and ``compare`` holds them to it:

- counts (recall hits, top-1 hits, int8 disagreements and correct top-1s)
  equal, or within ``JPEG_COUNT_SLACK`` where the renderer's JPEG step is in
  the scenes (every OOD and control row: another encoder, and nvJPEG on the
  card; ROADMAP "Known differences of the renderer") or the aligned
  samples' similarity fit moves pixels (the LBPH and comparison folders:
  up to 5.5 levels at a pixel, which can flip an LBP code);
- mean IoU, median landmark error, mean confidence and cosines within
  ``MEAN_TOL`` where the counts are equal (a scene that matches on one side
  only moves a mean of 16 by far more).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional


FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fixtures",
                       "evals.json")

SPEC = {
    "ood": {"scenes": 16, "ids": 16, "size": 256, "weights": "detector_v4_128.msgpack"},
    "int8": {"ids": 256, "extend_to": 16_384, "seed": 0, "batch": 512},
    "lbph": {"n_ids": 32, "train_per_id": 8, "probe_per_id": 2, "image_size": 100,
             "render_size": 160, "seed": 0},
    "compare": {"n_ids": 8, "per_id": 4, "size": 160, "seed": 1},
}

JPEG_COUNT_SLACK = 1
MEAN_TOL = 1e-3


def load() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


PARTS = ("ood", "int8", "lbph", "compare")


def run_reduced(device, workers: int = 8, parts=PARTS) -> dict:
    """The port's reports at ``SPEC``'s sizes, in the fixture's layout
    (``parts`` of them). The comparison matches through ``stream``: the
    ``stream_topk`` kernel on the card, the plain exact top-k on the CPU."""
    from facerecognition_tpu_torch.examples.compare_all_models import compare_models
    from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR
    from facerecognition_tpu_torch.scripts.int8_agreement import int8_report
    from facerecognition_tpu_torch.scripts.lbph_scale_eval import lbph_scale_report
    from facerecognition_tpu_torch.scripts.ood_eval import ood_report
    from facerecognition_tpu_torch.scripts.render_id_folders import render_id_folders

    quiet = lambda *_: None  # noqa: E731
    o, i8, lb, cm = SPEC["ood"], SPEC["int8"], SPEC["lbph"], SPEC["compare"]
    out = {}
    if "ood" in parts:
        out["ood"] = ood_report(o["scenes"], o["ids"], o["size"], os.path.join(ASSETS_DIR, o["weights"]),
                                device=device, log=quiet)
    if "int8" in parts:
        out["int8"] = int8_report(i8["ids"], i8["extend_to"], i8["batch"], i8["seed"], device=device,
                                  log=quiet)
    with tempfile.TemporaryDirectory(prefix="evals-") as tmp:
        if "lbph" in parts:
            d = os.path.join(tmp, "lbph")
            render_id_folders(d, lb["n_ids"], lb["train_per_id"] + lb["probe_per_id"], lb["render_size"],
                              lb["seed"], workers, log=None)
            out["lbph"] = lbph_scale_report(d, lb["n_ids"], lb["train_per_id"], lb["probe_per_id"],
                                            lb["image_size"], device=device, log=quiet)
        if "compare" in parts:
            d = os.path.join(tmp, "compare")
            render_id_folders(d, cm["n_ids"], cm["per_id"], cm["size"], cm["seed"], workers, log=None)
            out["compare"] = compare_models(d, max_images=cm["n_ids"] * cm["per_id"], match_kernel="stream",
                                            device=device)
    return out


def _count(ref_frac: float, ours_frac: float, n: int) -> tuple[int, int]:
    return round(ref_frac * n), round(ours_frac * n)


def compare(ref: dict, ours: dict) -> tuple[list[str], dict]:
    """(failures, the deltas by name) of ``ours`` against the fixture, over
    the parts ``ours`` holds."""
    fails: list[str] = []
    deltas: dict = {}

    def counts(name: str, a: int, b: int, slack: int) -> bool:
        deltas[name] = b - a
        if abs(b - a) > slack:
            fails.append(f"{name}: {b} against JAX's {a} (slack {slack})")
        return a == b

    def close(name: str, a: Optional[float], b: Optional[float]) -> None:
        if a is None or b is None:
            if a != b:
                fails.append(f"{name}: {b} against JAX's {a}")
            return
        deltas[name] = round(b - a, 6)
        if abs(b - a) > MEAN_TOL + 1e-9:
            fails.append(f"{name}: {b} against JAX's {a} (tolerance {MEAN_TOL})")

    if "ood" in ours:
        rd, od = ref["ood"]["detector"], ours["ood"]["detector"]
        for family, row in rd.items():
            n = row["scenes"]
            a, b = _count(row["recall@iou0.5"], od[family]["recall@iou0.5"], n)
            if counts(f"ood.{family}.hits", a, b, JPEG_COUNT_SLACK) and "mean_iou_matched" in row:
                for key in ("mean_iou_matched", "median_lm_err_frac", "mean_conf_matched"):
                    close(f"ood.{family}.{key}", row[key], od[family][key])
        re_, oe = ref["ood"]["embedder_ood_appearance"], ours["ood"]["embedder_ood_appearance"]
        if counts("ood.embedder.top1_hits", *_count(re_["top1"], oe["top1"], re_["probes"]), 0):
            close("ood.embedder.mean_genuine_cos", re_["mean_genuine_cos"], oe["mean_genuine_cos"])
    if "int8" in ours:
        for gallery in ("real_9k", "capacity_1m"):
            r, o = ref["int8"][gallery], ours["int8"][gallery]
            counts(f"int8.{gallery}.disagreements", r["disagreements"], o["disagreements"], 0)
            for key in ("f32_top1_correct_pct", "int8_top1_correct_pct"):
                counts(f"int8.{gallery}.{key[:-4]}_hits", *_count(r[key] / 100, o[key] / 100, r["probes"]), 0)
            close(f"int8.{gallery}.median_top1_margin", r["median_top1_margin"], o["median_top1_margin"])
    if "lbph" in ours:
        r, o = ref["lbph"], ours["lbph"]
        probes = r["n_ids"] * r["probe_per_id"]
        counts("lbph.top1_hits", *_count(r["top1"], o["top1"], probes), JPEG_COUNT_SLACK)
    if "compare" in ours:
        n = ref["spec"]["compare"]["n_ids"] * ref["spec"]["compare"]["per_id"]
        for model in ("arcface", "facenet", "lbph"):
            counts(f"compare.{model}.hits", *_count(ref["compare"][model]["accuracy"],
                                                    ours["compare"][model]["accuracy"], n),
                   JPEG_COUNT_SLACK)
    return fails, deltas

"""Out-of-distribution evaluation: detector recall/IoU and embedder top-1
on generator families held out of training.

Counterpart of ``scripts/ood_eval.py``. Per family of
``training/ood_faces``: N single-face scenes through ``FaceDetector.
detect_all`` (the ``detect_post`` kernel on the card) → recall at IoU 0.5
(ground truth clipped to the frame), mean matched IoU, median landmark
error (a fraction of the box's side), mean matched confidence; an
in-distribution control row on ``render_scene`` (seed 123). Embedder:
OOD-appearance identities rendered aligned (2 enrolled, 3 probes each) →
prototype top-1 over all of them with the serving-default ArcFace
(``default_arcface_checkpoint``, whose name the report records).

    python -m facerecognition_tpu_torch.scripts.ood_eval --out ood.json \
        [--scenes 200] [--ids 100] [--size 256] [--weights detector.msgpack]
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from facerecognition_tpu_torch.device import DeviceLike, resolve_device


def iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def eval_detector_family(det, family: str, n_scenes: int, size: int, seed: int = 0) -> dict:
    """One family's detector row (the JAX function's keys and rounding)."""
    from facerecognition_tpu_torch.training.ood_faces import ood_render_scene

    rng = np.random.default_rng(seed)
    hits, ious, lm_errs, confs = 0, [], [], []
    for _ in range(n_scenes):
        img, boxes, lms, _ = ood_render_scene(rng, size, family)
        gt = np.clip(boxes[0], 0, size)
        best, best_face = 0.0, None
        for f in det.detect_all(img):
            v = iou(np.clip(np.asarray(f["bbox"], np.float32), 0, size), gt)
            if v > best:
                best, best_face = v, f
        if best >= 0.5:
            hits += 1
            ious.append(best)
            confs.append(best_face["confidence"])
            bw = max(gt[2] - gt[0], gt[3] - gt[1])
            err = np.linalg.norm(np.asarray(best_face["landmarks"]) - lms[0], axis=1)
            lm_errs.append(float(np.median(err) / max(bw, 1e-9)))
    return {
        "scenes": n_scenes,
        "recall@iou0.5": round(hits / n_scenes, 4),
        "mean_iou_matched": round(float(np.mean(ious)), 4) if ious else None,
        "median_lm_err_frac": round(float(np.median(lm_errs)), 4) if lm_errs else None,
        "mean_conf_matched": round(float(np.mean(confs)), 4) if confs else None,
    }


def eval_control(det, n_scenes: int, size: int, seed: int = 123) -> dict:
    """The in-distribution control row: ``render_scene`` with one face."""
    from facerecognition_tpu_torch.training.synthetic_faces import render_scene

    rng = np.random.default_rng(seed)
    hits = 0
    for _ in range(n_scenes):
        img, boxes, _, _ = render_scene(rng, size, 1, 1.0)
        gt = np.clip(boxes[0], 0, size)
        if any(iou(np.clip(np.asarray(f["bbox"], np.float32), 0, size), gt) >= 0.5
               for f in det.detect_all(img)):
            hits += 1
    return {"scenes": n_scenes, "recall@iou0.5": round(hits / n_scenes, 4)}


def eval_embedder_ood(n_ids: int, enroll_per_id: int = 2, probe_per_id: int = 3, seed: int = 7,
                      device: DeviceLike = None, checkpoint: Optional[str] = None) -> dict:
    """Top-1 prototype identification over OOD-appearance identities with
    the serving-default ArcFace (or ``checkpoint``)."""
    from facerecognition_tpu_torch.inference.extract_embeddings import (
        default_arcface_checkpoint,
        load_arcface_model,
    )
    from facerecognition_tpu_torch.training.ood_faces import sample_identity_ood
    from facerecognition_tpu_torch.training.synthetic_faces import render_aligned_identity_sample

    ckpt = checkpoint or default_arcface_checkpoint()
    embedder = load_arcface_model(ckpt, device=device)
    rng = np.random.default_rng(seed)
    ids = [sample_identity_ood(rng) for _ in range(n_ids)]
    per = enroll_per_id + probe_per_id
    imgs = np.stack([render_aligned_identity_sample(rng, p, 112) for p in ids for _ in range(per)])
    embs = np.concatenate([embedder.embed_uint8(imgs[i : i + 128]) for i in range(0, len(imgs), 128)])
    embs = embs.reshape(n_ids, per, -1)
    protos = embs[:, :enroll_per_id].mean(1)
    protos /= np.maximum(np.linalg.norm(protos, axis=1, keepdims=True), 1e-9)
    probes = embs[:, enroll_per_id:].reshape(n_ids * probe_per_id, -1)
    scores = probes @ protos.T
    pred = scores.argmax(1)
    gt = np.repeat(np.arange(n_ids), probe_per_id)
    return {
        "n_ids": n_ids,
        "probes": int(len(gt)),
        "top1": round(float((pred == gt).mean()), 4),
        "mean_genuine_cos": round(float(scores[np.arange(len(gt)), gt].mean()), 4),
        "checkpoint": os.path.basename(ckpt),
    }


def ood_report(scenes: int = 200, ids: int = 100, size: int = 256, weights: Optional[str] = None,
               detector_only: bool = False, device: DeviceLike = None, log=print) -> dict:
    """The whole report: the control row, each family's row and the
    embedder's."""
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training.ood_faces import OOD_FAMILIES

    t0 = time.time()
    det = FaceDetector(weights=weights, confidence_threshold=0.5, device=device)
    report: dict = {"detector": {}, "size": size}
    if weights:
        report["detector_weights"] = os.path.basename(weights)
    report["detector"]["in_distribution_control"] = eval_control(det, scenes, size)
    for family in OOD_FAMILIES:
        report["detector"][family] = eval_detector_family(det, family, scenes, size)
        log(f"[ood +{time.time()-t0:.0f}s] {family}: {report['detector'][family]}")
    if not detector_only:
        report["embedder_ood_appearance"] = eval_embedder_ood(ids, device=device)
        log(f"[ood +{time.time()-t0:.0f}s] embedder: {report['embedder_ood_appearance']}")
    return report


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Out-of-distribution evaluation on the card")
    ap.add_argument("--scenes", type=int, default=200)
    ap.add_argument("--ids", type=int, default=100)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--out", required=True, help="output JSON")
    ap.add_argument("--weights", default=None, help="detector checkpoint (default: the shipped one)")
    ap.add_argument("--detector-only", action="store_true", help="skip the embedder eval")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    report = ood_report(args.scenes, args.ids, args.size, args.weights, args.detector_only, device)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()

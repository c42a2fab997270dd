"""Real-photo robustness matrix for the face detector.

Counterpart of ``scripts/detector_robustness.py``: one photograph through
rotation, scale, crop, lighting, JPEG quality, blur and occlusion, with the
detector's recall (best IoU >= 0.5 against the transformed ground-truth
box) and IoU per transform. The JAX script's transforms are OpenCV calls;
here they are ``training/raster`` (``csrc/raster.cpp``): ``warpAffine`` with
the reflect border (``warp_affine_u8_reflect``), ``resize`` ``INTER_AREA``
(``resize_area_u8``), ``GaussianBlur`` (``gaussian_blur_u8``), and the JPEG
cases through ``utils/imageio.encode_jpeg`` and the port's decoder. The
image is RGB here (the JAX script transforms OpenCV's BGR and converts each
case): every transform but JPEG treats the channels alike.

The photo (the JAX script's, the reference's test upload) is not in this
repository: ``--image`` names one (default: the path in
``tests/fixtures/anh1_gt.json``, whose ``bbox`` is the ground truth, as in
the JAX script); a missing file raises ``FileNotFoundError``.

    python -m facerecognition_tpu_torch.scripts.detector_robustness \\
        [--image PHOTO] [--weights assets/detector_v3_128.msgpack] [--threshold 0.5] [--device cpu]

Prints the markdown table and the JSON list of the JAX script.
"""

from __future__ import annotations

import json
import os

import numpy as np

from facerecognition_tpu_torch.device import resolve_device

GT_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "fixtures", "anh1_gt.json",
)


def ground_truth() -> tuple[str, np.ndarray]:
    """The photo's path and its hand-annotated box (x1, y1, x2, y2), float32."""
    with open(GT_FILE) as f:
        gt = json.load(f)
    return gt["image"], np.array(gt["bbox"], np.float32)


def iou(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix2 - ix1, 0.0) * max(iy2 - iy1, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def transform_box(box, m) -> np.ndarray:
    """Axis-aligned bounding box of an affine-transformed box."""
    corners = np.array([[box[0], box[1]], [box[2], box[1]], [box[0], box[3]], [box[2], box[3]]],
                       np.float32)
    pts = corners @ m[:, :2].T + m[:, 2]
    return np.array([pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()], np.float32)


def variants(img: np.ndarray, gt: np.ndarray):
    """Yield (group, name, image, gt_box) transform cases of an (H, W, 3)
    uint8 RGB image and its float32 box, in the JAX script's order."""
    from facerecognition_tpu_torch.data.native_decode import decode_mem
    from facerecognition_tpu_torch.training import raster
    from facerecognition_tpu_torch.utils.imageio import encode_jpeg

    h, w = img.shape[:2]
    yield "baseline", "original", img, gt
    # ±45° probes the v4 curriculum's rotation range; an axis-aligned box
    # of a rotated face grows, so IoU is lower at 45° even when exact
    for deg in (-45, -30, -15, 15, 30, 45):
        m = raster.rotation_matrix((w / 2, h / 2), deg, 1.0)
        yield "rotation", f"{deg:+d}°", raster.warp_affine_u8_reflect(img, m, (w, h)), transform_box(gt, m)
    for s in (0.3, 0.5, 2.0):
        yield "scale", f"{s}x", raster.resize_area_u8(img, (int(w * s), int(h * s))), gt * s
    # crops: keep the face but cut context (tight) / shift it off-centre
    cx1, cy1 = int(gt[0] * 0.5), int(gt[1] * 0.5)
    cx2 = int(min(gt[2] + 0.2 * (gt[2] - gt[0]), w))
    cy2 = int(min(gt[3] + 0.2 * (gt[3] - gt[1]), h))
    yield "crop", "tight", img[cy1:cy2, cx1:cx2], gt - [cx1, cy1, cx1, cy1]
    yield "crop", "left-quarter cut", img[:, w // 4:], gt - [w // 4, 0, w // 4, 0]
    for name, gain, bias in (("dark 0.4x", 0.4, 0), ("bright 1.6x", 1.6, 20), ("low-contrast", 0.5, 96)):
        yield "lighting", name, np.clip(img.astype(np.float32) * gain + bias, 0, 255).astype(np.uint8), gt
    for q in (50, 25, 10):
        yield "jpeg", f"q={q}", decode_mem(encode_jpeg(img, q)), gt
    for sigma in (2.0, 4.0):
        yield "blur", f"σ={sigma}", raster.gaussian_blur_u8(img, sigma), gt
    # occlusion: a gray bar over the eyes / lower face
    for name, (fy1, fy2) in (("eyes covered", (0.25, 0.45)), ("mouth covered", (0.65, 0.9))):
        out = img.copy()
        y1 = int(gt[1] + fy1 * (gt[3] - gt[1]))
        y2 = int(gt[1] + fy2 * (gt[3] - gt[1]))
        out[y1:y2, int(gt[0]):int(gt[2])] = 128
        yield "occlusion", name, out, gt


def evaluate(det, cases) -> list[dict]:
    """The JAX script's result row of each (group, name, image, gt) case."""
    results = []
    for group, name, im, gt in cases:
        dets = det.detect_all(np.ascontiguousarray(im))
        best_iou, best_conf = 0.0, 0.0
        for d in dets:
            i = iou(np.asarray(d["bbox"], np.float32), gt)
            if i > best_iou:
                best_iou, best_conf = i, float(d["confidence"])
        results.append(dict(group=group, name=name, detected=bool(best_iou >= 0.5),
                            iou=round(float(best_iou), 3), conf=round(float(best_conf), 3),
                            n_dets=len(dets)))
    return results


def report(results: list[dict]) -> str:
    """The JAX script's table, recall line and JSON."""
    lines = ["| group | transform | detected | IoU | conf | #dets |", "|---|---|---|---|---|---|"]
    for r in results:
        lines.append(f"| {r['group']} | {r['name']} | {'✓' if r['detected'] else '✗'} "
                     f"| {r['iou']:.2f} | {r['conf']:.2f} | {r['n_dets']} |")
    n_ok = sum(r["detected"] for r in results)
    lines.append(f"\nrecall@IoU0.5: {n_ok}/{len(results)}")
    lines.append(json.dumps(results))
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    import argparse

    from facerecognition_tpu_torch.data.native_decode import decode_mem
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

    photo, gt = ground_truth()
    ap = argparse.ArgumentParser(description="the detector's recall and IoU under transforms")
    ap.add_argument("--image", default=photo, help="the photo (default: the ground truth's)")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if not os.path.exists(args.image):
        raise FileNotFoundError(f"no photo at {args.image}")
    with open(args.image, "rb") as f:
        img = decode_mem(f.read(), args.image)
    det = FaceDetector(weights=args.weights, confidence_threshold=args.threshold, device=device)
    print(f"detector arch={det.arch} threshold={args.threshold}\n")
    results = evaluate(det, variants(img, gt))
    print(report(results), flush=True)
    return results


if __name__ == "__main__":
    main()

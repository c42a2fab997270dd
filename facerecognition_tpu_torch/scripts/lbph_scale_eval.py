"""LBPH at the reference's scale: closed-set top-1 at 1,000+ identities.

Counterpart of ``scripts/lbph_scale_eval.py``: over identity folders (from
``scripts/render_id_folders``), the first ``--train-per-id`` files of each
of the first ``--n-ids`` folders train ``models/lbph.LBPHModel`` (the
``lbph_hist`` kernel on the card) and the next ``--probe-per-id`` probe it;
each probe's label is its nearest training histogram by chi-square
(``chi2_nn``; the threshold off, cv2.face's semantics). Files are read as
``cv2.imread(..., IMREAD_GRAYSCALE)`` + ``cv2.resize`` read them
(``utils/imageio.load_gray``, then ``ops/image.bilinear_resize_u8``, OpenCV's
fixed-point bilinear, the images of one size as the channels of one call):
bit for bit. The times reported are
this run's own: the device's, not the JAX record's.

    python -m facerecognition_tpu_torch.scripts.lbph_scale_eval --data-dir ids \
        --out lbph.json [--n-ids 1000] [--train-per-id 8] [--probe-per-id 2]
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device
from facerecognition_tpu_torch.utils.imageio import load_gray

REFERENCE_9343ID_TOP1 = 0.0674


def resize_gray(images: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize`` of a stack of same-size gray images (N, H, W) to
    ``size``² in one call (the images as the channels of one frame)."""
    from facerecognition_tpu_torch.ops.image import bilinear_resize_u8

    if images.shape[1:] == (size, size):
        return images
    frame = torch.from_numpy(np.ascontiguousarray(images.transpose(1, 2, 0)))
    return bilinear_resize_u8(frame, size, size).numpy().transpose(2, 0, 1)


def load_split(data_dir: str, n_ids: int, train_per_id: int, probe_per_id: int, size: int,
               workers: int = 8):
    """(train images, train labels, probe images, probe labels) of the
    first ``n_ids`` folders: files decoded in ``workers`` threads, resized
    a shape at a time."""
    folders = sorted(os.listdir(data_dir))[:n_ids]
    need = train_per_id + probe_per_id
    jobs = []
    for lab, d in enumerate(folders):
        files = sorted(os.listdir(os.path.join(data_dir, d)))
        if len(files) < need:
            raise ValueError(f"{d}: {len(files)} < {need}")
        jobs += [(os.path.join(data_dir, d, f), lab, j < train_per_id) for j, f in enumerate(files[:need])]
    with ThreadPoolExecutor(max_workers=max(workers, 1)) as pool:
        grays = list(pool.map(lambda job: load_gray(job[0]), jobs))
    stack = np.empty((len(jobs), size, size), np.uint8)
    for shape in {g.shape for g in grays}:
        rows = [i for i, g in enumerate(grays) if g.shape == shape]
        for lo in range(0, len(rows), 512):  # 512 channels a call
            part = rows[lo : lo + 512]
            stack[part] = resize_gray(np.stack([grays[i] for i in part]), size)
    train = np.asarray([job[2] for job in jobs])
    labels = np.asarray([job[1] for job in jobs])
    return stack[train], labels[train], stack[~train], labels[~train]


def lbph_scale_report(data_dir: str, n_ids: int = 1000, train_per_id: int = 8,
                      probe_per_id: int = 2, image_size: int = 100, device: DeviceLike = None,
                      log=print) -> dict:
    from facerecognition_tpu_torch.models.lbph import LBPHModel

    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    train_imgs, train_labels, probe_imgs, probe_labels = load_split(
        data_dir, n_ids, train_per_id, probe_per_id, image_size)
    load_s = time.perf_counter() - t0
    log(f"loaded {len(train_imgs)} train / {len(probe_imgs)} probe images ({load_s:.1f}s)")
    model = LBPHModel(device=device)
    t1 = time.perf_counter()
    model.train(train_imgs, train_labels)
    sync()
    train_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    pred, _ = model.predict_batch(probe_imgs)
    predict_s = time.perf_counter() - t2
    n_hist, n_dim = model.histograms.shape
    return {
        "n_ids": n_ids,
        "train_per_id": train_per_id,
        "probe_per_id": probe_per_id,
        "image_size": image_size,
        "grid": [model.grid_x, model.grid_y],
        "gallery_histograms": int(n_hist),
        "hist_dim": int(n_dim),
        "top1": round(float((pred == probe_labels).mean()), 4),
        "top1_hits": int((pred == probe_labels).sum()),
        "load_s": round(load_s, 2),
        "train_s": round(train_s, 3),
        "predict_s": round(predict_s, 3),
        "probes_per_s": round(len(probe_imgs) / max(predict_s, 1e-9), 1),
        "reference_9343id_top1": REFERENCE_9343ID_TOP1,
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="LBPH closed-set top-1 at scale on the card")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--n-ids", type=int, default=1000)
    ap.add_argument("--train-per-id", type=int, default=8)
    ap.add_argument("--probe-per-id", type=int, default=2)
    ap.add_argument("--image-size", type=int, default=100)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    report = lbph_scale_report(args.data_dir, args.n_ids, args.train_per_id, args.probe_per_id,
                               args.image_size, resolve_device(args.device))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()

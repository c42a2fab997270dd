"""LBPH training from a directory, evaluation and the threshold search.

Counterpart of ``facerecognition_tpu/training/train_lbph.py``:

- ``load_faces_and_labels``: a person-per-folder directory (digit-aware
  label order, ``min_images``) as 100² gray faces, detected and cropped
  first when a detector is given;
- ``evaluate_lbph``: accuracy over the covered probes (distance below the
  threshold) and the coverage;
- ``find_optimal_threshold``: one prediction of every probe, then a sweep
  of thresholds for the best accuracy x coverage with coverage at least
  ``min_coverage``;
- ``write_threshold_to_config`` (``yaml`` is imported there only),
  ``train_lbph_from_directory`` and the ``main`` CLI:

    python -m facerecognition_tpu_torch.training.train_lbph <data_dir> --output-dir <dir>

The model's features come from the ``lbph_hist`` kernel and the nearest
rows from ``chi2_nn`` on the card (``device=None``), from their plain
versions on the CPU. The evaluation predicts with the model itself, its
threshold lifted (``_nearest``): the device gallery and its
``chi2_row_stats`` are never copied through the host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from facerecognition_tpu_torch.data.datasets import FolderDataset
from facerecognition_tpu_torch.device import DeviceLike
from facerecognition_tpu_torch.models.lbph import LBPHModel
from facerecognition_tpu_torch.models.lbph_tools import gray_face
from facerecognition_tpu_torch.utils.imageio import load_image

#: Thresholds ``find_optimal_threshold`` sweeps (chi-square distance).
THRESHOLDS = tuple(range(40, 121, 5))


def load_faces_and_labels(
    data_dir: str,
    image_size: int = 100,
    detector=None,
    min_images: int = 1,
) -> tuple[np.ndarray, np.ndarray, dict[int, str]]:
    """(images (N, size, size) float32 gray, labels (N,) int64, label map)
    of a person-per-folder directory. With a detector each face is detected
    and cropped with a 0.1 margin first (images without a face are
    skipped); without one each image is taken whole. Unreadable files are
    skipped."""
    index = FolderDataset(data_dir, min_images=min_images)
    images, labels = [], []
    for path, label in zip(index.paths, index.labels):
        try:
            img = load_image(path)
        except OSError:
            continue
        if detector is not None:
            img = detector.crop_face(img, margin=0.1, target_size=image_size)
            if img is None:
                continue
        images.append(gray_face(img, image_size))
        labels.append(int(label))
    label_map = {i: n for i, n in enumerate(index.label_names)}
    return np.stack(images), np.asarray(labels, np.int64), label_map


def _nearest(model: LBPHModel, images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(labels, distances) of each probe's nearest training row, whatever
    the model's threshold: predicted with the threshold lifted to infinity
    (and restored), so the model's device gallery and stats are used as
    they are, never copied."""
    saved = model.threshold
    model.threshold = float("inf")
    try:
        return model.predict_batch(images)
    finally:
        model.threshold = saved


def evaluate_lbph(
    model: LBPHModel,
    images: np.ndarray,
    labels: np.ndarray,
    threshold: float,
) -> dict:
    """Accuracy over the probes whose distance is below ``threshold``
    (covered; 0.0 when none is) and the covered fraction, with the raw
    predictions and distances."""
    pred_all, conf_all = _nearest(model, images)
    covered = conf_all < threshold
    n_cov = int(covered.sum())
    acc = float((pred_all[covered] == labels[covered]).mean()) if n_cov else 0.0
    return {
        "accuracy": acc,
        "coverage": n_cov / max(len(labels), 1),
        "n_covered": n_cov,
        "n_total": len(labels),
        "predictions": pred_all,
        "confidences": conf_all,
    }


def find_optimal_threshold(
    model: LBPHModel,
    images: np.ndarray,
    labels: np.ndarray,
    thresholds: Sequence[float] = THRESHOLDS,
    min_coverage: float = 0.3,
) -> tuple[float, dict, list[dict]]:
    """Predict once, then for each threshold the accuracy, coverage and
    their product; the best product among rows with coverage at least
    ``min_coverage`` (among all rows when none has). Returns
    (best threshold, best row, all rows)."""
    pred, conf = _nearest(model, images)
    results = []
    for thr in thresholds:
        covered = conf < thr
        n_cov = int(covered.sum())
        acc = float((pred[covered] == labels[covered]).mean()) if n_cov else 0.0
        cov = n_cov / max(len(labels), 1)
        results.append({"threshold": float(thr), "accuracy": acc, "coverage": cov,
                        "score": acc * cov})
    eligible = [r for r in results if r["coverage"] >= min_coverage]
    best = max(eligible or results, key=lambda r: r["score"])
    return best["threshold"], best, results


def write_threshold_to_config(config_path: str, threshold: float) -> None:
    """Set ``default_threshold`` in a YAML config (created when missing)."""
    import yaml

    config = {}
    if os.path.exists(config_path):
        with open(config_path) as f:
            config = yaml.safe_load(f) or {}
    config["default_threshold"] = float(threshold)
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)


def train_lbph_from_directory(
    data_dir: str,
    output_dir: str = "checkpoints/lbph",
    image_size: int = 100,
    radius: int = 1,
    neighbors: int = 8,
    grid_x: int = 8,
    grid_y: int = 8,
    detector=None,
    val_dir: Optional[str] = None,
    search_threshold: bool = True,
    config_path: Optional[str] = None,
    min_images: int = 1,
    device: DeviceLike = None,
) -> dict:
    """Train an ``LBPHModel`` on ``device`` from a person-per-folder
    directory and save ``lbph_model.npz`` and ``label_map.npy`` (a pickled
    dict) in ``output_dir``; with ``search_threshold``, search the threshold
    on ``val_dir`` (else on the training faces), set it on the model, write
    ``optimal_threshold.txt`` and, given ``config_path``, the YAML config.
    Returns counts, paths and the sweep."""
    images, labels, label_map = load_faces_and_labels(data_dir, image_size, detector, min_images)
    model = LBPHModel(radius, neighbors, grid_x, grid_y, device=device)
    model.train(images, labels)

    os.makedirs(output_dir, exist_ok=True)
    result = {
        "n_images": len(images),
        "n_identities": len(label_map),
        "model_path": os.path.join(output_dir, "lbph_model.npz"),
        "label_map_path": os.path.join(output_dir, "label_map.npy"),
    }
    np.save(result["label_map_path"], label_map, allow_pickle=True)

    if search_threshold:
        if val_dir:
            v_images, v_labels, _ = load_faces_and_labels(val_dir, image_size, detector)
        else:
            v_images, v_labels = images, labels
        thr, best, sweep = find_optimal_threshold(model, v_images, v_labels)
        model.threshold = thr
        result.update(optimal_threshold=thr, best=best, sweep=sweep)
        with open(os.path.join(output_dir, "optimal_threshold.txt"), "w") as f:
            f.write(f"{thr}\n")
        if config_path:
            write_threshold_to_config(config_path, thr)

    model.save(result["model_path"])
    return result


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Train LBPH from a person-per-folder directory")
    parser.add_argument("data_dir")
    parser.add_argument("--output-dir", default="checkpoints/lbph")
    parser.add_argument("--val-dir", default=None)
    parser.add_argument("--image-size", type=int, default=100)
    parser.add_argument("--config", default=None, help="YAML to write the threshold into")
    parser.add_argument("--no-threshold-search", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    result = train_lbph_from_directory(
        args.data_dir,
        args.output_dir,
        image_size=args.image_size,
        val_dir=args.val_dir,
        search_threshold=not args.no_threshold_search,
        config_path=args.config,
        device=args.device,
    )
    print(
        f"trained {result['n_identities']} identities / {result['n_images']} "
        f"images; threshold={result.get('optimal_threshold')}"
    )


if __name__ == "__main__":
    main()

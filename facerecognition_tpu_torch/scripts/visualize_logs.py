"""Training-log visualization and overfit analysis across merged runs.
Counterpart of ``facerecognition_tpu/scripts/visualize_logs.py``: merges
``training_history.json`` files (resumed runs), plots loss and accuracy
curves (host only: matplotlib, Agg, imported inside), and flags
overfitting (the validation metric falling while training improves).

    python -m facerecognition_tpu_torch.scripts.visualize_logs h1.json h2.json --output curves.png
"""

from __future__ import annotations

import json
import os
from typing import Sequence


def merge_histories(paths: Sequence[str]) -> list[dict]:
    """Concatenate histories by epoch; later files override duplicates
    (a resumed run re-logs its overlap)."""
    by_epoch: dict[int, dict] = {}
    for path in paths:
        with open(path) as f:
            for rec in json.load(f):
                by_epoch[int(rec.get("epoch", len(by_epoch)))] = rec
    return [by_epoch[e] for e in sorted(by_epoch)]


def analyze_overfit(
    history: Sequence[dict],
    train_key: str = "train_loss",
    val_key: str = "ver_acc",
    window: int = 5,
) -> dict:
    """Flag overfitting: train keeps improving while val degrades over the
    trailing window."""
    if len(history) < 2 * window:
        return {"overfitting": False, "reason": "history too short"}
    train = [r[train_key] for r in history if train_key in r]
    val = [r[val_key] for r in history if val_key in r]
    if len(train) < 2 * window or len(val) < 2 * window:
        return {"overfitting": False, "reason": "missing metrics"}
    train_improving = sum(train[-window:]) / window < sum(train[-2 * window : -window]) / window
    val_recent = sum(val[-window:]) / window
    val_before = sum(val[-2 * window : -window]) / window
    val_degrading = val_recent < val_before - 1e-6
    best_epoch = int(max(range(len(val)), key=lambda i: val[i]))
    return {
        "overfitting": bool(train_improving and val_degrading),
        "best_epoch": best_epoch,
        "best_val": float(val[best_epoch]),
        "val_trend": float(val_recent - val_before),
    }


def plot_history(history: Sequence[dict], output_path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [r.get("epoch", i) for i, r in enumerate(history)]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    for ax, keys, ylabel in ((axes[0], ("train_loss", "val_loss"), "loss"),
                             (axes[1], ("train_acc", "ver_acc"), "accuracy")):
        for key in keys:
            vals = [(e, r[key]) for e, r in zip(epochs, history) if key in r]
            if vals:
                ax.plot(*zip(*vals), label=key)
        ax.set_xlabel("epoch")
        ax.set_ylabel(ylabel)
        ax.legend()
    d = os.path.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Visualize training logs")
    parser.add_argument("histories", nargs="+", help="training_history.json files")
    parser.add_argument("--output", default="training_curves.png")
    args = parser.parse_args(argv)
    history = merge_histories(args.histories)
    plot_history(history, args.output)
    result = analyze_overfit(history)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()

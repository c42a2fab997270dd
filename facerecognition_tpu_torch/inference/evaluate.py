"""Evaluation: metrics, CMC, open-set identification, threshold sweep,
ROC/EER, plots, speed, the engine-level evaluation and the Markdown report.

Counterpart of ``facerecognition_tpu/inference/evaluate.py``. The metrics
are computed in numpy with sklearn's definitions (``compute_metrics``:
``zero_division=0``, averaged over the union of the labels of ``y_true``
and ``y_pred``; ``roc_eer``: ``roc_curve`` with ``drop_intermediate=True``
and a first threshold of ``inf``, its trapezoid ``auc``); the plots import
matplotlib inside the function (host only). The embeddings and the match
come from the port's engine on its device.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np


def _labels(y_true: np.ndarray, y_pred: np.ndarray) -> np.ndarray:
    return np.unique(np.concatenate([np.unique(y_true), np.unique(y_pred)]))


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den, 0 where den is 0 (``zero_division=0``)."""
    out = np.zeros(len(num), np.float64)
    nz = den != 0
    out[nz] = num[nz] / den[nz]
    return out


def compute_metrics(y_true, y_pred) -> dict:
    """Accuracy, and precision / recall / F1 averaged ``weighted`` (by each
    label's support in ``y_true``) and ``macro`` over the labels of either
    side; a ratio with a zero denominator counts 0, as sklearn's
    ``zero_division=0``."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    labels = _labels(y_true, y_pred)
    t = y_true[:, None] == labels[None, :]
    p = y_pred[:, None] == labels[None, :]
    tp = (t & p).sum(0).astype(np.float64)
    support = t.sum(0).astype(np.float64)
    predicted = p.sum(0).astype(np.float64)
    precision = _ratio(tp, predicted)
    recall = _ratio(tp, support)
    f1 = _ratio(2 * tp, 2 * tp + (predicted - tp) + (support - tp))
    out = {"accuracy": float(np.mean(y_true == y_pred))}
    for avg in ("weighted", "macro"):
        for name, values in (("precision", precision), ("recall", recall), ("f1", f1)):
            if avg == "macro":
                value = np.average(values)
            else:
                value = np.average(values, weights=support) if support.sum() else 0.0
            out[f"{name}_{avg}"] = float(value)
    return out


def top_k_accuracy(
    scores: np.ndarray, y_true: np.ndarray, ks: Sequence[int] = (1, 5)
) -> dict:
    """Top-k accuracy from a (N, C) score matrix: the fraction of rows
    whose true column is among their k highest."""
    order = np.argsort(-scores, axis=1)
    out = {}
    for k in ks:
        hits = (order[:, :k] == y_true[:, None]).any(axis=1)
        out[f"top_{k}_accuracy"] = float(hits.mean())
    return out


def cmc_curve(
    scores: np.ndarray, y_true: np.ndarray, max_rank: int = 20
) -> dict:
    """Cumulative Match Characteristic: P(correct id within top rank r).

    The standard closed-set identification curve (rank-1 == top-1
    accuracy). ``scores`` is the (N, C) query-vs-gallery score matrix with
    one column per gallery identity; ``y_true`` the correct column per row.
    The curve shows where the tail of near-misses sits as the gallery
    grows.
    """
    scores = np.asarray(scores)
    y_true = np.asarray(y_true)
    max_rank = min(max_rank, scores.shape[1])
    order = np.argsort(-scores, axis=1)[:, :max_rank]
    hit_at = order == y_true[:, None]  # (N, max_rank)
    cmc = hit_at.cumsum(axis=1).clip(max=1).mean(axis=0)
    return {
        "ranks": list(range(1, max_rank + 1)),
        "cmc": [float(v) for v in cmc],
        "rank1": float(cmc[0]),
        f"rank{max_rank}": float(cmc[-1]),
    }


def open_set_identification(
    scores: np.ndarray,
    y_true: np.ndarray,
    known_mask: np.ndarray,
    far_targets: Sequence[float] = (0.01, 0.001),
) -> dict:
    """Open-set identification: DIR@FAR (watchlist protocol).

    For probes of enrolled identities (``known_mask``), the Detection &
    Identification Rate is the fraction whose top-1 match is correct AND
    scores above threshold; for unenrolled probes, the False Accept Rate is
    the fraction wrongly accepted above threshold. Reports DIR at the
    thresholds achieving each target FAR — the operating numbers a
    deployment quotes.
    """
    scores = np.asarray(scores)
    y_true = np.asarray(y_true)
    known_mask = np.asarray(known_mask, bool)
    top1 = np.argmax(scores, axis=1)
    top1_score = scores[np.arange(len(scores)), top1]
    correct = (top1 == y_true) & known_mask

    unknown_scores = np.sort(top1_score[~known_mask])
    out = {}
    for far in far_targets:
        if len(unknown_scores) == 0:
            out[f"dir_at_far_{far:g}"] = None
            continue
        # smallest threshold with FAR <= target: the (1-far) quantile of
        # impostor top-1 scores
        k = int(np.ceil((1.0 - far) * len(unknown_scores)))
        thr = (
            unknown_scores[min(k, len(unknown_scores) - 1)]
            if k < len(unknown_scores)
            else unknown_scores[-1] + 1e-6
        )
        dir_rate = float((correct & (top1_score >= thr)).sum() / max(known_mask.sum(), 1))
        out[f"dir_at_far_{far:g}"] = dir_rate
        out[f"threshold_at_far_{far:g}"] = float(thr)
    return out


def threshold_sweep(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    scores: np.ndarray,
    known_mask: Optional[np.ndarray] = None,
    thresholds: Optional[np.ndarray] = None,
) -> dict:
    """Open-set threshold sweep.

    Below-threshold predictions become 'unknown' (-1); known/unknown split
    controls which ground truth counts as -1. Returns per-threshold rows +
    best-F1 and best-accuracy picks.
    """
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    scores = np.asarray(scores)
    if known_mask is None:
        known_mask = np.ones(len(y_true), bool)
    target = np.where(known_mask, y_true, -1)
    if thresholds is None:
        thresholds = np.linspace(scores.min(), scores.max(), 50)

    rows = []
    for thr in thresholds:
        pred = np.where(scores >= thr, y_pred, -1)
        acc = float((pred == target).mean())
        tp = float(((pred == target) & (pred != -1)).sum())
        fp = float(((pred != target) & (pred != -1)).sum())
        fn = float(((pred == -1) & (target != -1)).sum())
        prec = tp / max(tp + fp, 1e-12)
        rec = tp / max(tp + fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        rows.append(
            {
                "threshold": float(thr),
                "accuracy": acc,
                "precision": prec,
                "recall": rec,
                "f1": f1,
            }
        )
    best_f1 = max(rows, key=lambda r: r["f1"])
    best_acc = max(rows, key=lambda r: r["accuracy"])
    return {"sweep": rows, "best_f1": best_f1, "best_accuracy": best_acc}


def roc_curve(y_true, y_score) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) of a binary score, as sklearn's ``roc_curve``
    (labels 1 positive): one point per distinct score, descending; points
    collinear with both neighbours dropped; a first point (0, 0) at
    threshold ``inf``."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = y_score[idx]
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    return fps / fps[-1], tps / tps[-1], thresholds


def roc_eer(y_true_pairs: np.ndarray, pair_scores: np.ndarray) -> dict:
    """Verification ROC: area under it (trapezoids), the equal error rate
    at the kept point where |FNR - FPR| is least, and its threshold."""
    fpr, tpr, thr = roc_curve(y_true_pairs, pair_scores)
    fnr = 1 - tpr
    i = int(np.nanargmin(np.abs(fnr - fpr)))
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return {
        "auc": float(trapezoid(tpr, fpr)),
        "eer": float((fpr[i] + fnr[i]) / 2),
        "eer_threshold": float(thr[i]),
        "fpr": fpr,
        "tpr": tpr,
        "thresholds": thr,
    }


def plot_roc_curve(roc: dict, path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(roc["fpr"], roc["tpr"], label=f"AUC = {roc['auc']:.4f}")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.4)
    ax.scatter([roc["eer"]], [1 - roc["eer"]], c="r", zorder=5,
               label=f"EER = {roc['eer']:.4f}")
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("Verification ROC")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_confusion_matrix(
    y_true, y_pred, label_names: Sequence[str], path: str, max_classes: int = 20
) -> str:
    """Confusion matrix capped at the most frequent classes
    (at most ``max_classes``; host only: matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    top = [
        c for c, _ in sorted(
            zip(*np.unique(y_true, return_counts=True)),
            key=lambda t: -t[1],
        )[:max_classes]
    ]
    mask = np.isin(y_true, top)
    col = {c: j for j, c in enumerate(top)}
    cm = np.zeros((len(top), len(top)), np.int64)
    for t, p in zip(y_true[mask], y_pred[mask]):
        if p in col:
            cm[col[t], col[p]] += 1
    fig, ax = plt.subplots(figsize=(8, 7))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im)
    names = [label_names[c] if 0 <= c < len(label_names) else str(c) for c in top]
    ax.set_xticks(range(len(top)), names, rotation=90, fontsize=7)
    ax.set_yticks(range(len(top)), names, fontsize=7)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def measure_latency_throughput(
    engine, images: np.ndarray, batch_sizes: Sequence[int] = (1, 8, 32, 128)
) -> dict:
    """Single-image latency (mean of up to 16 one-image calls) and batched
    throughput (images/s) of the engine's embedder; each call returns numpy,
    so each timed call has finished on the device."""
    # single-stream latency
    engine.embedder.embed_uint8(images[:1])  # warm
    t0 = time.perf_counter()
    n = min(len(images), 16)
    for i in range(n):
        engine.embedder.embed_uint8(images[i : i + 1])
    lat_ms = (time.perf_counter() - t0) / n * 1e3

    thr = {}
    for bs in batch_sizes:
        if bs > len(images):
            continue
        batch = images[:bs]
        engine.embedder.embed_uint8(batch)  # warm/compile
        t0 = time.perf_counter()
        reps = max(1, 64 // bs)
        for _ in range(reps):
            engine.embedder.embed_uint8(batch)
        dt = (time.perf_counter() - t0) / reps
        thr[bs] = bs / dt
    return {
        "avg_latency_ms": lat_ms,
        "throughput_img_per_s": thr,
        "max_throughput": max(thr.values()) if thr else 0.0,
    }


def evaluate_recognition_engine(
    engine,
    images: np.ndarray,
    labels: np.ndarray,
    label_names: Sequence[str],
    output_dir: Optional[str] = None,
    measure_speed: bool = False,
) -> dict:
    """Engine-level evaluation: embeds the test set, matches it against the
    engine's gallery, computes closed-set metrics, top-k, CMC, open-set
    DIR@FAR, verification ROC/EER and the threshold sweep; optionally writes
    plots and measures speed."""
    embs = engine.embedder.embed_uint8(images.astype(np.float32))
    matches = engine.match(embs, k=5)
    name_to_id = {n: i for i, n in enumerate(label_names)}
    # Closed-set prediction = RAW top-1 gallery name (m[2][0][0]), not the
    # engine-thresholded m[0]: using the thresholded identity would fold
    # engine.threshold into accuracy AND make every sweep row below it a
    # forced miss (double thresholding). The open-set behavior is measured
    # separately by threshold_sweep over top_scores.
    y_pred = np.asarray(
        [
            name_to_id.get(m[2][0][0], -1) if m[2] else -1
            for m in matches
        ],
        np.int64,
    )
    top_scores = np.asarray([m[1] for m in matches])

    # full score matrix vs gallery for top-k: the device gallery, read once
    gal = engine.gallery.matrix.cpu().numpy()
    gal_ids = np.asarray(
        [name_to_id.get(n, -1) for n in engine.gallery.names]
    )
    scores_mat = embs @ gal.T  # (N, G)
    # map gallery columns to label ids
    by_label = np.full((len(images), len(label_names)), -np.inf)
    for col, lid in enumerate(gal_ids):
        if lid >= 0:
            by_label[:, lid] = np.maximum(by_label[:, lid], scores_mat[:, col])

    result = {
        "metrics": compute_metrics(labels, y_pred),
        **top_k_accuracy(by_label, labels),
        "threshold_sweep": threshold_sweep(labels, y_pred, top_scores),
        "cmc": cmc_curve(by_label, labels),
    }
    enrolled = set(gal_ids[gal_ids >= 0].tolist())
    known_mask = np.asarray([int(l) in enrolled for l in labels])
    if not known_mask.all() and known_mask.any():
        result["open_set"] = open_set_identification(
            by_label, labels, known_mask
        )

    # verification pairs from the test embeddings
    rng = np.random.default_rng(0)
    pair_scores, pair_truth = [], []
    for _ in range(min(2000, len(images) * 4)):
        i, j = rng.integers(0, len(images), 2)
        if i == j:
            continue
        pair_scores.append(float(embs[i] @ embs[j]))
        pair_truth.append(int(labels[i] == labels[j]))
    if len(set(pair_truth)) == 2:
        roc = roc_eer(np.asarray(pair_truth), np.asarray(pair_scores))
        result["verification"] = {
            "auc": roc["auc"],
            "eer": roc["eer"],
            "eer_threshold": roc["eer_threshold"],
        }
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            plot_roc_curve(roc, os.path.join(output_dir, "roc.png"))
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        plot_confusion_matrix(
            labels, y_pred, label_names, os.path.join(output_dir, "confusion.png")
        )
    if measure_speed:
        result["speed"] = measure_latency_throughput(engine, images)
    return result


def generate_report(results: dict, path: str, title: str = "Evaluation report") -> str:
    """Markdown report of ``evaluate_recognition_engine``'s results."""
    lines = [f"# {title}", ""]
    m = results.get("metrics", {})
    if m:
        lines += ["## Classification metrics", ""]
        lines += [f"| metric | value |", "|---|---|"]
        lines += [f"| {k} | {v:.4f} |" for k, v in m.items()]
        lines.append("")
    for k in ("top_1_accuracy", "top_5_accuracy"):
        if k in results:
            lines.append(f"- **{k}**: {results[k]:.4f}")
    cmc = results.get("cmc")
    if cmc:
        shown = [1, 5, 10, 20]
        pts = ", ".join(
            f"rank-{r}: {cmc['cmc'][r - 1]:.4f}"
            for r in shown
            if r <= len(cmc["cmc"])
        )
        lines += ["", "## Identification (CMC)", "", f"- {pts}"]
    osr = results.get("open_set")
    if osr:
        lines += ["", "## Open-set identification", ""]
        lines += [
            f"- DIR@FAR={k.split('_')[-1]}: {v:.4f}"
            for k, v in osr.items()
            if k.startswith("dir_at_far") and v is not None
        ]
    v = results.get("verification")
    if v:
        lines += [
            "",
            "## Verification",
            "",
            f"- AUC: {v['auc']:.4f}",
            f"- EER: {v['eer']:.4f} @ threshold {v['eer_threshold']:.4f}",
        ]
    ts = results.get("threshold_sweep")
    if ts:
        bf = ts["best_f1"]
        lines += [
            "",
            "## Threshold sweep",
            "",
            f"- best F1 {bf['f1']:.4f} @ threshold {bf['threshold']:.4f}",
            f"- best accuracy {ts['best_accuracy']['accuracy']:.4f} @ "
            f"threshold {ts['best_accuracy']['threshold']:.4f}",
        ]
    sp = results.get("speed")
    if sp:
        lines += [
            "",
            "## Speed",
            "",
            f"- avg latency: {sp['avg_latency_ms']:.2f} ms",
            f"- max throughput: {sp['max_throughput']:.0f} img/s",
        ]
    text = "\n".join(lines) + "\n"
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path

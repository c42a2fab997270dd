"""Model evaluation driver: embed a labelled test set, match it against a
prototype gallery, and report top-k, ROC/EER, the threshold sweep and
(optionally) latency, as JSON, markdown and plots.

Counterpart of ``examples/evaluate_model.py``: a folder-per-identity test
set (``FolderDataset``, at least 2 images each; PIL's bilinear resize),
each identity enrolled in a ``RecognitionEngine``'s gallery as the mean of
the first half of its images, then ``inference/evaluate.
evaluate_recognition_engine`` and ``generate_report``. ``evaluate_model``
takes the engine's ``match_kernel`` (``auto`` from the command line, as
JAX; ``stream`` matches with the ``stream_topk`` kernel on the card: the
same exact top-k) and can leave the plots out.

    python -m facerecognition_tpu_torch.examples.evaluate_model --model arcface \
        --data-dir test --checkpoint ckpt.msgpack --output-dir eval_out
"""

from __future__ import annotations

import json
import os

import numpy as np

from facerecognition_tpu_torch.device import resolve_device


def evaluate_model(data_dir: str, model: str = "arcface", checkpoint=None, output_dir: str = "eval_out",
                   max_images=None, measure_speed: bool = False, match_kernel: str = "auto",
                   plots: bool = True, device=None) -> dict:
    """The results of ``main``, written to ``output_dir`` (``results.json``,
    ``report.md``, and the plots unless ``plots`` is false: they need
    matplotlib)."""
    from facerecognition_tpu_torch.inference.engine import RecognitionEngine
    from facerecognition_tpu_torch.inference.evaluate import (
        evaluate_recognition_engine,
        generate_report,
    )
    from facerecognition_tpu_torch.scripts.facenet_ab_eval import load_folder

    device = resolve_device(device)
    size = 112 if model == "arcface" else 160
    index, images, labels = load_folder(data_dir, size, max_images)
    engine = RecognitionEngine(model_type=model, checkpoint_path=checkpoint, threshold=0.3,
                               match_kernel=match_kernel, device=device)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        embs = engine.embedder.embed_uint8(images[idx[: max(len(idx) // 2, 1)]].astype(np.float32))
        engine.gallery.add(index.label_names[int(c)], embs.mean(0))
    results = evaluate_recognition_engine(
        engine, images, labels, index.label_names,
        output_dir=output_dir if plots else None,
        measure_speed=measure_speed,
    )
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    generate_report(results, os.path.join(output_dir, "report.md"), title=f"{model} evaluation")
    return results


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Evaluate one recognition model on the card")
    parser.add_argument("--model", choices=["arcface", "facenet"], default="arcface")
    parser.add_argument("--checkpoint", default=None, help="weights (none: random, as JAX)")
    parser.add_argument("--data-dir", required=True, help="person-per-folder test set")
    parser.add_argument("--output-dir", default="eval_out")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--measure-speed", action="store_true")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    results = evaluate_model(args.data_dir, args.model, args.checkpoint, args.output_dir, args.max_images,
                             args.measure_speed, device=resolve_device(args.device))
    print(json.dumps(results.get("metrics", {}), indent=2))
    for k in ("top_1_accuracy", "top_5_accuracy"):
        if k in results:
            print(f"{k}: {results[k]:.4f}")
    return results

if __name__ == "__main__":
    main()

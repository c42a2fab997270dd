"""Train detector v3: DenseDetNet on the scene curriculum, then Platt
calibration. Counterpart of ``scripts/train_detector_v3.py``: the same
flags and defaults, over ``training/train_detector``
(``train_detector_curriculum`` with ``arch="dense"``, ``max_faces=2``;
``evaluate_detector``; ``fit_score_calibration``). The checkpoint is saved
(``utils/serialization.save_variables``, ``arch`` marker) before any
evaluation, then again with its ``calibration``. ``--out`` is required:
the JAX script's default is the shipped ``assets/`` file.

    python -m facerecognition_tpu_torch.scripts.train_detector_v3 --out detector_v3.msgpack
"""

from __future__ import annotations

import json
import time
import warnings
from typing import Optional

from facerecognition_tpu_torch.device import resolve_device

#: The JAX scripts' fixed sizes: held-out evaluation scenes (at threshold
#: 0.3, and at 0.5 once calibrated) and the calibration's scenes.
EVAL_SCENES = 250
CAL_SCENES = 300


def save_detector(out: str, variables: dict, calibration: Optional[tuple] = None) -> None:
    """A DenseDetNet serving checkpoint: params, the ``arch`` marker, and
    the Platt ``calibration`` (a, b) when given."""
    from facerecognition_tpu_torch.utils.serialization import save_variables

    tree = {"params": variables["params"], "arch": "dense"}
    if calibration is not None:
        tree["calibration"] = {"a": calibration[0], "b": calibration[1]}
    save_variables(out, tree)


def load_warm_start(path: str) -> dict:
    """A detector checkpoint's params, its ``arch`` and ``calibration``
    dropped, for ``init_variables``."""
    from facerecognition_tpu_torch.utils.serialization import load_variables

    init = load_variables(path)
    init.pop("calibration", None)
    init.pop("arch", None)
    return init


def calibrate(out: str, variables: dict, device, n_scenes: int, ranges=None, log=print) -> tuple:
    """Fit the Platt calibration of the saved checkpoint at threshold 0.3
    and save it again with it; returns (a, b)."""
    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training.train_detector import fit_score_calibration

    with warnings.catch_warnings():  # the uncalibrated file warns, as it should
        warnings.simplefilter("ignore")
        det = FaceDetector(weights=out, confidence_threshold=0.3, device=device)
    a, b = fit_score_calibration(det, n_scenes=n_scenes, ranges=ranges)
    log(f"calibration: a={a:.4f} b={b:.4f}")
    save_detector(out, variables, (a, b))
    log(f"saved (calibrated) -> {out}")
    return a, b


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Train the v3 detector on the card")
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.training.train_detector import (
        CurriculumConfig,
        evaluate_detector,
        train_detector_curriculum,
    )

    t0 = time.time()
    config = CurriculumConfig(steps=args.steps, batch_size=args.batch, lr=args.lr, arch="dense",
                              max_faces=2)
    variables, _ = train_detector_curriculum(
        config, log_every=250, device=device,
        progress=lambda s, l: print(f"step {s}: loss {l:.4f} ({time.time()-t0:.0f}s)", flush=True),
    )
    save_detector(args.out, variables)
    print(f"saved (uncalibrated) -> {args.out}", flush=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        det = FaceDetector(weights=args.out, confidence_threshold=0.3, device=device)
    quality = evaluate_detector(det, n_scenes=EVAL_SCENES)
    print("held-out quality:", json.dumps(quality), flush=True)
    calibration = calibrate(args.out, variables, device, CAL_SCENES)
    det2 = FaceDetector(weights=args.out, confidence_threshold=0.5, device=device)
    q2 = evaluate_detector(det2, n_scenes=EVAL_SCENES, seed=778)
    print("calibrated@0.5 quality:", json.dumps(q2), flush=True)
    print(f"total {time.time()-t0:.0f}s", flush=True)
    return {"quality": quality, "calibration": calibration, "calibrated_quality": q2}


if __name__ == "__main__":
    main()

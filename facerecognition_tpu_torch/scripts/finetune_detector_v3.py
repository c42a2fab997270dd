"""Fine-tune detector v3 on the widened face-fraction curriculum.

Counterpart of ``scripts/finetune_detector_v3.py``: warm start from
``--ckpt``, a short curriculum run at a low lr (``arch="dense"``,
``max_faces=2``), the uncalibrated checkpoint saved, evaluated at
threshold 0.3, calibrated and saved again. The JAX script rewrites its
``--ckpt`` in place (the shipped ``assets/`` file by default); here the
output is ``--out``, required, and may be the same path.

    python -m facerecognition_tpu_torch.scripts.finetune_detector_v3 \
        --ckpt assets/detector_v3_128.msgpack --out detector_v3_ft.msgpack
"""

from __future__ import annotations

import json
import os
import time
import warnings

from facerecognition_tpu_torch.device import resolve_device
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Fine-tune the v3 detector on the card")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--ckpt", default=os.path.join(ASSETS_DIR, "detector_v3_128.msgpack"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector
    from facerecognition_tpu_torch.scripts.train_detector_v3 import (
        CAL_SCENES,
        EVAL_SCENES,
        calibrate,
        load_warm_start,
        save_detector,
    )
    from facerecognition_tpu_torch.training.train_detector import (
        CurriculumConfig,
        evaluate_detector,
        train_detector_curriculum,
    )

    t0 = time.time()
    config = CurriculumConfig(steps=args.steps, lr=args.lr, arch="dense", max_faces=2)
    variables, _ = train_detector_curriculum(
        config, log_every=250, device=device, init_variables=load_warm_start(args.ckpt),
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
    print(f"total {time.time()-t0:.0f}s", flush=True)
    return {"quality": quality, "calibration": calibration}


if __name__ == "__main__":
    main()

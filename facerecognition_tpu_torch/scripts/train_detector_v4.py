"""Train detector v4: the v3 net fine-tuned on the widened (v4) curriculum.

Counterpart of ``scripts/train_detector_v4.py``: warm start from
``--init`` (its calibration and ``arch`` dropped), ``train_detector_
curriculum`` with ``arch="dense"``, ``max_faces=2`` and ``--ranges`` (v4,
or v3+v4 for the per-scene mix), the uncalibrated checkpoint saved first,
the Platt calibration fitted on scenes of the training envelope, then the
calibrated detector at threshold 0.5 evaluated on v3 and v4 scenes (seed
778). ``--out`` is required (the JAX script's default is the shipped
``assets/`` file).

    python -m facerecognition_tpu_torch.scripts.train_detector_v4 \
        --init assets/detector_v3_128.msgpack --out detector_v4.msgpack
"""

from __future__ import annotations

import json
import os
import time

from facerecognition_tpu_torch.device import resolve_device
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Fine-tune the v4 detector on the card")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=7e-4)
    ap.add_argument("--init", default=os.path.join(ASSETS_DIR, "detector_v3_128.msgpack"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--ranges", default="v4",
                    help="training envelope: v4, or v3+v4 (per-scene 50/50 consolidation mix)")
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
    from facerecognition_tpu_torch.training.synthetic_faces import RANGES_V4, SCENE_RANGES
    from facerecognition_tpu_torch.training.train_detector import (
        CurriculumConfig,
        evaluate_detector,
        train_detector_curriculum,
    )

    t0 = time.time()
    config = CurriculumConfig(steps=args.steps, batch_size=args.batch, lr=args.lr, arch="dense",
                              max_faces=2, ranges=args.ranges)
    variables, _ = train_detector_curriculum(
        config, log_every=250, device=device, init_variables=load_warm_start(args.init),
        progress=lambda s, l: print(f"step {s}: loss {l:.4f} ({time.time()-t0:.0f}s)", flush=True),
    )
    save_detector(args.out, variables)
    print(f"saved (uncalibrated) -> {args.out}", flush=True)
    calibration = calibrate(args.out, variables, device, CAL_SCENES,
                            ranges=SCENE_RANGES[args.ranges])
    det = FaceDetector(weights=args.out, confidence_threshold=0.5, device=device)
    q_v3 = evaluate_detector(det, n_scenes=EVAL_SCENES, seed=778)
    print("calibrated@0.5, v3 envelope:", json.dumps(q_v3), flush=True)
    q_v4 = evaluate_detector(det, n_scenes=EVAL_SCENES, seed=778, ranges=RANGES_V4)
    print("calibrated@0.5, v4 envelope:", json.dumps(q_v4), flush=True)
    print(f"total {time.time()-t0:.0f}s", flush=True)
    return {"calibration": calibration, "v3": q_v3, "v4": q_v4}


if __name__ == "__main__":
    main()

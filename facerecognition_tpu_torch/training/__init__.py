"""Training entry points of the port: the ArcFace, FaceNet and LBPH trainers.

The JAX package's names (its ``__all__``). ``ArcFaceTrainState`` is the
flax ``TrainState`` with ``batch_stats`` over the port's module
(``training.steps``); the trainers keep ``training.steps.TrainState`` (the
model, its ``OptaxChain`` and the update count), of which it is a kind.

The names are imported at first use (``__getattr__``), so importing one
module of the package does not import the others.
"""

import importlib

_EXPORTS = {
    "CurriculumConfig": "facerecognition_tpu_torch.training.train_detector",
    "evaluate_detector": "facerecognition_tpu_torch.training.train_detector",
    "fit_score_calibration": "facerecognition_tpu_torch.training.train_detector",
    "identity_dataset": "facerecognition_tpu_torch.training.synthetic_faces",
    "render_scene": "facerecognition_tpu_torch.training.synthetic_faces",
    "sample_identity": "facerecognition_tpu_torch.training.synthetic_faces",
    "scene_batch": "facerecognition_tpu_torch.training.synthetic_faces",
    "train_detector_curriculum": "facerecognition_tpu_torch.training.train_detector",
    "ArcFaceTrainState": "facerecognition_tpu_torch.training.steps",
    "make_arcface_train_step": "facerecognition_tpu_torch.training.steps",
    "make_arcface_eval_step": "facerecognition_tpu_torch.training.steps",
    "make_facenet_train_step": "facerecognition_tpu_torch.training.steps",
    "softmax_cross_entropy": "facerecognition_tpu_torch.training.steps",
    "load_config": "facerecognition_tpu_torch.training.config",
    "deep_merge": "facerecognition_tpu_torch.training.config",
    "EarlyStopping": "facerecognition_tpu_torch.training.schedules",
    "ReduceOnPlateau": "facerecognition_tpu_torch.training.schedules",
    "build_schedule": "facerecognition_tpu_torch.training.schedules",
    "CheckpointManager": "facerecognition_tpu_torch.training.checkpoint",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

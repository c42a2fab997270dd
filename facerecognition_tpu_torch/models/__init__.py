"""models of the PyTorch/CUDA port (see the package docstring).

The names are imported at first use (``__getattr__``), so importing one
module of the package does not import the others.
"""

import importlib

_EXPORTS = {
    "MobileFaceNet": "facerecognition_tpu_torch.models.mobilefacenet",
    "MobileFaceNetArcFace": "facerecognition_tpu_torch.models.mobilefacenet",
    "BlazeFaceNet": "facerecognition_tpu_torch.models.detector_net",
    "ResNet50Backbone": "facerecognition_tpu_torch.models.resnet",
    "ArcFaceModel": "facerecognition_tpu_torch.models.arcface",
    "ArcMarginProduct": "facerecognition_tpu_torch.models.arcface",
    "arc_margin_logits": "facerecognition_tpu_torch.models.arcface",
    "freeze_mask": "facerecognition_tpu_torch.models.arcface",
    "InceptionResnetV1": "facerecognition_tpu_torch.models.inception_resnet_v1",
    "FaceNetModel": "facerecognition_tpu_torch.models.facenet",
    "triplet_loss": "facerecognition_tpu_torch.models.facenet",
    "LBPHModel": "facerecognition_tpu_torch.models.lbph",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

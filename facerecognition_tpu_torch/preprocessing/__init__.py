"""preprocessing of the PyTorch/CUDA port (see the package docstring).

The names are imported at first use (``__getattr__``), so importing one
module of the package does not import the others.
"""

import importlib

_EXPORTS = {
    "FaceDetector": "facerecognition_tpu_torch.preprocessing.face_detector",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""utils of the PyTorch/CUDA port (see the package docstring).

The names are imported at first use (``__getattr__``), so importing one
module of the package does not import the others.
"""

import importlib

_EXPORTS = {
    "load_variables": "facerecognition_tpu_torch.utils.serialization",
    "save_variables": "facerecognition_tpu_torch.utils.serialization",
    "load_image": "facerecognition_tpu_torch.utils.imageio",
    "to_uint8": "facerecognition_tpu_torch.utils.imageio",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

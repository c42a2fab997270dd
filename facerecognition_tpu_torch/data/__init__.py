"""Host-side data: the image decoder's bindings, dataset indexes, samplers,
the batch loader, and the training augmentation (which runs on the card).

The names are imported at first use (``__getattr__``), so importing one
module of the package does not import the others.
"""

import importlib

_EXPORTS = {
    "CSVDataset": "facerecognition_tpu_torch.data.datasets",
    "FolderDataset": "facerecognition_tpu_torch.data.datasets",
    "check_identity_overlap": "facerecognition_tpu_torch.data.datasets",
    "split_by_identity": "facerecognition_tpu_torch.data.datasets",
    "split_by_image": "facerecognition_tpu_torch.data.datasets",
    "ClassBalancedSampler": "facerecognition_tpu_torch.data.sampler",
    "PKSampler": "facerecognition_tpu_torch.data.sampler",
    "BatchLoader": "facerecognition_tpu_torch.data.loader",
    "benchmark_loader": "facerecognition_tpu_torch.data.loader",
    "AUG_TIERS": "facerecognition_tpu_torch.data.augment",
    "augment_batch": "facerecognition_tpu_torch.data.augment",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

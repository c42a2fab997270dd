"""ops of the PyTorch/CUDA port (see the package docstring).

As in the JAX package, ``umeyama`` here is the function, which hides the
module of that name: import the module with ``importlib.import_module(
"facerecognition_tpu_torch.ops.umeyama")``."""


from facerecognition_tpu_torch.ops.umeyama import ARCFACE_TEMPLATE, umeyama, invert_affine
from facerecognition_tpu_torch.ops.image import (
    affine_warp,
    align_crop,
    bilinear_resize,
    crop_with_margin,
    normalize_imagenet_style,
    rgb_to_grayscale,
)
from facerecognition_tpu_torch.ops.matcher import (
    auto_cosine_topk,
    cosine_similarity,
    cosine_topk,
    l2_normalize,
    compute_prototypes,
    pairwise_sq_dists,
)
from facerecognition_tpu_torch.ops.warp_mxu import (
    affine_warp_mxu_batch,
    align_crop_mxu_batch,
    bilinear_resize_mxu_batch,
)
from facerecognition_tpu_torch.ops.nms import iou_matrix, nms_padded

__all__ = [
    "auto_cosine_topk",
    "pairwise_sq_dists",
    "affine_warp_mxu_batch",
    "align_crop_mxu_batch",
    "bilinear_resize_mxu_batch",
    "iou_matrix",
    "nms_padded",
    "ARCFACE_TEMPLATE",
    "umeyama",
    "invert_affine",
    "affine_warp",
    "align_crop",
    "bilinear_resize",
    "crop_with_margin",
    "normalize_imagenet_style",
    "rgb_to_grayscale",
    "cosine_similarity",
    "cosine_topk",
    "l2_normalize",
    "compute_prototypes",
]

"""inference of the PyTorch/CUDA port (see the package docstring).

The names are imported at first use (``__getattr__``), so importing one
module of the package does not import the others.
"""

import importlib

_EXPORTS = {
    "SearchIndex": "facerecognition_tpu_torch.inference.extract_embeddings",
    "build_faiss_index": "facerecognition_tpu_torch.inference.extract_embeddings",
    "extract_embeddings_from_csv": "facerecognition_tpu_torch.inference.extract_embeddings",
    "full_pipeline": "facerecognition_tpu_torch.inference.extract_embeddings",
    "visualize_tsne": "facerecognition_tpu_torch.inference.extract_embeddings",
    "ExplainabilityEngine": "facerecognition_tpu_torch.inference.explainability",
    "FaceNetExplainabilityEngine": "facerecognition_tpu_torch.inference.explainability",
    "GradCAM": "facerecognition_tpu_torch.inference.explainability",
    "BuildJob": "facerecognition_tpu_torch.inference.database_builder",
    "DatabaseBuilder": "facerecognition_tpu_torch.inference.database_builder",
    "get_builder": "facerecognition_tpu_torch.inference.database_builder",
    "Gallery": "facerecognition_tpu_torch.inference.engine",
    "RecognitionEngine": "facerecognition_tpu_torch.inference.engine",
    "create_engine_from_embeddings_dir": "facerecognition_tpu_torch.inference.engine",
    "cosine_similarity": "facerecognition_tpu_torch.ops.matcher",
    "EmbedderConfig": "facerecognition_tpu_torch.inference.extract_embeddings",
    "build_db": "facerecognition_tpu_torch.inference.extract_embeddings",
    "compute_prototypes_from_arrays": "facerecognition_tpu_torch.inference.extract_embeddings",
    "extract_embedding_single": "facerecognition_tpu_torch.inference.extract_embeddings",
    "extract_embeddings_batch": "facerecognition_tpu_torch.inference.extract_embeddings",
    "default_arcface_checkpoint": "facerecognition_tpu_torch.inference.extract_embeddings",
    "default_facenet_checkpoint": "facerecognition_tpu_torch.inference.extract_embeddings",
    "load_arcface_model": "facerecognition_tpu_torch.inference.extract_embeddings",
    "load_facenet_model": "facerecognition_tpu_torch.inference.extract_embeddings",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

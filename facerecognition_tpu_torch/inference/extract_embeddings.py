"""Embedders: checkpoint loading, the image → embedding forward, batched
extraction on image arrays, prototypes and the exact search index.

Counterpart of ``facerecognition_tpu/inference/extract_embeddings.py``
(``EmbedderConfig``, ``Embedder`` for ArcFace and FaceNet, the checkpoint
resolvers and loaders, ``extract_embedding_single``/``extract_embeddings_batch``,
``compute_prototypes_from_arrays``, ``SearchIndex``). What reads image files
(CSV extraction, ``full_pipeline``, ``build_db``, the CLI) and the t-SNE plot
wait (ROADMAP): the port reads no files, and a path is skipped as a failed
load.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from facerecognition_tpu_torch.convert import (
    facenet_state_dict,
    flax_to_state_dict,
    load_flax_variables,
    load_torch_checkpoint,
)
from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.models.facenet import FaceNetModel
from facerecognition_tpu_torch.ops.image import bilinear_resize, normalize_imagenet_style
from facerecognition_tpu_torch.ops.matcher import auto_cosine_topk, compute_prototypes, l2_normalize
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR
from facerecognition_tpu_torch.utils.imageio import load_image
from facerecognition_tpu_torch.utils.serialization import load_variables

#: Batch sizes the JAX package pads its device batches to (one compiled
#: graph per bucket); the port pads the staged path's warp batch alike.
BATCH_BUCKETS = (1, 8, 32, 128, 512)


def batch_bucket(n: int) -> int:
    """The smallest bucket that holds ``n``; above the largest, a multiple
    of it."""
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return -(-n // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


#: Shipped ArcFace serving checkpoints in preference order (same chain as
#: the JAX package: the ultraslim (1,1,1,1) backbone is the default).
DEFAULT_ARCFACE_CHECKPOINTS = (
    "arcface_synthid9k_ultraslim_512.msgpack",
    "arcface_synthid9k_slim_512.msgpack",
    "arcface_synthid9k_512.msgpack",
    "arcface_synthid_512.msgpack",
)
#: Shipped FaceNet checkpoints in preference order: the 9,343-identity
#: triplet run before the legacy 2,000-identity one.
DEFAULT_FACENET_CHECKPOINTS = (
    "facenet_synthid9k_512.msgpack",
    "facenet_synthid_512.msgpack",
)


@dataclasses.dataclass
class EmbedderConfig:
    """Which embedding model and input geometry to use."""

    model_type: str = "arcface"  # arcface | facenet
    embedding_size: int = 512
    input_size: int = 112  # 112 for arcface, 160 for facenet
    stage_sizes: tuple = (3, 4, 6, 3)  # ArcFace only


class Embedder:
    """uint8-range images → L2-normalized embeddings on one device. The
    output is normalised again after the model, as the JAX embedder does
    (FaceNet's own output is already unit rows)."""

    def __init__(
        self,
        config: EmbedderConfig,
        model: Union[ArcFaceModel, FaceNetModel],
        device: DeviceLike = None,
    ):
        kinds = {"arcface": ArcFaceModel, "facenet": FaceNetModel}
        if config.model_type not in kinds:
            raise ValueError(f"unknown model_type {config.model_type!r}")
        kind = kinds[config.model_type]
        if not isinstance(model, kind):
            raise TypeError(f"a {config.model_type} embedder needs a {kind.__name__}")
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, s, s, 3) float in [0, 255] on the embedder's device → (B, D)."""
        with strict_fp32():
            emb = self.model(normalize_imagenet_style(images))
        return l2_normalize(emb.float())

    def embed_uint8(self, images: np.ndarray) -> np.ndarray:
        """Embed a (N, H, W, 3) batch; resizes when H, W != input_size."""
        s = self.config.input_size
        if len(images) == 0:
            return np.zeros((0, self.config.embedding_size), np.float32)
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        if x.shape[1] != s or x.shape[2] != s:
            x = bilinear_resize(x, s, s)
        return self.embed(x).cpu().numpy()


def _first_shipped(names: Sequence[str]) -> Optional[str]:
    for name in names:
        path = os.path.join(ASSETS_DIR, name)
        if os.path.exists(path):
            return path
    return None


def default_arcface_checkpoint() -> Optional[str]:
    """Best shipped ArcFace serving checkpoint, or None."""
    return _first_shipped(DEFAULT_ARCFACE_CHECKPOINTS)


def default_facenet_checkpoint() -> Optional[str]:
    """Best shipped FaceNet serving checkpoint, or None."""
    return _first_shipped(DEFAULT_FACENET_CHECKPOINTS)


def load_arcface_checkpoint(checkpoint_path: str, embedding_size: int = 512) -> ArcFaceModel:
    """An ArcFace model (on the CPU) with a msgpack checkpoint's weights.

    The backbone depth rides in the checkpoint as ``stage_sizes`` (absent:
    ResNet50's (3, 4, 6, 3)).
    """
    variables = load_variables(checkpoint_path)
    raw = variables.pop("stage_sizes", None)
    stages = (3, 4, 6, 3) if raw is None else tuple(int(v) for v in np.asarray(raw))
    model = ArcFaceModel(embedding_size, stages)
    load_flax_variables(
        model, {k: variables[k] for k in ("params", "batch_stats") if k in variables}
    )
    return model


def load_arcface_model(
    checkpoint_path: Optional[str] = None,
    embedding_size: int = 512,
    stage_sizes: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
    seed: int = 0,
) -> Embedder:
    """ArcFace ``Embedder`` from a checkpoint, or randomly initialised from
    ``seed`` when ``checkpoint_path`` is None (for tests). An explicit
    ``stage_sizes`` must match the checkpoint's."""
    device = resolve_device(device)
    if checkpoint_path:
        model = load_arcface_checkpoint(checkpoint_path, embedding_size)
        if stage_sizes is not None and tuple(stage_sizes) != model.stage_sizes:
            raise ValueError(
                f"stage_sizes {tuple(stage_sizes)} != checkpoint's {model.stage_sizes}"
            )
    else:
        with torch.random.fork_rng(devices=[]):  # leave the global RNG as it was
            torch.manual_seed(seed)
            model = ArcFaceModel(embedding_size, tuple(stage_sizes or (3, 4, 6, 3)))
    config = EmbedderConfig("arcface", embedding_size, 112, model.stage_sizes)
    return Embedder(config, model, device)


def load_facenet_checkpoint(checkpoint_path: str, embedding_size: int = 512) -> FaceNetModel:
    """A FaceNet model (on the CPU) with a checkpoint's weights: a flax
    msgpack file, or a reference torch ``.pth``/``.pt`` (facenet-pytorch
    keys under ``model.``/``backbone.``/``module.``, ``logits`` dropped)."""
    model = FaceNetModel(embedding_size)
    if checkpoint_path.endswith((".pth", ".pt")):
        state = facenet_state_dict(load_torch_checkpoint(checkpoint_path))
    else:
        variables = load_variables(checkpoint_path)
        state = flax_to_state_dict(
            {k: variables[k] for k in ("params", "batch_stats") if k in variables}
        )
    model.load_state_dict(state, strict=True)
    return model


def load_facenet_model(
    checkpoint_path: Optional[str] = None,
    embedding_size: int = 512,
    device: DeviceLike = None,
    seed: int = 0,
) -> Embedder:
    """FaceNet ``Embedder`` (160² inputs) from a checkpoint, or randomly
    initialised from ``seed`` when ``checkpoint_path`` is None (for tests;
    PyTorch's initialisation, not flax's numbers)."""
    device = resolve_device(device)
    if checkpoint_path:
        model = load_facenet_checkpoint(checkpoint_path, embedding_size)
    else:
        with torch.random.fork_rng(devices=[]):  # leave the global RNG as it was
            torch.manual_seed(seed)
            model = FaceNetModel(embedding_size)
    return Embedder(EmbedderConfig("facenet", embedding_size, 160), model, device)


def extract_embedding_single(
    img_input, embedder: Embedder, preprocess: Optional[Callable] = None
) -> Optional[np.ndarray]:
    """One L2-normalized embedding of an image array, or None when the
    input cannot be read (a path: the port reads no files) or ``preprocess``
    returns None."""
    try:
        img = load_image(img_input)
    except OSError:
        return None
    if preprocess is not None:
        img = preprocess(img)
        if img is None:
            return None
    return embedder.embed_uint8(np.asarray(img)[None])[0]


def extract_embeddings_batch(
    img_inputs: Sequence, embedder: Embedder, preprocess: Optional[Callable] = None
) -> tuple[np.ndarray, list[int]]:
    """Embeddings (M, D) of the inputs that load, and their indices; each
    image not at the embedder's input size is resized first (float32, on the
    embedder's device), as the JAX function does."""
    images, kept = [], []
    s = embedder.config.input_size
    for i, inp in enumerate(img_inputs):
        try:
            img = load_image(inp)
        except OSError:
            continue
        if preprocess is not None:
            img = preprocess(img)
            if img is None:
                continue
        img = np.asarray(img)
        if img.shape[0] != s or img.shape[1] != s:
            x = torch.as_tensor(img.astype(np.float32), device=embedder.device)
            img = bilinear_resize(x, s, s).cpu().numpy()
        images.append(img)
        kept.append(i)
    if not images:
        return np.zeros((0, embedder.config.embedding_size), np.float32), []
    return embedder.embed_uint8(np.stack(images)), kept


def compute_prototypes_from_arrays(
    embeddings: np.ndarray, labels: np.ndarray, num_classes: Optional[int] = None
) -> np.ndarray:
    """Per-class mean prototypes, L2-normalised (zero rows for empty
    classes), on the host's CPU."""
    labels = np.asarray(labels)
    if num_classes is None:
        num_classes = int(labels.max()) + 1 if len(labels) else 0
    return compute_prototypes(
        torch.as_tensor(np.asarray(embeddings, np.float32)), torch.as_tensor(labels), num_classes
    ).numpy()


class SearchIndex:
    """Exact inner-product top-k index (the FAISS ``IndexFlatIP`` stand-in):
    unit rows on the device and the port's matcher, so the same top-k as
    ``Gallery`` (the streaming kernel when the dense scores would pressure
    device memory), with the row → label mapping attached."""

    def __init__(
        self, embeddings: np.ndarray, labels: Optional[np.ndarray] = None, device: DeviceLike = None
    ):
        self.device = resolve_device(device)
        emb = np.asarray(embeddings, np.float32)
        norm = np.linalg.norm(emb, axis=1, keepdims=True)
        self.matrix = torch.as_tensor(emb / np.maximum(norm, 1e-12), device=self.device)
        self.labels = np.asarray(labels) if labels is not None else np.arange(len(emb))

    def __len__(self) -> int:
        return int(self.matrix.shape[0])

    def search(self, queries: np.ndarray, k: int = 5) -> tuple[np.ndarray, np.ndarray]:
        """(scores (B, k), labels (B, k)) of the nearest rows."""
        k = min(k, len(self))
        q = torch.as_tensor(np.asarray(queries, np.float32), device=self.device)
        scores, idx = auto_cosine_topk(q, self.matrix, k)
        return scores.cpu().numpy(), self.labels[idx.cpu().numpy()]

    def save(self, path: str) -> None:
        np.savez(path, matrix=self.matrix.cpu().numpy(), labels=self.labels)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "SearchIndex":
        data = np.load(path if path.endswith(".npz") else path + ".npz", allow_pickle=False)
        return cls(data["matrix"], data["labels"], device=device)


#: The reference's name for the index.
build_faiss_index = SearchIndex

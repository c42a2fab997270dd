"""ArcFace embedder: checkpoint loading and the image → embedding forward.

Counterpart of ``facerecognition_tpu/inference/extract_embeddings.py``
(``EmbedderConfig``, ``Embedder``, the ArcFace checkpoint resolvers). FaceNet,
CSV extraction, prototypes and the CLI wait (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from facerecognition_tpu_torch.convert import load_flax_variables
from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.ops.image import bilinear_resize, normalize_imagenet_style
from facerecognition_tpu_torch.ops.matcher import l2_normalize
from facerecognition_tpu_torch.preprocessing.face_detector import ASSETS_DIR
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


@dataclasses.dataclass
class EmbedderConfig:
    """Which embedding model and input geometry to use."""

    model_type: str = "arcface"
    embedding_size: int = 512
    input_size: int = 112
    stage_sizes: tuple = (3, 4, 6, 3)


class Embedder:
    """uint8-range images → L2-normalized embeddings on one device."""

    def __init__(self, config: EmbedderConfig, model: ArcFaceModel, device: DeviceLike = None):
        if config.model_type != "arcface":
            raise NotImplementedError(
                f"model_type {config.model_type!r} is not ported yet; only "
                "arcface is (FaceNet: ROADMAP Queue 1, other backends item)"
            )
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


def default_arcface_checkpoint() -> Optional[str]:
    """Best shipped ArcFace serving checkpoint, or None."""
    for name in DEFAULT_ARCFACE_CHECKPOINTS:
        path = os.path.join(ASSETS_DIR, name)
        if os.path.exists(path):
            return path
    return None


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

"""Embedders: checkpoint loading, the image → embedding forward, batched
extraction, prototypes, the exact search index and gallery building.

Counterpart of ``facerecognition_tpu/inference/extract_embeddings.py``
(``EmbedderConfig``, ``Embedder`` for ArcFace and FaceNet, the checkpoint
resolvers and loaders, ``extract_embedding_single``/``extract_embeddings_batch``
on arrays, paths or bytes, ``compute_prototypes_from_arrays``,
``SearchIndex``, ``extract_embeddings_from_csv``, ``build_db``,
``full_pipeline``, ``visualize_tsne`` and the ``main`` CLI). An input that
cannot be read is skipped. sklearn and matplotlib are imported by
``visualize_tsne`` only.

    python -m facerecognition_tpu_torch.inference.extract_embeddings --mode db \
        --data-dir <person folders> --output databases/arcface
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from facerecognition_tpu_torch.convert import (
    arcface_state_dict,
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


def resnet_stage_sizes(state: dict) -> tuple:
    """Blocks per stage of the port's ResNet keys (``backbone.layer{s}_{b}.``)."""
    blocks = {(int(m.group(1)), int(m.group(2)))
              for m in (re.match(r"backbone\.layer(\d)_(\d+)\.", k) for k in state) if m}
    return tuple(sum(1 for s, _ in blocks if s == stage) for stage in (1, 2, 3, 4))


def load_arcface_checkpoint(checkpoint_path: str, embedding_size: int = 512) -> ArcFaceModel:
    """An ArcFace model (on the CPU) with a checkpoint's weights: a flax
    msgpack file, whose backbone depth rides in it as ``stage_sizes``
    (absent: ResNet50's (3, 4, 6, 3)), or a reference torch ``.pth``/``.pt``
    (``backbone.<torchvision resnet50>``, ``bn1``, ``fc``, ``bn2``; the
    margin head dropped), whose depth is the number of blocks its keys
    name in each stage: (3, 4, 6, 3) for the reference's ResNet50, as JAX
    assumes; a slim export (``scripts/export_torch``) loads too, where the
    JAX loader fails on the missing blocks."""
    if checkpoint_path.endswith((".pth", ".pt")):
        state = arcface_state_dict(load_torch_checkpoint(checkpoint_path))
        model = ArcFaceModel(embedding_size, resnet_stage_sizes(state))
        model.load_state_dict(state, strict=True)
        return model
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
    """One L2-normalized embedding of an image (array, path or bytes), or
    None when the input cannot be read or ``preprocess`` returns None."""
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
    """Embeddings (M, D) of the inputs that load, and their indices (an
    input that cannot be read, or that ``preprocess`` maps to None, is
    skipped); each image not at the embedder's input size is resized first
    (float32, on the embedder's device), as the JAX function does."""
    images, kept = [], []
    s = embedder.config.input_size
    for i, inp in enumerate(img_inputs):
        try:
            img = load_image(inp)
            if preprocess is not None:
                img = preprocess(img)
        except OSError:
            continue
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


def extract_embeddings_from_csv(
    csv_path: str,
    embedder: Embedder,
    image_root: Optional[str] = None,
    preprocess: Optional[Callable] = None,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """(embeddings (N, D), labels (N,), label names) of the images a CSV
    lists (``data.datasets.CSVDataset``'s three layouts); images that cannot
    be read are skipped with their labels."""
    from facerecognition_tpu_torch.data.datasets import CSVDataset

    index = CSVDataset(csv_path, image_root)
    embs, kept = extract_embeddings_batch(index.paths, embedder, preprocess)
    return embs, index.labels[kept], index.label_names


def visualize_tsne(
    embeddings: np.ndarray,
    labels: np.ndarray,
    output_path: str,
    max_classes: int = 20,
    perplexity: float = 30.0,
    seed: int = 0,
) -> str:
    """t-SNE plot of the embeddings of the ``max_classes`` most frequent
    identities, written to ``output_path`` (host only: sklearn and
    matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    labels = np.asarray(labels)
    classes, counts = np.unique(labels, return_counts=True)
    top = classes[np.argsort(-counts)][:max_classes]
    mask = np.isin(labels, top)
    emb = np.asarray(embeddings)[mask]
    lab = labels[mask]
    perplexity = min(perplexity, max(len(emb) - 1, 1) / 3)
    proj = TSNE(n_components=2, perplexity=perplexity, random_state=seed, init="pca").fit_transform(emb)
    fig, ax = plt.subplots(figsize=(8, 8))
    for c in top:
        pts = proj[lab == c]
        ax.scatter(pts[:, 0], pts[:, 1], s=8, label=str(c))
    if len(top) <= 20:
        ax.legend(fontsize=6, markerscale=1.5)
    ax.set_title(f"t-SNE of {len(emb)} embeddings / {len(top)} identities")
    d = os.path.dirname(output_path)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(output_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return output_path


def full_pipeline(
    csv_path: str,
    embedder: Embedder,
    output_dir: str,
    image_root: Optional[str] = None,
    preprocess: Optional[Callable] = None,
) -> dict:
    """CSV → embeddings, labels, class prototypes and their ``SearchIndex``
    in ``output_dir``, and a t-SNE plot from 10 embeddings up; returns the
    counts and paths."""
    os.makedirs(output_dir, exist_ok=True)
    embs, labels, names = extract_embeddings_from_csv(csv_path, embedder, image_root, preprocess)
    np.save(os.path.join(output_dir, "embeddings.npy"), embs)
    np.save(os.path.join(output_dir, "labels.npy"), labels)
    protos = compute_prototypes_from_arrays(embs, labels, len(names))
    np.save(os.path.join(output_dir, "prototypes.npy"), protos)
    index = SearchIndex(protos, np.arange(len(names)), device=embedder.device)
    index.save(os.path.join(output_dir, "search_index"))
    tsne_path = None
    if len(embs) >= 10:
        tsne_path = visualize_tsne(embs, labels, os.path.join(output_dir, "tsne.png"))
    return {
        "n_embeddings": len(embs),
        "n_classes": len(names),
        "embeddings_path": os.path.join(output_dir, "embeddings.npy"),
        "prototypes_path": os.path.join(output_dir, "prototypes.npy"),
        "index_path": os.path.join(output_dir, "search_index.npz"),
        "tsne_path": tsne_path,
    }


#: File endings ``build_db`` reads in a person's folder (as the JAX function).
IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def build_db(
    dataset_dir: str,
    embedder: Embedder,
    preprocess: Optional[Callable] = None,
    output_path: Optional[str] = None,
    progress: Optional[Callable[[int, int, str], None]] = None,
) -> dict[str, np.ndarray]:
    """{person: mean embedding / (||mean|| + 1e-8)} over a person-per-folder
    directory, each person's images in one batch (unreadable ones skipped;
    a person with none is left out). Saved as a pickled dict in
    ``output_path`` (``.npy``) when given; ``progress(i, n, person)`` after
    each person embedded."""
    people = sorted(
        d for d in os.listdir(dataset_dir) if os.path.isdir(os.path.join(dataset_dir, d))
    )
    db: dict[str, np.ndarray] = {}
    for i, person in enumerate(people):
        pdir = os.path.join(dataset_dir, person)
        paths = [
            os.path.join(pdir, f) for f in sorted(os.listdir(pdir)) if f.lower().endswith(IMAGE_EXTS)
        ]
        embs, _ = extract_embeddings_batch(paths, embedder, preprocess)
        if len(embs) == 0:
            continue
        mean = embs.mean(axis=0)
        db[person] = mean / (np.linalg.norm(mean) + 1e-8)
        if progress is not None:
            progress(i + 1, len(people), person)
    if output_path:
        d = os.path.dirname(output_path)
        if d:
            os.makedirs(d, exist_ok=True)
        np.save(output_path, db, allow_pickle=True)
    return db


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: ``--mode db`` (person folders → ``face_db.npy``), ``csv``
    (embeddings and labels) or ``full`` (``full_pipeline``)."""
    import argparse

    parser = argparse.ArgumentParser(description="Embedding extraction")
    parser.add_argument("--mode", choices=["db", "csv", "full"], default="db")
    parser.add_argument("--model", choices=["arcface", "facenet"], default="arcface")
    parser.add_argument("--checkpoint", default=None,
                        help="weights (default: the shipped checkpoint of --model)")
    parser.add_argument("--data-dir", default=None, help="db mode: person folders")
    parser.add_argument("--csv", default=None, help="csv/full modes")
    parser.add_argument("--image-root", default=None)
    parser.add_argument("--output", default="databases/out")
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    if args.model == "arcface":
        embedder = load_arcface_model(args.checkpoint or default_arcface_checkpoint(),
                                      device=args.device)
    else:
        embedder = load_facenet_model(args.checkpoint or default_facenet_checkpoint(),
                                      device=args.device)
    if args.mode == "db":
        if not args.data_dir:
            parser.error("--data-dir required for db mode")
        db = build_db(args.data_dir, embedder, output_path=os.path.join(args.output, "face_db.npy"))
        print(f"built gallery: {len(db)} identities → {args.output}/face_db.npy")
    elif args.mode == "csv":
        if not args.csv:
            parser.error("--csv required for csv mode")
        embs, labels, names = extract_embeddings_from_csv(args.csv, embedder, args.image_root)
        os.makedirs(args.output, exist_ok=True)
        np.save(os.path.join(args.output, "embeddings.npy"), embs)
        np.save(os.path.join(args.output, "labels.npy"), labels)
        print(f"extracted {len(embs)} embeddings / {len(names)} classes")
    else:
        if not args.csv:
            parser.error("--csv required for full mode")
        print(full_pipeline(args.csv, embedder, args.output, args.image_root))


if __name__ == "__main__":
    main()

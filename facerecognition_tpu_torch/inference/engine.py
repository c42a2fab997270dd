"""Recognition engine: the fused detect → align → embed → match path.

Counterpart of ``facerecognition_tpu/inference/engine.py``: ``Gallery``
(enrollment, the exact-N device matrix and the capacity-padded device store)
and ``RecognitionEngine.fused_recognize_frames`` for any ``max_faces``: one
face per frame by the argmax decode, or the crowd path (``max_faces > 1``:
decode → top-K → NMS, every slot aligned, embedded and matched, invalid
slots masked on the host). The staged ``recognize``/``match`` API, int8
matching and gallery save/load wait (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.inference.extract_embeddings import (
    Embedder,
    load_arcface_model,
)
from facerecognition_tpu_torch.models.detector_net import detect_best_face
from facerecognition_tpu_torch.ops.detect_post import detect_post
from facerecognition_tpu_torch.ops.matcher import auto_cosine_topk
from facerecognition_tpu_torch.ops.warp_sample import detector_input, embedder_input

MATCH_KERNELS = ("auto", "dense", "stream")
#: Crowd-path crop window per slot, as the JAX engine's ``_CROWD_WINDOW``:
#: frames with min(H, W) above it warp each slot from a window² crop.
CROWD_WINDOW = 160


class Gallery:
    """Identity gallery: host (capacity, D) store of unit rows + names, with
    device copies for matching.

    ``matrix`` is the exact-N device matrix (what the streaming kernel
    takes); ``device_store()`` is the capacity-padded one plus the live row
    count, for the dense path's ``n_valid`` mask. Rows changed since the
    padded copy was shipped are synced by copying just those rows.
    """

    def __init__(self, dim: int = 512, device: DeviceLike = None):
        self.dim = dim
        self.device = resolve_device(device)
        self.names: list[str] = []
        self._index: dict[str, int] = {}
        self._store = np.zeros((0, dim), np.float32)  # capacity >= len(names)
        self._device_matrix: Optional[torch.Tensor] = None
        self._device_store: Optional[torch.Tensor] = None
        self._dirty: set[int] = set()

    def __len__(self) -> int:
        return len(self.names)

    @property
    def matrix(self) -> torch.Tensor:
        """(N, D) float32 device matrix of the live rows (cached)."""
        if self._device_matrix is None:
            self._device_matrix = torch.tensor(
                self._store[: len(self.names)], device=self.device
            )
        return self._device_matrix

    def device_store(self) -> tuple[torch.Tensor, int]:
        """(capacity-padded device matrix, live row count)."""
        if self._device_store is None:
            self._device_store = torch.as_tensor(self._store, device=self.device).clone()
            self._dirty.clear()
        elif self._dirty:
            rows = np.fromiter(self._dirty, np.int64)
            self._device_store[torch.as_tensor(rows, device=self.device)] = torch.as_tensor(
                self._store[rows], device=self.device
            )
            self._dirty.clear()
        return self._device_store, len(self.names)

    def _invalidate_device(self, rows) -> None:
        """Drop the exact-N matrix; mark ``rows`` dirty in the padded store,
        or drop it when its capacity changed or the dirty set got large."""
        self._device_matrix = None
        incremental = (
            self._device_store is not None
            and self._device_store.shape[0] == len(self._store)
        )
        if incremental and len(self._dirty) + len(rows) <= max(1024, len(self._store) // 10):
            self._dirty.update(rows)
        else:
            self._device_store = None
            self._dirty.clear()

    def _reserve(self, extra: int) -> None:
        need = len(self.names) + extra
        if need <= len(self._store):
            return
        cap = max(need, 2 * len(self._store), 64)
        grown = np.zeros((cap, self.dim), np.float32)
        grown[: len(self.names)] = self._store[: len(self.names)]
        self._store = grown

    def add(self, name: str, embedding: np.ndarray) -> None:
        """Enroll (or replace) one identity: ``e / (||e|| + 1e-12)``, as the
        JAX ``add`` normalizes."""
        emb = np.asarray(embedding, np.float32).reshape(1, -1)
        self._write([name], emb / (np.linalg.norm(emb) + 1e-12))

    def add_many(self, names: Sequence[str], embeddings: np.ndarray) -> None:
        """Bulk enrollment: one vectorized normalize (``e / max(||e||,
        1e-12)``, as the JAX ``add_many``) and one block write. A repeated
        name keeps its last embedding, as repeated ``add`` does."""
        if len(names) == 0:
            return
        embs = np.ascontiguousarray(embeddings, np.float32).reshape(len(names), -1)
        self._write(names, embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12))

    def _write(self, names: Sequence[str], embs: np.ndarray) -> None:
        self._reserve(len(names))
        row_of_batch: dict[int, int] = {}
        for j, name in enumerate(names):
            idx = self._index.get(name)
            if idx is None:
                idx = len(self.names)
                self._index[name] = idx
                self.names.append(name)
            row_of_batch[idx] = j
        rows = np.fromiter(row_of_batch.keys(), np.int64)
        self._store[rows] = embs[np.fromiter(row_of_batch.values(), np.int64)]
        self._invalidate_device(row_of_batch.keys())


class RecognitionEngine:
    """Detector + embedder + gallery on one device, served in one fused call.

    ``match_kernel``: ``'stream'`` matches with the hand-written streaming
    top-k kernel on the exact-N gallery (the counterpart of the JAX
    ``'pallas'`` choice); ``'dense'`` with dense scores on the padded store
    and its ``n_valid`` mask; ``'auto'`` as the JAX package (dense, since the
    padded store carries a mask). ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        gallery: Optional[Gallery] = None,
        detector=None,
        threshold: float = 0.5,
        checkpoint_path: Optional[str] = None,
        match_kernel: str = "auto",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if match_kernel == "int8":
            raise NotImplementedError(
                "match_kernel='int8' is not ported yet (ROADMAP Queue 2: the "
                "int8 matcher kernel, sharing stream_topk's epilogue)"
            )
        if match_kernel not in MATCH_KERNELS:
            raise ValueError(f"unknown match_kernel {match_kernel!r}; have {MATCH_KERNELS}")
        if embedder is None:
            embedder = load_arcface_model(checkpoint_path, device=self.device)
        self.embedder = embedder
        self.gallery = gallery if gallery is not None else Gallery(
            embedder.config.embedding_size, device=self.device
        )
        self.detector = detector
        for part in (self.embedder, self.gallery, self.detector):
            if part is not None and part.device != self.device:
                raise ValueError(
                    f"{type(part).__name__} is on {part.device}, the engine on {self.device}"
                )
        self.threshold = threshold
        self.match_kernel = match_kernel

    @torch.no_grad()
    def _fused(self, frames: torch.Tensor, k: int, max_faces: int):
        """detect → align → embed → match for a (B, H, W, 3) frame batch on
        the device, ``max_faces`` slots per frame. Returns scores and indices
        (B, M, k), detector scores (B, M), boxes (B, M, 4) in the detector's
        input pixels, validity (B, M) and embeddings (B, M, D). The landmark
        scale into the frame, the alignment and both models' input
        normalisation run inside the ``warp_sample`` launches."""
        det = self.detector
        size = self.embedder.config.input_size
        det_size = det.input_size
        bsz, h, w = frames.shape[:3]
        dev = frames.device
        with strict_fp32():
            raw = det.net(detector_input(frames, det_size))
            if max_faces == 1:
                # Greedy NMS's first pick is the score argmax.
                b1, l1, s1 = detect_best_face(raw, det.anchors)
                boxes, lms, det_scores = b1[:, None], l1[:, None], s1[:, None]
                valid = torch.ones((bsz, 1), dtype=torch.bool, device=dev)
            else:
                boxes, lms, det_scores, valid = detect_post(
                    raw, det.anchors, det.iou_threshold, max_faces
                )
            window = CROWD_WINDOW if max_faces > 1 and min(h, w) > CROWD_WINDOW else None
            x = embedder_input(frames, lms, det_size, size, window)
            emb = self.embedder.model(x).float()
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        if self.match_kernel == "stream":
            scores, idx = auto_cosine_topk(
                emb, self.gallery.matrix, k, normalized=True, kernel="stream"
            )
        else:
            gal, n_valid = self.gallery.device_store()
            scores, idx = auto_cosine_topk(
                emb, gal, k, normalized=True, kernel=self.match_kernel, n_valid=n_valid
            )
        return (
            scores.reshape(bsz, max_faces, -1),
            idx.reshape(bsz, max_faces, -1),
            det_scores,
            boxes,
            valid,
            emb.reshape(bsz, max_faces, -1),
        )

    def fused_recognize_frames(
        self, frames: np.ndarray, k: int = 5, max_faces: int = 1
    ) -> list[dict]:
        """Recognize a (B, H, W, 3) frame batch, up to ``max_faces`` faces per
        frame.

        Needs a detector and a non-empty gallery. Returns one dict per frame
        whose top-level fields describe its best face (identity/confidence/
        top_k/bbox/status/embedding, 'No face' when no face clears the
        detector's calibrated confidence threshold and minimum size) and a
        ``'faces'`` list with the same fields for every detected face, in
        NMS slot order (score descending), as the JAX engine does.
        """
        if max_faces < 1:
            raise ValueError(f"max_faces must be >= 1, got {max_faces}")
        if self.detector is None:
            raise ValueError("fused path needs a detector")
        if len(self.gallery) == 0:
            raise ValueError("fused path needs a non-empty gallery")
        frames = np.asarray(frames)
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32)
        k_eff = min(k, len(self.gallery))
        out = self._fused(
            torch.as_tensor(np.ascontiguousarray(frames), device=self.device), k_eff, max_faces
        )
        scores, idx, det_scores, boxes, valid, emb = (t.cpu().numpy() for t in out)
        det_size = self.detector.input_size
        h, w = frames.shape[1:3]
        # frame-pixel boxes: the float32 product the JAX graph takes
        boxes = boxes * np.array([w / det_size, h / det_size] * 2, np.float32)
        det_scores = det_scores.astype(np.float64)
        # Platt calibration on the host in float64, as the JAX engine.
        cal = getattr(self.detector, "_calibration", None)
        if cal is not None:
            a_c, b_c = cal
            s = np.clip(det_scores, 1e-9, 1 - 1e-9)
            det_scores = 1.0 / (1.0 + np.exp(-(a_c * np.log(s / (1.0 - s)) + b_c)))
        conf_thr = self.detector.confidence_threshold
        min_size = self.detector.min_face_size
        results = []
        for b in range(len(frames)):
            faces = []
            for m in range(max_faces):
                if not valid[b, m] or det_scores[b, m] < conf_thr:
                    continue
                bw = boxes[b, m, 2] - boxes[b, m, 0]
                bh = boxes[b, m, 3] - boxes[b, m, 1]
                if min(bw, bh) < min_size:
                    continue
                top = [
                    (self.gallery.names[int(i)], float(s))
                    for s, i in zip(scores[b, m], idx[b, m])
                ]
                name, score = top[0]
                if score < self.threshold:
                    name = "Unknown"
                faces.append(
                    {
                        "identity": name,
                        "confidence": score,
                        "top_k": top,
                        "bbox": boxes[b, m].tolist(),
                        "det_score": float(det_scores[b, m]),
                        "embedding": emb[b, m],
                    }
                )
            if not faces:
                results.append(
                    {
                        "identity": "No face",
                        "confidence": 0.0,
                        "top_k": [],
                        "bbox": None,
                        "status": "success",
                        "embedding": None,
                        "faces": [],
                    }
                )
                continue
            best = faces[0]  # NMS slots come score-descending
            results.append(
                {
                    "identity": best["identity"],
                    "confidence": best["confidence"],
                    "top_k": best["top_k"],
                    "bbox": best["bbox"],
                    "status": "success",
                    "embedding": best["embedding"],
                    "faces": faces,
                }
            )
        return results

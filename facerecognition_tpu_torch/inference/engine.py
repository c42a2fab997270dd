"""Recognition engine: detect → align → embed → match, fused and staged.

Counterpart of ``facerecognition_tpu/inference/engine.py``: ``Gallery``
(enrollment and removal, the exact-N and capacity-padded device copies in
float32 and int8, save/load) and ``RecognitionEngine``: the fused serving
call ``fused_recognize_frames`` for any ``max_faces`` (one face per frame by
the argmax decode, or the crowd path: decode → top-K → NMS, every slot
aligned, embedded and matched, invalid slots masked on the host), and the
staged API the apps use (``recognize``, ``recognize_batch``,
``recognize_all``, ``add_to_db``, ``match``), which detects and aligns one
image at a time with the exact gather warp (``ops.image.align_crop``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.inference.extract_embeddings import (
    Embedder,
    batch_bucket,
    load_arcface_model,
    load_facenet_model,
)
from facerecognition_tpu_torch.models.detector_net import detect_best_face
from facerecognition_tpu_torch.ops import warp_sample
from facerecognition_tpu_torch.ops.detect_post import detect_post
from facerecognition_tpu_torch.ops.image import align_crop, bilinear_resize, crop_with_margin
from facerecognition_tpu_torch.ops.int8_topk import int8_topk
from facerecognition_tpu_torch.ops.matcher import (
    DENSE_SCORES_MAX_BYTES,
    auto_cosine_topk,
    l2_normalize,
    quantize_embeddings_int8_np,
)
from facerecognition_tpu_torch.ops.stream_topk import MAX_K
from facerecognition_tpu_torch.ops.warp_sample import detector_input, embedder_input
from facerecognition_tpu_torch.utils.imageio import load_image

MATCH_KERNELS = ("auto", "dense", "stream", "int8")
#: The staged API's message for an input it cannot embed (the JAX engine's).
UNREADABLE = "Cannot extract embedding (no face or invalid image)"
#: Embedder loaders by ``model_type``.
LOADERS = {"arcface": load_arcface_model, "facenet": load_facenet_model}
#: Crowd-path crop window per slot, as the JAX engine's ``_CROWD_WINDOW``:
#: frames with min(H, W) above it warp each slot from a window² crop.
CROWD_WINDOW = 160


class Gallery:
    """Identity gallery: host (capacity, D) store of unit rows + names, with
    device copies for matching.

    ``matrix`` is the exact-N float32 device matrix (what ``stream_topk``
    takes); ``device_store()`` is the capacity-padded one plus the live row
    count, for the dense path's ``n_valid`` mask. ``quantized()`` and
    ``quantized_store()`` are their int8 counterparts (codes + per-row
    scales, quantized on the host, only the codes shipped) for
    ``match_kernel='int8'``. Each padded copy keeps its own set of rows
    changed since it was shipped and syncs just those rows. Persists as a
    directory (``embeddings.npy`` + ``names.json``, memory-mappable) or as
    the ``.npy`` dict format, as the JAX ``Gallery``.
    """

    def __init__(self, dim: int = 512, device: DeviceLike = None):
        self.dim = dim
        self.device = resolve_device(device)
        self.names: list[str] = []
        self._index: dict[str, int] = {}
        self._store = np.zeros((0, dim), np.float32)  # capacity >= len(names)
        self._device_matrix: Optional[torch.Tensor] = None
        self._device_quant: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self._device_store: Optional[torch.Tensor] = None
        self._device_qstore: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        self._dirty_f32: set[int] = set()
        self._dirty_q: set[int] = set()

    def __len__(self) -> int:
        return len(self.names)

    @property
    def _matrix(self) -> np.ndarray:
        """Host view of the live rows."""
        return self._store[: len(self.names)]

    @property
    def matrix(self) -> torch.Tensor:
        """(N, D) float32 device matrix of the live rows (cached)."""
        if self._device_matrix is None:
            self._device_matrix = torch.tensor(self._matrix, device=self.device)
        return self._device_matrix

    def quantized(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(N, D) int8 device codes and (N,) float32 scales of the live rows
        (cached), quantized on the host: a quarter of the float32 rows'
        device bytes, and the float32 rows never reach the device."""
        if self._device_quant is None:
            q, scale = quantize_embeddings_int8_np(self._matrix)
            self._device_quant = (
                torch.as_tensor(q, device=self.device),
                torch.as_tensor(scale, device=self.device),
            )
        return self._device_quant

    def device_store(self) -> tuple[torch.Tensor, int]:
        """(capacity-padded device matrix, live row count)."""
        if self._device_store is None:
            self._device_store = torch.tensor(self._store, device=self.device)
            self._dirty_f32.clear()
        elif self._dirty_f32:
            rows = np.fromiter(self._dirty_f32, np.int64)
            self._device_store[torch.as_tensor(rows, device=self.device)] = torch.as_tensor(
                self._store[rows], device=self.device
            )
            self._dirty_f32.clear()
        return self._device_store, len(self.names)

    def quantized_store(self) -> tuple[torch.Tensor, torch.Tensor, int]:
        """int8 counterpart of ``device_store``: (padded codes, padded
        scales, live row count)."""
        if self._device_qstore is None:
            q, scale = quantize_embeddings_int8_np(self._store)
            self._device_qstore = (
                torch.as_tensor(q, device=self.device),
                torch.as_tensor(scale, device=self.device),
            )
            self._dirty_q.clear()
        elif self._dirty_q:
            rows = np.fromiter(self._dirty_q, np.int64)
            q, scale = quantize_embeddings_int8_np(self._store[rows])
            codes, scales = self._device_qstore
            ridx = torch.as_tensor(rows, device=self.device)
            codes[ridx] = torch.as_tensor(q, device=self.device)
            scales[ridx] = torch.as_tensor(scale, device=self.device)
            self._dirty_q.clear()
        return (*self._device_qstore, len(self.names))

    def _invalidate_device(self, rows=None) -> None:
        """Mark the device copies stale. ``rows``: the only store rows whose
        content changed (capacity unchanged), which each padded copy syncs on
        its next use; ``None`` (capacity growth, load, materialise) drops
        every copy. The exact-N copies always drop. A dirty set past a tenth
        of the capacity (at least 1024 rows) drops its copy instead."""
        self._device_matrix = None
        self._device_quant = None
        rows = None if rows is None else list(rows)
        limit = max(1024, len(self._store) // 10)
        if (
            rows is not None
            and self._device_store is not None
            and self._device_store.shape[0] == len(self._store)
            and len(self._dirty_f32) + len(rows) <= limit
        ):
            self._dirty_f32.update(rows)
        else:
            self._device_store = None
            self._dirty_f32.clear()
        if (
            rows is not None
            and self._device_qstore is not None
            and self._device_qstore[0].shape[0] == len(self._store)
            and len(self._dirty_q) + len(rows) <= limit
        ):
            self._dirty_q.update(rows)
        else:
            self._device_qstore = None
            self._dirty_q.clear()

    def _reserve(self, extra: int) -> None:
        need = len(self.names) + extra
        if need <= len(self._store):
            return
        cap = max(need, 2 * len(self._store), 64)
        grown = np.zeros((cap, self.dim), np.float32)
        grown[: len(self.names)] = self._matrix
        self._store = grown

    def _materialize(self) -> None:
        """Copy a read-only memory-mapped store into memory before a change."""
        if isinstance(self._store, np.memmap):
            self._store = np.array(self._store)

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
        self._materialize()
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

    def remove(self, name: str) -> bool:
        """Drop one identity by swap-remove (the last row moves into its
        place; row order is not part of the contract). False if unknown."""
        idx = self._index.pop(name, None)
        if idx is None:
            return False
        self._materialize()
        last = len(self.names) - 1
        changed: tuple[int, ...] = ()  # removing the last row changes only the count
        if idx != last:
            self._store[idx] = self._store[last]
            moved = self.names[last]
            self.names[idx] = moved
            self._index[moved] = idx
            changed = (idx,)
        self.names.pop()
        self._invalidate_device(changed)
        return True

    @classmethod
    def from_dict(cls, db: dict, device: DeviceLike = None) -> "Gallery":
        """A gallery of ``{name: embedding}`` (rows normalized on entry)."""
        first = next(iter(db.values()), None)
        g = cls(dim=len(np.ravel(first)) if first is not None else 512, device=device)
        if db:
            names = list(db.keys())
            g.add_many(names, np.stack([np.ravel(db[n]) for n in names]))
        return g

    def to_dict(self) -> dict[str, np.ndarray]:
        return {n: self._store[i].copy() for i, n in enumerate(self.names)}

    def save(self, path: str) -> None:
        """Persist the gallery: a directory ``path`` holding ``embeddings.npy``
        (N, dim) float32 and ``names.json`` (the native format, memory-
        mappable), or, when ``path`` ends in ``.npy``, a pickled ``{name:
        (dim,) array}`` dict (the interchange format)."""
        if path.endswith(".npy"):
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            np.save(path, self.to_dict(), allow_pickle=True)
            return
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f".tmp-{os.getpid()}")
        np.save(tmp + ".npy", np.ascontiguousarray(self._matrix))
        os.replace(tmp + ".npy", os.path.join(path, "embeddings.npy"))
        with open(tmp + ".json", "w") as f:
            json.dump(self.names, f)
        os.replace(tmp + ".json", os.path.join(path, "names.json"))

    @classmethod
    def load(cls, path: str, mmap: bool = False, device: DeviceLike = None) -> "Gallery":
        """Load either format (detected from ``path``). ``mmap`` (native
        format) memory-maps the embeddings read-only; the first change copies
        them into memory."""
        native = os.path.join(path, "embeddings.npy")
        if os.path.isdir(path) and os.path.exists(native):
            mat = np.load(native, mmap_mode="r" if mmap else None)
            with open(os.path.join(path, "names.json")) as f:
                names = json.load(f)
            if len(names) != len(mat):
                raise ValueError(f"gallery corrupt: {len(names)} names vs {len(mat)} rows")
            g = cls(dim=mat.shape[1] if mat.ndim == 2 else 512, device=device)
            g._store = mat if mmap else np.ascontiguousarray(mat, np.float32)
            g.names = list(names)
            g._index = {n: i for i, n in enumerate(names)}
            return g
        if not os.path.exists(path) and os.path.exists(path + ".npy"):
            path = path + ".npy"
        return cls.from_dict(np.load(path, allow_pickle=True).item(), device=device)


class RecognitionEngine:
    """Detector + embedder + gallery on one device, served in one fused call.

    ``match_kernel``: ``'stream'`` matches with the hand-written streaming
    top-k kernel on the exact-N gallery (the counterpart of the JAX
    ``'pallas'`` choice); ``'dense'`` with dense scores on the padded store
    and its ``n_valid`` mask; ``'int8'`` with the ``int8_topk`` kernel on the
    quantized padded store (the capacity mode: scores move by O(1e-3));
    ``'auto'`` as the JAX package (dense on the padded store, and in
    ``match`` the streaming kernel on the exact-N matrix when the dense
    scores would pressure device memory). ``detector=None`` embeds whole
    images (pre-aligned crops). Without an ``embedder``, ``model_type``
    (``'arcface'``, 112² inputs, or ``'facenet'``, 160²) and
    ``checkpoint_path`` choose one (None: random weights, for tests); the
    fused path aligns to the embedder's input size. ``device=None`` means
    the CUDA card.
    """

    def __init__(
        self,
        embedder: Optional[Embedder] = None,
        gallery: Optional[Gallery] = None,
        detector=None,
        threshold: float = 0.5,
        model_type: str = "arcface",
        checkpoint_path: Optional[str] = None,
        match_kernel: str = "auto",
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if match_kernel not in MATCH_KERNELS:
            raise ValueError(f"unknown match_kernel {match_kernel!r}; have {MATCH_KERNELS}")
        if model_type not in LOADERS:
            raise ValueError(f"unknown model_type {model_type!r}; have {tuple(LOADERS)}")
        if embedder is None:
            embedder = LOADERS[model_type](checkpoint_path, device=self.device)
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
        normalisation run inside the ``warp_sample`` launches, which write
        each model's input in that model's compute dtype; the detector's raw
        output and the embeddings are float32."""
        det = self.detector
        size = self.embedder.config.input_size
        det_size = det.input_size
        bsz, h, w = frames.shape[:3]
        dev = frames.device
        with strict_fp32():
            raw = det.net(detector_input(frames, det_size, out_dtype=det.net.dtype))
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
            x = embedder_input(frames, lms, det_size, size, window,
                               out_dtype=self.embedder.config.dtype)
            emb = self.embedder.model(x).float()
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        if self.match_kernel == "int8":
            gq, gs, n_valid = self.gallery.quantized_store()
            scores, idx = int8_topk(emb, gq, gs, k, n_valid)
        elif self.match_kernel == "stream":
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

    # -- configuration ------------------------------------------------------

    def set_threshold(self, threshold: float) -> None:
        self.threshold = float(threshold)

    # -- staged path --------------------------------------------------------

    def detect_and_align(self, image: np.ndarray) -> Optional[np.ndarray]:
        """The detector's face (``detect``) aligned to the embedder's input
        size: the Umeyama warp from its landmarks, else its box cropped with
        a 0.2 margin; None without a detector or a face."""
        if self.detector is None:
            return None
        det = self.detector.detect(image)
        if det is None:
            return None
        size = self.embedder.config.input_size
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        if det.get("landmarks") is not None:
            lms = torch.tensor(det["landmarks"], dtype=torch.float32, device=self.device)
            aligned = align_crop(img, lms, size)
        else:
            box = torch.tensor(det["bbox"], dtype=torch.float32, device=self.device)
            aligned = crop_with_margin(img, box, 0.2, size)
        return aligned.cpu().numpy()

    def extract_embedding(self, img_input) -> Optional[np.ndarray]:
        """Image → L2-normalized embedding (detected and aligned when the
        engine has a detector); None for an input it cannot read."""
        return self._extract_with_info(img_input)[0]

    def _extract_with_info(self, img_input) -> tuple[Optional[np.ndarray], bool]:
        """(embedding or None, face found). With a detector that finds no
        face, the whole image is embedded and ``face found`` is False."""
        try:
            img = load_image(img_input)
        except OSError:
            return None, False
        face_found = self.detector is None
        if self.detector is not None:
            aligned = self.detect_and_align(img)
            if aligned is not None:
                img = aligned
                face_found = True
        return self.embedder.embed_uint8(np.asarray(img, np.float32)[None])[0], face_found

    def match(self, embeddings: np.ndarray, k: int = 5) -> list[tuple[str, float, list]]:
        """Match (B, D) embeddings against the gallery: per query (best name,
        best score, top-k list of (name, score)); a best score below the
        threshold is named 'Unknown'."""
        if len(self.gallery) == 0:
            return [("No database", 0.0, [])] * len(embeddings)
        k_eff = min(k, len(self.gallery))
        q = torch.as_tensor(np.asarray(embeddings, np.float32), device=self.device)
        if self.match_kernel == "int8":
            gq, gs, n_valid = self.gallery.quantized_store()
            scores, idx = int8_topk(q, gq, gs, k_eff, n_valid)
        elif self.match_kernel == "stream":
            scores, idx = auto_cosine_topk(
                l2_normalize(q), self.gallery.matrix, k_eff, normalized=True, kernel="stream"
            )
        else:
            gal, n_valid = self.gallery.device_store()
            q = l2_normalize(q)
            pressure = (
                len(q) * gal.shape[0] * 4 > DENSE_SCORES_MAX_BYTES
                and gal.device.type == "cuda"
                and k_eff <= MAX_K
            )
            if self.match_kernel == "auto" and pressure:
                # the capacity regime: the streaming kernel on the exact-N matrix
                scores, idx = auto_cosine_topk(
                    q, self.gallery.matrix, k_eff, normalized=True, kernel="stream"
                )
            else:
                scores, idx = auto_cosine_topk(
                    q, gal, k_eff, normalized=True, kernel=self.match_kernel, n_valid=n_valid
                )
        scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
        out = []
        for b in range(len(q)):
            top = [(self.gallery.names[int(i)], float(s)) for s, i in zip(scores[b], idx[b])]
            best_name, best_score = top[0]
            if best_score < self.threshold:
                best_name = "Unknown"
            out.append((best_name, best_score, top))
        return out

    def recognize(self, img_input, k: int = 5) -> dict:
        """Recognize one image: a dict of identity, confidence, top_k,
        embedding, status (and face_found, message), as the JAX engine."""
        result: dict[str, Any] = {
            "identity": "Unknown",
            "confidence": 0.0,
            "top_k": [],
            "embedding": None,
            "status": "success",
        }
        embedding, face_found = self._extract_with_info(img_input)
        if embedding is None:
            result.update(status="error", message=UNREADABLE)
            return result
        result["embedding"] = embedding
        result["face_found"] = face_found
        if not face_found:
            result["message"] = "no face detected: embedded the full image"
        if len(self.gallery) == 0:
            result["status"] = "error"
            result["message"] = "No database loaded"
            return result
        identity, confidence, top_k = self.match(embedding[None], k)[0]
        result.update(identity=identity, confidence=confidence, top_k=top_k)
        return result

    def recognize_all(self, img_input, k: int = 5, max_faces: int = 16) -> dict:
        """Recognize every face of one image: ``detect_all``, one align of
        all faces (the two-pass warp of the fused path, ``warp_sample.
        align_crop``, its batch padded to a bucket), one embed batch, one
        match. Returns {'status', 'faces': [...]} by detection score."""
        if self.detector is None:
            raise ValueError("recognize_all needs a detector")
        try:
            img = load_image(img_input)
        except OSError:
            return {"status": "error", "message": "invalid image", "faces": []}
        dets = self.detector.detect_all(img)[:max_faces]
        if not dets:
            return {"status": "success", "faces": []}
        n = len(dets)
        lms = np.zeros((batch_bucket(n), 5, 2), np.float32)
        lms[:n] = np.stack([np.asarray(d["landmarks"], np.float32) for d in dets])
        frame = torch.as_tensor(np.ascontiguousarray(img), device=self.device)[None]
        aligned = warp_sample.align_crop(
            frame, torch.as_tensor(lms, device=self.device)[None], self.embedder.config.input_size
        )
        embs = self.embedder.embed_uint8(aligned[:n].cpu().numpy())
        matches = self.match(embs, k)
        faces = [
            {
                "identity": name,
                "confidence": score,
                "top_k": top,
                "bbox": list(d["bbox"]),
                "det_score": float(d["confidence"]),
                "embedding": emb,
            }
            for d, emb, (name, score, top) in zip(dets, embs, matches)
        ]
        faces.sort(key=lambda f: -f["det_score"])
        return {"status": "success", "faces": faces}

    def recognize_batch(self, img_inputs: Sequence, k: int = 5) -> list[dict]:
        """Recognize several images with one embed batch and one match."""
        results: list[dict] = []
        images, slots = [], []
        s = self.embedder.config.input_size
        for i, inp in enumerate(img_inputs):
            results.append({
                "identity": "Unknown",
                "confidence": 0.0,
                "top_k": [],
                "embedding": None,
                "status": "error",
                "message": UNREADABLE,
            })
            try:
                img = load_image(inp)
            except OSError:
                continue
            if self.detector is not None:
                aligned = self.detect_and_align(img)
                if aligned is not None:
                    img = aligned
            img = np.asarray(img, np.float32)
            if img.shape[0] != s or img.shape[1] != s:
                img = bilinear_resize(torch.as_tensor(img, device=self.device), s, s).cpu().numpy()
            images.append(img)
            slots.append(i)
        if not images:
            return results
        embs = self.embedder.embed_uint8(np.stack(images))
        matches = self.match(embs, k) if len(self.gallery) else None
        for j, i in enumerate(slots):
            results[i] = {
                "identity": "Unknown",
                "confidence": 0.0,
                "top_k": [],
                "embedding": embs[j],
                "status": "success",
            }
            if matches is None:
                results[i]["status"] = "error"
                results[i]["message"] = "No database loaded"
            else:
                identity, confidence, top_k = matches[j]
                results[i].update(identity=identity, confidence=confidence, top_k=top_k)
        return results

    def add_to_db(self, name: str, img_inputs: Sequence) -> bool:
        """Enroll ``name`` as the mean of its images' embeddings, divided by
        ``||mean|| + 1e-8``; False when no image gave an embedding."""
        embs = [e for e in map(self.extract_embedding, img_inputs) if e is not None]
        if not embs:
            return False
        mean = np.mean(np.stack(embs), axis=0)
        self.gallery.add(name, mean / (np.linalg.norm(mean) + 1e-8))
        return True

    def save_db(self, path: str) -> None:
        self.gallery.save(path)

    def get_db_identities(self) -> list[str]:
        return list(self.gallery.names)


def create_engine_from_embeddings_dir(
    model_path: Optional[str],
    embeddings_dir: str,
    model_type: str = "arcface",
    threshold: float = 0.5,
    detector: Any = "default",
    device: DeviceLike = None,
    match_kernel: str = "auto",
) -> RecognitionEngine:
    """A ``model_type`` engine whose gallery is ``face_db.npy``, else the
    first ``.npy`` dict that loads, in ``embeddings_dir``.
    ``detector="default"`` builds the shipped ``FaceDetector``; pass None to
    embed whole images. ``match_kernel`` as ``RecognitionEngine``'s."""
    device = resolve_device(device)
    if detector == "default":
        from facerecognition_tpu_torch.preprocessing.face_detector import FaceDetector

        detector = FaceDetector(device=device)
    engine = RecognitionEngine(
        model_type=model_type, checkpoint_path=model_path, threshold=threshold,
        detector=detector, device=device, match_kernel=match_kernel,
    )
    candidates = [os.path.join(embeddings_dir, "face_db.npy")] + [
        os.path.join(embeddings_dir, f) for f in sorted(os.listdir(embeddings_dir)) if f.endswith(".npy")
    ]
    for path in candidates:
        if os.path.exists(path):
            try:
                engine.gallery = Gallery.load(path, device=device)
                break
            except (ValueError, OSError):
                continue
    return engine

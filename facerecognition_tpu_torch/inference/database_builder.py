"""Gallery-build jobs in the background: registry, progress, logs, REST dicts.

Counterpart of ``facerecognition_tpu/inference/database_builder.py``: an
in-memory job registry under a lock, one background thread a build, and
``BuildJob.to_dict()`` payloads the web UI polls. A job dispatches to the
port's LBPH directory trainer (``training.train_lbph``) or its ArcFace /
FaceNet ``build_db`` (``inference.extract_embeddings``); any failure is
recorded in the job, with its traceback in the log. ``device`` (``None``:
the CUDA card) is where the builds run.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
import uuid
from typing import Any, Optional

from facerecognition_tpu_torch.device import DeviceLike

MODEL_TYPES = ("arcface", "facenet", "lbph")


class BuildJob:
    """A build's state: status, progress, logs, output files, times."""

    def __init__(self, job_id: str, model_type: str, dataset_dir: str):
        self.job_id = job_id
        self.model_type = model_type
        self.dataset_dir = dataset_dir
        self.status = "pending"  # pending | running | completed | failed
        self.progress = 0.0
        self.message = ""
        self.logs: list[str] = []
        self.output_files: list[str] = []
        self.error: Optional[str] = None
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self._lock = threading.Lock()

    def log(self, message: str) -> None:
        with self._lock:
            self.logs.append(f"[{time.strftime('%H:%M:%S')}] {message}")
            self.message = message

    def set_progress(self, frac: float) -> None:
        with self._lock:
            self.progress = max(0.0, min(1.0, frac))

    @property
    def elapsed_seconds(self) -> float:
        if self.started_at is None:
            return 0.0
        end = self.finished_at or time.time()
        return end - self.started_at

    def to_dict(self) -> dict[str, Any]:
        with self._lock:
            return {
                "job_id": self.job_id,
                "model_type": self.model_type,
                "dataset_dir": self.dataset_dir,
                "status": self.status,
                "progress": round(self.progress * 100.0, 1),
                "message": self.message,
                "logs": list(self.logs[-50:]),
                "output_files": list(self.output_files),
                "error": self.error,
                "elapsed_seconds": round(self.elapsed_seconds, 1),
            }


class DatabaseBuilder:
    """Job registry and background build threads; outputs go to
    ``output_root/<model_type>/``."""

    def __init__(self, output_root: str = "databases", device: DeviceLike = None):
        self.output_root = output_root
        self.device = device
        self.jobs: dict[str, BuildJob] = {}
        self.lock = threading.Lock()

    def create_job(self, model_type: str, dataset_dir: str) -> BuildJob:
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unknown model_type {model_type!r}")
        job = BuildJob(uuid.uuid4().hex[:12], model_type, dataset_dir)
        with self.lock:
            self.jobs[job.job_id] = job
        return job

    def get_job(self, job_id: str) -> Optional[BuildJob]:
        with self.lock:
            return self.jobs.get(job_id)

    def list_jobs(self) -> list[dict]:
        with self.lock:
            jobs = list(self.jobs.values())
        return [j.to_dict() for j in jobs]

    def start_build(
        self,
        job: BuildJob,
        embedder=None,
        detector=None,
        checkpoint_path: Optional[str] = None,
    ) -> threading.Thread:
        """Run ``job`` on a daemon thread (returned, started). ArcFace and
        FaceNet jobs take ``embedder``, else load ``checkpoint_path`` (None:
        random weights, as the JAX builder); a ``detector`` crops each face
        (0.2 margin) first."""
        thread = threading.Thread(
            target=self._run_build, args=(job, embedder, detector, checkpoint_path), daemon=True
        )
        thread.start()
        return thread

    def _run_build(self, job: BuildJob, embedder, detector, checkpoint_path) -> None:
        job.status = "running"
        job.started_at = time.time()
        out_dir = os.path.join(self.output_root, job.model_type)
        try:
            os.makedirs(out_dir, exist_ok=True)
            if job.model_type == "lbph":
                from facerecognition_tpu_torch.training.train_lbph import train_lbph_from_directory

                job.log("training LBPH from directory")
                result = train_lbph_from_directory(
                    job.dataset_dir, output_dir=out_dir, detector=detector, device=self.device
                )
                job.output_files = [result["model_path"], result["label_map_path"]]
                job.log(f"trained {result['n_identities']} identities ({result['n_images']} images)")
            else:
                from facerecognition_tpu_torch.inference.extract_embeddings import (
                    build_db,
                    load_arcface_model,
                    load_facenet_model,
                )

                if embedder is None:
                    job.log(f"loading {job.model_type} model")
                    loader = load_arcface_model if job.model_type == "arcface" else load_facenet_model
                    embedder = loader(checkpoint_path, device=self.device)
                out_path = os.path.join(out_dir, "face_db.npy")

                def progress(i, n, person):
                    job.set_progress(i / max(n, 1))
                    job.log(f"embedded {person} ({i}/{n})")

                preprocess = None
                if detector is not None:
                    size = embedder.config.input_size

                    def preprocess(img):
                        return detector.crop_face(img, margin=0.2, target_size=size)

                db = build_db(job.dataset_dir, embedder, preprocess=preprocess,
                              output_path=out_path, progress=progress)
                job.output_files = [out_path]
                job.log(f"built gallery with {len(db)} identities")
            job.set_progress(1.0)
            job.status = "completed"
        except Exception as exc:  # the job records any failure
            job.status = "failed"
            job.error = f"{type(exc).__name__}: {exc}"
            job.logs.append(traceback.format_exc())
        finally:
            job.finished_at = time.time()


_builder_singleton: Optional[DatabaseBuilder] = None
_builder_lock = threading.Lock()


def get_builder(output_root: str = "databases", device: DeviceLike = None) -> DatabaseBuilder:
    """The module's one ``DatabaseBuilder`` (made by the first call)."""
    global _builder_singleton
    with _builder_lock:
        if _builder_singleton is None:
            _builder_singleton = DatabaseBuilder(output_root, device)
        return _builder_singleton

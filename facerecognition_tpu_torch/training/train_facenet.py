"""FaceNet trainer on the card: P×K batches, online mining, verification eval.

Counterpart of ``facerecognition_tpu/training/train_facenet.py``: an
identity-disjoint split with the leakage guard, P×K batches, the fused
mining step (``semi_hard`` / ``batch_hard`` / ``random``, ``remat``),
augmentation tiers on the card (``data/augment``: the ``warp_sample``
kernel's matrix mode), Adam on a ``step`` schedule, best-on-val-loss and
last checkpoints, early stopping, history JSON, d(a,p) / d(a,n) metrics and
``init_from`` warm starts.

    python -m facerecognition_tpu_torch.training.train_facenet \\
        --config configs/facenet_config.yaml --set data.data_dir=<faces>

``data.resident``: ``"auto"`` decodes the train split once into one uint8
tensor on the card when it is at most 4 GiB and gathers each batch there by
index (``steps.make_resident_step``); False streams batches through the
``BatchLoader``. ``train.num_devices`` as in ``train_arcface`` (the global
batch is P×K): on a ``data`` mesh the streaming loader is kept, as in JAX,
and each rank loads its rows; the miners run over the whole batch's
embeddings.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from facerecognition_tpu_torch.convert import flax_to_state_dict
from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws
from facerecognition_tpu_torch.data.datasets import (
    CSVDataset,
    FolderDataset,
    check_identity_overlap,
    split_by_identity,
)
from facerecognition_tpu_torch.data.loader import BatchLoader, _load_resize
from facerecognition_tpu_torch.data.sampler import PKSampler
from facerecognition_tpu_torch.device import DeviceLike, strict_fp32
from facerecognition_tpu_torch.models.facenet import FaceNetModel
from facerecognition_tpu_torch.models.layers import init_like_flax
from facerecognition_tpu_torch.parallel.sharding import replicate
from facerecognition_tpu_torch.training.checkpoint import CheckpointManager
from facerecognition_tpu_torch.training.optim import OptaxChain
from facerecognition_tpu_torch.training.schedules import EarlyStopping, build_schedule
from facerecognition_tpu_torch.training.steps import (
    TrainState,
    make_facenet_train_step,
    make_resident_step,
)
from facerecognition_tpu_torch.training.train_arcface import (
    announce_data_parallel,
    barrier,
    compute_verification_accuracy,
    data_parallel,
    normalize_u8,
    rank0_value,
    rank_rows,
    resolve_config,
    shard_draws,
)
from facerecognition_tpu_torch.utils.serialization import load_variables

DEFAULT_CONFIG: dict[str, Any] = {
    "model": {"embedding_size": 512, "dropout": 0.6},
    "data": {
        "data_dir": None,
        "csv_path": None,
        "image_root": None,
        "image_size": 160,
        "min_images": 2,
        "val_frac": 0.1,
        "augmentation": "light",
        "num_workers": 8,
        # "auto": the train split decoded once into one uint8 tensor on the
        # card when it fits (<= 4 GiB), batches gathered there; False: the
        # streaming BatchLoader.
        "resident": "auto",
    },
    "train": {
        "p_identities": 8,
        "k_images": 4,
        "num_epochs": 30,
        "steps_per_epoch": None,
        "lr": 3e-4,
        "schedule": "step",
        "step_size_epochs": 10,
        "gamma": 0.5,
        "margin": 0.5,
        "mining": "semi_hard",  # semi_hard | batch_hard | random
        "early_stopping_patience": 8,
        "num_devices": "auto",
        "seed": 0,
        # Recompute the backbone's forward in the backward pass.
        "remat": False,
        # Warm start: "<ckpt_dir>:<tag>" (a training checkpoint) or
        # "<file>.msgpack" (a serving checkpoint); the optimizer starts fresh.
        "init_from": None,
    },
    "eval": {"num_pairs": 1000, "batch_size": 128},
    "checkpoint": {"dir": "checkpoints/facenet", "keep_last_n": 3},
}

#: ``data.resident: auto`` keeps a train split up to this many bytes on the card.
RESIDENT_MAX_BYTES = 4 << 30


class FaceNetTrainer:
    def __init__(
        self,
        config: Optional[dict | str] = None,
        overrides: Optional[list[str]] = None,
        device: DeviceLike = None,
    ):
        self.config = resolve_config(config, overrides, DEFAULT_CONFIG)
        t = self.config["train"]
        self.device, self.mesh, self.shard = data_parallel(
            t.get("num_devices", 1), t["p_identities"] * t["k_images"], device
        )
        self.history: list[dict] = []
        self.epoch = 0
        self.best_val_loss = np.inf
        self._setup()

    def _setup(self):
        c = self.config
        d, m, t = c["data"], c["model"], c["train"]
        if d["data_dir"]:
            index = FolderDataset(d["data_dir"], min_images=d["min_images"])
        elif d["csv_path"]:
            index = CSVDataset(d["csv_path"], d["image_root"])
        else:
            raise ValueError("config.data needs data_dir or csv_path")
        # Disjoint identities and the leakage guard (the FaceNet contract).
        self.train_index, self.val_index = split_by_identity(index, d["val_frac"], t["seed"])
        check_identity_overlap(self.train_index, self.val_index)

        model = FaceNetModel(m["embedding_size"], m["dropout"])
        init_like_flax(model, torch.Generator().manual_seed(t["seed"]))
        if t.get("init_from"):
            self._load_init(model, t["init_from"])
        self.model = model.to(self.device)
        if self.mesh is not None:  # every rank starts from rank 0's weights
            replicate(list(self.model.state_dict().values()), self.mesh)
        spe = self._steps_per_epoch()
        schedule = build_schedule(
            t["lr"],
            t["schedule"],
            total_steps=t["num_epochs"] * spe,
            step_size=t["step_size_epochs"] * spe,
            gamma=t["gamma"],
        )
        self.state = TrainState(self.model, OptaxChain(dict(self.model.named_parameters()), "adam", schedule))
        raw_step = make_facenet_train_step(
            margin=float(t["margin"]), mining=t["mining"], remat=bool(t.get("remat", False))
        )
        tier = d["augmentation"]
        shard = self.shard

        def step_with_aug(state, images_u8, labels, generator):
            b, s = images_u8.shape[:2]
            total = b if shard is None else shard.total
            draws = shard_draws(augment_draws(generator, total, s, tier), shard)
            images = apply_augment(images_u8, draws, tier)
            return raw_step(state, normalize_u8(images), labels, generator, shard=shard)

        self._train_step = step_with_aug
        s = d["image_size"]
        # Resident data is flat (N, H·W·3): a row gather, then a reshape.
        self._train_step_resident = make_resident_step(step_with_aug, image_shape=(s, s, 3))
        self._resident_data = None
        self.ckpt = CheckpointManager(c["checkpoint"]["dir"], c["checkpoint"]["keep_last_n"])
        self.early_stopping = EarlyStopping(patience=t["early_stopping_patience"], mode="min")

    @torch.no_grad()
    def _eval_step(self, images_u8: torch.Tensor) -> torch.Tensor:
        with strict_fp32():
            return self.model.eval()(normalize_u8(images_u8))

    def _load_init(self, model: torch.nn.Module, spec: str) -> None:
        """Warm-start the weights and batch statistics from ``dir:tag`` or
        ``*.msgpack``; a tree that does not match the model raises."""
        if spec.endswith(".msgpack"):
            loaded = load_variables(spec)
            try:
                state = flax_to_state_dict({k: loaded.get(k, {}) for k in ("params", "batch_stats")})
                model.load_state_dict(state, strict=True)
            except (RuntimeError, ValueError, KeyError) as exc:
                raise ValueError(f"init_from {spec!r} tree does not match the configured model") from exc
            return
        d, _, tag = spec.rpartition(":")
        tree, _ = CheckpointManager(d or spec).restore(tag or "best", map_location="cpu")
        try:
            model.load_state_dict(tree["model"], strict=True)
        except RuntimeError as exc:
            raise ValueError(f"init_from {spec!r} tree does not match the configured model") from exc

    def _steps_per_epoch(self) -> int:
        t = self.config["train"]
        per_batch = t["p_identities"] * t["k_images"]
        return t["steps_per_epoch"] or max(len(self.train_index) // per_batch, 1)

    def _ensure_resident(self) -> bool:
        """Decode the whole train split once into one uint8 tensor on the
        device (``data.resident``: "auto" up to 4 GiB, True always, False
        never)."""
        if self._resident_data is not None:
            return True
        d = self.config["data"]
        mode = d.get("resident", "auto")
        if mode is False or self.mesh is not None:  # a mesh streams, as in JAX
            return False
        n, s = len(self.train_index), d["image_size"]
        if mode == "auto" and n * s * s * 3 > RESIDENT_MAX_BYTES:
            return False
        arr = np.empty((n, s, s, 3), np.uint8)

        def load(i):
            arr[i] = _load_resize(self.train_index.paths[i], s)

        with ThreadPoolExecutor(d["num_workers"]) as ex:
            list(ex.map(load, range(n)))
        self._resident_data = torch.from_numpy(arr.reshape(n, -1)).to(self.device)
        self._resident_labels = torch.as_tensor(
            np.asarray(self.train_index.labels, np.int64), device=self.device
        )
        return True

    def train_epoch(self) -> dict:
        c = self.config
        t = c["train"]
        sampler = iter(
            PKSampler(self.train_index, t["p_identities"], t["k_images"], seed=t["seed"] + self.epoch)
        )
        gen = torch.Generator(device=self.device).manual_seed(t["seed"] * 77 + self.epoch)
        losses, n_triplets = [], []
        t0 = time.time()
        if self._ensure_resident():
            for _ in range(self._steps_per_epoch()):
                idx = torch.as_tensor(next(sampler), dtype=torch.int64).to(self.device)
                metrics = self._train_step_resident(
                    self.state, self._resident_data, self._resident_labels, idx, gen
                )
                losses.append(float(metrics["loss"]))
                n_triplets.append(float(metrics["n_triplets"]))
        else:
            loader = BatchLoader(
                self.train_index, rank_rows(sampler, self.shard), image_size=c["data"]["image_size"],
                n_workers=c["data"]["num_workers"],
            )
            it = iter(loader)
            try:
                for _ in range(self._steps_per_epoch()):
                    images, labels = next(it)
                    metrics = self._train_step(
                        self.state,
                        torch.from_numpy(images).to(self.device),
                        torch.from_numpy(np.asarray(labels, np.int64)).to(self.device),
                        gen,
                    )
                    losses.append(float(metrics["loss"]))
                    n_triplets.append(float(metrics["n_triplets"]))
            finally:
                loader.stop()
        return {
            "train_loss": float(np.mean(losses)),
            "avg_triplets": float(np.mean(n_triplets)),
            "epoch_seconds": time.time() - t0,
        }

    def embed_validation(self) -> np.ndarray:
        """The val split's embeddings, read through ``_load_resize`` (PIL's
        bilinear pixels), in batches of ``eval.batch_size``."""
        c = self.config
        bs, s = c["eval"]["batch_size"], c["data"]["image_size"]
        idx = self.val_index
        embs = []
        for start in range(0, len(idx), bs):
            chunk = range(start, min(start + bs, len(idx)))
            imgs = np.stack([_load_resize(idx.paths[i], s) for i in chunk])
            embs.append(self._eval_step(torch.from_numpy(imgs).to(self.device)).cpu().numpy())
        return np.concatenate(embs)

    def validation_metrics(self, embeddings: np.ndarray, labels: np.ndarray) -> dict:
        """Verification accuracy, and the triplet loss and mean d(a,p) /
        d(a,n) over up to 500 random valid triplets (numpy)."""
        c = self.config
        ver_acc, thr = compute_verification_accuracy(
            embeddings, labels, c["eval"]["num_pairs"], c["train"]["seed"]
        )
        rng = np.random.default_rng(0)
        d_ap, d_an = [], []
        classes = [int(cl) for cl in np.unique(labels) if (labels == cl).sum() >= 2]
        for _ in range(min(500, len(labels))):
            if len(classes) < 2:
                break
            cpos = int(rng.choice(classes))
            a, p = rng.choice(np.flatnonzero(labels == cpos), 2, replace=False)
            n = rng.choice(np.flatnonzero(labels != cpos))
            d_ap.append(np.linalg.norm(embeddings[a] - embeddings[p]))
            d_an.append(np.linalg.norm(embeddings[a] - embeddings[n]))
        margin = c["train"]["margin"]
        val_loss = (
            float(np.mean(np.maximum(np.asarray(d_ap) - np.asarray(d_an) + margin, 0)))
            if d_ap else 0.0
        )
        return {
            "val_loss": val_loss,
            "ver_acc": ver_acc,
            "ver_threshold": thr,
            "d_ap": float(np.mean(d_ap)) if d_ap else 0.0,
            "d_an": float(np.mean(d_an)) if d_an else 0.0,
        }

    def validate(self) -> dict:
        return self.validation_metrics(self.embed_validation(), self.val_index.labels)

    def train(self) -> list[dict]:
        t = self.config["train"]
        while self.epoch < t["num_epochs"]:
            record = {"epoch": self.epoch}
            record.update(self.train_epoch())
            record.update(self.validate())
            val_loss = rank0_value(record["val_loss"], self.shard, self.device)
            self.history.append(record)
            if self.shard is None or self.shard.rank == 0:
                with open(os.path.join(self.ckpt.directory, "training_history.json"), "w") as f:
                    json.dump(self.history, f, indent=2)
            if val_loss < self.best_val_loss:
                self.best_val_loss = val_loss
                self._save("best")
            self._save("last")
            self.epoch += 1
            if self.early_stopping(val_loss):
                break
        return self.history

    def _save(self, tag: str):
        """Rank 0 writes; every rank waits for it."""
        if self.shard is None or self.shard.rank == 0:
            self._write(tag)
        barrier(self.shard)

    def _write(self, tag: str):
        self.ckpt.save(
            tag,
            {
                "model": self.model.state_dict(),
                "opt_state": self.state.tx.state_dict(),
                "step": self.state.step,
            },
            metadata={
                "epoch": self.epoch,
                "best_val_loss": float(self.best_val_loss),
                "config": self.config,
                "history": self.history,
            },
        )


def main(argv: Optional[list[str]] = None):
    import argparse

    parser = argparse.ArgumentParser(description="Train FaceNet on the card")
    parser.add_argument("--config", default=None)
    parser.add_argument("--mining", default=None, choices=["semi_hard", "batch_hard", "random"])
    parser.add_argument("--set", action="append", default=[])
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)
    overrides = list(args.set)
    if args.mining:
        overrides.append(f"train.mining={args.mining}")
    trainer = FaceNetTrainer(args.config, overrides, device=args.device)
    announce_data_parallel(trainer.shard)
    history = trainer.train()
    print(json.dumps(history[-1] if history else {}, indent=2))


if __name__ == "__main__":
    main()

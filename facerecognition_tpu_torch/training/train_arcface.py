"""ArcFace trainer on the card: YAML config, full resume.

Counterpart of ``facerecognition_tpu/training/train_arcface.py``: warmup +
step/cosine/plateau schedules, SGD/Adam/AdamW with global-norm clipping,
mixup, label smoothing, layer freezing, class-balanced sampling,
augmentation tiers on the card (``data/augment``, whose warp is the
``warp_sample`` kernel's matrix mode), pure-cosine train accuracy,
pair-sampling verification accuracy, best/last/periodic checkpoints with
``keep_last_n``, early stopping, history JSON, and resume with the optimizer
and controller states and auto-extended epochs.

    python -m facerecognition_tpu_torch.training.train_arcface \\
        --config configs/arcface_config.yaml --set data.data_dir=<faces>

``train.num_devices``: data parallelism over the ranks of a
``torch.distributed`` group, one card a rank (``parallel.resolve_data_mesh``):
``"auto"`` is the group's world size, one card when no group is up; the
ranks are started by ``torchrun``, whose environment the trainer reads
(``parallel.multihost.initialize_from_env``)::

    torchrun --nproc_per_node 2 -m facerecognition_tpu_torch.training.train_arcface \\
        --config configs/arcface_config.yaml --set train.num_devices=auto

Each rank loads its rows of the global batch, draws the global batch's
augmentation (and the step's mixup and dropout) from the same generator and
keeps its rows, and runs the data-parallel step (``training/steps.py``):
W ranks with one seed train what one process trains. Rank 0 writes the
checkpoints, the history and the metrics; every rank reads them on resume,
and the early-stopping and plateau decisions take rank 0's validation
metrics. Randomness comes from ``torch.Generator``s seeded from
``train.seed`` (the JAX trainer's ``jax.random`` draws differ).
``device=None`` is the card; the CPU tests pass ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from facerecognition_tpu_torch.convert import state_dict_to_flax
from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws
from facerecognition_tpu_torch.data.datasets import CSVDataset, FolderDataset, split_by_image
from facerecognition_tpu_torch.data.loader import BatchLoader, _load_resize
from facerecognition_tpu_torch.data.sampler import ClassBalancedSampler
from facerecognition_tpu_torch.device import DeviceLike, resolve_device
from facerecognition_tpu_torch.models.arcface import ArcFaceModel, freeze_mask
from facerecognition_tpu_torch.models.layers import init_like_flax
from facerecognition_tpu_torch.parallel.collectives import BatchShard, batch_shard, broadcast_
from facerecognition_tpu_torch.parallel.mesh import resolve_data_mesh
from facerecognition_tpu_torch.parallel.multihost import initialize_from_env
from facerecognition_tpu_torch.parallel.sharding import replicate
from facerecognition_tpu_torch.training.checkpoint import CheckpointManager
from facerecognition_tpu_torch.training.config import apply_dotted_overrides, deep_merge, load_config
from facerecognition_tpu_torch.training.optim import OptaxChain
from facerecognition_tpu_torch.training.schedules import EarlyStopping, ReduceOnPlateau, build_schedule
from facerecognition_tpu_torch.training.steps import (
    TrainState,
    make_arcface_eval_step,
    make_arcface_train_step,
)
from facerecognition_tpu_torch.utils.metrics import MetricsLogger

DEFAULT_CONFIG: dict[str, Any] = {
    "model": {
        "embedding_size": 512,
        "scale": 64.0,
        "margin": 0.2,
        "easy_margin": True,
        "dropout": 0.5,
        "freeze_ratio": 0.0,
    },
    "data": {
        "data_dir": None,
        "csv_path": None,
        "image_root": None,
        "image_size": 112,
        "min_images": 2,
        "val_frac": 0.1,
        "class_balanced": True,
        "augmentation": "normal",
        "num_workers": 8,
    },
    "train": {
        "batch_size": 128,
        "num_epochs": 50,
        "steps_per_epoch": None,  # None → dataset_size / batch_size
        "optimizer": "sgd",
        "lr": 0.01,
        "momentum": 0.9,
        "weight_decay": 5e-4,
        "schedule": "cosine",
        "warmup_epochs": 2,
        "step_size_epochs": 10,
        "gamma": 0.1,
        "grad_clip": 5.0,
        "label_smoothing": 0.1,
        "mixup_alpha": 0.0,
        "margin_warmup_epochs": 0,  # >0: ramp margin from margin_start
        "margin_start": 0.0,
        "early_stopping_patience": 15,
        "early_stopping_metric": "ver_acc",  # ver_acc | val_loss | train_loss
        "plateau_factor": 0.1,
        "plateau_patience": 5,
        "num_devices": "auto",  # "auto": the torch.distributed group's ranks (one card without one)
        "seed": 0,
    },
    "eval": {"num_pairs": 2000, "batch_size": 256},
    "checkpoint": {
        "dir": "checkpoints/arcface",
        "keep_last_n": 3,
        "save_every_epochs": 5,
    },
}


def resolve_config(config, overrides, defaults: dict) -> dict:
    """A path (or None) loads YAML onto ``defaults``; a dict merges onto
    them; ``overrides`` (``a.b=v``) apply last."""
    if config is None or isinstance(config, str):
        return load_config(config, overrides, defaults)
    config = deep_merge(defaults, config)
    return apply_dotted_overrides(config, overrides) if overrides else config


def data_parallel(num_devices, batch_size: int, device: DeviceLike):
    """``train.num_devices`` → (the device, the ``data`` mesh, this rank's
    ``BatchShard``); mesh and shard None on one card. A group is started
    from ``torchrun``'s environment when one is asked for (gloo for
    ``device="cpu"``), before the device is resolved: it sets the rank's
    card."""
    if num_devices not in (None, 0, 1, False):
        cpu = device is not None and torch.device(device).type == "cpu"
        initialize_from_env("gloo" if cpu else None)
    dev = resolve_device(device)
    mesh = resolve_data_mesh(num_devices, batch_size, dev)
    return dev, mesh, (batch_shard(batch_size) if mesh is not None else None)


def announce_data_parallel(shard: Optional[BatchShard]) -> None:
    """A trainer's command line says when it trains on a group."""
    if shard is not None:
        print(f"data-parallel: rank {shard.rank} of {shard.world} ({torch.distributed.get_backend()})",
              flush=True)


def rank_rows(sampler, shard: Optional[BatchShard]):
    """This rank's rows of each global batch of indices."""
    for idx in sampler:
        yield idx if shard is None else idx[shard.start:shard.start + shard.rows]


def shard_draws(draws: dict, shard: Optional[BatchShard]) -> dict:
    """This rank's rows of the global batch's augmentation draws."""
    return draws if shard is None else {k: shard.take(v) for k, v in draws.items()}


def rank0_value(value: float, shard: Optional[BatchShard], device) -> float:
    """``value`` as rank 0 has it, on every rank (one process: itself)."""
    if shard is None:
        return value
    return float(broadcast_(torch.tensor([value], dtype=torch.float64, device=device))[0])


def barrier(shard: Optional[BatchShard]) -> None:
    if shard is not None:
        torch.distributed.barrier()


def compute_verification_accuracy(
    embeddings: np.ndarray, labels: np.ndarray, num_pairs: int = 2000, seed: int = 0
) -> tuple[float, float]:
    """Pair-sampling verification accuracy and its best threshold: num_pairs/2
    same-identity and num_pairs/2 different-identity pairs, 200 thresholds
    over the observed cosine range. (0.0, 0.5) on a split without a positive
    pair or without two identities."""
    rng = np.random.default_rng(seed)
    by_class: dict[int, np.ndarray] = {}
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        if len(idx) >= 2:
            by_class[int(c)] = idx
    if not by_class or len(np.unique(labels)) < 2:
        return 0.0, 0.5
    classes = np.asarray(list(by_class))
    n_half = num_pairs // 2

    sims, truth = [], []
    for _ in range(n_half):  # positive pairs
        c = int(rng.choice(classes))
        i, j = rng.choice(by_class[c], 2, replace=False)
        sims.append(float(embeddings[i] @ embeddings[j]))
        truth.append(1)
    all_classes = np.unique(labels)
    for _ in range(n_half):  # negative pairs
        c1, c2 = rng.choice(all_classes, 2, replace=False)
        i = rng.choice(np.flatnonzero(labels == c1))
        j = rng.choice(np.flatnonzero(labels == c2))
        sims.append(float(embeddings[i] @ embeddings[j]))
        truth.append(0)
    sims = np.asarray(sims)
    truth = np.asarray(truth)

    best_acc, best_thr = 0.0, 0.5
    for thr in np.linspace(sims.min(), sims.max(), 200):
        acc = float(np.mean((sims >= thr) == truth))
        if acc > best_acc:
            best_acc, best_thr = acc, float(thr)
    return best_acc, best_thr


def schedule_of(config: dict, steps_per_epoch: int):
    """The learning-rate schedule of the current config: its horizons come
    from ``train.num_epochs`` (rebuild it after changing them)."""
    t = config["train"]
    return build_schedule(
        t["lr"],
        t["schedule"],
        total_steps=t["num_epochs"] * steps_per_epoch,
        warmup_steps=t["warmup_epochs"] * steps_per_epoch,
        step_size=t["step_size_epochs"] * steps_per_epoch,
        gamma=t["gamma"],
    )


def build_tx(config: dict, steps_per_epoch: int, model: torch.nn.Module) -> OptaxChain:
    """The JAX trainer's ``_build_tx``: clip → (SGD: decayed weights) →
    sgd/adam/adamw → (plateau: scale), over the parameters ``freeze_ratio``
    leaves trainable."""
    t = config["train"]
    schedule = schedule_of(config, steps_per_epoch)
    opt = t["optimizer"].lower()
    params = dict(model.named_parameters())
    ratio = config["model"]["freeze_ratio"]
    return OptaxChain(
        params,
        opt,
        schedule,
        momentum=t["momentum"],
        weight_decay=t["weight_decay"] if opt in ("sgd", "adamw") else 0.0,
        grad_clip=t["grad_clip"],
        plateau=t["schedule"] == "plateau",
        trainable=freeze_mask(params, ratio) if ratio > 0 else None,
    )


def margin_schedule_of(config: dict, steps_per_epoch: int):
    """The margin ramp (``train.margin_warmup_epochs`` > 0) as ``step →
    margin``, in float32 as the JAX trainer computes it; None without one."""
    t = config["train"]
    if t.get("margin_warmup_epochs", 0) <= 0:
        return None
    f32 = np.float32
    m_final, m_start = config["model"]["margin"], t.get("margin_start", 0.0)
    warm_steps = t["margin_warmup_epochs"] * steps_per_epoch

    def margin_schedule(step: int) -> float:
        frac = np.clip(f32(step) / f32(warm_steps), f32(0), f32(1))
        return float(f32(m_start) + frac * f32(m_final - m_start))

    return margin_schedule


def normalize_u8(images: torch.Tensor) -> torch.Tensor:
    """``(x / 255 - 0.5) / 0.5`` in float32."""
    return (images.float() / 255.0 - 0.5) / 0.5


class ArcFaceTrainer:
    def __init__(
        self,
        config: Optional[dict | str] = None,
        overrides: Optional[list[str]] = None,
        device: DeviceLike = None,
    ):
        self.config = resolve_config(config, overrides, DEFAULT_CONFIG)
        t = self.config["train"]
        self.device, self.mesh, self.shard = data_parallel(
            t.get("num_devices", 1), t["batch_size"], device
        )
        self.history: list[dict] = []
        self.epoch = 0
        self.global_step = 0
        # ver_acc is maximised, losses minimised.
        self.metric_mode = (
            "max" if self.config["train"]["early_stopping_metric"] == "ver_acc" else "min"
        )
        self.best_metric = -np.inf if self.metric_mode == "max" else np.inf
        self._setup_data()
        self._setup_model()
        self._setup_optimizer()
        self.ckpt = CheckpointManager(
            self.config["checkpoint"]["dir"], self.config["checkpoint"]["keep_last_n"]
        )
        self.metrics_logger = MetricsLogger(self.ckpt.directory)
        t = self.config["train"]
        self.early_stopping = EarlyStopping(patience=t["early_stopping_patience"], mode=self.metric_mode)
        self.plateau = ReduceOnPlateau(
            factor=t["plateau_factor"], patience=t["plateau_patience"], mode=self.metric_mode
        )

    # -- setup --------------------------------------------------------------

    def _setup_data(self):
        d = self.config["data"]
        if d["data_dir"]:
            index = FolderDataset(d["data_dir"], min_images=d["min_images"])
        elif d["csv_path"]:
            index = CSVDataset(d["csv_path"], d["image_root"])
        else:
            raise ValueError("config.data needs data_dir or csv_path")
        self.train_index, self.val_index = split_by_image(
            index, d["val_frac"], self.config["train"]["seed"]
        )
        self.num_classes = index.num_classes

    def _setup_model(self):
        m = self.config["model"]
        model = ArcFaceModel(
            m["embedding_size"],
            num_classes=self.num_classes,
            scale=m["scale"],
            margin=m["margin"],
            easy_margin=m["easy_margin"],
            dropout=m["dropout"],
        )
        init_like_flax(model, torch.Generator().manual_seed(self.config["train"]["seed"]), ("fc",))
        self.model = model.to(self.device)
        if self.mesh is not None:  # every rank starts from rank 0's weights
            replicate(list(self.model.state_dict().values()), self.mesh)

    def _steps_per_epoch(self) -> int:
        t = self.config["train"]
        return t["steps_per_epoch"] or max(len(self.train_index) // t["batch_size"], 1)

    def _build_tx(self) -> OptaxChain:
        return build_tx(self.config, self._steps_per_epoch(), self.model)

    def _setup_optimizer(self):
        t = self.config["train"]
        self.state = TrainState(self.model, self._build_tx())
        tier = self.config["data"]["augmentation"]
        raw_step = make_arcface_train_step(
            label_smoothing=t["label_smoothing"],
            mixup_alpha=t["mixup_alpha"],
            margin_schedule=margin_schedule_of(self.config, self._steps_per_epoch()),
        )

        shard = self.shard

        def step_with_aug(state, images_u8, labels, generator):
            b, s = images_u8.shape[:2]
            total = b if shard is None else shard.total
            draws = shard_draws(augment_draws(generator, total, s, tier), shard)
            images = apply_augment(images_u8, draws, tier)
            return raw_step(state, normalize_u8(images), labels, generator, shard=shard)

        self._train_step = step_with_aug
        raw_eval = make_arcface_eval_step()
        self._eval_step = lambda state, images_u8: raw_eval(state, normalize_u8(images_u8))

    # -- loops --------------------------------------------------------------

    def _make_loader(self) -> BatchLoader:
        t, d = self.config["train"], self.config["data"]
        if d["class_balanced"]:
            sampler = iter(
                ClassBalancedSampler(self.train_index, t["batch_size"], seed=t["seed"] + self.epoch)
            )
        else:
            rng = np.random.default_rng(t["seed"] + self.epoch)

            def random_batches():
                while True:
                    yield rng.choice(len(self.train_index), t["batch_size"])

            sampler = random_batches()
        return BatchLoader(
            self.train_index, rank_rows(sampler, self.shard), image_size=d["image_size"],
            n_workers=d["num_workers"],
        )

    def _generator(self, salt: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(salt)

    def train_epoch(self) -> dict:
        loader = self._make_loader()
        spe = self._steps_per_epoch()
        losses, accs = [], []
        gen = self._generator(self.config["train"]["seed"] * 1000 + self.epoch)
        t0 = time.time()
        it = iter(loader)
        try:
            for step in range(spe):
                images, labels = next(it)
                # uint8 to the card; the step casts there
                metrics = self._train_step(
                    self.state,
                    torch.from_numpy(images).to(self.device),
                    torch.from_numpy(np.asarray(labels, np.int64)).to(self.device),
                    gen,
                )
                self.global_step += 1
                if step % 20 == 0 or step == spe - 1:
                    losses.append(float(metrics["loss"]))
                    accs.append(float(metrics["train_acc"]))
        finally:
            loader.stop()
        return {
            "train_loss": float(np.mean(losses)),
            "train_acc": float(np.mean(accs)),
            "epoch_seconds": time.time() - t0,
        }

    def embed_validation(self) -> tuple[np.ndarray, np.ndarray]:
        """The val split's unit embeddings, read through ``_load_resize``
        (PIL's bilinear pixels), and its labels."""
        size = self.config["data"]["image_size"]
        bs = self.config["eval"]["batch_size"]
        idx = self.val_index
        embs, labels = [], []
        for start in range(0, len(idx), bs):
            chunk = list(range(start, min(start + bs, len(idx))))
            imgs = np.stack([_load_resize(idx.paths[i], size) for i in chunk])
            emb = self._eval_step(self.state, torch.from_numpy(imgs).to(self.device))
            embs.append(emb.cpu().numpy())
            labels.append(idx.labels[chunk])
        return np.concatenate(embs), np.concatenate(labels)

    def validation_metrics(self, embeddings: np.ndarray, labels: np.ndarray) -> dict:
        """Verification accuracy, and the CE and accuracy of the margin-free
        scaled-cosine logits against the margin weight (numpy)."""
        e = self.config["eval"]
        ver_acc, thr = compute_verification_accuracy(
            embeddings, labels, e["num_pairs"], self.config["train"]["seed"]
        )
        w = self.model.arcface.weight.detach().cpu().numpy()
        w = w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
        logits = self.config["model"]["scale"] * embeddings @ w.T
        logits -= logits.max(axis=1, keepdims=True)
        logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
        val_loss = float(-logp[np.arange(len(labels)), labels].mean())
        val_acc = float((logits.argmax(axis=1) == labels).mean())
        return {"ver_acc": ver_acc, "ver_threshold": thr, "val_loss": val_loss, "val_acc": val_acc}

    def validate(self) -> dict:
        """Embed the val split and compute verification accuracy."""
        return self.validation_metrics(*self.embed_validation())

    def train(self) -> list[dict]:
        t = self.config["train"]
        ck = self.config["checkpoint"]
        while self.epoch < t["num_epochs"]:
            train_metrics = self.train_epoch()
            val_metrics = self.validate()
            record = {
                "epoch": self.epoch,
                "global_step": self.global_step,
                **train_metrics,
                **val_metrics,
            }
            name = t["early_stopping_metric"]
            if name == "ver_acc":
                metric = val_metrics["ver_acc"]
            elif name == "val_loss":
                metric = val_metrics["val_loss"]
            elif name == "train_loss":
                metric = train_metrics["train_loss"]
            else:
                raise ValueError(f"unknown early_stopping_metric {name!r}")
            metric = rank0_value(metric, self.shard, self.device)
            improved = metric > self.best_metric if self.metric_mode == "max" else metric < self.best_metric
            if improved:
                self.best_metric = metric
                self.save_checkpoint("best")
            if t["schedule"] == "plateau":
                # before the history write, so lr_scale lands in this epoch's record
                record["lr_scale"] = self._apply_plateau_scale(self.plateau.update(metric))
            self.history.append(record)
            self._write_history()
            if self.shard is None or self.shard.rank == 0:
                self.metrics_logger.log(self.global_step, record, prefix="arcface/")
            self.save_checkpoint("last")
            if ck["save_every_epochs"] and (self.epoch + 1) % ck["save_every_epochs"] == 0:
                self.save_checkpoint(f"epoch_{self.epoch}")
            self.epoch += 1
            if self.early_stopping(metric):
                break
        return self.history

    def _apply_plateau_scale(self, scale: float) -> float:
        """Write the plateau scale into the chain (the JAX trainer's injected
        ``optax.scale`` hyperparameter); without a plateau chain nothing."""
        if self.state.tx.plateau:
            self.state.tx.scale = float(scale)
        return scale

    # -- persistence --------------------------------------------------------

    def _write_history(self):
        if self.shard is not None and self.shard.rank:
            return
        with open(os.path.join(self.ckpt.directory, "training_history.json"), "w") as f:
            json.dump(self.history, f, indent=2)

    def save_checkpoint(self, tag: str):
        """Rank 0 writes; every rank waits for it."""
        if self.shard is None or self.shard.rank == 0:
            self._save_checkpoint(tag)
        barrier(self.shard)

    def _save_checkpoint(self, tag: str):
        tree = {
            "model": self.model.state_dict(),
            "opt_state": self.state.tx.state_dict(),
            "step": self.state.step,
        }
        self.ckpt.save(
            tag,
            tree,
            metadata={
                "epoch": self.epoch,
                "global_step": self.global_step,
                "best_metric": float(self.best_metric),
                "num_classes": self.num_classes,
                "config": self.config,
                "history": self.history,
                "early_stopping": self.early_stopping.state_dict(),
                "plateau": self.plateau.state_dict(),
            },
        )

    def export_variables(self) -> dict:
        """The model as flax variables (``params`` with the margin head,
        ``batch_stats``), for ``utils/serialization.save_variables``."""
        return state_dict_to_flax(self.model.state_dict())

    def resume(
        self, tag: str = "last", reset_optimizer: bool = False, extend_epochs: Optional[int] = None
    ):
        """Restore the model, optimizer and controllers. ``extend_epochs``
        adds epochs past the stored ``num_epochs``; a checkpoint already at
        its end gets 10 more."""
        tree, meta = self.ckpt.restore(tag, map_location=self.device)
        self.model.load_state_dict(tree["model"])
        if not reset_optimizer:
            self.state.tx.load_state_dict(tree["opt_state"])
        self.state.step = int(tree["step"])
        self.epoch = meta.get("epoch", 0) + 1
        self.global_step = meta.get("global_step", 0)
        self.best_metric = meta.get("best_metric", -np.inf if self.metric_mode == "max" else np.inf)
        self.history = meta.get("history", [])
        if meta.get("early_stopping"):
            self.early_stopping.load_state_dict(meta["early_stopping"])
        if meta.get("plateau"):
            self.plateau.load_state_dict(meta["plateau"])
        old_epochs = self.config["train"]["num_epochs"]
        if extend_epochs:
            self.config["train"]["num_epochs"] = self.epoch + extend_epochs
        elif self.epoch >= self.config["train"]["num_epochs"]:
            self.config["train"]["num_epochs"] = self.epoch + 10  # auto-extend
        if self.config["train"]["num_epochs"] != old_epochs:
            # The schedule's horizons follow num_epochs: without a rebuild a
            # decayed cosine would hold its end value every extended epoch.
            self.state.tx.schedule = schedule_of(self.config, self._steps_per_epoch())
        return meta


def main(argv: Optional[list[str]] = None):
    import argparse

    parser = argparse.ArgumentParser(description="Train ArcFace on the card")
    parser.add_argument("--config", default=None)
    parser.add_argument("--resume", default=None, help="checkpoint tag")
    parser.add_argument("--set", action="append", default=[], help="override key=value")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)
    trainer = ArcFaceTrainer(args.config, args.set, device=args.device)
    announce_data_parallel(trainer.shard)
    if args.resume:
        trainer.resume(args.resume)
    history = trainer.train()
    print(json.dumps(history[-1] if history else {}, indent=2))


if __name__ == "__main__":
    main()

"""Recognition-accuracy-at-scale training on synthetic identities.

Counterpart of ``facerecognition_tpu/training/train_synthid.py``: ArcFace
trained on a many-identity procedural dataset
(``synthetic_faces.identity_dataset``, rendered on the host), then measured
by top-1/top-5 retrieval against class prototypes and a verification
ROC/EER. The recipe is the JAX module's: a fingerprinted npz cache of the
rendered set, a train/validation split by sample index modulo the samples
per identity, ``ArcFaceModel(stage_sizes=...)`` with its margin head, the
chain clip-by-global-norm(5) → decayed weights → SGD with momentum on
``warmup_cosine_decay(0, lr, min(total // 20 + 1, 500), total)``, the margin
ramped over two epochs, "light" augmentation on the card (the warp through
``warp_sample``'s matrix mode) then ``(x / 255 - 0.5) / 0.5``, a resident or
streaming batch source, a per-epoch crash checkpoint with a ``stage_sizes``
marker and resume from it.

Randomness: the data order comes from ``np.random.default_rng(seed + 1)``
as in JAX (its permutations are drawn for every epoch, also the ones a
resume skips); the augmentation and dropout draws come from a
``torch.Generator`` per epoch seeded from ``(seed, epoch)``, not from JAX's
keys. ``step_with_aug`` takes given augmentation draws too.

Run: python -m facerecognition_tpu_torch.training.train_synthid --n-ids 500
(on the card; ``--device cpu`` for the plain path on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from facerecognition_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from facerecognition_tpu_torch.data.augment import apply_augment, augment_draws
from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32
from facerecognition_tpu_torch.models.arcface import ArcFaceModel
from facerecognition_tpu_torch.models.layers import init_like_flax
from facerecognition_tpu_torch.ops.image import normalize_imagenet_style
from facerecognition_tpu_torch.training.optim import OptaxChain
from facerecognition_tpu_torch.training.schedules import warmup_cosine_decay
from facerecognition_tpu_torch.training.steps import (
    TrainState,
    make_arcface_train_step,
    make_resident_step,
)

AUG_TIER = "light"
DEFAULT_STAGES = (3, 4, 6, 3)  # a checkpoint without the marker is ResNet50


@dataclasses.dataclass
class SynthIdConfig:
    n_ids: int = 500
    train_per_id: int = 24
    val_per_id: int = 6
    batch_size: int = 128
    epochs: int = 15
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 5e-4
    margin: float = 0.2
    scale: float = 64.0
    label_smoothing: float = 0.1
    embedding_size: int = 512
    seed: int = 0
    # ArcFace backbone depth: (3, 4, 6, 3) = ResNet50 (reference parity);
    # (2, 2, 2, 2) = slim serving variant (marker saved in the checkpoint).
    stage_sizes: tuple = (3, 4, 6, 3)
    cache: Optional[str] = None  # npz path: render once, reuse across runs
    # Keep the uint8 train set resident on the card when it fits (one
    # transfer for the whole run, batches gathered there by index).
    device_data_budget_bytes: int = 5 << 30
    ckpt_path: Optional[str] = None  # per-epoch crash checkpoint (msgpack)
    resume: bool = False


@torch.no_grad()
def _embed_all(model: ArcFaceModel, images_u8: np.ndarray, device, batch: int = 256) -> np.ndarray:
    """Unit embeddings of a uint8 (N, S, S, 3) array in fixed-size batches
    (the last one zero-padded), computed on ``device``."""
    model.eval()
    out = []
    n = len(images_u8)
    for i in range(0, n, batch):
        chunk = np.ascontiguousarray(images_u8[i : i + batch])
        if len(chunk) < batch:  # one shape for every call
            chunk = np.concatenate([chunk, np.zeros((batch - len(chunk),) + chunk.shape[1:], chunk.dtype)])
        x = normalize_imagenet_style(torch.from_numpy(chunk).to(device))
        with strict_fp32():
            emb = model(x).float()
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)
        out.append(emb.cpu().numpy())
    return np.concatenate(out)[:n]


def evaluate_retrieval(train_emb, train_labels, val_emb, val_labels, n_ids) -> dict:
    """Top-1/top-5 retrieval against class prototypes + verification ROC/EER.

    Gallery: the per-class mean prototypes of the train split; queries: the
    validation images. Verification pairs: each consecutive same-id
    validation pair positive, as many random different-id pairs negative
    (``np.random.default_rng(0)``).
    """
    from facerecognition_tpu_torch.inference.evaluate import cmc_curve, roc_eer, top_k_accuracy
    from facerecognition_tpu_torch.ops.matcher import compute_prototypes

    protos = compute_prototypes(
        torch.as_tensor(np.asarray(train_emb, np.float32)), torch.as_tensor(np.asarray(train_labels)), n_ids
    ).numpy()
    scores = val_emb @ protos.T  # (Nv, C) cosine (all normalized)
    out = top_k_accuracy(scores, val_labels, ks=(1, 5))
    out["cmc"] = cmc_curve(scores, val_labels, max_rank=20)

    rng = np.random.default_rng(0)
    pos_a, pos_b, neg_a, neg_b = [], [], [], []
    by_class: dict[int, list[int]] = {}
    for i, lab in enumerate(val_labels):
        by_class.setdefault(int(lab), []).append(i)
    for lab, idxs in by_class.items():
        for j in range(len(idxs) - 1):
            pos_a.append(idxs[j])
            pos_b.append(idxs[j + 1])
    n_pairs = len(pos_a)
    if n_pairs == 0:
        raise ValueError(
            "evaluate_retrieval needs two or more validation samples of an identity "
            "for verification pairs (val_per_id >= 2)"
        )
    labs = np.asarray(val_labels)
    for _ in range(n_pairs):
        while True:
            i, j = rng.integers(0, len(val_labels), 2)
            if labs[i] != labs[j]:
                neg_a.append(i)
                neg_b.append(j)
                break
    pair_scores = np.concatenate(
        [
            np.sum(val_emb[pos_a] * val_emb[pos_b], axis=1),
            np.sum(val_emb[neg_a] * val_emb[neg_b], axis=1),
        ]
    )
    pair_labels = np.concatenate([np.ones(n_pairs), np.zeros(n_pairs)])
    roc = roc_eer(pair_labels, pair_scores)
    out.update({k: roc[k] for k in ("auc", "eer", "eer_threshold")})
    return out


def dataset_fingerprint(config: SynthIdConfig) -> dict:
    """Everything the rendered set depends on: a cache is reused only when
    its fingerprint matches exactly."""
    return {
        "n_ids": config.n_ids,
        "k_total": config.train_per_id + config.val_per_id,
        "train_per_id": config.train_per_id,
        "seed": config.seed,
        "out_size": 112,
    }


def load_or_render(config: SynthIdConfig, log: Callable = print) -> tuple[np.ndarray, np.ndarray]:
    """The (N, 112, 112, 3) uint8 identity set and its labels: from
    ``config.cache`` when it exists (a fingerprint mismatch raises
    ``ValueError``; a cache without one is checked by its sample count
    only), else rendered (and written to the cache when one is named)."""
    from facerecognition_tpu_torch.training.synthetic_faces import identity_dataset

    k_total = config.train_per_id + config.val_per_id
    fingerprint = dataset_fingerprint(config)
    if config.cache and os.path.exists(config.cache):
        log(f"loading cached dataset {config.cache} ...")
        with np.load(config.cache) as z:
            imgs, labels = z["imgs"], z["labels"]
            cached_fp = json.loads(str(z["fingerprint"])) if "fingerprint" in z else None
        if cached_fp is None:
            if len(imgs) != config.n_ids * k_total:
                raise ValueError(
                    f"cache {config.cache} has {len(imgs)} samples, expected "
                    f"{config.n_ids * k_total} ({config.n_ids} ids x {k_total})"
                )
            log(f"WARNING: {config.cache} has no fingerprint (legacy cache); "
                f"cannot verify seed/split match {fingerprint}")
        elif cached_fp != fingerprint:
            raise ValueError(
                f"cache {config.cache} was rendered with {cached_fp}, "
                f"this run needs {fingerprint} — delete the cache or point "
                "--cache elsewhere"
            )
        return imgs, labels
    log(f"rendering {config.n_ids} ids x {k_total} samples ...")
    imgs, labels = identity_dataset(config.n_ids, k_total, out_size=112, seed=config.seed)
    if config.cache:
        np.savez(config.cache, imgs=imgs, labels=labels, fingerprint=json.dumps(fingerprint))
        log(f"cached dataset -> {config.cache}")
    return imgs, labels


def split_train_val(imgs, labels, config: SynthIdConfig):
    """Sample i is train when ``i % (train_per_id + val_per_id) <
    train_per_id``."""
    k = config.train_per_id + config.val_per_id
    mask = (np.arange(len(imgs)) % k) < config.train_per_id
    return imgs[mask], labels[mask], imgs[~mask], labels[~mask]


def build_model(config: SynthIdConfig, num_classes: Optional[int] = None) -> ArcFaceModel:
    """``ArcFaceModel`` of the config (with the margin head unless
    ``num_classes`` is 0), initialised as flax initialises it from
    ``torch.Generator().manual_seed(seed)``, on the CPU."""
    model = ArcFaceModel(
        config.embedding_size,
        tuple(config.stage_sizes),
        num_classes=config.n_ids if num_classes is None else num_classes,
        scale=config.scale,
        margin=config.margin,
    )
    return init_like_flax(model, torch.Generator().manual_seed(config.seed), ("fc",))


def build_tx(model: torch.nn.Module, config: SynthIdConfig, total_steps: int) -> OptaxChain:
    """``chain(clip_by_global_norm(5), add_decayed_weights(wd),
    sgd(warmup_cosine_decay(0, lr, min(total // 20 + 1, 500), total),
    momentum))``."""
    sched = warmup_cosine_decay(0.0, config.lr, min(total_steps // 20 + 1, 500), total_steps)
    return OptaxChain(
        dict(model.named_parameters()),
        "sgd",
        sched,
        momentum=config.momentum,
        weight_decay=config.weight_decay,
        grad_clip=5.0,
    )


def margin_ramp(margin: float, ramp_steps: int) -> Callable[[int], float]:
    """``margin * min(step / ramp_steps, 1)`` in float32."""
    f32 = np.float32

    def schedule(step: int) -> float:
        return float(f32(margin) * np.minimum(f32(step) / f32(ramp_steps), f32(1.0)))

    return schedule


def make_step_with_aug(config: SynthIdConfig, steps_per_epoch: int) -> Callable:
    """``step(state, images_u8, labels, generator=None, draws=None)``: the
    "light" augmentation (its draws from ``generator`` unless given), then
    ``(x / 255 - 0.5) / 0.5`` and the ArcFace step (dropout from
    ``generator``)."""
    raw_step = make_arcface_train_step(
        label_smoothing=config.label_smoothing,
        margin_schedule=margin_ramp(config.margin, 2 * steps_per_epoch),
    )

    def step_with_aug(state, images_u8, labels, generator=None, draws=None):
        b, s = images_u8.shape[:2]
        if draws is None:
            draws = augment_draws(generator, b, s, AUG_TIER, device=images_u8.device)
        images = apply_augment(images_u8, draws, AUG_TIER)
        images = (images / 255.0 - 0.5) / 0.5
        return raw_step(state, images, labels, generator)

    return step_with_aug


def variables_of(model: ArcFaceModel) -> dict:
    """The model's flax ``{"params", "batch_stats"}`` (margin head
    included)."""
    return state_dict_to_flax(model.state_dict())


def train_synthid(config: SynthIdConfig, log: Callable = print, device: DeviceLike = None):
    """Train + evaluate; returns (variables, metrics_history, final_eval)."""
    from facerecognition_tpu_torch.utils.serialization import load_variables, save_variables

    dev = resolve_device(device)
    if config.val_per_id < 2:
        raise ValueError(
            f"val_per_id={config.val_per_id}: the verification pairs of the final "
            "evaluation need two or more validation samples per identity"
        )
    t0 = time.time()
    imgs, labels = load_or_render(config, log)
    tr_imgs, tr_labels, va_imgs, va_labels = split_train_val(imgs, labels, config)
    log(f"dataset: train {tr_imgs.shape} val {va_imgs.shape} ({time.time() - t0:.0f}s)")

    if len(tr_imgs) < config.batch_size:
        raise ValueError(
            f"train set ({len(tr_imgs)}) smaller than batch_size "
            f"({config.batch_size}) — raise --n-ids/--train-per-id or "
            "lower --batch-size"
        )
    model = build_model(config).to(dev)
    steps_per_epoch = max(len(tr_imgs) // config.batch_size, 1)
    total_steps = steps_per_epoch * config.epochs
    state = TrainState(model, build_tx(model, config, total_steps))
    step_with_aug = make_step_with_aug(config, steps_per_epoch)

    resident = tr_imgs.nbytes <= config.device_data_budget_bytes
    if resident:
        data_dev = torch.from_numpy(np.ascontiguousarray(tr_imgs.reshape(len(tr_imgs), -1))).to(dev)
        labels_dev = torch.from_numpy(tr_labels.astype(np.int64)).to(dev)
        step_fn = make_resident_step(step_with_aug, image_shape=tr_imgs.shape[1:])
    else:
        step_fn = step_with_aug
    log(f"batch source: {'card-resident' if resident else 'host-streaming'} "
        f"({tr_imgs.nbytes / 2**30:.1f} GiB uint8)")

    def crash_save(epoch, history):
        if not config.ckpt_path:
            return
        tmp = config.ckpt_path + ".tmp"
        tree = variables_of(model)
        tree["stage_sizes"] = np.asarray(config.stage_sizes, np.int32)
        save_variables(tmp, tree)
        os.replace(tmp, config.ckpt_path)
        # The meta follows the checkpoint: a kill between the two replaces
        # leaves an older meta, and resume re-runs one epoch.
        meta_tmp = config.ckpt_path + ".meta.json.tmp"
        with open(meta_tmp, "w") as f:
            json.dump({"epoch": epoch, "history": history}, f)
        os.replace(meta_tmp, config.ckpt_path + ".meta.json")

    history: list = []
    start_epoch = 0
    if config.resume and config.ckpt_path and os.path.exists(config.ckpt_path):
        tree = load_variables(config.ckpt_path)
        raw_stages = tree.pop("stage_sizes", None)
        ckpt_stages = (
            tuple(int(v) for v in np.asarray(raw_stages)) if raw_stages is not None else DEFAULT_STAGES
        )
        if ckpt_stages != tuple(config.stage_sizes):
            raise ValueError(
                f"checkpoint {config.ckpt_path} was trained with "
                f"stage_sizes={ckpt_stages}, this run asks for "
                f"{tuple(config.stage_sizes)} — point --ckpt elsewhere"
            )
        sd = flax_to_state_dict(tree, include_head=True)
        model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
        try:
            with open(config.ckpt_path + ".meta.json") as f:
                meta = json.load(f)
            start_epoch = meta["epoch"] + 1
            history = meta["history"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError) as e:
            log(f"resume: ckpt ok but meta unreadable ({e}); "
                "restarting epoch count with loaded weights")
        log(f"resumed from {config.ckpt_path} at epoch {start_epoch} (optimizer state restarts)")

    data_rng = np.random.default_rng(config.seed + 1)
    for epoch in range(config.epochs):
        perm = data_rng.permutation(len(tr_imgs))
        if epoch < start_epoch:
            continue  # the permutation is drawn anyway: resume stays deterministic
        gen = torch.Generator(device=dev).manual_seed((config.seed + 2) * 100003 + epoch)
        losses, accs = [], []
        te = time.time()
        for s in range(steps_per_epoch):
            sel = perm[s * config.batch_size : (s + 1) * config.batch_size]
            if resident:
                idx = torch.from_numpy(sel.astype(np.int64)).to(dev)
                metrics = step_fn(state, data_dev, labels_dev, idx, gen)
            else:
                metrics = step_fn(
                    state,
                    torch.from_numpy(np.ascontiguousarray(tr_imgs[sel])).to(dev),
                    torch.from_numpy(tr_labels[sel].astype(np.int64)).to(dev),
                    gen,
                )
            losses.append(metrics["loss"])
            accs.append(metrics["train_acc"])
        row = {
            "epoch": epoch,
            "loss": float(torch.stack(losses).mean()),
            "train_acc": float(torch.stack(accs).mean()),
            "sec": round(time.time() - te, 1),
        }
        history.append(row)
        crash_save(epoch, history)
        log(f"epoch {epoch}: loss {row['loss']:.4f} train_acc {row['train_acc']:.3f} ({row['sec']}s)")
    tr_emb = _embed_all(model, tr_imgs, dev)
    va_emb = _embed_all(model, va_imgs, dev)
    final = evaluate_retrieval(tr_emb, tr_labels, va_emb, va_labels, config.n_ids)
    log("final eval: " + json.dumps(final))
    return variables_of(model), history, final


def serving_checkpoint(variables: dict, stage_sizes) -> dict:
    """The serving checkpoint of trained variables: the margin head dropped
    (``load_arcface_model`` builds the model without one) and, for a depth
    other than ResNet50's, the ``stage_sizes`` marker."""
    params = {k: v for k, v in variables["params"].items() if k != "arcface"}
    ckpt = {"params": params, "batch_stats": variables["batch_stats"]}
    if tuple(stage_sizes) != DEFAULT_STAGES:
        ckpt["stage_sizes"] = np.asarray(stage_sizes, np.int32)
    return ckpt


def main(argv: Optional[list] = None):
    from facerecognition_tpu_torch.utils.serialization import save_variables

    ap = argparse.ArgumentParser()
    ap.add_argument("--n-ids", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--train-per-id", type=int, default=24)
    ap.add_argument("--val-per-id", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--out", default="assets/arcface_synthid_512.msgpack")
    ap.add_argument("--report", default="docs/SYNTHID_EVAL.json")
    ap.add_argument("--cache", default=None, help="npz dataset cache (render once, reuse)")
    ap.add_argument("--ckpt", default=None, help="per-epoch crash checkpoint path (msgpack)")
    ap.add_argument("--resume", action="store_true", help="resume from --ckpt if it exists")
    ap.add_argument("--stage-sizes", default="3,4,6,3",
                    help="backbone blocks per stage; 2,2,2,2 = slim variant")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    config = SynthIdConfig(
        n_ids=args.n_ids,
        epochs=args.epochs,
        train_per_id=args.train_per_id,
        val_per_id=args.val_per_id,
        batch_size=args.batch_size,
        lr=args.lr,
        cache=args.cache,
        ckpt_path=args.ckpt,
        resume=args.resume,
        stage_sizes=tuple(int(v) for v in args.stage_sizes.split(",")),
    )
    variables, history, final = train_synthid(config, device=args.device)
    save_variables(args.out, serving_checkpoint(variables, config.stage_sizes))
    with open(args.report, "w") as f:
        json.dump({"config": dataclasses.asdict(config), "history": history, "final": final}, f, indent=2)
    print(f"saved {args.out} and {args.report}")
    return variables, history, final


if __name__ == "__main__":
    main()

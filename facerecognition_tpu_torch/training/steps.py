"""Training steps of the ArcFace and FaceNet trainers.

Counterpart of ``facerecognition_tpu/training/steps.py``. A step takes a
``TrainState`` (the model, its ``OptaxChain`` and the update count), updates
it in place, and returns its metrics as 0-d tensors (reading them is the
caller's synchronisation):

- ArcFace (``make_arcface_train_step``): mixup, label-smoothed cross-entropy
  over the margin head's logits, the raw gradients' global norm, and the
  margin-free cosine train accuracy under the parameters before the update.
  The margin schedule reads the update count before the update. Under mixup
  the margin sits at the primary labels only, so the permuted-label term
  scores a margin-free logit, as in the JAX step.
- FaceNet (``make_facenet_train_step``): one forward; the miners pick
  triplets on a detached copy of its embeddings and the loss is taken on the
  forward itself. ``remat`` recomputes the forward in the backward pass
  (``torch.utils.checkpoint``), with the dropout draws and the batch-norm
  statistics' update made once.

Randomness (dropout, mixup, random negatives) comes from the generator a
step is given; ``mix=`` and ``negatives=`` take given draws instead. Each
step's ``gradients`` attribute is its first half: the forward (which updates
the batch-norm statistics) and the gradients by parameter name, with the
metrics; ``apply_gradients`` is the second.
Everything runs under ``device.strict_fp32`` (no TF32).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from facerecognition_tpu_torch.device import strict_fp32
from facerecognition_tpu_torch.models.facenet import (
    masked_triplet_loss,
    mine_batch_hard,
    mine_semi_hard,
)
from facerecognition_tpu_torch.models.layers import set_stat_updates
from facerecognition_tpu_torch.ops.matcher import l2_normalize
from facerecognition_tpu_torch.training.optim import OptaxChain, global_norm

MINING = ("semi_hard", "batch_hard", "random")


class TrainState:
    """The model, its optimizer chain and the number of updates made
    (``step``, the JAX ``TrainState.step``)."""

    def __init__(self, model: torch.nn.Module, tx: OptaxChain, step: int = 0):
        self.model = model
        self.tx = tx
        self.step = step


def apply_gradients(state: TrainState, grads: dict) -> None:
    """One optimizer update from ``grads`` (by parameter name); the update
    count goes up by one."""
    state.tx.update(grads)
    state.step += 1


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """Mean cross-entropy against one-hot targets smoothed by
    ``label_smoothing`` (``t (1 - ls) + ls / C``)."""
    num_classes = logits.shape[-1]
    one_hot = F.one_hot(labels.long(), num_classes).to(logits.dtype)
    if label_smoothing > 0:
        one_hot = one_hot * (1.0 - label_smoothing) + label_smoothing / num_classes
    return -torch.mean(torch.sum(one_hot * F.log_softmax(logits, dim=-1), dim=-1))


def mixup_draws(generator: Optional[torch.Generator], b: int, alpha: float, device):
    """λ ~ Beta(α, α) and a permutation of the batch: (λ, perm (b,) int64).
    λ is drawn by numpy from a seed the generator gives (PyTorch's Beta
    sampler takes no generator)."""
    seed = int(torch.randint(0, 2**62, (), generator=generator, device=device))
    lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    perm = torch.randperm(b, generator=generator, device=device)
    return lam, perm


def mixup_batch(images: torch.Tensor, lam: float, perm: torch.Tensor) -> torch.Tensor:
    """``lam * x + (1 - lam) * x[perm]``."""
    lam = torch.as_tensor(lam, dtype=images.dtype, device=images.device)
    return lam * images + (1.0 - lam) * images[perm]


def _named_params(model: torch.nn.Module):
    names, params = zip(*model.named_parameters())
    return list(names), list(params)


def make_arcface_train_step(
    label_smoothing: float = 0.1,
    mixup_alpha: float = 0.0,
    margin_schedule: Optional[Callable[[int], float]] = None,
) -> Callable:
    """``step(state, images, labels, generator=None, mix=None) -> metrics``
    with ``loss``, ``train_acc`` and ``grad_norm``; images are normalised
    (B, S, S, 3) float32. ``margin_schedule(step) -> margin``."""

    def gradients(state: TrainState, images, labels, generator=None, mix=None):
        model = state.model.train()
        margin = margin_schedule(state.step) if margin_schedule is not None else None
        use_mixup = mixup_alpha > 0.0
        if use_mixup:
            lam, perm = mix if mix is not None else mixup_draws(
                generator, images.shape[0], mixup_alpha, images.device
            )
            images = mixup_batch(images, lam, perm)
        names, params = _named_params(model)
        with strict_fp32():
            logits, emb = model(images, labels=labels, margin_override=margin, generator=generator)
            loss = softmax_cross_entropy(logits, labels, label_smoothing)
            if use_mixup:
                loss = lam * loss + (1.0 - lam) * softmax_cross_entropy(
                    logits, labels[perm], label_smoothing
                )
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                cos = l2_normalize(emb, dim=1) @ l2_normalize(model.arcface.weight, dim=1).T
                acc = (torch.argmax(cos, dim=1) == labels).float().mean()
        metrics = {"loss": loss.detach(), "train_acc": acc, "grad_norm": global_norm(grads)}
        return dict(zip(names, grads)), metrics

    def step(state: TrainState, images, labels, generator=None, mix=None):
        grads, metrics = gradients(state, images, labels, generator, mix)
        apply_gradients(state, grads)
        return metrics

    step.gradients = gradients
    return step


def make_arcface_eval_step() -> Callable:
    """``step(state, images) -> (B, D)`` unit embeddings (no margin head)."""

    @torch.no_grad()
    def step(state: TrainState, images):
        with strict_fp32():
            return l2_normalize(state.model.eval()(images), dim=1)

    return step


def random_triplets(labels: torch.Tensor, negatives: torch.Tensor):
    """The ``random`` miner: anchor i, positive i + 1 (the same identity
    under K-grouping), negative ``negatives[i]`` (a permutation)."""
    ai = torch.arange(labels.shape[0], device=labels.device)
    pi = torch.roll(ai, -1)
    ni = negatives.to(labels.device)
    valid = (labels[ai] == labels[pi]) & (labels[ai] != labels[ni])
    return ai, pi, ni, valid


def make_facenet_train_step(
    margin: float = 0.5, mining: str = "semi_hard", remat: bool = False
) -> Callable:
    """``step(state, images, labels, generator=None, negatives=None) ->
    metrics`` with ``loss`` and ``n_triplets``; ``negatives``: the random
    miner's permutation (drawn from the generator when None)."""
    if mining not in MINING:
        raise ValueError(f"unknown mining {mining}")

    def gradients(state: TrainState, images, labels, generator=None, negatives=None):
        model = state.model.train()
        names, params = _named_params(model)
        with strict_fp32():
            if remat:
                start = None if generator is None else generator.get_state()

                def forward(x):
                    if start is not None:  # the recomputation draws the same dropout
                        generator.set_state(start)
                    return model(x, generator=generator)

                emb = torch.utils.checkpoint.checkpoint(forward, images, use_reentrant=False)
            else:
                emb = model(images, generator=generator)
            mined = emb.detach()
            if mining == "semi_hard":
                ai, pi, ni, valid = mine_semi_hard(mined, labels, margin)
            elif mining == "batch_hard":
                ai, pi, ni, valid = mine_batch_hard(mined, labels)
            else:
                if negatives is None:
                    negatives = torch.randperm(
                        images.shape[0], generator=generator, device=images.device
                    )
                ai, pi, ni, valid = random_triplets(labels, negatives)
            loss = masked_triplet_loss(emb, ai, pi, ni, valid, margin)
            set_stat_updates(model, False)
            try:
                grads = torch.autograd.grad(loss, params)
            finally:
                set_stat_updates(model, True)
        metrics = {"loss": loss.detach(), "n_triplets": valid.float().sum()}
        return dict(zip(names, grads)), metrics

    def step(state: TrainState, images, labels, generator=None, negatives=None):
        grads, metrics = gradients(state, images, labels, generator, negatives)
        apply_gradients(state, grads)
        return metrics

    step.gradients = gradients
    return step


def make_resident_step(step_fn: Callable, image_shape: Optional[tuple] = None) -> Callable:
    """``step_resident(state, data, labels_all, idx, generator=None)``: the
    dataset lives on the card as one uint8 tensor, each step gathers its
    batch by index there. With ``image_shape`` (H, W, C), ``data`` is flat
    (N, H·W·C) and the gathered rows are reshaped to images."""

    def step_resident(state, data, labels_all, idx, generator=None):
        batch = data.index_select(0, idx)
        if image_shape is not None:
            batch = batch.reshape((idx.shape[0],) + tuple(image_shape))
        return step_fn(state, batch, labels_all.index_select(0, idx), generator)

    return step_resident

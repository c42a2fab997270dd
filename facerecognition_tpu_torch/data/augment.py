"""Device-side augmentation: the five tiers as draws and their application.

Counterpart of ``facerecognition_tpu/data/augment.py``'s ``augment_batch``,
split in two so the draws can be given:

- ``augment_draws(generator, b, s, tier)`` draws, for each image, what
  ``augment_batch`` draws from ``jax.random``, with its distributions and
  ranges: the flip, the rotation θ (radians), the scale, the shift (pixels),
  the affine gate, brightness, the contrast factor, the gray gate, and the
  cutout origin and gate;
- ``apply_augment(images, draws, tier)`` applies them in JAX's order:
  flip → shift/scale/rotate → brightness/contrast → grayscale → cutout →
  clip to [0, 255].

The shift/scale/rotate warp is ``ops/warp_sample.affine_warp``
(``fast=False``, as in JAX): one launch of the ``warp_sample`` kernel on
the card, the plain two-pass warp on the CPU. The flip of integer pixels is
exact, so uint8 frames are flipped as they are and the kernel reads uint8
(JAX casts to float32 first: the values are the same).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from facerecognition_tpu_torch.ops import warp_sample
from facerecognition_tpu_torch.ops.umeyama import fma

AUG_TIERS: Dict[str, Dict[str, Any]] = {
    "none": dict(
        p_flip=0.0, rot=0.0, shift=0.0, scale=0.0, p_affine=0.0,
        brightness=0.0, contrast=0.0, p_gray=0.0, p_cutout=0.0, cutout_frac=0.0,
    ),
    "light": dict(
        p_flip=0.5, rot=5.0, shift=0.02, scale=0.05, p_affine=0.3,
        brightness=0.1, contrast=0.1, p_gray=0.0, p_cutout=0.0, cutout_frac=0.0,
    ),
    "normal": dict(
        p_flip=0.5, rot=10.0, shift=0.05, scale=0.1, p_affine=0.5,
        brightness=0.2, contrast=0.2, p_gray=0.05, p_cutout=0.2, cutout_frac=0.15,
    ),
    "strong": dict(
        p_flip=0.5, rot=15.0, shift=0.08, scale=0.15, p_affine=0.7,
        brightness=0.3, contrast=0.3, p_gray=0.1, p_cutout=0.3, cutout_frac=0.2,
    ),
    "heavy": dict(
        p_flip=0.5, rot=20.0, shift=0.1, scale=0.2, p_affine=0.8,
        brightness=0.4, contrast=0.4, p_gray=0.15, p_cutout=0.5, cutout_frac=0.25,
    ),
}

#: Grayscale weights (ITU-R 601), as ``augment_batch`` sums them.
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


def cutout_size(s: int, frac: float) -> int:
    return max(int(s * frac), 1)


def augment_draws(
    generator: Optional[torch.Generator], b: int, s: int, tier: str, device=None
) -> dict:
    """The tier's draws for a batch of ``b`` images of side ``s``, on the
    generator's device (or ``device``): a dict of (b,) or (b, 2) tensors,
    only the families the tier uses."""
    p = AUG_TIERS[tier]
    dev = device if device is not None else (generator.device if generator is not None else "cpu")

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    def bernoulli(prob, shape):
        return torch.rand(shape, generator=generator, device=dev) < prob

    draws = {}
    if p["p_flip"] > 0:
        draws["flip"] = bernoulli(p["p_flip"], (b,))
    if p["p_affine"] > 0:
        draws["theta"] = uniform((b,), -1.0, 1.0) * p["rot"] * math.pi / 180.0
        draws["scale"] = 1.0 + uniform((b,), -p["scale"], p["scale"])
        draws["shift"] = uniform((b, 2), -p["shift"], p["shift"]) * s
        draws["affine"] = bernoulli(p["p_affine"], (b,))
    if p["brightness"] > 0 or p["contrast"] > 0:
        draws["bright"] = uniform((b,), -p["brightness"], p["brightness"])
        draws["contrast"] = 1.0 + uniform((b,), -p["contrast"], p["contrast"])
    if p["p_gray"] > 0:
        draws["gray"] = bernoulli(p["p_gray"], (b,))
    if p["p_cutout"] > 0:
        hi = s - cutout_size(s, p["cutout_frac"])
        draws["cutout"] = torch.randint(0, hi, (b, 2), generator=generator, device=dev)
        draws["cutout_on"] = bernoulli(p["p_cutout"], (b,))
    return draws


def affine_matrices(draws: dict, s: int) -> torch.Tensor:
    """(b, 2, 3) forward maps: rotate by θ and scale about the image centre,
    then shift; the identity where the affine gate is off."""
    do = draws["affine"]
    theta = torch.where(do, draws["theta"], 0.0)
    scale = torch.where(do, draws["scale"], 1.0)
    shift = torch.where(do[:, None], draws["shift"], 0.0)
    # The trigonometry in float64, rounded once, and the centring terms as
    # fmas: XLA's float32 cos/sin are nearer these than PyTorch's, and it
    # contracts c - cos c + sin c into fmas. An ulp of a map entry moves a
    # sample by up to 1e-5 px, which is 1e-3 levels on pixel noise.
    cos = torch.cos(theta.double()).float() * scale
    sin = torch.sin(theta.double()).float() * scale
    c = torch.tensor((s - 1) / 2.0, device=theta.device)
    tx = fma(sin, c, fma(-cos, c, c)) + shift[:, 0]
    ty = fma(-cos, c, fma(-sin, c, c)) + shift[:, 1]
    return torch.stack(
        [torch.stack([cos, -sin, tx], -1), torch.stack([sin, cos, ty], -1)], 1
    ).float()


def apply_augment(images: torch.Tensor, draws: dict, tier: str) -> torch.Tensor:
    """Augment a (B, S, S, 3) uint8 or float [0, 255] batch with ``draws``:
    (B, S, S, 3) float32 in [0, 255] (on the card after the warp, an NHWC
    view of NCHW memory)."""
    p = AUG_TIERS[tier]
    s = images.shape[1]
    dev = images.device
    imgs = images
    if p["p_flip"] > 0:
        imgs = torch.where(draws["flip"].to(dev)[:, None, None, None], imgs.flip(2), imgs)
    if p["p_affine"] > 0:
        ms = affine_matrices({k: draws[k].to(dev) for k in ("theta", "scale", "shift", "affine")}, s)
        imgs = warp_sample.affine_warp(imgs.contiguous(), ms, s, s, fast=False)
    else:
        imgs = imgs.float()
    if p["brightness"] > 0 or p["contrast"] > 0:
        bright = draws["bright"].to(dev)[:, None, None, None]
        contr = draws["contrast"].to(dev)[:, None, None, None]
        imgs = (imgs - 127.5) * contr + 127.5 + bright * 255.0
    if p["p_gray"] > 0:
        w = torch.tensor(GRAY_WEIGHTS, dtype=torch.float32, device=dev)
        gray = torch.sum(imgs * w, dim=-1, keepdim=True)
        imgs = torch.where(draws["gray"].to(dev)[:, None, None, None], gray.expand_as(imgs), imgs)
    if p["p_cutout"] > 0:
        size = cutout_size(s, p["cutout_frac"])
        origin = draws["cutout"].to(dev)
        cx, cy = origin[:, 0, None, None], origin[:, 1, None, None]
        steps = torch.arange(s, device=dev)
        xs, ys = steps[None, None, :], steps[None, :, None]
        hole = (xs >= cx) & (xs < cx + size) & (ys >= cy) & (ys < cy + size)
        on = hole & draws["cutout_on"].to(dev)[:, None, None]
        imgs = torch.where(on[..., None], 127.5, imgs)
    return torch.clamp(imgs, 0.0, 255.0)

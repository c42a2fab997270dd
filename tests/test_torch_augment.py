"""The port's training augmentation against the JAX package's on the CPU.

``apply_augment`` is fed the draws ``augment_batch`` takes from its key
(rebuilt here with ``jax.random``, split as ``data/augment.py`` splits it)
and must give JAX's batch within 1e-3 levels for every tier, beyond the gap
between ``augment_batch``'s fused warp and JAX's own standalone one.
``augment_draws`` is held to the tiers' ranges and rates by its moments.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_tpu.data.augment import AUG_TIERS as JAX_TIERS
from facerecognition_tpu.data.augment import augment_batch
from facerecognition_tpu_torch.data.augment import (
    AUG_TIERS,
    affine_matrices,
    apply_augment,
    augment_draws,
    cutout_size,
)
from facerecognition_tpu_torch.ops import warp_mxu
from facerecognition_tpu_torch.ops import warp_sample as ws

LEVELS_TOL = 1e-3  # levels of [0, 255]
B, S = 12, 40

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs six workers on the machine's
    cores, and PyTorch's default of one thread a core in each of them
    oversubscribes it (a ResNet50 step then takes minutes). One thread
    also fixes the order of the CPU's reductions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def jax_draws(key, b: int, s: int, tier: str) -> dict:
    """What ``augment_batch(key, ..., tier)`` draws, as the port's draws."""
    p = JAX_TIERS[tier]
    keys = jax.random.split(key, 8)
    out = {}
    if p["p_flip"] > 0:
        out["flip"] = jax.random.bernoulli(keys[0], p["p_flip"], (b, 1, 1, 1)).reshape(b)
    if p["p_affine"] > 0:
        out["theta"] = (
            jax.random.uniform(keys[1], (b,), minval=-1.0, maxval=1.0) * p["rot"] * jnp.pi / 180.0
        )
        out["scale"] = 1.0 + jax.random.uniform(keys[2], (b,), minval=-p["scale"], maxval=p["scale"])
        out["shift"] = (
            jax.random.uniform(keys[3], (b, 2), minval=-p["shift"], maxval=p["shift"]) * s
        )
        out["affine"] = jax.random.bernoulli(keys[4], p["p_affine"], (b,))
    if p["brightness"] > 0 or p["contrast"] > 0:
        out["bright"] = jax.random.uniform(
            keys[5], (b, 1, 1, 1), minval=-p["brightness"], maxval=p["brightness"]
        ).reshape(b)
        out["contrast"] = (1.0 + jax.random.uniform(
            jax.random.fold_in(keys[5], 1), (b, 1, 1, 1), minval=-p["contrast"], maxval=p["contrast"]
        )).reshape(b)
    if p["p_gray"] > 0:
        out["gray"] = jax.random.bernoulli(keys[6], p["p_gray"], (b, 1, 1, 1)).reshape(b)
    if p["p_cutout"] > 0:
        size = max(int(s * p["cutout_frac"]), 1)
        cx = jax.random.randint(keys[7], (b, 1, 1), 0, s - size).reshape(b)
        cy = jax.random.randint(jax.random.fold_in(keys[7], 1), (b, 1, 1), 0, s - size).reshape(b)
        out["cutout"] = jnp.stack([cx, cy], 1)
        out["cutout_on"] = jax.random.bernoulli(
            jax.random.fold_in(keys[7], 2), p["p_cutout"], (b, 1, 1, 1)
        ).reshape(b)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def test_tiers_are_jax_tiers():
    assert AUG_TIERS == JAX_TIERS


def smooth_images(rng, b: int, s: int, block: int = 4) -> np.ndarray:
    """Pixel noise on a grid ``block`` pixels apart, bilinearly interpolated:
    uint8 frames whose values change by at most 255 / ``block`` a pixel, as
    a face's do."""
    coarse = torch.from_numpy(rng.integers(0, 256, (b, 3, s // block + 1, s // block + 1)).astype(np.float32))
    fine = torch.nn.functional.interpolate(coarse, scale_factor=block, mode="bilinear", align_corners=False)
    return fine[:, :, :s, :s].permute(0, 2, 3, 1).round().to(torch.uint8).numpy()


def jax_matrices(draws: dict, s: int) -> np.ndarray:
    """``augment_batch``'s forward maps from the draws, by XLA (jitted, as
    inside ``augment_batch``)."""

    def maps(theta, scale, shift, do):
        theta = jnp.where(do, theta, 0.0)
        scale = jnp.where(do, scale, 1.0)
        shift = jnp.where(do[:, None], shift, 0.0)
        cos, sin = jnp.cos(theta) * scale, jnp.sin(theta) * scale
        c = (s - 1) / 2.0
        tx = c - cos * c + sin * c + shift[:, 0]
        ty = c - sin * c - cos * c + shift[:, 1]
        return jnp.stack([jnp.stack([cos, -sin, tx], -1), jnp.stack([sin, cos, ty], -1)], axis=1)

    args = (jnp.asarray(draws[k].numpy()) for k in ("theta", "scale", "shift", "affine"))
    return np.asarray(jax.jit(maps)(*args))


def test_affine_matrices_equal_jax():
    """The maps against XLA's: the linear part within 2 float32 ulps (XLA's
    cos/sin are not correctly rounded; the port rounds float64 ones), the
    translation within 4 ulps of the side (its terms cancel), most entries
    equal."""
    eps = float(np.finfo(np.float32).eps)
    equal = total = 0
    for seed in range(2):
        for s in (40, 112, 160):
            d = jax_draws(jax.random.PRNGKey(seed), 128, s, "heavy")
            want = jax_matrices(d, s)
            got = affine_matrices(d, s).numpy()
            np.testing.assert_array_max_ulp(got[:, :, :2], want[:, :, :2], maxulp=2)
            np.testing.assert_allclose(got[:, :, 2], want[:, :, 2], rtol=0, atol=4 * eps * s)
            equal += int((got == want).sum())
            total += got.size
    assert equal >= 0.98 * total


def test_affine_warp_plain_equals_jax_on_pixel_noise(rng):
    """Given XLA's maps, the plain two-pass warp is JAX's within 1e-3 levels
    on pixel noise (the sharpest input: a sample moved by 1e-5 px there moves
    a value by 2.5e-3 levels, so the maps are compared above)."""
    from facerecognition_tpu.ops.warp_mxu import affine_warp_mxu_batch as jax_warp

    images = rng.integers(0, 256, (B, S, S, 3)).astype(np.float32)
    ms = jax_matrices(jax_draws(jax.random.PRNGKey(7), B, S, "heavy"), S)
    want = np.asarray(jax.jit(lambda x, m: jax_warp(x, m, S, S))(jnp.asarray(images), jnp.asarray(ms)))
    got = warp_mxu.affine_warp_mxu_batch(torch.from_numpy(images), torch.from_numpy(ms), S, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVELS_TOL)


def jax_fusion_gap(monkeypatch, images: np.ndarray, key, s: int) -> float:
    """How far ``augment_batch``'s own warp (XLA fuses the maps into it and
    rounds the sample positions otherwise) is from JAX's standalone
    ``affine_warp_mxu_batch`` on the same frames and maps: max |Δ| levels."""
    import facerecognition_tpu.data.augment as jax_augment
    from facerecognition_tpu.ops.warp_mxu import affine_warp_mxu_batch as jax_warp

    only_warp = dict(JAX_TIERS["heavy"], p_flip=0.0, brightness=0.0, contrast=0.0, p_gray=0.0,
                     p_cutout=0.0)
    monkeypatch.setitem(jax_augment.AUG_TIERS, "warp_only", only_warp)
    fused = np.asarray(augment_batch(key, jnp.asarray(images), "warp_only"))
    ms = jax_matrices(jax_draws(key, len(images), s, "heavy"), s)
    alone = jax.jit(lambda x, m: jax_warp(x, m, s, s))(jnp.asarray(images, jnp.float32), jnp.asarray(ms))
    return float(np.abs(np.clip(np.asarray(alone), 0, 255) - fused).max())


@pytest.mark.parametrize("tier", sorted(JAX_TIERS))
def test_apply_augment_equals_jax(tier, rng, monkeypatch):
    """Within 1e-3 levels of ``augment_batch`` on the same draws (smooth
    frames), plus the gap between ``augment_batch``'s fused warp and JAX's
    own standalone warp (which the port follows within 3e-5 levels, above):
    measured 1.6e-3 at this key's steepest slopes. The gates of this key take
    both values where the tier draws them."""
    images = smooth_images(rng, B, S)
    key = jax.random.PRNGKey(7)
    want = np.asarray(augment_batch(key, jnp.asarray(images), tier))
    draws = jax_draws(key, B, S, tier)
    for gate in ("flip", "affine", "cutout_on"):
        if gate in draws:
            assert 0 < int(draws[gate].sum()) < B, gate
    got = apply_augment(torch.from_numpy(images), draws, tier)
    assert got.dtype == torch.float32 and got.shape == (B, S, S, 3)
    gap = jax_fusion_gap(monkeypatch, images, key, S) if "theta" in draws else 0.0
    assert gap < 5e-3
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVELS_TOL + gap)


def test_apply_augment_float_frames_equal_uint8(rng):
    images = rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8)
    draws = augment_draws(torch.Generator().manual_seed(3), B, S, "heavy")
    a = apply_augment(torch.from_numpy(images), draws, "heavy")
    b = apply_augment(torch.from_numpy(images).float(), draws, "heavy")
    assert torch.equal(a, b)


def test_augment_draws_moments():
    """Ranges and rates of each family for every tier, over 40,000 draws
    (rates within 0.01, uniform means within 0.01 of the half range, their
    standard deviations within 2% of range / sqrt(12))."""
    n, s = 40_000, 112
    for tier, p in AUG_TIERS.items():
        d = augment_draws(torch.Generator().manual_seed(11), n, s, tier)
        for gate, rate in (("flip", p["p_flip"]), ("affine", p["p_affine"]), ("gray", p["p_gray"]),
                           ("cutout_on", p["p_cutout"])):
            if rate > 0:
                assert d[gate].dtype == torch.bool
                assert abs(d[gate].float().mean().item() - rate) < 0.01, (tier, gate)
            else:
                assert gate not in d
        uniforms = []
        if p["p_affine"] > 0:
            half = p["rot"] * math.pi / 180.0
            uniforms += [(d["theta"], 0.0, half), (d["scale"], 1.0, p["scale"]),
                         (d["shift"].flatten(), 0.0, p["shift"] * s)]
        if p["brightness"] > 0:
            uniforms += [(d["bright"], 0.0, p["brightness"]), (d["contrast"], 1.0, p["contrast"])]
        for x, centre, half in uniforms:
            assert x.min().item() >= centre - half - 1e-5 and x.max().item() <= centre + half + 1e-5
            assert abs(x.mean().item() - centre) < 0.01 * half
            assert abs(x.std().item() / (2 * half / math.sqrt(12)) - 1) < 0.02
        if p["p_cutout"] > 0:
            hi = s - cutout_size(s, p["cutout_frac"])
            c = d["cutout"]
            assert c.min().item() == 0 and c.max().item() == hi - 1
            assert abs(c.float().mean().item() - (hi - 1) / 2) < 0.02 * hi


def test_affine_matrices_identity_where_gated_off():
    d = augment_draws(torch.Generator().manual_seed(5), 64, S, "heavy")
    ms = affine_matrices(d, S)
    off = ~d["affine"]
    assert off.any()
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    assert torch.allclose(ms[off], eye.expand(int(off.sum()), 2, 3), atol=1e-5)
    on = d["affine"]
    det = ms[on, 0, 0] * ms[on, 1, 1] - ms[on, 0, 1] * ms[on, 1, 0]
    assert torch.allclose(det, d["scale"][on] ** 2, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("fast", [False, True])
def test_affine_warp_on_cpu_takes_the_plain_path(dtype, fast, rng):
    """On CPU tensors ``affine_warp`` is ``affine_warp_mxu_batch`` (bit for
    bit) and launches nothing; its slot parameters are the plain
    coefficients."""
    frames = torch.from_numpy(rng.integers(0, 256, (4, 24, 30, 3)).astype(np.uint8)).to(dtype)
    ms = affine_matrices(augment_draws(torch.Generator().manual_seed(1), 4, 24, "heavy"), 24)
    before = ws.launches.count
    got = ws.affine_warp(frames, ms, 20, 26, fast)
    assert torch.equal(got, warp_mxu.affine_warp_mxu_batch(frames, ms, 20, 26, fast=fast))
    params = ws.affine_slot_parameters(frames, ms, 20)
    coef = warp_mxu.warp_coefficients(warp_mxu.invert_affine(ms))
    assert torch.equal(params[:, :6], coef) and not params[:, 6:].any()
    assert ws.launches.count == before

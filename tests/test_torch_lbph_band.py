"""The arithmetic of ``csrc/lbph_hist.cu``, mirrored in plain PyTorch on the CPU.

The kernel turns ``tap_plan`` (as ``plan_words``) into fma operands with no
branch on the plan: taps 0 and 1 swapped where step 0 is FMA_RIGHT, tap k
rounded as fl(v * m_k), step s fused as fma(x, y_s, t), m and y in {w, 1};
and for the plans of (r 1, P 8) and (r 2, P 8) it compiles the taps'
offsets in (``STATIC_TAPS``). These tests hold the operand form against
``lbp_code_image`` bit for bit, and the compiled offsets against the plans.
"""

import os
import re

import numpy as np
import pytest
import torch

from facerecognition_tpu_torch.ops import lbph_hist as lh
from facerecognition_tpu_torch.ops.umeyama import fma

SOURCE = os.path.join(os.path.dirname(lh.__file__), os.pardir, "csrc", "lbph_hist.cu")


def launcher_taps(radius: int, neighbors: int):
    """What ``lbph_hist_launch`` makes of the plan words: per neighbour the
    taps' (dy, dx) in its order, m[4] and y[3]."""
    words = lh.plan_words(radius, neighbors)
    weights = words[:, 8:12].copy().view(np.float32)
    out = []
    for n in range(neighbors):
        ops = words[n, 12:15]
        order = [1, 0, 2, 3] if ops[0] == lh.FMA_RIGHT else [0, 1, 2, 3]
        offs, m, y = [], [], [0.0, 0.0, 0.0]
        for k in range(4):
            w = float(weights[n, order[k]])
            offs.append((int(words[n, order[k]]), int(words[n, 4 + order[k]])))
            fused = k != 1 and ops[0 if k == 0 else k - 1] != lh.ADD
            m.append(1.0 if fused else w)
            if k != 1:
                y[0 if k == 0 else k - 1] = w if fused else 1.0
        out.append((offs, m, y))
    return out


def operand_codes(gray: torch.Tensor, radius: int, neighbors: int) -> torch.Tensor:
    """The kernel's codes: per neighbour t = fma(fl(v0 m0), y0, fl(v1 m1)),
    then t = fma(fl(vk mk), y, t) for taps 2 and 3; the bit where t > centre
    or |t - centre| < eps."""
    img = gray.float()
    h, w = img.shape[-2:]
    r = radius

    def tap(dy, dx):
        return img[..., r + dy : h - r + dy, r + dx : w - r + dx]

    centre = tap(0, 0)
    code = torch.zeros(centre.shape, dtype=torch.int32)
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    for n, (offs, m, y) in enumerate(launcher_taps(radius, neighbors)):
        v = [tap(*o) for o in offs]
        t = fma(v[0] * np.float32(m[0]), f64(y[0]), v[1] * np.float32(m[1]))
        t = fma(v[2] * np.float32(m[2]), f64(y[1]), t)
        t = fma(v[3] * np.float32(m[3]), f64(y[2]), t)
        bit = (t > centre) | ((t - centre).abs() < np.finfo(np.float32).eps)
        code |= bit.int() << n
    return code


def _images(rng, side: int = 40) -> torch.Tensor:
    flat = np.full((side, side), 200.0)
    noise = rng.integers(0, 256, (side, side)).astype(np.float64)
    coarse = rng.integers(30, 226, (side // 8 + 1, side // 8 + 1))
    blocky = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:side, :side] + rng.integers(-12, 13, (side, side))
    special = noise.copy()
    special[5, 5], special[9, 12], special[20, 3], special[30, 30] = np.nan, np.inf, -np.inf, -0.0
    return torch.from_numpy(np.stack([flat, noise, blocky, special]).astype(np.float32))


@pytest.mark.parametrize("radius, neighbors", [(1, 8), (2, 8), (3, 8), (1, 4), (2, 16), (1, 10)])
def test_operand_form_equals_the_plan(radius, neighbors):
    imgs = _images(np.random.default_rng(radius * 100 + neighbors))
    got = operand_codes(imgs, radius, neighbors)
    want = lh.lbp_code_image(imgs, radius, neighbors)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _static_taps() -> np.ndarray:
    with open(SOURCE) as f:
        text = f.read()
    body = re.search(r"STATIC_TAPS\[2\]\[8\]\[4\]\[2\] = \{(.*?)\};", text, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)]).reshape(2, 8, 4, 2)


@pytest.mark.parametrize("radius", [1, 2])
def test_static_taps_are_the_plans_offsets(radius):
    """The offsets compiled into the specialised kernel are the plan's, in
    the launcher's order."""
    want = np.array([offs for offs, _, _ in launcher_taps(radius, 8)])
    np.testing.assert_array_equal(_static_taps()[radius - 1], want)

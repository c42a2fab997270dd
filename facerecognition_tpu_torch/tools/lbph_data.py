"""Generated gray faces for the LBPH path's checks and measurements.

``chip_smoke.py``, ``tools/kernel_breakdown.py`` and
``tools/checkout_compare.py`` draw their LBPH inputs from ``lbph_faces``, so
the three measure the same data. It imports only ``torch``:
``checkout_compare`` loads it from its file in processes whose package is
another checkout's.
"""

from __future__ import annotations

import torch

#: Side of a generated face, in pixels.
LBPH_SIDE = 100


def lbph_faces(gen: torch.Generator, identities: int, samples: int, device) -> torch.Tensor:
    """(identities·samples, 100, 100) float32 gray faces on ``device``,
    sample s of identity i at row i·samples + s: each identity a blocky
    pattern of its own, each sample it plus integer noise (a new draw for
    probes)."""
    side = LBPH_SIDE
    coarse = torch.randint(30, 226, (identities, 1, 13, 13), generator=gen, device=device)
    base = torch.nn.functional.interpolate(coarse.float(), scale_factor=8, mode="nearest")
    base = base[:, 0, :side, :side]
    noise = torch.randint(-12, 13, (identities, samples, side, side), generator=gen, device=device)
    faces = (base[:, None] + noise).clamp(0, 255).reshape(-1, side, side)
    return faces.contiguous()

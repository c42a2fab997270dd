"""Embed-only throughput of ArcFace backbone variants on one device.

Counterpart of ``scripts/bench_embed.py``: what the slim (2,2,2,2) backbone
buys over the full ResNet50 (3,4,6,3) at serving batch sizes. Each variant
is a randomly initialised ``ArcFaceModel`` (512-d, float32; seeded with
``torch.manual_seed(0)``) fed ``--batch`` random 112² uint8-range images
(``default_rng(0)``), normalised, embedded and L2-normalised.

Method (``utils/profiling.ms_per_call``): the JAX script scans ``--iters``
batches inside one ``jit``; here ``--iters`` calls run between two CUDA
events after a warm-up call; the best of 3 rounds, as images per second
(wall clock with ``--device cpu``). Counterpart of the reference's
embed-only cell (1,592 img/s max batched).

    python -m facerecognition_tpu_torch.scripts.bench_embed \\
        [--batch 256] [--iters 16] [--variants 3,4,6,3 2,2,2,2] [--device cpu]

Prints one JSON line per variant: ``stage_sizes``, ``img_per_sec``,
``batch``, ``vs_reference_1592``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from facerecognition_tpu_torch.device import DeviceLike, resolve_device, strict_fp32

REFERENCE_IMG_PER_SEC = 1592.0

#: The keys of each variant's line (the JAX script's).
REPORT_KEYS = ("stage_sizes", "img_per_sec", "batch", "vs_reference_1592")


def variant_model(stage_sizes):
    """The variant's ``ArcFaceModel`` (eval mode, on the CPU)."""
    from facerecognition_tpu_torch.models.arcface import ArcFaceModel

    torch.manual_seed(0)
    return ArcFaceModel(embedding_size=512, stage_sizes=tuple(stage_sizes)).eval()


def variant_forward(model, device: torch.device):
    """The timed function: (B, 112, 112, 3) floats → L2-normalised (B, 512)."""
    from facerecognition_tpu_torch.ops.image import normalize_imagenet_style
    from facerecognition_tpu_torch.ops.matcher import l2_normalize

    model = model.to(device).eval()

    def forward(x):
        return l2_normalize(model(normalize_imagenet_style(x)).float())

    return forward


def frames(batch: int, device: torch.device) -> torch.Tensor:
    """The JAX script's images: ``default_rng(0).integers(0, 256, (batch,
    112, 112, 3))`` as float32."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, 256, (batch, 112, 112, 3)).astype(np.float32), device=device)


def bench_variant(stage_sizes, batch: int, iters: int, device: DeviceLike = None,
                  model: Optional[torch.nn.Module] = None) -> float:
    """Images per second of one variant (``model`` given: those weights)."""
    from facerecognition_tpu_torch.utils.profiling import ms_per_call

    device = resolve_device(device)
    fn = variant_forward(model if model is not None else variant_model(stage_sizes), device)
    with torch.no_grad(), strict_fp32():
        ms = ms_per_call(fn, (frames(batch, device),), iters, device)
    return batch / ms * 1e3


def main(argv=None) -> list[dict]:
    import argparse

    ap = argparse.ArgumentParser(description="embed-only throughput of ArcFace variants")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--variants", nargs="+", default=["3,4,6,3", "2,2,2,2"],
                    help="one or more comma-separated stage-size tuples")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = []
    for spec in args.variants:
        stages = tuple(int(s) for s in spec.split(","))
        ips = bench_variant(stages, args.batch, args.iters, device)
        row = {
            "stage_sizes": list(stages),
            "img_per_sec": round(ips, 1),
            "batch": args.batch,
            "vs_reference_1592": round(ips / REFERENCE_IMG_PER_SEC, 2),
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

"""Device choice and float32 precision for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Without
a card that raises: nothing moves to the CPU unless the caller asks for it
with ``device="cpu"`` (as the CPU tests do).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → the current CUDA device; a CUDA device without a card
    raises. CUDA devices come back with their index, so two spellings of one
    card compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def strict_fp32():
    """Full float32 convolutions and matrix products inside the block.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the JAX reference runs these stages in float32
    (``Precision.HIGHEST`` in the solver and the warp). The flags are
    restored on exit rather than flipped at import.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev

"""Carry flax variables across into the port's ``state_dict``s.

The port's modules use the flax module names, so the path of a parameter
is the flax path with ``/`` replaced by ``.``. Only the layouts change:

- conv kernel HWIO → ``weight`` OIHW;
- Dense kernel (I, O) → Linear ``weight`` (O, I);
- BatchNorm ``scale``/``bias`` → ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``
  (``num_batches_tracked`` is set to 0 so ``strict`` loading works);
- the ArcFace margin head (``arcface``) is training-only and is skipped.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

#: Top-level flax modules the inference models do not have.
SKIPPED_MODULES = ("arcface",)


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value)


def flax_to_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` → flat torch ``state_dict``."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: np.ndarray) -> None:
        out[name] = torch.from_numpy(np.array(value))

    for path, value in _flatten(variables.get("params", {})):
        if path[0] in SKIPPED_MODULES:
            continue
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            put(f"{module}.weight", value)
        elif leaf == "scale":
            put(f"{module}.weight", value)
        elif leaf == "bias":
            put(f"{module}.bias", value)
        else:
            raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[0] in SKIPPED_MODULES:
            continue
        module, leaf = ".".join(path[:-1]), path[-1]
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise ValueError(f"unexpected flax batch stat {'/'.join(path)}")
        put(f"{module}.{name}", value)
        out[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def load_flax_variables(module: torch.nn.Module, variables: Mapping) -> None:
    """Load flax variables into ``module`` (strict: every name must match)."""
    module.load_state_dict(flax_to_state_dict(variables), strict=True)

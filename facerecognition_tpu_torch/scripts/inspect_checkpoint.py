"""Checkpoint inspector: the tree, shapes, dtypes and parameter count of a
checkpoint. Counterpart of ``facerecognition_tpu/scripts/inspect_checkpoint.py``.

It reads a flax msgpack serving file (the port's reader), a torch
``.pth``/``.pt`` (``convert.load_torch_checkpoint``: tensors only, the
trainers' wrappers unwrapped; keys split at ``.``), and the port's own
training checkpoints, a ``ckpt_{tag}/`` directory of
``training/checkpoint.CheckpointManager`` (where the JAX script reads an
orbax directory). On a msgpack file the lines and the count are the JAX
script's.

    python -m facerecognition_tpu_torch.scripts.inspect_checkpoint assets/detector_v4_128.msgpack
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np


def _children(tree: Any):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree, key=str)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def summarize_tree(tree: Any, prefix: str = "", lines=None, max_lines: int = 200) -> list[str]:
    """One ``path  shape  dtype`` line a leaf (shapes as tuples), at most
    ``max_lines``."""
    if lines is None:
        lines = []
    children = _children(tree)
    if children is not None:
        for k, v in children:
            summarize_tree(v, f"{prefix}/{k}" if prefix else k, lines, max_lines)
    else:
        shape = getattr(tree, "shape", None)
        shape = tuple(shape) if shape is not None else None
        dtype = getattr(tree, "dtype", type(tree).__name__)
        if len(lines) < max_lines:
            lines.append(f"{prefix}  {shape}  {dtype}")
    return lines


def count_params(tree: Any) -> int:
    """Elements over every leaf with a non-empty shape."""
    children = _children(tree)
    if children is not None:
        return sum(count_params(v) for _, v in children)
    shape = getattr(tree, "shape", None)
    return int(np.prod(tuple(shape))) if shape else 0


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def load_tree(path: str) -> Any:
    """The checkpoint at ``path`` as a tree (on the CPU)."""
    if path.endswith((".pth", ".pt")):
        from facerecognition_tpu_torch.convert import load_torch_checkpoint

        return _nest(load_torch_checkpoint(path))
    if os.path.isdir(path):
        import torch

        from facerecognition_tpu_torch.training.checkpoint import STATE_FILE

        state = os.path.join(path, STATE_FILE)
        if not os.path.exists(state):
            raise FileNotFoundError(f"{path} is not a training checkpoint (no {STATE_FILE})")
        return torch.load(state, map_location="cpu", weights_only=True)
    from facerecognition_tpu_torch.utils.serialization import load_variables

    return load_variables(path)


def inspect(path: str, max_lines: int = 200) -> dict:
    tree = load_tree(path)
    return {"n_params": count_params(tree), "lines": summarize_tree(tree, max_lines=max_lines)}


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="Inspect checkpoint keys")
    parser.add_argument("path")
    parser.add_argument("--max-lines", type=int, default=200)
    args = parser.parse_args(argv)
    info = inspect(args.path, args.max_lines)
    for line in info["lines"]:
        print(line)
    print(f"\ntotal parameters: {info['n_params']:,}")
    return info


if __name__ == "__main__":
    main()

"""Training checkpoints with the JAX package's layout and resume contract.

Counterpart of ``facerecognition_tpu/training/checkpoint.py`` (orbax there):

- ``save(tag, tree, metadata)``, tag ∈ {'best', 'last', 'epoch_<N>'}:
  ``ckpt_{tag}/`` holds ``state.pt``, the ``torch.save``d tree (state
  dicts of tensors, lists and numbers: loadable with ``weights_only=True``),
  and ``ckpt_{tag}.meta.json`` the metadata beside it. The directory is
  written as ``ckpt_{tag}.tmp`` and renamed over the old one, so a process
  that dies mid-save leaves the previous checkpoint whole.
- ``epoch_*`` tags beyond ``keep_last_n`` are deleted after each periodic
  save.
- ``restore(tag, map_location)`` returns (tree, metadata).

A JAX (orbax) checkpoint is not read here; the bridge between the packages
is the serving checkpoint (``utils/serialization.save_variables``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep_last_n = keep_last_n
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.join(self.directory, f"ckpt_{tag}")

    def _meta_path(self, tag: str) -> str:
        return os.path.join(self.directory, f"ckpt_{tag}.meta.json")

    def save(self, tag: str, tree: Any, metadata: Optional[dict] = None) -> None:
        path = self._path(tag)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        with open(self._meta_path(tag), "w") as f:
            json.dump(metadata or {}, f, indent=2, default=str)
        if tag.startswith("epoch_"):
            self._gc_periodic()

    def restore(self, tag: str, map_location=None):
        """(tree, metadata dict) of ``tag``; tensors onto ``map_location``."""
        path = self._path(tag)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        tree = torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                          weights_only=True)
        meta = {}
        if os.path.exists(self._meta_path(tag)):
            with open(self._meta_path(tag)) as f:
                meta = json.load(f)
        return tree, meta

    def exists(self, tag: str) -> bool:
        return os.path.exists(self._path(tag))

    def latest_epoch_tag(self) -> Optional[str]:
        epochs = self._epoch_tags()
        return f"epoch_{epochs[-1]}" if epochs else None

    def _epoch_tags(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_epoch_(\d+)", name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _gc_periodic(self) -> None:
        epochs = self._epoch_tags()
        for e in epochs[: max(len(epochs) - self.keep_last_n, 0)]:
            shutil.rmtree(self._path(f"epoch_{e}"), ignore_errors=True)
            try:
                os.remove(self._meta_path(f"epoch_{e}"))
            except FileNotFoundError:
                pass

"""Carry flax variables across into the port's ``state_dict``s.

The port's modules use the flax module names, so the path of a parameter
is the flax path with ``/`` replaced by ``.``; the FaceNet modules use
facenet-pytorch's names instead, which ``flax_module_name`` derives from the
flax ones (``repeat_1_0`` → ``repeat_1.0``, ``branch1_0`` → ``branch1.0``).
Only the layouts change:

- conv kernel HWIO → ``weight`` OIHW (a depthwise kernel, I = 1 with
  ``feature_group_count``, becomes ``Conv2d(groups=...)``'s (O, 1, H, W));
- MobileFaceNet's PReLU slopes (flax's ``prelu`` parameter) stay ``prelu``;
- Dense kernel (I, O) → Linear ``weight`` (O, I);
- BatchNorm ``scale``/``bias`` → ``weight``/``bias``, and the
  ``batch_stats`` ``mean``/``var`` → ``running_mean``/``running_var``
  (``num_batches_tracked`` is set to 0 so ``strict`` loading works);
- the ArcFace margin head (``arcface``, a (C, D) ``weight`` in both) is
  training-only: skipped unless ``include_head``.

``state_dict_to_flax`` is the inverse: a model the port trained becomes a
flax ``{'params', 'batch_stats'}`` tree that ``utils/serialization.
save_variables`` writes as a serving checkpoint both packages load.

A reference torch checkpoint of FaceNet (``model.``/``backbone.``/
``module.`` prefixes, facenet-pytorch keys) needs no layout change:
``facenet_state_dict`` only moves its keys under the port's ``backbone.``,
the counterpart of ``port_torch.facenet_wrapper_key_map``. A reference
ArcFace checkpoint (``backbone.<torchvision resnet50>``, ``bn1``, ``fc``,
``bn2``, ``arcface.weight``) is already in torch's layouts too:
``arcface_state_dict`` renames torchvision's blocks to the port's
(``arcface_key_map``'s rules) and drops the heads.

``export_arcface_state_dict`` and ``export_facenet_state_dict`` go the
other way, from a serving checkpoint's flax variables to the reference
layout (``port_torch.export_*``), for ``save_torch_checkpoint``.
"""

from __future__ import annotations

import re
from typing import Any, Iterator, Mapping, Optional

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


def flax_module_name(path: tuple) -> str:
    """A flax module path as the port's dotted module name; the sequential
    stacks of InceptionResnetV1 (``repeat_N_i``, ``branchN_i``) become
    facenet-pytorch's indexed children."""
    name = ".".join(path)
    name = re.sub(r"(^|\.)repeat_(\d)_(\d+)(?=\.|$)", r"\1repeat_\2.\3", name)
    return re.sub(r"(^|\.)branch(\d)_(\d+)(?=\.|$)", r"\1branch\2.\3", name)


def flax_to_state_dict(variables: Mapping, include_head: bool = False) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` → flat torch ``state_dict``; the
    margin head's ``arcface.weight`` too with ``include_head``."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: np.ndarray) -> None:
        out[name] = torch.from_numpy(np.array(value))

    for path, value in _flatten(variables.get("params", {})):
        if path[0] in SKIPPED_MODULES:
            if include_head and path == ("arcface", "weight"):
                put("arcface.weight", value)
            continue
        module, leaf = flax_module_name(path[:-1]), path[-1]
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            put(f"{module}.weight", value)
        elif leaf == "scale":
            put(f"{module}.weight", value)
        elif leaf in ("bias", "prelu"):
            put(f"{module}.{leaf}", value)
        else:
            raise ValueError(f"unexpected flax parameter {'/'.join(path)}")
    for path, value in _flatten(variables.get("batch_stats", {})):
        if path[0] in SKIPPED_MODULES:
            continue
        module, leaf = flax_module_name(path[:-1]), path[-1]
        name = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if name is None:
            raise ValueError(f"unexpected flax batch stat {'/'.join(path)}")
        put(f"{module}.{name}", value)
        out[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def state_module_path(name: str) -> tuple:
    """The port's dotted module name → the flax module path (the inverse of
    ``flax_module_name``)."""
    name = re.sub(r"(^|\.)repeat_(\d)\.(\d+)(?=\.|$)", r"\1repeat_\2_\3", name)
    name = re.sub(r"(^|\.)branch(\d)\.(\d+)(?=\.|$)", r"\1branch\2_\3", name)
    return tuple(name.split("."))


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A port model's ``state_dict`` → flax ``{'params', 'batch_stats'}`` of
    numpy arrays in the tensors' dtype, copies of them (the inverse of ``flax_to_state_dict`` with
    ``include_head``): OIHW → HWIO, Linear (O, I) → Dense (I, O), batch-norm
    ``weight``/``bias``/``running_*`` → ``scale``/``bias``/``mean``/``var``,
    ``num_batches_tracked`` dropped."""
    bn_modules = {k[: -len(".running_mean")] for k in state_dict if k.endswith(".running_mean")}
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path: tuple, value) -> None:
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = np.array(value.detach().cpu().numpy(), order="C")  # a copy, not a view

    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if key == "arcface.weight":
            put(params, ("arcface", "weight"), value)
            continue
        path = state_module_path(module)
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            put(stats, path + ({"running_mean": "mean", "running_var": "var"}[leaf],), value)
        elif leaf == "weight" and module in bn_modules:
            put(params, path + ("scale",), value)
        elif leaf == "weight":
            put(params, path + ("kernel",),
                value.permute(2, 3, 1, 0) if value.ndim == 4 else value.T)
        elif leaf in ("bias", "prelu"):
            put(params, path + (leaf,), value)
        else:
            raise ValueError(f"unexpected state dict entry {key}")
    return {"params": params, "batch_stats": stats}


def load_flax_variables(module: torch.nn.Module, variables: Mapping) -> None:
    """Load flax variables into ``module`` (strict: every name must match)."""
    module.load_state_dict(flax_to_state_dict(variables), strict=True)


def facenet_key(torch_key: str) -> Optional[str]:
    """A reference FaceNet checkpoint key → the port's ``FaceNetModel``
    key, or None to drop it: ``model.``/``backbone.``/``module.`` or no
    prefix → ``backbone.``, ``projection`` kept, the ``logits`` classifier
    dropped."""
    if torch_key.startswith("projection."):
        return torch_key
    for prefix in ("model.", "backbone.", "module."):
        if torch_key.startswith(prefix):
            torch_key = torch_key[len(prefix):]
            break
    return None if torch_key.startswith("logits") else f"backbone.{torch_key}"


def facenet_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference FaceNet state dict under the port's keys; BN layers
    without ``num_batches_tracked`` get it (0) so ``strict`` loading works."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        name = facenet_key(key)
        if name is not None:
            out[name] = value if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
    for key in list(out):
        if key.endswith(".running_mean"):
            out.setdefault(key[: -len("running_mean")] + "num_batches_tracked",
                           torch.tensor(0, dtype=torch.int64))
    return out


def arcface_key(torch_key: str) -> Optional[str]:
    """A reference ArcFace checkpoint key → the port's ``ArcFaceModel`` key,
    or None to drop it (``port_torch.arcface_key_map``'s rules):
    ``backbone.layer{s}.{b}.`` → ``backbone.layer{s}_{b}.``, its
    ``downsample.0/1`` → ``downsample_conv/bn``; the backbone's ``fc``
    classifier, the margin head ``arcface.weight`` and every
    ``num_batches_tracked`` dropped; ``bn1``, ``fc``, ``bn2`` kept."""
    if torch_key.endswith("num_batches_tracked") or torch_key.startswith("arcface."):
        return None
    if not torch_key.startswith("backbone."):
        return torch_key
    inner = torch_key[len("backbone."):]
    if inner.startswith("fc."):
        return None
    m = re.fullmatch(r"layer(\d)\.(\d+)\.(.+)", inner)
    if m:
        stage, block, rest = m.groups()
        rest = rest.replace("downsample.0.", "downsample_conv.").replace(
            "downsample.1.", "downsample_bn.")
        inner = f"layer{stage}_{block}.{rest}"
    return f"backbone.{inner}"


def arcface_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A reference ArcFace state dict (torch layouts: no transposes) under
    the port's keys, every batch norm's ``num_batches_tracked`` set to 0 so
    ``strict`` loading works."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        name = arcface_key(key)
        if name is not None:
            out[name] = value if torch.is_tensor(value) else torch.as_tensor(np.asarray(value))
    for key in list(out):
        if key.endswith(".running_mean"):
            out[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return out


def _export_state_dict(variables: Mapping, torch_module) -> dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` → a reference-layout state dict
    (``port_torch.export_state_dict``): HWIO → OIHW, Dense (I, O) → (O, I),
    ``scale`` → ``weight``, ``mean``/``var`` → ``running_*`` with
    ``num_batches_tracked`` 0; the margin head's ``weight`` as it is.
    ``torch_module`` maps a flax module path ("a/b") to the reference's
    dotted module name, or None to leave it out."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, value: np.ndarray) -> None:
        out[name] = torch.from_numpy(np.array(value))

    for path, value in _flatten(variables.get("params", {})):
        module = torch_module("/".join(path[:-1]))
        if module is None:
            continue
        leaf = path[-1]
        if leaf == "kernel":
            put(f"{module}.weight", value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T)
        elif leaf == "scale":
            put(f"{module}.weight", value)
        else:  # bias, or the margin head's own weight
            put(f"{module}.{leaf}", value)
    for path, value in _flatten(variables.get("batch_stats", {})):
        module = torch_module("/".join(path[:-1]))
        name = {"mean": "running_mean", "var": "running_var"}.get(path[-1])
        if module is None or name is None:
            continue
        put(f"{module}.{name}", value)
        out.setdefault(f"{module}.num_batches_tracked", torch.tensor(0, dtype=torch.int64))
    return out


def _resnet_module(path: str) -> str:
    """The port's ResNet module path → torchvision's dotted name."""
    parts = []
    for seg in path.split("/"):
        seg = seg.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        m = re.fullmatch(r"layer(\d)_(\d+)", seg)
        parts.append(f"layer{m.group(1)}.{m.group(2)}" if m else seg)
    return ".".join(parts)


def export_arcface_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """ArcFace serving variables → the reference's state dict
    (``backbone.<torchvision resnet>``, ``bn1``, ``fc``, ``bn2``, and
    ``arcface.weight`` when the variables hold the head)."""
    return _export_state_dict(
        variables,
        lambda p: "backbone." + _resnet_module(p[len("backbone/"):])
        if p.startswith("backbone/") else p.replace("/", "."),
    )


def export_facenet_state_dict(variables: Mapping, prefix: str = "model.") -> dict[str, torch.Tensor]:
    """FaceNet serving variables → the reference's state dict: the backbone
    under ``prefix`` with facenet-pytorch's indexed children (``''`` for a
    bare InceptionResnetV1), ``projection`` at the top."""

    def module(path: str) -> str:
        if path.startswith("backbone/"):
            return prefix + flax_module_name(tuple(path[len("backbone/"):].split("/")))
        return path.replace("/", ".")

    return _export_state_dict(variables, module)


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                          wrapper_key: str = "model_state_dict") -> None:
    """Write a ``.pth`` the reference's loaders take: the tensors under
    ``wrapper_key`` (its trainers' layout), or bare with ``wrapper_key=''``."""
    tensors = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({wrapper_key: tensors} if wrapper_key else tensors, path)


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` file's flat state dict, loaded with
    ``weights_only=True``; the ``model_state_dict`` / ``state_dict`` /
    ``model`` wrappers are unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return dict(obj)

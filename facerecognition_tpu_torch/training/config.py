"""YAML config loading with deep merge and dotted-key overrides.

Counterpart of ``facerecognition_tpu/training/config.py``:
``load_config(path, overrides, defaults)``, where overrides are
``section.key=value`` strings (the trainers' ``--set``) parsed with YAML
scalar rules. ``yaml`` is imported inside the functions that read or write a
config, so importing the port does not need it.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional, Sequence


def deep_merge(base: dict, override: Mapping) -> dict:
    """Recursive dict merge; override wins, sub-dicts merge."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(text: str) -> Any:
    """Parse a CLI override value with YAML scalar rules."""
    import yaml

    return yaml.safe_load(text)


def apply_dotted_overrides(config: dict, overrides: Sequence[str]) -> dict:
    """Apply ``a.b.c=value`` override strings."""
    out = copy.deepcopy(config)
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must be key=value")
        key, _, raw = item.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"cannot override through non-dict at {p!r}")
        node[parts[-1]] = _parse_value(raw)
    return out


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Sequence[str]] = None,
    defaults: Optional[dict] = None,
) -> dict:
    """Load a YAML config, merge it onto ``defaults``, apply dotted overrides."""
    config = copy.deepcopy(defaults) if defaults else {}
    if path:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        config = deep_merge(config, loaded)
    if overrides:
        config = apply_dotted_overrides(config, overrides)
    return config


def save_config(path: str, config: dict) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)

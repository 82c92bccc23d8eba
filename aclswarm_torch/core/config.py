"""Layered configuration: dataclass defaults < yaml file < CLI overrides
(port of `aclswarm_tpu/core/config.py`).

Every config is a plain dataclass whose field defaults are the code layer;
`load_layers` overlays a yaml file section and then ``key=value`` CLI
overrides, coercing strings to the field's type, so a run's whole
parameterization is reproducible from one yaml file. PyYAML is imported
only where a file is read or written: a run configured by overrides alone
needs none.
"""
from __future__ import annotations

import dataclasses
import typing
from pathlib import Path
from typing import Any, Optional, Sequence


def _coerce(text: str, ftype: Any) -> Any:
    """Parse a CLI string into a dataclass field's type."""
    origin = typing.get_origin(ftype)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if text.lower() in ("none", "null"):
            return None
        return _coerce(text, args[0])
    if ftype is bool or ftype == "bool":
        if text.lower() in ("1", "true", "yes", "on"):
            return True
        if text.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a boolean: {text!r}")
    if ftype is int or ftype == "int":
        return int(text)
    if ftype is float or ftype == "float":
        return float(text)
    return text


def parse_overrides(pairs: Sequence[str]) -> dict:
    """['k=v', ...] -> {k: 'v'} with validation."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"override must be key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def load_layers(cls, file: str | Path | None = None,
                section: Optional[str] = None,
                overrides: Sequence[str] | dict | None = None):
    """Build ``cls`` (a dataclass) from its defaults, overlaid with the
    given yaml file (optionally one top-level ``section`` of it), overlaid
    with ``key=value`` overrides. Unknown keys raise: a config typo fails
    loudly instead of falling back to a default."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    values: dict = {}

    def apply(layer: dict, origin: str):
        for k, v in layer.items():
            if k not in fields:
                raise KeyError(f"unknown {cls.__name__} key {k!r} ({origin}); "
                               f"valid: {sorted(fields)}")
            values[k] = (_coerce(v, hints[fields[k].name])
                         if isinstance(v, str) else v)

    if file is not None:
        import yaml

        with open(file) as f:
            doc = yaml.safe_load(f) or {}
        if section is not None:
            doc = doc.get(section, {}) or {}
        apply(doc, f"file {file}")
    if overrides:
        if not isinstance(overrides, dict):
            overrides = parse_overrides(overrides)
        apply(overrides, "cli")
    return cls(**values)


def to_yaml(cfg, path: str | Path) -> None:
    """Persist a dataclass config so the run is reproducible from a file."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)

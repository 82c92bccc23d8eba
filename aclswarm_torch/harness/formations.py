"""Formation-library loader (port of `aclswarm_tpu/harness/formations.py`).

The library format and the operator's semantics are the reference's:

- a *group* holds ``agents``, an optional group ``adjmat``, and a list of
  formations, each with ``name``, ``points`` (n x 3), optional ``scale``,
  optional per-formation ``adjmat``, optional ``gains`` (3n x 3n);
- a group-level ``adjmat`` key overrides every formation's own; note
  ``adjmat: fc`` is a *string*, so a group-level ``fc`` forces every
  formation fully connected even when per-formation matrices exist;
- anything that is not a list at that point becomes fully connected;
- ``scale`` multiplies the points only, never the gains.

The port reads its own copy of the library
(`aclswarm_torch/param/formations.yaml`). PyYAML is imported only by
`load_group`: `simformN` trials generate their formations and never read
the file.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from aclswarm_torch.core.types import Formation, make_formation

DEFAULT_LIBRARY = Path(__file__).resolve().parent.parent / "param" \
    / "formations.yaml"


@dataclasses.dataclass
class FormationSpec:
    """One loaded formation, host-side (NumPy)."""

    name: str
    points: np.ndarray            # (n, 3), scale already applied
    adjmat: np.ndarray            # (n, n) {0,1}
    gains: Optional[np.ndarray]   # (3n, 3n) or None

    @property
    def n(self) -> int:
        return self.points.shape[0]

    def to_device(self, gains=None, device=None,
                  dtype=torch.float32) -> Formation:
        """The port's `Formation` on ``device`` in ``dtype`` (``gains``
        replaces the spec's own; None keeps them)."""
        g = gains if gains is not None else self.gains
        return make_formation(self.points, self.adjmat, g, device=device,
                              dtype=dtype)


def _resolve_adjmat(entry, n: int) -> np.ndarray:
    if isinstance(entry, list):
        return np.asarray(entry, dtype=np.float64)
    return np.ones((n, n)) - np.eye(n)  # 'fc', None, or anything non-list


def load_group(path: str | Path | None = None, group: str = "swarm6_3d"
               ) -> list[FormationSpec]:
    """Load every formation in a group, operator semantics applied."""
    import yaml

    path = Path(path) if path is not None else DEFAULT_LIBRARY
    with open(path) as f:
        lib = yaml.safe_load(f)
    if group not in lib:
        raise KeyError(f"formation group {group!r} not in {path} "
                       f"(available: {[k for k in lib if isinstance(lib[k], dict)]})")
    spec = lib[group]
    n = int(spec["agents"])
    has_global = "adjmat" in spec

    out = []
    for fm in spec["formations"]:
        adj_entry = spec["adjmat"] if has_global else fm.get("adjmat")
        adjmat = _resolve_adjmat(adj_entry, n)
        scale = float(fm.get("scale", 1.0))
        points = scale * np.asarray(fm["points"], dtype=np.float64)
        gains = None
        if "gains" in fm:
            gains = np.asarray(fm["gains"], dtype=np.float64)
            if gains.shape != (3 * n, 3 * n):
                raise ValueError(f"{fm['name']}: gains {gains.shape}, "
                                 f"expected {(3 * n, 3 * n)}")
        if points.shape != (n, 3):
            raise ValueError(f"{fm['name']}: points {points.shape}, "
                             f"expected {(n, 3)}")
        out.append(FormationSpec(name=str(fm["name"]), points=points,
                                 adjmat=adjmat, gains=gains))
    return out


def min_planar_separation(points: np.ndarray) -> float:
    """Smallest pairwise **xy** distance between formation points.

    Collision avoidance treats vehicles as infinite vertical cylinders, so
    a commanded formation is only reachable if every pair of points keeps
    planar distance above ``r_keep_out``: two points sharing an xy column
    put their vehicles in permanent mutual avoidance."""
    p = np.asarray(points, dtype=np.float64)
    if p.shape[0] < 2:
        return np.inf
    dxy = np.linalg.norm(p[:, None, :2] - p[None, :, :2], axis=-1)
    return float(dxy[~np.eye(p.shape[0], dtype=bool)].min())


def check_feasible(spec: FormationSpec, r_keep_out: float = 1.2) -> None:
    """Raise if the formation is unreachable under planar avoidance."""
    sep = min_planar_separation(spec.points)
    if sep <= r_keep_out:
        raise ValueError(
            f"formation {spec.name!r} has min planar point separation "
            f"{sep:.3f} m <= r_keep_out {r_keep_out} m: vehicles on those "
            f"points sit in permanent mutual collision avoidance (planar "
            f"cylinder model), which gridlocks every trial")


def load_formation(name: str, path: str | Path | None = None,
                   group: str = "swarm6_3d") -> FormationSpec:
    """Load a single formation by name from a group."""
    for fm in load_group(path, group):
        if fm.name == name:
            return fm
    raise KeyError(f"formation {name!r} not in group {group!r}")

"""Vehicle registry (a copy of `aclswarm_tpu/core/registry.py`): named
vehicles <-> batch indices.

The aclswarm stack's identity scheme
(`aclswarm/include/aclswarm/utils.h:43-72` `loadVehicleInfo` +
`aclswarm/param/vehicles.yaml`): the rosparam `/vehs`
is an ORDERED list of vehicle names, and a vehicle's index is its position
in that list — the index the batched arrays are keyed by throughout this
framework (`VehicleEstimates.msg`: "keyed by vehicle id").

In the batched design the array index IS the identity, so this registry
exists for the boundaries where *names* appear: the ROS adapter's
per-vehicle topic namespaces (`interop/ros_bridge`: `/<veh>/distcmd`
etc.), mixed-fleet configs
(`vehicles.yaml`'s SQ/HX mixes), logs, and operators addressing a vehicle
by name.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Sequence

# the port's own registry file (a copy of the reference's
# `param/vehicles.yaml`)
DEFAULT_REGISTRY = (Path(__file__).resolve().parent.parent / "param"
                    / "vehicles.yaml")


@dataclasses.dataclass(frozen=True)
class VehicleRegistry:
    """Ordered vehicle names; index in the list = batch index."""

    names: tuple

    def __post_init__(self):
        if len(set(self.names)) != len(self.names):
            dupes = sorted({x for x in self.names
                            if list(self.names).count(x) > 1})
            raise ValueError(f"duplicate vehicle names: {dupes}")

    @property
    def n(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        """Name -> vehicle id (`loadVehicleInfo`, `utils.h:58-66`:
        unknown names are an error, not a default)."""
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"vehicle {name!r} not in /vehs list "
                           f"{list(self.names)}") from None

    def name(self, vehid: int) -> str:
        return self.names[vehid]

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return self.n


def make_registry(vehs: Sequence[str] | int) -> VehicleRegistry:
    """From an explicit name list, or an integer n -> the SIL convention
    SQ01s..SQnns (`trial.sh:64-78` builds /vehs this way)."""
    if isinstance(vehs, int):
        return VehicleRegistry(tuple(f"SQ{i + 1:02d}s" for i in range(vehs)))
    return VehicleRegistry(tuple(str(v) for v in vehs))


def load_registry(path: str | Path | None = None) -> VehicleRegistry:
    """Read a reference-format vehicles.yaml (`param/vehicles.yaml`:
    a `vehs:` name list)."""
    import yaml

    path = Path(path) if path is not None else DEFAULT_REGISTRY
    with open(path) as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict) or "vehs" not in data:
        raise ValueError(f"{path} has no 'vehs' list")
    return make_registry(data["vehs"])

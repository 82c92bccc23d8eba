"""Wire-API message types (a copy of `aclswarm_tpu/interop/messages.py`):
the `aclswarm_msgs` boundary, ROS-free.

The aclswarm stack's inter-agent and operator API is four ROS messages
(`aclswarm_msgs/msg/{Formation,CBAA,VehicleEstimates,SafetyStatus}.msg`),
kept so existing SIL tooling can drive the planner: these dataclasses
carry the same fields
with the same meaning, and `aclswarm_torch.interop.codec` gives them a stable
framed binary encoding (implemented twice — pure Python and native C++ —
byte-identical, so a ROS bridge or any host process can speak it without
Python). A final ROS plugin is then a transport swap: rosmsg <-> these
types is field-for-field.

Field provenance (reference .msg files):
- `Formation`: name, 3D points, adjacency matrix, optional precomputed
  gains (`Formation.msg:1-18`; points are geometry_msgs/Point = f64,
  adjmat UInt8MultiArray, gains Float32MultiArray).
- `CBAA`: auctionId, iter, per-task price table (f32) and winner table
  (i32, -1 = unset) (`CBAA.msg:1-12`).
- `VehicleEstimates`: per-vehicle stamped positions, zeros when unknown
  (`VehicleEstimates.msg:1-10`; PointStamped = stamp + f64 xyz).
- `SafetyStatus`: collision_avoidance_active (`SafetyStatus.msg:1-5`) —
  the gridlock health signal the trial supervisor consumes.

Every message carries a `Header` (seq, stamp-in-seconds, frame), the
std_msgs/Header equivalent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# frame type tags (codec wire format)
MSG_FORMATION = 1
MSG_CBAA = 2
MSG_VEHICLE_ESTIMATES = 3
MSG_SAFETY_STATUS = 4
# planner output stream: the reference carries these as std/geometry
# messages (`distcmd` = Vector3Stamped per vehicle,
# `coordination_ros.cpp:80`; `assignment` = UInt8MultiArray,
# `:293-297`); batched equivalents so the output side of the boundary is
# wire-shaped too
MSG_DIST_CMD = 5
MSG_ASSIGNMENT = 6
# operator flight-mode broadcast (`snapstack_msgs/QuadFlightMode` carried
# on `/globalflightmode`, published by `operator.py:111-115`, consumed by
# every safety node `safety.cpp:101-121`) and the batched SafetyStatus
# stream (per-vehicle `SafetyStatus.msg` flags, one frame per tick)
MSG_FLIGHT_MODE = 7
MSG_SAFETY_ARRAY = 8

# QuadFlightMode.mode values, aligned with the sim FSM's CMD_* codes
# (`aclswarm_torch/sim/vehicle.py`: CMD_GO=1, CMD_LAND=2, CMD_KILL=3)
MODE_GO = 1
MODE_LAND = 2
MODE_KILL = 3


@dataclasses.dataclass
class Header:
    """std_msgs/Header equivalent: sequence, stamp (seconds), frame id."""

    seq: int = 0
    stamp: float = 0.0
    frame_id: str = ""


@dataclasses.dataclass
class Formation:
    """`aclswarm_msgs/Formation` (`Formation.msg:1-18`): the operator's
    formation dispatch — name, points, adjacency, optional gains."""

    header: Header
    name: str
    points: np.ndarray              # (n, 3) float64
    adjmat: np.ndarray              # (n, n) uint8
    gains: Optional[np.ndarray] = None  # (3n, 3n) float32, or None

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float64)
        self.adjmat = np.ascontiguousarray(self.adjmat, dtype=np.uint8)
        if self.gains is not None:
            self.gains = np.ascontiguousarray(self.gains, dtype=np.float32)

    @property
    def n(self) -> int:
        return self.points.shape[0]


@dataclasses.dataclass
class CBAA:
    """`aclswarm_msgs/CBAA` (`CBAA.msg:1-12`): one agent's bid — its price
    table and winner beliefs for the current auction iteration."""

    header: Header
    auction_id: int
    iter: int
    price: np.ndarray               # (n,) float32
    who: np.ndarray                 # (n,) int32, -1 = unset

    def __post_init__(self):
        self.price = np.ascontiguousarray(self.price, dtype=np.float32)
        self.who = np.ascontiguousarray(self.who, dtype=np.int32)


@dataclasses.dataclass
class VehicleEstimates:
    """`aclswarm_msgs/VehicleEstimates` (`VehicleEstimates.msg:1-10`): one
    vehicle's flooded estimate vector — a stamped position per vehicle id,
    zeros when unknown."""

    header: Header
    positions: np.ndarray           # (n, 3) float64
    stamps: np.ndarray              # (n,) float64 seconds (per-entry stamp)

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions,
                                              dtype=np.float64)
        self.stamps = np.ascontiguousarray(self.stamps, dtype=np.float64)


@dataclasses.dataclass
class SafetyStatus:
    """`aclswarm_msgs/SafetyStatus` (`SafetyStatus.msg:1-5`): live health
    signal — is collision avoidance currently overriding the command?"""

    header: Header
    collision_avoidance_active: bool


@dataclasses.dataclass
class DistCmd:
    """Batched `distcmd`: the distributed controller's velocity goals for
    every vehicle (the reference publishes one Vector3Stamped per vehicle,
    `coordination_ros.cpp:80,370-378`)."""

    header: Header
    vel: np.ndarray                 # (n, 3) float64

    def __post_init__(self):
        self.vel = np.ascontiguousarray(self.vel, dtype=np.float64)


@dataclasses.dataclass
class Assignment:
    """Batched `assignment` topic: the accepted permutation, vehicle ->
    formation point (`UInt8MultiArray`, `coordination_ros.cpp:293-297`;
    int32 here so n > 255 swarms fit)."""

    header: Header
    perm: np.ndarray                # (n,) int32 v2f

    def __post_init__(self):
        self.perm = np.ascontiguousarray(self.perm, dtype=np.int32)


@dataclasses.dataclass
class FlightMode:
    """`snapstack_msgs/QuadFlightMode` equivalent: the operator's global
    flight-mode broadcast (GO / LAND / KILL, `operator.py:111-115`). KILL
    is the e-stop: every consumer must cut its command output on the tick
    it arrives (`safety.cpp:116-120`)."""

    header: Header
    mode: int                       # MODE_GO | MODE_LAND | MODE_KILL


@dataclasses.dataclass
class SafetyStatusArray:
    """Batched per-vehicle `SafetyStatus` flags for one tick (the
    reference publishes one `SafetyStatus.msg` per vehicle per safety
    tick, `safety.cpp:277-279`; batched like `DistCmd`). This is the live
    gridlock signal trial supervision consumes over the wire."""

    header: Header
    active: np.ndarray              # (n,) uint8/bool ca-active flags

    def __post_init__(self):
        self.active = np.ascontiguousarray(
            np.asarray(self.active).astype(np.uint8))


def formation_from_spec(spec, seq: int = 0, stamp: float = 0.0) -> Formation:
    """Build a Formation message from a harness `FormationSpec` (the
    operator's `buildFormationMessage`, `aclswarm/nodes/operator.py:155-213`:
    gains included only when precomputed)."""
    gains = None if spec.gains is None else np.asarray(spec.gains,
                                                       np.float32)
    return Formation(header=Header(seq=seq, stamp=stamp),
                     name=spec.name, points=np.asarray(spec.points),
                     adjmat=np.asarray(spec.adjmat), gains=gains)

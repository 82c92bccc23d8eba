"""rospy/aclswarm_msgs stand-ins with the REAL field layouts, ROS-free (a
copy of `aclswarm_tpu/interop/ros_fakes.py`).

`aclswarm_torch.interop.ros_bridge` is written against injected ``rospy`` and
message modules so the adapter runs identically under real ROS and in CI
where ROS cannot exist. This module provides those injections' fakes:

- message classes whose fields mirror the reference's `.msg` definitions
  exactly — `aclswarm_msgs/msg/{Formation,CBAA,VehicleEstimates,
  SafetyStatus}.msg`, the `std_msgs`/`geometry_msgs` types they embed, and
  `snapstack_msgs/QuadFlightMode` — down to the MultiArray layout
  convention the C++ nodes decode (`utils.h:83-126`:
  ``data[offset + dim[1].stride * i + j]``);
- a `FakeRospy` implementing the slice of the rospy API the adapter uses
  (init_node, Publisher/Subscriber, Time, get_param, is_shutdown), with
  in-process topic loopback: `publish` on a topic synchronously invokes
  every subscriber callback registered on it, so a test wires an
  operator-side publisher straight into the adapter.

These fakes are *layout documentation as code*: a real-ROS deployment
swaps them for ``import rospy; from aclswarm_msgs.msg import ...`` with no
adapter changes (see `ros_bridge.main`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


# -- std_msgs -------------------------------------------------------------

@dataclasses.dataclass
class Time:
    """rospy.Time: seconds + to_sec(), the slice the adapter touches."""

    secs: float = 0.0

    def to_sec(self) -> float:
        return float(self.secs)


@dataclasses.dataclass
class Header:
    """std_msgs/Header."""

    seq: int = 0
    stamp: Time = dataclasses.field(default_factory=Time)
    frame_id: str = ""


@dataclasses.dataclass
class MultiArrayDimension:
    """std_msgs/MultiArrayDimension."""

    label: str = ""
    size: int = 0
    stride: int = 0


class _MultiArrayLayout:
    def __init__(self):
        self.dim: list = []
        self.data_offset: int = 0


class UInt8MultiArray:
    """std_msgs/UInt8MultiArray (adjmat wire type, `Formation.msg:15`;
    also the bare `assignment` topic payload, `coordination_ros.cpp
    :293-297`, published with an empty layout)."""

    def __init__(self):
        self.layout = _MultiArrayLayout()
        self.data: list = []


class Float32MultiArray:
    """std_msgs/Float32MultiArray (gains wire type, `Formation.msg:18`)."""

    def __init__(self):
        self.layout = _MultiArrayLayout()
        self.data: list = []


class Int32MultiArray:
    """std_msgs/Int32MultiArray — the wide `assignment` payload for
    n > 255 swarms (no reference analogue: its `vehidx_t` is uint8,
    `utils.h:25`, so the reference wire caps at 255; the adapter's
    flag-gated widening carries the flagship scale on the same topic)."""

    def __init__(self):
        self.layout = _MultiArrayLayout()
        self.data: list = []


# -- geometry_msgs --------------------------------------------------------

@dataclasses.dataclass
class Point:
    """geometry_msgs/Point."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass
class Vector3:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass
class PointStamped:
    """geometry_msgs/PointStamped (`VehicleEstimates.msg:10` entries)."""

    header: Header = dataclasses.field(default_factory=Header)
    point: Point = dataclasses.field(default_factory=Point)


@dataclasses.dataclass
class Vector3Stamped:
    """geometry_msgs/Vector3Stamped (the `distcmd` topic,
    `coordination_ros.cpp:80`)."""

    header: Header = dataclasses.field(default_factory=Header)
    vector: Vector3 = dataclasses.field(default_factory=Vector3)


# -- aclswarm_msgs --------------------------------------------------------

class Formation:
    """aclswarm_msgs/Formation (`Formation.msg:1-18`)."""

    def __init__(self):
        self.header = Header()
        self.name = ""
        self.points: list = []          # geometry_msgs/Point[]
        self.adjmat = UInt8MultiArray()
        self.gains = Float32MultiArray()


class CBAA:
    """aclswarm_msgs/CBAA (`CBAA.msg:1-12`)."""

    def __init__(self):
        self.header = Header()
        self.auctionId = 0
        self.iter = 0
        self.price: list = []           # float32[]
        self.who: list = []             # int32[], -1 = unset


class VehicleEstimates:
    """aclswarm_msgs/VehicleEstimates (`VehicleEstimates.msg:1-10`)."""

    def __init__(self):
        self.header = Header()
        self.positions: list = []       # geometry_msgs/PointStamped[]


class SafetyStatus:
    """aclswarm_msgs/SafetyStatus (`SafetyStatus.msg:1-5`)."""

    def __init__(self):
        self.header = Header()
        self.collision_avoidance_active = False


# -- visualization_msgs ---------------------------------------------------

@dataclasses.dataclass
class ColorRGBA:
    """std_msgs/ColorRGBA."""

    r: float = 0.0
    g: float = 0.0
    b: float = 0.0
    a: float = 0.0


@dataclasses.dataclass
class Quaternion:
    """geometry_msgs/Quaternion."""

    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    w: float = 0.0


@dataclasses.dataclass
class Pose:
    """geometry_msgs/Pose."""

    position: Point = dataclasses.field(default_factory=Point)
    orientation: Quaternion = dataclasses.field(default_factory=Quaternion)


class Marker:
    """visualization_msgs/Marker — the slice the viz publishers touch
    (`viz_commands.py:141-202`, `operator.py:273-289`). Type/action enum
    values match the real message definition."""

    ARROW = 0
    CUBE = 1
    SPHERE = 2
    LINE_LIST = 5
    MESH_RESOURCE = 10
    ADD = 0
    MODIFY = 0
    DELETE = 2

    def __init__(self):
        self.header = Header()
        self.ns = ""
        self.id = 0
        self.type = Marker.ARROW
        self.action = Marker.ADD
        self.pose = Pose()
        self.scale = Vector3()
        self.color = ColorRGBA()
        self.lifetime = 0.0
        self.points: list = []          # geometry_msgs/Point[]
        self.mesh_resource = ""
        self.mesh_use_embedded_materials = False


class MarkerArray:
    """visualization_msgs/MarkerArray."""

    def __init__(self):
        self.markers: list = []


# -- snapstack_msgs -------------------------------------------------------

class QuadFlightMode:
    """snapstack_msgs/QuadFlightMode: the operator's global flight-mode
    broadcast (`operator.py:111-115`). Constant values match the real
    message definition's enum."""

    NOT_FLYING = 0
    TAKEOFF = 1
    LAND = 2
    INIT = 3
    GO = 4
    ESTOP = 5
    KILL = 6

    def __init__(self):
        self.header = Header()
        self.mode = QuadFlightMode.NOT_FLYING


# -- fake rospy -----------------------------------------------------------

class _Publisher:
    def __init__(self, core: "FakeRospy", topic: str):
        self._core = core
        self.topic = topic
        self.published: list = []       # every message, for assertions

    def publish(self, msg) -> None:
        self.published.append(msg)
        for cb, args in self._core._subs.get(self.topic, []):
            cb(msg) if args is None else cb(msg, args)


class _Subscriber:
    def __init__(self, core, topic):
        self._core, self.topic = core, topic

    def unregister(self) -> None:
        self._core._subs.pop(self.topic, None)


class _Timer:
    def __init__(self, cb):
        self.cb = cb


class FakeRospy:
    """The rospy API slice `ros_bridge` uses, with synchronous in-process
    topic loopback. Single-threaded by construction — callbacks run inside
    `publish`, timers fire only when the test calls them — so tests are
    deterministic where real rospy is concurrent."""

    def __init__(self, params: Optional[dict] = None):
        self._subs: dict = {}
        self.pubs: dict = {}
        self.params = dict(params or {})
        self.timers: list = []
        self.clock = 0.0
        self.shutdown = False
        self.logs: list = []

    # node lifecycle
    def init_node(self, name: str, **kw) -> None:
        self.node_name = name

    def is_shutdown(self) -> bool:
        return self.shutdown

    def spin(self) -> None:            # tests drive timers manually
        pass

    # pub/sub
    def Publisher(self, topic: str, msg_type: Any, queue_size: int = 1,
                  latch: bool = False) -> _Publisher:
        pub = _Publisher(self, topic)
        self.pubs[topic] = pub
        return pub

    def Subscriber(self, topic: str, msg_type: Any,
                   callback: Callable, callback_args: Any = None,
                   queue_size: int = 1) -> _Subscriber:
        self._subs.setdefault(topic, []).append((callback, callback_args))
        return _Subscriber(self, topic)

    # params / time / timers / logging
    def get_param(self, name: str, default: Any = None) -> Any:
        if name in self.params:
            return self.params[name]
        if default is None:
            raise KeyError(name)
        return default

    class _Now:
        def __init__(self, core):
            self._core = core

        def now(self):
            return Time(self._core.clock)

    @property
    def Time(self):
        return FakeRospy._Now(self)

    def Duration(self, secs: float) -> float:
        return secs

    def Timer(self, period, cb) -> _Timer:
        t = _Timer(cb)
        self.timers.append(t)
        return t

    def loginfo(self, fmt, *a):
        self.logs.append(("info", fmt % a if a else fmt))

    def logwarn(self, fmt, *a):
        self.logs.append(("warn", fmt % a if a else fmt))

    def logerr(self, fmt, *a):
        self.logs.append(("err", fmt % a if a else fmt))


class FakeMsgs:
    """Message-module namespace the adapter imports from: the union of
    `aclswarm_msgs.msg`, the `std_msgs`/`geometry_msgs` pieces, and
    `snapstack_msgs.QuadFlightMode` — mirroring `ros_bridge.main`'s
    real-ROS imports."""

    Header = Header
    MultiArrayDimension = MultiArrayDimension
    UInt8MultiArray = UInt8MultiArray
    Int32MultiArray = Int32MultiArray
    Float32MultiArray = Float32MultiArray
    Point = Point
    PointStamped = PointStamped
    Vector3 = Vector3
    Vector3Stamped = Vector3Stamped
    Formation = Formation
    CBAA = CBAA
    VehicleEstimates = VehicleEstimates
    SafetyStatus = SafetyStatus
    QuadFlightMode = QuadFlightMode
    ColorRGBA = ColorRGBA
    Quaternion = Quaternion
    Pose = Pose
    Marker = Marker
    MarkerArray = MarkerArray

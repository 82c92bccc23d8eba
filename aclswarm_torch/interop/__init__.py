"""Interop: the `aclswarm_msgs` wire boundary, ROS-free (port of
`aclswarm_tpu.interop`).

- ``messages``  — dataclass equivalents of the wire messages.
- ``codec``     — framed binary encoding (Python implementation; the same
  message encodes to the same bytes as the reference's codec).
- ``native``    — ctypes bindings to the C++ codec and shm ring of
  `native/` (``make -C native``), byte-identical to ``codec``.
- ``transport`` — host-local channels over the native shared-memory ring,
  and TCP sockets with the same channel API.
- ``planner``   — `TorchPlanner`: the coordination stack driven purely
  through wire messages, on the CUDA card unless asked for the CPU.
- ``bridge``    — the planner daemon on the shm rings; ``operator`` the
  base station that dispatches formations and flight modes to it.
- ``ros_bridge``— the `aclswarm_msgs` ROS adapter node (rospy injected;
  ``ros_fakes`` supplies the stand-ins with the real field layouts;
  ``viz_markers`` its rviz markers).

The planner (which pulls in torch and the engine) is exposed lazily, so a
bridge client or recorder process can import the codec, messages and
transport without the engine — the light wire boundary the codec exists
for.
"""
from aclswarm_torch.interop import codec, messages
from aclswarm_torch.interop.messages import (CBAA, Formation, Header,
                                             SafetyStatus, VehicleEstimates,
                                             formation_from_spec)

__all__ = ["codec", "messages", "Header", "Formation", "CBAA",
           "VehicleEstimates", "SafetyStatus", "formation_from_spec",
           "TorchPlanner", "PlannerOutput"]


def __getattr__(name):
    if name in ("TorchPlanner", "PlannerOutput"):
        from aclswarm_torch.interop import planner
        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

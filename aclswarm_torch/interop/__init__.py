"""Interop: the `aclswarm_msgs` wire boundary, ROS-free (port of the parts
of `aclswarm_tpu.interop` the wire front ends use).

- ``messages``  — dataclass equivalents of the wire messages.
- ``codec``     — framed binary encoding (Python implementation; the same
  message encodes to the same bytes as the reference's codec).
- ``native``    — ctypes bindings to the C++ codec and shm ring of
  `native/` (``make -C native``), byte-identical to ``codec``.
- ``transport`` — host-local channels over the native shared-memory ring,
  and TCP sockets with the same channel API.

No module here imports torch: a bridge or recorder process can speak the
wire without the engine. The reference's planner, bridge, operator, ROS
and visualisation modules are not ported yet.
"""
from aclswarm_torch.interop import codec, messages
from aclswarm_torch.interop.messages import (CBAA, Formation, Header,
                                             SafetyStatus, VehicleEstimates,
                                             formation_from_spec)

__all__ = ["codec", "messages", "Header", "Formation", "CBAA",
           "VehicleEstimates", "SafetyStatus", "formation_from_spec"]

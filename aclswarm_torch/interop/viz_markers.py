"""Live rviz markers on the ROS graph: the `viz_commands` node analogue
(port of `aclswarm_tpu/interop/viz_markers.py`).

The reference runs a standalone viz node subscribing every vehicle's
command topics and republishing rviz MarkerArrays
(`aclswarm/nodes/viz_commands.py:36-50`): blue `distcmd` arrows in each
vehicle's frame, black spheres at the centrally-aligned desired formation
(`vizAlignedCb`, `viz_commands.py:117-138`), and quad meshes; the operator
separately draws green room-bound walls (`genEnvironment`,
`aclswarm/nodes/operator.py:248-292`). In the batched deployment the
coordination node already *holds* everything those subscriptions
reconstruct — positions, the freshly computed distcmd, the committed
formation and assignment — so the viz publisher is a per-tick sink fed by
`TorchCoordinationNode.step` instead of a topic-scraping process.

Topic names match the reference node so existing rviz configs load
unchanged: `viz_dist_cmd`, `viz_central_alignment`, `viz_mesh`, plus the
operator-side room-bounds array (latched once).

``rospy``/``msgs`` are injected exactly like the rest of the adapter
(real modules in `ros_bridge.main`, `ros_fakes` in CI) — the fakes carry
the real `visualization_msgs/Marker` field layout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

ARROW_SCALE = 0.5       # the reference's command-arrow shrink (`s = 0.5`,
#                         `viz_commands.py:205`)
SPHERE_SIZE = 0.75      # aligned-formation sphere diameter
#                         (`create_sphere_markers`, `viz_commands.py:175`)
WALL_THK = 0.1          # room wall thickness (`operator.py:264`)
MESH_RESOURCE = "package://snap_sim/meshes/quadrotor.dae"


class VizMarkers:
    """MarkerArray publishers for the batched coordination node.

    One `tick(q, distcmd, formation_points, v2f)` per control tick
    refreshes the arrow + sphere + mesh arrays; `publish_room_bounds`
    draws the operator's four-wall environment once.
    """

    def __init__(self, rospy, msgs, vehs: Sequence[str],
                 frame_id: str = "world", decimate: int = 20):
        self.rospy = rospy
        self.msgs = msgs
        self.vehs = list(vehs)
        self.frame_id = frame_id
        # the reference viz republishes on every message; at the batched
        # node's 100 Hz tick that is rviz-pointless traffic, so markers
        # refresh every `decimate` ticks (default 5 Hz — the aligned-
        # sphere timer's own 0.2 s cadence, `viz_commands.py:85`)
        self.decimate = max(1, int(decimate))
        self._ticks = 0
        self.pub_distcmd = rospy.Publisher("viz_dist_cmd", msgs.MarkerArray,
                                           queue_size=1)
        self.pub_aligned = rospy.Publisher("viz_central_alignment",
                                           msgs.MarkerArray, queue_size=1)
        self.pub_mesh = rospy.Publisher("viz_mesh", msgs.MarkerArray,
                                        queue_size=1)
        self.pub_room = rospy.Publisher("/operator/room_bounds",
                                        msgs.MarkerArray, queue_size=1,
                                        latch=True)

    # -- marker builders ---------------------------------------------------

    def _marker(self, ns: str, mid: int, mtype: int, rgba,
                frame: Optional[str] = None):
        msgs = self.msgs
        mk = msgs.Marker()
        mk.header.frame_id = self.frame_id if frame is None else frame
        mk.ns = ns
        mk.id = mid
        mk.type = mtype
        mk.action = msgs.Marker.ADD
        mk.color.r, mk.color.g, mk.color.b, mk.color.a = rgba
        mk.pose.orientation.w = 1.0
        return mk

    def _arrows(self, ns: str, rgba, distcmd: np.ndarray, stamp):
        """Per-vehicle command arrows, drawn in each vehicle's own frame
        from origin to 0.5x the commanded velocity (`update_arrow_marker`,
        `viz_commands.py:204-210`)."""
        msgs = self.msgs
        arr = msgs.MarkerArray()
        for i, veh in enumerate(self.vehs):
            mk = self._marker(ns, i * 10, msgs.Marker.ARROW, rgba,
                              frame=veh)
            mk.header.stamp = stamp
            mk.scale.x = mk.scale.y = mk.scale.z = 0.1
            u = ARROW_SCALE * np.asarray(distcmd[i], float)
            mk.points = [msgs.Point(0.0, 0.0, 0.0),
                         msgs.Point(float(u[0]), float(u[1]), float(u[2]))]
            arr.markers.append(mk)
        return arr

    # -- per-tick refresh --------------------------------------------------

    def tick(self, q: np.ndarray, distcmd: np.ndarray,
             formation_points: Optional[np.ndarray],
             v2f: Optional[np.ndarray]) -> bool:
        """Refresh all live marker arrays (decimated). Returns whether
        this tick published."""
        self._ticks += 1
        if (self._ticks - 1) % self.decimate:
            return False
        stamp = self.rospy.Time.now()
        msgs = self.msgs
        self.pub_distcmd.publish(
            self._arrows("distcmd", (0.0, 0.0, 1.0, 1.0), distcmd, stamp))

        # quad meshes at the true poses (`create_mesh_markers`,
        # `viz_commands.py:141-159`; the reference leaves pose tracking to
        # per-vehicle frames — the batched node knows q directly)
        mesh = msgs.MarkerArray()
        for i in range(len(self.vehs)):
            mk = self._marker("mesh", i * 10, msgs.Marker.MESH_RESOURCE,
                              (0.0, 0.0, 0.0, 0.0))
            mk.header.stamp = stamp
            mk.mesh_resource = MESH_RESOURCE
            mk.mesh_use_embedded_materials = True
            mk.scale.x = mk.scale.y = mk.scale.z = 0.75
            mk.pose.position.x = float(q[i, 0])
            mk.pose.position.y = float(q[i, 1])
            mk.pose.position.z = float(q[i, 2])
            mesh.markers.append(mk)
        self.pub_mesh.publish(mesh)

        if formation_points is not None and v2f is not None:
            self.pub_aligned.publish(
                self._aligned_spheres(q, formation_points, v2f, stamp))
        return True

    def _aligned_spheres(self, q, formation_points, v2f, stamp):
        """Black spheres at the centrally-aligned desired formation
        (`vizAlignedCb`, `viz_commands.py:117-138`: align formation points
        to the swarm under the current assignment, sphere per point)."""
        import torch

        from aclswarm_torch.core import geometry
        from aclswarm_torch.core import perm as permutil
        msgs = self.msgs
        # host float64 tensors: a marker refresh never touches the card
        q = torch.as_tensor(np.asarray(q, float))
        v2f = torch.as_tensor(np.asarray(v2f))
        q_form = permutil.veh_to_formation_order(q, v2f)  # form order
        pa = geometry.align(
            torch.as_tensor(np.asarray(formation_points, float)), q_form,
            d=2).numpy()
        arr = msgs.MarkerArray()
        for i in range(pa.shape[0]):
            mk = self._marker("aligned", i * 10, msgs.Marker.SPHERE,
                              (0.1, 0.1, 0.1, 1.0))
            mk.header.stamp = stamp
            mk.scale.x = mk.scale.y = mk.scale.z = SPHERE_SIZE
            mk.pose.position.x = float(pa[i, 0])
            mk.pose.position.y = float(pa[i, 1])
            mk.pose.position.z = float(pa[i, 2])
            arr.markers.append(mk)
        return arr

    # -- room bounds (operator side) ---------------------------------------

    def publish_room_bounds(self, xmin: float, xmax: float, ymin: float,
                            ymax: float, zmax: float):
        """Four green wall cubes around the room (`genEnvironment`,
        `operator.py:248-292`), published latched."""
        msgs = self.msgs
        cx, cy = (xmax + xmin) / 2, (ymax + ymin) / 2
        w = xmax - xmin + WALL_THK
        h = ymax - ymin + WALL_THK
        centers = [(cx, ymax), (cx, ymin), (xmax, cy), (xmin, cy)]
        sizes = [(w, WALL_THK), (w, WALL_THK), (WALL_THK, h), (WALL_THK, h)]
        arr = msgs.MarkerArray()
        for i, ((px, py), (sx, sy)) in enumerate(zip(centers, sizes)):
            mk = self._marker("", i, msgs.Marker.CUBE, (0.0, 1.0, 0.0, 1.0),
                              frame="world")
            mk.scale.x, mk.scale.y, mk.scale.z = sx, sy, zmax
            mk.pose.position.x = px
            mk.pose.position.y = py
            mk.pose.position.z = zmax / 2
            arr.markers.append(mk)
        self.pub_room.publish(arr)
        return arr

"""ROS `aclswarm_msgs` adapter: the planner node on a live ROS graph (port
of `aclswarm_tpu/interop/ros_bridge.py`, whose `TpuCoordinationNode` is
this module's `TorchCoordinationNode`).

The planner is dispatched through the aclswarm stack's own
`aclswarm_msgs` boundary so the existing SIL tooling
(`aclswarm_sim/scripts/trial.sh:102`, `start.sh:148-160`) drives it
unchanged. This module is that shim: ONE ROS node that replaces the n
per-vehicle `coordination` C++ nodes (`coordination_ros.cpp`), speaking
exactly their topics —

    subscribe  /formation                aclswarm_msgs/Formation
    subscribe  /globalflightmode        snapstack_msgs/QuadFlightMode
    subscribe  /central_assignment      std_msgs/UInt8MultiArray (opt.)
    subscribe  /<veh>/vehicle_estimates aclswarm_msgs/VehicleEstimates
    publish    /<veh>/distcmd           geometry_msgs/Vector3Stamped
    publish    /<veh>/assignment        std_msgs/UInt8MultiArray

— and dispatching every control tick to the batched `TorchPlanner` (on
the CUDA card; ``planner=`` injects another). The per-vehicle `safety`
and `localization` nodes (and the operator, rviz, supervisor) keep
running untouched; only the coordination layer is swapped.
`<veh>/cbaabid` topics disappear by design: the CBAA exchange the aclswarm
nodes run over TCPROS (`coordination_ros.cpp:392-431`) happens inside the
batched auction, so the graph carries no bid traffic.

`rospy` and the message classes are INJECTED (see `main` for the
real-ROS wiring and `aclswarm_torch.interop.ros_fakes` for the fakes),
so the adapter logic is import-safe and testable without ROS.

Fleet bring-up mapping (`trial.sh` / `start.sh`): where `start.sh:148-160`
tmux-launches n x `start.launch` (safety + coordination + localization
per vehicle), this deployment launches n x {safety, localization} plus
ONE `python -m aclswarm_torch.interop.ros_bridge` (node
``coordination_torch``); ``--backend shm`` forwards to a planner daemon
(`python -m aclswarm_torch.interop.bridge`) instead of owning the card.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import numpy as np

from aclswarm_torch.interop import messages as m
from aclswarm_torch.utils.log import get_logger

log = get_logger("interop.ros_bridge")


# ---------------------------------------------------------------------------
# field-for-field converters: rospy message objects <-> wire dataclasses
# ---------------------------------------------------------------------------

def _as_array(data) -> np.ndarray:
    """rospy deserializes ``uint8[]`` fields as Python ``bytes`` (lists
    only appear on locally constructed messages and in the fakes) — decode
    both representations."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, np.uint8)
    return np.asarray(data)


def _decode_multiarray(msg, dtype) -> np.ndarray:
    """Decode a 2D std_msgs MultiArray exactly as the C++ nodes do
    (`utils.h:83-126`): ``data[offset + dim[1].stride * i + j]``."""
    dims = msg.layout.dim
    if len(dims) != 2:
        raise ValueError(f"expected 2 layout dims, got {len(dims)}")
    rows, cols = int(dims[0].size), int(dims[1].size)
    off, stride = int(msg.layout.data_offset), int(dims[1].stride)
    data = _as_array(msg.data)
    out = np.empty((rows, cols), dtype=dtype)
    for i in range(rows):
        out[i] = data[off + stride * i: off + stride * i + cols]
    return out


def _encode_multiarray(arr: np.ndarray, msg, msgs):
    """Fill a MultiArray message with the operator's layout convention
    (`operator.py:173-181`: row-major, dim0 stride = total size)."""
    arr = np.asarray(arr)
    msg.data = arr.flatten().tolist()
    d0, d1 = msgs.MultiArrayDimension(), msgs.MultiArrayDimension()
    d0.label, d0.size, d0.stride = "rows", arr.shape[0], arr.size
    d1.label, d1.size, d1.stride = "cols", arr.shape[1], arr.shape[1]
    msg.layout.dim = [d0, d1]
    return msg


def _stamp_to_sec(stamp) -> float:
    return float(stamp.to_sec() if hasattr(stamp, "to_sec") else stamp)


def _fill_ros_header(msg, h: m.Header, msgs) -> None:
    """Copy a wire Header into a ros message's header (seq, stamp via
    Time.from_sec when available, frame_id)."""
    msg.header.seq = int(h.seq)
    msg.header.frame_id = h.frame_id
    stamp_cls = type(msgs.Header().stamp)
    make = (stamp_cls.from_sec if hasattr(stamp_cls, "from_sec")
            else stamp_cls)
    msg.header.stamp = make(float(h.stamp))


def formation_from_ros(msg) -> m.Formation:
    """aclswarm_msgs/Formation -> wire (`formationCb` decode path,
    `coordination_ros.cpp:210-232`): points from geometry_msgs/Point[],
    adjmat/gains from the MultiArray layouts; an empty gains array means
    "solve on commit" (`coordination_ros.cpp:112-119`)."""
    pts = np.array([[p.x, p.y, p.z] for p in msg.points], dtype=np.float64)
    adj = _decode_multiarray(msg.adjmat, np.uint8)
    gains = None
    if len(msg.gains.data):
        gains = _decode_multiarray(msg.gains, np.float32)
    return m.Formation(
        header=m.Header(seq=int(msg.header.seq),
                        stamp=_stamp_to_sec(msg.header.stamp),
                        frame_id=msg.header.frame_id),
        name=msg.name, points=pts, adjmat=adj, gains=gains)


def formation_to_ros(fm: m.Formation, msgs, stamp=None):
    """wire -> aclswarm_msgs/Formation, mirroring the operator's
    `buildFormationMessage` layout exactly (`operator.py:159-213`)."""
    msg = msgs.Formation()
    _fill_ros_header(msg, fm.header, msgs)
    msg.name = fm.name
    msg.points = [msgs.Point(float(x), float(y), float(z))
                  for x, y, z in np.asarray(fm.points)]
    _encode_multiarray(np.asarray(fm.adjmat, np.uint8), msg.adjmat, msgs)
    if fm.gains is not None:
        _encode_multiarray(np.asarray(fm.gains, np.float32), msg.gains,
                           msgs)
    if stamp is not None:
        msg.header.stamp = stamp
    return msg


def estimates_from_ros(msg, n: Optional[int] = None) -> m.VehicleEstimates:
    """aclswarm_msgs/VehicleEstimates -> wire: per-entry stamped positions
    (`VehicleEstimates.msg:10`; zeros = unknown)."""
    k = len(msg.positions)
    if n is not None and k != n:
        raise ValueError(f"estimates for {k} vehicles, expected {n}")
    pos = np.array([[e.point.x, e.point.y, e.point.z]
                    for e in msg.positions], dtype=np.float64)
    stamps = np.array([_stamp_to_sec(e.header.stamp)
                       for e in msg.positions], dtype=np.float64)
    return m.VehicleEstimates(
        header=m.Header(seq=int(msg.header.seq),
                        stamp=_stamp_to_sec(msg.header.stamp),
                        frame_id=msg.header.frame_id),
        positions=pos, stamps=stamps)


def estimates_to_ros(est: m.VehicleEstimates, msgs):
    """wire -> aclswarm_msgs/VehicleEstimates (`trackingCb` encode,
    `localization_ros.cpp:132-148`)."""
    msg = msgs.VehicleEstimates()
    _fill_ros_header(msg, est.header, msgs)
    stamp_cls = type(msgs.Header().stamp)
    make_stamp = (stamp_cls.from_sec if hasattr(stamp_cls, "from_sec")
                  else stamp_cls)     # rospy.Time.from_sec vs fake Time(s)
    for (x, y, z), s in zip(np.asarray(est.positions), est.stamps):
        e = msgs.PointStamped()
        e.point = msgs.Point(float(x), float(y), float(z))
        e.header.stamp = make_stamp(float(s))
        msg.positions.append(e)
    return msg


def cbaa_from_ros(msg) -> m.CBAA:
    """aclswarm_msgs/CBAA -> wire (`cbaabidCb`, `coordination_ros.cpp
    :262-268`). This node publishes no bids (the auction is batched),
    but the converter completes the message-family mapping for replay
    tooling and tests."""
    return m.CBAA(
        header=m.Header(seq=int(msg.header.seq),
                        stamp=_stamp_to_sec(msg.header.stamp),
                        frame_id=msg.header.frame_id),
        auction_id=int(msg.auctionId), iter=int(msg.iter),
        price=np.asarray(msg.price, np.float32),
        who=np.asarray(msg.who, np.int32))


def cbaa_to_ros(bid: m.CBAA, msgs):
    """wire -> aclswarm_msgs/CBAA (`sendBidCb` encode,
    `coordination_ros.cpp:308-318`)."""
    msg = msgs.CBAA()
    _fill_ros_header(msg, bid.header, msgs)
    msg.auctionId = int(bid.auction_id)
    msg.iter = int(bid.iter)
    msg.price = [float(p) for p in bid.price]
    msg.who = [int(w) for w in bid.who]
    return msg


def assignment_from_ros(msg) -> np.ndarray:
    """std_msgs/UInt8MultiArray permutation -> (n,) int32
    (`centralAssignmentCb`, `coordination_ros.cpp:272-280`: a bare data
    vector, no layout)."""
    return _as_array(msg.data).astype(np.int32)


def assignment_to_ros(perm: np.ndarray, msgs, wide: bool = False):
    """(n,) permutation -> std_msgs/UInt8MultiArray exactly as the
    coordination node publishes it (`newAssignmentCb`,
    `coordination_ros.cpp:293-297`: flat data, empty layout). n > 255
    does not fit uint8 — the aclswarm nodes share this wire limit (their
    `vehidx_t` is uint8, `utils.h:25`).

    ``wide=True`` encodes an Int32MultiArray instead (same flat-data
    convention) so the adapter carries the flagship n > 255 scale on the
    ROS wire; consumers must opt into the widened type (the aclswarm C++
    nodes decode uint8 only). The shm wire (`interop.codec`) is int32-
    clean either way."""
    perm = np.asarray(perm)
    if wide:
        msg = msgs.Int32MultiArray()
        msg.data = [int(v) for v in perm]
        return msg
    if perm.size and int(perm.max()) > 255:
        raise ValueError("UInt8MultiArray assignment cannot carry indices "
                         "> 255; use wide=True (Int32MultiArray) or the "
                         "shm wire for n > 256 swarms")
    msg = msgs.UInt8MultiArray()
    msg.data = [int(v) for v in perm]
    return msg


def distcmd_to_ros(vel: np.ndarray, msgs, stamp=None, frame_id: str = ""):
    """One vehicle's (3,) velocity goal -> geometry_msgs/Vector3Stamped
    (the `distcmd` topic, `coordination_ros.cpp:80,370-378`)."""
    msg = msgs.Vector3Stamped()
    msg.vector = msgs.Vector3(float(vel[0]), float(vel[1]), float(vel[2]))
    if stamp is not None:
        msg.header.stamp = stamp
    msg.header.frame_id = frame_id
    return msg


def flightmode_from_ros(msg, quad_cls=None) -> m.FlightMode:
    """snapstack_msgs/QuadFlightMode -> wire FlightMode. The operator
    broadcasts GO / LAND / KILL (`operator.py:117-135`); other enum values
    are passed through as GO-neutral (mode 0 is ignored by the planner)."""
    cls = quad_cls if quad_cls is not None else type(msg)
    mode = int(msg.mode)
    table = {int(cls.GO): m.MODE_GO, int(cls.LAND): m.MODE_LAND,
             int(cls.KILL): m.MODE_KILL}
    return m.FlightMode(
        header=m.Header(seq=int(msg.header.seq),
                        stamp=_stamp_to_sec(msg.header.stamp)),
        mode=table.get(mode, 0))


# ---------------------------------------------------------------------------
# shm backend: forward to a planner daemon instead of owning the device
# ---------------------------------------------------------------------------

class ShmPlannerClient:
    """`TorchPlanner` duck-type that forwards over the shm wire to a
    planner daemon (`python -m aclswarm_torch.interop.bridge`).

    The two-process deployment shape: the rospy node lives at the graph
    edge (GIL, callbacks, ROS deps) while the daemon owns the device and
    the planner. The ROS node's `step()` then costs one shm round trip
    instead of a device dispatch. Same channels as the daemon serves (see
    `interop.bridge`).

    The estimate frames on this wire are (n, 3) self-estimates, so the
    per-vehicle (n, n, 3) information model cannot ride it — the adapter
    falls back to the fused model (documented divergence, see
    `TorchCoordinationNode`).
    """

    accepts_est = False

    def __init__(self, n: int, ns: str = "/asw",
                 central_assignment: bool = False,
                 connect_timeout_s: float = 60.0,
                 tick_timeout_s: float = 60.0):
        import time

        from aclswarm_torch.interop.transport import Channel

        self.n = n
        self.central_assignment = central_assignment
        self.tick_timeout_s = tick_timeout_s
        self._seq = 0
        self._chans = {}
        deadline = time.time() + connect_timeout_s
        for name in ("formation", "flightmode", "estimates",
                     "central-assignment", "distcmd", "assignment",
                     "safety"):
            while True:
                try:
                    self._chans[name] = Channel(f"{ns}-{name}")
                    break
                except OSError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.05)

    def close(self) -> None:
        for ch in self._chans.values():
            ch.close()

    # -- TorchPlanner surface ----------------------------------------------
    def handle_formation(self, fm: m.Formation) -> None:
        # a dropped commit would leave the daemon on the old formation
        # with no signal — retry through backpressure, loud on failure
        from aclswarm_torch.interop.transport import send_reliable
        send_reliable(self._chans["formation"], fm, grace_s=5.0, log=log)

    def handle_flightmode(self, fm: m.FlightMode) -> None:
        # KILL is the e-stop: silent loss is never acceptable
        from aclswarm_torch.interop.transport import send_reliable
        send_reliable(self._chans["flightmode"], fm, grace_s=5.0, log=log)

    def handle_central_assignment(self, perm) -> bool:
        perm = np.asarray(perm.perm if isinstance(perm, m.Assignment)
                          else perm, np.int32)
        if perm.shape != (self.n,) or not np.array_equal(
                np.sort(perm), np.arange(self.n)):
            return False       # same wire-corruption guard as TorchPlanner
        from aclswarm_torch.interop.transport import send_reliable
        self._seq += 1
        return send_reliable(
            self._chans["central-assignment"],
            m.Assignment(header=m.Header(seq=self._seq), perm=perm),
            grace_s=5.0, log=log)

    def tick(self, q: np.ndarray):
        """One forwarded tick: estimates out, the SAME tick's distcmd
        back (matched on header.seq — stale replies from a timed-out
        earlier tick are discarded, so one stall cannot desynchronize the
        stream). The daemon writes safety/assignment BEFORE the distcmd
        (`bridge.py` output order), so once the matching distcmd arrives,
        this tick's other frames are already readable."""
        import time

        from aclswarm_torch.interop.planner import PlannerOutput

        q = np.asarray(q)
        self._seq += 1
        self._chans["estimates"].send(m.VehicleEstimates(
            header=m.Header(seq=self._seq), positions=q,
            stamps=np.zeros(self.n)))
        deadline = time.time() + self.tick_timeout_s
        cmd = None
        while cmd is None or cmd.header.seq != self._seq:
            if cmd is not None and cmd.header.seq > self._seq:
                raise RuntimeError(
                    f"distcmd seq {cmd.header.seq} from the future "
                    f"(ours {self._seq}): two clients on one namespace?")
            cmd = self._chans["distcmd"].recv()
            if cmd is None:
                if time.time() > deadline:
                    raise TimeoutError("planner daemon did not answer the "
                                       "tick (distcmd timeout)")
                time.sleep(0.0005)
        # drain to the newest frames for this tick; an assignment is
        # one-shot, so any frame found (even a stale-seq one that raced a
        # previous timeout) is the daemon's latest accepted permutation
        asn = last_safe = None
        while (x := self._chans["assignment"].recv()) is not None:
            asn = x
        while (x := self._chans["safety"].recv()) is not None:
            last_safe = x
        return PlannerOutput(
            distcmd=np.asarray(cmd.vel),
            assignment=(None if asn is None
                        else np.asarray(asn.perm, np.int32)),
            auction_valid=True,
            safety=(None if last_safe is None
                    else np.asarray(last_safe.active, bool)))


# ---------------------------------------------------------------------------
# the node
# ---------------------------------------------------------------------------

class TorchCoordinationNode:
    """The n coordination nodes, as one planner-backed ROS node.

    ``rospy``/``msgs`` are the injected ROS API and message namespace
    (real modules in `main`, `ros_fakes.FakeRospy`/`FakeMsgs` in CI).
    Subscription callbacks only RECORD the newest message under a lock;
    all planner work happens in `step()` — the 100 Hz control-timer body
    (`control_dt`, `coordination.launch:24`) — so rospy's concurrent
    callback threads never race the device. This is the aclswarm node's
    own split: callbacks stash `newformation_`, `spin()` commits it
    (`coordination_ros.cpp:94-160`).

    State feed (``information_model``): each vehicle's own localization
    flood (`<veh>/vehicle_estimates`) carries a full n-vector.

    - ``"perveh"`` (default, the faithful model): the node keeps every
      vehicle's whole vector as one (n, n, 3) table and hands it to the
      planner, so vehicle v's distcmd is computed from v's OWN (stale,
      flood-propagated) estimates — exactly what the aclswarm
      coordination node consumes (`coordination_ros.cpp:240-250`). The
      batched state `q` is the table's diagonal (each vehicle's autopilot
      self-state, `localization_ros.cpp:101-110`).
    - ``"fused"``: only the self-estimates feed a shared state that every
      consumer sees — the centralized information model (better than the
      aclswarm nodes under degraded localization; NOT a like-for-like swap).
      Forced when the planner cannot carry the table (the shm wire's
      `ShmPlannerClient` — its estimate frames are (n, 3)).
    """

    def __init__(self, rospy, msgs, vehs: Optional[Sequence[str]] = None,
                 planner=None, assignment: str = "auction",
                 assign_every: int = 120,
                 central_assignment: Optional[bool] = None,
                 information_model: str = "perveh",
                 wide_assignment: Optional[bool] = None,
                 viz: bool = False, device=None, dtype="float32"):
        self.rospy = rospy
        self.msgs = msgs
        from aclswarm_torch.core.registry import make_registry
        self.registry = make_registry(
            vehs if vehs is not None else rospy.get_param("/vehs"))
        vehs = self.vehs = list(self.registry.names)
        n = self.registry.n
        if central_assignment is None:
            central_assignment = bool(
                rospy.get_param("/operator/central_assignment", False))
        if planner is None:
            from aclswarm_torch.interop.planner import TorchPlanner
            planner = TorchPlanner(n, assignment=assignment,
                                   assign_every=assign_every,
                                   central_assignment=central_assignment,
                                   device=device, dtype=dtype)
        # an injected planner (e.g. ShmPlannerClient) knows its own mode;
        # the /central_assignment subscription must follow it
        central_assignment = getattr(planner, "central_assignment",
                                     central_assignment)
        self.planner = planner
        if information_model not in ("perveh", "fused"):
            raise ValueError(f"unknown information_model "
                             f"{information_model!r}")
        self._use_est = (information_model == "perveh"
                         and getattr(planner, "accepts_est", False))
        if information_model == "perveh" and not self._use_est:
            rospy.logwarn("planner cannot carry per-vehicle estimate "
                          "tables; falling back to the fused information "
                          "model (see class docstring)")
        # n > 255 cannot ride the aclswarm UInt8MultiArray wire
        # (`utils.h:25` vehidx_t); auto-widen to Int32MultiArray
        self.wide_assignment = (n > 255 if wide_assignment is None
                                else bool(wide_assignment))
        self._lock = threading.Lock()
        self._pending_formation = None
        self._pending_modes: list = []
        self._pending_central: Optional[np.ndarray] = None
        self._q = np.zeros((n, 3))
        # (n, n, 3) only when the per-vehicle model actually consumes it —
        # at n=1000 the table is 24 MB with a 24 KB row copy per callback
        self._est = np.zeros((n, n, 3)) if self._use_est else None
        self._seen = np.zeros(n, dtype=bool)
        self.ticks = 0

        rospy.Subscriber("/formation", msgs.Formation, self._formation_cb,
                         queue_size=10)   # "don't miss a msg", `:74`
        rospy.Subscriber("/globalflightmode", msgs.QuadFlightMode,
                         self._mode_cb, queue_size=1)
        if central_assignment:
            rospy.logwarn("Expecting centralized assignment. Cheater!")
            # the push must ride the same width as the assignment wire:
            # uint8 wraps indices >= 256 into duplicates the permutation
            # guard would reject on every adoption attempt
            central_type = (msgs.Int32MultiArray if self.wide_assignment
                            else msgs.UInt8MultiArray)
            rospy.Subscriber("/central_assignment", central_type,
                             self._central_cb, queue_size=1)
        self._pub_cmd = []
        self._pub_asn = []
        asn_type = (msgs.Int32MultiArray if self.wide_assignment
                    else msgs.UInt8MultiArray)
        for i, veh in enumerate(vehs):
            rospy.Subscriber(f"/{veh}/vehicle_estimates",
                             msgs.VehicleEstimates, self._estimates_cb,
                             callback_args=i, queue_size=1)
            self._pub_cmd.append(rospy.Publisher(
                f"/{veh}/distcmd", msgs.Vector3Stamped, queue_size=1))
            self._pub_asn.append(rospy.Publisher(
                f"/{veh}/assignment", asn_type, queue_size=1))
        self.viz = None
        if viz:
            from aclswarm_torch.interop.viz_markers import VizMarkers
            self.viz = VizMarkers(rospy, msgs, vehs)
            sp = getattr(planner, "sparams", None)
            if sp is not None:
                lo, hi = np.asarray(sp.bounds_min), np.asarray(sp.bounds_max)
                self.viz.publish_room_bounds(float(lo[0]), float(hi[0]),
                                             float(lo[1]), float(hi[1]),
                                             float(hi[2]))

    # -- callbacks: record only --------------------------------------------

    def _formation_cb(self, msg) -> None:
        fm = formation_from_ros(msg)
        with self._lock:
            self._pending_formation = fm   # newest wins, like newformation_

    def _mode_cb(self, msg) -> None:
        fm = flightmode_from_ros(msg, self.msgs.QuadFlightMode)
        if fm.mode:
            with self._lock:
                self._pending_modes.append(fm)

    def _central_cb(self, msg) -> None:
        perm = assignment_from_ros(msg)
        with self._lock:
            self._pending_central = perm

    def _estimates_cb(self, msg, vehid: int) -> None:
        est = estimates_from_ros(msg, n=len(self.vehs))
        with self._lock:
            self._q[vehid] = est.positions[vehid]   # self-estimate
            if self._use_est:
                self._est[vehid] = est.positions    # v's whole flood table
            self._seen[vehid] = True

    # -- the control tick --------------------------------------------------

    def step(self, _event=None) -> Optional[m.Assignment]:
        """One control tick: commit pending inputs, tick the planner,
        publish per-vehicle distcmd (+ assignment when newly accepted).
        Returns the published wire Assignment for observability/tests."""
        with self._lock:
            fm = self._pending_formation
            self._pending_formation = None
            modes = self._pending_modes
            self._pending_modes = []
            central = self._pending_central
            self._pending_central = None
            q = self._q.copy()
            est = self._est.copy() if self._use_est else None
            ready = bool(self._seen.all())
        for mode in modes:
            self.planner.handle_flightmode(mode)
        if fm is not None:
            # the aclswarm node zeroes distcmd and stops timers before a
            # commit so vehicles hold still through a (possibly long)
            # on-demand gain solve (`coordination_ros.cpp:102-106`); the
            # single-timer node publishes one explicit zero to every
            # vehicle before blocking on the solve
            zero = np.zeros(3)
            stamp0 = self.rospy.Time.now()
            for v, pub in enumerate(self._pub_cmd):
                pub.publish(distcmd_to_ros(zero, self.msgs, stamp=stamp0,
                                           frame_id=self.vehs[v]))
            self.planner.handle_formation(fm)
            self.rospy.loginfo("committed formation %r", fm.name)
        if central is not None:
            if not self.planner.handle_central_assignment(central):
                self.rospy.logwarn("rejected malformed central assignment")
        if not ready:
            return None    # not every vehicle has reported yet
        out = (self.planner.tick(q, est=est) if self._use_est
               else self.planner.tick(q))
        stamp = self.rospy.Time.now()
        for v, pub in enumerate(self._pub_cmd):
            pub.publish(distcmd_to_ros(out.distcmd[v], self.msgs,
                                       stamp=stamp,
                                       frame_id=self.vehs[v]))
        self.ticks += 1
        if self.viz is not None:
            # the aligned-formation spheres need the committed formation +
            # assignment; a planner behind a wire (ShmPlannerClient) does
            # not expose them — arrows and meshes still draw
            formation = getattr(self.planner, "formation", None)
            v2f = getattr(self.planner, "v2f", None)
            self.viz.tick(
                q, out.distcmd,
                None if formation is None else np.asarray(formation.points),
                None if v2f is None else np.asarray(v2f))
        if out.assignment is None:
            return None
        asn = assignment_to_ros(out.assignment, self.msgs,
                                wide=self.wide_assignment)
        for pub in self._pub_asn:
            pub.publish(asn)
        return m.Assignment(header=m.Header(stamp=stamp.to_sec()
                                            if hasattr(stamp, "to_sec")
                                            else 0.0),
                            perm=out.assignment)


def run(rospy, msgs, control_dt: float = 0.01,
        **kw) -> TorchCoordinationNode:
    """Init the node on a (real or fake) rospy, arm the control timer."""
    rospy.init_node("coordination_torch")
    node = TorchCoordinationNode(rospy, msgs, **kw)
    rospy.Timer(rospy.Duration(control_dt), node.step)
    return node


def main(argv=None):  # pragma: no cover - requires a live ROS graph
    """Real-ROS entry point: `rosrun`-able once rospy + aclswarm_msgs are
    on the PYTHONPATH (a catkin overlay). CI covers the identical code
    path through `ros_fakes`."""
    try:
        import rospy
        from aclswarm_msgs.msg import (CBAA, Formation, SafetyStatus,
                                       VehicleEstimates)
        from geometry_msgs.msg import (Point, PointStamped, Pose,
                                       Quaternion, Vector3, Vector3Stamped)
        from snapstack_msgs.msg import QuadFlightMode
        from std_msgs.msg import (ColorRGBA, Float32MultiArray, Header,
                                  Int32MultiArray, MultiArrayDimension,
                                  UInt8MultiArray)
        from visualization_msgs.msg import Marker, MarkerArray
    except ImportError as e:
        raise SystemExit(
            f"ros_bridge.main needs a sourced ROS workspace with "
            f"aclswarm_msgs + snapstack_msgs: {e}")

    class Msgs:
        pass

    for cls in (CBAA, Formation, SafetyStatus, VehicleEstimates, Point,
                PointStamped, Pose, Quaternion, Vector3, Vector3Stamped,
                QuadFlightMode, ColorRGBA, Float32MultiArray, Header,
                Int32MultiArray, MultiArrayDimension, UInt8MultiArray,
                Marker, MarkerArray):
        setattr(Msgs, cls.__name__, cls)

    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--assignment", default="auction")
    ap.add_argument("--assign-every", type=int, default=120)
    ap.add_argument("--control-dt", type=float, default=0.01)
    ap.add_argument("--information-model", choices=("perveh", "fused"),
                    default="perveh",
                    help="perveh = each vehicle's own flood table feeds "
                         "its control (the aclswarm model); fused = "
                         "shared self-estimate state")
    ap.add_argument("--wide-assignment", action="store_true", default=None,
                    help="publish Int32MultiArray assignments (auto when "
                         "n > 255; the aclswarm C++ nodes decode uint8 "
                         "only)")
    ap.add_argument("--viz", action="store_true",
                    help="publish rviz MarkerArrays (viz_dist_cmd, "
                         "viz_central_alignment, viz_mesh, room bounds)")
    ap.add_argument("--backend", choices=("inproc", "shm"),
                    default="inproc",
                    help="inproc = this node owns the device planner; "
                         "shm = forward to a planner daemon "
                         "(`python -m aclswarm_torch.interop.bridge`) over "
                         "the shm rings — the two-process deployment")
    ap.add_argument("--ns", default="/asw",
                    help="shm channel namespace (--backend shm)")
    ap.add_argument("--device", default=None,
                    help="--backend inproc: device to plan on (default: "
                         "the CUDA card)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args(argv)
    planner = None
    if args.backend == "shm":
        rospy.init_node("coordination_torch")   # params need a node
        vehs = rospy.get_param("/vehs")
        planner = ShmPlannerClient(
            len(vehs), args.ns,
            central_assignment=bool(
                rospy.get_param("/operator/central_assignment", False)))
        if planner.central_assignment:
            # the MODE lives in the daemon: a bridge started without
            # --central-assignment discards pushes (and warns); this side
            # can only remind
            rospy.logwarn("central-assignment mode: the planner daemon "
                          "must also run with --central-assignment")
    run(rospy, Msgs, control_dt=args.control_dt, planner=planner,
        assignment=args.assignment, assign_every=args.assign_every,
        information_model=args.information_model,
        wide_assignment=args.wide_assignment, viz=args.viz,
        device=args.device, dtype=args.dtype)
    rospy.spin()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

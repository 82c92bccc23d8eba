"""The planner behind the wire boundary (port of
`aclswarm_tpu/interop/planner.py`, whose `TpuPlanner` is this module's
`TorchPlanner`).

A host process that speaks the `aclswarm_msgs` semantics — Formation in,
per-tick state in, distcmd + assignment out — and runs the torch engine's
planner stages for the whole swarm, so the aclswarm SIL tooling can drive
the port through the same message boundary its ROS nodes use. This module
is that process's core, transport-free: wire `messages` in, wire-shaped
results out. Bolting it to a transport (the shm rings of
`aclswarm_torch.interop.transport` in `interop.bridge`, the ROS adapter
`interop.ros_bridge`) is a pure I/O loop.

What it replaces: the n per-vehicle `coordination` nodes
(`coordination_ros.cpp`) — formation commit incl. on-demand gain solve
(`:112-119`), the auto-auction timer (`:322-359`), and the 100 Hz control
tick (`:370-378`) — batched for the whole swarm, one tick per call.

The planner runs on the CUDA card unless it is given ``device="cpu"``;
``dtype`` (float32 by default) is the precision every wire input is cast
to once, on the host, before its one copy to the device. A tick reads
the device once: one host copy of the tick's outputs (distcmd, the
avoidance flags and, on an auction tick, the candidate assignment and its
validity), from which the host decides acceptance and publication.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from aclswarm_torch import control
from aclswarm_torch.core.types import (ControlGains, SafetyParams,
                                       SwarmState, make_formation,
                                       resolve_device)
from aclswarm_torch.interop import messages as m
from aclswarm_torch.sim import engine

@dataclasses.dataclass
class PlannerOutput:
    """One tick's wire-shaped outputs.

    ``distcmd`` is the batched `distcmd` topic (Vector3Stamped velocity
    goal per vehicle, `coordination_ros.cpp:80,370-378`); ``assignment``
    is the `assignment` topic payload (the aclswarm nodes ship a
    UInt8MultiArray permutation, `coordination_ros.cpp:293-297`; here it
    is int32 because the wire Assignment message was widened for
    n > 255), present only on ticks where a new assignment was accepted.
    """

    distcmd: np.ndarray                       # (n, 3) float
    assignment: Optional[np.ndarray] = None   # (n,) int32 v2f, when accepted
    auction_valid: bool = True                # detect-and-skip flag
    # per-vehicle collision-avoidance-active flags for this tick — the
    # batched `SafetyStatus` stream (`safety.cpp:277-279`), the live
    # gridlock signal trial supervision consumes over the wire
    safety: Optional[np.ndarray] = None       # (n,) bool ca-active


def _tick(swarm: SwarmState, formation, v2f: torch.Tensor, cgains,
          sparams, do_assign: bool, first: torch.Tensor, cfg,
          est: Optional[torch.Tensor] = None):  # torchcheck: device-path
    """The reference's `_tick`: the assignment (a host branch on
    ``do_assign`` where the reference has a `lax.cond`), the control law,
    saturation and the velocity-obstacle flags."""
    if do_assign:
        new_v2f, valid = engine.assign(swarm, formation, v2f, cfg, est,
                                       first=first)
    else:
        new_v2f, valid = v2f, None
    if est is None:
        rel = None
    else:
        # per-vehicle relative views from the estimate tables: rel[v, w] =
        # v's estimate of (w's position − its own) — what the aclswarm
        # control law receives from its own localization node
        # (`coordination_ros.cpp:240-250`)
        n = est.shape[0]
        idx = torch.arange(n, dtype=torch.int64, device=est.device)
        rel = est - est[idx, idx][:, None, :]
    u = control.compute(swarm, formation, new_v2f, cgains, rel=rel)
    # safety stage over the raw distcmd: saturate then the VO check — the
    # per-vehicle safety node's ca-active signal (`safety.cpp:503`),
    # computed here so the wire carries `SafetyStatus` per tick. The
    # k-neighbor pruning knob matters: dense avoidance is cubic in n
    usat = control.saturate_velocity(u, sparams)
    _, ca = control.collision_avoidance(
        swarm.q, usat, sparams, max_neighbors=cfg.colavoid_neighbors)
    return u, new_v2f, valid, ca


class TorchPlanner:
    """Host-side planner speaking the wire API.

    Usage (one instance per swarm, e.g. inside a bridge process):

        planner = TorchPlanner(n)                        # on the card
        planner.handle_formation(formation_msg)         # operator dispatch
        out = planner.tick(estimates_msg)               # each control tick
        # out.distcmd -> safety/autopilot; out.assignment -> peers

    Matches the aclswarm coordination node's observable behavior, as the
    reference's `TpuPlanner` does:
    - a Formation without gains triggers the ADMM solve on the planner's
      device (`coordination_ros.cpp:112-119`);
    - a new formation resets the assignment to identity and re-arms the
      auto-auction (`auctioneer.cpp:42-62`, `coordination_ros.cpp:136-153`);
    - auctions run every ``assign_every`` ticks (autoauction_dt /
      control_dt, `coordination.launch:23-24`), first one immediately after
      the commit settles; invalid auctions are skipped, keeping the old
      assignment (`auctioneer.cpp:283-292`).
    """

    # capability probe for adapters: tick() takes the (n, n, 3) per-vehicle
    # estimate table (the ShmPlannerClient's wire does not)
    accepts_est = True

    def __init__(self, n: int, assignment: str = "auction",
                 assign_every: int = 120,
                 cgains: Optional[ControlGains] = None,
                 sparams: Optional[SafetyParams] = None,
                 colavoid_neighbors: Optional[int] = "auto",
                 central_assignment: bool = False,
                 device=None, dtype=torch.float32):
        self.n = n
        self.device = resolve_device(device)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        # comparison mode (`/operator/central_assignment`,
        # `coordination_ros.cpp:46-51`): the planner runs NO auctions and
        # instead adopts operator-pushed permutations at the auction
        # cadence (`autoauctionCb`, `coordination_ros.cpp:330-343`)
        self.central_assignment = central_assignment
        self._Pcentral: Optional[np.ndarray] = None
        self._central_rcvd = False
        if colavoid_neighbors == "auto":
            # dense VO is exact but cubic; above small-swarm scale prune
            # to the 16 nearest (exact whenever <= 16 vehicles are inside
            # d_avoid_thresh — see control.collision_avoidance)
            colavoid_neighbors = 16 if n > 64 else None
        self.cfg = engine.SimConfig(assignment=assignment,
                                    assign_every=assign_every,
                                    colavoid_neighbors=colavoid_neighbors)
        self.cgains = cgains or ControlGains()
        self.sparams = sparams or SafetyParams()
        self.formation = None
        self.v2f = np.arange(n, dtype=np.int32)
        self._ticks_since_commit = 0
        self._await_first_accept = True
        self.killed = False

    # -- the assignment, on the device and on the host ---------------------
    @property
    def v2f(self) -> torch.Tensor:
        """The current assignment ((n,) int32 on the planner's device)."""
        return self._v2f

    @v2f.setter
    def v2f(self, perm) -> None:
        # the host copy rides beside the device tensor, so the tick's
        # change test and a central push's comparison read no device value
        if isinstance(perm, torch.Tensor):
            host = perm.detach().to("cpu", torch.int32).numpy()
        else:
            host = np.asarray(perm, np.int32)
        self._v2f_host = host.copy()
        self._v2f = torch.from_numpy(self._v2f_host.copy()).to(self.device)

    def _host(self, x) -> torch.Tensor:
        """Wire data (float64 numpy) cast once on the host to the
        planner's dtype, then one copy to the device."""
        return torch.as_tensor(np.asarray(x), dtype=self.dtype).to(
            self.device)

    # -- flight-mode boundary (`safety.cpp:101-121`) ----------------------
    def handle_flightmode(self, msg: m.FlightMode) -> None:
        """Apply an operator GO/LAND/KILL broadcast. KILL is the e-stop:
        from the tick it is processed, `tick` emits zero distcmd and runs
        no auctions until a GO re-arms (`safety.cpp:116-120` drops the
        fleet to NOT_FLYING; coordination output is gated on flying).
        LAND is a vehicle-side ramp — the planner keeps serving commands
        while the fleet descends."""
        if msg.mode == m.MODE_KILL:
            self.killed = True
        elif msg.mode == m.MODE_GO:
            self.killed = False

    # -- centralized-comparison boundary ----------------------------------
    def handle_central_assignment(self, msg) -> bool:
        """Accept an operator-computed assignment (`centralAssignmentCb`,
        `coordination_ros.cpp:272-280`): remember it, and flag it for
        adoption if it is the first assignment since a formation commit or
        differs from the current one. Adoption happens at the auction
        cadence inside `tick` (`autoauctionCb`, `:330-343`); no auction
        runs while this mode is on.

        ``msg`` is a wire `Assignment` (or a bare (n,) permutation).
        Returns False (and changes nothing) for a malformed permutation —
        a wire-level corruption guard typed ROS messages give implicitly.

        The pending flag LATCHES across pushes exactly as
        `central_assignment_rcvd_` does: a later unchanged push updates
        the stored permutation but does not cancel a pending adoption —
        whatever is newest at the cadence gets adopted.
        """
        perm = np.asarray(msg.perm if isinstance(msg, m.Assignment)
                          else msg, np.int32)
        if perm.shape != (self.n,) or not np.array_equal(
                np.sort(perm), np.arange(self.n)):
            return False
        self._Pcentral = perm
        changed = bool(np.any(perm != self._v2f_host))
        if self._await_first_accept or changed:
            self._central_rcvd = True
        return True

    # -- operator boundary ------------------------------------------------
    def handle_formation(self, msg: m.Formation) -> None:
        """Commit a formation dispatch (`formationCb` + the spin-loop
        commit, `coordination_ros.cpp:94-160`)."""
        if msg.n != self.n:
            raise ValueError(f"formation for {msg.n} vehicles, planner "
                             f"has {self.n}")
        points = self._host(msg.points)
        gains = msg.gains
        if gains is None:
            from aclswarm_torch.gains import solve_gains
            gains = solve_gains(points, np.asarray(msg.adjmat))
        self.formation = make_formation(points, np.asarray(msg.adjmat),
                                        gains, device=self.device,
                                        dtype=self.dtype)
        self.v2f = np.arange(self.n, dtype=np.int32)
        self._ticks_since_commit = 0
        # the first *valid* auction after a commit is always published,
        # even if the assignment is unchanged (`auctioneer.cpp:310-316`
        # formation_just_received); persists across invalid auctions
        self._await_first_accept = True
        # discard a central permutation computed for the superseded
        # formation (as the reference: the aclswarm node leaves
        # `central_assignment_rcvd_` latched across commits, but its
        # operator re-pushes every 0.75 s so nothing ever relies on
        # adopting a stale cross-formation permutation)
        self._Pcentral = None
        self._central_rcvd = False

    # -- per-tick boundary ------------------------------------------------
    def tick(self, estimates, vel: Optional[np.ndarray] = None,
             est: Optional[np.ndarray] = None) -> PlannerOutput:
        """One control tick. ``estimates`` is a `VehicleEstimates` message
        (or a plain (n, 3) position array); ``vel`` the vehicles' own
        velocities (zeros when not provided — the damping term then drops,
        as when the aclswarm twist feed is absent).

        ``est`` (optional, (n, n, 3)) is the batched per-vehicle estimate
        table — row v = vehicle v's full `vehicle_estimates` vector from
        its own localization flood. When present, control consumes each
        vehicle's OWN relative views and a CBAA auction aligns on them —
        the aclswarm coordination node's information model
        (`coordination_ros.cpp:240-250`); `estimates` should then carry
        the diagonal. Without it, every consumer sees the fused array."""
        if self.formation is None or self.killed:
            # no formation committed (`coordination_ros.cpp:102-106` zeros
            # the cmd on commit gaps) or e-stopped: zero command, hold
            # assignment, no auction
            return PlannerOutput(distcmd=np.zeros((self.n, 3)),
                                 safety=np.zeros((self.n,), bool))
        q = (estimates.positions if isinstance(estimates, m.VehicleEstimates)
             else np.asarray(estimates))
        if q.shape != (self.n, 3):
            raise ValueError(f"estimates shape {q.shape} != {(self.n, 3)}")
        if est is not None and np.shape(est) != (self.n, self.n, 3):
            raise ValueError(f"est shape {np.shape(est)} != "
                             f"{(self.n, self.n, 3)}")
        q_t = self._host(q)
        v = torch.zeros_like(q_t) if vel is None else self._host(vel)
        swarm = SwarmState(q=q_t, vel=v)
        do_assign = (self._ticks_since_commit % self.cfg.assign_every) == 0
        adopted_central = False
        if self.central_assignment:
            # comparison mode: the received permutation is used "as if the
            # auctioneer had decided it", at the auction cadence, and no
            # auction ever starts (`coordination_ros.cpp:330-343`)
            if do_assign and self._central_rcvd:
                self.v2f = self._Pcentral
                self._central_rcvd = False
                adopted_central = True
            do_assign = False
        est_t = None if est is None else self._host(est)
        first = torch.full((), self._await_first_accept, dtype=torch.bool,
                           device=self.device)
        u, new_v2f, valid, ca = _tick(swarm, self.formation, self._v2f,
                                      self.cgains, self.sparams, do_assign,
                                      first, self.cfg, est=est_t)
        self._ticks_since_commit += 1
        # the tick's one device read: distcmd, the flags and, on an
        # auction tick, the candidate and its validity, in one copy (an
        # int32 permutation of n <= 2^24 is exact in either float type)
        parts = [u.reshape(-1), ca.to(u.dtype)]
        if do_assign:
            parts += [new_v2f.to(u.dtype), valid.to(u.dtype).reshape(1)]
        host = torch.cat(parts).cpu().numpy()
        n3 = 3 * self.n
        distcmd = host[:n3].reshape(self.n, 3)
        safety = host[n3:n3 + self.n] != 0
        ok = True
        new_host = self._v2f_host
        if do_assign:
            new_host = host[n3 + self.n:n3 + 2 * self.n].astype(np.int32)
            ok = bool(host[-1] != 0)
        # an adoption is published unconditionally (`newAssignmentCb`,
        # `coordination_ros.cpp:284-304`); an auction publishes on change
        # or on the first acceptance after a commit
        accepted = adopted_central or (do_assign and ok)
        changed = accepted and (adopted_central
                                or bool(np.any(new_host != self._v2f_host))
                                or self._await_first_accept)
        if accepted:
            self._await_first_accept = False
        if do_assign:
            self._v2f, self._v2f_host = new_v2f, new_host
        return PlannerOutput(
            distcmd=distcmd,
            assignment=(self._v2f_host.copy() if changed else None),
            auction_valid=ok,
            safety=safety)

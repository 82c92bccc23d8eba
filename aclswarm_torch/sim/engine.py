"""Closed-loop swarm simulation (port of `aclswarm_tpu/sim/engine.py`).

One `step` = one 100 Hz control tick of every vehicle: [flood] ->
[auction, decimated] -> control law -> saturate -> mux -> collision
avoidance -> safe trajectory -> [flight FSM] -> dynamics. `rollout` is a
Python loop over `step`.

Where the reference decides with `lax.cond` on a traced tick, the port
decides on the host: `SimState.tick` is a Python int, so the auction
decimation and the flood stripe schedule cost no device read. Data-valued
gates (the airborne gate, `assign_enabled`, `first_auction`) stay tensors
and act through `torch.where`, exactly as the reference selects on them.

Not ported yet (raise `NotImplementedError`): faults, scenarios,
``check_mode='on'`` and ``telemetry='on'``; `batched_rollout` is absent.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from aclswarm_torch import control
from aclswarm_torch.assignment import auction, cbaa, sinkhorn
from aclswarm_torch.assignment.cbaa import CbaaTables
from aclswarm_torch.core import geometry
from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core.types import (ControlGains, Formation, SafetyParams,
                                       SwarmState, as_float)
from aclswarm_torch.faults import masking as faultmask
from aclswarm_torch.sim import localization as loclib
from aclswarm_torch.sim import vehicle
from aclswarm_torch.sim.localization import EstimateTable
from aclswarm_torch.sim.vehicle import ExternalInputs, FlightState

_LATER = {
    "faults": "the engine-extensions slice (faults)",
    "scenario": "the engine-extensions slice (scenarios)",
    "check_mode": "the engine-extensions slice (invariants)",
    "telemetry": "the engine-extensions slice (telemetry)",
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it arrives with "
                               f"{_LATER[what]}")


@dataclass(frozen=True)
class SimConfig:
    """Static rollout configuration: every field and default of the
    reference `SimConfig` (see it for each field's meaning)."""

    control_dt: float = 0.01
    assign_every: int = 120
    assignment: str = "auction"
    dynamics: str = "tracking"
    tau: float = 0.15
    kp_track: float = 8.0
    kd_track: float = 4.0
    use_colavoid: bool = True
    flight_fsm: bool = False
    colavoid_neighbors: int | None = None
    localization: str = "truth"
    flood_every: int = 2
    flood_block: int | None = None
    flood_phases: int = 1
    cbaa_task_block: int | None = None
    assign_eps: float = 0.0
    check_mode: str = "off"
    telemetry: str = "off"


@dataclass
class SimState:
    """Everything that persists across control ticks. ``tick`` is a host
    int (the decimation phase); ``first_auction`` and ``assign_enabled``
    are () bool tensors, as in the reference. ``cbaa_warm`` (None = the
    stateless-auction engine) re-seeds each CBAA auction from the last
    valid one's fixed point. The reference's other optional carries
    (faults, scenario, inv, tel) are not ported yet."""

    swarm: SwarmState
    goal: control.TrajGoal
    v2f: torch.Tensor           # (n,) int32 current assignment
    tick: int
    flight: FlightState
    first_auction: torch.Tensor   # () bool
    assign_enabled: torch.Tensor  # () bool
    loc: EstimateTable | None = None
    cbaa_warm: CbaaTables | None = None


@dataclass
class StepMetrics:
    """Per-tick observables (stacked over time by `rollout`)."""

    distcmd_norm: torch.Tensor   # (n,) |distcmd| per vehicle (pre-safety)
    ca_active: torch.Tensor      # (n,) collision avoidance modified the cmd
    assign_valid: torch.Tensor   # () bool: this tick's auction gave a perm
    reassigned: torch.Tensor     # () bool: assignment changed this tick
    auctioned: torch.Tensor      # () bool: an auction ran this tick
    q: torch.Tensor              # (n, 3) positions after the tick
    mode: torch.Tensor           # (n,) int32 flight mode after the tick
    v2f: torch.Tensor            # (n,) assignment after the tick


def init_state(q0, v2f0=None, flying: bool = True,
               localization: bool = False, faults=None,
               checks: bool = False, telemetry: bool = False,
               scenario=None, cbaa_warm: bool = False,
               device=None, dtype=torch.float32) -> SimState:
    """``flying=True`` starts airborne in FLYING, ``False`` on the ground
    (send CMD_GO with ``cfg.flight_fsm``). ``localization=True``
    allocates the estimate tables ('flooded' mode). ``cbaa_warm=True``
    allocates the CBAA warm-start tables (cold, `cbaa.init_tables`).
    ``device=None`` is the card; the state lives on ``device`` in
    ``dtype``."""
    for what, on in (("faults", faults is not None), ("check_mode", checks),
                     ("telemetry", telemetry),
                     ("scenario", scenario is not None)):
        if on:
            raise _not_ported(what)
    q0 = as_float(q0, device, dtype)
    dev = q0.device
    n = q0.shape[0]
    v2f0 = (permutil.identity(n, dev) if v2f0 is None
            else torch.as_tensor(v2f0, dtype=torch.int32, device=dev))
    return SimState(
        swarm=SwarmState(q=q0, vel=torch.zeros_like(q0)),
        goal=control.TrajGoal.hover_at(q0, device=dev, dtype=dtype),
        v2f=v2f0, tick=0,
        flight=vehicle.init_flight(n, dev, dtype, flying=flying),
        loc=loclib.init_table(q0, dev, dtype) if localization else None,
        first_auction=torch.ones((), dtype=torch.bool, device=dev),
        assign_enabled=torch.ones((), dtype=torch.bool, device=dev),
        cbaa_warm=cbaa.init_tables(n, dev, dtype) if cbaa_warm else None)


def _check_cfg(cfg: SimConfig) -> None:
    if cfg.assignment not in ("auction", "sinkhorn", "cbaa", "none"):
        raise ValueError(f"unknown assignment mode {cfg.assignment!r}")
    for what in ("check_mode", "telemetry"):
        mode = getattr(cfg, what)
        if mode == "on":
            raise _not_ported(what)
        if mode != "off":
            raise ValueError(f"unknown {what} {mode!r}")
    if cfg.localization not in ("truth", "flooded"):
        raise ValueError(f"unknown localization mode {cfg.localization!r}")
    if cfg.dynamics not in ("tracking", "firstorder", "doubleint"):
        raise ValueError(f"unknown dynamics model {cfg.dynamics!r}")


def assign(swarm: SwarmState, formation: Formation, v2f: torch.Tensor,
           cfg: SimConfig, est: torch.Tensor | None = None,
           first: torch.Tensor | None = None,
           alive: torch.Tensor | None = None,
           link_mask: torch.Tensor | None = None,
           warm: CbaaTables | None = None):
    """One re-assignment: (new v2f, () bool valid), plus the updated
    `CbaaTables` appended last when ``warm`` is given.

    'auction' and 'sinkhorn' follow the centralized path: order the swarm
    by the *last* assignment, align the formation globally (d=2), then
    solve the vehicle->point problem — exactly with `auction_lap` on the
    `cdist` costs, or fast with `sinkhorn_assign`. 'cbaa' follows the
    decentralized path: per-agent local alignment + the synchronous
    max-consensus auction. An invalid outcome (auction out of rounds,
    CBAA without consensus) holds the current assignment.

    The centralized modes always use ground truth; only CBAA consumes the
    localization estimates ``est`` ((n, n, 3)) when the flooded model is
    on. With ``cfg.assign_eps`` > 0 the current assignment is kept unless
    the candidate improves the total EXACT distance by that relative
    margin (for CBAA the veto runs inside `cbaa_assign`); ``first``
    (() bool) marks the first auction after a dispatch, which the margin
    never vetoes.

    ``alive`` (optional (n,) bool) masks the solve to the alive sub-fleet:
    dead vehicles stay pinned to their points and alive ones bid only over
    alive-owned points (`faults.masking`; the global alignment keeps all
    rows). ``link_mask`` degrades CBAA's consensus graph; the centralized
    solvers ignore it. ``warm`` (CBAA only) re-seeds the auction from the
    previous one's tables; an invalid auction returns the old tables.
    """
    if warm is not None and cfg.assignment != "cbaa":
        raise ValueError("warm CbaaTables only apply to the 'cbaa' "
                         f"assignment mode, not {cfg.assignment!r}")
    true_ = torch.ones((), dtype=torch.bool, device=v2f.device)

    def hysteresis(cand, cost):
        """Keep the current assignment unless the candidate improves the
        total of the (n, n) vehicle->aligned-point distances ``cost`` by
        the relative margin."""
        if cfg.assign_eps <= 0.0:
            return cand
        cost_new = torch.sum(cost.gather(1, cand.long()[:, None]))
        cost_cur = torch.sum(cost.gather(1, v2f.long()[:, None]))
        take = cost_new < (1.0 - cfg.assign_eps) * cost_cur
        if first is not None:
            take = take | first
        return torch.where(take, cand, v2f)

    if cfg.assignment == "none":
        return v2f, true_
    if cfg.assignment == "cbaa":
        res = cbaa.cbaa_from_state(swarm.q, formation.points,
                                   formation.adjmat, v2f, est=est,
                                   task_block=cfg.cbaa_task_block,
                                   alive=alive, comm_extra=link_mask,
                                   warm=warm, assign_eps=cfg.assign_eps,
                                   first=first)
        new_v2f = torch.where(res.valid, res.v2f, v2f)
        if warm is None:
            return new_v2f, res.valid
        # only a VALID auction's fixed point is worth carrying
        return new_v2f, res.valid, CbaaTables(
            price=torch.where(res.valid, res.price, warm.price),
            who=torch.where(res.valid, res.who, warm.who))
    if cfg.assignment not in ("auction", "sinkhorn"):
        raise ValueError(f"unknown assignment mode {cfg.assignment!r}")
    q_form = permutil.veh_to_formation_order(swarm.q, v2f)
    paligned = geometry.align(formation.points, q_form, d=2)
    if cfg.assignment == "auction":
        c = geometry.cdist(swarm.q, paligned)
        if alive is not None:
            c = faultmask.mask_cost(c, alive, v2f)
        res = auction.auction_lap(-c)
        return (torch.where(res.valid, hysteresis(res.row_to_col, c), v2f),
                res.valid)
    if alive is None:
        res = sinkhorn.sinkhorn_assign(swarm.q, paligned)
    else:
        pin, forbid = faultmask.pin_forbid(alive, v2f)
        res = sinkhorn.sinkhorn_assign(swarm.q, paligned, pin=pin,
                                       forbid=forbid)
    c = None
    if cfg.assign_eps > 0.0:
        c = geometry.cdist(swarm.q, paligned)
        if alive is not None:
            c = faultmask.mask_cost(c, alive, v2f)
    return hysteresis(res.row_to_col, c), true_


def step(state: SimState, formation: Formation, gains: ControlGains,
         sparams: SafetyParams, cfg: SimConfig,
         inputs: ExternalInputs | None = None
         ) -> tuple[SimState, StepMetrics]:
    """One 100 Hz control tick for the whole swarm."""
    _check_cfg(cfg)
    swarm, goal, v2f, fs = state.swarm, state.goal, state.v2f, state.flight
    n = swarm.q.shape[0]
    dev = swarm.q.device
    if inputs is None:
        inputs = ExternalInputs.none(n, dev, swarm.q.dtype)
    true_ = torch.ones((), dtype=torch.bool, device=dev)

    # --- operator flight-mode broadcast ---
    if cfg.flight_fsm:
        fs = vehicle.apply_command(fs, inputs.cmd)
    flying = fs.mode == vehicle.FLYING

    # --- mutual localization: flood at its own 50 Hz rate ---
    loc = state.loc
    if cfg.localization == "flooded":
        if loc is None:
            raise ValueError("cfg.localization='flooded' needs "
                             "init_state(..., localization=True)")
        if cfg.flood_phases == 1:
            loc = loclib.tick(loc, swarm.q, formation.adjmat, v2f,
                              state.tick % cfg.flood_every == 0,
                              target_block=cfg.flood_block)
        else:
            loc = loclib.tick_phased(loc, swarm.q, formation.adjmat, v2f,
                                     state.tick, cfg.flood_every,
                                     cfg.flood_phases,
                                     target_block=cfg.flood_block)

    # --- auto-auction, decimated on the host tick; the airborne and
    # enabled gates select on the candidate as in the reference ---
    # CBAA alone consumes the flooded estimates and the warm tables
    est = loc.est if cfg.localization == "flooded" else None
    warm = state.cbaa_warm if cfg.assignment == "cbaa" else None
    new_warm = state.cbaa_warm
    if cfg.assignment != "none" and state.tick % cfg.assign_every == 0:
        outs = assign(swarm, formation, v2f, cfg, est=est,
                      first=state.first_auction, warm=warm)
        take = state.assign_enabled
        if cfg.flight_fsm:
            take = take & torch.all(flying)
        new_v2f = torch.where(take, outs[0], v2f)
        valid = torch.where(take, outs[1], true_)
        if warm is not None:
            # a gated-off auction's tables are discarded like its v2f
            new_warm = CbaaTables(
                price=torch.where(take, outs[2].price, warm.price),
                who=torch.where(take, outs[2].who, warm.who))
    else:
        new_v2f, valid = v2f, true_
        take = torch.zeros((), dtype=torch.bool, device=dev)
    reassigned = take & torch.any(new_v2f != v2f)
    first_auction = state.first_auction & ~(take & valid)
    v2f = new_v2f

    # --- distributed control law -> distcmd ---
    rel = loclib.relative_views(loc) if cfg.localization == "flooded" \
        else None
    u = control.compute(swarm, formation, v2f, gains, rel=rel)
    if cfg.flight_fsm:
        u = torch.where(flying[:, None], u, torch.zeros_like(u))
    distcmd_norm = torch.linalg.vector_norm(u, dim=-1)

    # --- safety shim: saturate -> mux -> avoid -> safe trajectory ---
    u = control.saturate_velocity(u, sparams)
    u, yawrate = vehicle.mux_goals(u, inputs)
    if cfg.use_colavoid:
        u, ca = control.collision_avoidance(
            swarm.q, u, sparams, max_neighbors=cfg.colavoid_neighbors)
    else:
        ca = torch.zeros((n,), dtype=torch.bool, device=dev)
    safe_goal = control.make_safe_traj(cfg.control_dt, u, yawrate, goal,
                                       sparams)

    # --- flight FSM: per-mode goal override ---
    if cfg.flight_fsm:
        fs, goal = vehicle.flight_step(fs, goal, safe_goal, swarm.q,
                                       sparams, cfg.control_dt)
        ca = ca & flying
    else:
        goal = safe_goal

    # --- vehicle dynamics ---
    if cfg.dynamics == "tracking":
        swarm = SwarmState(q=goal.pos, vel=goal.vel)
    elif cfg.dynamics == "firstorder":
        a = min(max(cfg.control_dt / cfg.tau, 0.0), 1.0)
        vel = swarm.vel + a * (goal.vel - swarm.vel)
        swarm = SwarmState(q=swarm.q + vel * cfg.control_dt, vel=vel)
    else:  # doubleint: PD tracking law, semi-implicit Euler
        acc = cfg.kp_track * (goal.pos - swarm.q) \
            + cfg.kd_track * (goal.vel - swarm.vel)
        vel = swarm.vel + acc * cfg.control_dt
        swarm = SwarmState(q=swarm.q + vel * cfg.control_dt, vel=vel)

    new_state = SimState(swarm=swarm, goal=goal, v2f=v2f,
                         tick=state.tick + 1, flight=fs, loc=loc,
                         first_auction=first_auction,
                         assign_enabled=state.assign_enabled,
                         cbaa_warm=new_warm)
    return new_state, StepMetrics(distcmd_norm=distcmd_norm, ca_active=ca,
                                  assign_valid=valid, reassigned=reassigned,
                                  auctioned=take, q=swarm.q, mode=fs.mode,
                                  v2f=v2f)


def rollout(state: SimState, formation: Formation, gains: ControlGains,
            sparams: SafetyParams, cfg: SimConfig, n_ticks: int,
            inputs: ExternalInputs | None = None
            ) -> tuple[SimState, StepMetrics]:
    """Roll the swarm forward ``n_ticks`` ticks. ``inputs`` (optional) is
    an `ExternalInputs` stacked over a leading ``n_ticks`` axis. Returns
    the final state and `StepMetrics` stacked over time (leading axis
    ``n_ticks``), as the reference's scan does."""
    per_tick = []
    for t in range(n_ticks):
        state, m = step(state, formation, gains, sparams, cfg,
                        None if inputs is None else inputs.at(t))
        per_tick.append(m)
    stacked = {f.name: torch.stack([getattr(m, f.name) for m in per_tick])
               for f in fields(StepMetrics)} if per_tick else None
    return state, (StepMetrics(**stacked) if stacked else None)

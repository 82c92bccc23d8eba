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

`batched_rollout` rolls B independent trials at once: every tensor of the
state and the formation carries a leading ``(B,)`` axis (`stack_states`,
`core.types.make_formations`), and one `step` advances them all with one
set of launches — K1, K2 and K3 each take the whole batch. The trials
share the decimation phase, a host int (``tick0`` + the tick of the
rollout, the reference's ``shared_tick``); each trial's own tick is host
data too, a (B,) int64 array that a dispatch resets. The auction LAP and
CBAA, whose loops are polled from the host, run trial by trial inside a
batched auction tick, bit-identical to serial solves by construction.

A `FaultSchedule` (`aclswarm_torch.faults`) and a `Scenario`
(`aclswarm_torch.scenarios`) ride the state as data, one script per trial
of a batch: masks and `where`s of each trial's own tick, which the step
holds as a device tensor (`batched_rollout` builds it once per call, not
per tick). `no_faults` and `no_scenario` are bit-identical to None.

`parallel.rollout` runs `step` on one rank's agent rows of a sharded
state, one trial's or a whole batch's (its ``block`` argument): the same
stages, the O(n^2) ones on the rank's rows against gathered inputs, the
sequential loops replicated.

``SimConfig.check_mode='on'`` records the first violated invariant of
each trial into the ``SimState.inv`` carry (`analysis.invariants`), and
``telemetry='on'`` accumulates the device counters into ``SimState.tel``
(`telemetry.device`); both ride `StepMetrics` out. Every check and
counter site is gated in Python on the static mode, so ``'off'`` adds no
operation, and ``'on'`` adds operations but no host read and changes no
result.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from aclswarm_torch import control
from aclswarm_torch.analysis import invariants as invlib
from aclswarm_torch.analysis.invariants import InvariantState
from aclswarm_torch.assignment import auction, cbaa, sinkhorn
from aclswarm_torch.assignment.cbaa import CbaaTables
from aclswarm_torch.core import geometry
from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core import types as typeslib
from aclswarm_torch.core.types import (ControlGains, Formation, SafetyParams,
                                       SwarmState, as_float)
from aclswarm_torch.faults import masking as faultmask
from aclswarm_torch.faults import schedule as faultlib
from aclswarm_torch.faults.schedule import FaultSchedule
from aclswarm_torch.scenarios import timeline as scenlib
from aclswarm_torch.scenarios.timeline import Scenario
from aclswarm_torch.sim import localization as loclib
from aclswarm_torch.sim import vehicle
from aclswarm_torch.sim.localization import EstimateTable
from aclswarm_torch.sim.vehicle import ExternalInputs, FlightState
from aclswarm_torch.telemetry import device as devtel
from aclswarm_torch.telemetry.device import ChunkTelemetry


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
    valid one's fixed point. ``faults`` and ``scenario`` (None = the
    fault-free, scenario-free engine) are the trial's scripts. ``inv``
    (the invariant carry, ``check_mode='on'``) and ``tel`` (the counter
    carry, ``telemetry='on'``) are None when unused. A
    batch of B trials (`stack_states`) has a (B,) int64 numpy ``tick`` and
    a leading (B,) axis on every tensor."""

    swarm: SwarmState
    goal: control.TrajGoal
    v2f: torch.Tensor           # ([B,] n) int32 current assignment
    tick: int | np.ndarray
    flight: FlightState
    first_auction: torch.Tensor   # ([B,]) bool
    assign_enabled: torch.Tensor  # ([B,]) bool
    loc: EstimateTable | None = None
    cbaa_warm: CbaaTables | None = None
    faults: FaultSchedule | None = None
    scenario: Scenario | None = None
    inv: InvariantState | None = None
    tel: ChunkTelemetry | None = None


@dataclass
class StepMetrics:
    """Per-tick observables (stacked over time by `rollout`; a batched
    step adds a (B,) axis after the time axis)."""

    distcmd_norm: torch.Tensor   # (n,) |distcmd| per vehicle (pre-safety)
    ca_active: torch.Tensor      # (n,) collision avoidance modified the cmd
    assign_valid: torch.Tensor   # () bool: this tick's auction gave a perm
    reassigned: torch.Tensor     # () bool: assignment changed this tick
    auctioned: torch.Tensor      # () bool: an auction ran this tick
    q: torch.Tensor              # (n, 3) positions after the tick
    mode: torch.Tensor           # (n,) int32 flight mode after the tick
    v2f: torch.Tensor            # (n,) assignment after the tick
    # None unless the state carries a FaultSchedule / a Scenario
    alive: torch.Tensor | None = None        # (n,) bool alive this tick
    fault_event: torch.Tensor | None = None  # () bool: an alive bit flipped
    scen_event: torch.Tensor | None = None   # () bool: a scenario axis
    #                                          flipped state this tick
    # None unless cfg.check_mode / cfg.telemetry is 'on'
    inv_code: torch.Tensor | None = None     # () int32 first violation's
    #                                          code so far (0 = clean)
    tel: ChunkTelemetry | None = None        # the counters after the tick


def init_state(q0, v2f0=None, flying: bool = True,
               localization: bool = False, faults=None,
               checks: bool = False, telemetry: bool = False,
               scenario=None, cbaa_warm: bool = False,
               device=None, dtype=torch.float32) -> SimState:
    """``flying=True`` starts airborne in FLYING, ``False`` on the ground
    (send CMD_GO with ``cfg.flight_fsm``). ``localization=True``
    allocates the estimate tables ('flooded' mode). ``cbaa_warm=True``
    allocates the CBAA warm-start tables (cold, `cbaa.init_tables`).
    ``faults`` (a `FaultSchedule`) and ``scenario`` (a `Scenario`) attach
    the trial's scripts; None keeps the fault-free, scenario-free engine.
    ``checks=True`` allocates the invariant carry (needed iff the rollout
    runs with ``cfg.check_mode='on'``), ``telemetry=True`` the counter
    carry (``cfg.telemetry='on'``). ``device=None`` is the card; the state
    lives on ``device`` in ``dtype``."""
    q0 = as_float(q0, device, dtype)
    dev = q0.device
    n = q0.shape[0]
    if scenario is not None and scenario.n != n:
        raise ValueError(f"scenario scripts n={scenario.n} agents but "
                         f"the state carries n={n}")
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
        cbaa_warm=cbaa.init_tables(n, dev, dtype) if cbaa_warm else None,
        faults=faults, scenario=scenario,
        inv=invlib.init_invariants(device=dev) if checks else None,
        tel=devtel.init_telemetry(dtype=dtype, device=dev) if telemetry
        else None)


def _check_cfg(cfg: SimConfig) -> None:
    if cfg.assignment not in ("auction", "sinkhorn", "cbaa", "none"):
        raise ValueError(f"unknown assignment mode {cfg.assignment!r}")
    for what in ("check_mode", "telemetry"):
        mode = getattr(cfg, what)
        if mode not in ("off", "on"):
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
           warm: CbaaTables | None = None,
           check: bool = False, tel: bool = False):
    """One re-assignment: ``(v2f, valid[, code][, rounds][, tables])``.
    ``check`` appends the solver-level invariant code (([B,]) int32, 0 =
    clean: the `sinkhorn_marginal` contract on K1's plan), ``tel`` the
    solver's rounds (([B,]) int32: the auction LAP's bid rounds, CBAA's
    consensus rounds, 0 for Sinkhorn), and ``warm`` the updated
    `CbaaTables`, in that order; each flag is Python-gated, so without
    them the return is ``(v2f, valid)``.

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
    if v2f.ndim > 1 and cfg.assignment in ("auction", "cbaa"):
        return _assign_by_trial(swarm, formation, v2f, cfg, est, first,
                                alive, link_mask, warm, check, tel)
    lead = v2f.shape[:-1]
    true_ = torch.ones(lead, dtype=torch.bool, device=v2f.device)

    def zeros():
        return torch.zeros(lead, dtype=torch.int32, device=v2f.device)

    def ret(new_v2f, valid, code, rounds):
        out = (new_v2f, valid)
        if check:
            out += (zeros() if code is None else code,)
        if tel:
            out += (zeros() if rounds is None else rounds.to(torch.int32),)
        return out

    def hysteresis(cand, cost):
        """Keep the current assignment unless the candidate improves the
        total of the (n, n) vehicle->aligned-point distances ``cost`` by
        the relative margin (per trial)."""
        if cfg.assign_eps <= 0.0:
            return cand
        cost_new = torch.sum(cost.gather(-1, cand.long()[..., None]),
                             dim=(-2, -1))
        cost_cur = torch.sum(cost.gather(-1, v2f.long()[..., None]),
                             dim=(-2, -1))
        take = cost_new < (1.0 - cfg.assign_eps) * cost_cur
        if first is not None:
            take = take | first
        return torch.where(take[..., None], cand, v2f)

    if cfg.assignment == "none":
        return ret(v2f, true_, None, None)
    if cfg.assignment == "cbaa":
        res = cbaa.cbaa_from_state(swarm.q, formation.points,
                                   formation.adjmat, v2f, est=est,
                                   task_block=cfg.cbaa_task_block,
                                   alive=alive, comm_extra=link_mask,
                                   warm=warm, assign_eps=cfg.assign_eps,
                                   first=first)
        out = ret(torch.where(res.valid, res.v2f, v2f), res.valid, None,
                  res.rounds)
        if warm is None:
            return out
        # only a VALID auction's fixed point is worth carrying
        return out + (CbaaTables(
            price=torch.where(res.valid, res.price, warm.price),
            who=torch.where(res.valid, res.who, warm.who)),)
    if cfg.assignment not in ("auction", "sinkhorn"):
        raise ValueError(f"unknown assignment mode {cfg.assignment!r}")
    q_form = permutil.veh_to_formation_order(swarm.q, v2f)
    paligned = geometry.align(formation.points, q_form, d=2)
    if cfg.assignment == "auction":
        c = geometry.cdist(swarm.q, paligned)
        if alive is not None:
            c = faultmask.mask_cost(c, alive, v2f)
        res = auction.auction_lap(-c)
        return ret(torch.where(res.valid, hysteresis(res.row_to_col, c),
                               v2f), res.valid, None, res.iters)
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
    code = None
    if check:
        # the marginal contract on the transport plan K1 returned (the
        # rounded permutation is the engine's assign_perm contract)
        row_err, col_err = sinkhorn.marginal_errors(res.plan_log)
        code = invlib.sinkhorn_marginals_violated(row_err, col_err).to(
            torch.int32) * invlib.CODES["sinkhorn_marginal"]
    return ret(hysteresis(res.row_to_col, c), true_, code, None)


def _assign_by_trial(swarm, formation, v2f, cfg, est, first, alive,
                     link_mask, warm, check, tel):
    """`assign` for a batch of trials in the host-polled modes (the auction
    LAP, CBAA): one serial solve per trial, the results (codes and rounds
    too) stacked — the serial outputs bit for bit."""
    def pick(x, b):
        return None if x is None else typeslib.row(x, b)

    outs = [assign(typeslib.row(swarm, b), typeslib.row(formation, b),
                   v2f[b], cfg, est=pick(est, b), first=pick(first, b),
                   alive=pick(alive, b), link_mask=pick(link_mask, b),
                   warm=pick(warm, b), check=check, tel=tel)
            for b in range(v2f.shape[0])]
    return tuple(typeslib.stack(list(xs)) for xs in zip(*outs))


def _pdistmat(points: torch.Tensor) -> torch.Tensor:
    """`geometry.pdistmat` of ([B,] n, d) points, trial by trial (a
    product over the batch would round otherwise than the lone ones)."""
    if points.ndim == 2:
        return geometry.pdistmat(points)
    return torch.stack([geometry.pdistmat(p) for p in points])


def _trial_ticks(state: SimState, dev) -> torch.Tensor:
    """Each trial's own tick as an int32 tensor on the device: a fill for
    one trial, a host-to-device copy for a batch (`batched_rollout` passes
    its own instead, built once per call)."""
    if isinstance(state.tick, np.ndarray):
        return torch.as_tensor(state.tick.astype(np.int32)).to(dev)
    return torch.full((), int(state.tick), dtype=torch.int32, device=dev)


def _same(x):
    return x


def step(state: SimState, formation: Formation, gains: ControlGains,
         sparams: SafetyParams, cfg: SimConfig,
         inputs: ExternalInputs | None = None,
         shared_tick: int | None = None,
         trial_ticks: torch.Tensor | None = None,
         block=None) -> tuple[SimState, StepMetrics]:  # torchcheck: device-path
    """One 100 Hz control tick for the whole swarm, or for a batch of
    trials. ``shared_tick`` (host int) replaces ``state.tick`` as the
    decimation phase (auction period, flood cadence); a batch needs it,
    and every trial's tick must agree with it modulo `assign_every` and
    `flood_every` (the batched trial driver aligns dispatches to chunk
    boundaries so they do). The fault and scenario masks key on each
    trial's own tick: ``trial_ticks`` (optional, ([B,]) int32 on the
    device) is ``state.tick`` already there.

    ``block`` (`parallel.rollout`'s row block) runs the tick on one rank's
    agent rows ``[block.lo, block.hi)`` of a sharded state, of one trial
    or of every trial of a batch (``([B,] r, ...)`` leaves): ``state`` and
    ``formation`` hold that rank's part (`parallel.mesh.shard_problem`);
    the flood, the control law and the avoidance compute the rank's rows
    against whole inputs (``block.gather``, which moves a batch whole);
    the assignment and the masks run on the whole, and the metrics come
    back whole. Every such site is gated in Python, so without ``block``
    the operations are the unsharded step's."""
    _check_cfg(cfg)
    swarm, goal, v2f, fs = state.swarm, state.goal, state.v2f, state.flight
    r = swarm.q.shape[-2]               # the rows this step advances
    lead = swarm.q.shape[:-2]           # () or (B,) trials
    dev = swarm.q.device
    if shared_tick is None:
        if lead:
            raise ValueError("a batched step needs shared_tick, the "
                             "trials' common decimation phase")
        shared_tick = state.tick
    if inputs is None:
        inputs = ExternalInputs.none(r, dev, swarm.q.dtype,
                                     batch=lead[0] if lead else None)
    # a sharded tick's whole positions and assignment, its collectives
    # (the gather of row blocks, the max over ranks) and its row span
    if block is None:
        n, q, adj, whole, top, span = r, swarm.q, formation.adjmat, _same, \
            _same, None
    else:
        n, whole, top, span = block.n, block.gather, block.top, \
            (block.lo, block.hi)
        q, v2f = block.start(swarm.q, v2f)
        adj = block.adjacency()
    true_ = torch.ones(lead, dtype=torch.bool, device=dev)
    faults, scen = state.faults, state.scenario
    # the sanitizer and the counters (`analysis.invariants`,
    # `telemetry.device`): every site below is gated in Python on the
    # static modes, so 'off' adds no operation. Recording order = blame
    # priority (first violation wins; see invariants.CONTRACTS).
    checks = cfg.check_mode == "on"
    tel_on = cfg.telemetry == "on"
    inv, tel = state.inv, state.tel
    if checks and inv is None:
        raise ValueError("cfg.check_mode='on' needs init_state(..., "
                         "checks=True): the sanitizer records violations "
                         "into the SimState.inv carry")
    if tel_on and tel is None:
        raise ValueError("cfg.telemetry='on' needs init_state(..., "
                         "telemetry=True): the counters accumulate into "
                         "the SimState.tel carry")
    if (faults is not None or scen is not None or checks) \
            and trial_ticks is None:
        trial_ticks = _trial_ticks(state, dev)
    if checks:
        inv = invlib.record(inv, invlib.adjacency_asymmetric(adj),
                            "adj_sym", trial_ticks)

    # --- fault model: masks of each trial's own tick ---
    if faults is not None:
        alive_rows = faultlib.alive_at(faults, trial_ticks)
        alive = whole(alive_rows)
        # delivered iff both ends live and the loss draw spares it
        link_mask = faultlib.link_up_at(faults, trial_ticks, rows=span) \
            & alive_rows[..., :, None] & alive[..., None, :]
        fault_event = top(faultlib.fault_event_at(faults, trial_ticks))
        if checks:
            inv = invlib.record(inv, top(invlib.alive_mask_stale(
                alive_rows, faults, trial_ticks)), "mask_consistency",
                trial_ticks)
    else:
        alive_rows = alive = link_mask = fault_event = None

    # --- scenario timeline: an axis off for every trial (host onsets) is
    # skipped, which equals its `where` against the baseline ---
    changed = None
    if scen is not None:
        on = scenlib.axes_on(scen, state.tick)
        if checks and not on["formation"]:
            # the axis is off for every trial: the effective points are
            # the formation's own
            inv = invlib.record(inv, invlib.nonfinite_points(
                formation.points), "scen_points", trial_ticks)
        if on["formation"]:
            # (c)+(e): the effective formation and its desired distances
            pts, changed = scenlib.formation_points_at(
                scen, formation.points, trial_ticks, cfg.control_dt)
            if checks:
                inv = invlib.record(inv, invlib.nonfinite_points(pts),
                                    "scen_points", trial_ticks)
            changed = changed[..., None, None]
            if block is None:
                formation = replace(
                    formation, points=pts,
                    dstar_xy=torch.where(changed, _pdistmat(pts[..., :2]),
                                         formation.dstar_xy),
                    dstar_z=torch.where(changed, _pdistmat(pts[..., 2:3]),
                                        formation.dstar_z))
            else:
                # the block's distance rows follow its vehicles' points
                formation = replace(formation, points=pts)
        scen_event = scenlib.scenario_event_at(scen, trial_ticks)
    else:
        scen_event = None

    # --- operator flight-mode broadcast ---
    if cfg.flight_fsm:
        fs = vehicle.apply_command(fs, inputs.cmd)
    flying = fs.mode == vehicle.FLYING

    # --- mutual localization: flood at its own 50 Hz rate ---
    loc = state.loc
    loc_view = None
    if cfg.localization == "flooded":
        if loc is None:
            if faults is not None:
                raise ValueError(
                    "cfg.localization='flooded' combined with a "
                    "FaultSchedule needs init_state(..., "
                    "localization=True, faults=...): the fault model "
                    "drops flood links, which requires the estimate "
                    "tables to exist")
            raise ValueError("cfg.localization='flooded' needs "
                             "init_state(..., localization=True)")
        # a block floods its receivers against the gathered senders
        rows_kw = {} if block is None else {"lo": block.lo,
                                            "gather": block.gather}
        if cfg.flood_phases == 1:
            loc = loclib.tick(loc, swarm.q, adj, v2f,
                              shared_tick % cfg.flood_every == 0,
                              target_block=cfg.flood_block,
                              link_mask=link_mask, **rows_kw)
        else:
            loc = loclib.tick_phased(loc, swarm.q, adj, v2f,
                                     shared_tick, cfg.flood_every,
                                     cfg.flood_phases,
                                     target_block=cfg.flood_block,
                                     link_mask=link_mask, **rows_kw)
        # (b) sensor noise on the consumed view only; the carry stays clean
        loc_view = loc
        if scen is not None and on["noise"]:
            draw, noisy = scenlib.est_noise_at(scen, trial_ticks, n,
                                               swarm.q.dtype)
            if block is not None:
                draw = draw.narrow(-3, block.lo, block.hi - block.lo)
            loc_view = loclib.noised_view(loc, (draw, noisy))

    # --- auto-auction, decimated on the host tick; the airborne, enabled
    # and (e) re-matching gates select on the candidate as in the
    # reference ---
    # CBAA alone consumes the flooded estimates and the warm tables
    est = loc_view.est if loc_view is not None else None
    warm = state.cbaa_warm if cfg.assignment == "cbaa" else None
    new_warm = state.cbaa_warm
    cand_rounds = None
    auction = cfg.assignment != "none" \
        and shared_tick % cfg.assign_every == 0
    if auction:
        # a block's solvers run replicated on the whole inputs
        bidders = swarm if block is None else SwarmState(q=q, vel=None)
        solver_form, solver_est, link, warm_all = (formation, est,
                                                   link_mask, warm)
        if block is not None:
            cb = cfg.assignment == "cbaa"
            solver_form = Formation(points=formation.points, adjmat=adj,
                                    gains=None, dstar_xy=None, dstar_z=None)
            solver_est = whole(est) if cb and est is not None else None
            link = whole(link_mask) if cb and link_mask is not None \
                else None
            if warm is not None:
                warm_all = CbaaTables(price=whole(warm.price),
                                      who=whole(warm.who))
        if scen is not None and on["byz"]:
            # (d) the solvers see the reported positions, byzantine rows
            # lying; control and dynamics keep the true state
            byz = scen if block is None else replace(
                scen, byz_mask=whole(scen.byz_mask))
            bidders = SwarmState(q=scenlib.reported_positions(
                byz, bidders.q, trial_ticks), vel=bidders.vel)
        if checks:
            # the solvers see non-finite inputs as 0: LAPACK and the
            # rounding refuse a NaN pose, which is the sanitizer's to
            # report (finite inputs pass through bit for bit)
            bidders = SwarmState(q=torch.nan_to_num(bidders.q),
                                 vel=bidders.vel)
            solver_form = replace(solver_form, points=torch.nan_to_num(
                solver_form.points))
            if solver_est is not None:
                solver_est = torch.nan_to_num(solver_est)
        outs = assign(bidders, solver_form, v2f, cfg, est=solver_est,
                      first=state.first_auction, alive=alive,
                      link_mask=link, warm=warm_all, check=checks,
                      tel=tel_on)
        take = state.assign_enabled
        if cfg.flight_fsm:
            all_flying = torch.all(flying, dim=-1)
            if block is not None:
                all_flying = ~top(~all_flying)
            take = take & all_flying
        if scen is not None:
            take = take & scenlib.rematch_ok_at(scen, trial_ticks)
        new_v2f = torch.where(take[..., None], outs[0], v2f)
        valid = torch.where(take, outs[1], true_)
        i = 2
        if checks:
            # a gated-off candidate is discarded, so are its violations
            inv = invlib.record_code(inv, torch.where(
                take, outs[i], torch.zeros_like(outs[i])), trial_ticks)
            i += 1
        if tel_on:
            cand_rounds = outs[i]
            i += 1
        if warm is not None:
            # a gated-off auction's tables are discarded like its v2f
            price, who = outs[i].price, outs[i].who
            if block is not None:
                price, who = (
                    price.narrow(-2, block.lo, block.hi - block.lo),
                    who.narrow(-2, block.lo, block.hi - block.lo))
            new_warm = CbaaTables(
                price=torch.where(take[..., None, None], price,
                                  warm.price),
                who=torch.where(take[..., None, None], who, warm.who))
    else:
        new_v2f, valid = v2f, true_
        take = torch.zeros(lead, dtype=torch.bool, device=dev)
    reassigned = take & torch.any(new_v2f != v2f, dim=-1)
    first_auction = state.first_auction & ~(take & valid)
    v2f = new_v2f
    # the rows the state carries (a block's stay the same tensor between
    # auctions, so its formation rows move only after one)
    v2f_rows = v2f if block is None else (
        v2f.narrow(-1, block.lo, block.hi - block.lo).contiguous()
        if auction else state.v2f)
    if checks:
        # every solver's output and the held assignment alike
        inv = invlib.record(inv, invlib.perm_violated(v2f), "assign_perm",
                            trial_ticks)

    # --- distributed control law -> distcmd ---
    rel = None if loc_view is None else loclib.relative_views(
        loc_view, **({} if block is None else {"lo": block.lo}))
    alive_form = None
    if faults is not None:
        # dead vehicles leave the formation graph: their points cast no
        # edges (masked in formation space through the assignment)
        alive_form = faultmask.alive_points(alive, v2f)
    if block is None:
        ctrl_formation = formation
        if faults is not None:
            pair_alive = alive_form[..., :, None] & alive_form[..., None, :]
            ctrl_formation = replace(formation, adjmat=torch.where(
                pair_alive, formation.adjmat,
                torch.zeros((), dtype=formation.adjmat.dtype, device=dev)))
        u = control.compute(swarm, ctrl_formation, v2f, gains, rel=rel)
    else:
        # each vehicle's law where it lives, on its formation point's rows
        u = control.compute_rows(
            swarm.vel, block.formation_rows(v2f_rows, formation.points,
                                            changed, alive_form),
            v2f, block.lo, gains, q=q, rel=rel)
    if cfg.flight_fsm:
        u = torch.where(flying[..., None], u, torch.zeros_like(u))
    if faults is not None:
        # dead vehicles publish no distcmd
        u = torch.where(alive_rows[..., None], u, torch.zeros_like(u))
    distcmd_norm = whole(torch.linalg.vector_norm(u, dim=-1))
    if checks and faults is not None:
        inv = invlib.record(inv, invlib.dead_rows_active(distcmd_norm,
                                                         alive),
                            "dead_distcmd", trial_ticks)

    # --- safety shim: saturate -> mux -> avoid -> safe trajectory ---
    u = control.saturate_velocity(u, sparams)
    u, yawrate = vehicle.mux_goals(u, inputs)
    if cfg.use_colavoid:
        # (a) active scenario obstacles cast sectors beside the vehicles
        obstacles = None
        if scen is not None and on["obstacles"]:
            obs_pos, obs_act = scenlib.obstacles_at(scen, trial_ticks,
                                                    cfg.control_dt)
            obstacles = (obs_pos, scen.obs_radius, obs_act)
        u, ca = control.collision_avoidance(
            q, u, sparams, max_neighbors=cfg.colavoid_neighbors,
            neighbor_mask=alive, obstacles=obstacles, rows=span)
    else:
        ca = torch.zeros(lead + (r,), dtype=torch.bool, device=dev)
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
    new_swarm = dynamics(cfg, swarm, goal)

    # --- (b) wind displaces the integrated positions, before the fault
    # freeze: a dead vehicle stays frozen in wind ---
    if scen is not None and on["wind"]:
        dq, wind_on = scenlib.wind_at(scen, trial_ticks, cfg.control_dt, n,
                                      swarm.q.dtype)
        if block is not None:
            dq = dq.narrow(-2, block.lo, block.hi - block.lo)
        new_swarm = SwarmState(
            q=torch.where(wind_on[..., None, None], new_swarm.q + dq,
                          new_swarm.q), vel=new_swarm.vel)

    # --- fault freeze: dead vehicles hold pose, goal and flight mode ---
    if faults is not None:
        row = alive_rows[..., None]

        def hold(new, old):
            return torch.where(row if new.ndim > alive_rows.ndim
                               else alive_rows, new, old)

        new_swarm = typeslib.tree_map(hold, new_swarm, swarm)
        goal = typeslib.tree_map(hold, goal, state.goal)
        fs = typeslib.tree_map(hold, fs, state.flight)
        ca = ca & alive_rows

    if checks:
        if faults is not None:
            inv = invlib.record(inv, top(invlib.dead_rows_moved(
                new_swarm.q, swarm.q, alive_rows)), "dead_frozen",
                trial_ticks)
        # finiteness before bounds: a NaN pose fails the inside test too
        inv = invlib.record(inv, top(invlib.nonfinite_state(new_swarm,
                                                            goal)),
                            "state_finite", trial_ticks)
        inv = invlib.record(inv, top(invlib.out_of_bounds(new_swarm.q,
                                                          sparams)),
                            "state_bounds", trial_ticks)

    # --- counters, after every mask is final (`ca` is what flew) ---
    ca_all = whole(ca)
    if tel_on:
        rounds = tel.assign_rounds
        if cand_rounds is not None:
            rounds = rounds + torch.where(take, cand_rounds,
                                          torch.zeros_like(cand_rounds))
        stale = tel.flood_stale_max
        if cfg.localization == "flooded":
            stale = torch.maximum(stale, top(torch.amax(
                loc.age, dim=(-2, -1)).to(torch.int32)))
        tel = replace(tel, auctions=tel.auctions + take.to(torch.int32),
                      assign_rounds=rounds,
                      reassigns=tel.reassigns + reassigned.to(torch.int32),
                      ca_ticks=tel.ca_ticks + torch.sum(ca_all, dim=-1,
                                                        dtype=torch.int32),
                      flood_stale_max=stale)

    new_state = SimState(swarm=new_swarm, goal=goal, v2f=v2f_rows,
                         tick=state.tick + 1, flight=fs, loc=loc,
                         first_auction=first_auction,
                         assign_enabled=state.assign_enabled,
                         cbaa_warm=new_warm, faults=faults, scenario=scen,
                         inv=inv, tel=tel)
    return new_state, StepMetrics(distcmd_norm=distcmd_norm,
                                  ca_active=ca_all, assign_valid=valid,
                                  reassigned=reassigned, auctioned=take,
                                  q=whole(new_swarm.q),
                                  mode=whole(fs.mode), v2f=v2f, alive=alive,
                                  fault_event=fault_event,
                                  scen_event=scen_event,
                                  inv_code=inv.code if checks else None,
                                  tel=tel if tel_on else None)


def dynamics(cfg: SimConfig, swarm: SwarmState,
             goal: control.TrajGoal) -> SwarmState:
    """The vehicles' response to their goals over one tick, row by row:
    'tracking' lands on the goal, 'firstorder' lags its velocity by
    ``tau``, 'doubleint' is a PD tracking law (semi-implicit Euler)."""
    if cfg.dynamics == "tracking":
        return SwarmState(q=goal.pos, vel=goal.vel)
    if cfg.dynamics == "firstorder":
        a = min(max(cfg.control_dt / cfg.tau, 0.0), 1.0)
        vel = swarm.vel + a * (goal.vel - swarm.vel)
        return SwarmState(q=swarm.q + vel * cfg.control_dt, vel=vel)
    acc = cfg.kp_track * (goal.pos - swarm.q) \
        + cfg.kd_track * (goal.vel - swarm.vel)
    vel = swarm.vel + acc * cfg.control_dt
    return SwarmState(q=swarm.q + vel * cfg.control_dt, vel=vel)


def _stack_metrics(per_tick: list) -> StepMetrics | None:
    if not per_tick:
        return None
    return StepMetrics(**{f.name: None if getattr(per_tick[0], f.name)
                          is None else typeslib.stack([getattr(m, f.name)
                                                       for m in per_tick])
                          for f in fields(StepMetrics)})


def rollout(state: SimState, formation: Formation, gains: ControlGains,
            sparams: SafetyParams, cfg: SimConfig, n_ticks: int,
            inputs: ExternalInputs | None = None
            ) -> tuple[SimState, StepMetrics]:  # torchcheck: device-path
    """Roll the swarm forward ``n_ticks`` ticks. ``inputs`` (optional) is
    an `ExternalInputs` stacked over a leading ``n_ticks`` axis. Returns
    the final state and `StepMetrics` stacked over time (leading axis
    ``n_ticks``), as the reference's scan does."""
    per_tick = []
    for t in range(n_ticks):
        state, m = step(state, formation, gains, sparams, cfg,
                        None if inputs is None else inputs.at(t))
        per_tick.append(m)
    return state, _stack_metrics(per_tick)


def batched_rollout(state: SimState, formation: Formation,
                    gains: ControlGains, sparams: SafetyParams,
                    cfg: SimConfig, n_ticks: int,  # torchcheck: device-path
                    inputs: ExternalInputs | None = None, tick0: int = 0
                    ) -> tuple[SimState, StepMetrics]:
    """Roll B independent trials forward ``n_ticks`` ticks at once.

    ``state`` and ``formation`` carry a leading (B,) axis (`stack_states`,
    `core.types.make_formations`; trials may fly different formations of
    one size n); ``gains``, ``sparams`` and ``cfg`` are shared. ``inputs``
    (optional) is stacked over time then trials, leaves (n_ticks, B, ...).
    ``tick0`` is the shared decimation phase of the first tick (the
    reference's ``shared_tick``): tick t of the rollout auctions when
    ``(tick0 + t) % assign_every == 0``. Returns the final batched state
    and `StepMetrics` with leaves (n_ticks, B, ...) — per trial, the
    serial `rollout` of the same start bit for bit. With faults,
    scenarios or checks the trials' own ticks cross to the device once, as
    offsets from the shared phase."""
    offset = None
    if state.faults is not None or state.scenario is not None \
            or cfg.check_mode == "on":
        offset = torch.as_tensor(
            (np.asarray(state.tick) - tick0).astype(np.int32)).to(
                state.v2f.device)
    per_tick = []
    for t in range(n_ticks):
        state, m = step(state, formation, gains, sparams, cfg,
                        None if inputs is None else inputs.at(t),
                        shared_tick=tick0 + t,
                        trial_ticks=None if offset is None
                        else offset + (tick0 + t))
        per_tick.append(m)
    return state, _stack_metrics(per_tick)


def stack_states(states: list[SimState]) -> SimState:
    """B serial states (same n, same optional carries) -> one batched
    state: a leading (B,) axis on every tensor and a (B,) int64 tick."""
    out = typeslib.stack(states)
    if out.scenario is not None:
        scenlib.stack_host([s.scenario for s in states], out.scenario)
    return replace(out, tick=np.asarray([s.tick for s in states], np.int64))


def take_trials(state: SimState, idx) -> SimState:
    """Trials ``idx`` (a host sequence of ints) of a batched state, in that
    order — the compaction's row gather."""
    keep = list(idx)
    rows = torch.as_tensor(keep, dtype=torch.int64).to(state.v2f.device)
    out = typeslib.take_rows(state, rows)
    if out.scenario is not None:
        scenlib.take_host(state.scenario, keep, out.scenario)
    return replace(out, tick=np.asarray(state.tick)[keep])


def trial(state: SimState, b: int) -> SimState:
    """Trial ``b`` of a batched state as a serial state (views)."""
    out = typeslib.row(state, b)
    if out.scenario is not None:
        scenlib.take_host(state.scenario, b, out.scenario)
    return replace(out, tick=int(state.tick[b]))

"""The swarm step sharded over the agent mesh (port of
`aclswarm_tpu/parallel/rollout.py`).

Where the reference lets GSPMD partition `sim.step`, each rank here runs
`sim.step` itself on its own block of agent rows ``[lo, hi)``
(`parallel.mesh`; the step's ``block`` argument, `_Block` below), and
every byte between ranks is an explicit call in `parallel.collectives`.
The callables take the rank's local state (rows of the row-sharded
leaves, all of the replicated ones) and return the next local state with
the tick's `StepMetrics` replicated on every rank.

What each stage does with the rows (collectives per tick, and their bytes
per rank at n=1000 in float32 on k ranks, the chip's cell; ``gather``
counts its whole output):

- partitioned, O(n^2) or more per tick:
  - the flood merge: K3 on the rank's receivers against every sender's
    ages of the flooded stripe, the winners' estimates read from the
    gathered stripe. Two gathers, (n, w) int32 ages and (n, w, 3)
    estimates: 8.0 MB a tick at w = 500 (``flood_phases=2``), 16 MB at
    w = n;
  - the control law, where each vehicle lives: its flooded relative views
    never move; the gain, desired-distance and adjacency rows of its
    formation point move to it instead, once per change of the local
    assignment (k broadcasts of each rank's formation block, n^2 x 11
    floats: 44 MB per re-assignment; the whole adjacency, n^2 floats =
    4 MB, is gathered once, at the first tick). The 3x3 gain products
    run on the rank's rows alone, of one trial or of a batch: they are
    elementwise (`control.distcntrl._gain_product`), so a row's bits do
    not depend on the rows beside it;
  - collision avoidance (dense and k-nearest), the rank's rows against
    the whole positions;
- per row, no communication: observe-self, the saturation, the mux, the
  safety integrator, the flight FSM, the dynamics, the wind and the fault
  freeze;
- replicated, every rank from gathered inputs (docs/SCALING.md's rule for
  sequential loops): the assignment, Sinkhorn (K1 + K2 as the engine
  calls it, without ``stage_shardings``), the auction LAP and CBAA's
  consensus (on CBAA ticks the whole estimate table is gathered,
  n^2 x 3 floats = 12 MB, and the warm tables when carried); the fault
  draws and masks, the scenario timeline and draws, and the sanitizer's
  contracts;
- the tick's end: four gathers, of the new positions, |distcmd|, the
  avoidance flags and the flight modes (n x (12 + 4 + 1 + 4) bytes =
  21 KB), which are the replicated `StepMetrics` and the next tick's
  whole positions; with faults, one gather of the alive mask (n bytes)
  and one reduce of the fault event; with checks or telemetry, one
  reduce of each late flag and of the stale age (4 bytes each).

So a flooded tick moves about 8.0 MB per rank at n=1000 with two phases,
and the truth-mode tick 21 KB, plus 44 MB per re-assignment. A rank
outside the mesh (an uneven world) receives the replicated outputs from
the mesh's first rank (`collectives.spill`, on the device).

`batched_rollout_fn` composes both scaling axes in one program, as the
reference's does: each tick is one `sim.step` on the rank's rows of every
trial of the batch (leaves ``(B, r, ...)``), and every collective above
carries the trial axis. So a batch of B trials makes the same collective
calls per tick as one trial and moves B times the bytes (a flooded tick:
about B x 8.0 MB per rank at n=1000 with two phases; B x 44 MB per
re-assignment), K3 merges every trial's receivers in one launch per tick,
and K1 and K2 solve the whole batch's assignment once per auction tick
(K1's residency waves, K2's split grid). The trials share the decimation
phase, the tick of the rollout (`sim.batched_rollout`'s ``shared_tick``
from a first tick of 0), and their ticks must agree with each other
modulo ``assign_every`` and, flooded, ``flood_every``. Every stage
listed as partitioned stays partitioned in a batch: a rank's gain
products are its own B x r x n rows.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core.types import Formation
from aclswarm_torch.parallel import collectives as coll
from aclswarm_torch.parallel import mesh as meshlib
from aclswarm_torch.sim import engine as _engine
from aclswarm_torch.sim.engine import SimState, StepMetrics


class _Block:
    """One rank's rows ``[lo, hi)`` of the agent axis, as `sim.step`'s
    ``block`` sees them: the collectives (``gather``, ``top``), the whole
    positions and assignment a tick starts from (``start``), the whole
    adjacency (gathered at the first tick) and the formation rows of the
    rank's vehicles (``formation_rows``), kept for the local assignment
    tensor they were moved for (a tick without an auction passes that
    tensor on unchanged). A trial-batched formation (leaves (B, ...))
    makes a batched block: the agent axis is axis 1 of every leaf, and
    each collective moves the whole batch."""

    def __init__(self, mesh, formation: Formation):
        self.mesh = mesh
        self.form = formation
        self.n = formation.points.shape[-2]
        self.axis = formation.points.ndim - 2    # 1 behind a trial axis
        self.lo, self.hi = mesh.rows(self.n)
        self.carry = None
        self._adj = None
        self._rows_for = None
        self._rows = None

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return coll.gather(x, self.mesh, axis=self.axis)

    def top(self, x: torch.Tensor) -> torch.Tensor:
        return coll.reduce_max(x, self.mesh)

    def start(self, q_rows: torch.Tensor, v2f_rows: torch.Tensor):
        """The whole (q, v2f) at the tick's start: the last tick's
        metrics in a rollout (``carry``), else gathered."""
        if self.carry is not None:
            return self.carry
        return self.gather(q_rows), self.gather(v2f_rows)

    def adjacency(self) -> torch.Tensor:
        if self._adj is None:
            self._adj = self.gather(self.form.adjmat)
        return self._adj

    def _vehicle_rows(self, v2f_rows: torch.Tensor) -> Formation:
        """The adjacency, gain and desired-distance rows of the points
        ``v2f_rows``, in vehicle order: each rank broadcasts its block in
        turn and every rank keeps the rows it needs (one block in memory
        at a time)."""
        if self._rows_for is v2f_rows:
            return self._rows
        mesh, n, lead = self.mesh, self.n, self.axis
        fr = v2f_rows.long()
        per = n // mesh.size
        mine = (self.form.gains, self.form.dstar_xy, self.form.dstar_z)
        out = [x.new_zeros(fr.shape + x.shape[fr.ndim:]) for x in mine]
        for p in range(mesh.size):
            sel = (fr >= p * per) & (fr < (p + 1) * per)
            at = torch.clamp(fr - p * per, 0, per - 1)
            for i, x in enumerate(mine):
                blk = coll.broadcast(x if mesh.index == p else None, p, x,
                                     mesh)
                pick = permutil.take(blk, at, lead)
                out[i] = torch.where(
                    sel.view(sel.shape + (1,) * (pick.ndim - sel.ndim)),
                    pick, out[i])
        self._rows = Formation(points=self.form.points,
                               adjmat=permutil.take(self.adjacency(), fr,
                                                    lead),
                               gains=out[0], dstar_xy=out[1],
                               dstar_z=out[2])
        self._rows_for = v2f_rows
        return self._rows

    def formation_rows(self, v2f_rows: torch.Tensor, points: torch.Tensor,
                       changed: torch.Tensor | None,
                       alive_form: torch.Tensor | None) -> Formation:
        """The control law's rows for the rank's vehicles: the distances
        of the tick's points where a scenario stage ``changed`` them, the
        edges of dead points (``alive_form``, by point) cut."""
        rows = self._vehicle_rows(v2f_rows)
        fr, lead = v2f_rows.long(), self.axis
        if changed is not None:
            rows = replace(
                rows,
                dstar_xy=torch.where(changed, permutil.take(
                    _engine._pdistmat(points[..., :2]), fr, lead),
                    rows.dstar_xy),
                dstar_z=torch.where(changed, permutil.take(
                    _engine._pdistmat(points[..., 2:3]), fr, lead),
                    rows.dstar_z))
        if alive_form is not None:
            rows = replace(rows, adjmat=torch.where(
                permutil.take(alive_form, fr, lead)[..., :, None]
                & alive_form[..., None, :], rows.adjmat,
                torch.zeros((), dtype=rows.adjmat.dtype,
                            device=rows.adjmat.device)))
        return rows


def _check_carries(state: SimState, cfg, localization, checks) -> None:
    """The reference's ``localization``/``checks`` arguments name the
    state's carries; the port checks the state against them."""
    loc = (cfg.localization == "flooded") if localization is None \
        else localization
    chk = (cfg.check_mode == "on") if checks is None else checks
    if loc != (state.loc is not None) or chk != (state.inv is not None):
        raise ValueError(f"the state's carries (loc={state.loc is not None}"
                         f", inv={state.inv is not None}) do not match "
                         f"localization={loc}, checks={chk}")


def _tick(st: SimState, blk: _Block, gains, sparams, cfg, **phase):
    """One tick of this rank's rows (`sim.step` on the block; ``phase``:
    a batch's ``shared_tick`` and ``trial_ticks``): (local state,
    replicated metrics). The ranks outside the mesh take the replicated
    outputs from the mesh's first rank."""
    if blk.mesh.index is None:
        got = coll.spill(_spill_like(st, cfg), blk.mesh)
        new = replace(st, tick=st.tick + 1, **got["state"])
        return new, got["metrics"]
    new, m = _engine.step(st, blk.form, gains, sparams, cfg, block=blk,
                          **phase)
    coll.spill({"state": {"first_auction": new.first_auction,
                          "inv": new.inv, "tel": new.tel},
                "metrics": m}, blk.mesh)
    return new, m


def _spill_like(st: SimState, cfg) -> dict:
    """The structure and dtypes of what `_tick` spills, as a rank outside
    the mesh knows them (the shapes cross with the spill)."""
    dev = st.first_auction.device

    def like(dtype):
        return torch.empty(0, dtype=dtype, device=dev)

    flag = like(torch.bool)
    faults = st.faults is not None
    metrics = StepMetrics(
        distcmd_norm=like(st.swarm.q.dtype), ca_active=flag,
        assign_valid=flag, reassigned=flag, auctioned=flag,
        q=like(st.swarm.q.dtype), mode=like(st.flight.mode.dtype),
        v2f=like(st.v2f.dtype), alive=flag if faults else None,
        fault_event=flag if faults else None,
        scen_event=flag if st.scenario is not None else None,
        inv_code=like(torch.int32) if cfg.check_mode == "on" else None,
        tel=st.tel if cfg.telemetry == "on" else None)
    return {"state": {"first_auction": st.first_auction, "inv": st.inv,
                      "tel": st.tel}, "metrics": metrics}


def sharded_step_fn(mesh, formation_sharded, gains, sparams, cfg,
                    localization: bool | None = None,
                    checks: bool | None = None):
    """A one-tick function: this rank's local state -> (local state,
    replicated `StepMetrics`). ``formation_sharded`` is this rank's part
    of the formation (`mesh.shard_problem`)."""
    blk = _Block(mesh, formation_sharded)

    def step(state: SimState):
        _check_carries(state, cfg, localization, checks)
        blk.carry = None
        return _tick(state, blk, gains, sparams, cfg)

    return step


def sharded_rollout_fn(mesh, formation_sharded, gains, sparams, cfg,
                       n_ticks: int, localization: bool | None = None,
                       checks: bool | None = None):
    """A rollout of ``n_ticks`` ticks: this rank's local state -> (local
    final state, `StepMetrics` stacked over time, replicated). The whole
    positions and assignment a tick ends with start the next tick."""
    blk = _Block(mesh, formation_sharded)

    def roll(state: SimState):
        _check_carries(state, cfg, localization, checks)
        return _roll(state, blk, gains, sparams, cfg, n_ticks)

    return roll


def _roll(state: SimState, blk: _Block, gains, sparams, cfg, n_ticks: int,
          batched: bool = False):
    """``n_ticks`` ticks of this rank's rows; the whole positions and
    assignment a tick ends with start the next tick. A batch (``batched``)
    passes `sim.batched_rollout`'s phase with a first tick of 0: tick t is
    ``shared_tick`` t, and with faults, scenarios or checks each trial's
    own tick crosses to the device once, as its offset from t."""
    offset = None
    if batched and (state.faults is not None or state.scenario is not None
                    or cfg.check_mode == "on"):
        offset = torch.as_tensor(np.asarray(state.tick).astype(
            np.int32)).to(state.v2f.device)
    per_tick = []
    blk.carry = None
    for t in range(n_ticks):
        phase = {} if not batched else {
            "shared_tick": t,
            "trial_ticks": None if offset is None else offset + t}
        state, m = _tick(state, blk, gains, sparams, cfg, **phase)
        blk.carry = (m.q, m.v2f)
        per_tick.append(m)
    return state, _engine._stack_metrics(per_tick)


def batched_sim_state_sharding(mesh, localization: bool = False,
                               checks: bool = False) -> SimState:
    """Placement tree for a trial-batched `SimState` (leaves (B, ...)):
    the batch axis replicated, the agent axis as in
    `mesh.sim_state_sharding`."""
    return meshlib.batch_axis(meshlib.sim_state_sharding(
        mesh, localization=localization, checks=checks))


def batched_formation_sharding(mesh) -> Formation:
    """Placement tree for a (B, ...)-stacked `Formation`."""
    return meshlib.batch_axis(meshlib.formation_sharding(mesh))


def _check_phases(ticks, cfg) -> None:
    """The batched engine's rule: the trials share one decimation phase,
    so their ticks agree modulo the auction period and, flooded, the
    flood cadence."""
    t = np.asarray(ticks, dtype=np.int64)
    periods = ((("assign_every", cfg.assign_every),)
               if cfg.assignment != "none" else ()) + \
        ((("flood_every", cfg.flood_every),)
         if cfg.localization == "flooded" else ())
    for what, k in periods:
        if np.any((t - t[0]) % k):
            raise ValueError(f"the trials' ticks {t.tolist()} disagree "
                             f"modulo {what}={k}: a batch shares one "
                             "decimation phase")


def batched_rollout_fn(mesh, formation_batched, gains, sparams, cfg,
                       n_ticks: int, localization: bool | None = None,
                       checks: bool | None = None):
    """A rollout of a trial batch over the mesh, both axes in one program:
    this rank's part of a (B, ...)-batched state (`mesh.shard_problem`,
    or `place` with `batched_sim_state_sharding`) -> (its part of the
    final batched state, `StepMetrics` with leaves (n_ticks, B, ...),
    replicated). Each tick is one `sim.step` on the rank's rows of every
    trial; tick t's decimation phase is t and the fault and scenario masks
    key on each trial's own tick, as `sim.batched_rollout` has them, whose
    results these are bit for bit."""
    blk = _Block(mesh, formation_batched)

    def roll(state: SimState):
        _check_carries(state, cfg, localization, checks)
        _check_phases(state.tick, cfg)
        return _roll(state, blk, gains, sparams, cfg, n_ticks, batched=True)

    return roll

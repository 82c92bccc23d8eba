"""`torchcheck` layer 2: a dispatch audit of every public device-path entry
point of the port.

The AST lint (layer 1) reasons about source; this layer runs the code.
Every entry in `ENTRY_POINTS` is called three times with freshly built
float32 inputs (the build functions give every constructor an explicit dtype),
and the audit checks:

(a) **host syncs within budget** — on the card each call runs under
    ``torch.cuda.set_sync_debug_mode("warn")`` and its synchronizing
    calls (a device read, a blocking copy, a stream wait) are counted.
    The count is held at or below the entry's declared ``host_syncs``,
    and the registry gives the reason for every site: each is a poll of
    a data-dependent loop (the auction every 32 rounds, CBAA every 4,
    ADMM once per step and its Newton iteration every 4) or a host
    preparation the port makes on purpose. On the CPU there is no
    transfer to guard, so (a) is a card check (``chip_smoke.py``'s
    ``audit`` phase);
(b) **the second call changes nothing** — eager torch compiles nothing,
    so the counterpart of the reference's cache check is the ATen op
    stream: the second and third identical calls must dispatch the same
    ops in the same order (a `TorchDispatchMode` records them; the first
    call may fill the port's host caches, as a first call compiles). On
    the card they must also make the same K1/K2/K3 launch counts
    (`ops.LAUNCHES`);
(c) **no float64 leaf** in any output from float32 inputs.

Registering a new entry point:

    from aclswarm_torch.analysis import trace_audit

    def _build_my_entry(gp, dev):    # gp: GridPoint, dev: torch.device
        args = (...)                 # fresh tensors, explicit dtypes
        kwargs = {"cfg": ...}
        return args, kwargs

    trace_audit.register_entry(
        "mymod.my_fn", my_fn, build=_build_my_entry, host_syncs=0,
        syncs_why="none: every loop runs on the device")

The function itself carries ``# torchcheck: device-path`` on its ``def``
line (`tests/test_torch_lint.py` holds every registered function to it).
The build function must return *fresh* tensors each call (the staging ops write
their store in place) and every grid point it supports; raise `Skip` for
unsupported combinations.

Zero-cost-off proof: `aten_baseline.json` holds, for every baseline entry
and grid key (``check_mode='off'``, no invariant or counter carry), the
SHA-256 digest of the ATen op stream one call dispatches on the CPU and
the op count, with the torch version it was written under.
`verify_zero_cost_off` re-records them and asserts equality: the checks
and counters add no operation when they are off. An intended change to
the op stream regenerates it with ``python -m
aclswarm_torch.analysis.trace_audit --write-aten-baseline`` (a reviewable
artifact diff).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import warnings
from functools import partial
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "GridPoint", "AuditReport", "Skip", "EntryPoint", "ENTRY_POINTS",
    "register_entry", "audit_entry", "audit_all", "iter_grid", "f32_mode",
    "leaf_dtypes", "op_stream", "count_syncs", "grid_key",
    "verify_zero_cost_off",
    "write_aten_baseline", "ATEN_BASELINE_PATH", "TICK_SYNCS",
    "tick_budget",
]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GridPoint:
    """One cell of the audit grid."""

    n: int = 5            # fleet size
    B: int = 2            # trial-batch width (batched entries)
    solver: str = "auction"       # 'auction' | 'sinkhorn' | 'cbaa'
    faults: bool = False          # attach a FaultSchedule
    localization: str = "truth"   # 'truth' | 'flooded'


class Skip(Exception):
    """Raised by a build function for an unsupported grid combination."""


@dataclasses.dataclass
class EntryPoint:
    name: str
    fn: Callable
    build: Callable[[GridPoint, torch.device], tuple]
    # which grid axes this entry actually varies over (grid dedup)
    axes: tuple = ("n",)
    # participates in the zero-cost-off op baseline (False for the
    # [checked]/[telemetry] variants — those are *expected* to differ)
    baseline: bool = True
    # synchronizing calls one call may make on the card (an int, or a
    # function of the grid point), and why
    host_syncs: int | Callable[[GridPoint], int] = 0
    syncs_why: str = ""

    def budget(self, gp: GridPoint) -> int:
        """The synchronizing calls one call may make at ``gp``."""
        return self.host_syncs(gp) if callable(self.host_syncs) \
            else self.host_syncs


@dataclasses.dataclass
class AuditReport:
    name: str
    grid: GridPoint
    out_dtypes: tuple
    f64_leaves: tuple          # offending output dtypes, must be empty
    n_ops: int                 # ATen ops of one call
    op_digest: str             # SHA-256 of that op stream
    changed: bool              # the two identical calls dispatched differently
    launches: tuple = ()       # per recorded call: {kernel: launches}
    syncs: tuple = ()          # per recorded call: synchronizing calls
    sync_sites: dict = dataclasses.field(default_factory=dict)
    #                            the last call's syncs by source line

    @property
    def launches_changed(self) -> bool:
        return len(self.launches) == 2 and self.launches[0] != self.launches[1]

    @property
    def ok(self) -> bool:
        return not (self.f64_leaves or self.changed or self.launches_changed)


ENTRY_POINTS: list[EntryPoint] = []


def register_entry(name: str, fn: Callable, *, build: Callable,
                   axes: tuple = ("n",), baseline: bool = True,
                   host_syncs: int | Callable = 0,
                   syncs_why: str = "") -> None:
    ENTRY_POINTS.append(EntryPoint(name=name, fn=fn, build=build,
                                   axes=tuple(axes), baseline=baseline,
                                   host_syncs=host_syncs,
                                   syncs_why=syncs_why))


@contextlib.contextmanager
def f32_mode():
    """Run the audit at deployment precision whatever the caller's default
    dtype (the build functions pass float32 explicitly; this pins what a
    dtype-less constructor would take)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(F32)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


# ---------------------------------------------------------------------------
# input build functions (fresh, float32-explicit, on the audit's device)

def _ring(n: int) -> np.ndarray:
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([3.0 * np.cos(ang), 3.0 * np.sin(ang),
                     np.full(n, 2.0)], 1).astype(np.float32)


def _scatter(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    q[:, 2] = 2.0
    return q


def _formation(n: int, dev):
    from aclswarm_torch.core.types import make_formation
    adj = (np.ones((n, n)) - np.eye(n)).astype(np.float32)
    gains = (np.eye(n, dtype=np.float32)[:, :, None, None]
             * np.eye(3, dtype=np.float32)[None, None] * 0.01)
    return make_formation(_ring(n), adj, gains, device=dev, dtype=F32)


def _sparams():
    from aclswarm_torch.core.types import SafetyParams
    return SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                        bounds_max=(50.0, 50.0, 10.0))


def _sim_cfg(gp: GridPoint, **kw):
    from aclswarm_torch import sim
    return sim.SimConfig(assignment=gp.solver, assign_every=2,
                         localization=gp.localization, flood_every=2,
                         flight_fsm=False, **kw)


def _faults(gp: GridPoint, dev, seed: int = 0):
    if not gp.faults:
        return None
    from aclswarm_torch.faults import schedule as faultlib
    return faultlib.sample_schedule(
        seed, gp.n, dropout_frac=0.25, drop_tick=1, rejoin_tick=3,
        link_loss=0.1, device=dev, dtype=F32)


def _scenario(gp: GridPoint, dev, seed: int = 0):
    """A kitchen-sink registry draw: every axis scripted, so the audited
    scenario program is the fully-general one."""
    from aclswarm_torch.scenarios import sample
    return sample("kitchen_sink", seed, gp.n, horizon=_TICKS, device=dev,
                  dtype=F32)


def _sim_state(gp: GridPoint, dev, seed: int = 0, checks: bool = False,
               telemetry: bool = False, scen: bool = False):
    from aclswarm_torch import sim
    return sim.init_state(_scatter(gp.n, seed),
                          localization=(gp.localization == "flooded"),
                          faults=_faults(gp, dev, seed), checks=checks,
                          telemetry=telemetry,
                          scenario=_scenario(gp, dev, seed) if scen else None,
                          device=dev, dtype=F32)


_TICKS = 4


def _modes(check: bool, tel: bool) -> dict:
    return {"check_mode": "on" if check else "off",
            "telemetry": "on" if tel else "off"}


def _build_rollout(gp: GridPoint, dev, check: bool = False,
                   tel: bool = False, scen: bool = False):
    from aclswarm_torch.core.types import ControlGains
    args = (_sim_state(gp, dev, checks=check, telemetry=tel, scen=scen),
            _formation(gp.n, dev), ControlGains(), _sparams())
    return args, {"cfg": _sim_cfg(gp, **_modes(check, tel)),
                  "n_ticks": _TICKS}


def _build_batched_rollout(gp: GridPoint, dev, check: bool = False,
                           tel: bool = False, scen: bool = False):
    from aclswarm_torch import sim
    from aclswarm_torch.core import types
    from aclswarm_torch.core.types import ControlGains
    state = sim.stack_states([
        _sim_state(gp, dev, seed=b, checks=check, telemetry=tel, scen=scen)
        for b in range(gp.B)])
    form = types.stack([_formation(gp.n, dev) for _ in range(gp.B)])
    args = (state, form, ControlGains(), _sparams())
    return args, {"cfg": _sim_cfg(gp, **_modes(check, tel)),
                  "n_ticks": _TICKS}


def _build_rollout_summary(gp: GridPoint, dev, check: bool = False,
                           tel: bool = False, scen: bool = False):
    from aclswarm_torch.sim import summary
    args, kwargs = _build_batched_rollout(gp, dev, check=check, tel=tel,
                                          scen=scen)
    carry = summary.init_carry(gp.n, window=3, dtype=F32, device=dev,
                               batch=gp.B)
    kwargs.update(window=3, pose_every=0, takeoff_alt=1.0)
    return (args[0], carry) + args[1:], kwargs


def _aligned_pair(gp: GridPoint):
    q = _scatter(gp.n)
    rng = np.random.default_rng(1)
    return q, _ring(gp.n)[rng.permutation(gp.n)]


def _t(x, dev, dtype=F32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=dev,
                                                        dtype=dtype)


def _build_auction(gp: GridPoint, dev):
    q, p = _aligned_pair(gp)
    c = np.linalg.norm(q[:, None] - p[None], axis=-1).astype(np.float32)
    return (_t(-c, dev),), {}


def _build_sinkhorn(gp: GridPoint, dev):
    q, p = _aligned_pair(gp)
    return (_t(q, dev), _t(p, dev)), {}


def _build_cbaa(gp: GridPoint, dev):
    q, p = _aligned_pair(gp)
    adj = (np.ones((gp.n, gp.n)) - np.eye(gp.n)).astype(np.float32)
    v2f = torch.arange(gp.n, dtype=torch.int32, device=dev)
    return (_t(q, dev), _t(p, dev), _t(adj, dev), v2f), {}


def _build_cbaa_warm(gp: GridPoint, dev):
    from aclswarm_torch.assignment.cbaa import init_tables
    args, _ = _build_cbaa(gp, dev)
    return args, {"warm": init_tables(gp.n, dev, F32)}


def _admm_graph(n: int) -> np.ndarray:
    """Ring + chords: rigid enough, and non-edges exist."""
    adj = np.zeros((n, n), bool)
    for k in (1, 2):
        adj |= np.eye(n, k=k, dtype=bool) | np.eye(n, k=-k, dtype=bool)
        adj |= np.eye(n, k=n - k, dtype=bool) | np.eye(n, k=k - n,
                                                       dtype=bool)
    return adj.astype(np.float32)


def _build_admm(gp: GridPoint, dev):
    # host points and graph, as a caller hands them over: the port's
    # host half (non-edge buckets, the kernel basis) runs inside the call.
    # The port takes planarity from the points, so the ring's heights
    # vary: the non-planar design the reference audits (planar=False)
    from aclswarm_torch.gains.params import AdmmParams
    pts = _ring(gp.n)
    pts[:, 2] += np.linspace(-0.5, 0.5, gp.n, dtype=np.float32)
    return (pts, _admm_graph(gp.n)), {"params": AdmmParams(),
                                      "device": dev}


def _build_admm_warm(gp: GridPoint, dev):
    # seeded with the COLD carry, whose warm solve equals the cold one
    from aclswarm_torch.gains.admm import init_carry
    args, kw = _build_admm(gp, dev)
    return args, dict(kw, carry=init_carry(gp.n, planar=False, dtype=F32,
                                           device=dev))


def _build_admm_batch(gp: GridPoint, dev, B: int = 2):
    # the serial build function's formation stacked B times
    args, kw = _build_admm(gp, dev)
    return tuple(np.stack([a] * B) for a in args), kw


def _build_planner_tick(gp: GridPoint, dev):
    from aclswarm_torch import sim
    from aclswarm_torch.core.types import ControlGains, SwarmState
    if gp.solver == "sinkhorn":
        raise Skip("planner tick serves auction/cbaa (its wire modes)")
    q = _t(_scatter(gp.n), dev)
    swarm = SwarmState(q=q, vel=torch.zeros_like(q))
    v2f = torch.arange(gp.n, dtype=torch.int32, device=dev)
    cfg = sim.SimConfig(assignment=gp.solver, assign_every=2)
    args = (swarm, _formation(gp.n, dev), v2f, ControlGains(), _sparams(),
            True, torch.ones((), dtype=torch.bool, device=dev))
    kwargs = {"cfg": cfg}
    if gp.localization == "flooded":
        kwargs["est"] = q[None].expand(gp.n, gp.n, 3).clone()
    return args, kwargs


# ---- serve.staging build functions ----
#
# The staging ops are audited over the exact tree the serving layer
# stages — a SimState row (always carrying a no-fault schedule, serve's
# bucket convention) paired with its Formation — at a fixed 4-row store
# capacity (capacity only scales leading axes).

_STAGING_CAP = 4


def _serve_row(gp: GridPoint, dev, scen: bool = False):
    from aclswarm_torch import sim
    from aclswarm_torch.faults import schedule as faultlib
    state = sim.init_state(
        _scatter(gp.n), faults=faultlib.no_faults(gp.n, dev, F32),
        scenario=_scenario(gp, dev) if scen else None, device=dev,
        dtype=F32)
    return state, _formation(gp.n, dev)


def _staging_store(gp: GridPoint, dev, scen: bool = False):
    from aclswarm_torch import sim
    from aclswarm_torch.core import types
    st, fm = _serve_row(gp, dev, scen=scen)
    return (sim.stack_states([st] * _STAGING_CAP),
            types.stack([fm] * _STAGING_CAP))


def _build_staging_write(gp: GridPoint, dev, scen: bool = False):
    return (_staging_store(gp, dev, scen=scen),
            _serve_row(gp, dev, scen=scen), 1), {}


def _build_staging_gather(gp: GridPoint, dev):
    return (_staging_store(gp, dev), (0, 1, 2, 0)), {}


def _build_staging_scatter(gp: GridPoint, dev):
    from aclswarm_torch import sim
    state_store = _staging_store(gp, dev)[0]
    row = _serve_row(gp, dev)[0]
    return (state_store, sim.stack_states([row, row]), [0, 1], [0, 1]), {}


def _build_staging_take(gp: GridPoint, dev):
    return (_staging_store(gp, dev), 2), {}


def _build_staging_unpack(gp: GridPoint, dev):
    return (torch.zeros((4, 2, gp.n, 3), dtype=F32, device=dev),
            torch.zeros((2, gp.n, 3), dtype=F32, device=dev)), {}


def _build_staging_init(gp: GridPoint, dev, scen: bool = False):
    from aclswarm_torch.faults import schedule as faultlib
    return (_t(_scatter(gp.n), dev), faultlib.no_faults(gp.n, dev, F32),
            _scenario(gp, dev) if scen else None), {}


# ---------------------------------------------------------------------------
# the registry
#
# ``host_syncs`` bounds one call on the card at the tier-1 grid (n=5,
# B=2, 4 ticks, an auction tick every 2). Every site below was found by
# the card audit itself, which attributes each synchronizing call to the
# source line that made it (`chip_smoke.py --phases audit`, H100):
#
# - `control.safety.host_row`: each element write of a host value into
#   a card tensor (``row[k] = v``) is a blocking host-to-device copy;
#   a tick builds 3 rows of 3 (9 syncs), and 6 more with the checks on;
# - `sim.localization` (flooded): the own-entry age write, ``age[...,
#   d, d] = 0``, 1 per tick;
# - the auction: each bidding round's owner scatter
#   (`_owners_assigned`, ``hit[owner] = True``), 1 per round, plus its
#   poll once per 32 rounds (`POLL_EVERY`); n=5 auctions run <= 64
#   rounds;
# - CBAA: its poll once per 4 consensus rounds and the reference
#   agent's row read (``who[ref]``), plus the warm start's kept-agent
#   scatter;
# - an ADMM solve: the host half's copies of the problem to the card
#   (6), the hermitian pseudo-inverse (2), one read of the stop flags
#   per ADMM step and one of the Newton-Schulz stall flag per 4 Newton
#   steps;
# - a batched rollout with faults, scenarios or checks: its trials'
#   tick offsets copied to the card once per call.
#
# TICK_SYNCS is the rollout's budget per tick (`sim.engine.rollout`):
# every tick, the flooded and the checked extras, and an auction tick by
# solver. chip_smoke's audit phase holds the n=1000 `simform1000_flooded`
# rollout to it, tick by tick.

TICK_SYNCS = {"tick": 9, "flooded": 1, "checked": 6,
              "auction": {"sinkhorn": 0, "auction": 80, "cbaa": 4},
              "batch_offsets": 1}

_ROLL_AXES = ("n", "solver", "faults", "localization")
_BATCH_AXES = ("n", "B", "solver", "faults", "localization")
_ROLL_WHY = ("TICK_SYNCS: per tick `control.safety.host_row`'s element "
             "writes (+ the flooded age write, + the checks' rows); per "
             "auction tick (ticks 0 and 2) the solver's")
_BATCH_WHY = _ROLL_WHY + ("; a batch runs its auctions trial by trial "
                          "and copies its tick offsets once per call")


def tick_budget(localization: str, checked: bool = False,
                solver: str | None = None) -> int:
    """The synchronizing calls one tick of a serial rollout may make:
    an ordinary tick, or with ``solver`` an auction tick of that
    solver."""
    return (TICK_SYNCS["tick"]
            + TICK_SYNCS["flooded"] * (localization == "flooded")
            + TICK_SYNCS["checked"] * checked
            + (TICK_SYNCS["auction"][solver] if solver else 0))


def _rollout_budget(gp: GridPoint, batched: bool = False,
                    checked: bool = False) -> int:
    """`TICK_SYNCS` over the audit's rollout: every tick, and the
    auction ticks (0 and 2 at assign_every=2), once per trial."""
    auctions = len(range(0, _TICKS, 2)) * (gp.B if batched else 1)
    return (tick_budget(gp.localization, checked) * _TICKS
            + TICK_SYNCS["auction"][gp.solver] * auctions
            + TICK_SYNCS["batch_offsets"] * batched)


def _planner_budget(gp: GridPoint) -> int:
    """One auction, no safety rows (the planner saturates on the host's
    parameters without building them on the card)."""
    return TICK_SYNCS["auction"][gp.solver]


def _install_default_registry() -> None:
    """Every public device-path entry point of the port."""
    from aclswarm_torch.assignment import auction, cbaa, sinkhorn
    from aclswarm_torch.gains import admm
    from aclswarm_torch.interop import planner
    from aclswarm_torch.serve import staging as serve_staging
    from aclswarm_torch.sim import engine, summary

    roll = dict(axes=_ROLL_AXES, host_syncs=_rollout_budget,
                syncs_why=_ROLL_WHY)
    batch = dict(axes=_BATCH_AXES, host_syncs=partial(_rollout_budget,
                                                      batched=True),
                 syncs_why=_BATCH_WHY)
    roll_checked = dict(roll, host_syncs=partial(_rollout_budget,
                                                 checked=True))
    batch_checked = dict(batch, host_syncs=partial(
        _rollout_budget, batched=True, checked=True))
    register_entry("sim.engine.rollout", engine.rollout,
                   build=_build_rollout, **roll)
    register_entry("sim.engine.batched_rollout", engine.batched_rollout,
                   build=_build_batched_rollout, **batch)
    register_entry("sim.summary.batched_rollout_summary",
                   summary.batched_rollout_summary,
                   build=_build_rollout_summary, **batch)
    register_entry("assignment.auction.auction_lap", auction.auction_lap,
                   build=_build_auction,
                   host_syncs=TICK_SYNCS["auction"]["auction"],
                   syncs_why="one owner scatter per bidding round and "
                   "one poll per 32 rounds")
    register_entry("assignment.sinkhorn.sinkhorn_assign",
                   sinkhorn.sinkhorn_assign, build=_build_sinkhorn,
                   host_syncs=0, syncs_why="none: K1 and K2 on the card")
    register_entry("assignment.cbaa.cbaa_from_state", cbaa.cbaa_from_state,
                   build=_build_cbaa,
                   host_syncs=TICK_SYNCS["auction"]["cbaa"],
                   syncs_why="one poll per 4 consensus rounds and the "
                   "reference agent's row read")
    admm_why = ("the host half's 6 copies of the problem to the card, "
                "the pseudo-inverse's 2, one read of the stop flags per "
                "ADMM step and one of the stall flag per 4 Newton steps")
    register_entry("gains.admm.solve", admm.solve_gains, build=_build_admm,
                   host_syncs=64, syncs_why=admm_why)
    # warm-pipeline variants: the carry-threaded ADMM re-seed, the batch
    # designer, and the table-seeded CBAA re-auction
    register_entry("gains.admm.solve[warm]", admm.solve_gains,
                   build=_build_admm_warm, host_syncs=64,
                   syncs_why=admm_why)
    register_entry("gains.admm.solve_batch", admm.solve_gains_batch,
                   build=_build_admm_batch, host_syncs=64,
                   syncs_why=admm_why)
    register_entry("assignment.cbaa.cbaa_from_state[warm]",
                   cbaa.cbaa_from_state, build=_build_cbaa_warm,
                   host_syncs=TICK_SYNCS["auction"]["cbaa"],
                   syncs_why="one poll per 4 consensus rounds, the "
                   "reference agent's row read and the warm start's "
                   "kept-agent scatter")
    register_entry("interop.planner.tick", planner._tick,
                   build=_build_planner_tick,
                   axes=("n", "solver", "localization"),
                   host_syncs=_planner_budget,
                   syncs_why="one auction: the auction's or CBAA's")
    # serve.staging: the staging-store ops and the batched unpack behind
    # the device-bound serve round
    staging_why = ("none after the first call: the slot indices are "
                   "cached on the card")
    register_entry("serve.staging.write_row", serve_staging.write_row,
                   build=_build_staging_write, host_syncs=0,
                   syncs_why=staging_why)
    register_entry("serve.staging.gather_rows", serve_staging.gather_rows,
                   build=_build_staging_gather, host_syncs=0,
                   syncs_why=staging_why)
    register_entry("serve.staging.scatter_rows", serve_staging.scatter_rows,
                   build=_build_staging_scatter, host_syncs=0,
                   syncs_why=staging_why)
    register_entry("serve.staging.take_row", serve_staging.take_row,
                   build=_build_staging_take, host_syncs=0,
                   syncs_why=staging_why)
    register_entry("serve.staging.unpack_round", serve_staging.unpack_round,
                   build=_build_staging_unpack, host_syncs=0,
                   syncs_why="none: a non-blocking copy ended by an event")
    register_entry("serve.staging.init_row", serve_staging.init_row,
                   build=_build_staging_init, host_syncs=0,
                   syncs_why="none: the state's constants are fills")
    # scenario-carrying variants
    register_entry("sim.engine.rollout[scenario]", engine.rollout,
                   build=partial(_build_rollout, scen=True), **roll)
    register_entry("sim.engine.batched_rollout[scenario]",
                   engine.batched_rollout,
                   build=partial(_build_batched_rollout, scen=True),
                   **batch)
    register_entry("sim.summary.batched_rollout_summary[scenario]",
                   summary.batched_rollout_summary,
                   build=partial(_build_rollout_summary, scen=True),
                   **batch)
    register_entry("serve.staging.write_row[scenario]",
                   serve_staging.write_row,
                   build=partial(_build_staging_write, scen=True),
                   host_syncs=0, syncs_why=staging_why)
    register_entry("serve.staging.init_row[scenario]",
                   serve_staging.init_row,
                   build=partial(_build_staging_init, scen=True),
                   host_syncs=0,
                   syncs_why="none: the state's constants are fills")
    # the sanitizer and the device counters on: excluded from the
    # zero-cost baseline (they differ from it by construction)
    register_entry("sim.engine.rollout[checked]", engine.rollout,
                   build=partial(_build_rollout, check=True),
                   baseline=False, **roll_checked)
    register_entry("sim.summary.batched_rollout_summary[checked]",
                   summary.batched_rollout_summary,
                   build=partial(_build_rollout_summary, check=True),
                   baseline=False, **batch_checked)
    register_entry("sim.engine.rollout[scenario,checked]", engine.rollout,
                   build=partial(_build_rollout, check=True, scen=True),
                   baseline=False, **roll_checked)
    register_entry("sim.engine.rollout[telemetry]", engine.rollout,
                   build=partial(_build_rollout, tel=True),
                   baseline=False, **roll)
    register_entry("sim.summary.batched_rollout_summary[telemetry]",
                   summary.batched_rollout_summary,
                   build=partial(_build_rollout_summary, tel=True),
                   baseline=False, **batch)


_install_default_registry()


# ---------------------------------------------------------------------------
# the audit

class _OpStream(TorchDispatchMode):
    """Records the name of every ATen op dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def op_stream(fn, *args, **kwargs) -> tuple[list[str], object]:
    """(ATen op names in dispatch order, result) of one call."""
    with _OpStream() as rec:
        out = fn(*args, **kwargs)
    return [str(op) for op in rec.ops], out


def _digest(ops: list[str]) -> str:
    return hashlib.sha256("\n".join(ops).encode()).hexdigest()


# the reference's field order where the port's differs (a dataclass puts
# its defaulted fields last)
_REFERENCE_FIELDS = {
    "SimState": ("swarm", "goal", "v2f", "tick", "flight", "loc",
                 "first_auction", "assign_enabled", "faults", "scenario",
                 "inv", "tel", "cbaa_warm"),
}


def _leaf_items(tree, path: str = ""):
    """(path, leaf) pairs in the reference's leaf order: dataclass fields
    and tuple items in order, mapping keys sorted, None skipped."""
    from aclswarm_torch.serve.staging import HostRead
    if tree is None:
        return
    if isinstance(tree, HostRead):
        # the chunk's positions and the final ones share one host buffer
        for name in ("q_chunks", "q_final"):
            yield f"{path}.{name}", tree._host
    elif isinstance(tree, (torch.Tensor, np.ndarray, np.generic, bool, int,
                           float)):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        names = _REFERENCE_FIELDS.get(type(tree).__name__) or [
            f.name for f in dataclasses.fields(tree)]
        for name in names:
            yield from _leaf_items(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_items(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None)
        for i, x in enumerate(tree):
            yield from _leaf_items(
                x, f"{path}.{names[i]}" if names else f"{path}[{i}]")
    else:
        raise TypeError(f"unexpected output leaf {type(tree)} at {path}")


def _dtype_name(path: str, x) -> str:
    """A leaf's dtype under the reference's name. The port holds a few
    leaves otherwise by design, as `convert.sim_state_to_numpy` maps
    them: the tick is host data (a Python int, a batch's int64 array)
    where the reference has an int32 array, and the key words of fault
    schedules and scenarios are int64 where the reference's are uint32."""
    leaf = path.rsplit(".", 1)[-1]
    if leaf == "tick" and not isinstance(x, torch.Tensor):
        return "int32"
    if leaf == "key" and isinstance(x, torch.Tensor) \
            and x.dtype == torch.int64:
        return "uint32"
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    if isinstance(x, (np.ndarray, np.generic)):
        return str(x.dtype)
    return {bool: "bool", int: "int64", float: "float64"}[type(x)]


def leaf_dtypes(tree) -> tuple[str, ...]:
    """Output leaf dtypes in the reference's leaf order and names."""
    return tuple(_dtype_name(p, x) for p, x in _leaf_items(tree))


_BAD_DTYPES = ("float64", "complex128")


def _site(filename: str, lineno: int) -> str:
    """A source line, relative to the package when it is the port's."""
    path = Path(filename)
    parts = path.parts
    if "aclswarm_torch" in parts:
        path = Path(*parts[parts.index("aclswarm_torch"):])
    return f"{path.as_posix()}:{lineno}"


@contextlib.contextmanager
def count_syncs(dev: torch.device, counts: list,
                sites: dict | None = None):
    """Count the synchronizing CUDA calls made inside (appended to
    ``counts``), and in ``sites`` by the source line that made each; on
    the CPU there is nothing to count."""
    if dev.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(old)
    hits = [w for w in caught if "synchronizing" in str(w.message)]
    counts.append(len(hits))
    if sites is not None:
        for w in hits:
            key = _site(w.filename, w.lineno)
            sites[key] = sites.get(key, 0) + 1


def _launches() -> dict:
    from aclswarm_torch import ops
    return dict(ops.LAUNCHES)


def audit_entry(entry: EntryPoint, gp: GridPoint,
                device=None) -> AuditReport:
    """Run checks (a)-(c) for one entry at one grid point on ``device``
    (None = the card; the CPU only when asked for).

    Returns a report whose ``.ok`` captures (b) and (c); ``syncs`` holds
    each recorded call's synchronizing calls on the card (empty on the
    CPU), which the caller holds to ``entry.budget(gp)``.
    """
    from aclswarm_torch.core.types import resolve_device

    dev = resolve_device(device)
    with f32_mode():
        # a first call fills the host caches (the counterpart of a first
        # compile); inputs are built outside every recorded window
        args, kwargs = entry.build(gp, dev)
        entry.fn(*args, **kwargs)
        streams, launches, syncs = [], [], []
        for _ in range(2):
            args, kwargs = entry.build(gp, dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            before = _launches()
            sites: dict = {}
            with count_syncs(dev, syncs, sites):
                ops, out = op_stream(entry.fn, *args, **kwargs)
            if dev.type == "cuda":
                torch.cuda.synchronize()
                after = _launches()
                launches.append({k: after[k] - before.get(k, 0)
                                 for k in after})
            streams.append(ops)
        dtypes = leaf_dtypes(out)
    return AuditReport(
        name=entry.name, grid=gp, out_dtypes=dtypes,
        f64_leaves=tuple(d for d in dtypes if d in _BAD_DTYPES),
        n_ops=len(streams[1]), op_digest=_digest(streams[1]),
        changed=streams[0] != streams[1], launches=tuple(launches),
        syncs=tuple(syncs), sync_sites=sites)


def iter_grid(slow: bool = False) -> Iterable[GridPoint]:
    """Tier-1 keeps the grid small (n=5, B=2: one fault-free truth-model
    point per solver plus the faulted/flooded stack); ``slow=True``
    crosses the axes at n=16/B=4 as well."""
    yield GridPoint(n=5, B=2, solver="auction")
    yield GridPoint(n=5, B=2, solver="sinkhorn", faults=True)
    yield GridPoint(n=5, B=2, solver="cbaa", faults=True,
                    localization="flooded")
    if slow:
        for solver in ("auction", "sinkhorn", "cbaa"):
            for faults in (False, True):
                for loc in ("truth", "flooded"):
                    yield GridPoint(n=16, B=4, solver=solver,
                                    faults=faults, localization=loc)


def grid_points(entry: EntryPoint, slow: bool = False):
    """The grid points an entry varies over (deduplicated by its axes)."""
    seen = set()
    for gp in iter_grid(slow):
        key = tuple(getattr(gp, a) for a in entry.axes)
        if key not in seen:
            seen.add(key)
            yield gp


def audit_all(slow: bool = False, device=None) -> list[AuditReport]:
    """Audit every registered entry across the grid."""
    reports: list[AuditReport] = []
    for entry in ENTRY_POINTS:
        for gp in grid_points(entry, slow):
            try:
                reports.append(audit_entry(entry, gp, device))
            except Skip:
                continue
    return reports


# ---------------------------------------------------------------------------
# zero-cost-off proof

ATEN_BASELINE_PATH = Path(__file__).resolve().parent / "aten_baseline.json"


def grid_key(entry: EntryPoint, gp: GridPoint) -> str:
    """Stable baseline key: entry name + the axes it varies over."""
    return f"{entry.name}|" + ",".join(
        f"{a}={getattr(gp, a)}" for a in entry.axes)


def entry_ops(entry: EntryPoint, gp: GridPoint) -> list[str]:
    """The ATen op stream of one steady-state call on the CPU (the
    baseline is a CPU capture: the card's kernels are no ATen ops)."""
    with f32_mode():
        args, kwargs = entry.build(gp, torch.device("cpu"))
        entry.fn(*args, **kwargs)
        args, kwargs = entry.build(gp, torch.device("cpu"))
        return op_stream(entry.fn, *args, **kwargs)[0]


def _iter_baseline_cells(slow: bool = False):
    """(entry, gp, key) for every baseline-participating grid cell."""
    for entry in ENTRY_POINTS:
        if entry.baseline:
            for gp in grid_points(entry, slow):
                yield entry, gp, grid_key(entry, gp)


def verify_zero_cost_off(slow: bool = False) -> dict:
    """Check that ``check_mode='off'`` is free: every baseline entry's op
    stream must equal the committed capture.

    Returns ``{"skipped": reason | None, "checked": int,
    "mismatches": [key, ...], "uncovered": [key, ...],
    "unverified": [key, ...]}`` — ``skipped`` is set (and nothing
    compared) when the baseline was written under another torch version
    (op names and decompositions are version-specific); ``uncovered``
    lists committed digests no registered entry produced, and
    ``unverified`` lists tier-1 cells with NO committed digest (a newly
    registered entry point is not proven until the baseline is
    regenerated).
    """
    def skip(reason):
        return {"skipped": reason, "checked": 0, "mismatches": [],
                "uncovered": [], "unverified": []}

    if not ATEN_BASELINE_PATH.exists():
        return skip(f"no baseline at {ATEN_BASELINE_PATH}")
    base = json.loads(ATEN_BASELINE_PATH.read_text())
    if base.get("torch_version") != torch.__version__:
        return skip(f"baseline written under torch "
                    f"{base.get('torch_version')}, running "
                    f"{torch.__version__} (op streams are version-specific;"
                    " regenerate with --write-aten-baseline)")
    cells = base["cells"]
    mismatches, covered, unverified = [], set(), []
    tier1 = {k for _, _, k in _iter_baseline_cells(False)}
    for entry, gp, key in _iter_baseline_cells(slow):
        if key not in cells:
            # a build function that does not support the cell has no digest
            # either; anything else is unproven
            try:
                with f32_mode():
                    entry.build(gp, torch.device("cpu"))
            except Skip:
                continue
            if key in tier1:
                unverified.append(key)
            continue
        try:
            ops = entry_ops(entry, gp)
        except Skip:
            # a committed digest whose build function now skips must surface as
            # `uncovered`, so coverage is marked only after a recording
            continue
        covered.add(key)
        if (_digest(ops), len(ops)) != (cells[key]["digest"],
                                        cells[key]["ops"]):
            mismatches.append(key)
    return {"skipped": None, "checked": len(covered),
            "mismatches": mismatches,
            "uncovered": sorted(set(cells) - covered),
            "unverified": sorted(unverified)}


def write_aten_baseline(slow: bool = False) -> int:
    """(Re)capture the zero-cost-off baseline from the current tree.

    Only when the op stream changed on purpose: the committed JSON diff
    is the review artifact that says so."""
    cells = {}
    for entry, gp, key in _iter_baseline_cells(slow):
        try:
            ops = entry_ops(entry, gp)
        except Skip:
            continue
        cells[key] = {"digest": _digest(ops), "ops": len(ops)}
    ATEN_BASELINE_PATH.write_text(json.dumps(
        {"torch_version": torch.__version__, "device": "cpu",
         "cells": cells}, indent=1, sort_keys=True) + "\n")
    return len(cells)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.analysis.trace_audit",
        description="torchcheck layer 2: dispatch audit of every "
        "device-path entry point + the zero-cost-off proof")
    ap.add_argument("--slow", action="store_true",
                    help="cross the full n=16/B=4 grid")
    ap.add_argument("--device", default=None,
                    help="where to run the audit (default: the card, where "
                    "host syncs are counted against each entry's budget; "
                    "cpu: the op streams and dtypes only)")
    ap.add_argument("--write-aten-baseline", action="store_true",
                    help="recapture aten_baseline.json from the current "
                    "tree (ONLY when the op stream changed on purpose; "
                    "the JSON diff is the review artifact)")
    ap.add_argument("--skip-baseline", action="store_true",
                    help="audit only; skip the zero-cost-off comparison")
    args = ap.parse_args(argv)

    if args.write_aten_baseline:
        n = write_aten_baseline(slow=args.slow)
        print(f"wrote {n} op-stream digests to {ATEN_BASELINE_PATH}")
        return 0

    ok = True
    entries = {e.name: e for e in ENTRY_POINTS}
    for r in audit_all(slow=args.slow, device=args.device):
        within = all(s <= entries[r.name].budget(r.grid) for s in r.syncs)
        status = "ok" if r.ok and within else "FAIL"
        print(f"{status:4s} {r.name} {r.grid} ops={r.n_ops} "
              f"changed={r.changed} syncs={list(r.syncs)} "
              f"f64={list(r.f64_leaves)}")
        ok &= status == "ok"

    if not args.skip_baseline:
        z = verify_zero_cost_off(slow=args.slow)
        if z["skipped"]:
            print(f"zero-cost-off: SKIPPED ({z['skipped']})")
        else:
            status = "ok" if not (z["mismatches"] or z["uncovered"]
                                  or z["unverified"]) else "FAIL"
            print(f"{status:4s} zero-cost-off: {z['checked']} entry cells "
                  f"match the baseline; mismatches={z['mismatches']} "
                  f"uncovered={z['uncovered']} "
                  f"unverified={z['unverified']}")
            ok &= status == "ok"
    return 0 if ok else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""Invariant sanitizer of the rollout (port of
`aclswarm_tpu/analysis/invariants.py`).

A registry of the algebraic invariants the system states — the
assignment is a permutation, Sinkhorn marginals within tolerance, the
adjacency symmetric, fault masks consistent with the `FaultSchedule`,
poses finite and in bounds after the safety shim, ADMM residuals driven
down — checked inside `sim.step` when ``SimConfig.check_mode='on'``.

- **Errors are data, not control flow.** A violation is recorded into an
  `InvariantState` carry (``code`` and ``tick``, ([B,]) int32 tensors)
  threaded through the rollout: the first violation wins, later ones never
  overwrite it, each trial of a batch on its own row. The per-tick code
  rides the copies the trial drivers already make per chunk, and the host
  decodes it (`first_violation`): no extra device-to-host copy.
- **Off is free.** Every check site in `sim.step` is gated in Python on
  the static mode: ``'off'`` adds no tensor operation.
- **Checkers are independent oracles.** A predicate never reuses the
  code path it checks: `alive_mask_stale` recomputes the alive mask from
  the raw `FaultSchedule` fields instead of calling
  `faults.schedule.alive_at`, so a fault in the checked path cannot blind
  its own checker.

The device never raises: the drivers call `raise_on_violation` on the
codes they read and get an `InvariantViolation` naming the trial, the
tick and the contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Contract", "CONTRACTS", "CODES", "InvariantState",
    "InvariantViolation", "init_invariants", "record", "record_code",
    "contract_of", "first_violation", "raise_on_violation",
    "SINKHORN_MARGINAL_TOL", "BOUNDS_MARGIN",
    "perm_violated", "adjacency_asymmetric", "alive_mask_stale",
    "dead_rows_active", "dead_rows_moved", "nonfinite_state",
    "nonfinite_points", "out_of_bounds", "sinkhorn_marginals_violated",
    "admm_residual_violated",
]

# Sinkhorn marginal: sum_i |row_mass_i - 1/n| (same for columns). The
# production settings leave < 1e-3 at n <= 100; 0.05 (5% of the mass
# misallocated) is far outside that and still catches a broken iteration
# before the rounded permutation degrades.
SINKHORN_MARGINAL_TOL = 0.05
# room-bounds slack in metres: the safety shim clamps goals to the room,
# but the doubleint dynamics may overshoot a clamped goal a little
BOUNDS_MARGIN = 1.0


@dataclasses.dataclass(frozen=True)
class Contract:
    """One registered invariant. ``code`` is the int32 the carry records
    (0 is 'clean'); ``scope`` names the stage the check runs at."""

    id: str
    code: int
    summary: str
    scope: str


CONTRACTS: tuple[Contract, ...] = (
    # when one tick violates several contracts the FIRST one *recorded*
    # in `engine.step` wins (adj_sym, mask_consistency, the solver-level
    # sinkhorn_marginal, assign_perm, dead_distcmd, dead_frozen,
    # state_finite, state_bounds — e.g. a NaN pose is reported as
    # state_finite, not as the out-of-bounds its NaN comparisons imply)
    Contract("adj_sym", 1,
             "formation adjacency matrix is symmetric",
             "engine.step input"),
    Contract("mask_consistency", 2,
             "alive mask equals the FaultSchedule's mask at the "
             "current tick (no stale mask after a drop/rejoin)",
             "engine.step fault model"),
    Contract("assign_perm", 3,
             "the assignment v2f is a permutation (auction, "
             "Sinkhorn-rounded, and CBAA consensus outputs alike)",
             "engine.step after assignment"),
    Contract("sinkhorn_marginal", 4,
             "Sinkhorn transport-plan row/col marginals within "
             "SINKHORN_MARGINAL_TOL of uniform",
             "engine.assign sinkhorn path"),
    Contract("dead_distcmd", 5,
             "dead vehicles publish no distcmd",
             "engine.step control masking"),
    Contract("dead_frozen", 6,
             "dead vehicles' poses stay pinned across the tick",
             "engine.step fault freeze"),
    Contract("state_finite", 7,
             "poses/velocities/goals finite after the safety shim",
             "engine.step post-dynamics"),
    Contract("state_bounds", 8,
             "poses within room bounds + BOUNDS_MARGIN",
             "engine.step post-dynamics"),
    Contract("admm_residual", 9,
             "ADMM gain iteration drove its residual down (converged "
             "by threshold, or net decrease over the budget)",
             "gains.admm solve"),
    # recorded between mask_consistency and the assignment contracts in
    # `engine.step` (the scenario-effective formation is computed before
    # the auction consumes it)
    Contract("scen_points", 10,
             "scenario-effective formation points (sequence tables + "
             "goal drift) are finite",
             "engine.step scenario timeline"),
)

CODES = {c.id: c.code for c in CONTRACTS}
_BY_CODE = {c.code: c for c in CONTRACTS}


def contract_of(code: int) -> Contract | None:
    """Decode a device code (0 / unknown -> None)."""
    return _BY_CODE.get(int(code))


class InvariantViolation(RuntimeError):
    """A sanitizer failure surfaced by a host driver."""

    def __init__(self, contract: Contract, tick: int,
                 trial: int | None = None):
        self.contract = contract
        self.tick = tick
        self.trial = trial
        where = f"trial {trial}, " if trial is not None else ""
        super().__init__(
            f"invariant {contract.id!r} violated ({where}tick {tick}): "
            f"{contract.summary} [scope: {contract.scope}]")


@dataclasses.dataclass
class InvariantState:
    """Per-trial error carry: the code of the FIRST violation (0 = clean)
    and the trial's tick it landed on (-1 = none)."""

    code: torch.Tensor   # ([B,]) int32
    tick: torch.Tensor   # ([B,]) int32


def init_invariants(batch: int | None = None, device=None
                    ) -> InvariantState:
    """A clean carry on ``device`` (None = the card)."""
    from aclswarm_torch.core.types import resolve_device

    dev = resolve_device(device)
    lead = () if batch is None else (batch,)
    return InvariantState(
        code=torch.zeros(lead, dtype=torch.int32, device=dev),
        tick=torch.full(lead, -1, dtype=torch.int32, device=dev))


def record(inv: InvariantState, violated: torch.Tensor, contract_id: str,
           tick: torch.Tensor) -> InvariantState:
    """First-wins accumulation of one contract's ([B,]) bool predicate
    at each trial's ``tick`` (([B,]) int32)."""
    return record_code(inv, violated.to(torch.int32) * CODES[contract_id],
                       tick)


def record_code(inv: InvariantState, code: torch.Tensor,
                tick: torch.Tensor) -> InvariantState:
    """First-wins accumulation of an already-encoded ([B,]) int32 code
    (0 = no violation), as the solver-level checks return them."""
    hit = (code != 0) & (inv.code == 0)
    return InvariantState(code=torch.where(hit, code, inv.code),
                          tick=torch.where(hit, tick, inv.tick))


# ---------------------------------------------------------------------------
# contract predicates: tensors in, ([B,]) bool out (True = VIOLATED); a
# leading (B,) axis checks each trial of a batch on its own

def perm_violated(v2f: torch.Tensor) -> torch.Tensor:
    """``v2f`` ([B,] n) is not a permutation of 0..n-1: each value's count,
    out-of-range entries counted nowhere (scattered onto a clipped index
    with weight 0, never indexed out of range)."""
    n = v2f.shape[-1]
    inrange = (v2f >= 0) & (v2f < n)
    counts = torch.zeros(v2f.shape, dtype=torch.int32, device=v2f.device)
    counts.scatter_add_(-1, torch.clamp(v2f, 0, n - 1).long(),
                        inrange.to(torch.int32))
    return ~torch.all(counts == 1, dim=-1)


def adjacency_asymmetric(adjmat: torch.Tensor) -> torch.Tensor:
    return torch.any(adjmat != adjmat.mT, dim=-1).any(dim=-1)


def alive_mask_stale(alive: torch.Tensor, sched, tick: torch.Tensor
                     ) -> torch.Tensor:
    """The mask the engine threads differs from the schedule's own rule
    at each trial's ``tick``: alive iff ``tick < drop`` or ``tick >=
    rejoin``, recomputed here from the raw fields."""
    t = tick[..., None]
    ref = (t < sched.drop_tick) | (t >= sched.rejoin_tick)
    return torch.any(alive != ref, dim=-1)


def dead_rows_active(distcmd_norm: torch.Tensor, alive: torch.Tensor
                     ) -> torch.Tensor:
    """A dead vehicle published a nonzero distcmd."""
    return torch.any(~alive & (distcmd_norm > 0), dim=-1)


def dead_rows_moved(q_new: torch.Tensor, q_prev: torch.Tensor,
                    alive: torch.Tensor) -> torch.Tensor:
    """A dead vehicle's pose changed across the tick (a rejoined vehicle
    is alive and exempt)."""
    moved = torch.any(q_new != q_prev, dim=-1)
    return torch.any(~alive & moved, dim=-1)


def nonfinite_points(pts: torch.Tensor) -> torch.Tensor:
    """A non-finite scenario-effective formation point."""
    return ~torch.isfinite(pts).all(dim=-1).all(dim=-1)


def nonfinite_state(swarm, goal) -> torch.Tensor:
    """A non-finite pose, velocity or goal after the safety shim."""
    ok = torch.stack([torch.isfinite(x).all(dim=-1).all(dim=-1)
                      for x in (swarm.q, swarm.vel, goal.pos, goal.vel)])
    return ~ok.all(dim=0)


def out_of_bounds(q: torch.Tensor, sparams,
                  margin: float = BOUNDS_MARGIN) -> torch.Tensor:
    """A pose left the room by more than ``margin``. NaN poses fail the
    inside test too, but `nonfinite_state` is recorded first."""
    from aclswarm_torch.control.safety import host_row

    lo = host_row(q, [b - margin for b in sparams.bounds_min])
    hi = host_row(q, [b + margin for b in sparams.bounds_max])
    inside = (q >= lo) & (q <= hi)
    return ~inside.all(dim=-1).all(dim=-1)


def sinkhorn_marginals_violated(row_err: torch.Tensor,
                                col_err: torch.Tensor,
                                tol: float = SINKHORN_MARGINAL_TOL
                                ) -> torch.Tensor:
    """Row/col L1 marginal errors (`sinkhorn.marginal_errors`) outside
    the tolerance."""
    return (row_err > tol) | (col_err > tol)


def admm_residual_violated(first_diff: torch.Tensor,
                           last_diff: torch.Tensor,
                           stopped: torch.Tensor) -> torch.Tensor:
    """The ADMM iteration neither met its stopping criteria nor ended
    below its first residual: transient growth is normal, finishing
    higher than it started is not."""
    return ~stopped & (last_diff > first_diff)


# ---------------------------------------------------------------------------
# host side

def first_violation(codes: np.ndarray, tick0: int = 0
                    ) -> tuple[int, Contract] | None:
    """Decode a read-back per-tick ``(T,)`` code array: (tick, Contract)
    of the first violation, or None if clean. ``tick0`` is the tick of
    the array's first element (chunked drivers pass their chunk base)."""
    codes = np.asarray(codes)
    nz = np.nonzero(codes != 0)[0]
    if nz.size == 0:
        return None
    t = int(nz[0])
    contract = contract_of(int(codes[t]))
    if contract is None:       # unknown code: still a violation, loudly
        contract = Contract("unknown", int(codes[t]),
                            "unregistered contract code", "unknown")
    return tick0 + t, contract


def raise_on_violation(codes: np.ndarray, trial: int | None = None,
                       tick0: int = 0) -> None:
    """Raise `InvariantViolation` on the first nonzero code, else no-op."""
    hit = first_violation(codes, tick0)
    if hit is not None:
        tick, contract = hit
        raise InvariantViolation(contract, tick, trial=trial)

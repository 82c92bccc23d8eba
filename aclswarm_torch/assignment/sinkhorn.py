"""Sinkhorn optimal-transport assignment (port of
`aclswarm_tpu/assignment/sinkhorn.py`).

Vehicle->point distances, log-domain Sinkhorn (kernel K1 on the card),
rounding to a permutation (kernel K2 for the 'dominant' rule) and a
parallel 2-opt repair. Every data-dependent loop on the main path runs on
the card: K2 holds the rounding loop, and the 2-opt repair runs its full
sweep budget (see `two_opt_refine`), so an assignment never reads a value
back to the host.

`sinkhorn_assign` also solves a batch of trials, the clouds ``(B, n, 3)``:
one K1 call and one K2 call for the whole batch, the rest batched on the
trial axis.

With ``stage_shardings`` (the agent mesh, `aclswarm_torch.parallel`) the
iterations run row-sharded and the rounding replicated, the reference's
staged layout (docs/SCALING.md): each rank iterates its rows of logK with
one column collective per iteration (`sinkhorn_log_rows`), then the plan
and the cost are gathered and K2 rounds on every rank. The row-sharded
iterations are the reference's own XLA formulation under a mesh: K1's one
cooperative launch cannot hold a collective in the middle of its loop.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from aclswarm_torch import ops
from aclswarm_torch.core import geometry
from aclswarm_torch.faults import masking


class SinkhornResult(NamedTuple):
    row_to_col: torch.Tensor  # ([B,] n) rounded permutation (v2f here)
    plan_log: torch.Tensor    # ([B,] n, n) final log transport plan
    err: torch.Tensor         # ([B,]) final row-marginal L1 error


def sinkhorn_log(cost: torch.Tensor, tau: float = 0.03, n_iters: int = 200,
                 impl: str = "auto") -> torch.Tensor:
    """Log-domain Sinkhorn on a square cost matrix; returns the log plan.
    ``impl='auto'``: kernel K1 on the card, its plain version on the CPU
    (the port has no other route)."""
    if impl != "auto":
        raise ValueError(f"unknown sinkhorn impl {impl!r}")
    return ops.sinkhorn_log(cost, tau, n_iters)


def marginal_errors(plan_log: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """L1 marginal errors ``(row_err, col_err)`` of a ([B,] n, n) log
    plan, each ``sum_i |mass_i - 1/n|`` over rows / columns, per trial.
    The `sinkhorn_marginal` contract thresholds them."""
    target = 1.0 / plan_log.shape[-1]
    row_mass = torch.exp(torch.logsumexp(plan_log, dim=-1))
    col_mass = torch.exp(torch.logsumexp(plan_log, dim=-2))
    return (torch.sum(torch.abs(row_mass - target), dim=-1),
            torch.sum(torch.abs(col_mass - target), dim=-1))


def round_to_permutation(plan_log: torch.Tensor) -> torch.Tensor:
    """Greedy rounding: n times take the global max entry (first hit),
    strike its row and column."""
    n = plan_log.shape[0]
    scores = plan_log.clone()
    assign = torch.full((n,), -1, dtype=torch.int32, device=plan_log.device)
    for _ in range(n):
        flat = torch.argmax(scores)
        i, j = flat // n, flat % n
        assign[i] = j.to(torch.int32)
        scores[i, :] = -math.inf
        scores[:, j] = -math.inf
    return assign


def round_parallel(plan_log: torch.Tensor,
                   max_rounds: int | None = None) -> torch.Tensor:
    """Conflict-resolution rounding: every unassigned agent claims its best
    remaining column; each column keeps its best claimant, permanently.
    Off the main path; its data-dependent loop runs on the host."""
    n = plan_log.shape[0]
    dev = plan_log.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    if max_rounds is None:
        max_rounds = n
    neg = -math.inf
    scores = plan_log
    assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < max_rounds and bool((assign < 0).any()):  # torchcheck: disable=JC001 rounding='parallel' only
        unassigned = assign < 0
        want = torch.argmax(scores, dim=1)
        val = scores[idx, want]
        claims = torch.where(unassigned[:, None] & (want[:, None] == idx),
                             val[:, None], torch.full_like(scores, neg))
        best_agent = torch.argmax(claims, dim=0)
        col_taken = claims.max(dim=0).values > neg
        winners = col_taken[want] & (best_agent[want] == idx) & unassigned
        assign = torch.where(winners, want.to(torch.int32), assign)
        scores = torch.where(col_taken[None, :] | winners[:, None],
                             torch.full_like(scores, neg), scores)
        rounds += 1
    return assign


def round_dominant(plan_log: torch.Tensor,
                   max_rounds: int | None = None) -> torch.Tensor:
    """Locally-dominant-pair rounding (== sequential global greedy):
    kernel K2 on the card, its plain version on the CPU."""
    return ops.round_dominant(plan_log, max_rounds)[0]


def two_opt_refine(cost: torch.Tensor, v2f: torch.Tensor,
                   sweeps: int = 20) -> torch.Tensor:
    """Parallel 2-opt repair: per sweep, every vehicle finds its best swap
    partner; mutually-best improving pairs swap simultaneously.

    The reference stops at the first sweep that makes no swap. Here every
    sweep runs, and the result is bit-identical: a sweep's swap set
    depends only on ``v2f``, so once a sweep makes no swap ``v2f`` stops
    changing and every later sweep is idle too. Running them on the card
    costs a few small kernels; stopping early would cost a host read of
    the swap flag every sweep."""
    n = cost.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=cost.device)
    eye = torch.eye(n, dtype=torch.bool, device=cost.device)
    for _ in range(sweeps):
        v = v2f.long()
        a = torch.gather(cost, -1, v[..., None])[..., 0]   # cost[i, v2f[i]]
        # M[i, k] = cost[i, v2f[k]]
        M = torch.gather(cost, -1, v[..., None, :].expand(cost.shape))
        gain = a[..., :, None] + a[..., None, :] - M - M.mT
        gain = torch.where(eye, torch.full_like(gain, -math.inf), gain)
        b = torch.argmax(gain, dim=-1)
        ok = (torch.gather(b, -1, b) == idx) \
            & (torch.gather(gain, -1, b[..., None])[..., 0] > 1e-7)
        v2f = torch.where(ok, torch.gather(v2f, -1, b), v2f)
    return v2f


def sinkhorn_assign(q: torch.Tensor, p_aligned: torch.Tensor,
                    tau: float = 0.03,  # torchcheck: device-path
                    n_iters: int = 200,
                    rounding: str = "dominant",
                    refine_sweeps: int = 12,
                    impl: str = "auto",
                    stage_shardings=None,
                    pin: torch.Tensor | None = None,
                    forbid: torch.Tensor | None = None) -> SinkhornResult:
    """Fast assignment: vehicle->point distances (`cdist_fast`), scale
    normalization, Sinkhorn, rounding ('dominant' | 'parallel' | 'greedy'),
    then ``refine_sweeps`` of 2-opt repair against the raw distances.

    ``pin``/``forbid`` ((n, n) bool, together or not at all): pinned pairs
    become free and forbidden ones prohibitively expensive, applied after
    the scale normalization and to the raw cost the repair sees.
    ``stage_shardings`` = ``(row_sharding(mesh), replicated(mesh))``
    (`parallel.mesh`) stages the solve over the mesh: ``q`` and
    ``p_aligned`` are whole on every rank, each rank prices and iterates
    its own rows, and every rank returns the whole result (a rank outside
    the mesh, in an uneven world, receives it from the mesh's first rank:
    `collectives.spill`)."""
    if (pin is None) != (forbid is None):
        raise ValueError("sinkhorn_assign: pass pin and forbid together "
                         "or not at all")
    if q.ndim > 2 and rounding != "dominant":
        raise ValueError("a batch of trials rounds with 'dominant' (K2) "
                         f"only, not {rounding!r}")
    if stage_shardings is None:
        mesh = None
        cost_raw = geometry.cdist_fast(q, p_aligned)
    else:
        if q.ndim > 2:
            raise ValueError("stage_shardings solves one problem, not a "
                             "batch of trials")
        mesh = _staged_mesh(stage_shardings)
        if mesh.index is None:
            return _spilled_result(mesh, q)
        cost_raw = _gather_rows(lambda lo, hi: geometry.cdist_fast(
            q[lo:hi], p_aligned), mesh, q.shape[-2])
    # each trial's mean alone, as its serial solve reduces it
    mean = torch.mean(cost_raw) if cost_raw.ndim == 2 else torch.stack(
        [torch.mean(c) for c in cost_raw])[:, None, None]
    cost = cost_raw / (mean + 1e-12)
    if pin is not None:
        cost = masking.apply_pin_forbid(cost, pin, forbid)
        cost_raw = masking.apply_pin_forbid(cost_raw, pin, forbid)
    if mesh is None:
        plan_log = sinkhorn_log(cost, tau=tau, n_iters=n_iters, impl=impl)
    else:
        plan_log = _gather_rows(lambda lo, hi: sinkhorn_log_rows(
            cost[lo:hi], mesh, tau, n_iters), mesh, cost.shape[-1])
    if rounding == "dominant":
        v2f = round_dominant(plan_log)
    elif rounding == "parallel":
        v2f = round_parallel(plan_log)
    elif rounding == "greedy":
        v2f = round_to_permutation(plan_log)
    else:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    if refine_sweeps > 0:
        v2f = two_opt_refine(cost_raw, v2f, sweeps=refine_sweeps)
    row_mass = torch.exp(torch.logsumexp(plan_log, dim=-1))
    err = torch.sum(torch.abs(row_mass - 1.0 / cost.shape[-1]), dim=-1)
    out = SinkhornResult(row_to_col=v2f, plan_log=plan_log, err=err)
    if mesh is None:
        return out
    from aclswarm_torch.parallel import collectives as coll

    return coll.spill(out, mesh)


def _spilled_result(mesh, q: torch.Tensor) -> SinkhornResult:
    """A staged solve's result on a rank outside the mesh: the mesh's
    first rank's, received leaf by leaf (`collectives.spill`)."""
    from aclswarm_torch.parallel import collectives as coll

    n = q.shape[-2]
    return coll.spill(SinkhornResult(
        row_to_col=torch.empty((n,), dtype=torch.int32, device=mesh.device),
        plan_log=torch.empty((n, n), dtype=q.dtype, device=mesh.device),
        err=torch.empty((), dtype=q.dtype, device=mesh.device)), mesh)


def _staged_mesh(stage_shardings):
    """The mesh of ``(iteration placement, rounding placement)``: the
    iterations row-sharded, the rounding replicated, on one mesh."""
    it, rnd = stage_shardings
    if getattr(it, "axis", None) != 0 or getattr(rnd, "axis", 0) is not None \
            or it.mesh is not rnd.mesh:
        raise ValueError("stage_shardings must be (row_sharding(mesh), "
                         "replicated(mesh)) of one parallel.mesh mesh")
    return it.mesh


def _gather_rows(rows_of, mesh, n: int) -> torch.Tensor:
    """``rows_of(lo, hi)``, this rank's rows of an (n, ...) result, then
    every rank's rows gathered: the whole result on every rank."""
    from aclswarm_torch.parallel import collectives as coll

    return coll.gather(rows_of(*mesh.rows(n)), mesh)


def sinkhorn_log_rows(cost_rows: torch.Tensor, mesh, tau: float = 0.03,
                      n_iters: int = 200) -> torch.Tensor:
    """`sinkhorn_log` on a mesh: this rank's (r, n) rows of the cost in,
    its rows of the log plan out. f is row-local; each g update reduces
    the columns over the ranks, every rank's (n,) column logsumexp
    gathered in one collective and combined, so g is the same on every
    rank. Plain tensor operations on any device: the reference's XLA
    iteration under a mesh."""
    from aclswarm_torch.parallel import collectives as coll

    n = cost_rows.shape[-1]
    logK = -cost_rows / tau
    log_mu = torch.full((n,), -math.log(n), dtype=cost_rows.dtype,
                        device=cost_rows.device)
    f = torch.zeros(cost_rows.shape[0], dtype=cost_rows.dtype,
                    device=cost_rows.device)
    g = torch.zeros_like(log_mu)
    for _ in range(n_iters):
        f = log_mu[:f.shape[0]] - torch.logsumexp(logK + g[None, :], dim=-1)
        part = torch.logsumexp(logK + f[:, None], dim=-2)
        g = log_mu - torch.logsumexp(coll.gather(part[None], mesh), dim=0)
    return logK + f[:, None] + g[None, :]

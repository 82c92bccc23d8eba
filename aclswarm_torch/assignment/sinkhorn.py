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
    ``stage_shardings`` belongs to the multi-device slice."""
    if stage_shardings is not None:
        raise NotImplementedError("sinkhorn_assign stage_shardings belongs "
                                  "to the parallel/ slice, not yet ported")
    if (pin is None) != (forbid is None):
        raise ValueError("sinkhorn_assign: pass pin and forbid together "
                         "or not at all")
    if q.ndim > 2 and rounding != "dominant":
        raise ValueError("a batch of trials rounds with 'dominant' (K2) "
                         f"only, not {rounding!r}")
    cost_raw = geometry.cdist_fast(q, p_aligned)
    # each trial's mean alone, as its serial solve reduces it
    mean = torch.mean(cost_raw) if cost_raw.ndim == 2 else torch.stack(
        [torch.mean(c) for c in cost_raw])[:, None, None]
    cost = cost_raw / (mean + 1e-12)
    if pin is not None:
        cost = masking.apply_pin_forbid(cost, pin, forbid)
        cost_raw = masking.apply_pin_forbid(cost_raw, pin, forbid)
    plan_log = sinkhorn_log(cost, tau=tau, n_iters=n_iters, impl=impl)
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
    return SinkhornResult(row_to_col=v2f, plan_log=plan_log, err=err)

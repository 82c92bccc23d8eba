"""Bertsekas auction algorithm for linear assignment (port of
`aclswarm_tpu/assignment/auction.py`): the exact centralized solver, the
engine's default assignment mode.

Jacobi variant with epsilon scaling: every unassigned agent bids each
round and each object accepts its highest bidder. With a final eps below
gap/n the result is optimal; for float costs it is within n*eps of optimal.

The reference nests two data-dependent loops (bid rounds inside scaling
phases). Here they are one flat loop whose whole state stays on the
device: each step decides on the device whether the phase goes on, a new
phase starts (the owners reset and eps shrinks in that same step, which
also bids the phase's first round) or the solve is done, and applies its
update through `torch.where` on that decision. A step past the end is the
identity and ``iters`` counts only live bid rounds, so the host may poll
the done flag every ``poll_every`` steps instead of every round and the
result stays bit-identical to the reference's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from aclswarm_torch.core import geometry

# steps between reads of the done flag on a CUDA device (the CPU reads it
# every step: a read costs nothing there)
POLL_EVERY = 32


class AuctionResult(NamedTuple):
    row_to_col: torch.Tensor  # (n,) int32 agent -> object
    prices: torch.Tensor      # (n,) final object prices
    iters: torch.Tensor       # () int32 total bid rounds executed
    valid: torch.Tensor       # () bool: converged to a true permutation
                              # (False only if max_rounds was exhausted)


def _owners_assigned(owner: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool: agent i owns some object. The unowned sentinel ``n``
    lands in a spare slot that is cut off (no scatter may index out of
    range here)."""
    hit = torch.zeros(n + 1, dtype=torch.bool, device=owner.device)
    hit[owner.long()] = True
    return hit[:n]


def auction_lap(benefit: torch.Tensor,  # torchcheck: device-path
                eps_start: float | None = None,
                eps_min: float = 1e-4,
                scale_factor: float = 5.0,
                max_rounds: int = 10000,
                poll_every: int | None = None) -> AuctionResult:
    """Maximize sum_i benefit[i, assign[i]] over permutations.

    Args:
      benefit: (n, n) benefit (negated cost) matrix.
      eps_start: initial epsilon; defaults to max(max|benefit|, 1)/2,
        computed on the device.
      eps_min: final epsilon (optimality slack is n * eps_min).
      scale_factor: epsilon division factor per scaling phase.
      max_rounds: cap on total bid rounds across all phases.
      poll_every: steps between host reads of the done flag; None = 1 on
        the CPU, `POLL_EVERY` on a CUDA device. Any value gives the same
        result.
    """
    n = benefit.shape[0]
    dtype, dev = benefit.dtype, benefit.device
    if poll_every is None:
        poll_every = POLL_EVERY if dev.type == "cuda" else 1
    big = torch.finfo(dtype).max / 4
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    cols32 = cols.to(torch.int32)
    eps_floor = torch.full((), eps_min, dtype=dtype, device=dev)
    # eps shrinks by a multiplication with the reciprocal, rounded in the
    # matrix's dtype: the reference's compiler lowers its division by the
    # constant to that, and 1.5 * (1/5) != 1.5 / 5 in the last bit, which
    # on tied (integer) benefits changes who outbids whom
    shrink = torch.ones((), dtype=dtype, device=dev) / scale_factor

    if eps_start is None:
        eps = torch.clamp(torch.max(torch.abs(benefit)), min=1.0) / 2.0
    else:
        eps = torch.full((), eps_start, dtype=dtype, device=dev)
    owner = torch.full((n,), n, dtype=torch.int32, device=dev)
    prices = torch.zeros(n, dtype=dtype, device=dev)
    rounds = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    def step(owner, prices, eps, rounds, done):
        live = rounds < max_rounds
        assigned = _owners_assigned(owner, n)
        phase_over = torch.all(assigned) | ~live
        advance = phase_over & (eps > eps_floor) & live & ~done
        done = done | (phase_over & ~advance)
        eps = torch.where(advance,
                          torch.maximum(eps * shrink, eps_floor), eps)
        # a new phase starts with every object unowned
        owner_in = torch.where(advance, torch.full_like(owner, n), owner)
        unassigned = ~assigned | advance

        # one bid round (the reference's `bid_round`, operation for
        # operation: the prices must agree to the last bit)
        value = benefit - prices[None, :]
        top1, j_star = torch.max(value, dim=1)       # first maximal column
        value2 = value.scatter(1, j_star[:, None], -big)
        top2 = torch.max(value2, dim=1).values
        bid_amt = prices[j_star] + (top1 - top2) + eps
        bids = torch.where(
            unassigned[:, None] & (j_star[:, None] == cols[None, :]),
            bid_amt[:, None], -big)                  # (agents, objects)
        best_bid, best_agent = torch.max(bids, dim=0)  # first maximal agent
        got_bid = best_bid > -big
        new_prices = torch.where(got_bid, best_bid, prices)
        new_owner = torch.where(got_bid, best_agent.to(torch.int32),
                                owner_in)

        owner = torch.where(done, owner, new_owner)
        prices = torch.where(done, prices, new_prices)
        rounds = rounds + (~done).to(torch.int32)
        return owner, prices, eps, rounds, done

    # rounds <= max_rounds live steps, plus one step that sees the end
    state = (owner, prices, eps, rounds, done)
    steps = 0
    while steps <= max_rounds:
        state = step(*state)
        steps += 1
        if steps % poll_every == 0 and bool(state[4]):  # torchcheck: disable=JC001 poll: one read per POLL_EVERY rounds
            break
    owner, prices, _, rounds, _ = state

    # owner[j] = agent; invert to agent -> object. If max_rounds ran out
    # mid-phase some agents own nothing: `valid` says so.
    row_to_col = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    row_to_col[owner.long()] = cols32
    return AuctionResult(row_to_col=row_to_col[:n], prices=prices,
                         iters=rounds, valid=torch.all(owner < n))


def assign_min_dist(q: torch.Tensor, p_aligned: torch.Tensor,
                    **kw) -> torch.Tensor:
    """Centralized assignment minimizing total vehicle->point distance;
    returns v2f (n,)."""
    return auction_lap(-geometry.cdist(q, p_aligned), **kw).row_to_col

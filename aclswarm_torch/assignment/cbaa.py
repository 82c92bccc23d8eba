"""CBAA (Consensus-Based Auction Algorithm), bulk-synchronous (port of
`aclswarm_tpu/assignment/cbaa.py`): the decentralized assignment mode.

All n price/who tables live in one ``(n, n)`` tensor each; a bid round is
a masked max-consensus over the neighbor axis, and an auction iterates up
to ``n * DIAMETER`` rounds, ending early at the tables' fixed point.

Semantics kept from the reference:
- initial greedy bid on the nearest aligned formation point at price
  1/(dist + 1e-8);
- per-task winner = highest price among graph neighbors + self, ties to
  the LOWEST vehicle id;
- an outbid agent rebids in the same round on the updated table, must
  strictly beat the table price, and takes the FIRST index achieving its
  max among candidates;
- the communication graph is the formation adjacency composed with the
  *current* assignment;
- the final `who` table maps task -> vehicle; valid = it is a permutation
  every agent agrees on.

The dense consensus round materializes an (n, n, n) masked broadcast;
``task_block=B`` walks the task axis in blocks of B (peak memory
O(n^2 B), bit-identical: the reduction is independent per task).

The early exit is a fixed-point test on the device. The round map is a
pure function of the tables, so a round run past the fixed point changes
nothing: the loop reads the flag back only every ``poll_every`` rounds,
``rounds`` counts only the rounds before the flag rose, and tables and
count equal those of a loop that tests every round.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from aclswarm_torch.core import geometry
from aclswarm_torch.core import perm as permutil

PRICE_EPS = 1e-8  # price regularizer
DIAMETER = 2      # graph-diameter budget: n * DIAMETER bid rounds
# rounds between reads of the fixed-point flag on a CUDA device (the CPU
# reads it every round)
POLL_EVERY = 4


class CBAAResult(NamedTuple):
    v2f: torch.Tensor    # (n,) int32 vehicle -> formation point
    f2v: torch.Tensor    # (n,) int32 formation point -> vehicle (`who`)
    valid: torch.Tensor  # () bool: consensus reached a true permutation
    price: torch.Tensor  # (n, n) final per-agent price tables
    who: torch.Tensor    # (n, n) int32 final per-agent winner tables
    rounds: torch.Tensor  # () int32: bid rounds actually executed


class CbaaTables(NamedTuple):
    """The auction state threaded ACROSS auctions (the warm start): the
    (n, n) price and winner tables a finished auction left behind
    (`CBAAResult.price` / `.who`)."""

    price: torch.Tensor   # (n, n) per-agent price tables
    who: torch.Tensor     # (n, n) int32 per-agent winner tables


def init_tables(n: int, device=None, dtype=torch.float32) -> CbaaTables:
    """The COLD auction start as tables: empty prices, no winners. Seeding
    `cbaa_assign(warm=...)` with it is bit-identical in value to the
    table-free cold auction."""
    from aclswarm_torch.core.types import resolve_device

    dev = resolve_device(device)
    return CbaaTables(price=torch.zeros((n, n), dtype=dtype, device=dev),
                      who=torch.full((n, n), -1, dtype=torch.int32,
                                     device=dev))


def _own_distances(q_veh: torch.Tensor, paligned: torch.Tensor
                   ) -> torch.Tensor:
    """d[v, j] = ||q_v - paligned_v[j]||. `vector_norm` sums the three
    squares in the fused multiply-add chain the reference's compiled norm
    uses on the CPU (sqrt((dx^2 + dy^2) + dz^2) with separately rounded
    squares differs from it in the last bit of one distance in nine), so
    prices agree to the last bit and no strict comparison between bids
    can flip."""
    return torch.linalg.vector_norm(q_veh[:, None, :] - paligned, dim=-1)


def bid_prices(q_veh: torch.Tensor, paligned: torch.Tensor) -> torch.Tensor:
    """Candidate prices: price[v, j] = 1 / (||q_v - paligned_v[j]|| + eps);
    ``paligned`` is each agent's own locally-aligned formation ((n, n, 3),
    agent axis first)."""
    return 1.0 / (_own_distances(q_veh, paligned) + PRICE_EPS)


def _select_task(myprice, price, who, vehids):
    """Each agent picks the first index achieving the max over candidate
    tasks where its own price strictly beats the current table (and zero),
    then writes its bid into its table row. Agents with no candidate leave
    their row unchanged."""
    cand = (myprice > price) & (myprice > 0.0)
    masked = torch.where(cand, myprice, -math.inf)
    task = torch.argmax(masked, dim=1, keepdim=True)   # first max (lowest j)
    was_assigned = torch.any(cand, dim=1, keepdim=True)
    newp = price.scatter(1, task, torch.where(
        was_assigned, myprice.gather(1, task), price.gather(1, task)))
    neww = who.scatter(1, task, torch.where(
        was_assigned, vehids[:, None], who.gather(1, task)))
    return newp, neww


def _consensus_round(price, who, comm_mask, vehids, task_block=None):
    """One synchronous bid round: masked max-consensus over neighbors +
    self. Winner per (agent, task) maximizes price with ties to the lowest
    vehicle id. Returns updated tables and the per-agent outbid flags.

    The max over the sender axis returns its first maximal index, which IS
    the lowest sender id among equal prices; the winner's `who` entry is
    then one gather. comm includes self, so a row is never fully masked
    and the max is always a real sender's (nonnegative) price."""
    n = price.shape[0]

    def block_merge(pb, wb):
        eff = torch.where(comm_mask[:, :, None], pb[None, :, :], -math.inf)
        best, winner = torch.max(eff, dim=1)           # (n, B) each
        return best, torch.gather(wb, 0, winner)

    if task_block is None:
        new_price, new_who = block_merge(price, who)
    else:
        B = int(task_block)
        merged = [block_merge(price[:, s:s + B], who[:, s:s + B])
                  for s in range(0, n, B)]
        new_price = torch.cat([m[0] for m in merged], dim=1)
        new_who = torch.cat([m[1] for m in merged], dim=1)

    mine = vehids[:, None]
    was_outbid = torch.any((who == mine) & (new_who != mine), dim=1)
    return new_price, new_who, was_outbid


def cbaa_assign(q_veh: torch.Tensor,
                paligned: torch.Tensor,
                adjmat: torch.Tensor,
                v2f_prev: torch.Tensor,
                n_iters: Optional[int] = None,
                task_block: Optional[int] = None,
                early_exit: bool = True,
                alive: Optional[torch.Tensor] = None,
                comm_extra: Optional[torch.Tensor] = None,
                warm: Optional[CbaaTables] = None,
                assign_eps: float = 0.0,
                first: Optional[torch.Tensor] = None,
                poll_every: Optional[int] = None) -> CBAAResult:
    """Run a full synchronous CBAA auction.

    Args:
      q_veh: (n, 3) swarm positions, vehicle order.
      paligned: (n, n, 3) per-agent locally-aligned formation points, from
        `geometry.align_formation_local`.
      adjmat: (n, n) formation-space adjacency.
      v2f_prev: (n,) current assignment (defines the comm graph).
      n_iters: bid rounds; defaults to n * DIAMETER.
      task_block: None = dense consensus broadcast; an int B bounds peak
        memory to O(n^2 B).
      early_exit: stop once a bid round leaves every table unchanged (the
        result, tables included, equals the full ``n_iters`` budget's).
        False runs exactly ``n_iters`` rounds and never reads the device.
      alive: optional (n,) bool fault mask. Dead agents never bid and alive
        agents never bid on dead-owned points; the result pins dead
        vehicles to their current points and requires consensus only among
        alive agents over alive-owned points. All true == None, bit for bit.
      comm_extra: optional (n, n) bool link degradation ANDed onto the
        consensus graph. Self-loops never drop.
      warm: optional `CbaaTables` — seed from a previous auction's fixed
        point: the carried WINNER LIST is re-priced at the winners' fresh
        bids before the initial greedy bid (raw stale prices would
        ratchet-lock under max-consensus). `init_tables` == None in value.
      assign_eps: relative cost-improvement hysteresis on the RESULT: the
        returned ``v2f`` keeps ``v2f_prev`` unless the candidate improves
        the summed own-aligned-point distance by this margin. ``price``,
        ``who`` and ``f2v`` stay the raw consensus outcome either way.
      first: optional () bool — the first auction after a formation
        dispatch bypasses the hysteresis.
      poll_every: rounds between host reads of the fixed-point flag; None
        = 1 on the CPU, `POLL_EVERY` on a CUDA device. Any value gives the
        same result.
    """
    n = q_veh.shape[0]
    dev = q_veh.device
    if n_iters is None:
        n_iters = n * DIAMETER
    if poll_every is None:
        poll_every = POLL_EVERY if dev.type == "cuda" else 1
    vehids = torch.arange(n, dtype=torch.int32, device=dev)

    # comm graph in vehicle space: v hears w iff adj[v2f[v], v2f[w]] or v==w
    comm_mask = permutil.comm_mask(adjmat, v2f_prev, self_loop=True)
    if comm_extra is not None:
        comm_mask = (comm_mask & comm_extra) \
            | torch.eye(n, dtype=torch.bool, device=dev)

    myprice = bid_prices(q_veh, paligned)
    zero = torch.zeros((), dtype=myprice.dtype, device=dev)
    if alive is not None:
        alive_pt = alive[permutil.invert(v2f_prev).long()]
        myprice = torch.where(alive[:, None] & alive_pt[None, :], myprice,
                              zero)

    # START bids: empty tables + initial greedy bid — or, when warm, the
    # previous auction's winner list re-priced at the winners' fresh bids
    if warm is None:
        tables = init_tables(n, dev, myprice.dtype)
        price0, who0 = _select_task(myprice, tables.price, tables.who,
                                    vehids)
    else:
        tasks = torch.arange(n, dtype=torch.int64, device=dev)
        f2v_c = warm.who[0].to(torch.int32)       # carried winner list
        held = f2v_c >= 0
        # release-at-seed: an incumbent keeps its carried task only if that
        # task is still its own best bid; otherwise the entry is cleared
        # and the ex-holder bids fresh. -1 (no winner) indexes row n-1, as
        # the reference's wrap does; `held` discards what it reads.
        holder = torch.where(held, f2v_c, f2v_c + n).long()
        pref = torch.argmax(myprice, dim=1)
        keep = held & (pref[holder] == tasks)
        wprice = torch.where(keep, myprice[holder, tasks], zero)
        price0 = wprice[None, :].expand(n, n).contiguous()
        who0 = torch.where(keep, f2v_c, -1)[None, :].expand(n, n).contiguous()
        # kept incumbents sit out the initial greedy bid (their seeded
        # entry IS their fresh bid)
        kept_agent = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        kept_agent[torch.where(keep, holder, n)] = True
        bid_price = torch.where(kept_agent[:n, None], zero, myprice)
        price0, who0 = _select_task(bid_price, price0, who0, vehids)

    def one_round(price, who):
        newp, neww, outbid = _consensus_round(price, who, comm_mask, vehids,
                                              task_block=task_block)
        # outbid agents rebid on the updated table
        rebp, rebw = _select_task(myprice, newp, neww, vehids)
        return (torch.where(outbid[:, None], rebp, newp),
                torch.where(outbid[:, None], rebw, neww))

    price, who = price0, who0
    if early_exit:
        rounds = torch.zeros((), dtype=torch.int32, device=dev)
        fixed = torch.zeros((), dtype=torch.bool, device=dev)
        for it in range(1, n_iters + 1):
            newp, neww = one_round(price, who)
            rounds = rounds + (~fixed).to(torch.int32)
            fixed = fixed | (torch.all(newp == price)
                             & torch.all(neww == who))
            price, who = newp, neww
            if it % poll_every == 0 and bool(fixed):  # torchcheck: disable=JC001 poll: one read per POLL_EVERY rounds
                break
    else:
        for _ in range(n_iters):
            price, who = one_round(price, who)
        rounds = torch.full((), n_iters, dtype=torch.int32, device=dev)

    # consensus result: every agent's `who` row is its belief of P^T
    if alive is None:
        f2v = who[0].to(torch.int32)
        agree = torch.all(who == who[None, 0, :])
        valid = agree & permutil.is_valid(f2v)
    else:
        # the reference row is the first ALIVE agent's table; dead-owned
        # points are pinned to their current vehicles; consensus is
        # required only among alive agents over alive-owned points. All
        # dead -> invalid -> the caller holds the current assignment.
        f2v_cur = permutil.invert(v2f_prev)
        ref = torch.argmax(alive.to(torch.int32))
        cons = who[ref].to(torch.int32)
        f2v = torch.where(alive_pt, cons, f2v_cur)
        agree = torch.all(torch.where(alive[:, None] & alive_pt[None, :],
                                      who == cons[None, :], True))
        valid = torch.any(alive) & agree & permutil.is_valid(f2v)
    v2f = permutil.invert(torch.where(valid, f2v, vehids))
    if assign_eps > 0.0:
        # churn-only re-assignment veto: accept the consensus assignment
        # only if it improves each agent's own-aligned-point distance in
        # total by the relative margin (dead-pinned terms cancel)
        d = _own_distances(q_veh, paligned)
        cost_new = torch.sum(d.gather(1, v2f.long()[:, None]))
        cost_cur = torch.sum(d.gather(1, v2f_prev.long()[:, None]))  # torchcheck: disable=JC006 dead-pinned terms cancel
        take = cost_new < (1.0 - assign_eps) * cost_cur
        if first is not None:
            take = take | first
        v2f = torch.where(take, v2f, v2f_prev)
    return CBAAResult(v2f=v2f, f2v=f2v, valid=valid, price=price, who=who,
                      rounds=rounds)


def cbaa_from_state(q_veh, formation_points, adjmat, v2f_prev, n_iters=None,
                    est=None, task_block=None,  # torchcheck: device-path
                    early_exit=True,
                    alive=None, comm_extra=None, warm=None,
                    assign_eps=0.0, first=None, poll_every=None):
    """Local alignment + auction for the whole swarm. ``est`` (optional,
    (n, n, 3)) routes each agent's localization estimates into its
    alignment instead of shared ground truth; own positions stay exact.
    The alignment stays unmasked under ``alive``: a dead vehicle keeps
    anchoring its neighbors' alignments at its frozen position. The other
    arguments are `cbaa_assign`'s."""
    paligned = geometry.align_formation_local(
        q_veh, formation_points, adjmat, v2f_prev, est=est)
    return cbaa_assign(q_veh, paligned, adjmat, v2f_prev, n_iters=n_iters,
                       task_block=task_block, early_exit=early_exit,
                       alive=alive, comm_extra=comm_extra, warm=warm,
                       assign_eps=assign_eps, first=first,
                       poll_every=poll_every)

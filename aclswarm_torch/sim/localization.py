"""Mutual localization by timestamped flooding (port of
`aclswarm_tpu/sim/localization.py`).

The n per-vehicle estimate tables are one ``(n, n, 3)`` tensor ``est``
(row v = vehicle v's belief about every vehicle) plus an ``(n, n)`` int32
``age`` in control ticks. One flood round is a masked min over the
neighbor axis of packed ``(age << 16 | sender)`` values — freshest sender
first, lowest sender id on ties — with strictly-newer-wins merge
semantics. The merge is kernel K3 on the card (`ops.flood`).

Decimation is host control flow: the engine passes the tick as a Python
int, so deciding whether (and which stripe) to flood never reads the card.
A batch of trials adds a leading ``(B,)`` axis to the tables, the
positions, the graphs and the assignments; the trials share the host tick,
and one K3 launch merges the whole batch.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from aclswarm_torch import ops
from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core.types import as_float

# ages clamp at AGE_CAP for packing (~5.5 min of 100 Hz ticks); n < 2^16
AGE_CAP = (1 << 15) - 1


@dataclass
class EstimateTable:
    """All n vehicles' estimate vectors: row v is vehicle v's table."""

    est: torch.Tensor   # (n, n, 3) est[v, w] = v's estimate of w's position
    age: torch.Tensor   # (n, n) int32 ticks since the estimate's source stamp


def init_table(q0, device=None, dtype=torch.float32) -> EstimateTable:
    """Every vehicle starts knowing the true initial positions."""
    q0 = as_float(q0, device, dtype)
    n = q0.shape[0]
    return EstimateTable(est=q0[None].expand(n, n, 3).clone(),
                         age=torch.zeros((n, n), dtype=torch.int32,
                                         device=q0.device))


def comm_mask(adjmat: torch.Tensor, v2f: torch.Tensor) -> torch.Tensor:
    """Vehicle-space communication graph, no self-loop (own state comes
    from the autopilot)."""
    return permutil.comm_mask(adjmat, v2f, self_loop=False)


def observe_self(table: EstimateTable, q_true: torch.Tensor) -> EstimateTable:
    """Each vehicle's own entry is ground truth with a fresh stamp."""
    n = q_true.shape[-2]
    d = torch.arange(n, dtype=torch.int64, device=q_true.device)
    est = table.est.clone()
    est[..., d, d, :] = q_true
    age = table.age.clone()
    age[..., d, d] = 0
    return EstimateTable(est=est, age=age)


def flood(table: EstimateTable, comm: torch.Tensor,
          target_block: int | None = None, merge_impl: str = "auto",
          stripe: tuple[int, int] | None = None) -> EstimateTable:
    """One synchronous flood round: receivers merge their neighbors' tables
    with newest-stamp-wins (ties keep the receiver's own entry; among
    equally fresh senders the lowest id wins).

    ``merge_impl='auto'``: kernel K3 on the card, its plain version on the
    CPU (``target_block`` blocks the plain version's target axis).
    ``stripe=(start, width)`` (host ints) merges only targets
    ``[start, start + width)`` — the phased-flood mode.
    """
    if merge_impl != "auto":
        raise ValueError(f"unknown merge impl {merge_impl!r}")
    age, est = table.age, table.est
    n = age.shape[-1]
    if n >= 1 << 16:
        raise ValueError("flood merge packs sender ids into 16 bits "
                         f"(n={n} >= 65536)")
    if stripe is None:
        start, width = 0, n
    else:
        start, width = int(stripe[0]), int(stripe[1])
    # a stripe of `age` is a strided column slice; the packing below
    # materializes it as the contiguous (n, width) block K3 takes
    age_t = age[..., start:start + width]
    est_t = est[..., start:start + width, :]
    ids = torch.arange(n, dtype=torch.int32, device=age.device)
    packed = (torch.clamp(age_t, max=AGE_CAP) << 16) | ids[:, None]
    best_packed = ops.flood_merge(packed, comm, target_block)
    best = best_packed >> 16                    # freshest neighbor age
    take = best < torch.clamp(age_t, max=AGE_CAP)   # strictly newer wins
    # a receiver with no sender got SENTINEL, whose id bits (0xFFFF) index
    # past the table: the reference's gather clamps it and the `take`
    # select discards it; torch.gather would fault, so mask it to row 0
    src = torch.where(take, best_packed & 0xFFFF, 0).long()
    est_new = torch.gather(est_t, -3, src[..., None].expand(*src.shape, 3))
    new_est_t = torch.where(take[..., None], est_new, est_t)
    new_age_t = torch.where(take, best, age_t)
    if stripe is None:
        return EstimateTable(est=new_est_t, age=new_age_t)
    est, age = est.clone(), age.clone()
    est[..., start:start + width, :] = new_est_t
    age[..., start:start + width] = new_age_t
    return EstimateTable(est=est, age=age)


def noised_view(table: EstimateTable, noise) -> EstimateTable:
    """Scenario sensor noise on the table as consumed this tick (a
    measurement-noise model): ``noise`` is an ``(([B,] n, n, 3) draw,
    ([B,]) active)`` pair. The engine hands this view to the control law
    and CBAA and keeps the carried table clean, so each consumed estimate
    holds one draw of error however long the trial; an inactive trial's
    table passes through bitwise."""
    draw, on = noise
    return EstimateTable(
        est=torch.where(on[..., None, None, None], table.est + draw,
                        table.est), age=table.age)


def _advance(table: EstimateTable, q_true: torch.Tensor, adjmat, v2f,
             link_mask) -> tuple[EstimateTable, torch.Tensor]:
    table = observe_self(EstimateTable(est=table.est, age=table.age + 1),
                         q_true)
    comm = comm_mask(adjmat, v2f)
    if link_mask is not None:
        comm = comm & link_mask
    return table, comm


def tick(table: EstimateTable, q_true: torch.Tensor, adjmat: torch.Tensor,
         v2f: torch.Tensor, do_flood: bool,
         target_block: int | None = None,
         link_mask: torch.Tensor | None = None) -> EstimateTable:
    """One control tick: ages advance, own state refreshes, and on
    decimated ticks (host bool ``do_flood``) the flood round runs.
    ``link_mask`` ((n, n) bool, receiver-major) restricts deliveries."""
    table, comm = _advance(table, q_true, adjmat, v2f, link_mask)
    return flood(table, comm, target_block) if do_flood else table


def tick_phased(table: EstimateTable, q_true: torch.Tensor,
                adjmat: torch.Tensor, v2f: torch.Tensor, tick_idx: int,
                flood_every: int, phases: int,
                target_block: int | None = None,
                link_mask: torch.Tensor | None = None) -> EstimateTable:
    """Phased flood: the target axis splits into ``phases`` stripes and
    stripe ``p`` merges on ticks where ``tick % flood_every ==
    p * (flood_every // phases)``; every target still refreshes every
    ``flood_every`` ticks. ``tick_idx`` is a host int."""
    if flood_every % phases:
        raise ValueError(f"flood_phases={phases} must divide "
                         f"flood_every={flood_every}")
    n = q_true.shape[-2]
    width = -(-n // phases)                 # ceil: stripes cover [0, n)
    table, comm = _advance(table, q_true, adjmat, v2f, link_mask)
    gap = flood_every // phases
    slot = int(tick_idx) % flood_every
    if slot % gap:
        return table
    start = min((slot // gap) * width, n - width)  # clamp: full last stripe
    return flood(table, comm, target_block, stripe=(start, width))


def relative_views(table: EstimateTable) -> torch.Tensor:
    """(n, n, 3) rel[v, w] = v's estimate of (w's position − its own)."""
    n = table.est.shape[-2]
    d = torch.arange(n, dtype=torch.int64, device=table.est.device)
    return table.est - table.est[..., d, d, :][..., :, None, :]


def staleness(table: EstimateTable, q_true: torch.Tensor) -> torch.Tensor:
    """(n, n) estimate error vs ground truth."""
    return torch.linalg.vector_norm(table.est - q_true[..., None, :, :],
                                    dim=-1)

"""On-device supervisor observables of a rollout chunk (port of
`aclswarm_tpu/sim/summary.py`).

Everything the trial FSM branches on is a per-tick scalar of a trial:

- convergence: every vehicle's trailing 1 s mean ``|distcmd| <`` 1 m/s
  (`ChunkSummary.conv_all`);
- gridlock: any vehicle's trailing 1 s CA duty ``> 0.95`` (`grid_any`);
- takeoff: all ``|z - takeoff_alt| <`` 0.05 m (`taken_off`);
- the assignment events, passed through.

The windowed means are reduced on the device, and the window's history
crosses chunk boundaries in `SummaryCarry` (the last W-1 samples), which
never visits the host. The CSV's one per-vehicle metric, the EWMA-smoothed
planar distance, is integrated on the device in the same carry and read
back as a trial-cumulative (n,) total per chunk.

`summarize_chunk` reduces batch-major metrics ([B,] T, ...);
`batched_rollout_summary` runs `engine.batched_rollout` and reduces its
(T, B, ...) metrics, so per chunk the host receives (B, T) bools and
(B, n) distances, which `to_host` fetches in two device-to-host copies
for the whole batch.

Metrics of a rollout carrying a fault schedule or a scenario also yield
the recovery clock (`_recovery_clock`): ticks from the last fault or
scenario event to reconvergence, and the accepted reassignments in
between. The reference advances it tick by tick in a scan; here it is a
few whole-chunk operations (the last event's index by a cumulative max,
the first reconvergence after it by a cumulative count), the same
numbers.

A rollout under ``check_mode='on'`` passes its per-tick invariant codes
through (``inv_code``), and one under ``telemetry='on'`` its counters
after the chunk's last tick (``tel``); `to_host` packs both into its two
copies.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from aclswarm_torch.core import types as typeslib
from aclswarm_torch.sim import engine, vehicle
from aclswarm_torch.sim.engine import StepMetrics
from aclswarm_torch.telemetry import device as devtel
from aclswarm_torch.telemetry.device import ChunkTelemetry

# the supervisor's thresholds (`harness.supervisor`), duplicated so the
# device code does not import the host-side harness
ZERO_POS_THR = 0.05
ORIG_ZERO_VEL_THR = 1.00
AVG_ACTIVE_CA_THR = 0.95
EWMA_ALPHA = 0.98


@dataclass
class SummaryCarry:
    """Cross-chunk reduction state (on the device; never read back)."""

    dn_hist: torch.Tensor      # ([B,] W-1, n) trailing |distcmd|
    ca_hist: torch.Tensor      # ([B,] W-1, n) trailing CA-active (float)
    fx: torch.Tensor           # ([B,] n) EWMA-filtered x
    fy: torch.Tensor           # ([B,] n) EWMA-filtered y
    cumdist: torch.Tensor      # ([B,] n) accumulated filtered distance
    inited: torch.Tensor       # ([B,]) bool: EWMA filter seeded?
    # the fault-recovery clock (zeros when no events ride the rollout)
    rec_pending: torch.Tensor  # ([B,]) bool: an event awaits reconvergence
    rec_since: torch.Tensor    # ([B,]) int32 ticks since the last event
    rec_churn: torch.Tensor    # ([B,]) int32 reassignments since then


@dataclass
class ChunkSummary:
    """Per-chunk supervisor observables, batch-major."""

    conv_all: torch.Tensor      # ([B,] T) trailing-W mean |distcmd| < thr
    grid_any: torch.Tensor      # ([B,] T) any trailing-W CA duty > thr
    taken_off: torch.Tensor     # ([B,] T) all |z - takeoff_alt| < thr
    all_flying: torch.Tensor    # ([B,] T) every vehicle FLYING
    auctioned: torch.Tensor     # ([B,] T) pass-through from StepMetrics
    assign_valid: torch.Tensor  # ([B,] T)
    reassigned: torch.Tensor    # ([B,] T)
    cumdist: torch.Tensor       # ([B,] n) EWMA distance, trial-cumulative
    q_dec: torch.Tensor | None  # ([B,] ceil(T/pose_every), n, 3) or None
    # None unless the rollout carried a FaultSchedule / a Scenario
    fault_event: torch.Tensor | None = None     # ([B,] T) pass-through
    n_alive: torch.Tensor | None = None         # ([B,] T) int32
    scen_event: torch.Tensor | None = None      # ([B,] T) pass-through
    # recovery clock outputs, -1 except at the tick recovery completes
    recovery_ticks: torch.Tensor | None = None  # ([B,] T) int32
    fault_churn: torch.Tensor | None = None     # ([B,] T) int32
    # None unless the rollout ran with check_mode / telemetry 'on'
    inv_code: torch.Tensor | None = None        # ([B,] T) int32 codes
    tel: ChunkTelemetry | None = None           # ([B,]) after the chunk


def init_carry(n: int, window: int, dtype=torch.float32, device=None,
               batch: int | None = None) -> SummaryCarry:
    """Fresh reduction state for a trial (or ``batch`` trials) on
    ``device`` (None = the card)."""
    from aclswarm_torch.core.types import resolve_device

    dev = resolve_device(device)
    lead = () if batch is None else (batch,)

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=dev)

    return SummaryCarry(
        dn_hist=zeros((window - 1, n), dtype),
        ca_hist=zeros((window - 1, n), dtype),
        fx=zeros((n,), dtype), fy=zeros((n,), dtype),
        cumdist=zeros((n,), dtype), inited=zeros((), torch.bool),
        rec_pending=zeros((), torch.bool),
        rec_since=zeros((), torch.int32), rec_churn=zeros((), torch.int32))


def _trailing_window_mean(x: torch.Tensor, hist: torch.Tensor, window: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean over the trailing ``window`` ticks for each tick of the chunk:
    ``x`` ([B,] T, n), ``hist`` the ([B,] W-1, n) samples before it.
    Returns (([B,] T, n) means, the new history). Ticks whose window
    reaches before the trial's start average in the zero history; the host
    FSM never reads those (its push counters gate them)."""
    ext = torch.cat([hist, x], dim=-2)                 # ([B,] W-1+T, n)
    csum = torch.cumsum(ext, dim=-2)
    csum = torch.cat([torch.zeros_like(csum[..., :1, :]), csum], dim=-2)
    means = (csum[..., window:, :] - csum[..., :-window, :]) / window
    new_hist = ext[..., ext.shape[-2] - (window - 1):, :]
    return means, new_hist


def _ewma_distance(q: torch.Tensor, carry: SummaryCarry):
    """The EWMA position filter and its planar path length, advanced over
    the chunk's ([B,] T, n, 3) positions one tick at a time on the device.
    Runs from the trial's first tick; the host reads cumulative totals at
    chunk boundaries."""
    f = torch.stack([carry.fx, carry.fy], dim=-1)      # ([B,] n, 2)
    dist, inited = carry.cumdist, carry.inited
    init = inited[..., None, None]
    zero = torch.zeros((), dtype=dist.dtype, device=dist.device)
    for t in range(q.shape[-3]):
        xy = q[..., t, :, :2]
        nf = torch.where(init, EWMA_ALPHA * f + (1 - EWMA_ALPHA) * xy, xy)
        d = nf - f
        dist = dist + torch.where(init[..., 0],
                                  torch.hypot(d[..., 0], d[..., 1]), zero)
        f = nf
        init = torch.ones_like(init)
    if q.shape[-3]:
        inited = torch.ones_like(inited)
    return f[..., 0], f[..., 1], dist, inited


def _recovery_clock(event: torch.Tensor, conv_all: torch.Tensor,
                    reassigned: torch.Tensor, carry: SummaryCarry,
                    min_ticks: int):
    """Time to reconvergence and assignment churn after each event, over
    the chunk's ([B,] T) flags: (recovery_ticks, fault_churn, pending,
    since, churn).

    An event (a dropout or rejoin, a scenario axis flipping) restarts the
    clock and zeroes the churn; events coalesce into one window from the
    LAST one. Recovery completes at the first tick at least ``min_ticks``
    (the supervisor window W) after the event whose windowed convergence
    predicate holds; that tick emits the ticks since the event and the
    accepted reassignments in between, every other tick -1. The
    reference's tick-by-tick scan, as whole-chunk operations."""
    T = event.shape[-1]
    dev = event.device
    t = torch.arange(T, dtype=torch.int64, device=dev)
    # the last event at or before each tick (-1: none in this chunk)
    last = torch.cummax(torch.where(event, t, torch.full_like(t, -1)),
                        dim=-1).values
    seen = last >= 0
    at_last = torch.clamp(last, min=0)
    since = torch.where(seen, t - last,
                        carry.rec_since[..., None].long() + t + 1)
    re = torch.cumsum(reassigned.long(), dim=-1)
    churn = torch.where(seen, re - torch.gather(re, -1, at_last),
                        carry.rec_churn[..., None].long() + re)
    cand = conv_all & ~event & (since >= min_ticks)
    # recovery is the first candidate of its window, if the window is
    # pending (it opened with an event, or the carry was pending)
    nc = torch.cumsum(cand.long(), dim=-1)
    nc_window = nc - torch.where(seen, torch.gather(nc, -1, at_last),
                                 torch.zeros_like(nc))
    pending = seen | carry.rec_pending[..., None]
    done = cand & pending & (nc_window == 1)
    minus1 = torch.full_like(since, -1)
    rec = torch.where(done, since, minus1).to(torch.int32)
    chn = torch.where(done, churn, minus1).to(torch.int32)
    end_pending = pending[..., -1] & (nc_window[..., -1] == 0)
    return (rec, chn, end_pending, since[..., -1].to(torch.int32),
            churn[..., -1].to(torch.int32))


def summarize_chunk(metrics: StepMetrics, carry: SummaryCarry, window: int,
                    takeoff_alt: float, pose_every: int = 0
                    ) -> tuple[ChunkSummary, SummaryCarry]:
    """Reduce batch-major `StepMetrics` (leaves ([B,] T, ...): one trial's
    time-major metrics, or a batch's with the trial axis first) to the
    per-tick supervisor scalars and the cumulative distance. Every tensor
    stays on its device."""
    dn = metrics.distcmd_norm
    ca = metrics.ca_active.to(dn.dtype)
    dn_mean, dn_hist = _trailing_window_mean(dn, carry.dn_hist, window)
    ca_mean, ca_hist = _trailing_window_mean(ca, carry.ca_hist, window)
    fx, fy, cumdist, inited = _ewma_distance(metrics.q, carry)
    conv_all = torch.all(dn_mean < ORIG_ZERO_VEL_THR, dim=-1)
    # the recovery clock keys on the union of the events riding this
    # rollout: fault drops and rejoins, scenario axis flips
    event = metrics.fault_event if metrics.alive is not None else None
    if metrics.scen_event is not None:
        event = metrics.scen_event if event is None \
            else event | metrics.scen_event
    extra = {}
    if event is not None:
        rec, chn, pending, since, churn = _recovery_clock(
            event, conv_all, metrics.reassigned, carry, window)
        extra.update(recovery_ticks=rec, fault_churn=chn)
        if metrics.alive is not None:
            extra.update(fault_event=metrics.fault_event,
                         n_alive=torch.sum(metrics.alive, dim=-1,
                                           dtype=torch.int32))
        if metrics.scen_event is not None:
            extra["scen_event"] = metrics.scen_event
    else:
        pending, since, churn = (carry.rec_pending, carry.rec_since,
                                 carry.rec_churn)
    if metrics.inv_code is not None:
        extra["inv_code"] = metrics.inv_code
    if metrics.tel is not None:
        # the carry after the chunk's last tick
        extra["tel"] = typeslib.tree_map(lambda x: x[..., -1], metrics.tel)
    summary = ChunkSummary(
        conv_all=conv_all,
        grid_any=torch.any(ca_mean > AVG_ACTIVE_CA_THR, dim=-1),
        taken_off=torch.all(
            torch.abs(metrics.q[..., 2] - takeoff_alt) < ZERO_POS_THR,
            dim=-1),
        all_flying=torch.all(metrics.mode == vehicle.FLYING, dim=-1),
        auctioned=metrics.auctioned, assign_valid=metrics.assign_valid,
        reassigned=metrics.reassigned, cumdist=cumdist,
        q_dec=metrics.q[..., ::pose_every, :, :] if pose_every else None,
        **extra)
    new_carry = SummaryCarry(dn_hist=dn_hist, ca_hist=ca_hist, fx=fx, fy=fy,
                             cumdist=cumdist, inited=inited,
                             rec_pending=pending, rec_since=since,
                             rec_churn=churn)
    return summary, new_carry


def batched_rollout_summary(state, carry: SummaryCarry, formation, gains,
                            sparams, cfg,  # torchcheck: device-path
                            n_ticks: int, inputs=None,
                            tick0: int = 0, *, window: int,
                            takeoff_alt: float, pose_every: int = 0):
    """B trials x ``n_ticks`` ticks (`engine.batched_rollout`) reduced per
    trial on the device. Returns ``(state, carry, summary)`` with the
    summary's per-tick leaves (B, T) and ``cumdist`` (B, n): all a trials
    driver reads per chunk (`to_host`)."""
    state, metrics = engine.batched_rollout(state, formation, gains, sparams,
                                            cfg, n_ticks, inputs, tick0)
    # (T, B, ...) -> (B, T, ...)
    batch_major = typeslib.tree_map(lambda x: x.movedim(0, 1), metrics)
    summary, carry = summarize_chunk(batch_major, carry, window, takeoff_alt,
                                     pose_every)
    return state, carry, summary


# the per-tick flags `to_host` packs into its integer copy, in this order
FLAGS = ("conv_all", "grid_any", "taken_off", "all_flying", "auctioned",
         "assign_valid", "reassigned")


def pack(parts: dict, dtype) -> tuple[torch.Tensor, list]:
    """Tensors of any shapes -> one flat ``dtype`` tensor and the layout
    `unpack` needs: one device-to-host copy for all of them."""
    layout = [(k, tuple(v.shape)) for k, v in parts.items()]
    flat = torch.cat([v.reshape(-1).to(dtype) for v in parts.values()])
    return flat, layout


def unpack(flat: np.ndarray, layout: list) -> dict:
    """The host side of `pack`: numpy arrays keyed by name."""
    out, at = {}, 0
    for k, shape in layout:
        size = int(np.prod(shape, dtype=np.int64))
        out[k] = flat[at:at + size].reshape(shape)
        at += size
    return out


def to_host(summary: ChunkSummary) -> dict:
    """The summary on the host in two device-to-host copies: one int32
    copy of the seven ([B,] T) flags, with the invariant codes and the
    integer counters when they ride the summary, and one float copy of
    ``cumdist`` ([B,] n), with ``admm_residual``. Returns numpy arrays
    keyed by field name (flags as bool, ``tel`` as a dict of the counters'
    arrays)."""
    ints = {k: getattr(summary, k) for k in FLAGS}
    floats = {"cumdist": summary.cumdist}
    if summary.inv_code is not None:
        ints["inv_code"] = summary.inv_code
    if summary.tel is not None:
        ints.update({f"tel.{f}": getattr(summary.tel, f)
                     for f in devtel.INT_FIELDS})
        floats["tel.admm_residual"] = summary.tel.admm_residual
    iflat, ilay = pack(ints, torch.int32)
    fflat, flay = pack(floats, summary.cumdist.dtype)
    out = unpack(iflat.cpu().numpy(), ilay)
    out.update(unpack(fflat.cpu().numpy().astype(np.float64), flay))
    for k in FLAGS:
        out[k] = out[k].astype(bool)
    if summary.tel is not None:
        out["tel"] = {f: out.pop(f"tel.{f}") for f in devtel.FIELDS}
    return out

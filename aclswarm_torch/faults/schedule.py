"""Fault scripts as data (port of `aclswarm_tpu/faults/schedule.py`):
per-vehicle dropout/rejoin windows and lossy links.

A fault timeline is a `FaultSchedule` of tensors, never control flow: the
engine evaluates ``alive_at(schedule, tick)`` and ``link_up_at(schedule,
tick)`` as masks of the per-trial tick, so every trial of a batch may
carry a different script. A batch stacks the schedules (a leading (B,)
axis on every tensor) and passes the trials' ticks as a (B,) tensor.

- **Dropout**: vehicle v is alive iff ``tick < drop_tick[v]`` or ``tick >=
  rejoin_tick[v]``. A dead vehicle freezes, publishes no distcmd, casts no
  avoidance sector, leaves the effective adjacency, and neither sends nor
  receives; it keeps owning its formation point (`faults.masking`).
- **Link loss**: ``link_loss[v, w]`` is the per-tick probability that
  receiver v misses sender w. A dropped flood link holds the last value.
  Draws are seeded per trial and redrawn per tick, ``fold_in(key, tick)``
  on JAX's threefry stream (`core.prng`), so the link masks equal the
  reference's bit for bit.

`no_faults` (all alive, lossless) is bit-identical to ``faults=None``
through the engine: every mask applies as a `where` against it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from aclswarm_torch.core import prng
from aclswarm_torch.core.types import resolve_device

NEVER = np.int32(2**31 - 1)


@dataclass
class FaultSchedule:
    """One trial's fault script ([B,] leading axis for a batch).
    ``rejoin_tick`` must exceed ``drop_tick`` to script a window, or be
    `NEVER` to stay down; ``drop_tick == NEVER`` never faults."""

    drop_tick: torch.Tensor    # ([B,] n) int32 tick the vehicle drops
    rejoin_tick: torch.Tensor  # ([B,] n) int32 tick it rejoins
    link_loss: torch.Tensor    # ([B,] n, n) P(receiver v misses sender w)
    key: torch.Tensor          # ([B,] 2) int64 threefry key words

    @property
    def n(self) -> int:
        return self.drop_tick.shape[-1]


def from_numpy(drop_tick, rejoin_tick, link_loss, key, device=None,
               dtype=torch.float32) -> FaultSchedule:
    """A schedule from host arrays (the reference's leaves: int32 ticks,
    float loss, uint32 key words) on ``device`` (None = the card)."""
    dev = resolve_device(device)

    def ints(x, dt):
        return torch.as_tensor(np.asarray(x).astype(np.int64)).to(
            device=dev, dtype=dt)

    return FaultSchedule(
        drop_tick=ints(drop_tick, torch.int32),
        rejoin_tick=ints(rejoin_tick, torch.int32),
        link_loss=torch.as_tensor(np.array(link_loss)).to(
            device=dev, dtype=dtype),
        key=ints(key, torch.int64))


def no_faults(n: int, device=None, dtype=torch.float32) -> FaultSchedule:
    """The identity schedule: everyone alive forever, lossless links."""
    dev = resolve_device(device)
    return FaultSchedule(
        drop_tick=torch.full((n,), int(NEVER), dtype=torch.int32,
                             device=dev),
        rejoin_tick=torch.full((n,), int(NEVER), dtype=torch.int32,
                               device=dev),
        link_loss=torch.zeros((n, n), dtype=dtype, device=dev),
        key=torch.zeros((2,), dtype=torch.int64, device=dev))


def sample_schedule(seed: int, n: int, *, dropout_frac: float = 0.0,
                    drop_tick: int = 0, rejoin_tick: int | None = None,
                    link_loss: float = 0.0, device=None,
                    dtype=torch.float32) -> FaultSchedule:
    """Seeded spec -> schedule: a random ``dropout_frac`` of the fleet drops
    at ``drop_tick`` (rejoining at ``rejoin_tick`` if given), every directed
    link carries a flat ``link_loss`` rate. Host numpy, as the reference
    samples it, so a seed picks the same victims in both packages."""
    rng = np.random.default_rng(seed)
    k = int(round(dropout_frac * n))
    victims = rng.choice(n, size=k, replace=False) if k else np.empty(0, int)
    drops = np.full((n,), NEVER, np.int32)
    drops[victims] = np.int32(drop_tick)
    rejoins = np.full((n,), NEVER, np.int32)
    if rejoin_tick is not None:
        if rejoin_tick <= drop_tick:
            raise ValueError(f"rejoin_tick ({rejoin_tick}) must be > "
                             f"drop_tick ({drop_tick})")
        rejoins[victims] = np.int32(rejoin_tick)
    loss = np.full((n, n), float(link_loss))
    np.fill_diagonal(loss, 0.0)
    kd = np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)
    return from_numpy(drops, rejoins, loss, kd, device=device, dtype=dtype)


def tick_tensor(tick, like: torch.Tensor) -> torch.Tensor:
    """The trials' ticks as an int32 tensor on ``like``'s device: a host
    int (a fill, no copy), or a ([B,]) int tensor there already."""
    if not isinstance(tick, torch.Tensor):
        return torch.full((), int(tick), dtype=torch.int32,  # torchcheck: disable=JC001 a host int here
                          device=like.device)
    return tick.to(torch.int32)


def alive_at(sched: FaultSchedule, tick) -> torch.Tensor:
    """([B,] n) bool alive mask at ``tick`` (a host int, or a ([B,]) int
    tensor of per-trial ticks)."""
    t = tick_tensor(tick, sched.drop_tick)[..., None]
    return (t < sched.drop_tick) | (t >= sched.rejoin_tick)


def link_up_at(sched: FaultSchedule, tick,
               rows: tuple[int, int] | None = None) -> torch.Tensor:
    """([B,] n, n) bool: directed link (receiver v <- sender w) delivered
    this tick: ``uniform(fold_in(key, tick)) >= link_loss``, the
    reference's draw bit for bit; zero loss always delivers.
    ``rows=(lo, hi)``: a schedule holding receivers ``[lo, hi)`` of
    ``link_loss`` (the agent-axis sharding) gets those rows of the whole
    draw."""
    key = prng.fold_in(sched.key, tick_tensor(tick, sched.drop_tick))
    n = sched.link_loss.shape[-1]
    u = prng.uniform(key, (n, n) if rows else sched.link_loss.shape[-2:],
                     sched.link_loss.dtype)
    if rows:
        u = u[..., rows[0]:rows[1], :]
    return u >= sched.link_loss


def fault_event_at(sched: FaultSchedule, tick) -> torch.Tensor:
    """([B,]) bool: any vehicle's alive bit flips at ``tick`` (a dropout or
    a rejoin lands), which (re)starts the recovery clock (`sim.summary`)."""
    t = tick_tensor(tick, sched.drop_tick)
    return torch.any(alive_at(sched, t) != alive_at(sched, t - 1), dim=-1)

"""Per-trial device counters of a rollout (port of
`aclswarm_tpu/telemetry/device.py`).

The evaluation signals — auction/CBAA rounds to consensus, assignment
churn, flood staleness, collision-avoidance activity, ADMM iterations and
residual — live on the device, where a host registry cannot see them
without a read per tick. `ChunkTelemetry` is a carry of ([B,]) tensors
that `sim.step` accumulates when ``SimConfig.telemetry='on'``; the
chunk-final snapshot rides the copies the trial drivers already make per
chunk, so the counters add no device-to-host copy. With ``'off'`` the
carry is absent and the step adds no operation. The carry is a `SimState`
field, so it checkpoints with the state.

Counters (trial-cumulative; a batch carries a leading (B,) axis):

- ``auctions``        auctions taken (gate-passed ticks)
- ``assign_rounds``   solver rounds, summed over auctions: the auction
                      LAP's bid rounds (`AuctionResult.iters`), CBAA's
                      consensus rounds, 0 for Sinkhorn
- ``reassigns``       accepted assignment changes (churn)
- ``ca_ticks``        vehicle-ticks with collision avoidance active, after
                      the flight and fault masks
- ``flood_stale_max`` the largest estimate age (ticks) seen in the
                      localization tables (0 on ground truth)
- ``admm_iters`` / ``admm_residual``  the last dispatch-time gain solve's
                      iterations and final residual, set by the driver
                      from `gains.solve_gains(..., telemetry=True)`
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ChunkTelemetry", "init_telemetry", "to_host", "FIELDS",
           "INT_FIELDS", "ChunkPublisher"]


@dataclass
class ChunkTelemetry:
    """Per-trial counter carry, each leaf ([B,])."""

    auctions: torch.Tensor         # int32
    assign_rounds: torch.Tensor    # int32
    reassigns: torch.Tensor        # int32
    ca_ticks: torch.Tensor         # int32
    flood_stale_max: torch.Tensor  # int32
    admm_iters: torch.Tensor       # int32 (0 = no solve recorded)
    admm_residual: torch.Tensor    # the state's float dtype


# host-facing field order (the reference's)
FIELDS = ("auctions", "assign_rounds", "reassigns", "ca_ticks",
          "flood_stale_max", "admm_iters", "admm_residual")
INT_FIELDS = FIELDS[:-1]


def init_telemetry(batch: int | None = None, dtype=torch.float32,
                   device=None) -> ChunkTelemetry:
    """A zeroed carry on ``device`` (None = the card); the residual in the
    state's ``dtype``."""
    from aclswarm_torch.core.types import resolve_device

    dev = resolve_device(device)
    lead = () if batch is None else (batch,)
    return ChunkTelemetry(
        **{f: torch.zeros(lead, dtype=torch.int32, device=dev)
           for f in INT_FIELDS},
        admm_residual=torch.zeros(lead, dtype=dtype, device=dev))


def to_host(tel, index=None) -> dict:
    """A snapshot of the carry -> a dict of python ints and a float.
    ``tel`` is a `ChunkTelemetry` or a mapping of its fields (tensors or
    numpy arrays); ``index`` selects into a stacked carry (-1: the last
    tick of a (T,)-stacked `StepMetrics.tel`; b: a trial of a summary's
    (B,) snapshot)."""
    out = {}
    for f in FIELDS:
        v = tel[f] if isinstance(tel, dict) else getattr(tel, f)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if index is not None:
            v = v[index]
        out[f] = float(v) if f == "admm_residual" else int(v)
    return out


class ChunkPublisher:
    """Folds chunk-boundary snapshots into a host registry.

    The device counters are trial-cumulative; the registry keeps
    process-cumulative counters and current-level gauges. The publisher
    keeps the last snapshot per trial key and publishes deltas, so the
    counters stay monotone across trials, waves and resumed runs."""

    COUNTERS = ("auctions", "assign_rounds", "reassigns", "ca_ticks")

    def __init__(self, registry, prefix: str = "sim"):
        self._reg = registry
        self._prefix = prefix
        self._last: dict = {}

    def publish(self, key, tel_host: dict) -> None:
        """Fold one snapshot (`to_host` output) for trial ``key``."""
        prev = self._last.get(key, {})
        for f in self.COUNTERS:
            delta = tel_host[f] - prev.get(f, 0)
            if delta > 0:
                self._reg.counter(f"{self._prefix}_{f}_total").inc(delta)
        self._reg.gauge(f"{self._prefix}_flood_stale_max_ticks").set(
            tel_host["flood_stale_max"])
        solve = (tel_host["admm_iters"], tel_host["admm_residual"])
        if tel_host["admm_iters"] and solve != (
                prev.get("admm_iters"), prev.get("admm_residual")):
            # a new dispatch solve landed since the last chunk
            self._reg.histogram(f"{self._prefix}_admm_iters").observe(
                tel_host["admm_iters"])
            self._reg.histogram(f"{self._prefix}_admm_residual").observe(
                tel_host["admm_residual"])
        self._last[key] = dict(tel_host)

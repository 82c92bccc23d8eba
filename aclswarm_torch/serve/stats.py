"""ServeStats: the serving layer's telemetry surface (a copy of
`aclswarm_tpu/serve/stats.py`).

Every `SwarmService` owns a private `MetricsRegistry` and records into it:

- **admission counters**: ``serve_accepted_total``,
  ``serve_rejected_total`` and the ``serve_retry_after_s`` histogram of
  the backpressure hints handed out;
- **lifecycle counters**: completed / failed / preempted / resumed /
  ``serve_deadline_miss_total``;
- **scheduler gauges, sampled at every chunk boundary**:
  ``serve_queue_depth`` and ``serve_bucket_occupancy`` (live jobs /
  max_batch slots), plus ``*_hist`` distributions of both;
- **per-tenant end-to-end latency** histograms
  (``serve_latency_s{tenant=...}``);
- **per-tenant device-time** counters (``serve_device_s{tenant,kind}``):
  each round's device span divided across its occupied batch rows;
- **round spans** (``serve.round`` and its ``serve.round.<stage>``
  children) in the registry's flight recorder.

`ServeStats.of(service)` reduces that registry to one plain-data record;
`.compact()` is the summary a results row embeds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ServeStats"]


@dataclasses.dataclass
class ServeStats:
    """Plain-data snapshot of one service's telemetry registry."""

    counts: dict                 # accepted/rejected/completed/... ints
    queue_depth: int             # last sampled depth (chunk boundary)
    occupancy: float             # last sampled live/max_batch fill
    occupancy_mean: float        # mean over all sampled rounds
    occupancy_p95: float
    queue_depth_mean: float
    queue_depth_p95: float
    latency_s: dict              # tenant -> {count, p50, p95, p99}
    rounds: int                  # scheduler rounds executed
    chunks: int                  # device chunks executed
    spans_recorded: int
    workers: int                 # configured worker slots (fleet size)
    workers_up: int              # slots currently up (worker_up gauges)
    per_worker: dict             # slot -> {up, chunks, occupancy_mean}
    # swarmtrace stream census (journaled services; zeros otherwise):
    # events appended to events.log, appends the filesystem refused
    # (loudly logged), and wall seconds spent appending — the numerator
    # of the trace_soak overhead measurement
    trace_events: int = 0
    trace_lost: int = 0
    trace_spent_s: float = 0.0
    # swarmwatch per-tenant device-time cost accounting
    # tenant -> {kind: seconds},
    # each round's device span attributed across its occupied batch
    # rows (serve_device_s{tenant,kind} counters)
    device_s: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, service) -> "ServeStats":
        reg = service.telemetry
        counts = {}
        for key in ("accepted", "rejected", "completed", "failed",
                    "preempted", "resumed", "deadline_miss",
                    "failover", "requeued", "poisoned"):
            counts[key] = int(reg.counter(f"serve_{key}_total").value)
        occ = reg.histogram("serve_bucket_occupancy_hist")
        dep = reg.histogram("serve_queue_depth_hist")
        occ_row, dep_row = occ.to_row(), dep.to_row()
        lat = {}
        per_worker: dict = {}
        device_s: dict = {}
        for m in reg.metrics():
            if m.name == "serve_device_s" and m.labels.get("tenant"):
                device_s.setdefault(m.labels["tenant"], {})[
                    m.labels.get("kind", "?")] = round(float(m.value), 6)
            elif m.name == "serve_latency_s" and m.labels.get("tenant"):
                row = m.to_row()
                lat[m.labels["tenant"]] = {
                    "count": row["count"],
                    "p50": row.get("p50"), "p95": row.get("p95"),
                    "p99": row.get("p99")}
            elif m.labels.get("worker") is not None:
                w = per_worker.setdefault(
                    m.labels["worker"],
                    {"up": False, "chunks": 0, "occupancy_mean": 0.0})
                if m.name == "serve_worker_up":
                    w["up"] = bool(m.value)
                elif m.name == "serve_worker_chunks_total":
                    w["chunks"] = int(m.value)
                elif m.name == "serve_worker_occupancy_hist":
                    w["occupancy_mean"] = round(float(
                        m.to_row().get("mean", 0.0)), 3)
        with service._lock:
            rounds = int(service.stats.get("rounds", 0))
            chunks = int(service.stats.get("chunks", 0))
        return cls(
            counts=counts,
            queue_depth=int(reg.gauge("serve_queue_depth").value),
            occupancy=float(reg.gauge("serve_bucket_occupancy").value),
            occupancy_mean=float(occ_row.get("mean", 0.0)),
            occupancy_p95=float(occ_row.get("p95", 0.0)),
            queue_depth_mean=float(dep_row.get("mean", 0.0)),
            queue_depth_p95=float(dep_row.get("p95", 0.0)),
            latency_s=lat, rounds=rounds, chunks=chunks,
            spans_recorded=int(reg.recorder.recorded),
            workers=int(reg.gauge("serve_workers_total").value),
            workers_up=sum(1 for w in per_worker.values() if w["up"]),
            per_worker=per_worker,
            trace_events=(service._trace.emitted
                          if service._trace is not None else 0),
            trace_lost=(service._trace.lost
                        if service._trace is not None else 0),
            trace_spent_s=(round(service._trace.spent_s, 6)
                           if service._trace is not None else 0.0),
            device_s=device_s)

    def compact(self) -> dict:
        """The bench-row summary: bucket occupancy, queue depth,
        preemption count, the admission ledger, and the fleet
        provenance (worker count + failover events — a row served by a
        degraded fleet says so) — small enough to ride every structured
        one-line row, degraded ones included."""
        return {
            "occupancy_mean": round(self.occupancy_mean, 3),
            "queue_depth": self.queue_depth,
            "preempted": self.counts.get("preempted", 0),
            "accepted": self.counts.get("accepted", 0),
            "rejected": self.counts.get("rejected", 0),
            "deadline_miss": self.counts.get("deadline_miss", 0),
            "workers": self.workers,
            "failovers": self.counts.get("failover", 0),
        }

    @staticmethod
    def empty_compact() -> dict:
        """The same key set, zeroed — degraded rows where no service
        ever started (probe failure, watchdog) still carry the
        telemetry block so row consumers need no key-presence logic."""
        return {"occupancy_mean": 0.0, "queue_depth": 0, "preempted": 0,
                "accepted": 0, "rejected": 0, "deadline_miss": 0,
                "workers": 0, "failovers": 0}

    def to_row(self) -> dict:
        return dataclasses.asdict(self)

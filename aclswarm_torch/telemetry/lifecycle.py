"""Causal trace context and the request lifecycle-event stream (a copy of
`aclswarm_tpu/telemetry/lifecycle.py`; the reference documents it in
docs/OBSERVABILITY.md).

- **`TraceContext`** — a ``trace_id`` minted once at submit and carried
  through admission, the job, every checkpoint manifest (so it survives
  preemption, a killed process and a migration to another worker) and
  every lifecycle event. One id names the request's whole history.
- **`LifecycleLog`** — one schema'd, append-only event stream (the
  torn-tail-tolerant frame log of `resilience.checkpoint`): every
  request-lifecycle transition is a typed record with a wall-clock and a
  monotonic timestamp plus a per-writer sequence number. Appends are
  serialized under a lock (worker threads must never interleave partial
  frames), and an append failure is logged, never raised into the serve
  path.

The event vocabulary is the schema: `make_event` rejects unknown event
names and missing required fields at write time. File order is causal
order: one process appends serially, and a recovery process appends
strictly after the crashed one stopped.

Stdlib-only imports at module level (the telemetry package contract);
the frame codec is imported at first append or read.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from pathlib import Path
from typing import Optional

__all__ = ["TraceContext", "LifecycleLog", "EVENTS", "FLEET_EVENTS",
           "make_event", "mint_trace_id"]


def mint_trace_id() -> str:
    """A fresh 64-bit hex trace id (the causal-correlation key)."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagated trace identity: ``trace_id`` names the request's
    causal history end to end; ``parent_span`` names the submitting
    span (``client.submit``, ``wire.submit``, a suite cell, ...) so a
    timeline can say who started it."""

    trace_id: str
    parent_span: str = ""

    @staticmethod
    def mint(parent_span: str = "") -> "TraceContext":
        return TraceContext(mint_trace_id(), parent_span)


# ---------------------------------------------------------------------------
# event vocabulary — the schema (required field names per event kind)
#
# Request-scope events carry a request_id + trace_id; fleet-scope events
# (worker death) carry neither. Every event additionally carries the
# envelope: t_wall (epoch s), t_mono (monotonic s — comparable only
# within one pid), seq (per-writer monotonic), pid.

EVENTS: dict[str, frozenset] = {
    # admission
    "submitted": frozenset({"kind", "tenant"}),       # + deadline_s, t_submit
    "admitted": frozenset(),                          # + queue_depth
    "queued": frozenset({"reason"}),
    #                     boundary|preempt|failover|recovery|unowned
    # scheduling / execution
    "batched": frozenset({"worker", "round", "batch"}),   # + bucket, chunk
    "chunk": frozenset({"k", "digest", "worker"}),        # + tick_end, round
    "preempted": frozenset({"chunk"}),                    # + run_chunks
    "checkpointed": frozenset({"chunk", "durable"}),
    # failover / recovery
    "migrated": frozenset({"dead_worker", "chunk"}),      # + failovers
    "resumed": frozenset({"from_chunk"}),                 # + preemptions
    # terminal
    "deadline": frozenset({"chunk"}),                     # + late
    "resolved": frozenset({"status", "chunks"}),
    #                       + latency_s, preemptions, failovers, error_code
    "poisoned": frozenset(),                              # + excluded
    "cancelled": frozenset({"reason"}),
}

# fleet-scope events: no request_id/trace_id (a worker death orphans a
# whole batch; the per-request half of the story is its `migrated` event)
FLEET_EVENTS: dict[str, frozenset] = {
    "failover": frozenset({"worker", "reason", "orphans"}),   # + retired
    # telemetry.slo: one record per alert state-machine transition —
    # state is "firing" or "resolved" ("pending" never emits: a flap
    # that clears before its dwell is suppressed, not archived). labels
    # partitions one SLO into independent alerts (worker_up fires per
    # worker; fleet-scope SLOs use "").
    "alert": frozenset({"slo", "state", "labels"}),
    #                                   + burn_short, burn_long, value
}

TERMINAL_EVENTS = ("resolved",)

_KIND = "serve_event"          # the frame-manifest kind every event uses


def make_event(event: str, *, request_id: Optional[str], trace_id: str,
               seq: int, t_wall: Optional[float] = None,
               t_mono: Optional[float] = None, **fields
               ) -> tuple[dict, dict]:
    """Build one (payload, manifest) event pair, validating the event
    name and its required fields — a record that would be unreadable to
    the postmortem is refused at WRITE time, loudly."""
    fleet = event in FLEET_EVENTS
    required = FLEET_EVENTS.get(event) if fleet else EVENTS.get(event)
    if required is None:
        raise ValueError(
            f"unknown lifecycle event {event!r} (request-scope: "
            f"{sorted(EVENTS)}; fleet-scope: {sorted(FLEET_EVENTS)})")
    missing = required - set(fields)
    if missing:
        raise ValueError(f"lifecycle event {event!r} missing required "
                         f"field(s) {sorted(missing)}")
    if not fleet and not request_id:
        raise ValueError(f"request-scope event {event!r} needs a "
                         "request_id")
    import os
    payload = dict(fields)
    payload["request_id"] = request_id
    payload["trace_id"] = trace_id
    payload["t_wall"] = time.time() if t_wall is None else float(t_wall)
    payload["t_mono"] = (time.monotonic() if t_mono is None
                         else float(t_mono))
    payload["seq"] = int(seq)
    payload["pid"] = os.getpid()
    # manifest: kind + event ride the same slots the reference's
    # worker-ledger records use, so one reader serves both
    from aclswarm_torch.resilience import checkpoint as ckptlib
    manifest = ckptlib.make_manifest(_KIND, "-", 0, "-", event=event,
                                     t_wall=payload["t_wall"])
    return payload, manifest


class LifecycleLog:
    """Thread-safe appender/reader for one journal's lifecycle stream.

    The on-disk format is `resilience.checkpoint.append_frame`'s
    length-prefixed frame log: appends are not atomic, and a crash
    mid-append costs at most the record being written (the reader
    treats exactly that torn tail as clean EOF). Append failures are
    LOGGED, never raised — losing one trace record must not take the
    serve path down with it."""

    def __init__(self, path, log=None):
        self.path = Path(path)
        self.log = log
        self._lock = threading.Lock()
        self._seq = 0
        self._fh = None          # persistent append handle (lazy): the
        #                          hot-path emits run under the service
        #                          lock, and two open/close syscalls per
        #                          event there is pure tax
        self.emitted = 0
        self.lost = 0
        # wall seconds spent inside emit(): the direct measurement of
        # the tracing cost, read against the serve round wall
        self.spent_s = 0.0

    def emit(self, event: str, request_id: Optional[str] = None,
             trace_id: str = "", **fields) -> bool:
        """Append one validated event; returns False (loudly logged)
        when the filesystem refused the append."""
        from aclswarm_torch.resilience import checkpoint as ckptlib
        t0 = time.perf_counter()
        with self._lock:
            try:
                seq = self._seq
                self._seq += 1
                payload, manifest = make_event(
                    event, request_id=request_id, trace_id=trace_id,
                    seq=seq, **fields)
                try:
                    if self._fh is None:
                        self.path.parent.mkdir(parents=True,
                                               exist_ok=True)
                        self._fh = open(self.path, "ab")
                    ckptlib.append_frame(self.path, payload, manifest,
                                         fh=self._fh)
                except OSError as e:
                    self.lost += 1
                    if self.log is not None:
                        self.log.warning(
                            "lifecycle log append failed (%s) — the %s "
                            "record for %s is lost to the trace", e,
                            event, request_id or "<fleet>")
                    return False
                self.emitted += 1
                return True
            finally:
                self.spent_s += time.perf_counter() - t0

    def close(self) -> None:
        """Release the persistent handle (clean service shutdown); a
        later emit reopens lazily — the stream itself has no end."""
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    @staticmethod
    def read(path) -> tuple[list[dict], bool]:
        """Every event of a lifecycle log in causal (file) order, each
        flattened to one dict with the ``event`` name merged in;
        returns ``(rows, torn_tail)``."""
        from aclswarm_torch.resilience import checkpoint as ckptlib
        frames, torn = ckptlib.read_frame_log(path)
        rows = []
        for payload, man in frames:
            row = dict(payload) if isinstance(payload, dict) else {}
            row["event"] = man.get("event")
            row.setdefault("t_wall", man.get("t_wall"))
            rows.append(row)
        return rows, torn

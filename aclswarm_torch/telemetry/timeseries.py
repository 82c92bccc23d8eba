"""Time series for the health tier (a copy of
`aclswarm_tpu/telemetry/timeseries.py`): bounded in-memory history over
the metrics registry, fed by a cadenced sampler thread, persisted
through the resilience frame log.

The registry (`telemetry.registry`) answers "what is the value now";
this module keeps how it evolved, so an operator can tell a 30-second
stall from a healthy idle and an SLO can be evaluated over a window:

- **`TimeSeriesStore`** — named series of ``(t_wall, value)`` points in
  bounded rings (`done_retention` discipline: an always-on service must
  not grow per-sample state without bound). Windowed reads
  (`window`, `latest`) plus the two derived quantities every SLO needs:
  `window_delta` (reset-tolerant counter increase over a window — a
  worker restart zeroes its process counters, and the delta must read
  that as a RESET, not as negative progress) and `rate` (delta/span).
- **`Sampler`** — a daemon thread that snapshots one `MetricsRegistry`
  every ``interval_s``: counters and gauges land under their snapshot
  key, histograms land as ``key:count`` / ``key:p99`` (the percentile
  series per-tenant SLOs read). Each tick optionally appends ONE frame
  to a ``timeseries.log`` through `resilience.checkpoint.append_frame`
  — the same torn-tail-tolerant codec the journal uses — so the whole
  history survives SIGKILL and `load_store` can rebuild it from disk
  alone. The sampler self-measures (``spent_s``): its cost read
  directly against the serve wall.

Stdlib-only at module level (the telemetry package contract); the
frame codec is imported lazily at first persist/load.
"""
from __future__ import annotations

import math
import threading
import time
from pathlib import Path
from typing import Callable, Optional

__all__ = ["TimeSeriesStore", "Sampler", "load_store", "read_ticks",
           "PERSIST_KIND"]

PERSIST_KIND = "watch_sample"      # frame-manifest kind of one sample tick


class _Series:
    """One bounded ring of (t, v) points (newest ``cap`` retained)."""

    __slots__ = ("ring", "next", "count")

    def __init__(self):
        self.ring: list = []
        self.next = 0
        self.count = 0          # total points ever appended

    def append(self, cap: int, t: float, v: float) -> None:
        if len(self.ring) < cap:
            self.ring.append((t, v))
        else:
            self.ring[self.next] = (t, v)
        self.next = (self.next + 1) % cap
        self.count += 1

    def points(self) -> list:
        """Time-ordered points (the ring is appended in time order, so
        oldest-first is [next:] + [:next] once wrapped)."""
        if self.count <= len(self.ring):
            return list(self.ring)
        return self.ring[self.next:] + self.ring[:self.next]


class TimeSeriesStore:
    """Thread-safe bounded store of named time series."""

    def __init__(self, capacity: int = 1024):
        if capacity < 2:
            raise ValueError("time-series capacity must be >= 2 (deltas "
                             "need two points)")
        self._cap = int(capacity)
        self._series: dict[str, _Series] = {}
        self._lock = threading.Lock()
        self.dropped = 0        # points evicted by ring wraparound

    @property
    def capacity(self) -> int:
        return self._cap

    def append(self, name: str, t: float, value: float) -> None:
        v = float(value)
        if not math.isfinite(v):
            return                    # a NaN sample poisons every window
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series()
            if len(s.ring) >= self._cap:
                self.dropped += 1
            s.append(self._cap, float(t), v)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def points(self, name: str) -> list:
        """Time-ordered (t, v) points of one series ([] if unknown)."""
        with self._lock:
            s = self._series.get(name)
            return s.points() if s is not None else []

    def latest(self, name: str):
        """(t, v) of the newest point, or None. O(1): the SLO
        evaluators read `latest` for many series on every sampler tick
        — copying the whole ring to take its last element would count
        straight against the <2% overhead bar."""
        with self._lock:
            s = self._series.get(name)
            if s is None or not s.ring:
                return None
            return s.ring[(s.next - 1) % len(s.ring)]

    def window(self, name: str, span_s: float,
               now: Optional[float] = None) -> list:
        """Points with t >= now - span_s (time-ordered)."""
        pts = self.points(name)
        if not pts:
            return []
        t1 = pts[-1][0] if now is None else float(now)
        t0 = t1 - float(span_s)
        return [p for p in pts if p[0] >= t0]

    @staticmethod
    def _delta(pts: list) -> float:
        """Reset-tolerant counter increase over already-windowed
        points: the sum of positive steps, where a DROP reads as a
        counter reset (a restarted worker process starts its counters
        at zero) and contributes the post-reset value — never a
        negative delta that would erase pre-restart progress::

            samples 0, 5, 9, 2, 4  ->  5 + 4 + 2 + 2 = 13
        """
        total = 0.0
        prev = pts[0][1]
        for _, v in pts[1:]:
            total += (v - prev) if v >= prev else v
            prev = v
        return total

    def window_delta(self, name: str, span_s: float,
                     now: Optional[float] = None) -> Optional[float]:
        """Reset-tolerant counter increase over the window (`_delta`).
        Returns None when the window holds fewer than 2 points (no
        delta is honest — 0.0 would claim "nothing happened")."""
        pts = self.window(name, span_s, now)
        if len(pts) < 2:
            return None
        return self._delta(pts)

    def rate(self, name: str, span_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Reset-tolerant counter rate over the window (delta / actual
        covered span, from ONE window scan — this runs per-series per
        sampler tick). None when underdetermined."""
        pts = self.window(name, span_s, now)
        if len(pts) < 2:
            return None
        dt = pts[-1][0] - pts[0][0]
        if dt <= 0:
            return None
        return self._delta(pts) / dt


# ---------------------------------------------------------------------------
# registry -> store sampling

# histogram row fields sampled as sub-series (`key:count` is cumulative
# — counter semantics; the percentile fields are levels)
_HIST_FIELDS = ("count", "sum", "p50", "p95", "p99")


def _snapshot_series(registry) -> dict[str, float]:
    """Flatten one registry snapshot into {series: value} (the sampler's
    unit of work; also the persisted frame payload's ``v`` map)."""
    out: dict[str, float] = {}
    snap = registry.snapshot()
    for key, row in snap["metrics"].items():
        kind = row.get("kind")
        if kind in ("counter", "gauge"):
            v = row.get("value")
            if isinstance(v, (int, float)) and math.isfinite(v):
                out[key] = float(v)
        elif kind == "histogram":
            for f in _HIST_FIELDS:
                v = row.get(f)
                if isinstance(v, (int, float)) and math.isfinite(v):
                    out[f"{key}:{f}"] = float(v)
    out["spans_recorded_total"] = float(snap.get("spans_recorded", 0))
    out["spans_dropped_total"] = float(snap.get("spans_dropped", 0))
    return out


class Sampler:
    """Cadenced registry sampler (daemon thread) feeding one store.

    ``probe`` (optional) runs first each tick — the service uses it to
    refresh liveness gauges (queue depth, in-flight count) so the
    sampled values are current, not boundary-stale. ``on_sample(now)``
    runs after the tick's points land — the SLO engine's evaluation
    hook, so sampling and evaluation share one cadence AND one
    ``spent_s`` self-measurement (the overhead number the committed
    artifact enforces covers the whole watch path)."""

    def __init__(self, registry, store: TimeSeriesStore, *,
                 interval_s: float = 0.25, persist_path=None,
                 probe: Optional[Callable[[], None]] = None,
                 on_sample: Optional[Callable[[float], None]] = None,
                 log=None):
        if interval_s <= 0:
            raise ValueError("sampler interval_s must be > 0")
        self.registry = registry
        self.store = store
        self.interval_s = float(interval_s)
        self.persist_path = (Path(persist_path)
                             if persist_path is not None else None)
        self.probe = probe
        self.on_sample = on_sample
        self.log = log
        self.samples = 0          # ticks taken
        self.lost = 0             # persist appends the filesystem refused
        self.spent_s = 0.0        # wall spent inside tick() — the
        #                           overhead numerator (trace_soak idiom)
        self._fh = None           # persistent append handle (lazy)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------- sampling

    def tick(self, now: Optional[float] = None) -> dict[str, float]:
        """Take one sample NOW (the thread calls this on cadence; tests
        call it directly for determinism). Returns the {series: value}
        map that landed."""
        t0 = time.perf_counter()
        try:
            t = time.time() if now is None else float(now)
            if self.probe is not None:
                try:
                    self.probe()
                except Exception as e:      # noqa: BLE001 — keep sampling
                    if self.log is not None:
                        self.log.warning("watch probe failed (%s) — tick "
                                         "sampled without it", e)
            values = _snapshot_series(self.registry)
            for name, v in values.items():
                self.store.append(name, t, v)
            self.samples += 1
            if self.persist_path is not None:
                self._persist(t, values)
            if self.on_sample is not None:
                try:
                    self.on_sample(t)
                except Exception as e:      # noqa: BLE001 — keep sampling
                    if self.log is not None:
                        self.log.warning(
                            "watch on_sample hook failed (%s) — the "
                            "sampler keeps its cadence", e)
            return values
        finally:
            self.spent_s += time.perf_counter() - t0

    def _persist(self, t: float, values: dict) -> None:
        """Append one sample frame (torn-tail-tolerant stream — the
        lifecycle-log discipline: losing one tick to a crash or a full
        disk is loud, never fatal to the serve path)."""
        from aclswarm_torch.resilience import checkpoint as ckptlib
        payload = {"t": t, "v": values}
        man = ckptlib.make_manifest(PERSIST_KIND, "-", fingerprint="-",
                                    chunk=self.samples, t_wall=t)
        with self._lock:
            try:
                if self._fh is None:
                    self.persist_path.parent.mkdir(parents=True,
                                                   exist_ok=True)
                    self._fh = open(self.persist_path, "ab")
                ckptlib.append_frame(self.persist_path, payload, man,
                                     fh=self._fh)
            except OSError as e:
                self.lost += 1
                if self.log is not None:
                    self.log.warning("time-series persist to %s failed "
                                     "(%s) — this tick is memory-only",
                                     self.persist_path, e)

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        """Launch the cadenced thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="swarmwatch-sampler")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:          # noqa: BLE001 — a sampler
                # bug must never take the service down; log and keep
                # the cadence (the store simply misses this tick)
                if self.log is not None:
                    self.log.error("watch sampler tick failed: %s", e)

    def stop(self, final_tick: bool = True) -> None:
        """Stop the thread (joins), take one final sample so the
        persisted history covers the shutdown edge, and release the
        persist handle."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)
        self._thread = None
        if final_tick:
            try:
                self.tick()
            except Exception:               # noqa: BLE001 — best effort
                pass
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_ticks(path) -> tuple[list, bool]:
    """Decode a persisted ``timeseries.log`` into time-ordered
    ``(t, {series: value})`` sample ticks plus the torn-tail flag —
    THE one home for the on-disk tick contract (`load_store` rebuilds
    a store from it; the watch CLI's replay re-evaluates SLOs over
    it). A torn trailing frame (crash mid-append) is clean EOF; frames
    of other kinds or malformed payloads are skipped, not fatal."""
    from aclswarm_torch.resilience import checkpoint as ckptlib
    frames, torn = ckptlib.read_frame_log(path)
    ticks: list = []
    for payload, man in frames:
        if man.get("kind") != PERSIST_KIND or not isinstance(payload,
                                                             dict):
            continue                 # one log, one kind — skip strangers
        t = payload.get("t")
        vals = payload.get("v")
        if not isinstance(t, (int, float)) or not isinstance(vals, dict):
            continue
        ticks.append((float(t),
                      {str(k): float(v) for k, v in vals.items()
                       if isinstance(v, (int, float))}))
    return ticks, torn


def load_store(path, capacity: int = 4096
               ) -> tuple[TimeSeriesStore, int, bool]:
    """Rebuild a `TimeSeriesStore` from a persisted ``timeseries.log``
    alone (the postmortem path: the process that sampled it may be
    SIGKILLed and gone). Returns ``(store, ticks, torn_tail)``."""
    store = TimeSeriesStore(capacity=capacity)
    ticks, torn = read_ticks(path)
    for t, vals in ticks:
        for name, v in vals.items():
            store.append(name, t, v)
    return store, len(ticks), torn

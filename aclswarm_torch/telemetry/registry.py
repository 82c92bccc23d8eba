"""Host-side metrics registry (a copy of `aclswarm_tpu/telemetry/registry.py`;
the reference documents it in docs/OBSERVABILITY.md).

The paper's whole evaluation is built on signals (convergence time,
assignment churn, auction round counts, serve latency) that every
subsystem previously surfaced through its own ad-hoc dict — `bench.py`
rows, `SwarmService.stats`, suite JSON. This module is the one
measurement substrate they all report through:

- **Counter**: monotone event count (`inc`). Admission accepts,
  preemptions, log records, auctions.
- **Gauge**: last-write-wins level (`set`/`add`). Queue depth, bucket
  occupancy, flood staleness.
- **Histogram**: bounded-reservoir distribution (`observe`) with exact
  count/sum/min/max and p50/p95/p99 estimated over the newest
  ``reservoir`` samples (a ring — an always-on service must not grow
  per-observation state without bound, the `done_retention` rule
  applied to measurement). Per-tenant latency, timing reps, span
  durations.

Exports: `snapshot()` (one plain dict, safe to json.dumps),
`to_jsonl()` / `dump()` (JSON-lines, one metric per line + one line per
flight-recorder span), and `prometheus_text()` (text exposition format
with proper label escaping) — the three formats every scrape/commit
path needs.

Thread-safety: serve is multithreaded (client threads submit while the
worker resolves), so every mutation takes the owning metric's lock and
`snapshot` takes each lock briefly per metric — a snapshot taken during
a storm of updates is internally consistent per metric and never tears
a histogram's (count, sum, reservoir) triple.

Pure stdlib on purpose: the trial driver imports it whatever device
the trial runs on.
"""
from __future__ import annotations

import json
import math
import threading
import time
from typing import Iterable, Optional

from aclswarm_torch.telemetry.spans import FlightRecorder, Span
from aclswarm_torch.utils.locks import OrderedLock

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "reset_registry"]

_PCTS = (50.0, 95.0, 99.0)


def _quantile(data: list, p: float) -> float:
    """Linear interpolation between order statistics (numpy's default
    'linear' method) over an already-sorted sample.

    Nearest-rank aliases the tail at small
    counts: at n=15 both p95 and p99 land on the same order statistic,
    so every committed small-count artifact reported p95_s == p99_s —
    a made-up equality. Interpolating keeps p99 strictly between p95
    and the observed max whenever the top samples differ, and still
    converges to nearest-rank as n grows."""
    if len(data) == 1:
        return data[0]
    pos = p / 100.0 * (len(data) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(data) - 1)
    return data[lo] + (data[hi] - data[lo]) * (pos - lo)


def _label_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((str(k), str(v))
                        for k, v in (labels or {}).items()))


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped (the exposition-format spec)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _sanitize_name(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return out or "_"


class _Metric:
    kind = "metric"

    def __init__(self, name: str, labels: Optional[dict] = None,
                 help: str = ""):
        self.name = name
        self.labels = dict(labels or {})
        self.help = help
        # registry=None on purpose: a metric lock observing its own
        # hold time into a histogram guarded by a metric lock recurses
        self._lock = OrderedLock("telemetry.metric")

    def _ident(self) -> dict:
        d = {"name": self.name, "kind": self.kind}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class Counter(_Metric):
    """Monotone event counter. `inc(k)` with k < 0 raises — a counter
    that can go down is a gauge wearing the wrong name, and downstream
    rate math would silently mis-read it."""

    kind = "counter"

    def __init__(self, name, labels=None, help=""):
        super().__init__(name, labels, help)
        self._value = 0

    def inc(self, amount: int | float = 1) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (inc {amount});"
                " use a Gauge for levels")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value

    def to_row(self) -> dict:
        return dict(self._ident(), value=self.value)


class Gauge(_Metric):
    """Last-write-wins level."""

    kind = "gauge"

    def __init__(self, name, labels=None, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def to_row(self) -> dict:
        return dict(self._ident(), value=self.value)


class Histogram(_Metric):
    """Bounded-reservoir distribution: exact count/sum/min/max over
    every observation, percentiles over the newest ``reservoir``
    samples (a ring buffer — O(reservoir) memory forever, so an
    always-on service can observe per-request latency indefinitely).
    """

    kind = "histogram"

    def __init__(self, name, labels=None, help="", reservoir: int = 512):
        super().__init__(name, labels, help)
        if reservoir < 1:
            raise ValueError(f"histogram {name!r} reservoir must be >= 1")
        self._cap = int(reservoir)
        self._ring: list[float] = []
        self._next = 0            # ring write cursor
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._ring) < self._cap:
                self._ring.append(v)
            else:
                self._ring[self._next] = v
            self._next = (self._next + 1) % self._cap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def percentiles(self, pcts: Iterable[float] = _PCTS) -> dict:
        """{"p50": ..., ...} over the reservoir (NaN-free: {} when no
        observation has landed yet)."""
        with self._lock:
            data = sorted(self._ring)
        if not data:
            return {}
        return {f"p{p:g}": _quantile(data, p) for p in pcts}

    def to_row(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            data = sorted(self._ring)
        row = dict(self._ident(), count=count, sum=total)
        if count:
            row["min"] = mn
            row["max"] = mx
            row["mean"] = total / count
            for p in _PCTS:
                row[f"p{p:g}"] = _quantile(data, p)
        return row


class MetricsRegistry:
    """Get-or-create home for metrics + the span flight recorder.

    One instance per measurement domain: the process-wide default
    (`get_registry`) for the sim/trials/bench stack, one per
    `SwarmService` so concurrent services (tests, soak reference runs)
    never cross-pollute counters.
    """

    def __init__(self, spans: int = 1024):
        self._lock = OrderedLock("telemetry.registry")
        self._metrics: dict[tuple, _Metric] = {}    # guarded-by: _lock
        self.recorder = FlightRecorder(capacity=spans)

    # ------------------------------------------------------------ create

    def _get(self, cls, name, labels, **kw):
        key = (cls.kind, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):     # pragma: no cover — keyed
                raise TypeError(f"{name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str, labels: Optional[dict] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, labels: Optional[dict] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  help: str = "", reservoir: int = 512) -> Histogram:
        return self._get(Histogram, name, labels, help=help,
                         reservoir=reservoir)

    # ------------------------------------------------------------- spans

    def span(self, name: str, **attrs):
        """Context manager: times a block into the flight recorder AND
        observes the duration into the ``span_<name>_s`` histogram —
        traces and metrics agree by construction::

            with registry.span("serve.round", batch=4):
                ...
        """
        return _SpanCtx(self, name, attrs)

    def spans(self) -> list[Span]:
        return self.recorder.spans()

    # ----------------------------------------------------------- exports

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """One plain-data dict of every metric (json.dumps-safe), plus
        the flight-recorder census. Keys are ``name{k=v,...}``."""
        out: dict = {"metrics": {}, "spans_recorded": 0,
                     "spans_dropped": 0}
        for m in self.metrics():
            key = m.name
            if m.labels:
                key += "{" + ",".join(
                    f"{k}={v}" for k, v in sorted(m.labels.items())) + "}"
            out["metrics"][key] = m.to_row()
        out["spans_recorded"] = self.recorder.recorded
        out["spans_dropped"] = self.recorder.dropped
        return out

    def to_jsonl(self) -> str:
        """JSON-lines export: one line per metric, a span-census line
        (recorded/dropped — ring drops under load must be first-class,
        not silent), then one per retained span (the artifact format
        `check_results.py` understands)."""
        lines = [json.dumps(m.to_row(), sort_keys=True)
                 for m in self.metrics()]
        lines.append(json.dumps(
            {"name": "spans_dropped_total", "kind": "counter",
             "value": self.recorder.dropped,
             "recorded": self.recorder.recorded}, sort_keys=True))
        lines += [json.dumps(s.to_row(), sort_keys=True)
                  for s in self.spans()]
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, path) -> None:
        from pathlib import Path
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_jsonl())

    def prometheus_text(self) -> str:
        """Text exposition format. Histograms export ``_count``/``_sum``
        plus quantile series (reservoir-estimated, in the summary-type
        idiom); label values are escaped per the format spec."""
        lines: list[str] = []
        for m in self.metrics():
            name = _sanitize_name(m.name)
            if m.help:
                lines.append(f"# HELP {name} {_escape_help(m.help)}")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {name} summary")
                row = m.to_row()
                for p in _PCTS:
                    key = f"p{p:g}"
                    if key in row:
                        lines.append(
                            f"{name}{_fmt_labels(m.labels, quantile=p / 100.0)}"
                            f" {_fmt_num(row[key])}")
                lines.append(f"{name}_count{_fmt_labels(m.labels)} "
                             f"{row['count']}")
                lines.append(f"{name}_sum{_fmt_labels(m.labels)} "
                             f"{_fmt_num(row['sum'])}")
            else:
                lines.append(f"# TYPE {name} {m.kind}")
                lines.append(f"{name}{_fmt_labels(m.labels)} "
                             f"{_fmt_num(m.value)}")
        # flight-recorder census: a scraper must see span LOSS, not just
        # the spans that survived the ring — otherwise a wrapped ring
        # under load reads as "all quiet" exactly when it is lossy
        lines.append("# TYPE spans_recorded_total counter")
        lines.append(f"spans_recorded_total {self.recorder.recorded}")
        lines.append("# TYPE spans_dropped_total counter")
        lines.append(f"spans_dropped_total {self.recorder.dropped}")
        return "\n".join(lines) + "\n"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict, quantile: Optional[float] = None) -> str:
    items = [(k, str(v)) for k, v in sorted(labels.items())]
    if quantile is not None:
        items.append(("quantile", f"{quantile:g}"))
    if not items:
        return ""
    body = ",".join(f'{_sanitize_name(k)}="{_escape_label(v)}"'
                    for k, v in items)
    return "{" + body + "}"


def _fmt_num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _SpanCtx:
    def __init__(self, registry: MetricsRegistry, name: str, attrs: dict):
        self._reg = registry
        self._name = name
        self._attrs = attrs
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        self._reg.recorder.record(
            Span(name=self._name, t_wall=time.time(), dur_s=dur,
                 attrs=dict(self._attrs, error=True) if exc_type
                 else dict(self._attrs)))
        self._reg.histogram(f"span_{self._name}_s").observe(dur)
        return False


# ---------------------------------------------------------------------------
# process-wide default registry (the sim/trials/bench measurement domain)

_DEFAULT = MetricsRegistry()
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (`utils.log` counts records
    into it, `utils.timing.timing_stats` feeds named histograms, the
    trial drivers publish device chunk counters)."""
    return _DEFAULT


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh default registry and return it (test isolation;
    holders of the old instance keep a consistent but detached view)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
        return _DEFAULT

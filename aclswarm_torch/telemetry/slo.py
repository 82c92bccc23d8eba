"""SLO engine of the health tier (a copy of
`aclswarm_tpu/telemetry/slo.py`): a declarative SLO registry evaluated
by a multi-window burn-rate engine with a pending -> firing -> resolved
alert state machine.

It evaluates the serving objectives (zero silent losses, goodput
floors, p99 bounds, worker liveness) continuously over the
`TimeSeriesStore` history, so a dead worker shows while it is dead and
not only in the journal afterwards:

- **catalog** (`default_slos`): availability (completed over
  window-terminated work), p99 latency bound, goodput floor,
  silent-loss == 0 (promises outstanding while nothing is queued,
  in flight, or resolving), per-worker ``worker_up``, and
  queue-saturation — each a plain-data `SloSpec` row, so services and
  tests can extend or re-parameterize the registry declaratively.
- **multi-window burn rate**: each evaluation produces an error
  fraction in [0, 1]; the engine averages it over a LONG and a SHORT
  window and divides by the SLO's error budget — the Google-SRE
  multi-window multi-burn-rate pattern, scaled to serving seconds.
  ``mode="burn"`` SLOs (availability, goodput) breach only when BOTH
  windows burn past the threshold (fast detection without paging on a
  single bad sample); ``mode="level"`` SLOs (worker_up, silent_loss,
  p99, queue_saturation) breach on the instantaneous condition and
  rely on the state machine's dwell times for flap suppression.
- **alert state machine**: ok -> pending (breach observed) -> firing
  (breach sustained ``for_s``) -> resolved (clear sustained
  ``clear_s``) -> ok. A pending alert whose breach clears before
  ``for_s`` never fires (flap suppression); a firing alert's clear
  clock resets on every re-breach. Transitions are appended to the
  service's `LifecycleLog` as schema'd ``alert`` fleet events, so the
  postmortem surface and the live surface share one stream.

`SwarmWatch` composes the store + `timeseries.Sampler` + engine for
one service: sampling and evaluation share a cadence and one
``spent_s`` self-measurement (the tier's own cost).

Stdlib-only at module level (the telemetry package contract).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from aclswarm_torch.telemetry.timeseries import Sampler, TimeSeriesStore

__all__ = ["SloSpec", "SloEngine", "SwarmWatch", "default_slos",
           "OK", "PENDING", "FIRING"]

# alert states (the machine's vocabulary; "resolved" is a TRANSITION
# back to OK, recorded in the event stream, not a resting state)
OK = "ok"
PENDING = "pending"
FIRING = "firing"


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative SLO row.

    ``kind`` picks the evaluator (the catalog below); ``params`` its
    thresholds. ``mode`` picks the breach rule: ``"burn"`` = both
    windows' burn rates past ``burn_threshold``; ``"level"`` = the
    instantaneous error is total (>= 1.0). ``budget`` is the error
    budget the burn rate divides by (for availability-style SLOs,
    1 - objective)."""

    name: str
    kind: str                     # availability|p99|goodput|silent_loss|
    #                               worker_up|queue_saturation
    description: str = ""
    mode: str = "level"           # "burn" | "level"
    budget: float = 0.05          # error budget (burn denominator)
    burn_threshold: float = 2.0   # burn rate that breaches (mode=burn)
    window_s: float = 30.0        # long window
    short_s: float = 5.0          # short window
    for_s: float = 0.0            # breach dwell before pending -> firing
    clear_s: float = 2.0          # clear dwell before firing -> resolved
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.mode not in ("burn", "level"):
            raise ValueError(f"SLO {self.name!r}: mode must be 'burn' or"
                             f" 'level', got {self.mode!r}")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"SLO {self.name!r}: budget must be in "
                             f"(0, 1], got {self.budget!r}")
        if self.short_s > self.window_s:
            raise ValueError(f"SLO {self.name!r}: short_s "
                             f"({self.short_s}) must not exceed window_s"
                             f" ({self.window_s})")


def default_slos(*, max_queue_total: int = 32,
                 availability_objective: float = 0.95,
                 p99_bound_s: float = 60.0,
                 goodput_floor_hz: float = 0.0,
                 saturation_frac: float = 0.9,
                 window_s: float = 30.0, short_s: float = 5.0
                 ) -> list[SloSpec]:
    """The serving SLO catalog, as live declarative rows.
    ``goodput_floor_hz=0`` keeps the goodput SLO trivially green (no
    floor configured); services with a measured capacity set a real
    floor."""
    return [
        SloSpec(
            name="availability", kind="availability", mode="burn",
            budget=max(1e-6, 1.0 - availability_objective),
            burn_threshold=2.0, window_s=window_s, short_s=short_s,
            for_s=0.0, clear_s=2.0,
            description="completed / work reaching a terminal verdict "
                        "in the window (in-flight work is not yet "
                        "evidence either way)"),
        SloSpec(
            name="latency_p99", kind="p99", mode="level",
            budget=0.1, window_s=window_s, short_s=short_s,
            for_s=short_s, clear_s=2.0,
            params={"bound_s": float(p99_bound_s)},
            description="worst per-tenant p99 accept->terminal latency "
                        "under the bound"),
        SloSpec(
            name="goodput", kind="goodput", mode="burn",
            budget=0.1, burn_threshold=2.0,
            window_s=window_s, short_s=short_s, for_s=short_s,
            clear_s=2.0, params={"floor_hz": float(goodput_floor_hz)},
            description="completed-request rate holds the configured "
                        "floor while load is offered"),
        SloSpec(
            name="silent_loss", kind="silent_loss", mode="level",
            budget=1e-6, window_s=window_s, short_s=short_s,
            for_s=1.0, clear_s=1.0,
            description="accepted promises outstanding while nothing "
                        "is queued, in flight, or resolving — work "
                        "vanished (the one forbidden outcome)"),
        SloSpec(
            name="worker_up", kind="worker_up", mode="level",
            budget=1e-6, window_s=window_s, short_s=short_s,
            for_s=0.0, clear_s=0.5,
            description="every supervised worker slot is up (one alert "
                        "per worker label; a kill fires it, the "
                        "backoff-gated rejoin resolves it)"),
        SloSpec(
            name="queue_saturation", kind="queue_saturation",
            mode="level", budget=0.1, window_s=window_s,
            short_s=short_s, for_s=short_s, clear_s=2.0,
            params={"cap": int(max_queue_total),
                    "frac": float(saturation_frac)},
            description="admission queue depth sustained at >= "
                        "saturation_frac of the global cap"),
    ]


# ---------------------------------------------------------------------------
# evaluators: spec -> [(label_key, err in [0,1], observed value)]
#
# err is the INSTANTANEOUS error fraction this tick; the engine owns
# the windowing. label_key partitions one spec into independent alerts
# (worker_up fires per worker; everything else is fleet-scope "").

def _eval_availability(store, spec, now):
    w = spec.window_s
    comp = store.window_delta("serve_completed_total", w, now)
    fail = store.window_delta("serve_failed_total", w, now) or 0.0
    miss = store.window_delta("serve_deadline_miss_total", w, now) or 0.0
    if comp is None:
        comp = 0.0
    terminated = comp + fail + miss
    if terminated <= 0:
        return [("", 0.0, 1.0)]       # nothing reached a verdict: green
    avail = comp / terminated
    return [("", max(0.0, 1.0 - avail), avail)]


def _eval_p99(store, spec, now):
    bound = float(spec.params.get("bound_s", 60.0))
    worst = None
    for name in store.names():
        if name.startswith("serve_latency_s") and name.endswith(":p99"):
            pt = store.latest(name)
            if pt is not None and (worst is None or pt[1] > worst):
                worst = pt[1]
    if worst is None:
        return [("", 0.0, 0.0)]
    return [("", 1.0 if worst > bound else 0.0, worst)]


def _eval_goodput(store, spec, now):
    floor = float(spec.params.get("floor_hz", 0.0))
    acc = store.rate("serve_accepted_total", spec.window_s, now)
    good = store.rate("serve_completed_total", spec.window_s, now)
    if acc is None or acc <= 0:
        return [("", 0.0, good or 0.0)]   # no offered load: green
    good = good or 0.0
    if floor <= 0:
        return [("", 0.0, good)]
    return [("", 1.0 if good < floor else 0.0, good)]


def _eval_silent_loss(store, spec, now):
    def _latest(name, default=None):
        pt = store.latest(name)
        return pt[1] if pt is not None else default
    acc = _latest("serve_accepted_total")
    if acc is None:
        return [("", 0.0, 0.0)]
    terms = sum(_latest(f"serve_{k}_total", 0.0)
                for k in ("completed", "failed", "deadline_miss"))
    outstanding = acc - terms
    depth = _latest("serve_queue_depth", 0.0)
    inflight = _latest("serve_inflight", 0.0)
    lost = outstanding > 0 and depth <= 0 and inflight <= 0
    return [("", 1.0 if lost else 0.0, max(0.0, outstanding))]


def _eval_worker_up(store, spec, now):
    out = []
    for name in store.names():
        if name.startswith("serve_worker_up{"):
            pt = store.latest(name)
            if pt is None:
                continue
            label = name[len("serve_worker_up"):]
            out.append((label, 0.0 if pt[1] >= 1.0 else 1.0, pt[1]))
    return out or [("", 0.0, 1.0)]


def _eval_queue_saturation(store, spec, now):
    cap = max(1, int(spec.params.get("cap", 32)))
    frac = float(spec.params.get("frac", 0.9))
    pt = store.latest("serve_queue_depth")
    depth = pt[1] if pt is not None else 0.0
    fill = depth / cap
    return [("", 1.0 if fill >= frac else 0.0, fill)]


_EVALUATORS: dict[str, Callable] = {
    "availability": _eval_availability,
    "p99": _eval_p99,
    "goodput": _eval_goodput,
    "silent_loss": _eval_silent_loss,
    "worker_up": _eval_worker_up,
    "queue_saturation": _eval_queue_saturation,
}


@dataclasses.dataclass
class _AlertCell:
    """Per-(spec, label) machine state + the err sample window."""

    state: str = OK
    since: float = 0.0            # entered current state
    breach_since: Optional[float] = None
    clear_since: Optional[float] = None
    fired: int = 0                # firing transitions (lifetime)
    errs: list = dataclasses.field(default_factory=list)  # (t, err)
    burn_short: float = 0.0
    burn_long: float = 0.0
    value: float = 0.0


class SloEngine:
    """Evaluate a spec list against one store; drive the alert state
    machines; emit transitions.

    ``emit(event_fields)`` is called for every transition with the
    schema'd ``alert`` fleet-event fields (`telemetry.lifecycle`
    validates them at write time); the service wires it to its
    `LifecycleLog`. ``registry`` (optional) counts transitions into
    ``watch_alerts_total{slo,state}`` so the alert ledger is itself a
    scrapeable metric."""

    def __init__(self, specs: list[SloSpec], store: TimeSeriesStore, *,
                 emit: Optional[Callable[[dict], None]] = None,
                 registry=None, log=None):
        for s in specs:
            if s.kind not in _EVALUATORS:
                raise ValueError(
                    f"SLO {s.name!r}: unknown kind {s.kind!r} "
                    f"(catalog: {sorted(_EVALUATORS)})")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self.specs = list(specs)
        self.store = store
        self.emit = emit
        self.registry = registry
        self.log = log
        self._cells: dict[tuple, _AlertCell] = {}
        self._lock = threading.Lock()
        self.evaluations = 0

    # ------------------------------------------------------------ windowing

    @staticmethod
    def _burn(cell: _AlertCell, span_s: float, now: float,
              budget: float) -> float:
        """Mean err over the trailing span, over the budget — the burn
        rate (1.0 = burning exactly the budget)."""
        pts = [e for t, e in cell.errs if t >= now - span_s]
        if not pts:
            return 0.0
        return (sum(pts) / len(pts)) / max(budget, 1e-9)

    # ----------------------------------------------------------- evaluation

    def evaluate(self, now: Optional[float] = None) -> list[dict]:
        """One evaluation pass over every spec. Returns the transition
        events emitted this pass (also sent through ``emit``)."""
        now = time.time() if now is None else float(now)
        transitions: list[dict] = []
        with self._lock:
            self.evaluations += 1
            for spec in self.specs:
                try:
                    results = _EVALUATORS[spec.kind](self.store, spec,
                                                     now)
                except Exception as e:      # noqa: BLE001 — an evaluator
                    # bug must not kill the watch loop; skip this spec
                    if self.log is not None:
                        self.log.error("SLO %s evaluator failed: %s",
                                       spec.name, e)
                    continue
                for label, err, value in results:
                    key = (spec.name, label)
                    cell = self._cells.get(key)
                    if cell is None:
                        cell = self._cells[key] = _AlertCell(since=now)
                    cell.errs.append((now, err))
                    # bound the err window (store-capacity discipline)
                    horizon = now - spec.window_s * 1.5
                    while cell.errs and cell.errs[0][0] < horizon:
                        cell.errs.pop(0)
                    cell.burn_long = self._burn(cell, spec.window_s,
                                                now, spec.budget)
                    cell.burn_short = self._burn(cell, spec.short_s,
                                                 now, spec.budget)
                    cell.value = value
                    if spec.mode == "burn":
                        breach = (cell.burn_long >= spec.burn_threshold
                                  and cell.burn_short
                                  >= spec.burn_threshold)
                    else:
                        breach = err >= 1.0
                    transitions.extend(
                        self._advance(spec, label, cell, breach, now))
        return transitions

    def _advance(self, spec: SloSpec, label: str, cell: _AlertCell,
                 breach: bool, now: float) -> list[dict]:
        out = []
        if cell.state == OK:
            if breach:
                cell.breach_since = now
                cell.state = PENDING
                cell.since = now
                if now - cell.breach_since >= spec.for_s:
                    out.append(self._transition(spec, label, cell,
                                                FIRING, now))
        elif cell.state == PENDING:
            if not breach:
                # flap suppressed: a pending breach that clears before
                # for_s never fires (and emits nothing)
                cell.state = OK
                cell.since = now
                cell.breach_since = None
            elif now - (cell.breach_since or now) >= spec.for_s:
                out.append(self._transition(spec, label, cell, FIRING,
                                            now))
        elif cell.state == FIRING:
            if breach:
                cell.clear_since = None       # re-breach resets the clear
            else:
                if cell.clear_since is None:
                    cell.clear_since = now
                if now - cell.clear_since >= spec.clear_s:
                    out.append(self._transition(spec, label, cell,
                                                "resolved", now))
        return out

    def _transition(self, spec: SloSpec, label: str, cell: _AlertCell,
                    to: str, now: float) -> dict:
        """Advance one cell and build + emit its schema'd event."""
        if to == FIRING:
            cell.state = FIRING
            cell.fired += 1
            cell.clear_since = None
        else:                                 # resolved -> resting OK
            cell.state = OK
            cell.breach_since = None
            cell.clear_since = None
        cell.since = now
        ev = {"slo": spec.name, "state": to, "labels": label,
              "burn_short": round(cell.burn_short, 4),
              "burn_long": round(cell.burn_long, 4),
              "value": round(float(cell.value), 6), "t_wall": now}
        if self.registry is not None:
            self.registry.counter(
                "watch_alerts_total",
                labels={"slo": spec.name, "state": to}).inc()
        if self.emit is not None:
            try:
                self.emit(ev)
            except Exception as e:          # noqa: BLE001 — loud, nonfatal
                if self.log is not None:
                    self.log.warning("alert event emit failed: %s", e)
        if self.log is not None:
            lvl = (self.log.warning if to == FIRING else self.log.info)
            lvl("SLO %s%s %s (burn %.2f/%.2f, value %.4g)",
                spec.name, label, to.upper(), cell.burn_short,
                cell.burn_long, cell.value)
        return ev

    # -------------------------------------------------------------- surface

    def verdicts(self) -> dict:
        """{slo: {state, burn_short, burn_long, value, fired, labels}}
        — the ``health`` kind's core payload. ``state`` is the WORST
        label state (firing > pending > ok)."""
        rank = {OK: 0, PENDING: 1, FIRING: 2}
        with self._lock:
            out: dict = {}
            for spec in self.specs:
                cells = {lbl: c for (nm, lbl), c in self._cells.items()
                         if nm == spec.name}
                if not cells:
                    out[spec.name] = {"state": OK, "burn_short": 0.0,
                                      "burn_long": 0.0, "value": None,
                                      "fired": 0, "labels": {}}
                    continue
                worst = max(cells.values(), key=lambda c: rank[c.state])
                out[spec.name] = {
                    "state": worst.state,
                    "burn_short": round(max(c.burn_short
                                            for c in cells.values()), 4),
                    "burn_long": round(max(c.burn_long
                                           for c in cells.values()), 4),
                    "value": worst.value,
                    "fired": sum(c.fired for c in cells.values()),
                    "labels": {lbl or "-": c.state
                               for lbl, c in sorted(cells.items())},
                }
            return out

    def firing(self) -> list[str]:
        with self._lock:
            return sorted(f"{nm}{lbl}" for (nm, lbl), c
                          in self._cells.items() if c.state == FIRING)


class SwarmWatch:
    """Store + sampler + SLO engine for one measurement domain (one
    `SwarmService`, or any registry). Evaluation rides the sampler's
    ``on_sample`` hook, so one cadence and one ``spent_s`` cover the
    whole watch path."""

    def __init__(self, registry, specs: list[SloSpec], *,
                 interval_s: float = 0.25, capacity: int = 1024,
                 persist_path=None, emit=None,
                 probe: Optional[Callable[[], None]] = None, log=None):
        self.store = TimeSeriesStore(capacity=capacity)
        self.engine = SloEngine(specs, self.store, emit=emit,
                                registry=registry, log=log)
        self.sampler = Sampler(registry, self.store,
                               interval_s=interval_s,
                               persist_path=persist_path, probe=probe,
                               on_sample=self.engine.evaluate, log=log)

    def start(self) -> None:
        self.sampler.start()

    def stop(self) -> None:
        self.sampler.stop()

    @property
    def spent_s(self) -> float:
        return self.sampler.spent_s

    def health(self) -> dict:
        """The live health surface (the wire ``health`` kind's payload
        core): SLO verdicts + burn rates, alerts currently firing, and
        the sampler's own census."""
        return {
            "verdicts": self.engine.verdicts(),
            "firing": self.engine.firing(),
            "sampler": {"samples": self.sampler.samples,
                        "interval_s": self.sampler.interval_s,
                        "spent_s": round(self.sampler.spent_s, 6),
                        "persist_lost": self.sampler.lost,
                        "series": len(self.store.names()),
                        "points_dropped": self.store.dropped},
        }

"""The health tier on the port — time-series store, burn-rate engine,
alert state machine, service integration and CLI: the cases of
`tests/test_watch.py` on `aclswarm_torch` (its service on the CPU in
float64), and parity with the reference.

Engine tests drive `evaluate(now=...)` with explicit clocks — no sleeps,
fully deterministic. Parity: one seeded sample stream fed to the
reference's `SloEngine` and the port's gives the same transitions,
values and burn rates exactly; the stores' windowed deltas and rates are
equal; each package reads the other's persisted ``timeseries.log``. The
reference's `benchmarks/` schema cases (`check_results`, `bench_trend`)
test its own benchmark tooling, which the port does not have: parity
cases take their place.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from aclswarm_torch.serve import ServiceConfig
from aclswarm_torch.telemetry import MetricsRegistry
from aclswarm_torch.telemetry import slo as port_slo
from aclswarm_torch.telemetry import timeseries as port_ts
from aclswarm_torch.telemetry.slo import (FIRING, OK, PENDING, SloEngine,
                                          SloSpec, default_slos)
from aclswarm_torch.telemetry.timeseries import (Sampler, TimeSeriesStore,
                                                 load_store)
from aclswarm_tpu.telemetry import slo as ref_slo
from aclswarm_tpu.telemetry import timeseries as ref_ts
from aclswarm_tpu.telemetry import watch as ref_watch

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

pytestmark = pytest.mark.telemetry


def _cfg(**kw) -> ServiceConfig:
    return ServiceConfig(device="cpu", dtype="float64", **kw)


# ---------------------------------------------------------------------------
# TimeSeriesStore

class TestTimeSeriesStore:
    def test_append_window_latest(self):
        s = TimeSeriesStore(capacity=16)
        for t in range(10):
            s.append("x", float(t), float(t * 2))
        assert s.latest("x") == (9.0, 18.0)
        w = s.window("x", 3.0, now=9.0)
        assert [p[0] for p in w] == [6.0, 7.0, 8.0, 9.0]
        assert s.window("unknown", 3.0) == []
        assert s.latest("unknown") is None

    def test_wraparound_keeps_newest_and_counts_drops(self):
        s = TimeSeriesStore(capacity=4)
        for t in range(7):
            s.append("x", float(t), float(t))
        pts = s.points("x")
        assert [p[0] for p in pts] == [3.0, 4.0, 5.0, 6.0]   # time order
        assert s.dropped == 3

    def test_window_delta_golden_reset_tolerant(self):
        """The docstring's golden case: samples 0,5,9,2,4 — the 9→2
        drop is a counter RESET (restarted worker), contributing the
        post-reset value, never a negative delta."""
        s = TimeSeriesStore(capacity=16)
        for t, v in enumerate([0, 5, 9, 2, 4]):
            s.append("c", float(t), float(v))
        assert s.window_delta("c", 100.0, now=4.0) == 13.0

    def test_rate_across_counter_reset(self):
        s = TimeSeriesStore(capacity=16)
        # 10 events, restart (reset to 2 post-restart events), 4 more:
        # 10 + 2 + 4 = 16 over 4 s — never a negative rate
        for t, v in [(0, 0), (2, 10), (3, 2), (4, 6)]:
            s.append("c", float(t), float(v))
        assert s.window_delta("c", 100.0, now=4.0) == 16.0
        assert s.rate("c", 100.0, now=4.0) == pytest.approx(16.0 / 4.0)
        assert s.rate("c", 100.0, now=4.0) > 0

    def test_underdetermined_windows_are_none_not_zero(self):
        s = TimeSeriesStore(capacity=8)
        assert s.window_delta("c", 10.0) is None
        s.append("c", 0.0, 5.0)
        assert s.window_delta("c", 10.0) is None   # one point: no delta
        assert s.rate("c", 10.0) is None

    def test_nan_sample_refused(self):
        s = TimeSeriesStore(capacity=8)
        s.append("x", 0.0, float("nan"))
        s.append("x", 1.0, float("inf"))
        assert s.points("x") == []

    def test_capacity_validated(self):
        with pytest.raises(ValueError):
            TimeSeriesStore(capacity=1)


# ---------------------------------------------------------------------------
# Sampler + persistence

def _reg_with_traffic() -> MetricsRegistry:
    reg = MetricsRegistry()
    reg.counter("serve_completed_total").inc(3)
    reg.gauge("serve_queue_depth").set(2)
    h = reg.histogram("serve_latency_s", {"tenant": "a"})
    for v in (0.1, 0.2, 0.3):
        h.observe(v)
    return reg


class TestSampler:
    def test_tick_flattens_registry(self):
        reg = _reg_with_traffic()
        store = TimeSeriesStore(capacity=32)
        smp = Sampler(reg, store, interval_s=1.0)
        vals = smp.tick(now=10.0)
        assert vals["serve_completed_total"] == 3.0
        assert vals["serve_queue_depth"] == 2.0
        assert "serve_latency_s{tenant=a}:p99" in vals
        assert "serve_latency_s{tenant=a}:count" in vals
        assert "spans_dropped_total" in vals
        assert store.latest("serve_completed_total") == (10.0, 3.0)
        assert smp.samples == 1 and smp.spent_s > 0

    def test_persist_and_load_store_round_trip(self, tmp_path):
        reg = _reg_with_traffic()
        store = TimeSeriesStore(capacity=32)
        log = tmp_path / "ts" / "timeseries.log"
        smp = Sampler(reg, store, interval_s=1.0, persist_path=log)
        smp.tick(now=1.0)
        reg.counter("serve_completed_total").inc(2)
        smp.tick(now=2.0)
        smp.stop(final_tick=False)
        loaded, ticks, torn = load_store(log)
        assert ticks == 2 and not torn
        assert loaded.points("serve_completed_total") == \
            store.points("serve_completed_total") == [(1.0, 3.0),
                                                      (2.0, 5.0)]

    def test_load_store_drops_torn_tail(self, tmp_path):
        reg = _reg_with_traffic()
        store = TimeSeriesStore(capacity=32)
        log = tmp_path / "timeseries.log"
        smp = Sampler(reg, store, interval_s=1.0, persist_path=log)
        smp.tick(now=1.0)
        smp.tick(now=2.0)
        smp.stop(final_tick=False)
        whole = log.read_bytes()
        log.write_bytes(whole[:-7])       # crash mid-append
        loaded, ticks, torn = load_store(log)
        assert torn and ticks == 1
        assert loaded.latest("serve_completed_total") == (1.0, 3.0)

    def test_hooks_run_and_failures_keep_the_cadence(self):
        reg = _reg_with_traffic()
        store = TimeSeriesStore(capacity=32)
        seen = []

        def probe():
            reg.gauge("serve_queue_depth").set(7)

        def on_sample(t):
            seen.append(t)
            raise RuntimeError("evaluator bug")

        smp = Sampler(reg, store, interval_s=1.0, probe=probe,
                      on_sample=on_sample)
        vals = smp.tick(now=5.0)
        assert vals["serve_queue_depth"] == 7.0   # probe ran first
        assert seen == [5.0]                      # hook ran
        assert smp.tick(now=6.0)                  # failure didn't wedge


# ---------------------------------------------------------------------------
# burn-rate engine + alert state machine

def _avail_spec(**kw) -> SloSpec:
    base = dict(name="availability", kind="availability", mode="burn",
                budget=0.1, burn_threshold=2.0, window_s=10.0,
                short_s=2.0, for_s=0.0, clear_s=2.0)
    base.update(kw)
    return SloSpec(**base)


def _feed(store, t, completed, failed):
    store.append("serve_completed_total", t, float(completed))
    store.append("serve_failed_total", t, float(failed))


class TestBurnRateGolden:
    def test_clean_traffic_burn_is_zero(self):
        store = TimeSeriesStore(capacity=64)
        eng = SloEngine([_avail_spec()], store)
        for t in range(8):
            _feed(store, float(t), completed=t * 5, failed=0)
            assert eng.evaluate(now=float(t)) == []
        v = eng.verdicts()["availability"]
        assert v["state"] == OK
        assert v["burn_short"] == 0.0 and v["burn_long"] == 0.0
        assert v["value"] == 1.0

    def test_golden_burn_value_and_firing(self):
        """50% failures against a 10% budget. Golden values: the alert
        fires at the FIRST evaluation where both windows breach —
        err history [0, 0.5] → mean 0.25 / 0.1 = burn 2.5 on both
        windows (>= threshold 2.0). By the last sample the short
        window holds only err-0.5 points → burn exactly 5.0, the long
        window [0, .5, .5, .5, .5] → mean 0.4 / 0.1 = 4.0."""
        store = TimeSeriesStore(capacity=64)
        events = []
        eng = SloEngine([_avail_spec()], store, emit=events.append)
        _feed(store, 0.0, 0, 0)
        eng.evaluate(now=0.0)
        transitions = []
        for t in range(1, 5):
            _feed(store, float(t), completed=t * 2, failed=t * 2)
            transitions += eng.evaluate(now=float(t))
        assert [e["state"] for e in transitions] == [FIRING]
        ev = transitions[0]
        assert ev["slo"] == "availability"
        assert ev["burn_short"] == pytest.approx(2.5)
        assert ev["burn_long"] == pytest.approx(2.5)
        assert events == transitions        # emit got the same records
        v = eng.verdicts()["availability"]
        assert v["state"] == FIRING
        assert v["burn_short"] == pytest.approx(5.0)
        assert v["burn_long"] == pytest.approx(4.0)

    def test_burn_requires_both_windows(self):
        """A long window still burning but a recovered short window
        must NOT re-breach (the multi-window rule: fast detection
        without paging on history)."""
        store = TimeSeriesStore(capacity=64)
        eng = SloEngine([_avail_spec(for_s=100.0)], store)
        _feed(store, 0.0, 0, 0)
        eng.evaluate(now=0.0)
        # errors for 4 samples, then clean recovery
        comp = fail = 0
        for t in range(1, 5):
            comp, fail = comp + 1, fail + 1
            _feed(store, float(t), comp, fail)
            eng.evaluate(now=float(t))
        assert eng._cells[("availability", "")].state == PENDING
        for t in range(5, 8):
            comp += 10
            _feed(store, float(t), comp, fail)
            eng.evaluate(now=float(t))
        cell = eng._cells[("availability", "")]
        # short window clean -> breach gone -> pending flap suppressed
        assert cell.state == OK
        assert cell.burn_short < 2.0 < cell.burn_long


def _worker_spec(**kw) -> SloSpec:
    base = dict(name="worker_up", kind="worker_up", mode="level",
                budget=1e-6, window_s=10.0, short_s=2.0, for_s=0.0,
                clear_s=2.0)
    base.update(kw)
    return SloSpec(**base)


class TestAlertStateMachine:
    def _up(self, store, t, w0=1.0, w1=1.0):
        store.append("serve_worker_up{worker=0}", t, w0)
        store.append("serve_worker_up{worker=1}", t, w1)

    def test_fire_and_resolve_per_label(self):
        store = TimeSeriesStore(capacity=64)
        events = []
        eng = SloEngine([_worker_spec()], store, emit=events.append)
        self._up(store, 0.0)
        assert eng.evaluate(now=0.0) == []
        self._up(store, 1.0, w0=0.0)           # worker 0 dies
        tr = eng.evaluate(now=1.0)
        assert [(e["state"], e["labels"]) for e in tr] == \
            [("firing", "{worker=0}")]
        v = eng.verdicts()["worker_up"]
        assert v["state"] == FIRING
        assert v["labels"] == {"{worker=0}": FIRING, "{worker=1}": OK}
        self._up(store, 2.0)                   # rejoin
        assert eng.evaluate(now=2.0) == []     # clear dwell not yet met
        self._up(store, 4.5)
        tr = eng.evaluate(now=4.5)
        assert [e["state"] for e in tr] == ["resolved"]
        assert eng.verdicts()["worker_up"]["state"] == OK
        assert eng.verdicts()["worker_up"]["fired"] == 1
        assert eng.firing() == []

    def test_flap_suppression_pending_never_fires(self):
        store = TimeSeriesStore(capacity=64)
        events = []
        eng = SloEngine([_worker_spec(for_s=3.0)], store,
                        emit=events.append)
        self._up(store, 0.0)
        eng.evaluate(now=0.0)
        self._up(store, 1.0, w0=0.0)           # blip
        assert eng.evaluate(now=1.0) == []     # pending, dwell unmet
        assert eng._cells[("worker_up", "{worker=0}")].state == PENDING
        self._up(store, 2.0)                   # recovered inside dwell
        assert eng.evaluate(now=2.0) == []
        assert eng._cells[("worker_up", "{worker=0}")].state == OK
        assert events == []                    # the flap left no record

    def test_dwell_fires_after_for_s(self):
        store = TimeSeriesStore(capacity=64)
        eng = SloEngine([_worker_spec(for_s=3.0)], store)
        self._up(store, 0.0)
        eng.evaluate(now=0.0)
        for t in (1.0, 2.0, 3.0):
            self._up(store, t, w0=0.0)
            assert eng.evaluate(now=t) == []
        self._up(store, 4.0, w0=0.0)           # dwell (3s) met at 4.0
        tr = eng.evaluate(now=4.0)
        assert [e["state"] for e in tr] == ["firing"]

    def test_rebreach_resets_the_clear_clock(self):
        store = TimeSeriesStore(capacity=64)
        eng = SloEngine([_worker_spec(clear_s=2.0)], store)
        self._up(store, 0.0)
        eng.evaluate(now=0.0)
        self._up(store, 1.0, w0=0.0)
        assert len(eng.evaluate(now=1.0)) == 1      # firing
        self._up(store, 2.0)                        # clear starts
        eng.evaluate(now=2.0)
        self._up(store, 3.0, w0=0.0)                # re-breach!
        eng.evaluate(now=3.0)
        self._up(store, 4.5)                        # clear restarts
        assert eng.evaluate(now=4.5) == []          # old clock was reset
        self._up(store, 6.6)
        tr = eng.evaluate(now=6.6)
        assert [e["state"] for e in tr] == ["resolved"]

    def test_alert_counter_rides_the_registry(self):
        reg = MetricsRegistry()
        store = TimeSeriesStore(capacity=64)
        eng = SloEngine([_worker_spec()], store, registry=reg)
        self._up(store, 0.0, w0=0.0)
        eng.evaluate(now=0.0)
        snap = reg.snapshot()["metrics"]
        assert snap["watch_alerts_total{slo=worker_up,state=firing}"][
            "value"] == 1


class TestSpecValidation:
    def test_bad_specs_refused(self):
        with pytest.raises(ValueError):
            SloSpec(name="x", kind="availability", mode="sideways")
        with pytest.raises(ValueError):
            SloSpec(name="x", kind="availability", budget=0.0)
        with pytest.raises(ValueError):
            SloSpec(name="x", kind="availability", short_s=60.0,
                    window_s=30.0)
        store = TimeSeriesStore(capacity=8)
        with pytest.raises(ValueError):
            SloEngine([SloSpec(name="x", kind="nope")], store)
        spec = default_slos()[0]
        with pytest.raises(ValueError):
            SloEngine([spec, spec], store)      # duplicate names

    def test_default_catalog_covers_the_offline_bars(self):
        names = {s.name for s in default_slos()}
        assert names == {"availability", "latency_p99", "goodput",
                         "silent_loss", "worker_up", "queue_saturation"}


# ---------------------------------------------------------------------------
# span-drop export satellite

class TestSpanDropExport:
    def test_dropped_spans_are_first_class_metrics(self):
        reg = MetricsRegistry(spans=2)
        for i in range(5):
            with reg.span("w"):
                pass
        text = reg.prometheus_text()
        assert "spans_recorded_total 5" in text
        assert "spans_dropped_total 3" in text
        rows = [json.loads(ln) for ln in reg.to_jsonl().splitlines()]
        census = [r for r in rows
                  if r.get("name") == "spans_dropped_total"]
        assert census and census[0]["value"] == 3

    def test_span_dump_carries_drops(self, tmp_path):
        from aclswarm_torch.telemetry.spans import (FlightRecorder, Span,
                                                    SpanDump)
        rec = FlightRecorder(capacity=2)
        for i in range(4):
            rec.record(Span(name="s", t_wall=float(i), dur_s=0.0))
        dump = SpanDump(rec, tmp_path / "d.jsonl")
        assert dump.drops == 0
        assert dump.dump("test") == 2
        assert dump.drops == 2
        header = json.loads(
            (tmp_path / "d.jsonl").read_text().splitlines()[0])
        assert header["dropped"] == 2


# ---------------------------------------------------------------------------
# service integration (one service per test — kept tiny)

class TestServeIntegration:
    def test_queue_depth_gauge_is_fresh_off_boundaries(self):
        """The freshness regression (satellite): an idle service (no
        worker running — start=False, so there are NO chunk boundaries)
        must still show current depth on submit/cancel."""
        from aclswarm_torch.serve import SwarmService

        svc = SwarmService(_cfg(max_batch=1), start=False)
        g = lambda: svc.telemetry.gauge("serve_queue_depth").value  # noqa: E731
        assert g() == 0
        t1 = svc.submit("assign", {"n": 4, "seed": 0}, tenant="a",
                        request_id="w-a")
        assert g() == 1          # fresh at submit, no boundary needed
        svc.submit("assign", {"n": 4, "seed": 1}, tenant="b",
                   request_id="w-b")
        assert g() == 2
        assert svc.cancel("w-a") == "queued"
        assert g() == 1          # fresh at cancel too
        svc.close(drain=False, timeout=1.0)
        assert t1.done

    def test_watch_service_end_to_end(self, tmp_path):
        """health kind + per-tenant device accounting + persisted
        history + CLI replay + postmortem --all, one service."""
        from aclswarm_torch.serve import SwarmService
        from aclswarm_torch.telemetry import postmortem
        from aclswarm_torch.telemetry import watch as watchcli

        d = tmp_path / "journal"
        svc = SwarmService(_cfg(
            max_batch=1, journal_dir=str(d), watch=True,
            watch_interval_s=0.05))
        res = svc.submit("assign", {"n": 5, "seed": 0},
                         tenant="alpha").result(120)
        assert res.ok
        svc.watch.sampler.tick()          # deterministic extra sample
        h = svc.submit("health", {}, tenant="ops").result(60)
        assert h.ok and h.value["watch_enabled"]
        verdicts = h.value["watch"]["verdicts"]
        assert set(verdicts) == {s.name for s in default_slos()}
        assert h.value["workers"]["total"] == 1
        assert h.value["watch"]["firing"] == []
        # per-tenant device-time accounting: the assign's execution
        # wall landed on its tenant+kind counter
        st = svc.serve_stats()
        assert st.device_s.get("alpha", {}).get("assign", 0.0) > 0.0
        assert "health" in st.device_s.get("ops", {})
        svc.close()
        # history survives the process boundary: disk alone
        loaded, ticks, torn = load_store(d / "timeseries.log")
        assert ticks > 0 and not torn
        assert loaded.latest("serve_completed_total")[1] >= 2.0
        assert watchcli.main(["--log", str(d / "timeseries.log")]) == 0
        assert postmortem.main([str(d), "--all"]) == 0

    def test_health_kind_without_watch_still_reports_liveness(self):
        from aclswarm_torch.serve import SwarmService

        with SwarmService(_cfg(max_batch=1)) as svc:
            h = svc.submit("health", {}).result(60)
            assert h.ok
            assert h.value["watch_enabled"] is False
            assert h.value["watch"] is None
            assert h.value["workers"]["total"] == 1
            assert h.value["alive"] is True


# ---------------------------------------------------------------------------
# watch CLI + schema guard

class TestWatchCli:
    def test_replay_surfaces_alert_transitions(self, tmp_path):
        """A persisted history containing a worker death must replay to
        the same firing/resolved pair the live engine produced."""
        reg = MetricsRegistry()
        up = reg.gauge("serve_worker_up", {"worker": "0"})
        store = TimeSeriesStore(capacity=64)
        log = tmp_path / "timeseries.log"
        smp = Sampler(reg, store, interval_s=1.0, persist_path=log)
        up.set(1)
        smp.tick(now=0.0)
        up.set(0)
        smp.tick(now=1.0)
        up.set(1)
        for t in (2.0, 3.0, 4.0, 5.0):
            smp.tick(now=t)
        smp.stop(final_tick=False)
        from aclswarm_torch.telemetry.watch import replay_log
        rep = replay_log(log)
        assert rep["ticks"] == 6 and not rep["torn_tail"]
        states = [(e["slo"], e["state"]) for e in rep["transitions"]]
        assert states == [("worker_up", "firing"),
                          ("worker_up", "resolved")]
        assert rep["firing"] == []

    def test_cli_exit_codes(self, tmp_path):
        from aclswarm_torch.telemetry import watch as watchcli

        assert watchcli.main(["--log", str(tmp_path / "nope.log")]) == 2
        assert watchcli.main(["--tcp", "not-an-address"]) == 2


# ---------------------------------------------------------------------------
# parity with the reference (in place of its benchmark-schema cases)

def _stream(seed: int, ticks: int = 120):
    """A seeded sample stream over the series the default catalog reads:
    counters that grow and reset (a restarted worker), a worker that dies
    and rejoins, queue depth, per-tenant latency percentiles."""
    rng = np.random.default_rng(seed)
    comp = fail = miss = acc = 0.0
    out = []
    for k in range(ticks):
        t = 0.25 * k
        comp += float(rng.integers(0, 4))
        fail += float(rng.integers(0, 3) * (rng.random() < 0.3))
        miss += float(rng.random() < 0.05)
        acc = max(acc, comp + fail + miss) + float(rng.integers(0, 2))
        if k == 70:
            comp = fail = miss = 0.0            # counter reset
        vals = {
            "serve_completed_total": comp,
            "serve_failed_total": fail,
            "serve_deadline_miss_total": miss,
            "serve_accepted_total": acc,
            "serve_queue_depth": float(rng.integers(0, 34)),
            "serve_inflight": float(rng.integers(0, 3)),
            "serve_worker_up{worker=0}": float(not 30 <= k < 38),
            "serve_worker_up{worker=1}": float(not 90 <= k < 91),
            "serve_latency_s{tenant=a}:p99": float(rng.random() * 90),
            "serve_latency_s{tenant=a}:count": float(k),
        }
        out.append((t, vals))
    return out


def _run_engine(mod_slo, mod_ts, stream, specs):
    store = mod_ts.TimeSeriesStore(capacity=256)
    eng = mod_slo.SloEngine(specs, store)
    transitions = []
    for t, vals in stream:
        for name, v in vals.items():
            store.append(name, t, v)
        transitions += eng.evaluate(now=t)
    return transitions, eng.verdicts()


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_engine_matches_reference(seed):
    """One sample stream through both engines (the default catalog at a
    tight queue cap and goodput floor, so every SLO moves): the same
    transitions in the same order, and equal verdicts, values and burn
    rates."""
    kw = dict(max_queue_total=16, goodput_floor_hz=2.0, p99_bound_s=60.0,
              window_s=5.0, short_s=1.0)
    stream = _stream(seed)
    got, gv = _run_engine(port_slo, port_ts, stream, default_slos(**kw))
    want, wv = _run_engine(ref_slo, ref_ts, stream,
                              ref_slo.default_slos(**kw))
    assert len(want) > 2
    assert got == want
    assert gv == wv


def test_store_deltas_and_rates_match_reference():
    stream = _stream(3)
    a, b = TimeSeriesStore(capacity=64), ref_ts.TimeSeriesStore(capacity=64)
    for t, vals in stream:
        for name, v in vals.items():
            a.append(name, t, v)
            b.append(name, t, v)
    now = stream[-1][0]
    for name in stream[0][1]:
        for w in (1.0, 5.0, 30.0):
            assert a.window_delta(name, w, now) == \
                b.window_delta(name, w, now), (name, w)
            assert a.rate(name, w, now) == b.rate(name, w, now), (name, w)
    assert a.dropped == b.dropped


def test_persisted_history_reads_across_packages(tmp_path):
    """The port's ``timeseries.log`` replays through the reference's
    `replay_log` to the port's own transitions, and the reference's log
    loads in the port's `load_store`."""
    reg = MetricsRegistry()
    up = reg.gauge("serve_worker_up", {"worker": "0"})
    log = tmp_path / "port.log"
    smp = Sampler(reg, TimeSeriesStore(capacity=64), interval_s=1.0,
                  persist_path=log)
    for t, u in enumerate([1, 0, 0, 1, 1, 1, 1]):
        up.set(u)
        smp.tick(now=float(t))
    smp.stop(final_tick=False)
    from aclswarm_torch.telemetry.watch import replay_log
    mine, theirs = replay_log(log), ref_watch.replay_log(log)
    assert [(e["slo"], e["state"]) for e in mine["transitions"]] == \
        [("worker_up", "firing"), ("worker_up", "resolved")]
    assert mine == theirs

    from aclswarm_tpu.telemetry import MetricsRegistry as RefRegistry
    rreg = RefRegistry()
    rreg.counter("serve_completed_total").inc(4)
    rlog = tmp_path / "ref.log"
    rs = ref_ts.Sampler(rreg, ref_ts.TimeSeriesStore(capacity=8),
                        interval_s=1.0, persist_path=rlog)
    rs.tick(now=1.0)
    rs.stop(final_tick=False)
    loaded, ticks, torn = load_store(rlog)
    assert ticks == 1 and not torn
    assert loaded.latest("serve_completed_total") == (1.0, 4.0)

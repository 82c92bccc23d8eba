"""Request tracing on the port — the lifecycle schema, the postmortem,
the span crash dump: the cases of `tests/test_trace.py` on
`aclswarm_torch` (its service on the CPU in float64), and parity with the
reference.

The event schema refuses malformed records at write time, the stream
survives a torn tail, the postmortem detects exactly the violations it
claims to (coverage holes, digest drift, trace drift, missing
terminals), and the span ring dumps and disarms cleanly. Parity: the
reference's `postmortem.reconstruct` and the port's, over the same
journal written by the port's service (clean, preempted, migrated,
deadline and cancel runs) or by hand (each violation), give equal
reports. The reference's `benchmarks/bench_trend.py` cases test its own
benchmark tooling, which the port does not have: the parity cases take
their place.
"""
from __future__ import annotations

import json

import pytest
import torch

from aclswarm_torch.serve import ServiceConfig
from aclswarm_torch.telemetry import (FlightRecorder, LifecycleLog, Span,
                                      TraceContext, mint_trace_id)
from aclswarm_torch.telemetry import postmortem
from aclswarm_torch.telemetry.lifecycle import make_event
from aclswarm_torch.telemetry.spans import SpanDump
from aclswarm_tpu.telemetry import postmortem as ref_postmortem

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

pytestmark = pytest.mark.telemetry


def _cfg(**kw) -> ServiceConfig:
    return ServiceConfig(device="cpu", dtype="float64", **kw)


# ------------------------------------------------------------ lifecycle

class TestLifecycleSchema:
    def test_mint_and_context(self):
        a, b = mint_trace_id(), mint_trace_id()
        assert a != b and len(a) == 16 and int(a, 16) >= 0
        ctx = TraceContext.mint("client.submit")
        assert ctx.parent_span == "client.submit" and len(ctx.trace_id) == 16

    def test_unknown_event_and_missing_fields_refused_at_write(self):
        with pytest.raises(ValueError, match="unknown lifecycle event"):
            make_event("teleported", request_id="r", trace_id="t", seq=0)
        with pytest.raises(ValueError, match="missing required"):
            make_event("chunk", request_id="r", trace_id="t", seq=0, k=1)
        with pytest.raises(ValueError, match="needs a request_id"):
            make_event("chunk", request_id=None, trace_id="t", seq=0,
                       k=1, digest=2, worker=0)

    def test_event_envelope(self):
        payload, man = make_event("resolved", request_id="r1",
                                  trace_id="t1", seq=7,
                                  status="completed", chunks=3)
        assert payload["request_id"] == "r1"
        assert payload["trace_id"] == "t1" and payload["seq"] == 7
        assert payload["t_wall"] > 0 and payload["t_mono"] > 0
        assert man["kind"] == "serve_event" and man["event"] == "resolved"

    def test_log_roundtrip_and_torn_tail(self, tmp_path):
        log = LifecycleLog(tmp_path / "events.log")
        tid = mint_trace_id()
        assert log.emit("submitted", request_id="r1", trace_id=tid,
                        kind="rollout", tenant="a")
        assert log.emit("chunk", request_id="r1", trace_id=tid,
                        k=0, digest=0xAB, worker=0)
        assert log.emit("failover", worker="0.1", reason="drill",
                        orphans=1)
        rows, torn = LifecycleLog.read(tmp_path / "events.log")
        assert not torn and [r["event"] for r in rows] \
            == ["submitted", "chunk", "failover"]
        assert rows[0]["trace_id"] == tid and rows[1]["k"] == 0
        assert rows[0]["seq"] == 0 and rows[1]["seq"] == 1
        # torn tail: a crash mid-append loses at most the last record
        raw = (tmp_path / "events.log").read_bytes()
        (tmp_path / "events.log").write_bytes(raw[:-7])
        rows2, torn2 = LifecycleLog.read(tmp_path / "events.log")
        assert torn2 and [r["event"] for r in rows2] \
            == ["submitted", "chunk"]


# ------------------------------------------------------------ postmortem

def _emit_clean_timeline(log: LifecycleLog, rid: str, tid: str,
                         chunks: int = 3, t0: float = 1000.0):
    dt = [t0]

    def e(event, **f):
        dt[0] += 0.1
        log.emit(event, request_id=rid, trace_id=tid, t_wall=dt[0], **f)

    e("submitted", kind="rollout", tenant="a")
    e("admitted", queue_depth=1)
    for k in range(chunks):
        e("batched", worker=0, round=k + 1, batch=1, chunk=k)
        e("chunk", k=k, digest=100 + k, worker=0)
        if k < chunks - 1:
            e("queued", reason="boundary")
    e("resolved", status="completed", chunks=chunks, latency_s=1.0)


class TestPostmortem:
    def test_clean_timeline_reconstructs(self, tmp_path):
        log = LifecycleLog(tmp_path / "events.log")
        tid = mint_trace_id()
        _emit_clean_timeline(log, "r1", tid)
        rep = postmortem.reconstruct(tmp_path)["requests"]["r1"]
        assert rep["complete"] and rep["gap_free"], rep["problems"]
        assert rep["trace_id"] == tid and rep["chunks"] == 3
        assert rep["status"] == "completed"
        st = rep["stages"]
        assert st["queue_wait_s"] == pytest.approx(0.1, abs=1e-6)
        assert st["device_s"] == pytest.approx(0.3, abs=1e-6)
        assert st["batch_wait_s"] == pytest.approx(0.2, abs=1e-6)
        assert st["total_s"] > 0

    def test_chunk_hole_detected(self, tmp_path):
        log = LifecycleLog(tmp_path / "events.log")
        tid = mint_trace_id()
        log.emit("submitted", request_id="r1", trace_id=tid,
                 kind="rollout", tenant="a")
        for k in (0, 2):               # chunk 1 missing
            log.emit("batched", request_id="r1", trace_id=tid,
                     worker=0, round=k, batch=1)
            log.emit("chunk", request_id="r1", trace_id=tid,
                     k=k, digest=k, worker=0)
        log.emit("resolved", request_id="r1", trace_id=tid,
                 status="completed", chunks=2)
        rep = postmortem.reconstruct(tmp_path)["requests"]["r1"]
        assert rep["complete"] and not rep["gap_free"]
        assert any("hole" in p for p in rep["problems"])

    def test_nonidentical_reexecution_detected(self, tmp_path):
        """At-least-once re-execution after a crash restore is legal —
        but ONLY bit-identically. A duplicate chunk with a different
        digest must fail the reconstruction."""
        log = LifecycleLog(tmp_path / "events.log")
        tid = mint_trace_id()
        log.emit("submitted", request_id="r1", trace_id=tid,
                 kind="rollout", tenant="a")
        for dg in (111, 222):          # chunk 0 twice, digests differ
            log.emit("batched", request_id="r1", trace_id=tid,
                     worker=0, round=1, batch=1)
            log.emit("chunk", request_id="r1", trace_id=tid,
                     k=0, digest=dg, worker=0)
        log.emit("resolved", request_id="r1", trace_id=tid,
                 status="completed", chunks=1)
        rep = postmortem.reconstruct(tmp_path)["requests"]["r1"]
        assert rep["duplicate_chunks"] == 1 and not rep["gap_free"]
        assert any("DIFFERENT digest" in p for p in rep["problems"])

    def test_trace_drift_and_missing_terminal_detected(self, tmp_path):
        log = LifecycleLog(tmp_path / "events.log")
        log.emit("submitted", request_id="r1", trace_id="aaaa",
                 kind="rollout", tenant="a")
        log.emit("chunk", request_id="r1", trace_id="bbbb",
                 k=0, digest=1, worker=0)
        rep = postmortem.reconstruct(tmp_path)["requests"]["r1"]
        assert not rep["complete"] and not rep["gap_free"]
        assert any("drift" in p for p in rep["problems"])
        assert any("terminal" in p for p in rep["problems"])

    def test_crash_before_first_batch_is_failover_gap_not_queue(
            self, tmp_path):
        """A request that crashed/recovered before EVER being scheduled
        must show the outage in failover_gap_s — charging it to queue
        wait would hide exactly the incident the tool exists to
        surface (review regression)."""
        log = LifecycleLog(tmp_path / "events.log")
        tid = mint_trace_id()

        def e(event, t, **f):
            log.emit(event, request_id="r1", trace_id=tid, t_wall=t, **f)

        e("submitted", 100.0, kind="rollout", tenant="a")
        e("admitted", 100.1)
        e("queued", 100.2, reason="recovery")    # crash + restart
        e("batched", 105.2, worker=0, round=1, batch=1)
        e("chunk", 105.3, k=0, digest=1, worker=0)
        e("resolved", 105.4, status="completed", chunks=1)
        rep = postmortem.reconstruct(tmp_path)["requests"]["r1"]
        assert rep["gap_free"], rep["problems"]
        st = rep["stages"]
        assert st["failover_gap_s"] == pytest.approx(5.0, abs=1e-6)
        assert st["queue_wait_s"] == pytest.approx(0.1, abs=1e-6)

    def test_accepted_but_traceless_is_loud(self, tmp_path):
        """A req frame with no events is a reconstruction failure, not
        an empty success — the soak counts on this."""
        from aclswarm_torch.resilience import checkpoint as ckptlib
        (tmp_path / "req_ghost.req").write_bytes(ckptlib.dumps(
            {"params": {}}, ckptlib.make_manifest(
                "serve_req", "-", 0, "-", request_id="ghost",
                tenant="a", req_kind="assign", deadline_s=None,
                t_submit=0.0, trace_id="cafe")))
        rep = postmortem.reconstruct(tmp_path)
        assert rep["accepted"] == 1 and rep["complete"] == 0
        assert any("traceless" in p
                   for p in rep["requests"]["ghost"]["problems"])

    def test_cli_exit_codes(self, tmp_path, capsys):
        log = LifecycleLog(tmp_path / "events.log")
        _emit_clean_timeline(log, "ok1", mint_trace_id())
        assert postmortem.main([str(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "1 complete, 1 gap-free" in out and "resolved" in out
        log.emit("submitted", request_id="bad", trace_id="x",
                 kind="rollout", tenant="a")     # never resolves
        assert postmortem.main([str(tmp_path)]) == 1

    def test_fleet_all_gates_on_duplicate_terminals(self, tmp_path,
                                                    capsys):
        """Two slot journals, one request terminal in BOTH (the
        router re-placed a dead slot's work while the slot's successor
        independently recovered and honored the same promise). The
        plain merge stays exit 0 — bounded at-least-once duplicate
        compute is legal — but `--all` surfaces duplicate_terminals in
        the summary table and a nonzero count fails the gate."""
        a, b = tmp_path / "slot0", tmp_path / "slot1"
        la = LifecycleLog(a / "events.log")
        lb = LifecycleLog(b / "events.log")
        _emit_clean_timeline(la, "r1", mint_trace_id())
        _emit_clean_timeline(la, "dup", "feed", t0=2000.0)
        _emit_clean_timeline(lb, "dup", "feed", t0=2000.0)
        rep = postmortem.fleet_reconstruct([a, b])
        assert rep["losses"] == [] and \
            rep["duplicate_terminals"] == ["dup"]
        argv = [str(a), str(b)]
        assert postmortem.main(argv) == 0          # merge: legal
        capsys.readouterr()
        assert postmortem.main(argv + ["--all"]) == 1
        out = capsys.readouterr().out
        assert "duplicate_terminals 1" in out
        assert "DUPLICATE: dup" in out

    def test_fleet_all_clean_merge_passes(self, tmp_path, capsys):
        """The duplicate gate must not fail a clean migration-free
        two-journal merge."""
        a, b = tmp_path / "slot0", tmp_path / "slot1"
        _emit_clean_timeline(LifecycleLog(a / "events.log"), "r1",
                             mint_trace_id())
        _emit_clean_timeline(LifecycleLog(b / "events.log"), "r2",
                             mint_trace_id())
        assert postmortem.main([str(a), str(b), "--all"]) == 0
        out = capsys.readouterr().out
        assert "duplicate_terminals 0" in out


# ------------------------------------------------------- span crash dump

class TestSpanCrashDump:
    def test_dump_appends_header_and_rows(self, tmp_path):
        rec = FlightRecorder(capacity=8)
        for i in range(3):
            rec.record(Span(name="serve.round", t_wall=1.0 + i,
                            dur_s=0.5, attrs={"round": i}))
        dump = SpanDump(rec, tmp_path / "spans_dump.jsonl")
        assert dump.dump("test") == 3
        assert dump.dump("again") == 3          # appends accumulate
        lines = [json.loads(ln) for ln in
                 (tmp_path / "spans_dump.jsonl").read_text().splitlines()]
        headers = [ln for ln in lines if "span_dump" in ln]
        assert [h["span_dump"] for h in headers] == ["test", "again"]
        assert headers[0]["spans"] == 3 and headers[0]["recorded"] == 3
        spans = [ln for ln in lines if "span" in ln and "seq" in ln]
        assert len(spans) == 6
        assert spans[0]["span"] == "serve.round"

    def test_uninstalled_dump_is_noop(self, tmp_path):
        rec = FlightRecorder(capacity=4)
        rec.record(Span(name="x", t_wall=1.0, dur_s=0.1))
        dump = SpanDump(rec, tmp_path / "d.jsonl")
        dump.uninstall()
        assert dump.dump("late") == 0
        assert dump.recorder is None     # ring released, not retained
        assert not (tmp_path / "d.jsonl").exists()

    def test_sigterm_chain_restored_and_sigign_respected(self, tmp_path):
        """install/uninstall must leave the SIGTERM disposition exactly
        as found (no unbounded handler chains across service
        lifetimes), and a host's explicit SIG_IGN choice must survive
        the chained handler (review regression)."""
        import signal

        from aclswarm_torch.telemetry import install_crash_dump

        prev = signal.getsignal(signal.SIGTERM)
        try:
            signal.signal(signal.SIGTERM, signal.SIG_IGN)
            rec = FlightRecorder(capacity=4)
            rec.record(Span(name="x", t_wall=1.0, dur_s=0.1))
            handle = install_crash_dump(rec, tmp_path / "d.jsonl")
            ours = signal.getsignal(signal.SIGTERM)
            assert ours is not signal.SIG_IGN     # hook installed
            # delivering through the hook dumps and then HONORS the
            # host's ignore choice — the process survives
            ours(signal.SIGTERM, None)
            assert (tmp_path / "d.jsonl").exists()
            assert signal.getsignal(signal.SIGTERM) is ours  # no reset
            handle.uninstall()
            assert signal.getsignal(signal.SIGTERM) is signal.SIG_IGN
        finally:
            signal.signal(signal.SIGTERM, prev)

    def test_service_flushes_ring_on_worker_death(self, tmp_path):
        """The worker-death path: the supervisor dumps the span ring to
        the journal when it declares a worker dead — the spans leading
        up to the death survive even though the worker could not flush
        itself."""
        from aclswarm_torch.resilience import crash as crashlib
        from aclswarm_torch.resilience.crash import CrashPlan
        from aclswarm_torch.serve import SwarmService, bucket_of, place_slot

        roll = {"n": 5, "ticks": 60, "chunk_ticks": 20, "seed": 3}
        svc = SwarmService(_cfg(
            workers=2, max_batch=1, quantum_chunks=8,
            journal_dir=str(tmp_path), supervise_poll_s=0.02,
            rejoin_base_s=0.02))
        slot = place_slot(bucket_of("rollout", roll), [0, 1])
        crashlib.arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        res = svc.submit("rollout", roll).result(timeout=240)
        crashlib.arm(None)
        svc.close()
        assert res.ok and res.failovers >= 1
        dumpf = tmp_path / "spans_dump.jsonl"
        assert dumpf.is_file()
        lines = [json.loads(ln)
                 for ln in dumpf.read_text().splitlines()]
        headers = [ln for ln in lines if "span_dump" in ln]
        assert any("declared dead" in h["span_dump"] for h in headers)
        assert any(ln.get("span") == "serve.round" for ln in lines)


# ------------------------------------------- parity with the reference

ROLL = {"n": 5, "ticks": 60, "chunk_ticks": 20, "seed": 3}


def _same_report(journal):
    mine = postmortem.reconstruct(journal)
    theirs = ref_postmortem.reconstruct(journal)
    assert mine == theirs
    return mine


def test_reconstruct_matches_reference_on_served_journal(tmp_path):
    """Rollouts preempted at every chunk (one slot, a one-chunk quantum),
    an assignment and a gain design: every request complete and gap-free,
    the same report from both packages."""
    from aclswarm_torch.serve import SwarmService
    svc = SwarmService(_cfg(max_batch=1, quantum_chunks=1,
                            journal_dir=str(tmp_path)), start=False)
    tickets = [svc.submit("rollout", dict(ROLL, seed=s), tenant=t)
               for s, t in ((1, "a"), (2, "b"))]
    tickets += [svc.submit("assign", {"n": 6, "seed": 0}, tenant="c"),
                svc.submit("gains", {"n": 5, "seed": 0}, tenant="c")]
    svc.start()
    results = [t.result(timeout=240) for t in tickets]
    svc.close()
    assert all(r.ok for r in results)
    rep = _same_report(tmp_path)
    assert rep["accepted"] == 4 == rep["complete"] == rep["gap_free"]
    for r in results:
        row = rep["requests"][r.request_id]
        assert row["trace_id"] == r.trace_id and row["chunks"] == r.chunks
    assert postmortem.main([str(tmp_path), "--all"]) == 0


def test_reconstruct_matches_reference_on_migrated_journal(tmp_path):
    """A worker killed mid-rollout: the migrated request's timeline, with
    its failover gap, reads the same in both packages."""
    from aclswarm_torch.resilience import crash as crashlib
    from aclswarm_torch.resilience.crash import CrashPlan
    from aclswarm_torch.serve import SwarmService, bucket_of, place_slot
    svc = SwarmService(_cfg(workers=2, max_batch=1, quantum_chunks=8,
                            journal_dir=str(tmp_path),
                            supervise_poll_s=0.02, rejoin_base_s=0.02))
    slot = place_slot(bucket_of("rollout", ROLL), [0, 1])
    crashlib.arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
    try:
        res = svc.submit("rollout", ROLL, request_id="mig").result(240)
    finally:
        crashlib.arm(None)
        svc.close()
    assert res.ok and res.failovers >= 1
    row = _same_report(tmp_path)["requests"]["mig"]
    assert row["complete"] and row["gap_free"] and row["migrations"] >= 1


def test_reconstruct_matches_reference_on_deadline_and_cancel(tmp_path):
    """A request past its deadline and a cancelled one: both terminal,
    both reports equal."""
    from aclswarm_torch.serve import SwarmService
    svc = SwarmService(_cfg(max_batch=1, journal_dir=str(tmp_path)),
                       start=False)
    late = svc.submit("rollout", ROLL, request_id="late", deadline_s=0.0)
    gone = svc.submit("assign", {"n": 4, "seed": 1}, request_id="gone")
    assert svc.cancel("gone") == "queued"
    svc.start()
    assert not late.result(timeout=240).ok
    assert not gone.result(timeout=60).ok
    svc.close()
    rep = _same_report(tmp_path)
    assert {rid: row["status"] for rid, row in rep["requests"].items()} \
        == {"late": "timed_out", "gone": "failed"}


def _violation(log, kind):
    tid = mint_trace_id()
    log.emit("submitted", request_id="r1", trace_id=tid, kind="rollout",
             tenant="a")
    chunks = {"hole": [(0, 0), (2, 2)], "digest": [(0, 111), (0, 222)],
              "trace": [(0, 1)], "terminal": [(0, 1), (1, 2)]}[kind]
    for k, dg in chunks:
        log.emit("batched", request_id="r1", trace_id=tid, worker=0,
                 round=k, batch=1)
        log.emit("chunk", request_id="r1",
                 trace_id="bbbb" if kind == "trace" else tid,
                 k=k, digest=dg, worker=0)
    if kind != "terminal":
        log.emit("resolved", request_id="r1", trace_id=tid,
                 status="completed", chunks=len(chunks))


@pytest.mark.parametrize("kind", ["hole", "digest", "trace", "terminal"])
def test_analysis_of_violations_matches_reference(tmp_path, kind):
    _violation(LifecycleLog(tmp_path / "events.log"), kind)
    rep = _same_report(tmp_path)["requests"]["r1"]
    assert not rep["gap_free"] and rep["problems"]

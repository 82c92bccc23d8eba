"""The serving layer (`aclswarm_torch.serve`) on the reference's own cases
(`tests/test_serve.py`), float64 on the CPU at the reference's sizes
(n=5, `ROLL` and `ROLL_FAULTED`), and against the reference's
`SwarmService` on one request script.

The contract, edge by edge: duplicate submissions are idempotent,
queue-full rejection is loud and carries a retry-after hint, deadlines
expiring during a multi-chunk rollout terminate with a structured error at
the next boundary, checkpoint-backed preemption resumes bit for bit under
an active `FaultSchedule`, staged rounds (pipelined or not) equal the
pack-at-round-time path bit for bit, one trace id names a request across
preemption, recovery and migration, a worker that dies mid-batch loses
nothing a journal recovery cannot honor, tenants cannot starve each
other, a worker's death fails its jobs over to the survivors (with the
poison bound and the exoneration of innocent batch-mates), and an
all-tenants-idle `close` is a clean shutdown.

The trace cases read the journal's `events.log` with `LifecycleLog.read`
and check the trace id and the preempted/resumed/migrated arc there, and
hold each request to the port's postmortem (`postmortem.analyze_request`:
complete, gap-free chunk coverage, duplicate executions bit-identical,
one trace id, the terminal event last).

Parity with the reference: the same script through both services gives
the same statuses, error codes, chunk counts, preemptions, failovers and
`assign` permutations exactly, and final positions within 1e-9 (float64;
the two engines' float paths differ in the last bits, so their digests
differ). The smoke drills run as subprocesses, each within its own time
limit.
"""
from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from aclswarm_torch.resilience import crash as crashlib
from aclswarm_torch.resilience.crash import CrashPlan
from aclswarm_torch.serve import (COMPLETED, FAILED, TIMED_OUT,
                                  RejectedError, ServiceConfig, SwarmService,
                                  Ticket, bucket_of, place_slot,
                                  submit_and_wait)
from aclswarm_torch.telemetry import LifecycleLog, postmortem

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

REPO = Path(__file__).resolve().parents[1]
CPU64 = dict(device="cpu", dtype="float64")

ROLL = {"n": 5, "ticks": 60, "chunk_ticks": 20, "seed": 5}
ROLL_FAULTED = {"n": 5, "ticks": 80, "chunk_ticks": 20, "seed": 6,
                "faults": {"dropout_frac": 0.4, "drop_tick": 15,
                           "rejoin_tick": 45}}
MW_ROLL = {"n": 5, "ticks": 80, "chunk_ticks": 20, "seed": 6}


def cfg(**kw) -> ServiceConfig:
    return ServiceConfig(**CPU64, **kw)


def _mw_config(**kw) -> ServiceConfig:
    base = dict(workers=2, max_batch=1, quantum_chunks=8,
                supervise_poll_s=0.02, rejoin_base_s=0.02,
                rejoin_max_s=0.2)
    base.update(kw)
    return cfg(**base)


@pytest.fixture(autouse=True)
def _disarm_crash():
    yield
    crashlib.arm(None)


@pytest.fixture
def svc():
    s = SwarmService(cfg(max_batch=2, quantum_chunks=2))
    yield s
    s.close()


def _same_result(got, want) -> None:
    assert got.ok and want.ok
    assert got.value["digest"] == want.value["digest"]
    assert got.value["chunk_digests"] == want.value["chunk_digests"]
    assert np.array_equal(got.value["q"], want.value["q"])


def _events(journal, rid: str) -> list:
    rows, torn = LifecycleLog.read(Path(journal) / "events.log")
    assert not torn
    return [r for r in rows if r.get("request_id") == rid]


def _gap_free(events: list, rid: str, res) -> bool:
    """The postmortem's verdict on one request's journaled events: complete
    and gap-free, under the result's trace id and chunk count."""
    rep = postmortem.analyze_request(events, rid)
    assert rep["problems"] == [], rep["problems"]
    return (rep["complete"] and rep["gap_free"]
            and rep["trace_id"] == res.trace_id
            and rep["chunks"] == res.chunks)


# ------------------------------------------------------------- config

def test_unported_config_fields_raise():
    """``cpu_fallback`` raises (no CPU re-run); ``watch=True`` builds the
    health tier and its ``health`` kind reports live SLO verdicts."""
    with SwarmService(cfg(watch=True, watch_interval_s=0.05)) as svc:
        svc.watch.sampler.tick()          # deterministic first sample
        h = svc.submit("health", {}).result(60)
        assert h.ok and h.value["watch_enabled"]
        watch = h.value["watch"]
        assert set(watch["verdicts"]) == {
            "availability", "latency_p99", "goodput", "silent_loss",
            "worker_up", "queue_saturation"}
        assert watch["firing"] == [] and watch["sampler"]["samples"] >= 1
    with pytest.raises(NotImplementedError, match="CPU"):
        SwarmService(cfg(cpu_fallback=True), start=False)
    with pytest.raises(ValueError, match="dtype"):
        SwarmService(ServiceConfig(device="cpu", dtype="float16"),
                     start=False)


# ------------------------------------------------------------- lifecycle

class TestLifecycle:
    def test_rollout_completes_and_streams_chunks(self, svc):
        t = svc.submit("rollout", ROLL, tenant="a")
        res = t.result(timeout=240)
        assert res.status == COMPLETED and res.ok
        assert res.value["q"].shape == (5, 3)
        assert res.value["q"].dtype == np.float64
        assert res.value["ticks"] == 60 and res.chunks == 3
        events = list(t.stream(timeout=1))
        assert [e.payload["chunk"] for e in events] == [0, 1, 2]
        assert events[-1].payload["digest"] == res.value["digest"]

    def test_mixed_kinds_complete(self, svc):
        ta = svc.submit("assign", {"n": 10, "seed": 1}, tenant="a")
        tl = svc.submit("assign", {"n": 10, "seed": 1, "solver": "lap"},
                        tenant="a")
        tg = svc.submit("gains", {"n": 5, "seed": 2}, tenant="b")
        ra, rl, rg = ta.result(240), tl.result(240), tg.result(240)
        assert ra.ok and sorted(ra.value["perm"]) == list(range(10))
        assert rl.ok and sorted(rl.value["perm"]) == list(range(10))
        assert rg.ok and rg.value["gains"].shape == (15, 15)

    def test_unknown_kind_and_bad_params_refused_at_submit(self, svc):
        with pytest.raises(ValueError, match="unknown request kind"):
            svc.submit("nope", {})
        with pytest.raises(ValueError, match="multiple of"):
            svc.submit("rollout", {"n": 5, "ticks": 40, "chunk_ticks": 30,
                                   "assign_every": 20})
        with pytest.raises(ValueError, match="chunks run whole"):
            svc.submit("rollout", {"n": 5, "ticks": 50,
                                   "chunk_ticks": 20})
        with pytest.raises(ValueError, match="faults"):
            svc.submit("rollout", dict(ROLL, faults={"bogus_key": 1}))
        with pytest.raises(ValueError, match="information model"):
            svc.submit("scenario", dict(ROLL, family="sensor_noise"))

    def test_duplicate_submission_idempotent(self, svc):
        t1 = svc.submit("rollout", ROLL, tenant="a", request_id="dup")
        t2 = svc.submit("rollout", ROLL, tenant="a", request_id="dup")
        assert t1 is t2
        res = t1.result(timeout=240)
        assert res.ok
        t3 = svc.submit("rollout", ROLL, tenant="a", request_id="dup")
        assert t3.result(timeout=5).value["digest"] \
            == res.value["digest"]
        assert svc.stats["accepted"] == 1 and svc.stats["completed"] == 1

    def test_racing_duplicate_submits_one_execution(self, svc):
        tickets, barrier = [], threading.Barrier(8)

        def go():
            barrier.wait()
            tickets.append(svc.submit("rollout", ROLL, tenant="a",
                                      request_id="race"))

        threads = [threading.Thread(target=go) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        assert len(tickets) == 8
        assert all(t is tickets[0] for t in tickets)
        assert tickets[0].result(timeout=240).ok
        assert svc.stats["accepted"] == 1

    def test_stream_timeout_raises_and_end_marker_sticky(self, svc):
        t = svc.submit("rollout", ROLL, tenant="a")
        assert t.result(timeout=240).ok
        assert [e.payload["chunk"] for e in t.stream(timeout=1)] \
            == [0, 1, 2]
        assert list(t.stream(timeout=1)) == []
        with pytest.raises(TimeoutError, match="no chunk event"):
            next(Ticket("never-resolved").stream(timeout=0.05))

    def test_stats_and_health_kinds_scrape_the_service(self, svc):
        assert svc.submit("assign", {"n": 6, "seed": 1}).result(240).ok
        rp = svc.submit("stats", {"format": "prometheus"}).result(120)
        assert rp.ok and "serve_accepted_total" in rp.value["text"]
        assert "lock_hold_s" in rp.value["text"]
        rs = svc.submit("stats", {"format": "snapshot"}).result(120)
        assert rs.ok and rs.value["serve"]["accepted"] >= 2
        rbad = svc.submit("stats", {"format": "nope"}).result(120)
        assert not rbad.ok and rbad.error.code == "execution_failed"
        rh = svc.submit("health", {}).result(120)
        assert rh.ok and rh.value["alive"] and rh.value["watch"] is None
        assert rh.value["workers"] == {"total": 1, "up": 1,
                                       "per_worker": {"0": True}}

    def test_terminal_requests_retire_to_bounded_cache(self):
        svc = SwarmService(cfg(done_retention=2))
        results = [
            svc.submit("assign", {"n": 6, "seed": i},
                       request_id=f"r{i}").result(timeout=240)
            for i in range(4)]
        assert all(r.ok for r in results)
        assert svc._jobs == {}
        assert set(svc._done_prior) == {"r2", "r3"}
        replay = svc.submit("assign", {"n": 6, "seed": 3},
                            request_id="r3").result(timeout=5)
        assert replay.ok and svc.stats["accepted"] == 4
        svc.close()


# ------------------------------------------- admission and backpressure

class TestAdmission:
    def test_queue_full_rejection_with_retry_after(self):
        svc = SwarmService(cfg(max_queue_per_tenant=2, max_queue_total=3),
                           start=False)
        svc.submit("rollout", ROLL, tenant="a")
        svc.submit("rollout", ROLL, tenant="a")
        with pytest.raises(RejectedError) as ei:
            svc.submit("rollout", ROLL, tenant="a")
        assert ei.value.retry_after_s > 0 and "cap" in str(ei.value)
        svc.submit("rollout", ROLL, tenant="b")
        with pytest.raises(RejectedError) as ei:
            svc.submit("rollout", ROLL, tenant="c")
        assert "global cap" in str(ei.value)
        assert svc.stats["rejected"] == 2 and svc.stats["accepted"] == 3
        svc.close(drain=False)

    def test_rejected_work_is_not_owed(self, tmp_path):
        svc = SwarmService(cfg(max_queue_per_tenant=1,
                               journal_dir=str(tmp_path)), start=False)
        svc.submit("rollout", ROLL, tenant="a", request_id="kept")
        with pytest.raises(RejectedError):
            svc.submit("rollout", ROLL, tenant="a", request_id="bounced")
        reqs = {p.name for p in tmp_path.glob("req_*.req")}
        assert reqs == {"req_kept.req"}
        svc.close(drain=False)


# ----------------------------------------------------------- deadlines

class TestDeadlines:
    def test_deadline_expiring_during_chunks(self, svc):
        assert svc.submit("rollout", dict(ROLL, ticks=20, seed=1),
                          tenant="warm").result(timeout=240).ok
        tshort = svc.submit("rollout", dict(ROLL, seed=9), tenant="b")
        tlong = svc.submit(
            "rollout", {"n": 5, "ticks": 100_000, "chunk_ticks": 20,
                        "seed": 8},
            tenant="a", deadline_s=2.0)
        rlong = tlong.result(timeout=240)
        assert rlong.status == TIMED_OUT and not rlong.ok
        assert rlong.error.code == "deadline_exceeded"
        assert "chunk boundary" in rlong.error.message
        assert 0 < rlong.chunks < 5000
        assert tshort.result(timeout=240).ok

    def test_expired_on_arrival(self, svc):
        r = svc.submit("rollout", ROLL, deadline_s=0.0).result(timeout=60)
        assert r.status == TIMED_OUT and r.chunks == 0
        assert r.error.code == "deadline_exceeded"


# --------------------------------------------- preemption + bit-parity

class TestPreemption:
    def test_preempt_then_resume_bit_parity_under_faults(self):
        """Two tenants contend for ONE batch slot with a 1-chunk quantum:
        both rollouts (one with an active FaultSchedule) are preempted
        through the checkpoint codec repeatedly and finish bit-identical
        to uncontended solo runs."""
        ref = SwarmService(cfg(max_batch=4))
        r_ref = [ref.submit("rollout", p).result(240)
                 for p in (ROLL_FAULTED, dict(ROLL, seed=7))]
        ref.close()
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1))
        ta = svc.submit("rollout", ROLL_FAULTED, tenant="a")
        tb = svc.submit("rollout", dict(ROLL, seed=7), tenant="b")
        ra, rb = ta.result(timeout=240), tb.result(timeout=240)
        svc.close()
        assert ra.preemptions > 0 and rb.preemptions > 0
        assert svc.stats["preempted"] >= 2
        for got, want in ((ra, r_ref[0]), (rb, r_ref[1])):
            _same_result(got, want)


# ------------------------------------------------- staged-round parity

class TestStagedParity:
    """Staged rounds (submit-time prep, staging stores, pipelining, one
    host copy per round) equal the pack-at-round-time path
    (``staging=False``) bit for bit."""

    def _legacy(self, specs, **kw):
        svc = SwarmService(cfg(max_batch=2, staging=False, **kw))
        out = [svc.submit("rollout", s).result(timeout=240) for s in specs]
        svc.close()
        assert all(r.ok for r in out)
        return out

    @pytest.mark.parametrize("pipeline", [True, False])
    def test_staged_rounds_bit_identical_to_legacy(self, pipeline):
        specs = [ROLL, ROLL_FAULTED,
                 dict(ROLL, assignment="sinkhorn", seed=3)]
        want = self._legacy(specs)
        svc = SwarmService(cfg(max_batch=2, pipeline=pipeline))
        got = [t.result(timeout=240)
               for t in [svc.submit("rollout", s) for s in specs]]
        svc.close()
        for g, w in zip(got, want):
            _same_result(g, w)

    def test_staged_parity_across_preemption_resume(self):
        specs = [ROLL_FAULTED, dict(ROLL, seed=7)]
        want = self._legacy(specs)
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1))
        ts = [svc.submit("rollout", s, tenant=f"t{i}")
              for i, s in enumerate(specs)]
        got = [t.result(timeout=240) for t in ts]
        svc.close()
        assert any(r.preemptions > 0 for r in got)
        for g, w in zip(got, want):
            _same_result(g, w)

    def test_store_eviction_keeps_bit_parity(self):
        """Six rollouts through a one-slot batch: the staging store (two
        rows) evicts residents back to their own rows and re-stages them,
        and every result still equals the legacy path's."""
        specs = [dict(ROLL, seed=20 + i) for i in range(6)]
        want = self._legacy(specs)
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1))
        ts = [svc.submit("rollout", s, tenant=f"t{i}")
              for i, s in enumerate(specs)]
        got = [t.result(timeout=240) for t in ts]
        svc.close()
        for g, w in zip(got, want):
            _same_result(g, w)

    def test_staged_parity_across_worker_kill_migration(self, tmp_path):
        want = self._legacy([ROLL_FAULTED])[0]
        svc = SwarmService(cfg(workers=2, max_batch=1, quantum_chunks=8,
                               journal_dir=str(tmp_path),
                               supervise_poll_s=0.02, rejoin_base_s=0.05))
        slot = place_slot(bucket_of("rollout", ROLL_FAULTED), [0, 1])
        crashlib.arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        got = svc.submit("rollout", ROLL_FAULTED).result(timeout=240)
        crashlib.arm(None)
        svc.close()
        assert got.failovers >= 1
        _same_result(got, want)


# -------------------------------------------------------- trace continuity

class TestTraceContinuity:
    def test_trace_id_constant_across_preemption_resume(self, tmp_path):
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1,
                               journal_dir=str(tmp_path)))
        ta = svc.submit("rollout", ROLL_FAULTED, tenant="a",
                        request_id="pa")
        tb = svc.submit("rollout", dict(ROLL, seed=7), tenant="b",
                        request_id="pb")
        ra, rb = ta.result(timeout=240), tb.result(timeout=240)
        svc.close()
        assert ra.ok and rb.ok and ra.preemptions > 0
        assert ra.trace_id and ra.trace_id != rb.trace_id
        for rid, res in (("pa", ra), ("pb", rb)):
            ev = _events(tmp_path, rid)
            assert {r["trace_id"] for r in ev} == {res.trace_id}
            assert _gap_free(ev, rid, res)
        names = [r["event"] for r in _events(tmp_path, "pa")]
        assert "preempted" in names and "resumed" in names

    def test_trace_id_constant_across_crash_recovery(self, tmp_path):
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1,
                               journal_dir=str(tmp_path),
                               max_worker_restarts=0,
                               supervise_poll_s=0.02))
        crashlib.arm(CrashPlan("serve", 2, "raise"))
        svc.submit("rollout", ROLL_FAULTED, tenant="a", request_id="roll")
        deadline = time.monotonic() + 60
        while svc.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not svc.alive
        crashlib.arm(None)
        tid_before = svc._jobs["roll"].req.trace_id

        svc2 = SwarmService(cfg(max_batch=1, journal_dir=str(tmp_path)))
        res = svc2.submit("rollout", ROLL_FAULTED,
                          request_id="roll").result(timeout=240)
        svc2.close()
        assert res.ok and res.resumed and res.trace_id == tid_before
        ev = _events(tmp_path, "roll")
        assert {r["trace_id"] for r in ev} == {tid_before}
        assert _gap_free(ev, "roll", res)
        names = [r["event"] for r in ev]
        # the crash gap reads queued(recovery) -> batched -> resumed
        rec = names.index("queued", names.index("queued") + 1) \
            if names.count("queued") > 1 else None
        assert any(r["event"] == "queued" and r["reason"] == "recovery"
                   for r in ev) and rec is not None
        assert "resumed" in names[rec:]

    def test_result_trace_id_explicit_and_minted(self):
        svc = SwarmService(cfg(), start=False)
        t = svc.submit("assign", {"n": 6}, trace_id="feedface00000001")
        assert svc._jobs[t.request_id].req.trace_id == "feedface00000001"
        t2 = svc.submit("assign", {"n": 6, "seed": 2})
        assert len(svc._jobs[t2.request_id].req.trace_id) == 16
        svc.close(drain=False)


# ------------------------------------------------- crash + journal recovery

class TestRecovery:
    def test_worker_death_mid_batch_loses_nothing(self, tmp_path):
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1,
                               journal_dir=str(tmp_path),
                               max_worker_restarts=0,
                               supervise_poll_s=0.02))
        crashlib.arm(CrashPlan("serve", 3, "raise"))
        svc.submit("rollout", ROLL_FAULTED, tenant="a", request_id="roll")
        svc.submit("assign", {"n": 10, "seed": 4}, tenant="b",
                   request_id="asg")
        deadline = time.monotonic() + 60
        while svc.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        assert not svc.alive
        done = {p.name for p in tmp_path.glob("req_*.done")}
        reqs = {p.name for p in tmp_path.glob("req_*.req")}
        assert reqs == {"req_roll.req", "req_asg.req"}
        assert len(done) < 2

        svc2 = SwarmService(cfg(max_batch=1, journal_dir=str(tmp_path)))
        t_roll = svc2.submit("rollout", ROLL_FAULTED, request_id="roll")
        t_asg = svc2.submit("assign", {"n": 10, "seed": 4},
                            request_id="asg")
        r_roll, r_asg = t_roll.result(timeout=240), \
            t_asg.result(timeout=240)
        svc2.close()
        assert r_roll.ok and r_asg.ok and r_roll.resumed
        assert svc2.stats["resumed"] == 1
        ref = SwarmService(cfg())
        want = ref.submit("rollout", ROLL_FAULTED).result(240)
        ref.close()
        _same_result(r_roll, want)

    def test_resubmit_after_restart_replays_journaled_result(
            self, tmp_path):
        svc = SwarmService(cfg(journal_dir=str(tmp_path)))
        want = svc.submit("rollout", ROLL, request_id="r1").result(240)
        svc.close()
        svc2 = SwarmService(cfg(journal_dir=str(tmp_path)), start=False)
        got = svc2.submit("rollout", ROLL, request_id="r1").result(1)
        assert got.ok and got.value["digest"] == want.value["digest"]
        assert svc2.stats["accepted"] == 0
        svc2.close(drain=False)

    def test_float32_checkpoint_refused_by_a_float64_service(self,
                                                             tmp_path):
        """A journaled float32 rollout killed mid-flight is not resumed by
        a float64 service: the checkpoint's fingerprint names its dtype,
        and the request fails loudly instead of mixing precisions."""
        svc = SwarmService(ServiceConfig(device="cpu", dtype="float32",
                                         max_batch=1, quantum_chunks=1,
                                         journal_dir=str(tmp_path),
                                         max_worker_restarts=0,
                                         supervise_poll_s=0.02))
        crashlib.arm(CrashPlan("serve", 2, "raise"))
        svc.submit("rollout", ROLL, request_id="r32")
        deadline = time.monotonic() + 60
        while svc.alive and time.monotonic() < deadline:
            time.sleep(0.05)
        crashlib.arm(None)
        assert list((tmp_path / "ckpt").glob("req_r32.c*.ckpt"))
        svc2 = SwarmService(cfg(journal_dir=str(tmp_path)))
        res = svc2.submit("rollout", ROLL, request_id="r32").result(60)
        svc2.close()
        assert res.status == FAILED and "dtype" in res.error.message


# ----------------------------------------------- warm gains over the wire

class TestGainsWarmCarry:
    def test_warm_bootstrap_bitwise_legacy_then_reseed(self, svc):
        legacy = svc.submit("gains", {"n": 5, "seed": 3},
                            tenant="a").result(240)
        warm = svc.submit("gains", {"n": 5, "seed": 3, "warm": True},
                          tenant="a").result(240)
        assert legacy.ok and warm.ok and "carry" not in legacy.value
        assert np.array_equal(warm.value["gains"], legacy.value["gains"])
        carry = warm.value["carry"]
        assert all(isinstance(v, np.ndarray) for v in carry.values())
        re = svc.submit("gains", {"n": 5, "seed": 3, "carry": carry},
                        tenant="a").result(240)
        assert re.ok and "carry" in re.value
        np.testing.assert_allclose(re.value["gains"],
                                   legacy.value["gains"], atol=5e-3)


# ------------------------------------------------- fairness + shutdown

class TestFairnessAndShutdown:
    def test_flooding_tenant_cannot_starve_another(self):
        svc = SwarmService(cfg(max_batch=1, quantum_chunks=1,
                               max_queue_per_tenant=8), start=False)
        flood = [svc.submit("rollout", dict(ROLL, seed=50 + i),
                            tenant="a") for i in range(6)]
        tb = svc.submit("rollout", dict(ROLL, seed=99), tenant="b")
        svc.start()
        assert tb.result(timeout=240).ok
        assert sum(1 for t in flood if t.done) < 6
        for t in flood:
            assert t.result(timeout=240).ok
        svc.close()

    def test_all_tenants_idle_clean_shutdown(self):
        svc = SwarmService(cfg())
        assert svc.submit("assign", {"n": 8}).result(timeout=240).ok
        svc.close()
        assert not svc.alive and svc.stats["failovers"] == 0
        svc.close()
        with pytest.raises(RejectedError, match="shutdown"):
            svc.submit("assign", {"n": 8})

    def test_close_during_a_respawn_skips_the_unstarted_thread(self):
        """A slot respawned at the instant `close` joins the fleet has a
        registered thread that has not started yet: joining it would
        raise, and it has done no work, so the join passes it by."""
        svc = SwarmService(cfg(), start=False)
        svc._pool._slots[0].thread = threading.Thread(target=lambda: None)
        svc._pool.join(0.1)
        svc.close(drain=False)

    def test_nondrain_close_resolves_queued_with_structured_error(self):
        svc = SwarmService(cfg(), start=False)
        t = svc.submit("rollout", ROLL)
        svc.close(drain=False)
        r = t.result(timeout=5)
        assert r.status == FAILED and r.error.code == "service_shutdown"

    def test_drain_timeout_is_loud_not_silent(self):
        svc = SwarmService(cfg(max_batch=1))
        t = svc.submit("rollout", {"n": 5, "ticks": 10_000,
                                   "chunk_ticks": 20, "seed": 3})
        time.sleep(0.3)
        svc.close(drain=True, timeout=0.2)
        r = t.result(timeout=60)
        assert r.status == FAILED and r.error.code == "service_shutdown"
        assert "abandoned the drain" in r.error.message


# ------------------------------------------------------- client helpers

class TestSubmitAndWait:
    def test_structured_nonanswers(self):
        svc = SwarmService(cfg(), start=False)
        r = submit_and_wait(svc, "assign", {"n": 6}, poll_s=0.05,
                            client_timeout_s=10.0)
        assert r.status == FAILED and r.error.code == "worker_died"
        svc.close(drain=False)
        svc2 = SwarmService(cfg(max_queue_per_tenant=1), start=False)
        svc2.submit("assign", {"n": 6})
        r2 = submit_and_wait(svc2, "assign", {"n": 6}, reject_retries=0)
        assert r2.status == FAILED and r2.error.code == "queue_full"
        assert r2.error.detail["retry_after_s"] > 0
        svc2.close(drain=False)

    def test_retry_after_honored_by_default(self):
        svc = SwarmService(cfg(max_queue_per_tenant=1, max_batch=1,
                               idle_poll_s=0.01), start=False)
        svc.submit("assign", {"n": 6, "seed": 1})
        starter = threading.Timer(0.6, svc.start)
        starter.start()
        r = submit_and_wait(svc, "assign", {"n": 6, "seed": 2},
                            reject_retries=16, client_timeout_s=120)
        starter.join()
        assert r.ok, r.error
        assert svc.stats["rejected"] >= 1
        svc.close()
        svc2 = SwarmService(cfg(max_queue_per_tenant=1), start=False)
        svc2.submit("assign", {"n": 6})
        r2 = submit_and_wait(svc2, "assign", {"n": 6},
                             reject_retries=2, max_retry_wait_s=0.05)
        assert r2.status == FAILED and r2.error.code == "queue_full"
        assert svc2.stats["rejected"] == 3
        svc2.close(drain=False)

    def test_client_timeout_while_service_still_owes(self):
        svc = SwarmService(cfg())
        r = submit_and_wait(
            svc, "rollout", {"n": 5, "ticks": 10_000, "chunk_ticks": 20,
                             "seed": 1},
            poll_s=0.1, client_timeout_s=0.3)
        assert r.status == FAILED and r.error.code == "client_timeout"
        svc.close(drain=False)


# -------------------------------------------- multi-worker + failover

class TestMultiWorker:
    def test_place_slot_deterministic_and_minimal_rematch(self):
        buckets = [("rollout", n, 20, "auction", 20)
                   for n in (5, 8, 16, 100)] + [("single", "assign")]
        before = {b: place_slot(b, [0, 1, 2]) for b in buckets}
        assert before == {b: place_slot(b, [0, 1, 2]) for b in buckets}
        after = {b: place_slot(b, [1, 2]) for b in buckets}
        for b in buckets:
            if before[b] != 0:
                assert after[b] == before[b]
            else:
                assert after[b] in (1, 2)
        assert place_slot(("x",), []) is None

    def test_place_slot_equals_the_references(self):
        from aclswarm_tpu.serve import place_slot as jplace
        buckets = [("rollout", n, 20, a, 20) for n in (5, 8, 1000)
                   for a in ("auction", "sinkhorn")] + [("single", "gains")]
        for b in buckets:
            for cands in ([0, 1], [0, 1, 2], [1, 2], ["0.1", "1.3"]):
                assert place_slot(b, cands) == jplace(b, cands)

    def test_submit_and_wait_returns_migrated_result(self):
        ref = SwarmService(cfg())
        want = ref.submit("rollout", MW_ROLL).result(240)
        ref.close()
        svc = SwarmService(_mw_config())
        slot = place_slot(bucket_of("rollout", MW_ROLL), [0, 1])
        crashlib.arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        r = submit_and_wait(svc, "rollout", MW_ROLL, poll_s=0.1,
                            client_timeout_s=240)
        assert r.ok, r.error
        assert r.failovers >= 1
        assert r.value["digest"] == want.value["digest"]
        assert svc.stats["failovers"] >= 1 and svc.stats["requeued"] >= 1
        svc.close()

    def test_stream_survives_migration(self):
        svc = SwarmService(_mw_config())
        slot = place_slot(bucket_of("rollout", MW_ROLL), [0, 1])
        crashlib.arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        t = svc.submit("rollout", MW_ROLL, tenant="a")
        chunks = [ev.payload["chunk"] for ev in t.stream(timeout=240)]
        assert t.done and t.result(timeout=5).ok
        assert chunks == list(range(4))
        svc.close()

    def test_poisoned_request_bounded_and_fleet_survives(self):
        from aclswarm_torch.resilience import InjectedCrash
        svc = SwarmService(_mw_config(max_worker_exclusions=2,
                                      max_worker_restarts=6))
        svc.register("poison", lambda p: (_ for _ in ()).throw(
            InjectedCrash("poison")))
        rp = svc.submit("poison", {}, tenant="evil").result(timeout=120)
        assert rp.status == FAILED and rp.error.code == "poisoned"
        assert rp.failovers == 2 and svc.stats["poisoned"] == 1
        assert svc.submit("assign", {"n": 8, "seed": 2},
                          tenant="good").result(timeout=120).ok
        assert svc.alive
        svc.close()

    def test_poison_bound_holds_under_pipelined_load(self):
        from aclswarm_torch.resilience import InjectedCrash
        svc = SwarmService(_mw_config(max_worker_exclusions=2,
                                      max_worker_restarts=12))
        svc.register("poison", lambda p: (_ for _ in ()).throw(
            InjectedCrash("poison")))
        rolls = [svc.submit("rollout", dict(MW_ROLL, seed=80 + i),
                            tenant=f"t{i % 2}") for i in range(3)]
        rp = svc.submit("poison", {}, tenant="evil").result(timeout=240)
        assert rp.status == FAILED and rp.error.code == "poisoned"
        for t in rolls:
            assert t.result(timeout=240).ok
        assert svc.stats["poisoned"] == 1 and svc.alive
        svc.close()

    def test_innocent_batch_mates_of_kills_are_exonerated(self):
        from aclswarm_torch.resilience import arm_many
        specs = [dict(MW_ROLL, seed=41), dict(MW_ROLL, seed=42)]
        ref = SwarmService(cfg(max_batch=4))
        want = [ref.submit("rollout", s).result(240) for s in specs]
        ref.close()
        svc = SwarmService(_mw_config(max_batch=2, max_worker_exclusions=2,
                                      max_worker_restarts=9))
        slot = place_slot(bucket_of("rollout", MW_ROLL), [0, 1])
        arm_many([CrashPlan(f"serve.w{slot}", 2, "raise"),
                  CrashPlan(f"serve.w{slot}", 5, "raise")])
        ts = [svc.submit("rollout", s, tenant="a") for s in specs]
        res = [t.result(timeout=240) for t in ts]
        arm_many([])
        assert svc.stats["failovers"] >= 1 and svc.stats["poisoned"] == 0
        for r, w in zip(res, want):
            assert r.ok, f"innocent batch-mate terminated: {r.error}"
            assert r.value["digest"] == w.value["digest"]
        assert any(r.failovers >= 1 for r in res)
        svc.close()

    def test_trace_id_constant_across_worker_migration(self, tmp_path):
        svc = SwarmService(_mw_config(journal_dir=str(tmp_path)))
        slot = place_slot(bucket_of("rollout", MW_ROLL), [0, 1])
        crashlib.arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        res = svc.submit("rollout", MW_ROLL, tenant="a",
                         request_id="mig").result(timeout=240)
        crashlib.arm(None)
        svc.close()
        assert res.ok and res.failovers >= 1
        ev = _events(tmp_path, "mig")
        assert {r["trace_id"] for r in ev} == {res.trace_id}
        assert _gap_free(ev, "mig", res)
        names = [r["event"] for r in ev]
        assert "migrated" in names and "resumed" in names[
            names.index("migrated"):]
        assert len({r["worker"] for r in ev if r["event"] == "chunk"}) == 2

    def test_retry_after_scales_with_surviving_capacity(self):
        from aclswarm_torch.serve.admission import AdmissionControl
        adm = AdmissionControl(8, 32)
        adm.note_service(1.0)

        class _J:
            def __init__(self):
                self.req = type("R", (), {"tenant": "t"})()
                self.held = False
                self.bucket = ("x",)
        adm.admit(_J(), force=True)
        full = adm.retry_after()
        adm.set_capacity(alive=1, total=2)
        assert adm.retry_after() == pytest.approx(min(30.0, 2 * full))
        adm.set_capacity(alive=0, total=2)
        assert adm.retry_after() == 30.0
        adm.set_capacity(alive=2, total=2)
        assert adm.retry_after() == pytest.approx(full)

    def test_cancel_queued_now_resident_at_boundary(self):
        svc = SwarmService(cfg(max_batch=1), start=False)
        t1 = svc.submit("rollout", dict(ROLL, seed=31), tenant="a",
                        request_id="c1")
        assert svc.cancel("c1", "client vanished")
        r1 = t1.result(timeout=5)
        assert r1.status == FAILED and r1.error.code == "cancelled"
        assert "client vanished" in r1.error.message
        assert not svc.cancel("c1") and not svc.cancel("nonexistent")
        t2 = svc.submit("rollout", {"n": 5, "ticks": 10_000,
                                    "chunk_ticks": 20, "seed": 32},
                        tenant="a", request_id="c2")
        svc.start()
        next(iter(t2.stream(timeout=120)))
        assert svc.cancel("c2", "client vanished mid-run")
        r2 = t2.result(timeout=120)
        assert r2.status == FAILED and r2.error.code == "cancelled"
        assert r2.chunks >= 1
        svc.close()

    def test_worker_telemetry_and_compact_fleet_keys(self):
        from aclswarm_torch.serve import ServeStats
        svc = SwarmService(_mw_config(workers=2))
        assert svc.submit("rollout", dict(ROLL, seed=77)).result(240).ok
        st = svc.serve_stats()
        assert st.workers == 2 and st.workers_up == 2
        assert set(st.per_worker) <= {"0", "1"}
        assert sum(w["chunks"] for w in st.per_worker.values()) >= 3
        c = st.compact()
        assert c["workers"] == 2 and c["failovers"] == 0
        assert set(ServeStats.empty_compact()) == set(c)
        svc.close()


# ------------------------------------------------- parity with the reference

def _script(serve_mod, crash_mod, **svc_kw):
    """One request script through one package's service; returns every
    request's result by id. Submitted before the workers start, so the
    schedule (and with it the preemptions) is the same in both."""
    S, C = serve_mod.SwarmService, serve_mod.ServiceConfig
    out = {}
    svc = S(C(max_batch=2, quantum_chunks=2, **svc_kw), start=False)
    reqs = [("rollout", ROLL, "a", "roll"),
            ("rollout", ROLL_FAULTED, "b", "roll_f"),
            ("rollout", dict(ROLL, assignment="sinkhorn", seed=12), "a",
             "roll_sk"),
            ("scenario", dict(ROLL, family="wind_gust", seed=4), "c",
             "scen"),
            ("assign", {"n": 10, "seed": 1}, "b", "asg_sk"),
            ("assign", {"n": 9, "seed": 2, "solver": "lap"}, "c", "asg_lap"),
            ("assign", {"n": 6, "solver": "bogus"}, "c", "asg_bad"),
            ("gains", {"n": 5, "seed": 2}, "a", "gains"),
            ("rollout", dict(ROLL, seed=8), "b", "late")]
    tickets = {rid: svc.submit(k, p, tenant=t, request_id=rid,
                               deadline_s=0.0 if rid == "late" else None)
               for k, p, t, rid in reqs}
    svc.start()
    out.update({rid: t.result(240) for rid, t in tickets.items()})
    svc.close()
    # contention: one slot, one-chunk quantum — preemptions
    svc = S(C(max_batch=1, quantum_chunks=1, **svc_kw), start=False)
    tickets = {rid: svc.submit("rollout", p, tenant=rid, request_id=rid)
               for rid, p in (("pre_a", ROLL_FAULTED),
                              ("pre_b", dict(ROLL, seed=7)))}
    svc.start()
    out.update({rid: t.result(240) for rid, t in tickets.items()})
    svc.close()
    # failover: the rollout bucket's owner killed at its round 2
    svc = S(C(workers=2, max_batch=1, quantum_chunks=8,
              supervise_poll_s=0.02, rejoin_base_s=0.02, **svc_kw))
    slot = serve_mod.place_slot(serve_mod.bucket_of("rollout", MW_ROLL),
                                [0, 1])
    crash_mod.arm(crash_mod.CrashPlan(f"serve.w{slot}", 2, "raise"))
    out["mig"] = svc.submit("rollout", MW_ROLL,
                            request_id="mig").result(240)
    crash_mod.arm(None)
    svc.close()
    return out


def test_service_matches_the_reference_on_one_script():
    import aclswarm_tpu.serve as jserve
    from aclswarm_tpu.resilience import crash as jcrash

    import aclswarm_torch.serve as tserve

    want = _script(jserve, jcrash)
    got = _script(tserve, crashlib, **CPU64)
    assert got.keys() == want.keys()
    for rid in want:
        g, w = got[rid], want[rid]
        assert (g.status, g.chunks, g.preemptions, g.failovers) \
            == (w.status, w.chunks, w.preemptions, w.failovers), rid
        assert (g.error and g.error.code) == (w.error and w.error.code), rid
        if w.ok and "q" in w.value:
            # float64; the engines differ in the last bits, so the
            # digests differ and the positions agree within 1e-9
            np.testing.assert_allclose(g.value["q"], np.asarray(
                w.value["q"]), rtol=0, atol=1e-9, err_msg=rid)
            assert g.value["ticks"] == w.value["ticks"]
        if w.ok and "perm" in w.value:
            assert np.array_equal(g.value["perm"], w.value["perm"]), rid
    assert got["pre_a"].preemptions > 0 and got["mig"].failovers == 1
    assert got["late"].status == TIMED_OUT
    assert got["asg_bad"].error.code == "execution_failed"


# ----------------------------------------------------------- smoke drills

@pytest.mark.parametrize("extra", [[], ["--multiworker"]],
                         ids=["recovery", "multiworker"])
def test_serve_smoke_subprocess(extra):
    """The smoke drills on the CPU at n=5: the child process SIGKILLed at
    serve round 3 and its journal recovery, and the worker-kill
    failover seen live by the health tier; each PASSes within its own
    time limit."""
    r = subprocess.run(
        [sys.executable, "-m", "aclswarm_torch.serve.smoke", "--device",
         "cpu", "--dtype", "float64", *extra],
        capture_output=True, text=True, timeout=240, cwd=str(REPO),
        env={**__import__("os").environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "PASS" in r.stdout


@pytest.mark.parametrize("flag", ["--postmortem", "--procs"])
def test_smoke_names_the_slices_it_lacks(flag, capsys):
    """``--postmortem`` runs its drill (a worker killed mid-rollout, the
    timeline rebuilt from the journal alone) and passes; ``--procs``, no
    longer a slice the port lacks, runs the process-mode drill (a router
    over two procworker processes, one SIGKILLed) and passes."""
    from aclswarm_torch.serve import smoke
    assert smoke.main([flag, "--device", "cpu", "--dtype", "float64"]) == 0
    assert "PASS" in capsys.readouterr().out

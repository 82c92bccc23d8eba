"""The port's process mode (`aclswarm_torch.serve.router` +
`serve.procworker`): the cases of `tests/test_router.py` against the
port's router, on the CPU in float64.

As in the reference's file, the supervision protocol (HELLO arbitration,
leases, READY) runs in-process with raw wire frames and real in-process
worker cells (a `SwarmService` + `WireServer` per fake slot), so
placement, failover, fencing and the journal audit run at thread-test
speed. Real child processes run in two cases: the duplicate-HELLO race
(two OS processes claim one slot: exactly one admitted, the loser exits
3 with the structured refusal and never writes a journal frame) and the
`serve.smoke --procs` drill on the CPU.

The race is the reference's, steadied: the winner holds its claim until
the router has refused the loser (``router_hello_refused_total`` reads
1, within a deadline) and is then released by the router's ``die``, in
place of a fixed 2 s hold that a slow loser (a torch import under a
loaded host) could outlast — what it asserts is unchanged.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from aclswarm_torch.interop import transport
from aclswarm_torch.resilience import checkpoint as ckptlib
from aclswarm_torch.serve import ServiceConfig, SwarmService, wire
from aclswarm_torch.serve.router import (DEAD, UP, RouterConfig,
                                         SwarmRouter)
from aclswarm_torch.serve.service import (bucket_of, read_fence,
                                          write_fence)
from aclswarm_torch.serve.workers import place_slot

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

REPO = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu", dtype="float64")
ROLL = {"n": 5, "ticks": 60, "chunk_ticks": 20, "seed": 5}
SLOW_ROLL = {"n": 5, "ticks": 400, "chunk_ticks": 20, "seed": 7}


# ------------------------------------------------------------ placement

class TestPlacement:
    def test_place_slot_accepts_string_uids(self):
        uids = ["0.1", "1.4", "2.2"]
        pick = place_slot(("single", "assign"), uids)
        assert pick in uids
        assert all(place_slot(("single", "assign"), uids) == pick
                   for _ in range(5))

    def test_place_slot_matches_reference(self):
        """The port's rendezvous picks what the reference's picks, over
        string uids and int slots alike."""
        from aclswarm_tpu.serve.workers import place_slot as ref_place
        for bucket in [("rollout", n, c) for n in (3, 5, 8)
                       for c in (10, 20)] + [("single", "assign")]:
            for cands in (["0.1", "1.2", "2.1", "3.1"], [0, 1, 2, 3]):
                assert place_slot(bucket, cands) == ref_place(bucket, cands)

    def test_incarnation_set_minimal_disruption(self):
        """Death: only the dead node's buckets move. Respawn: a bucket
        never moves between surviving incarnations."""
        old = [f"{s}.1" for s in range(4)]
        survivors = ["0.1", "2.1", "3.1"]
        new = ["0.1", "1.2", "2.1", "3.1"]
        buckets = [("rollout", n, c) for n in (3, 5, 8)
                   for c in (10, 20)] + [("single", "assign")]
        for b in buckets:
            was = place_slot(b, old)
            if was != "1.1":
                assert place_slot(b, survivors) == was
                assert place_slot(b, new) in (was, "1.2")

    def test_bucket_of_groups_all_plain_kinds(self):
        assert bucket_of("assign", {"n": 5}) \
            == bucket_of("assign", {"n": 50})
        assert bucket_of("rollout", ROLL) != bucket_of("assign", ROLL)


# -------------------------------------------------------------- fencing

class TestFence:
    def test_fence_round_trip(self, tmp_path):
        assert read_fence(tmp_path) is None
        write_fence(tmp_path, 3)
        assert read_fence(tmp_path) == 3
        write_fence(tmp_path, 4)
        assert read_fence(tmp_path) == 4

    def test_constructor_refuses_fenced_journal(self, tmp_path):
        write_fence(tmp_path, 5)
        with pytest.raises(RuntimeError, match="fenced"):
            SwarmService(ServiceConfig(journal_dir=str(tmp_path),
                                       incarnation=4, **CPU), start=False)

    def test_zombie_journal_writes_noop(self, tmp_path):
        """A fenced predecessor's journal writes are loud no-ops."""
        from aclswarm_torch.serve import RejectedError

        svc = SwarmService(ServiceConfig(journal_dir=str(tmp_path),
                                         incarnation=1, max_batch=1, **CPU))
        svc.submit("rollout", ROLL, tenant="a",
                   request_id="pre-fence").result(timeout=120)
        write_fence(tmp_path, 2)
        time.sleep(SwarmService.FENCE_CHECK_S * 3)

        def frames():
            return sorted((str(p), p.stat().st_size)
                          for p in tmp_path.rglob("*") if p.is_file()
                          and p.name != "spans_dump.jsonl")

        before = frames()
        with pytest.raises(RejectedError):
            svc.submit("rollout", dict(ROLL, seed=9), tenant="a",
                       request_id="post-fence")
        svc.close(drain=True, timeout=30.0)
        assert frames() == before, \
            "zombie wrote journal frames past the fence"
        assert svc.telemetry.counter("serve_fenced_total").value >= 1


# ------------------------------------------- supervision-wire machinery

def _sup_connect(router):
    host, port = router._sup.address
    return transport.connect_when_ready(host, int(port), grace_s=5.0)


def _hello(chan, slot, inc, pid=None, role="procworker", timeout_s=5.0):
    chan.send_bytes(wire._frame(wire.K_HELLO, {
        "client": f"proc.w{slot}.{inc}", "role": role,
        "slot": slot, "incarnation": inc,
        "pid": pid if pid is not None else os.getpid()}))
    chan.flush()
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        try:
            raw = chan.recv_bytes()
        except OSError:
            return None, None        # closed without a verdict
        if raw is not None:
            payload, man = ckptlib.loads(raw, chan.name)
            return man.get("kind"), payload
        time.sleep(0.01)
    return None, None


@pytest.fixture
def bare_router(tmp_path):
    """A router with its supervision plane live but no children and no
    front server."""
    router = SwarmRouter(RouterConfig(journal_root=str(tmp_path), slots=2,
                                      respawn=False, lease_s=2.0))
    router.start(spawn=False, front=False)
    yield router
    router.close(timeout=10)


class TestArbitration:
    def test_exactly_one_claimant_wins(self, bare_router):
        c1 = _sup_connect(bare_router)
        kind, payload = _hello(c1, 0, 1)
        assert kind == wire.K_HELLO_ACK and payload["accepted"]
        assert payload["lease_s"] == pytest.approx(2.0)
        c2 = _sup_connect(bare_router)
        kind2, p2 = _hello(c2, 0, 1)
        assert kind2 == wire.K_ERROR
        assert p2["error"] == "slot_taken" and p2["owner"] == "0.1"
        c1.close()
        c2.close()

    def test_stale_incarnation_refused(self, bare_router):
        c1 = _sup_connect(bare_router)
        assert _hello(c1, 1, 3)[0] == wire.K_HELLO_ACK
        c1.close()                       # connection death -> DEAD
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if any(f["slot"] == 1 and f["state"] == DEAD
                   for f in bare_router.fleet()):
                break
            time.sleep(0.02)
        c2 = _sup_connect(bare_router)
        kind, p = _hello(c2, 1, 2)
        assert kind == wire.K_ERROR
        assert p["error"] == "stale_incarnation" and p["current"] == 3
        c2.close()

    def test_unknown_slot_refused(self, bare_router):
        c = _sup_connect(bare_router)
        kind, p = _hello(c, 97, 1)
        assert kind == wire.K_ERROR and "unknown slot" in p["error"]
        c.close()

    def test_non_procworker_hello_dropped(self, bare_router):
        c = _sup_connect(bare_router)
        kind, _ = _hello(c, 0, 1, role="imposter", timeout_s=1.0)
        assert kind is None
        assert all(f["state"] == DEAD for f in bare_router.fleet())
        c.close()


# ------------------------------------- in-process fleet: the data path

class _FakeWorker:
    """A real worker cell (SwarmService + WireServer) in the test
    process, attached through the genuine supervision handshake; its
    beats carry launch counts like a procworker's."""

    def __init__(self, router, slot, inc, journal_dir, **svc_kw):
        self.slot, self.inc = slot, inc
        write_fence(journal_dir, inc)
        self.svc = SwarmService(ServiceConfig(
            journal_dir=str(journal_dir), incarnation=inc, workers=1,
            **CPU, **svc_kw))
        self.server = wire.WireServer(self.svc, base=None,
                                      tcp=("127.0.0.1", 0))
        self.chan = _sup_connect(router)
        kind, _ = _hello(self.chan, slot, inc)
        assert kind == wire.K_HELLO_ACK
        self.chan.send_bytes(wire._frame(wire.K_EVENT, {
            "event": "ready", "slot": slot, "incarnation": inc,
            "pid": os.getpid(),
            "wire_port": int(self.server.tcp_address[1])}))
        self.chan.flush()
        self._stop = threading.Event()
        self._beat = threading.Thread(target=self._beats, daemon=True)
        self._beat.start()

    def _beats(self):
        while not self._stop.is_set():
            try:
                self.chan.send_bytes(wire._frame(wire.K_PING, {
                    "slot": self.slot, "incarnation": self.inc,
                    "pid": os.getpid(), "stats": {},
                    "launches": {"sinkhorn_log": self.slot}}))
                self.chan.flush()
                while self.chan.recv_bytes() is not None:
                    pass
            except OSError:
                return
            time.sleep(0.3)

    def die(self):
        """Supervision-connection death while the cell keeps running —
        the zombie case."""
        self._stop.set()
        self.chan.close()

    def close(self):
        self._stop.set()
        try:
            self.chan.close()
        except OSError:
            pass
        self.server.close()
        self.svc.close(drain=False, timeout=5.0)


@pytest.fixture
def fleet(tmp_path):
    router = SwarmRouter(RouterConfig(journal_root=str(tmp_path), slots=2,
                                      respawn=False, lease_s=2.0,
                                      max_resubmits=3))
    router.start(spawn=False, front=False)
    workers = [_FakeWorker(router, s, 1, tmp_path / f"w{s}", max_batch=2)
               for s in range(2)]
    assert router.wait_ready(10.0), router.fleet()
    yield router, workers
    for w in workers:
        w.close()
    router.close(timeout=10)


class TestDataPath:
    def test_submit_routes_and_matches_direct(self, fleet):
        router, _ = fleet
        ref = SwarmService(ServiceConfig(max_batch=1, **CPU))
        want = ref.submit("rollout", ROLL).result(timeout=120)
        ref.close()
        got = router.submit("rollout", ROLL, tenant="a",
                            request_id="r-parity").result(timeout=120)
        assert got.ok, got.error
        assert got.value["digest"] == want.value["digest"]

    def test_bucket_spread_and_idempotent_attach(self, fleet):
        router, _ = fleet
        t1 = router.submit("assign", {"n": 5, "seed": 1}, tenant="a",
                           request_id="same-rid")
        t2 = router.submit("assign", {"n": 5, "seed": 1}, tenant="a",
                           request_id="same-rid")
        assert t1 is t2
        assert t1.result(timeout=120).ok

    def test_failover_migrates_inflight(self, fleet):
        """Supervision death mid-flight: the route requeues, rendezvous
        re-places it on the survivor, and the result lands on the
        original front ticket with failovers counted."""
        router, workers = fleet
        t = router.submit("rollout", SLOW_ROLL, tenant="a",
                          request_id="r-migrate")
        deadline = time.monotonic() + 10.0
        uid = ""
        while time.monotonic() < deadline and not uid:
            uid = router.route_uid("r-migrate")
            time.sleep(0.01)
        assert uid, "route never dispatched"
        victim = next(w for w in workers if f"{w.slot}.1" == uid)
        victim.die()
        res = t.result(timeout=120)
        assert res.ok, res.error
        assert res.failovers >= 1
        assert any(d["uid"] == uid and d["requeued"] >= 1
                   for d in router.deaths)
        live = [f for f in router.fleet() if f["state"] == UP]
        assert len(live) == 1 and live[0]["uid"] != uid

    def test_lease_miss_declares_dead(self, fleet):
        router, workers = fleet
        workers[0]._stop.set()           # heartbeats stop, chan stays
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            if any(d["slot"] == 0 and "lease" in d["reason"]
                   for d in router.deaths):
                break
            time.sleep(0.05)
        assert any(d["slot"] == 0 and "lease" in d["reason"]
                   for d in router.deaths), router.deaths

    def test_health_aggregates_processes(self, fleet):
        router, _ = fleet
        h = router.submit("health", {}, tenant="_ops",
                          request_id="h1").result(timeout=30).value
        assert h["router"] is True
        assert set(h["processes"]) == {"0.1", "1.1"}
        for row in h["processes"].values():
            assert row["pid"] == os.getpid()
            assert row["incarnation"] == 1

    def test_beats_carry_launches_and_boots_are_kept(self, fleet):
        """Each incarnation's last beat's launch counts are kept, and each
        READY leaves a boot row."""
        router, _ = fleet
        deadline = time.monotonic() + 5.0
        while len(router.child_launches) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert {uid: c["launches"] for uid, c
                in router.child_launches.items()} == {
            "0.1": {"sinkhorn_log": 0}, "1.1": {"sinkhorn_log": 1}}
        assert sorted(b["uid"] for b in router.boots) == ["0.1", "1.1"]
        assert all(b["boot_s"] >= 0.0 for b in router.boots)

    def test_fleet_journals_reconstruct_gap_free(self, fleet, tmp_path):
        from aclswarm_torch.telemetry import postmortem

        router, workers = fleet
        ts = [router.submit("rollout", dict(ROLL, seed=100 + i),
                            tenant="a", request_id=f"pm-{i}")
              for i in range(3)]
        for t in ts:
            assert t.result(timeout=120).ok
        for w in workers:
            w.close()
        rep = postmortem.fleet_reconstruct([tmp_path / "w0",
                                            tmp_path / "w1"])
        assert rep["losses"] == []
        assert {r for r in rep["requests"] if r.startswith("pm-")} \
            == {"pm-0", "pm-1", "pm-2"}


# ------------------------------------------------- HELLO-ack identity

class TestHelloAckIdentity:
    def test_server_info_carries_pid_and_incarnation(self, tmp_path):
        svc = SwarmService(ServiceConfig(journal_dir=str(tmp_path),
                                         incarnation=7, max_batch=1, **CPU))
        srv = wire.WireServer(svc, base=None, tcp=("127.0.0.1", 0))
        c = wire.WireClient(tcp=srv.tcp_address, client_id="idwatch")
        try:
            assert c.server_info["pid"] == os.getpid()
            assert c.server_info["incarnation"] == 7
        finally:
            c.close()
            srv.close()
            svc.close(drain=False, timeout=5.0)

    def test_watch_identity_delta(self):
        from aclswarm_torch.telemetry.watch import (identities,
                                                    identity_delta)

        h1 = {"pid": 10, "incarnation": 1,
              "processes": {"0.1": {"pid": 20, "incarnation": 1},
                            "1.1": {"pid": 21, "incarnation": 1}}}
        assert identity_delta(identities(h1), identities(h1)) == []
        h2 = {"pid": 10, "incarnation": 1,
              "processes": {"0.1": {"pid": 20, "incarnation": 1},
                            "1.2": {"pid": 35, "incarnation": 2}}}
        delta = identity_delta(identities(h1), identities(h2))
        assert len(delta) == 1
        assert "RESPAWN" in delta[0] and "w1" in delta[0]
        assert "20" not in delta[0] and "35" in delta[0]
        assert identity_delta(identities(h2), identities(h2)) == []


# ------------------------------------- the duplicate-HELLO race (OS)

class TestDuplicateHelloRace:
    def test_two_processes_one_winner(self, tmp_path):
        """Two real OS processes claim the same slot: exactly one is
        admitted, the loser exits 3 with the structured refusal, and the
        loser never writes a journal frame. The winner holds until the
        router has refused the loser, then the router releases it."""
        router = SwarmRouter(RouterConfig(journal_root=str(tmp_path),
                                          slots=1, respawn=False))
        router.start(spawn=False, front=False)
        host, port = router._sup.address
        env = {**os.environ,
               "PYTHONPATH": os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")])}
        cmd = [sys.executable, "-m", "aclswarm_torch.serve.procworker",
               "--slot", "0", "--incarnation", "1",
               "--supervisor", f"{host}:{port}",
               "--handshake-only", "--handshake-hold-s", "120"]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env) for _ in range(2)]
        try:
            refused = router.telemetry.counter("router_hello_refused_total")
            deadline = time.monotonic() + 100
            while refused.value < 1 and time.monotonic() < deadline \
                    and all(p.poll() is None for p in procs):
                time.sleep(0.02)
            assert refused.value == 1
            router.stop_slot(0)          # the router's `die` releases it
            outs = [p.communicate(timeout=60)[0] for p in procs]
            verdicts = []
            for p, out in zip(procs, outs):
                row = next(json.loads(ln) for ln in out.splitlines()
                           if ln.startswith("{"))
                verdicts.append((p.returncode, row))
            codes = sorted(rc for rc, _ in verdicts)
            assert codes == [0, 3], (codes, outs)
            admitted = [v for rc, v in verdicts if rc == 0]
            loser = [v for rc, v in verdicts if rc == 3]
            assert admitted[0]["verdict"] == "ADMITTED"
            assert loser[0]["verdict"] == "REFUSED"
            assert loser[0]["error"] in ("slot_taken", "slot_reserved")
            assert [p for p in Path(tmp_path).rglob("*")
                    if p.is_file()] == []
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            router.close(timeout=10)


class TestRefusalOutsideLock:
    """`_admit` decides a refusal under the router lock and sends it after
    release: a loser with a wedged socket cannot stall the fleet."""

    def test_wedged_loser_does_not_stall_router_lock(self, tmp_path):
        router = SwarmRouter(RouterConfig(journal_root=str(tmp_path),
                                          slots=1, respawn=False))
        in_send = threading.Event()
        release = threading.Event()

        class _WedgedChan:
            name = "wedged-refusal-chan"

            def send_bytes(self, raw):
                in_send.set()
                assert release.wait(10.0), "never released"

            def flush(self):
                pass

            def close(self):
                pass

        raw = wire._frame(wire.K_HELLO, {
            "client": "proc.w999.0", "role": "procworker",
            "slot": 999, "incarnation": 0, "pid": 1})
        t = threading.Thread(target=router._admit,
                             args=(_WedgedChan(), raw), daemon=True)
        try:
            t.start()
            assert in_send.wait(5.0), "refusal send never started"
            assert router._lock.acquire(timeout=2.0), \
                "router lock held across the refusal send"
            router._lock.release()
        finally:
            release.set()
            t.join(5.0)
            router._sup.close()
        assert not t.is_alive()
        snap = router.telemetry.snapshot()["metrics"]
        assert snap["router_hello_refused_total"]["value"] == 1


# --------------------------------------------------- the --procs drill

def test_procs_drill_passes_on_the_cpu():
    """`python -m aclswarm_torch.serve.smoke --procs --device cpu --dtype
    float64`: the rollout's process SIGKILLed mid-flight, zero losses, a
    bit-identical migrated digest, new pids after the rolling restart, a
    gap-free fleet postmortem; its JSON line carries five boots and the
    children's launches (the plain versions on the CPU: none)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "aclswarm_torch.serve.smoke",
                        "--procs", "--device", "cpu", "--dtype", "float64"],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    assert any(ln.startswith("PASS") for ln in r.stdout.splitlines())
    line = next(json.loads(ln) for ln in r.stdout.splitlines()
                if ln.startswith('{"serve_smoke"'))
    assert line["serve_smoke"] == "procs"
    assert len(line["boots"]) == 5 and line["migrated"] >= 1
    assert line["launches"]["children"] == {
        "sinkhorn_log": 0, "round_dominant": 0, "flood_merge": 0}
    assert len(set(line["pids"]["restarted"].values())) == 2

"""The wire front end on the port (`aclswarm_torch.serve.wire`): the
cases of `tests/test_serve_wire.py` in front of the port's `SwarmService`
(on the CPU in float64), and parity with the reference.

External-process semantics over both transports, tested in-process with
real rings and real sockets: submit/accept/event/result round trips
match the direct API bit for bit, a CRC-failing frame is rejected loudly
without touching service state, admission rejection crosses the wire
with its retry-after hint, and a client that stops talking has its
queued entries cancelled with a structured error while resident work
finishes its batch. The TCP classes add the off-host hardening surface:
slow-loris read/write bounds, handshake deadlines, accept-rate bounding,
reconnect attach, and seeded wire-frame fuzzing over both transports.
Parity: the port's codec encodes every message kind to the reference's
bytes and decodes the reference's, and a reference `WireClient` is
served by the port's `WireServer`.

The shm cases need the native library (``make -C native``) and skip
with a reason without it; the TCP cases are pure stdlib. Shm names
carry a ``asw-torchwire-`` prefix and a uuid, every TCP server binds
port 0, and every wait has its own deadline.
"""
from __future__ import annotations

import socket
import time
import uuid

import numpy as np
import pytest
import torch

from aclswarm_torch.interop import codec
from aclswarm_torch.interop import messages as msgs
from aclswarm_torch.interop import native as nat
from aclswarm_torch.serve import FAILED, ServiceConfig, SwarmService
from aclswarm_tpu.interop import codec as ref_codec
from aclswarm_tpu.interop import messages as ref_msgs

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

pytestmark = [pytest.mark.serve]

ROLL = {"n": 5, "ticks": 60, "chunk_ticks": 20, "seed": 5}


def _cfg(**kw) -> ServiceConfig:
    return ServiceConfig(device="cpu", dtype="float64", **kw)


def _need_native() -> None:
    """Build the native library once (under a file lock: test workers
    share the build directory) or skip the calling test."""
    if not nat.build_locked():
        pytest.skip("native transport not built (make -C native)")


@pytest.fixture
def native():
    _need_native()


def _base() -> str:
    return "asw-torchwire-" + uuid.uuid4().hex[:8]


def _tcp_stack(svc, **kw):
    """(server, (host, port)) bound on an ephemeral port."""
    from aclswarm_torch.serve.wire import WireServer

    srv = WireServer(svc, base=None, tcp=("127.0.0.1", 0),
                     client_lease_s=kw.pop("client_lease_s", 30.0), **kw)
    return srv, srv.tcp_address


@pytest.fixture
def stack():
    """(service, server, client) on a unique ring namespace."""
    from aclswarm_torch.serve.wire import WireClient, WireServer

    svc = SwarmService(_cfg(max_batch=2))
    base = _base()
    srv = WireServer(svc, base, client_lease_s=30.0)
    cli = WireClient(base, tenant="ext")
    yield svc, srv, cli
    cli.close()
    srv.close()
    svc.close()


@pytest.mark.usefixtures("native")
class TestWireRoundTrip:
    def test_submit_stream_result_matches_direct_api(self, stack):
        svc, srv, cli = stack
        want = svc.submit("rollout", ROLL, tenant="direct").result(240)
        t = cli.submit("rollout", ROLL)
        res = t.result(timeout=240)
        assert res.ok and res.chunks == 3
        # the wire result is the SAME value the in-process API returns
        assert int(res.value["digest"]) == int(want.value["digest"])
        assert np.array_equal(np.asarray(res.value["q"]),
                              np.asarray(want.value["q"]))
        events = list(t.stream(timeout=1))
        assert [e.payload["chunk"] for e in events] == [0, 1, 2]
        assert events[-1].payload["digest"] == res.value["digest"]

    def test_single_shot_kinds_and_malformed_refusal(self, stack):
        svc, srv, cli = stack
        ra = cli.submit("assign", {"n": 10, "seed": 1}).result(120)
        assert ra.ok
        assert sorted(np.asarray(ra.value["perm"])) == list(range(10))
        # a malformed request is refused with a structured wire error,
        # not accepted-and-failed (admission-time validation holds
        # across the wire)
        rbad = cli.submit("rollout", {"n": 5, "ticks": 50,
                                      "chunk_ticks": 20}).result(60)
        assert rbad.status == FAILED
        assert rbad.error.code == "wire_error"
        assert "chunks run whole" in rbad.error.message
        assert svc.stats["accepted"] == 1   # only the assign

    def test_wire_trace_postmortem_and_stats_scrape(self, tmp_path):
        """swarmtrace across the wire: the CLIENT mints the trace_id,
        the service adopts it (journal acceptance frame + every
        lifecycle event + the result frame), and the postmortem
        reconstructs the whole story from the journal alone. Plus the
        `stats` kind: an off-process client scrapes prometheus text
        over the same rings — no package import needed on the scraper
        side."""
        from aclswarm_torch.serve.wire import WireClient, WireServer
        from aclswarm_torch.telemetry import postmortem

        svc = SwarmService(_cfg(max_batch=2,
                                journal_dir=str(tmp_path)))
        base = _base()
        srv = WireServer(svc, base, client_lease_s=30.0)
        cli = WireClient(base, tenant="ext")
        t = cli.submit("rollout", ROLL, request_id="w-traced",
                       trace_id="beefbeefbeefbeef")
        res = t.result(timeout=240)
        assert res.ok and res.chunks == 3
        # the client-minted id came back on the wire result frame
        assert res.trace_id == "beefbeefbeefbeef"
        # an auto-minted wire trace also round-trips
        r2 = cli.submit("assign", {"n": 6, "seed": 1}).result(120)
        assert r2.ok and len(r2.trace_id) == 16
        # off-process scrape over the wire: prometheus text, no import
        rs = cli.submit("stats", {"format": "prometheus"}).result(120)
        assert rs.ok and "serve_accepted_total" in rs.value["text"]
        cli.close()
        srv.close()
        svc.close()
        # postmortem from the journal alone: the wire-submitted request
        # reconstructs complete + gap-free under the CLIENT's trace_id
        rep = postmortem.reconstruct(tmp_path)
        wt = rep["requests"]["w-traced"]
        assert wt["complete"] and wt["gap_free"], wt["problems"]
        assert wt["trace_id"] == "beefbeefbeefbeef"
        assert wt["chunks"] == 3 and wt["status"] == "completed"
        assert rep["complete"] == rep["reconstructed"]

    def test_crc_rejection_is_loud_and_isolated(self, stack):
        svc, srv, cli = stack
        cli._c2s.send_bytes(b"\x00garbage that is not a frame")
        deadline = time.monotonic() + 10
        reject = svc.telemetry.counter("wire_crc_rejected_total")
        while reject.value < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert reject.value == 1
        # the connection survives: the next valid frame is served
        assert cli.submit("assign", {"n": 6}).result(120).ok

    def test_concurrent_client_connections_serialize_on_ctl(self):
        """The shm ring is single-producer, but every client HELLOs on
        the one shared control ring: the cross-process writer lock must
        serialize them (regression: two concurrent connects interleaved
        their head updates and misframed the ctl ring for everyone)."""
        import threading

        from aclswarm_torch.serve.wire import WireClient, WireServer

        svc = SwarmService(_cfg(max_batch=4))
        base = _base()
        srv = WireServer(svc, base)
        oks, errs = [], []

        def connect(i):
            try:
                c = WireClient(base, tenant=f"c{i}")
                oks.append(c.submit("assign",
                                    {"n": 6, "seed": i}).result(120).ok)
                c.close()
            except Exception as e:      # noqa: BLE001 — recorded
                errs.append(repr(e))

        threads = [threading.Thread(target=connect, args=(i,))
                   for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not errs and oks == [True] * 5, (oks, errs)
        srv.close()
        svc.close()

    def test_queue_full_rejection_crosses_the_wire(self):
        from aclswarm_torch.serve.wire import WireClient, WireServer

        svc = SwarmService(_cfg(max_queue_per_tenant=1),
                           start=False)
        base = _base()
        srv = WireServer(svc, base)
        cli = WireClient(base, tenant="ext")
        t1 = cli.submit("assign", {"n": 6}, request_id="w-keep")
        r2 = cli.submit("assign", {"n": 6},
                        request_id="w-bounce").result(30)
        assert r2.status == FAILED and r2.error.code == "queue_full"
        assert r2.error.detail["retry_after_s"] > 0
        assert not t1.done                  # accepted, still owed
        cli.close()
        srv.close()
        svc.close(drain=False)

    def test_connection_default_deadline_applies(self):
        """Regression: the client frame always carries a ``deadline_s``
        key (None when unset), so the server must apply its
        per-connection default on a None VALUE, not on key absence —
        otherwise `default_deadline_s` is dead code and a slow client
        parks unbounded work."""
        from aclswarm_torch.serve.wire import WireClient, WireServer

        svc = SwarmService(_cfg())
        base = _base()
        srv = WireServer(svc, base, default_deadline_s=0.0)
        cli = WireClient(base, tenant="ext")
        r = cli.submit("rollout", ROLL).result(timeout=60)
        assert r.status == "timed_out"
        assert r.error.code == "deadline_exceeded"
        # an explicit per-request deadline overrides the default
        r2 = cli.submit("assign", {"n": 6},
                        deadline_s=60.0).result(timeout=60)
        assert r2.ok
        cli.close()
        srv.close()
        svc.close()

    def test_dead_client_cancels_entries_at_boundaries(self):
        """Loud disconnect semantics: the client vanishes (no BYE, no
        pings) with two long rollouts in flight. Every entry terminates
        with a structured ``cancelled`` error — queued entries
        immediately, the RESIDENT one only at its next chunk boundary
        (``Result.chunks >= 1``: the running batch is never cancelled
        mid-kernel), and the disconnect is counted + logged."""
        from aclswarm_torch.serve.wire import WireClient, WireServer

        svc = SwarmService(_cfg(max_batch=1, quantum_chunks=99))
        base = _base()
        srv = WireServer(svc, base, client_lease_s=1.0)
        cli = WireClient(base, tenant="ext", ping_s=0.2)
        cli.submit("rollout", dict(ROLL, ticks=10_000),
                   request_id="w-a")
        cli.submit("rollout", dict(ROLL, ticks=10_000, seed=9),
                   request_id="w-b")
        # wait until at least one is resident and producing chunks
        deadline = time.monotonic() + 120
        while svc.stats["chunks"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert svc.stats["chunks"] >= 1
        # the client DIES: reader+pinger stop, rings stay (no BYE)
        cli._stop.set()
        cli._thread.join(5)
        deadline = time.monotonic() + 60
        while svc.stats["cancelled"] < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert svc.stats["cancelled"] == 2
        disc = svc.telemetry.counter("wire_client_disconnects_total")
        assert disc.value == 1
        results = {rid: svc._done_prior.get(rid)
                   for rid in ("w-a", "w-b")}
        assert all(r is not None and r.status == FAILED
                   and r.error.code == "cancelled"
                   for r in results.values()), results
        # the resident request reached a boundary before terminating —
        # it was never killed mid-batch
        assert max(r.chunks for r in results.values()) >= 1
        assert all(r.chunks < 500 for r in results.values())
        srv.close()
        svc.close(drain=False)


# ---------------------------------------------------------------- TCP


class TestTcpWire:
    def test_round_trip_matches_direct_api(self):
        from aclswarm_torch.serve.wire import WireClient

        svc = SwarmService(_cfg(max_batch=2))
        srv, (host, port) = _tcp_stack(svc)
        cli = WireClient(tcp=(host, port), tenant="ext")
        want = svc.submit("rollout", ROLL, tenant="direct").result(240)
        t = cli.submit("rollout", ROLL)
        res = t.result(timeout=240)
        assert res.ok and res.chunks == 3
        assert int(res.value["digest"]) == int(want.value["digest"])
        assert np.array_equal(np.asarray(res.value["q"]),
                              np.asarray(want.value["q"]))
        events = list(t.stream(timeout=1))
        assert [e.payload["chunk"] for e in events] == [0, 1, 2]
        # the scrape surface works off-host too
        rs = cli.submit("stats", {"format": "prometheus"}).result(120)
        assert rs.ok and "serve_accepted_total" in rs.value["text"]
        cli.close()
        srv.close()
        svc.close()

    def test_submit_and_wait_honors_retry_after(self):
        """A queue_full rejection is retried
        after the server's hint (deterministic jitter), not surfaced
        raw — the caller sees the eventual result, and the reject
        ledger shows the backpressure actually engaged."""
        import threading

        from aclswarm_torch.serve.wire import WireClient

        svc = SwarmService(_cfg(max_queue_per_tenant=1, max_batch=1,
                                idle_poll_s=0.01), start=False)
        srv, (host, port) = _tcp_stack(svc)
        cli = WireClient(tcp=(host, port), tenant="ext")
        # the workers are NOT started: the occupier pins the one
        # tenant-cap slot, so the next submit is deterministically
        # rejected. The worker fleet starts shortly after — the
        # honored retry then lands once the occupier is picked.
        cli.submit("rollout", ROLL, request_id="w-occupy")
        starter = threading.Timer(0.8, svc.start)
        starter.start()
        r = cli.submit_and_wait("assign", {"n": 6}, timeout=240,
                                reject_retries=16)
        starter.join()
        assert r.ok, r.error
        assert svc.telemetry.counter("serve_rejected_total").value >= 1
        # with retries disabled the raw queue_full surfaces
        svc2 = SwarmService(_cfg(max_queue_per_tenant=1), start=False)
        srv2, (h2, p2) = _tcp_stack(svc2)
        cli2 = WireClient(tcp=(h2, p2), tenant="ext")
        cli2.submit("assign", {"n": 6}, request_id="w-keep")
        r2 = cli2.submit_and_wait("assign", {"n": 6}, timeout=30,
                                  reject_retries=0)
        assert r2.status == FAILED and r2.error.code == "queue_full"
        assert r2.error.detail["retry_after_s"] > 0
        cli2.close()
        srv2.close()
        svc2.close(drain=False)
        cli.close()
        srv.close()
        svc.close()

    def test_slowloris_read_bound_drops_only_the_loris(self):
        """A client trickling a frame byte-by-byte is declared gone at
        the read deadline (counted), its queued work cancelled with the
        structured error — while an honest client on the same server
        keeps being served and the dispatcher never stalls."""
        from aclswarm_torch.serve.wire import (K_HELLO, K_SUBMIT,
                                               WireClient, _frame)

        svc = SwarmService(_cfg(max_batch=2))
        srv, (host, port) = _tcp_stack(svc, read_deadline_s=0.5,
                                       handshake_s=2.0)
        s = socket.create_connection((host, port))
        hello = _frame(K_HELLO, {"client": "loris"})
        s.sendall(len(hello).to_bytes(4, "little") + hello)
        sub = _frame(K_SUBMIT, {
            "request_id": "l-1", "kind": "rollout",
            "params": dict(ROLL, ticks=10_000), "tenant": "loris",
            "deadline_s": None, "trace_id": "f" * 16})
        framed = len(sub).to_bytes(4, "little") + sub
        s.sendall(framed[:6])          # header + 2 bytes, then stall
        loris = svc.telemetry.counter("wire_slowloris_dropped_total")
        deadline = time.monotonic() + 15
        while loris.value < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert loris.value == 1
        # the honest client was never impacted
        cli = WireClient(tcp=(host, port), tenant="honest")
        assert cli.submit("assign", {"n": 6}).result(120).ok
        cli.close()
        s.close()
        srv.close()
        svc.close()

    def test_write_stall_bounded_buffer_drops_client(self):
        """The write half of slow-loris: a client that submits work
        and never drains responses fills its BOUNDED outbound buffer
        and is declared gone — the dispatcher keeps serving instead of
        blocking on the send."""
        from aclswarm_torch.serve.wire import (K_HELLO, K_SUBMIT,
                                               WireClient, _frame)

        svc = SwarmService(_cfg(max_batch=2))
        # a small server-side user buffer so undrained responses
        # overflow it once the kernel buffers are pinched below. It
        # holds several responses: a prometheus scrape grows past 4 KB
        # as the registry fills, and a frame larger than the whole
        # buffer can never be queued (the channel raises on it, and the
        # dispatcher never reaches the drop) — with the reference's
        # 4096 bytes that race decided the outcome
        srv, (host, port) = _tcp_stack(svc, sock_buffer=16384,
                                       read_deadline_s=30.0)
        # the client: minimal receive window, and it NEVER reads
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1)
        s.connect((host, port))
        hello = _frame(K_HELLO, {"client": "sink"})
        s.sendall(len(hello).to_bytes(4, "little") + hello)
        # pinch the server's kernel send buffer too, once the
        # connection is promoted
        deadline = time.monotonic() + 10
        while "sink" not in srv._conns and time.monotonic() < deadline:
            time.sleep(0.02)
        srv._conns["sink"].s2c._sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDBUF, 1)
        # ask for work whose responses are BIG (the prometheus scrape
        # is several KB) and never drain any of it: keep asking until
        # the server's drop counter moves (the deadline bounds the
        # wait, not a fixed burst that a loaded host may drain)
        loris = svc.telemetry.counter("wire_slowloris_dropped_total")
        deadline = time.monotonic() + 60
        k = 0
        while loris.value < 1 and time.monotonic() < deadline:
            sub = _frame(K_SUBMIT, {
                "request_id": f"sink-{k}", "kind": "stats",
                "params": {"format": "prometheus"}, "tenant": "sink",
                "deadline_s": None, "trace_id": "a" * 16})
            k += 1
            try:
                s.sendall(len(sub).to_bytes(4, "little") + sub)
            except OSError:
                break               # the server already dropped us
            if k % 8 == 0:          # a beat for the responses to pile up
                beat = time.monotonic() + 0.5
                while loris.value < 1 and time.monotonic() < beat:
                    time.sleep(0.01)
        while loris.value < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loris.value >= 1
        # server healthy for others
        cli = WireClient(tcp=(host, port), tenant="honest")
        assert cli.submit("assign", {"n": 6}).result(120).ok
        cli.close()
        s.close()
        srv.close()
        svc.close(drain=False)

    def test_reconnect_attaches_pending_and_replays_idempotently(self):
        """Reconnect-storm hardening: an abrupt socket death (no BYE)
        followed by a reconnect under the SAME client id transfers the
        pending tickets; re-submitting the same request_id attaches to
        the existing job via the atomic id reservation — exactly one
        execution, the result delivered to the new connection."""
        from aclswarm_torch.serve.wire import WireClient

        svc = SwarmService(_cfg(max_batch=1, quantum_chunks=99))
        srv, (host, port) = _tcp_stack(svc)
        cli = WireClient(tcp=(host, port), tenant="ext",
                         client_id="stormy")
        roll = dict(ROLL, ticks=4000)
        cli.submit("rollout", roll, request_id="w-keep")
        deadline = time.monotonic() + 120
        while svc.stats["chunks"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        # the client WEDGES: reader stopped, no BYE, socket left open
        # (closing it races the reconnect against the server's
        # reset-detection — a client that dies visibly first gets the
        # documented `cancelled` outcome instead; the attach path under
        # test is reconnect-before-the-server-notices)
        cli._stop.set()
        cli._thread.join(5)
        cli2 = WireClient(tcp=(host, port), tenant="ext",
                          client_id="stormy")
        r = cli2.submit("rollout", roll,
                        request_id="w-keep").result(timeout=240)
        assert r.ok
        assert svc.stats["accepted"] == 1          # ONE execution
        assert svc.telemetry.counter(
            "wire_reconnects_total").value == 1
        cli._c2s.close()           # the wedged client's leaked fd
        cli2.close()
        srv.close()
        svc.close()

    def test_handshake_deadline_and_garbage_hello(self):
        from aclswarm_torch.serve.wire import WireServer

        svc = SwarmService(_cfg(), start=False)
        srv = WireServer(svc, base=None, tcp=("127.0.0.1", 0),
                         handshake_s=0.3)
        host, port = srv.tcp_address
        expired = svc.telemetry.counter("wire_handshake_expired_total")
        rejected = svc.telemetry.counter("wire_handshake_rejected_total")
        # a socket that never completes a HELLO is closed at the bound
        s1 = socket.create_connection((host, port))
        # a socket whose first frame is garbage is closed immediately —
        # counted SEPARATELY (a misbehaving client, not a slow
        # handshake)
        s2 = socket.create_connection((host, port))
        s2.sendall((16).to_bytes(4, "little") + b"x" * 16)
        deadline = time.monotonic() + 10
        while (expired.value < 1 or rejected.value < 1) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert expired.value == 1 and rejected.value == 1
        s1.close()
        s2.close()
        srv.close()
        svc.close(drain=False)

    def test_accept_rate_bounding_defers_not_denies(self):
        """The token bucket defers accepts past the rate (counted) but
        every well-behaved client still connects — the storm waits in
        the backlog instead of monopolizing the dispatcher."""
        from aclswarm_torch.serve.wire import WireClient, WireServer

        svc = SwarmService(_cfg(max_batch=4))
        srv = WireServer(svc, base=None, tcp=("127.0.0.1", 0),
                         accept_rate=5.0)
        srv._listener._burst = 2        # tiny burst for the test
        srv._listener._tokens = 2.0
        host, port = srv.tcp_address
        clis = [WireClient(tcp=(host, port), tenant=f"c{i}",
                           hello_timeout_s=30.0) for i in range(6)]
        oks = [c.submit("assign", {"n": 6, "seed": i}).result(120).ok
               for i, c in enumerate(clis)]
        assert oks == [True] * 6
        assert srv._listener.throttled >= 1
        for c in clis:
            c.close()
        srv.close()
        svc.close()


# ------------------------------------------------------ wire fuzzing


def _fuzz_stack(transport_kind: str):
    """(svc, srv, cli, raw_send, teardown) — raw_send injects BYTES
    onto the client->server channel of an ESTABLISHED connection, on
    either transport."""
    from aclswarm_torch.serve.wire import WireClient

    svc = SwarmService(_cfg(max_batch=2))
    if transport_kind == "tcp":
        srv, (host, port) = _tcp_stack(svc, read_deadline_s=30.0)
        cli = WireClient(tcp=(host, port), tenant="fuzz")
        raw = cli._c2s._sock.sendall
    else:
        from aclswarm_torch.serve.wire import WireServer

        _need_native()
        base = _base()
        srv = WireServer(svc, base, client_lease_s=30.0)
        cli = WireClient(base, tenant="fuzz")

        def raw(b):
            assert cli._c2s.send_bytes(b)

    def teardown():
        cli.close()
        srv.close()
        svc.close(drain=False)

    return svc, srv, cli, raw, teardown


def _tcp_framed(record: bytes) -> bytes:
    return len(record).to_bytes(4, "little") + record


@pytest.mark.parametrize("transport_kind", ["tcp", "shm"])
class TestWireFuzz:
    """Seeded wire-frame fuzzing over both transports: the dispatcher
    survives every class of damage, exactly the afflicted connection
    is declared gone (when the damage is structural to the STREAM),
    and the rejection counters increment — never a partial
    application, never a wedged server."""

    def test_bitflip_records_all_rejected(self, transport_kind):
        from aclswarm_torch.serve.wire import K_SUBMIT, _frame

        svc, srv, cli, raw, teardown = _fuzz_stack(transport_kind)
        try:
            rng = np.random.default_rng(5)
            reject = svc.telemetry.counter("wire_crc_rejected_total")
            sent = 12
            for k in range(sent):
                rec = bytearray(_frame(K_SUBMIT, {
                    "request_id": f"fz-{k}", "kind": "assign",
                    "params": {"n": 6, "seed": k}, "tenant": "fuzz",
                    "deadline_s": None, "trace_id": "b" * 16}))
                pos = int(rng.integers(0, len(rec)))
                rec[pos] ^= 1 << int(rng.integers(0, 8))
                raw(_tcp_framed(bytes(rec)) if transport_kind == "tcp"
                    else bytes(rec))
            deadline = time.monotonic() + 30
            while reject.value < sent and time.monotonic() < deadline:
                time.sleep(0.02)
            # EVERY flipped record rejected; nothing applied
            assert reject.value == sent
            assert svc.stats["accepted"] == 0
            # the connection survives record-level damage: a valid
            # submit on the same connection is served
            assert cli.submit("assign", {"n": 6}).result(120).ok
        finally:
            teardown()

    def test_truncated_record_rejected(self, transport_kind):
        from aclswarm_torch.serve.wire import K_SUBMIT, _frame

        svc, srv, cli, raw, teardown = _fuzz_stack(transport_kind)
        try:
            rec = _frame(K_SUBMIT, {
                "request_id": "tr-1", "kind": "assign",
                "params": {"n": 6}, "tenant": "fuzz",
                "deadline_s": None, "trace_id": "c" * 16})
            cut = rec[:len(rec) // 2]
            # a truncated RECORD inside a well-formed transport frame:
            # the codec CRC rejects it, the connection survives
            raw(_tcp_framed(cut) if transport_kind == "tcp" else cut)
            reject = svc.telemetry.counter("wire_crc_rejected_total")
            deadline = time.monotonic() + 15
            while reject.value < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert reject.value == 1 and svc.stats["accepted"] == 0
            assert cli.submit("assign", {"n": 6}).result(120).ok
        finally:
            teardown()

    def test_oversize_frame_kills_only_that_connection(
            self, transport_kind):
        from aclswarm_torch.serve.wire import WireClient

        svc, srv, cli, raw, teardown = _fuzz_stack(transport_kind)
        try:
            if transport_kind == "tcp":
                # a length prefix past max_frame is stream corruption:
                # THIS connection is declared gone...
                raw((1 << 30).to_bytes(4, "little") + b"x" * 64)
                gone = svc.telemetry.counter(
                    "wire_client_disconnects_total")
                deadline = time.monotonic() + 15
                while gone.value < 1 and time.monotonic() < deadline:
                    time.sleep(0.02)
                assert gone.value == 1
            else:
                # the shm ring bounds frames at the SENDING side: an
                # oversized frame is refused with ValueError before it
                # can ever misframe the ring (the receiving-side n<0
                # contract is covered by the native ring tests)
                with pytest.raises(ValueError):
                    cli._c2s.send_bytes(b"x" * (2 << 20))
            # ...and the SERVER keeps serving new connections
            if transport_kind == "tcp":
                c2 = WireClient(tcp=srv.tcp_address, tenant="ok")
            else:
                c2 = WireClient(srv.base, tenant="ok")
            assert c2.submit("assign", {"n": 6}).result(120).ok
            c2.close()
        finally:
            teardown()

    def test_midframe_disconnect_declares_client_gone(
            self, transport_kind):
        from aclswarm_torch.serve.wire import K_SUBMIT, _frame

        if transport_kind == "shm":
            pytest.skip("mid-frame disconnect is a stream property; "
                        "the shm ring writes frames atomically")
        svc, srv, cli, raw, teardown = _fuzz_stack(transport_kind)
        try:
            rec = _frame(K_SUBMIT, {
                "request_id": "md-1", "kind": "assign",
                "params": {"n": 6}, "tenant": "fuzz",
                "deadline_s": None, "trace_id": "d" * 16})
            framed = _tcp_framed(rec)
            raw(framed[:len(framed) // 2])
            # the socket dies mid-frame (no BYE): reader stops first so
            # the close is abrupt from the server's point of view
            cli._stop.set()
            cli._thread.join(5)
            cli._c2s._sock.close()
            gone = svc.telemetry.counter(
                "wire_client_disconnects_total")
            deadline = time.monotonic() + 15
            while gone.value < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert gone.value == 1
            # the half-frame was never applied
            assert svc.stats["accepted"] == 0
        finally:
            srv.close()
            svc.close(drain=False)

    def test_codec_single_bit_flips_all_detected(self, transport_kind):
        """The exhaustive ground truth under the per-connection CRC
        story: EVERY single-bit flip of a wire record — header bytes
        included — fails `checkpoint.loads`. (The reserved-byte and
        meta-length header gaps this found are regression-pinned
        here.)"""
        if transport_kind == "shm":
            pytest.skip("transport-independent — run once under tcp")
        from aclswarm_torch.resilience import checkpoint as ck
        from aclswarm_torch.serve.wire import K_SUBMIT, _frame

        rec = _frame(K_SUBMIT, {
            "request_id": "bf", "kind": "assign",
            "params": {"n": 6, "seed": 1}, "tenant": "t",
            "deadline_s": None, "trace_id": "e" * 16})
        undetected = []
        for pos in range(len(rec)):
            for bit in range(8):
                bad = bytearray(rec)
                bad[pos] ^= 1 << bit
                try:
                    ck.loads(bytes(bad), "<fuzz>")
                    undetected.append((pos, bit))
                except ck.CheckpointError:
                    pass
        assert not undetected, undetected


# --------------------------------------------------- socket transport


class TestSocketTransport:
    def test_burst_framing_and_observables(self):
        from aclswarm_torch.interop import transport as T

        with T.SocketListener() as lst:
            host, port = lst.address
            cli = T.connect_when_ready(host, port, grace_s=5)
            srv = None
            deadline = time.monotonic() + 5
            while srv is None and time.monotonic() < deadline:
                srv = lst.accept()
                time.sleep(0.005)
            frames = [bytes([i]) * (50 + i) for i in range(20)]
            for f in frames:
                assert cli.send_bytes(f)
            got = []
            deadline = time.monotonic() + 5
            while len(got) < 20 and time.monotonic() < deadline:
                f = srv.recv_bytes()
                if f is None:
                    time.sleep(0.001)
                    continue
                got.append(f)
            assert got == frames
            # slow-loris observable: a partial frame ages
            cli._sock.sendall((500).to_bytes(4, "little") + b"zz")
            deadline = time.monotonic() + 5
            while srv.stalled_recv_s <= 0.0 \
                    and time.monotonic() < deadline:
                assert srv.recv_bytes() is None
                time.sleep(0.005)
            assert srv.recv_bytes() is None
            assert srv.stalled_recv_s > 0.0
            # peer close raises (the corrupt-ring contract)
            cli.close()
            with pytest.raises(OSError):
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline:
                    srv.recv_bytes()
                    time.sleep(0.005)
            srv.close()

    def test_bounded_buffer_backpressure_and_oversize(self):
        from aclswarm_torch.interop import transport as T

        with T.SocketListener() as lst:
            host, port = lst.address
            cli = T.connect_when_ready(host, port, grace_s=5)
            srv = None
            deadline = time.monotonic() + 5
            while srv is None and time.monotonic() < deadline:
                srv = lst.accept()
                time.sleep(0.005)
            # a frame that can NEVER fit raises (ring parity)
            cli._max_frame = 1024
            with pytest.raises(ValueError):
                cli.send_bytes(b"x" * 4096)
            # an undrained peer turns into False (explicit
            # backpressure), never a blocked writer
            cli._max_frame = T.MAX_FRAME
            cli._max_buffer = 8192
            cli._sock.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_SNDBUF, 2048)
            sent = 0
            saw_false = False
            for _ in range(2000):
                if cli.send_bytes(b"y" * 1024):
                    sent += 1
                else:
                    saw_false = True
                    break
            assert saw_false and sent >= 1
            assert cli.queued_bytes > 0
            cli.close()
            srv.close()

    def test_connect_when_ready_error_distinction(self):
        from aclswarm_torch.interop import transport as T

        with pytest.raises(OSError, match="refused every connection"):
            T.connect_when_ready("127.0.0.1", 1, grace_s=0.3)

    @pytest.mark.usefixtures("native")
    def test_open_when_ready_error_distinction(self, tmp_path):
        from aclswarm_torch.interop import transport as T

        # never appeared: the message must blame the missing peer, not
        # the handshake
        with pytest.raises(OSError, match="never appeared"):
            T.open_when_ready("asw-torchwire-none-" + uuid.uuid4().hex[:6],
                              grace_s=0.2)

    @pytest.mark.usefixtures("native")
    def test_ring_roundtrip_via_memoryview_paths(self):
        """The ring copy paths (zero-copy send cast + persistent-view
        recv): byte-exact round trip,
        including embedded NULs and large frames."""
        from aclswarm_torch.interop import transport as T

        name = "asw-torchwire-mv-" + uuid.uuid4().hex[:6]
        with T.Channel(name, create=True, capacity=1 << 16) as ch:
            for frame in (b"", b"\x00" * 7, bytes(range(256)) * 100):
                if not frame:
                    continue        # empty frames are not a ring case
                assert ch.send_bytes(frame)
                assert ch.recv_bytes() == frame


class TestTcpWireOwnership:
    def test_foreign_client_cannot_steal_a_result(self):
        """Review regression: the service-level idempotent attach has
        no tenancy, so the WIRE door owns rid->client-id — a different
        client replaying a known id (live OR already retired) is
        refused, never handed the owner's result."""
        from aclswarm_torch.serve.wire import WireClient

        svc = SwarmService(_cfg(max_batch=2))
        srv, (host, port) = _tcp_stack(svc)
        owner = WireClient(tcp=(host, port), tenant="owner",
                           client_id="owner")
        r = owner.submit("assign", {"n": 6}, request_id="mine").result(120)
        assert r.ok                      # completed + retired
        thief = WireClient(tcp=(host, port), tenant="thief",
                           client_id="thief")
        rs = thief.submit("assign", {"n": 6},
                          request_id="mine").result(timeout=60)
        assert rs.status == FAILED and rs.error.code == "wire_error"
        assert "owned by another client" in rs.error.message
        assert svc.telemetry.counter("wire_rid_refused_total").value == 1
        # the owner can still replay its own id (idempotent attach)
        r2 = owner.submit("assign", {"n": 6},
                          request_id="mine").result(120)
        assert r2.ok
        owner.close()
        thief.close()
        srv.close()
        svc.close()


class TestSocketTransportBounds:
    def test_completed_frames_reset_the_stall_clock(self):
        """Review regression: stalled_recv_s means 'oldest INCOMPLETE
        frame', not 'oldest busy stretch' — a fast client whose buffer
        always ends mid-frame must never age into the loris bound."""
        from aclswarm_torch.interop import transport as T

        with T.SocketListener() as lst:
            host, port = lst.address
            cli = T.connect_when_ready(host, port, grace_s=5)
            srv = None
            deadline = time.monotonic() + 5
            while srv is None and time.monotonic() < deadline:
                srv = lst.accept()
                time.sleep(0.005)
            frame = b"z" * 64
            framed = (len(frame)).to_bytes(4, "little") + frame
            # keep the rx buffer ALWAYS mid-frame: full frame + half
            # the next, completing the half on the following beat
            cli._sock.sendall(framed + framed[:30])
            t_end = time.monotonic() + 0.5
            while time.monotonic() < t_end:
                got = srv.recv_bytes()
                if got is not None:
                    cli._sock.sendall(framed[30:] + framed[:30])
                # the stall clock must track only the CURRENT partial
                assert srv.stalled_recv_s < 0.4
                time.sleep(0.01)
            cli.close()
            srv.close()

    def test_inbound_buffer_bounded_under_frame_flood(self):
        """Review regression: recv_bytes reads from the kernel only
        until a frame is ready — a pre-sent flood of small frames
        cannot balloon the server-side buffer (TCP flow control takes
        over once we stop reading)."""
        from aclswarm_torch.interop import transport as T

        with T.SocketListener() as lst:
            host, port = lst.address
            cli = T.connect_when_ready(host, port, grace_s=5)
            srv = None
            deadline = time.monotonic() + 5
            while srv is None and time.monotonic() < deadline:
                srv = lst.accept()
                time.sleep(0.005)
            frame = b"f" * 100
            framed = (len(frame)).to_bytes(4, "little") + frame
            blob = framed * 3000        # ~300 KB of tiny frames
            cli._sock.setblocking(True)
            sent = 0
            cli._sock.settimeout(2.0)
            try:
                while sent < len(blob):
                    sent += cli._sock.send(blob[sent:])
            except socket.timeout:
                pass                    # flow control engaged: good
            got = 0
            deadline = time.monotonic() + 10
            while got < 100 and time.monotonic() < deadline:
                if srv.recv_bytes() is not None:
                    got += 1
                # the inbound buffer stays ~one read chunk, never the
                # whole flood
                assert len(srv._rx) <= (1 << 16) + len(framed)
            assert got == 100
            cli.close()
            srv.close()


class TestClientHandleLocking:
    """Regression: `WireClient._handle` used to read `_tickets`
    without the client lock, racing `submit`'s insert from the caller
    thread (a ticket registered between the reader thread's lookup and
    the dict resize could be missed or corrupt the dict)."""

    def test_ticket_lookup_holds_client_lock(self):
        import threading

        from aclswarm_torch.serve import wire
        from aclswarm_torch.utils.locks import OrderedLock
        from aclswarm_torch.utils import get_logger

        # a bare client: exactly the attributes _handle touches, no
        # transport — the lock discipline is what's under test
        client = wire.WireClient.__new__(wire.WireClient)
        client.log = get_logger("test.wire.client")
        client.server_info = {}
        client._connected = threading.Event()
        client._lock = OrderedLock("serve.wire")
        depths = []

        class _Guarded(dict):
            def get(_self, key, default=None):
                depths.append(client._lock.locked())
                return dict.get(_self, key, default)

        client._tickets = _Guarded()
        client._handle({"request_id": "ghost", "seq": 0,
                        "payload": {}}, wire.K_EVENT)
        assert depths == [True], \
            "ticket lookup must run under the client lock"


# ------------------------------------------- parity with the reference


def _messages(pkg, seed: int) -> dict:
    """One message of every kind in ``pkg``'s dataclasses, from a seed."""
    rng = np.random.default_rng(seed)
    n = 7
    h = pkg.Header(seq=int(rng.integers(0, 1 << 31)),
                   stamp=float(rng.random() * 1e4), frame_id="world")
    return {
        "formation": pkg.Formation(
            header=h, name="simform7", points=rng.normal(size=(n, 3)),
            adjmat=(rng.random((n, n)) < 0.5).astype(np.uint8),
            gains=rng.normal(size=(3 * n, 3 * n)).astype(np.float32)),
        "formation_no_gains": pkg.Formation(
            header=h, name="ring", points=rng.normal(size=(n, 3)),
            adjmat=np.ones((n, n), np.uint8)),
        "cbaa": pkg.CBAA(header=h, auction_id=3, iter=2,
                         price=rng.random(n).astype(np.float32),
                         who=rng.integers(-1, n, n).astype(np.int32)),
        "estimates": pkg.VehicleEstimates(
            header=h, positions=rng.normal(size=(n, 3)),
            stamps=rng.random(n)),
        "safety": pkg.SafetyStatus(header=h,
                                   collision_avoidance_active=True),
        "distcmd": pkg.DistCmd(header=h, vel=rng.normal(size=(n, 3))),
        "assignment": pkg.Assignment(header=h,
                                     perm=rng.permutation(n)),
        "flightmode": pkg.FlightMode(header=h, mode=pkg.MODE_LAND),
        "safety_array": pkg.SafetyStatusArray(
            header=h, active=rng.random(n) < 0.5),
    }


@pytest.mark.parametrize("kind", list(_messages(msgs, 0)))
def test_codec_bytes_match_reference(kind):
    """The same message encodes to the same bytes in both packages, and
    each package decodes the other's bytes to an equal message."""
    mine = _messages(msgs, 11)[kind]
    theirs = _messages(ref_msgs, 11)[kind]
    wire = codec.encode(mine)
    assert wire == ref_codec.encode(theirs)
    back, ref_back = codec.decode(ref_codec.encode(theirs)), \
        ref_codec.decode(wire)
    for f in vars(mine):
        a, b = getattr(back, f), getattr(ref_back, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        elif f == "header":
            assert vars(a) == vars(b)
        else:
            assert a == b, f


def test_reference_client_served_by_port_server():
    """A reference `WireClient` (the reference's frames) talks to the
    port's `WireServer` over TCP: accepted, streamed and answered with
    the port's result, equal to the port's direct API."""
    from aclswarm_tpu.serve.wire import WireClient as RefWireClient

    svc = SwarmService(_cfg(max_batch=2))
    srv, (host, port) = _tcp_stack(svc)
    cli = RefWireClient(tcp=(host, port), tenant="ref")
    try:
        want = svc.submit("rollout", ROLL, tenant="direct").result(240)
        t = cli.submit("rollout", ROLL)
        res = t.result(timeout=240)
        assert res.ok and res.chunks == 3
        assert int(res.value["digest"]) == int(want.value["digest"])
        assert np.array_equal(np.asarray(res.value["q"]),
                              np.asarray(want.value["q"]))
        assert [e.payload["chunk"] for e in t.stream(timeout=1)] == \
            [0, 1, 2]
    finally:
        cli.close()
        srv.close()
        svc.close()

"""Wire front end of the serving layer (a copy of
`aclswarm_tpu/serve/wire.py`): external client processes submit over the
interop shm rings — or, off-host, over a TCP socket speaking the
identical frames — to the port's `SwarmService`.

This module is the transport boundary. It reuses what already exists
instead of inventing a protocol:

- **transport**: `interop.transport.Channel` — the named SPSC
  shared-memory rings (`native/shmring.cpp`), one ring per direction
  per connection, plus one well-known *control* ring for handshakes —
  or `interop.transport.SocketChannel`: one duplex TCP stream per
  client carrying the same length-prefixed frames (the connection
  itself is the handshake channel, no ctl ring needed);
- **wire format**: the journal's codec-framed records
  (`resilience.checkpoint.dumps/loads` — magic, version, CRC,
  length-prefixed array table). A request ON THE WIRE is byte-for-byte
  the record the journal stores, so there is exactly one serialization
  surface to version and one CRC to trust — on EITHER transport.
  Versioning rides the frame's ``format_version`` plus a
  ``wire_version`` manifest field checked at hello time.

Connection lifecycle (client-created rings, server-owned control)::

    server:  WireServer(service, base)        # creates {base}.ctl
             WireServer(service, tcp=("0.0.0.0", 7421))   # + TCP bind
    client:  WireClient(base)                 # creates {base}.{cid}.c2s
                                              #     and {base}.{cid}.s2c,
                                              # then HELLO on the ctl ring
             WireClient(tcp=(host, 7421))     # connect, HELLO on the
                                              # socket itself
    client:  submit(...) -> Ticket            # wire.submit -> accept/
                                              # reject frame
    server:  streams wire.event / wire.result frames back per request
    client:  close()                          # BYE (clean) — or just die

Failure semantics (the loud-disconnect contract):

- a frame that fails the codec CRC (or does not parse) is REJECTED with
  a loud log + ``wire_crc_rejected_total`` — never partially applied;
- a client that stops talking (no submit/ping within
  ``client_lease_s``) is declared dead: its entries are cancelled with
  a structured ``cancelled`` error — still-QUEUED ones immediately,
  RESIDENT ones only at their next chunk boundary — never the running
  batch mid-kernel; the terminal results are journaled and their
  delivery dropped loudly;
- per-connection deadlines: every submit may carry ``deadline_s``; the
  connection's ``default_deadline_s`` applies otherwise, so one slow
  client cannot park unbounded work.

TCP-specific hardening (the adversarial-client bounds the open-loop
traffic fleet `serve.traffic` drives; every bound is counted):

- **slow-loris reads** — a client trickling a frame byte-by-byte shows
  up as an inbound partial frame older than ``read_deadline_s`` and is
  declared gone (its queued work cancelled, the structured-`cancelled`
  path above); the dispatcher never blocks on a read;
- **slow-loris writes** — sends are non-blocking against a BOUNDED
  per-connection outbound buffer; a client that stops draining
  responses fills its bound and is declared gone — the dispatcher and
  every other client keep moving;
- **handshake deadline** — an accepted socket that does not complete a
  valid HELLO within ``handshake_s`` is closed and counted;
- **reconnect storms** — accepts are rate-bounded
  (`transport.SocketListener` token bucket; the overflow waits in the
  kernel backlog), and a HELLO re-using a known client id ATTACHES:
  pending tickets transfer to the new connection (nothing cancelled),
  and re-submitting an id the service knows lands on the existing
  atomic id reservation — reconnect + replay never duplicates work.

The server is a thin adapter: admission, fairness, journaling, failover
and every promise stay in `SwarmService` — a wire client gets exactly
the in-process semantics, one process boundary later. A scripted
`resilience.crash.CrashPlan` site ``wire`` (boundary = frames handled)
kills the dispatcher deterministically for the chaos drills.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
import queue as queuelib
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Optional

from aclswarm_torch.interop import transport
from aclswarm_torch.resilience import checkpoint as ckptlib
from aclswarm_torch.resilience.crash import InjectedCrash, maybe_crash
from aclswarm_torch.serve.api import (E_QUEUE_FULL, E_SHUTDOWN, FAILED,
                                      ChunkEvent, RejectedError, Result,
                                      ServeError, Ticket)
from aclswarm_torch.serve.api import _SENTINEL as _TICKET_SENTINEL
from aclswarm_torch.telemetry import mint_trace_id
from aclswarm_torch.utils.log import get_logger
from aclswarm_torch.utils.locks import OrderedLock
from aclswarm_torch.utils.retry import retry_after_delay

WIRE_VERSION = 1
WIRE_CRASH_SITE = "wire"    # maybe_crash site: one boundary per client
#                             frame handled by the dispatcher
# frame kinds (the manifest's `kind` field — same slot the journal uses)
K_HELLO = "wire_hello"
K_HELLO_ACK = "wire_hello_ack"
K_SUBMIT = "wire_submit"
K_ACCEPT = "wire_accept"
K_REJECT = "wire_reject"
K_EVENT = "wire_event"
K_RESULT = "wire_result"
K_ERROR = "wire_error"
K_PING = "wire_ping"
K_BYE = "wire_bye"

RING_CAPACITY = 1 << 20


@contextlib.contextmanager
def _ctl_writer_lock(base: str):
    """Cross-process writer lock for the shared control ring. The shm
    rings are strictly SINGLE-producer (`native/shmring.cpp` uses plain
    non-CAS head writes), but every client writes its HELLO to the one
    well-known ctl ring — two clients connecting concurrently would
    interleave their head updates and misframe the ring for everyone
    after. A flock on a well-known lock file serializes the (rare,
    tiny) ctl writes; connection rings stay lock-free SPSC."""
    path = Path("/dev/shm") if Path("/dev/shm").is_dir() \
        else Path("/tmp")
    lock = path / f"aclswarm.{base.strip('/')}.ctl.lock"
    with open(lock, "a+b") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


def _frame(kind: str, payload: dict, **extra) -> bytes:
    return ckptlib.dumps(payload, ckptlib.make_manifest(
        kind, "-", chunk=0, fingerprint="-", wire_version=WIRE_VERSION,
        **extra))


def _send(channel, frame: bytes, grace_s: float = 2.0, log=None,
          what: str = "frame") -> bool:
    """Backpressure-bounded raw send; a drop after the grace is LOUD
    (the receiving side stopped draining — a dead or wedged peer).
    The loop is `transport.send_bytes_reliable` — one home for the
    bounded-send semantics."""
    return transport.send_bytes_reliable(channel, frame,
                                         grace_s=grace_s, poll_s=0.001,
                                         log=log, what=what)


class _Conn:
    """Server-side state for one client connection. On the shm
    transport ``c2s``/``s2c`` are two rings; on TCP they are the SAME
    duplex `SocketChannel`."""

    def __init__(self, cid: str, c2s, s2c, tcp: bool = False):
        self.cid = cid
        self.c2s = c2s
        self.s2c = s2c
        self.tcp = tcp
        self.last_seen = time.monotonic()
        self.pending: dict[str, Ticket] = {}    # rid -> live ticket
        self.dead = False
        self.superseded = False     # replaced by a reconnect: pending
        #                             transferred, nothing cancelled


class WireServer:
    """Serve `SwarmService` requests to external processes over shm
    rings and/or a TCP listener. One dispatcher thread owns every
    channel (SPSC discipline: the server is the single reader of ctl +
    every c2s, the single writer of every s2c; sockets are owned the
    same way)."""

    def __init__(self, service, base: Optional[str] = "aclswarm-serve",
                 *, tcp: Optional[tuple] = None,
                 client_lease_s: float = 10.0,
                 default_deadline_s: Optional[float] = None,
                 poll_s: float = 0.002,
                 read_deadline_s: float = 5.0,
                 handshake_s: float = 5.0,
                 accept_rate: float = 64.0,
                 sock_buffer: int = transport.DEFAULT_SOCK_BUFFER,
                 log=None):
        self.svc = service
        self.base = base
        self.client_lease_s = float(client_lease_s)
        self.default_deadline_s = default_deadline_s
        self.poll_s = float(poll_s)
        self.read_deadline_s = float(read_deadline_s)
        self.handshake_s = float(handshake_s)
        self.sock_buffer = int(sock_buffer)
        self.log = log or get_logger("serve.wire")
        if base is None and tcp is None:
            raise ValueError("WireServer needs a shm base and/or a tcp "
                             "bind address")
        # shm control ring (co-hosted clients); TCP listener (off-host)
        self._ctl = (transport.Channel(f"{base}.ctl", create=True,
                                       capacity=RING_CAPACITY)
                     if base is not None else None)
        self._listener = (transport.SocketListener(
            tcp[0], int(tcp[1]), accept_rate=accept_rate)
            if tcp is not None else None)
        self._pending_socks: list[tuple] = []   # (chan, t_accept): pre-HELLO
        self._conns: dict[str, _Conn] = {}
        # rid -> submitting client id, bounded (mirrors the service's
        # done-retention): the service-level idempotent attach knows
        # nothing of tenancy, so the WIRE door must remember who owns a
        # request id — including RETIRED ones, or any client could
        # replay a completed id and read another client's result
        self._rid_owner: dict[str, str] = {}
        self._rid_owner_cap = 4096
        self._frames = 0            # client frames handled (crash site)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="swarmserve-wire")
        self._thread.start()

    @property
    def tcp_address(self) -> Optional[tuple]:
        """(host, port) actually bound (port 0 resolves here), or None
        when the server is shm-only."""
        return self._listener.address if self._listener else None

    # ------------------------------------------------------------- loop

    def _run(self) -> None:
        while not self._stop.is_set():
            # the single dispatcher must never die of one bad ring or
            # one buggy frame handler: a silent dispatcher death wedges
            # EVERY wire client while the service looks healthy — the
            # same round-level containment the worker loop has. The one
            # deliberate exception: a scripted InjectedCrash (the chaos
            # drills) must actually kill the dispatcher.
            try:
                busy = self._one_pass()
            except InjectedCrash:
                self.log.error("wire dispatcher: scripted crash — dying")
                raise
            except Exception:           # noqa: BLE001 — logged, loud
                self.log.exception(
                    "wire dispatcher pass failed — continuing (a "
                    "repeating error here means a corrupt ring; close "
                    "the offending client)")
                busy = False
            if not busy:
                time.sleep(self.poll_s)

    def _one_pass(self) -> bool:
        busy = self._drain_ctl()
        busy |= self._accept_tcp()
        now = time.monotonic()
        for conn in list(self._conns.values()):
            try:
                busy |= self._drain_client(conn)
                busy |= self._pump_results(conn)
                if conn.tcp and not conn.dead:
                    # flush any buffered responses; enforce the
                    # slow-loris bounds (both directions)
                    conn.s2c.flush()
                    if conn.c2s.stalled_recv_s > self.read_deadline_s:
                        self._count("wire_slowloris_dropped_total")
                        self._client_gone(
                            conn, "slow-loris read: partial frame older "
                                  f"than {self.read_deadline_s:g} s")
            except OSError as e:
                # a corrupt/oversized record on THIS connection's
                # channel (recv_bytes raises), or a closed/reset
                # socket: the connection is unrecoverable — misframed
                # forever — but the server is not
                self.log.error("wire: channel error on %s (%s) — "
                               "declaring the client gone", conn.cid, e)
                self._count("wire_conn_errors_total")
                self._client_gone(conn, f"channel error: {e}")
            if not conn.dead \
                    and now - conn.last_seen > self.client_lease_s:
                self._client_gone(
                    conn, f"client lease ({self.client_lease_s:g} s)"
                          " missed — client died or wedged")
            if conn.dead and not conn.pending:
                self._close_conn(conn)
        return busy

    def _count(self, name: str, n: int = 1) -> None:
        self.svc.telemetry.counter(name).inc(n)

    # --------------------------------------------------- TCP handshake

    def _accept_tcp(self) -> bool:
        """Accept rate-bounded TCP connections and walk the pre-HELLO
        set: a valid HELLO within ``handshake_s`` promotes the socket
        to a connection; garbage or silence closes it (counted)."""
        if self._listener is None:
            return False
        busy = False
        while True:
            chan = self._listener.accept()
            if chan is None:
                break
            busy = True
            chan._max_buffer = self.sock_buffer
            self._count("wire_tcp_accepted_total")
            self._pending_socks.append((chan, time.monotonic()))
        self.svc.telemetry.gauge("wire_accepts_throttled").set(
            self._listener.throttled)
        now = time.monotonic()
        for entry in list(self._pending_socks):
            chan, t0 = entry
            try:
                raw = chan.recv_bytes()
            except OSError:
                self._pending_socks.remove(entry)
                chan.close()
                continue
            if raw is None:
                if now - t0 > self.handshake_s:
                    self._count("wire_handshake_expired_total")
                    self.log.warning(
                        "wire: socket %s never completed a HELLO within "
                        "%g s — closed", chan.name, self.handshake_s)
                    self._pending_socks.remove(entry)
                    chan.close()
                continue
            busy = True
            self._pending_socks.remove(entry)
            dec = self._decode(raw, chan.name)
            if dec is None or dec[1].get("kind") != K_HELLO:
                self.log.warning("wire: first frame on %s was not a "
                                 "valid HELLO — closed", chan.name)
                # distinct from the deadline counter: a garbage first
                # frame is a misbehaving client, not a slow handshake —
                # conflating them sends operators tuning handshake_s
                # after phantom slowness
                self._count("wire_handshake_rejected_total")
                chan.close()
                continue
            self._promote_tcp(chan, dec[0])
        return busy

    def _promote_tcp(self, chan, payload: dict) -> None:
        cid = str(payload.get("client", "")) or uuid.uuid4().hex[:8]
        prior = self._conns.get(cid)
        conn = _Conn(cid, chan, chan, tcp=True)
        if prior is not None:
            # reconnect attach: the storm case. The new connection
            # inherits every pending ticket — nothing is cancelled, the
            # in-flight work keeps running, and results land on the NEW
            # socket. The old socket is superseded (closed without the
            # cancellation sweep).
            conn.pending = prior.pending
            prior.pending = {}
            prior.superseded = True
            prior.dead = True
            self._count("wire_reconnects_total")
            self.log.warning(
                "wire: client %s reconnected — %d pending ticket(s) "
                "transferred to the new connection", cid,
                len(conn.pending))
        self._conns[cid] = conn
        if prior is not None:
            self._close_conn(prior)    # successor owns the cid now
        self._send_conn(conn, _frame(K_HELLO_ACK, self._hello_ack()),
                        what="hello-ack")
        self.svc.telemetry.gauge("wire_connections").set(
            sum(1 for c in self._conns.values() if not c.dead))
        self.log.info("wire: client %s connected over tcp (%s)",
                      cid, chan.name)

    def _hello_ack(self) -> dict:
        """The HELLO reply payload. ``pid`` + ``incarnation`` name the
        server PROCESS generation: a reconnect to the same process
        echoes the same pair, a respawned procworker (serve.procworker)
        presents a new one — `telemetry/watch.py --follow` and the
        router's supervision tier both key on exactly this."""
        return {"server": self.base or "tcp",
                "pid": os.getpid(),
                "incarnation": int(getattr(
                    getattr(self.svc, "cfg", None), "incarnation", 0)),
                "workers": int(self.svc.stats.get("workers", 1))}

    def _decode(self, raw: bytes, where: str):
        """Codec-framed decode with CRC rejection: a corrupt frame is
        counted + logged and the connection moves on — a bad frame must
        never be partially applied or kill the dispatcher."""
        try:
            payload, man = ckptlib.loads(raw, where)
        except ckptlib.CheckpointError as e:
            self.svc.telemetry.counter("wire_crc_rejected_total").inc()
            self.log.error("wire: REJECTED corrupt frame on %s: %s",
                           where, e)
            return None
        if man.get("wire_version") != WIRE_VERSION:
            self.svc.telemetry.counter("wire_version_rejected_total").inc()
            self.log.error(
                "wire: REJECTED frame on %s: wire_version %r != %d",
                where, man.get("wire_version"), WIRE_VERSION)
            return None
        return payload, man

    def _drain_ctl(self) -> bool:
        if self._ctl is None:
            return False
        busy = False
        while True:
            raw = self._ctl.recv_bytes()
            if raw is None:
                return busy
            busy = True
            dec = self._decode(raw, self._ctl.name)
            if dec is None:
                continue
            payload, man = dec
            if man.get("kind") != K_HELLO:
                self.log.warning("wire: non-hello frame kind %r on the "
                                 "control ring — ignored", man.get("kind"))
                continue
            cid = str(payload.get("client", ""))
            if not cid or cid in self._conns:
                self.log.warning("wire: bad/duplicate hello %r", cid)
                continue
            try:
                c2s = transport.open_when_ready(f"{self.base}.{cid}.c2s")
                s2c = transport.open_when_ready(f"{self.base}.{cid}.s2c")
            except OSError as e:
                self.log.error("wire: hello from %r but its rings never "
                               "appeared: %s", cid, e)
                continue
            conn = _Conn(cid, c2s, s2c)
            self._conns[cid] = conn
            self._send_conn(conn, _frame(K_HELLO_ACK, self._hello_ack()),
                            what="hello-ack")
            self.svc.telemetry.gauge("wire_connections").set(
                sum(1 for c in self._conns.values() if not c.dead))
            self.log.info("wire: client %s connected", cid)

    def _send_conn(self, conn: _Conn, frame: bytes,
                   what: str = "frame") -> None:
        """Transport-appropriate send. TCP: one non-blocking attempt
        against the connection's bounded outbound buffer — False means
        the client stopped draining (the write half of slow-loris), and
        THAT connection is declared gone; the dispatcher never sleeps
        on a send, so no client can stall another. shm: the bounded
        poll-through-backpressure loop (`transport.send_bytes_reliable`
        — an SPSC ring drains on its own)."""
        if conn.dead:
            return
        if conn.tcp:
            try:
                ok = conn.s2c.send_bytes(frame)
            except OSError as e:
                self._count("wire_conn_errors_total")
                self._client_gone(conn, f"send failed: {e}")
                return
            if not ok:
                self._count("wire_slowloris_dropped_total")
                self._client_gone(
                    conn, f"outbound buffer full ({what}) — client not "
                          "draining responses")
            return
        _send(conn.s2c, frame, log=self.log, what=what)

    # frames handled per connection per dispatcher pass: one fast
    # client pipelining valid frames must not pin the single dispatcher
    # and starve the other connections' drains/leases ("no client can
    # stall another" holds against FLOODS too, not just stalls)
    FRAMES_PER_PASS = 64

    def _drain_client(self, conn: _Conn) -> bool:
        busy = False
        handled = 0
        while not conn.dead and handled < self.FRAMES_PER_PASS:
            raw = conn.c2s.recv_bytes()
            if raw is None:
                return busy
            busy = True
            handled += 1
            conn.last_seen = time.monotonic()
            # scripted dispatcher death (chaos drills): one boundary
            # per client frame handled, deterministic under a scripted
            # frame sequence
            self._frames += 1
            maybe_crash(WIRE_CRASH_SITE, self._frames)
            dec = self._decode(raw, conn.c2s.name)
            if dec is None:
                # CRC-rejected: tell the client something arrived broken
                self._send_conn(conn, _frame(K_ERROR, {
                    "error": "corrupt frame rejected (CRC)"}),
                    what="crc-error")
                continue
            payload, man = dec
            kind = man.get("kind")
            if kind == K_PING:
                continue
            if kind == K_BYE:
                self._client_gone(conn, "clean BYE", clean=True)
                return True
            if kind == K_SUBMIT:
                self._handle_submit(conn, payload)
            else:
                self.log.warning("wire: unknown frame kind %r from %s",
                                 kind, conn.cid)
        return busy

    def _handle_submit(self, conn: _Conn, payload: dict) -> None:
        rid = str(payload.get("request_id") or uuid.uuid4().hex[:12])
        # rid-ownership guard, BEFORE the service sees the submit: the
        # service's idempotent attach serves live AND retired ids with
        # no tenancy check, so without wire-level ownership any client
        # could replay a known id and STEAL another client's result
        # (found in review — the TCP port is exactly where adversarial
        # clients live). Same-cid replays (reconnect storms) pass.
        owner = self._rid_owner.get(rid)
        if owner is not None and owner != conn.cid:
            self._count("wire_rid_refused_total")
            self.log.warning(
                "wire: client %s submitted request id %r owned by "
                "client %s — refused", conn.cid, rid, owner)
            self._send_conn(conn, _frame(K_ERROR, {
                "request_id": rid,
                "error": "request_id owned by another client"}),
                what="refusal")
            return
        # the client frame always carries the key (None when the caller
        # set no deadline), so the connection default applies on None,
        # not on key absence — otherwise it would be dead code
        deadline_s = payload.get("deadline_s")
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        try:
            # the trace starts at the CLIENT: its minted id crosses the
            # wire in the submit frame and the service adopts it, so
            # one trace_id names the request from the external process
            # through admission, chunks, failover, and the result frame
            ticket = self.svc.submit(
                str(payload["kind"]), payload.get("params") or {},
                tenant=str(payload.get("tenant", conn.cid)),
                request_id=rid, deadline_s=deadline_s,
                trace_id=str(payload.get("trace_id") or "") or None)
        except RejectedError as e:
            self._send_conn(conn, _frame(K_REJECT, {
                "request_id": rid, "reason": str(e),
                "retry_after_s": e.retry_after_s}), what="reject")
            return
        except (ValueError, KeyError) as e:
            self._send_conn(conn, _frame(K_ERROR, {
                "request_id": rid,
                "error": f"{type(e).__name__}: {e}"}), what="refusal")
            return
        # duplicate-submit attach across connections (reconnect + replay
        # races the lease): if another connection OF THIS CLIENT still
        # tracks the rid, move the ticket here — exactly one connection
        # pumps a ticket's events/result.
        for other in self._conns.values():
            if other is not conn and other.cid == conn.cid:
                other.pending.pop(rid, None)
        self._rid_owner[rid] = conn.cid
        if len(self._rid_owner) > self._rid_owner_cap:
            # evict oldest-first but never a rid that is still PENDING
            # on some connection — evicting a live owner entry would
            # re-open the replay-steal for long-running requests (the
            # queue caps keep live rids far below the cap, so the scan
            # always finds retirees)
            live = set()
            for c in self._conns.values():
                live.update(c.pending)
            for rid0 in list(self._rid_owner):
                if len(self._rid_owner) <= self._rid_owner_cap:
                    break
                if rid0 not in live:
                    del self._rid_owner[rid0]
        conn.pending[rid] = ticket
        self._send_conn(conn, _frame(K_ACCEPT, {"request_id": rid}),
                        what="accept")

    def _pump_results(self, conn: _Conn) -> bool:
        """Forward buffered chunk events and terminal results. Runs for
        dead connections too (a batch in flight when the client died
        still terminates — results are discarded at the journal, not
        the scheduler), but skips the sends."""
        busy = False
        for rid in list(conn.pending):
            ticket = conn.pending[rid]
            # capture done BEFORE draining: events always precede the
            # resolution, so everything pushed before a True here is in
            # the queue we are about to drain. Capturing after would
            # race a resolve landing mid-drain and drop the trailing
            # chunk event(s) when the rid is retired below.
            done_now = ticket.done
            while True:
                try:
                    ev = ticket._events.get_nowait()
                except queuelib.Empty:
                    break
                if ev is _TICKET_SENTINEL:
                    ticket._events.put(_TICKET_SENTINEL)   # keep sticky
                    break
                busy = True
                if not conn.dead and isinstance(ev, ChunkEvent):
                    self._send_conn(conn, _frame(K_EVENT, {
                        "request_id": rid, "seq": ev.seq,
                        "payload": dict(ev.payload)}), what="event")
            if done_now:
                busy = True
                res = ticket.result(timeout=0)
                if not conn.dead:
                    self._send_conn(conn, _frame(K_RESULT, {
                        "request_id": rid, "status": res.status,
                        "value": res.value,
                        "error": res.error.to_row() if res.error
                        else None,
                        "latency_s": res.latency_s,
                        "queued_s": res.queued_s,
                        "chunks": res.chunks,
                        "preemptions": res.preemptions,
                        "resumed": res.resumed,
                        "failovers": res.failovers,
                        "trace_id": res.trace_id}),
                        what="result")
                conn.pending.pop(rid, None)
        return busy

    def _client_gone(self, conn: _Conn, reason: str,
                     clean: bool = False) -> None:
        """Loud disconnect: cancel the dead client's entries with a
        structured ``cancelled`` error — queued ones immediately,
        resident ones at their next chunk boundary — never the running
        batch mid-kernel. Every ticket stays registered so
        `_pump_results` retires it when its terminal (cancelled or
        completed-and-discarded) result lands. A SUPERSEDED connection
        (reconnect attach) never reaches here with pending work — its
        tickets were transferred, not orphaned."""
        conn.dead = True
        outcome = {rid: self.svc.cancel(
            rid, f"wire client {conn.cid} gone ({reason})")
            for rid in list(conn.pending)}
        queued = sum(1 for o in outcome.values() if o == "queued")
        resident = sum(1 for o in outcome.values() if o == "resident")
        terminal = len(outcome) - queued - resident
        (self.log.info if clean else self.log.error)(
            "wire: client %s disconnected (%s) — %d queued entr%s "
            "cancelled now, %d resident request(s) cancelled at their "
            "next chunk boundary, %d already terminal; results are "
            "discarded", conn.cid, reason, queued,
            "y" if queued == 1 else "ies", resident, terminal)
        self.svc.telemetry.counter("wire_client_disconnects_total").inc()
        self.svc.telemetry.gauge("wire_connections").set(
            sum(1 for c in self._conns.values() if not c.dead))

    def _close_conn(self, conn: _Conn) -> None:
        # a superseded connection was REPLACED in the map by its
        # successor: only evict the registry entry if it is still ours
        if self._conns.get(conn.cid) is conn:
            self._conns.pop(conn.cid, None)
        if conn.tcp:
            conn.c2s.close()           # one duplex socket
        else:
            # the CLIENT owns its rings; the server only unmaps
            conn.c2s.close(unlink=False)
            conn.s2c.close(unlink=False)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(10.0)
        for conn in list(self._conns.values()):
            if not conn.dead:
                if conn.tcp:
                    try:
                        conn.s2c.send_bytes(_frame(K_ERROR, {
                            "error": f"{E_SHUTDOWN}: wire server "
                                     "closing"}))
                        conn.s2c.flush()
                    except (OSError, ValueError):
                        pass
                else:
                    _send(conn.s2c, _frame(K_ERROR, {
                        "error": f"{E_SHUTDOWN}: wire server closing"}),
                        grace_s=0.2)
            self._close_conn(conn)
        for chan, _ in self._pending_socks:
            chan.close()
        self._pending_socks.clear()
        if self._listener is not None:
            self._listener.close()
        if self._ctl is not None:
            self._ctl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class WireClient:
    """External-process client: submit requests over the shm rings (or
    a TCP socket, ``tcp=(host, port)`` — off-host) and hold ordinary
    `Ticket`s — the same per-chunk stream + terminal `Result` surface
    the in-process API gives, resolved by a background reader thread. A
    rejected submit resolves the ticket with the same structured
    ``queue_full`` failure `submit_and_wait` produces — and
    `submit_and_wait` itself honors the admission ``retry_after_s``
    hint with bounded, deterministically jittered retries."""

    def __init__(self, base: str = "aclswarm-serve",
                 client_id: Optional[str] = None, *,
                 tcp: Optional[tuple] = None,
                 tenant: Optional[str] = None,
                 hello_timeout_s: float = 10.0,
                 ping_s: float = 2.0, log=None):
        self.base = base
        self.cid = client_id or uuid.uuid4().hex[:8]
        self.tenant = tenant or self.cid
        self.ping_s = float(ping_s)
        self.log = log or get_logger("serve.wire.client")
        self.tcp = tcp
        if tcp is not None:
            # one duplex socket: connection == handshake channel. The
            # HELLO needs no cross-process lock — this client is the
            # socket's only writer.
            chan = transport.connect_when_ready(
                tcp[0], int(tcp[1]), grace_s=hello_timeout_s)
            self._c2s = self._s2c = chan
            self._ctl = None
        else:
            # the client OWNS its connection rings; the server opens
            # them after the hello
            self._c2s = transport.Channel(f"{base}.{self.cid}.c2s",
                                          create=True,
                                          capacity=RING_CAPACITY)
            self._s2c = transport.Channel(f"{base}.{self.cid}.s2c",
                                          create=True,
                                          capacity=RING_CAPACITY)
            self._ctl = transport.open_when_ready(
                f"{base}.ctl", grace_s=hello_timeout_s)
        self._tickets: dict[str, Ticket] = {}       # guarded-by: _lock
        # the HELLO-ack payload: server identity (pid, incarnation,
        # workers) — callers distinguishing a RESPAWNED server process
        # from a reconnect of the old one read it here
        self.server_info: dict = {}
        self._lock = OrderedLock("serve.wire")
        self._stop = threading.Event()
        self._connected = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"wire-client-{self.cid}")
        self._thread.start()
        if tcp is not None:
            sent = self._c2s.send_bytes(
                _frame(K_HELLO, {"client": self.cid}))
        else:
            # the ctl ring is shared by every connecting client but the
            # shm ring is single-producer: serialize the hello behind
            # the cross-process writer lock
            with _ctl_writer_lock(base):
                sent = _send(self._ctl,
                             _frame(K_HELLO, {"client": self.cid}),
                             grace_s=hello_timeout_s, log=self.log,
                             what="hello")
        if not sent:
            self.close()
            raise OSError(f"wire hello to {self._where()} not accepted "
                          f"within {hello_timeout_s:g} s (no server "
                          "draining?)")
        if not self._connected.wait(hello_timeout_s):
            self.close()
            raise OSError(f"wire server on {self._where()} never acked "
                          f"the hello within {hello_timeout_s:g} s")

    def _where(self) -> str:
        return (f"tcp {self.tcp[0]}:{self.tcp[1]}" if self.tcp
                else f"{self.base}.ctl")

    @property
    def alive(self) -> bool:
        """True while this client can still deliver results: the
        reader thread is running and nobody called close(). A dead
        reader strands every ticket (and stops the liveness pings, so
        the server cancels the work at the lease) — callers holding a
        client across failures should check this and rebuild."""
        return self._thread.is_alive() and not self._stop.is_set()

    def forget(self, request_id: str) -> None:
        """Drop the local ticket for ``request_id`` so a later
        `submit` under the same id builds a fresh one (the re-submit
        path: a rejected id is free server-side; an accepted one
        attaches idempotently). Local bookkeeping only — nothing
        crosses the wire."""
        with self._lock:
            self._tickets.pop(request_id, None)

    def kill(self) -> None:
        """ABRUPT death, for chaos drills: no BYE, the reader stops,
        the socket/rings close immediately — exactly what the server
        sees when a client process dies. The reconnect-attach story
        (`serve.traffic`'s storms) is: `kill()`, then a new client
        under the same ``client_id`` re-submits the open ids."""
        self._stop.set()
        self._thread.join(2.0)
        self._c2s.close()
        if self._s2c is not self._c2s:
            self._s2c.close()
        if self._ctl is not None:
            self._ctl.close()

    # -------------------------------------------------------------- API

    def submit(self, kind: str, params: dict, *,
               request_id: Optional[str] = None,
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> Ticket:
        rid = request_id or uuid.uuid4().hex[:12]
        with self._lock:
            if rid in self._tickets:
                return self._tickets[rid]
            ticket = Ticket(rid)
            ticket.accepted = False    # until the accept frame lands
            self._tickets[rid] = ticket
        # swarmtrace: the trace is minted HERE, at the true origin —
        # the server adopts it, so the off-process hop is inside the
        # traced window instead of invisible before it
        try:
            ok = _send(self._c2s, _frame(K_SUBMIT, {
                "request_id": rid, "kind": kind, "params": params,
                "tenant": tenant or self.tenant, "deadline_s": deadline_s,
                "trace_id": trace_id or mint_trace_id()}),
                log=self.log, what=f"submit {rid}")
        except OSError as e:           # closed/reset socket: loud, not
            ok = False                 # a raise into the caller's lap
            self.log.error("wire client %s: submit %s failed: %s",
                           self.cid, rid, e)
        if not ok:
            ticket._resolve(Result(
                request_id=rid, status=FAILED,
                error=ServeError(E_SHUTDOWN,
                                 "wire submit never left the channel "
                                 "(server not draining)")))
        return ticket

    def submit_and_wait(self, kind: str, params: dict, *,
                        timeout: Optional[float] = None,
                        reject_retries: int = 4,
                        max_retry_wait_s: float = 30.0,
                        **kw) -> Result:
        """Submit and block for the terminal result, HONORING admission
        backpressure: a ``queue_full`` rejection sleeps out the
        server's ``retry_after_s`` hint (deterministic crc32 jitter —
        `utils.retry.jittered` — de-aligns a fleet of retriers without
        `random`) and re-submits under the SAME request id, up to
        ``reject_retries`` times. Only after the budget does the caller
        see the structured ``queue_full`` result. ``timeout`` bounds
        each wait-for-result, not the retry sleeps."""
        rid = kw.pop("request_id", None) or uuid.uuid4().hex[:12]
        seed = zlib.crc32(rid.encode())
        for attempt in range(max(0, reject_retries) + 1):
            res = self.submit(kind, params, request_id=rid,
                              **kw).result(timeout=timeout)
            if not (res.status == FAILED and res.error is not None
                    and res.error.code == E_QUEUE_FULL
                    and attempt < reject_retries):
                return res
            hint = float((res.error.detail or {})
                         .get("retry_after_s", 0.1))
            time.sleep(retry_after_delay(hint, seed, attempt,
                                         max_retry_wait_s))
            # the rejected ticket is resolved; drop it so the re-submit
            # builds a fresh one (the server never accepted the id, so
            # the id reservation is still free — or now attaches)
            self.forget(rid)
        raise AssertionError("unreachable")    # pragma: no cover

    # ------------------------------------------------------------- loop

    def _run(self) -> None:
        last_ping = time.monotonic()
        while not self._stop.is_set():
            try:
                raw = self._s2c.recv_bytes()
                now = time.monotonic()
                if now - last_ping >= self.ping_s:
                    # liveness: the server cancels queued entries of a
                    # client whose lease lapses — pings keep it alive
                    # while this process waits on long results
                    self._c2s.send_bytes(_frame(K_PING, {}))
                    last_ping = now
            except OSError as e:
                # the server closed/reset the connection (shutdown, or
                # this client tripped a hardening bound): every open
                # ticket resolves with a structured error — a lost
                # connection is loud, never a silent hang
                self._conn_lost(f"connection lost: {e}")
                return
            if raw is None:
                time.sleep(0.002)
                continue
            try:
                payload, man = ckptlib.loads(raw, self._s2c.name)
                self._handle(payload, man.get("kind"))
            except ckptlib.CheckpointError as e:
                self.log.error("wire client: corrupt server frame: %s", e)
            except Exception:      # noqa: BLE001 — a reader-thread death
                # is a silent hang for every waiting ticket; log and
                # keep reading (one bad frame must not kill the client)
                self.log.exception(
                    "wire client: frame handler failed — continuing")

    def _conn_lost(self, reason: str) -> None:
        if self._stop.is_set():
            # an INTENTIONAL teardown (close(), or a storm's scripted
            # abrupt kill): the open tickets belong to whoever killed
            # us — resolving them wire_error here would race the
            # reconnect-attach path into reporting losses that never
            # happened
            return
        self.log.error("wire client %s: %s", self.cid, reason)
        with self._lock:
            open_tickets = [t for t in self._tickets.values()
                            if not t.done]
        for t in open_tickets:
            t._resolve(Result(
                request_id=t.request_id, status=FAILED,
                error=ServeError("wire_error", reason)))

    def _handle(self, payload: dict, kind: Optional[str]) -> None:
        if kind == K_HELLO_ACK:
            self.server_info = dict(payload)
            self._connected.set()
            return
        rid = str(payload.get("request_id", ""))
        with self._lock:
            ticket = self._tickets.get(rid)
        if kind == K_EVENT and ticket is not None:
            ticket._push(ChunkEvent(rid, int(payload.get("seq", 0)),
                                    dict(payload.get("payload") or {})))
        elif kind == K_RESULT and ticket is not None:
            err = payload.get("error")
            ticket._resolve(Result(
                request_id=rid, status=str(payload["status"]),
                value=payload.get("value"),
                error=ServeError(**err) if err else None,
                latency_s=float(payload.get("latency_s", 0.0)),
                queued_s=float(payload.get("queued_s", 0.0)),
                chunks=int(payload.get("chunks", 0)),
                preemptions=int(payload.get("preemptions", 0)),
                resumed=bool(payload.get("resumed", False)),
                failovers=int(payload.get("failovers", 0)),
                trace_id=str(payload.get("trace_id", ""))))
        elif kind == K_REJECT and ticket is not None:
            ticket._resolve(Result(
                request_id=rid, status=FAILED,
                error=ServeError(
                    E_QUEUE_FULL, str(payload.get("reason", "rejected")),
                    detail={"retry_after_s":
                            float(payload.get("retry_after_s", 0.0))})))
        elif kind == K_ERROR:
            msg = str(payload.get("error", "server error"))
            if ticket is not None:
                ticket._resolve(Result(
                    request_id=rid, status=FAILED,
                    error=ServeError("wire_error", msg)))
            else:
                self.log.error("wire client: server error: %s", msg)
        elif kind == K_ACCEPT:
            if ticket is not None:
                ticket.accepted = True
        elif kind in (K_EVENT, K_RESULT, K_REJECT):
            # known kind, no local ticket: a reconnect can receive
            # events for transferred requests before this process
            # re-submits them — progress is lost, the result is not
            self.log.info("wire client: %s for untracked request %r "
                          "(reconnect window) — dropped", kind, rid)
        else:
            self.log.warning("wire client: unknown frame kind %r", kind)

    def close(self, bye: bool = True) -> None:
        """Clean shutdown: BYE tells the server to cancel anything
        still queued for this client (loudly, with structured errors)
        instead of waiting out the lease."""
        if bye:
            try:
                self._c2s.send_bytes(_frame(K_BYE, {}))
                if self.tcp:
                    self._c2s.flush()
            except Exception:        # noqa: BLE001 — channel may be gone
                pass
        self._stop.set()
        self._thread.join(5.0)
        if self._ctl is not None:
            self._ctl.close()
        self._c2s.close()
        if self._s2c is not self._c2s:
            self._s2c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

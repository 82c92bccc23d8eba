"""The router: a stateless routing tier over process-per-worker cells
(port of `aclswarm_tpu/serve/router.py`).

`SwarmRouter` is the front door for a fleet of `serve.procworker`
processes, each a `SwarmService` slot with its own CUDA context on the
card. It speaks the codec-framed wire protocol in both directions and
holds no durable state of its own — every promise lives in a worker's
per-slot journal, so the router can die and restart without losing
anything:

- **south side (supervision)**: a TCP listener procworkers dial. The
  HELLO carries ``(slot, incarnation, pid)`` and admission is the
  duplicate-claim arbiter — exactly one process owns a slot, the loser
  is refused with a structured error (sent outside the router lock)
  before it can build a service. Heartbeats are `wire.K_PING` frames;
  the lease/declare-dead logic from `serve.workers.WorkerPool` carries
  over with "thread death" replaced by *connection death OR process
  exit*, and fencing by per-job epochs replaced by incarnation-stamped
  journal frames (`service.write_fence` — stamped into the slot's
  journal dir before every respawn, so a zombie's writes are no-ops).
  Each beat's ``launches`` (the child's `ops.LAUNCHES`) is kept per
  incarnation (`child_launches`), and each READY's boot seconds from the
  spawn (`boots`);
- **north side (clients)**: the router IS a `wire.WireServer` service
  facade — it implements the same four-member surface the wire server
  needs (``telemetry`` / ``stats`` / ``submit`` / ``cancel``), so the
  front door is the unchanged wire protocol and any `WireClient` (the
  traffic fleet included) talks to the fleet without knowing it is one;
- **placement**: rendezvous hash of ``(bucket, incarnation set)`` —
  the same `serve.workers.place_slot` math, with worker UIDs
  (``slot.gen``) as candidates, so churn re-places only the dead
  incarnation's buckets;
- **failover**: reconnect-attach through the journal. A killed
  process's slot respawns onto its STABLE journal dir; recovery
  re-admits the in-flight requests from their req-frames and resumes
  rollouts from their chunk checkpoints (bit for bit); the router
  re-submits the same request ids to the new incarnation and the
  service's idempotent attach binds them to the recovered jobs. The
  client's connection to the router never blinks;
- **rolling restart**: ``rolling_restart()`` drives
  drain → fence → respawn → re-admit per slot.

The children are spawned as ``python -m aclswarm_torch.serve.procworker``
(`subprocess.Popen`, an exec: no fork of a process that holds CUDA),
with the port's root on ``PYTHONPATH``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, List, Optional

from aclswarm_torch.interop import transport
from aclswarm_torch.resilience import checkpoint as ckptlib
from aclswarm_torch.serve import wire
from aclswarm_torch.serve.api import (COMPLETED, E_CANCELLED, E_DEADLINE,
                                      E_SHUTDOWN, FAILED, TIMED_OUT,
                                      RejectedError, Result, ServeError,
                                      Ticket)
from aclswarm_torch.serve.service import bucket_of, write_fence
from aclswarm_torch.serve.workers import place_slot
from aclswarm_torch.telemetry import MetricsRegistry
from aclswarm_torch.telemetry.locks import OrderedLock
from aclswarm_torch.utils.log import get_logger

# slot states (the process-fleet analogue of serve.workers' lifecycle)
SPAWNING = "spawning"    # launched / admitted, not READY yet
UP = "up"                # ready: data-plane client connected, placeable
DRAINING = "draining"    # placeable set excludes it; in-flight finishing
DEAD = "dead"            # declared dead (conn death / exit / lease)
RETIRED = "retired"      # circuit open: max consecutive respawns burned


@dataclasses.dataclass
class RouterConfig:
    """Router knobs. ``journal_root`` holds one STABLE dir per slot
    (``w{slot}``) — stability across incarnations is what makes respawn
    recovery (and therefore failover) work."""

    journal_root: str
    slots: int = 2
    host: str = "127.0.0.1"
    lease_s: float = 5.0           # worker silent this long => dead
    handshake_s: float = 5.0       # accepted sock must HELLO within
    spawn_timeout_s: float = 180.0  # child boot: torch import, CUDA
    #                                context, kernel library load,
    #                                recovery, warmup
    poll_s: float = 0.005
    respawn: bool = True
    max_respawns: int = 3          # CONSECUTIVE spawn failures/deaths
    #                                before a slot retires (reset by a
    #                                completed READY + first beat)
    drain_timeout_s: float = 30.0
    max_resubmits: int = 5         # per-request failover budget
    max_inflight: int = 512        # router-level admission cap
    scrape_timeout_s: float = 10.0  # health/stats fan-out budget
    # ServiceConfig overrides + warmup list shipped to every child:
    # {"service": {...}, "warm": [[kind, params], ...]}
    worker: dict = dataclasses.field(default_factory=dict)
    incarnation: int = 0           # the router's own identity in its
    #                                HELLO acks (it is not journaled)


@dataclasses.dataclass
class _ProcSlot:
    """One supervised worker-process slot (parent-side record)."""

    slot: int
    gen: int = 0
    state: str = DEAD
    pid: Optional[int] = None
    wire_port: Optional[int] = None
    proc: Optional[subprocess.Popen] = None
    chan: object = None            # supervision SocketChannel
    client: Optional[wire.WireClient] = None
    last_beat: float = 0.0         # monotonic
    t_spawn: float = 0.0
    deaths: int = 0                # consecutive (retire input)
    stop_requested: bool = False   # clean stop: skip auto-respawn
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def uid(self) -> str:
        return f"{self.slot}.{self.gen}"


@dataclasses.dataclass
class _Route:
    """Router-side record of one in-flight client request — everything
    needed to re-dispatch it if its worker process dies."""

    rid: str
    kind: str
    params: dict
    tenant: str
    deadline_s: Optional[float]
    trace_id: Optional[str]
    bucket: tuple
    front: Ticket
    t_submit: float                # wall clock
    backend: Optional[Ticket] = None
    uid: str = ""
    resubmits: int = 0
    cancelled: bool = False
    dispatching: bool = False      # single-flight guard: submit() and
    #                                the pump must never race a double
    #                                forget+submit for one rid


class SwarmRouter:
    """Stateless wire front door + process-fleet supervisor. Also the
    `WireServer` service facade: ``telemetry`` / ``stats`` /
    ``submit`` / ``cancel`` are exactly the four members the wire
    dispatcher touches."""

    def __init__(self, cfg: RouterConfig, log=None):
        self.cfg = cfg
        self.log = log or get_logger("serve.router")
        self.telemetry = MetricsRegistry()
        self.stats = {"workers": int(cfg.slots)}
        self.root = Path(cfg.journal_root)
        self.root.mkdir(parents=True, exist_ok=True)
        # key set fixed at construction (slots never add/remove), so
        # len()/iteration are lock-free; the _ProcSlot FIELDS are
        # mutated under _lock
        self._slots: Dict[int, _ProcSlot] = {
            i: _ProcSlot(slot=i) for i in range(max(1, cfg.slots))}
        self._routes: Dict[str, _Route] = {}        # guarded-by: _lock
        self._lock = OrderedLock("serve.router", registry=self.telemetry)
        self._closing = False
        self._stop = threading.Event()
        # death ledger: every declared death, with wall + monotonic
        # stamps so drills measure detection latency from the kill.
        # APPEND-only, appended under _lock; drills and status
        # snapshots read len()/[-1] lock-free (atomic in CPython,
        # staleness tolerated by design — polling loops must not
        # contend with the supervision path)
        self.deaths: List[dict] = []
        # per incarnation uid: the child's last beat's kernel launches
        # (and the library it loaded); one row per READY with its boot
        # seconds from the spawn. Written by the supervision thread only
        self.child_launches: Dict[str, dict] = {}
        self.boots: List[dict] = []
        self._sup = transport.SocketListener(cfg.host, 0)
        self._pending_socks: List[tuple] = []
        self.wire: Optional[wire.WireServer] = None
        self.telemetry.gauge("router_workers_total").set(len(self._slots))
        self._sup_thread = threading.Thread(
            target=self._supervise, daemon=True, name="router-supervise")
        self._pump_thread = threading.Thread(
            target=self._pump, daemon=True, name="router-pump")

    # ------------------------------------------------------- lifecycle

    @property
    def supervision_address(self) -> tuple:
        return self._sup.address

    @property
    def tcp_address(self) -> Optional[tuple]:
        """Client-facing (host, port) — None until start(front=True)."""
        return self.wire.tcp_address if self.wire is not None else None

    def _journal_dir(self, slot: int) -> Path:
        return self.root / f"w{slot}"

    def start(self, spawn: bool = True, front: bool = True,
              extra_env: Optional[dict] = None) -> "SwarmRouter":
        """Launch supervision + pump threads, optionally spawn the
        fleet and open the client-facing wire listener. Split so tests
        can run a router that only ARBITRATES (spawn=False, front=False
        — external claimants dial the supervision port themselves)."""
        self._sup_thread.start()
        self._pump_thread.start()
        if spawn:
            with self._lock:
                for sl in self._slots.values():
                    self._spawn_locked(sl, extra_env=extra_env)
        if front:
            self.wire = wire.WireServer(self, base=None,
                                        tcp=(self.cfg.host, 0))
        return self

    def wait_ready(self, timeout: float = None) -> bool:
        """Block until every non-retired slot is UP (placeable)."""
        t_end = time.monotonic() + (timeout if timeout is not None
                                    else self.cfg.spawn_timeout_s)
        while time.monotonic() < t_end:
            with self._lock:
                states = [sl.state for sl in self._slots.values()]
            if states and all(s in (UP, RETIRED) for s in states) \
                    and any(s == UP for s in states):
                return True
            time.sleep(0.05)
        return False

    def close(self, timeout: float = 30.0) -> None:
        self._closing = True
        if self.wire is not None:
            self.wire.close()
        # resolve whatever is still routed — the promise ledger lives
        # in the worker journals, so a recovery can still honor these
        with self._lock:
            routes = list(self._routes.values())
            self._routes.clear()
        for r in routes:
            r.front._resolve(Result(
                request_id=r.rid, status=FAILED,
                error=ServeError(E_SHUTDOWN, "router closing"),
                trace_id=r.trace_id or ""))
        with self._lock:
            slots = list(self._slots.values())
        for sl in slots:
            self._stop_slot_locked_free(sl)
        t_end = time.monotonic() + timeout
        for sl in slots:
            if sl.proc is not None:
                try:
                    sl.proc.wait(max(0.1, t_end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    self.log.error("worker w%s did not exit — SIGKILL",
                                   sl.uid)
                    try:
                        sl.proc.kill()
                        sl.proc.wait(5.0)
                    except OSError:
                        pass
        self._stop.set()
        self._sup_thread.join(5.0)
        self._pump_thread.join(5.0)
        for sl in slots:
            if sl.client is not None:
                try:
                    sl.client.close(bye=False)
                except OSError:
                    pass
            if sl.chan is not None:
                sl.chan.close()
        for chan, _ in self._pending_socks:
            chan.close()
        self._sup.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------------------------------------------- spawn / stop

    def _spawn_locked(self, sl: _ProcSlot,
                      extra_env: Optional[dict] = None) -> None:
        """Fence the predecessor, bump the incarnation, launch the
        child (caller holds the lock)."""
        sl.gen += 1
        sl.state = SPAWNING
        sl.pid = None
        sl.wire_port = None
        sl.stop_requested = False
        sl.t_spawn = time.monotonic()
        sl.last_beat = time.monotonic()
        jdir = self._journal_dir(sl.slot)
        jdir.mkdir(parents=True, exist_ok=True)
        # fence FIRST: from here the predecessor's journal writes are
        # no-ops even if the child takes seconds to boot
        write_fence(jdir, sl.gen)
        cmd = [sys.executable, "-m", "aclswarm_torch.serve.procworker",
               "--slot", str(sl.slot), "--incarnation", str(sl.gen),
               "--supervisor",
               f"{self.cfg.host}:{self.supervision_address[1]}",
               "--journal-dir", str(jdir),
               "--config", json.dumps(self.cfg.worker)]
        # the child must import this package no matter the parent's cwd
        import aclswarm_torch
        pkg_root = str(Path(aclswarm_torch.__file__).resolve().parents[1])
        env = {**os.environ, **(extra_env or {})}
        env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else pkg_root)
        logf = open(jdir / f"proc.{sl.gen}.log", "ab")
        try:
            sl.proc = subprocess.Popen(
                cmd, stdout=logf, stderr=subprocess.STDOUT, env=env)
        finally:
            logf.close()
        self.telemetry.counter("router_spawns_total").inc()
        self.log.info("spawned w%s pid %d (journal %s)",
                      sl.uid, sl.proc.pid, jdir)

    def ensure_spawned(self, slot: int,
                       extra_env: Optional[dict] = None) -> None:
        with self._lock:
            sl = self._slots[slot]
            if sl.state in (SPAWNING, UP, DRAINING):
                return
            if sl.state == RETIRED:
                sl.deaths = 0       # explicit restart resets the breaker
            self._spawn_locked(sl, extra_env=extra_env)

    def drain_slot(self, slot: int) -> None:
        """Remove the slot from the placeable set; in-flight work keeps
        running. Tells the worker too (observable ack)."""
        with self._lock:
            sl = self._slots[slot]
            if sl.state != UP:
                return
            sl.state = DRAINING
        self._send_ctl(sl, "drain")

    def stop_slot(self, slot: int, kill: bool = False) -> Optional[int]:
        """Stop the slot's process: ``kill=True`` SIGKILLs it (the
        chaos path — supervision notices via connection death and the
        failover machinery runs); otherwise a clean ``die`` control.
        Returns the pid stopped (None if the slot had none)."""
        with self._lock:
            sl = self._slots[slot]
            pid = sl.pid if sl.pid is not None else (
                sl.proc.pid if sl.proc is not None else None)
            if not kill:
                sl.stop_requested = True
        if pid is None:
            return None
        if kill:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        else:
            self._send_ctl(sl, "die")
        return pid

    def _stop_slot_locked_free(self, sl: _ProcSlot) -> None:
        sl.stop_requested = True
        if sl.chan is not None:
            try:
                sl.chan.send_bytes(wire._frame(wire.K_EVENT,
                                               {"ctl": "die"}))
                sl.chan.flush()
            except OSError:
                pass

    def _send_ctl(self, sl: _ProcSlot, ctl: str) -> None:
        if sl.chan is None:
            return
        try:
            sl.chan.send_bytes(wire._frame(wire.K_EVENT, {"ctl": ctl}))
            sl.chan.flush()
        except OSError as e:
            self.log.error("ctl %s to w%s failed: %s", ctl, sl.uid, e)

    # ------------------------------------------------- supervision loop

    def _supervise(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self._supervise_pass()
            except Exception:      # noqa: BLE001 — supervisor must live
                self.log.exception("supervision pass failed — continuing")
                busy = False
            if not busy:
                time.sleep(self.cfg.poll_s)

    def _supervise_pass(self) -> bool:
        busy = False
        # accept + handshake-window the supervision socks
        while True:
            chan = self._sup.accept()
            if chan is None:
                break
            busy = True
            self._pending_socks.append((chan, time.monotonic()))
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
                if now - t0 > self.cfg.handshake_s:
                    self._pending_socks.remove(entry)
                    chan.close()
                continue
            busy = True
            self._pending_socks.remove(entry)
            self._admit(chan, raw)
        # per-slot: drain frames, watch the process, enforce the lease
        with self._lock:
            slots = list(self._slots.values())
        for sl in slots:
            if sl.chan is not None:
                try:
                    while True:
                        raw = sl.chan.recv_bytes()
                        if raw is None:
                            break
                        busy = True
                        self._worker_frame(sl, raw)
                except OSError as e:
                    self._declare_dead(sl, f"connection death: {e}")
                    continue
            if sl.state in (SPAWNING, UP, DRAINING):
                if sl.proc is not None and sl.proc.poll() is not None:
                    self._declare_dead(
                        sl, f"process exit (rc {sl.proc.returncode})",
                        expected=sl.stop_requested
                        or sl.proc.returncode == 0)
                elif sl.state in (UP, DRAINING) and sl.chan is not None \
                        and now - sl.last_beat > self.cfg.lease_s:
                    # the lease starts at READY: a SPAWNING child is
                    # silent by design (torch import, CUDA context,
                    # warmup) and
                    # bounded by spawn_timeout_s instead
                    self._declare_dead(
                        sl, f"lease ({self.cfg.lease_s:g} s) missed — "
                            "process wedged")
                elif sl.state == SPAWNING and \
                        now - sl.t_spawn > self.cfg.spawn_timeout_s:
                    self._declare_dead(
                        sl, f"never READY within "
                            f"{self.cfg.spawn_timeout_s:g} s")
            if sl.state == DEAD and self.cfg.respawn and sl.gen > 0 \
                    and not sl.stop_requested and not self._closing:
                if sl.deaths > self.cfg.max_respawns:
                    sl.state = RETIRED
                    self.log.error(
                        "slot %d RETIRED after %d consecutive deaths",
                        sl.slot, sl.deaths)
                    self._gauge_up()
                else:
                    with self._lock:
                        self._spawn_locked(sl)
                    self.telemetry.counter("router_respawns_total").inc()
                    busy = True
        return busy

    def _admit(self, chan, raw: bytes) -> None:
        """Supervision HELLO admission — the duplicate-slot arbiter.
        Exactly one claimant wins; the loser gets a structured error
        and its connection closed before it can build a service."""
        try:
            payload, man = ckptlib.loads(raw, chan.name)
        except ckptlib.CheckpointError as e:
            self.log.error("corrupt supervision HELLO: %s", e)
            chan.close()
            return
        if man.get("kind") != wire.K_HELLO \
                or payload.get("role") != "procworker":
            self.log.warning("non-procworker HELLO on the supervision "
                             "port — closed")
            chan.close()
            return
        slot_id = int(payload.get("slot", -1))
        inc = int(payload.get("incarnation", -1))
        pid = int(payload.get("pid", 0))

        def _refuse(err: str, **extra) -> None:
            # called with _lock RELEASED: the loser's socket may be
            # wedged, and a blocking send under the router lock would
            # stall the sweep/respawn path for the whole fleet (the
            # ack send below already follows the same rule)
            self.telemetry.counter("router_hello_refused_total").inc()
            self.log.warning("HELLO w%d.%d pid %d REFUSED: %s",
                             slot_id, inc, pid, err)
            try:
                chan.send_bytes(wire._frame(
                    wire.K_ERROR, {"error": err, "slot": slot_id,
                                   **extra}))
                chan.flush()
            except OSError:
                pass
            chan.close()

        refusal = None      # (err, extra) decided under the lock
        with self._lock:
            sl = self._slots.get(slot_id)
            if sl is None:
                refusal = (f"unknown slot {slot_id}", {})
            elif sl.chan is not None and sl.state in (SPAWNING, UP,
                                                      DRAINING):
                refusal = ("slot_taken",
                           {"owner": sl.uid, "owner_pid": sl.pid})
            elif inc < sl.gen:
                refusal = ("stale_incarnation", {"current": sl.gen})
            elif sl.proc is not None and sl.state == SPAWNING \
                    and pid != sl.proc.pid:
                refusal = ("slot_reserved", {"owner_pid": sl.proc.pid})
            else:
                sl.gen = inc
                sl.pid = pid
                sl.chan = chan
                sl.state = SPAWNING     # READY promotes to UP
                sl.last_beat = time.monotonic()
                if sl.proc is None:
                    # externally-launched claimant (spawn=False mode):
                    # its boot budget starts at admission — an
                    # unstamped t_spawn would read as an expired spawn
                    # window and insta-declare the winner dead
                    sl.t_spawn = time.monotonic()
        if refusal is not None:
            _refuse(refusal[0], **refusal[1])
            return
        try:
            chan.send_bytes(wire._frame(wire.K_HELLO_ACK, {
                "server": "router", "accepted": True,
                "pid": os.getpid(),
                "incarnation": int(self.cfg.incarnation),
                "lease_s": self.cfg.lease_s,
                "workers": len(self._slots)}))
            chan.flush()
        except OSError as e:
            self._declare_dead(sl, f"ack send failed: {e}")
            return
        self.log.info("admitted w%s pid %d", sl.uid, pid)

    def _worker_frame(self, sl: _ProcSlot, raw: bytes) -> None:
        try:
            payload, man = ckptlib.loads(raw, sl.chan.name)
        except ckptlib.CheckpointError as e:
            self.log.error("corrupt frame from w%s: %s", sl.uid, e)
            return
        sl.last_beat = time.monotonic()
        kind = man.get("kind")
        if kind == wire.K_PING:
            if payload.get("stats"):
                sl.stats = dict(payload["stats"])
            if payload.get("launches") is not None:
                self.child_launches[sl.uid] = {
                    "pid": sl.pid, "launches": dict(payload["launches"]),
                    "library": dict(payload.get("library") or {})}
            return
        if kind == wire.K_BYE:
            self._declare_dead(sl, "clean BYE", expected=True)
            return
        if kind == wire.K_EVENT and payload.get("event") == "ready":
            sl.wire_port = int(payload["wire_port"])
            try:
                client = wire.WireClient(
                    tcp=(self.cfg.host, sl.wire_port),
                    client_id=f"router-w{sl.uid}",
                    tenant="_router", hello_timeout_s=15.0)
            except OSError as e:
                self._declare_dead(sl, f"data plane dial failed: {e}")
                return
            old = sl.client
            sl.client = client
            if old is not None:
                try:
                    old.close(bye=False)
                except OSError:
                    pass
            sl.state = UP
            sl.deaths = 0           # completed boot resets the breaker
            self.boots.append({"uid": sl.uid, "pid": sl.pid,
                               "boot_s": time.monotonic() - sl.t_spawn})
            self._gauge_up()
            self.log.info("w%s UP (pid %d, data plane :%d, ack pid=%s "
                          "incarnation=%s)", sl.uid, sl.pid,
                          sl.wire_port,
                          client.server_info.get("pid"),
                          client.server_info.get("incarnation"))
            return
        if kind == wire.K_EVENT and payload.get("event") == "draining":
            self.log.info("w%s draining acknowledged (%s in flight)",
                          sl.uid, payload.get("inflight"))
            return

    def _gauge_up(self) -> None:
        with self._lock:
            up = sum(1 for s in self._slots.values() if s.state == UP)
        self.telemetry.gauge("router_workers_up").set(up)

    def _declare_dead(self, sl: _ProcSlot, reason: str,
                      expected: bool = False) -> None:
        """Connection death OR process exit OR lease miss — the
        process-fleet spelling of `WorkerPool._declare_dead`. Requeues
        the dead incarnation's routes for re-dispatch (the journal owns
        the durable copy; the respawned incarnation recovers it)."""
        with self._lock:
            if sl.state in (DEAD, RETIRED):
                return
            uid = sl.uid
            sl.state = DEAD
            sl.deaths = 0 if expected else sl.deaths + 1
            chan, client = sl.chan, sl.client
            sl.chan = None
            sl.client = None
            requeued = 0
            for r in self._routes.values():
                if r.uid == uid and r.backend is not None \
                        and not r.backend.done:
                    r.backend = None
                    r.resubmits += 1
                    requeued += 1
            death = {"slot": sl.slot, "uid": uid, "pid": sl.pid,
                     "reason": reason, "expected": bool(expected),
                     "requeued": requeued,
                     "t_dead_wall": time.time(),
                     "t_dead_mono": time.monotonic()}
            self.deaths.append(death)
        (self.log.info if expected else self.log.error)(
            "worker w%s DEAD (%s) — %d in-flight route(s) requeued for "
            "re-dispatch through the journal", uid, reason, requeued)
        if not expected:
            self.telemetry.counter("router_worker_deaths_total").inc()
        if requeued:
            self.telemetry.counter("router_failovers_total").inc(requeued)
        self._gauge_up()
        if chan is not None:
            chan.close()
        if client is not None:
            try:
                client.kill()
            except OSError:
                pass

    # -------------------------------------------------- placement/pump

    def _placeable(self) -> List[_ProcSlot]:
        return [sl for sl in self._slots.values()
                if sl.state == UP and sl.client is not None
                and sl.client.alive]

    def _place(self, bucket: tuple) -> Optional[_ProcSlot]:
        """Rendezvous over ``(bucket, incarnation set)``: candidates
        are worker UIDs, so a respawn (new incarnation) re-rolls ONLY
        what the hash moves — the same minimal-churn property the
        thread fleet's bucket placement has."""
        with self._lock:
            cands = {sl.uid: sl for sl in self._placeable()}
        if not cands:
            return None
        uid = place_slot(bucket, sorted(cands))
        return cands[uid]

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self._pump_pass()
            except Exception:      # noqa: BLE001 — pump must live
                self.log.exception("route pump pass failed — continuing")
                busy = False
            if not busy:
                time.sleep(0.002)

    def _pump_pass(self) -> bool:
        busy = False
        now = time.time()
        with self._lock:
            routes = list(self._routes.values())
        for r in routes:
            if r.front.done:
                with self._lock:
                    self._routes.pop(r.rid, None)
                continue
            if r.backend is None:
                # awaiting re-dispatch after a worker death (or the
                # first dispatch raced a churn window)
                if r.deadline_s is not None \
                        and now - r.t_submit > r.deadline_s:
                    self._resolve(r, Result(
                        request_id=r.rid, status=TIMED_OUT,
                        error=ServeError(
                            E_DEADLINE,
                            f"deadline ({r.deadline_s:g} s) passed "
                            "while awaiting a live worker"),
                        latency_s=now - r.t_submit,
                        trace_id=r.trace_id or ""))
                    busy = True
                    continue
                busy |= self._dispatch(r)
                continue
            # forward buffered chunk events (done captured FIRST —
            # same race discipline as wire._pump_results)
            done_now = r.backend.done
            if not done_now and not self._uid_live(r.uid):
                # safety net for the dispatch-vs-death window: a
                # backend ticket parked on a killed client never
                # resolves (kill() suppresses resolution), so a
                # pending route on a dead incarnation requeues here
                # even if `_declare_dead` raced past it
                r.backend = None
                r.resubmits += 1
                self.telemetry.counter("router_failovers_total").inc()
                busy = True
                continue
            while True:
                try:
                    ev = r.backend._events.get_nowait()
                except Exception:   # queue.Empty
                    break
                if ev is wire._TICKET_SENTINEL:
                    r.backend._events.put(wire._TICKET_SENTINEL)
                    break
                busy = True
                r.front._push(ev)
            if done_now:
                busy = True
                res = r.backend.result(timeout=0)
                if self._is_worker_loss(r, res) \
                        and r.resubmits <= self.cfg.max_resubmits \
                        and not r.cancelled and not self._closing:
                    # the backend died under the request: requeue — the
                    # journal still owes it, the respawn will recover it
                    r.backend = None
                    r.resubmits += 1
                    self.telemetry.counter(
                        "router_failovers_total").inc()
                    continue
                self._resolve(r, dataclasses.replace(
                    res, failovers=res.failovers + (1 if r.resubmits
                                                    else 0)))
        return busy

    def _uid_live(self, uid: str) -> bool:
        """Is this EXACT incarnation still serving (UP or finishing a
        drain) with a usable data-plane client?"""
        try:
            slot = int(uid.split(".")[0])
        except (ValueError, IndexError):
            return False
        with self._lock:
            sl = self._slots.get(slot)
            return (sl is not None and sl.state in (UP, DRAINING)
                    and sl.uid == uid and sl.client is not None
                    and sl.client.alive)

    def _is_worker_loss(self, r: _Route, res: Result) -> bool:
        """A terminal that means 'the WORKER went away', not 'the
        request failed': wire transport errors, or a shutdown the
        worker broadcast while dying. Only treated as loss when the
        placed incarnation is in fact no longer the live one —
        a healthy worker's genuine error result always passes
        through."""
        if res.error is None:
            return False
        if res.error.code not in ("wire_error", E_SHUTDOWN):
            return False
        return not self._uid_live(r.uid)

    def _dispatch(self, r: _Route) -> bool:
        with self._lock:
            if r.backend is not None or r.dispatching or r.cancelled \
                    or r.front.done:
                return False
            r.dispatching = True
        try:
            sl = self._place(r.bucket)
            if sl is None:
                return False
            client = sl.client
            try:
                client.forget(r.rid)    # a fresh ticket per dispatch
                backend = client.submit(
                    r.kind, r.params, request_id=r.rid,
                    tenant=r.tenant, deadline_s=r.deadline_s,
                    trace_id=r.trace_id)
            except OSError as e:
                self.log.error("dispatch %s to w%s failed: %s",
                               r.rid, sl.uid, e)
                return False
            with self._lock:
                r.backend = backend
                r.uid = sl.uid
            self.telemetry.counter("router_dispatch_total").inc()
            return True
        finally:
            with self._lock:
                r.dispatching = False

    def _resolve(self, r: _Route, res: Result) -> None:
        with self._lock:
            self._routes.pop(r.rid, None)
        r.front._resolve(res)

    # --------------------------------------- WireServer service facade

    def submit(self, kind: str, params: dict, *,
               tenant: str = "default",
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> Ticket:
        """The `SwarmService.submit` surface, routing edition. The
        ticket returned is the ROUTER's promise: it survives worker
        process death (re-dispatch through the journal) and resolves
        with whatever terminal the fleet produces. ``health`` and
        ``stats`` are answered by fleet-wide aggregation — one scrape
        reads every process."""
        rid = request_id or uuid.uuid4().hex[:12]
        if self._closing:
            raise RejectedError(E_SHUTDOWN, 0.0)
        with self._lock:
            prior = self._routes.get(rid)
            if prior is not None:
                return prior.front  # idempotent duplicate attach
        if kind in ("health", "stats") \
                and not (params or {}).get("worker_only"):
            front = Ticket(rid)
            threading.Thread(
                target=self._scrape, daemon=True,
                args=(kind, dict(params or {}), front, rid),
                name=f"router-scrape-{rid}").start()
            return front
        bucket = bucket_of(kind, params or {})   # ValueError refuses
        with self._lock:
            if len(self._routes) >= self.cfg.max_inflight:
                raise RejectedError("router inflight cap", 0.25)
            if not any(sl.state in (UP, SPAWNING, DRAINING)
                       for sl in self._slots.values()):
                raise RejectedError("no live workers", 1.0)
            front = Ticket(rid)
            r = _Route(rid=rid, kind=kind, params=dict(params or {}),
                       tenant=tenant, deadline_s=deadline_s,
                       trace_id=trace_id, bucket=bucket, front=front,
                       t_submit=time.time())
            self._routes[rid] = r
        self.telemetry.counter("router_requests_total").inc()
        self._dispatch(r)           # pump retries if this window misses
        return front

    def cancel(self, request_id: str,
               reason: str = "cancelled by client"):
        """Wire-disconnect semantics at the router: resolve the front
        ticket with a structured ``cancelled`` error and drop the
        route. The worker-side copy runs to its own terminal and is
        discarded at ITS journal — bounded waste, never a wedge."""
        with self._lock:
            r = self._routes.get(request_id)
            if r is None or r.front.done:
                return None
            r.cancelled = True
            self._routes.pop(request_id, None)
            backend = r.backend
        verdict = ("resident" if backend is not None
                   and backend.accepted else "queued")
        r.front._resolve(Result(
            request_id=request_id, status=FAILED,
            error=ServeError(E_CANCELLED, reason),
            trace_id=r.trace_id or ""))
        return verdict

    # ----------------------------------------------- fleet aggregation

    def _scrape(self, kind: str, params: dict, front: Ticket,
                rid: str) -> None:
        """Fan a ``health``/``stats`` scrape across every live process
        and aggregate into ONE codec-serializable payload — the fleet
        is one scrape target (`telemetry/watch.py --tcp` pointed at the
        router sees every worker process, pids and incarnations
        included)."""
        t0 = time.time()
        with self._lock:
            live = [(sl.uid, sl.slot, sl.pid, sl.client)
                    for sl in self._placeable()]
            states = {sl.uid: sl.state for sl in self._slots.values()}
        per: Dict[str, dict] = {}
        for uid, slot, pid, client in live:
            sub = dict(params)
            sub["worker_only"] = True
            try:
                res = client.submit(
                    kind, sub, request_id=f"{rid}.w{slot}",
                    tenant="_router").result(
                        timeout=self.cfg.scrape_timeout_s)
                per[uid] = {"pid": pid, "up": res.ok,
                            "value": res.value,
                            "error": (res.error.to_row()
                                      if res.error else None)}
            except (OSError, TimeoutError) as e:
                per[uid] = {"pid": pid, "up": False, "value": None,
                            "error": {"code": "scrape_failed",
                                      "message": str(e)}}
        if kind == "health":
            value = self._aggregate_health(per, states)
        else:
            value = self._aggregate_stats(params, per)
        front._resolve(Result(request_id=rid, status=COMPLETED,
                              value=value, latency_s=time.time() - t0))

    def _aggregate_health(self, per: Dict[str, dict],
                          states: Dict[str, str]) -> dict:
        counts: Dict[str, float] = {}
        queue_depth = 0
        per_worker: Dict[str, bool] = {u: False for u in states}
        processes: Dict[str, dict] = {}
        watch_enabled = False
        for uid, row in per.items():
            h = row.get("value") or {}
            per_worker[uid] = bool(row.get("up")) and bool(
                h.get("alive", False))
            watch_enabled |= bool(h.get("watch_enabled"))
            queue_depth += int(h.get("queue_depth", 0))
            for k, v in (h.get("counts") or {}).items():
                counts[k] = counts.get(k, 0) + v
            processes[uid] = {
                "pid": h.get("pid", row.get("pid")),
                "incarnation": h.get("incarnation"),
                "up": per_worker[uid],
                "watch": h.get("watch"),
                "error": row.get("error")}
        up = sum(1 for v in per_worker.values() if v)
        with self._lock:
            inflight = len(self._routes)
        return {
            "t_wall": time.time(),
            "alive": up > 0,
            "pid": os.getpid(),
            "incarnation": int(self.cfg.incarnation),
            "router": True,
            "watch_enabled": watch_enabled,
            "watch": None,
            "workers": {"total": len(states), "up": up,
                        "per_worker": per_worker},
            "queue_depth": queue_depth,
            "inflight": inflight,
            "counts": counts,
            "deaths": len([d for d in self.deaths
                           if not d["expected"]]),
            "processes": processes,
        }

    def _aggregate_stats(self, params: dict,
                         per: Dict[str, dict]) -> dict:
        fmt = str(params.get("format", "prometheus"))
        if fmt == "prometheus":
            parts = [self.telemetry.prometheus_text()]
            for uid, row in sorted(per.items()):
                text = (row.get("value") or {}).get("text", "")
                parts.append(f"# process uid={uid} "
                             f"pid={row.get('pid')}\n{text}")
            return {"format": fmt, "text": "\n".join(parts)}
        return {"format": fmt, "router": self.telemetry.snapshot(),
                "pid": os.getpid(),
                "incarnation": int(self.cfg.incarnation),
                "workers": {uid: row.get("value")
                            for uid, row in sorted(per.items())}}

    # -------------------------------------------------- rolling restart

    def inflight_on(self, uid: str) -> int:
        with self._lock:
            return sum(1 for r in self._routes.values()
                       if r.uid == uid and r.backend is not None
                       and not r.backend.done)

    def route_uid(self, rid: str) -> str:
        """The incarnation a live route is currently placed on (empty
        when undispatched or already terminal) — lets a chaos drill
        aim its kill at the process actually carrying a request."""
        with self._lock:
            r = self._routes.get(rid)
            return r.uid if r is not None else ""

    def _wait_state(self, slot: int, want: str, timeout: float,
                    min_gen: int = 0) -> bool:
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            with self._lock:
                sl = self._slots[slot]
                if sl.state == want and sl.gen >= min_gen:
                    return True
            time.sleep(0.02)
        return False

    def rolling_restart(self, kill: bool = False,
                        extra_env: Optional[dict] = None) -> List[dict]:
        """Drain → fence → respawn → re-admit, one slot at a time —
        the fleet never loses more than one cell of capacity. With
        ``kill=True`` the stop is a SIGKILL (the chaos drill: proves
        the drain→fence path needs no cooperation from the dying
        process); otherwise a clean ``die`` control. The fence is
        written by `_spawn_locked` before every respawn; re-admit is
        the successor's READY. Returns one row per slot with the
        measured detection/restart timings."""
        rows = []
        for slot in sorted(self._slots):
            with self._lock:
                sl = self._slots[slot]
                if sl.state == RETIRED:
                    continue
                old_uid, old_pid = sl.uid, sl.pid
            t0 = time.monotonic()
            self.drain_slot(slot)
            t_drain = time.monotonic()
            drained = True
            while self.inflight_on(old_uid) > 0:
                if time.monotonic() - t_drain > self.cfg.drain_timeout_s:
                    drained = False
                    break
                time.sleep(0.02)
            n_deaths = len(self.deaths)
            t_kill = time.monotonic()
            self.stop_slot(slot, kill=kill)
            # detection: the supervision loop notices (conn death /
            # exit) and declares — measured, not assumed
            detect_s = None
            t_end = time.monotonic() + self.cfg.lease_s + 10.0
            while time.monotonic() < t_end:
                if len(self.deaths) > n_deaths:
                    detect_s = self.deaths[-1]["t_dead_mono"] - t_kill
                    break
                time.sleep(0.005)
            self.ensure_spawned(slot, extra_env=extra_env)
            up = self._wait_state(slot, UP, self.cfg.spawn_timeout_s,
                                  min_gen=int(old_uid.split(".")[1]) + 1)
            with self._lock:
                sl = self._slots[slot]
                new_uid, new_pid = sl.uid, sl.pid
            rows.append({
                "slot": slot, "old_uid": old_uid, "new_uid": new_uid,
                "old_pid": old_pid, "new_pid": new_pid,
                "killed": bool(kill), "drained": drained,
                "detect_s": detect_s, "readmitted": bool(up),
                "restart_s": time.monotonic() - t0})
            self.log.info("rolling restart slot %d: %s -> %s "
                          "(detect %.3fs, total %.1fs)", slot, old_uid,
                          new_uid, detect_s or -1.0,
                          rows[-1]["restart_s"])
        return rows

    def kill_slot(self, slot: int, wait_up: bool = True,
                  timeout: Optional[float] = None) -> dict:
        """SIGKILL a worker process mid-flight (NO drain — the hard
        failover drill) and measure kill→declared-dead detection
        latency plus the in-flight routes migrated. Auto-respawn
        brings the slot back; with ``wait_up`` blocks until the
        successor is re-admitted."""
        with self._lock:
            sl = self._slots[slot]
            old_uid, old_pid = sl.uid, sl.pid
        n_deaths = len(self.deaths)
        n_failovers = self.telemetry.counter(
            "router_failovers_total").value
        t_kill = time.monotonic()
        self.stop_slot(slot, kill=True)
        detect_s = None
        death = None
        t_end = time.monotonic() + self.cfg.lease_s + 10.0
        while time.monotonic() < t_end:
            if len(self.deaths) > n_deaths:
                death = self.deaths[-1]
                detect_s = death["t_dead_mono"] - t_kill
                break
            time.sleep(0.002)
        up = True
        if wait_up:
            up = self._wait_state(
                slot, UP, timeout or self.cfg.spawn_timeout_s,
                min_gen=int(old_uid.split(".")[1]) + 1)
        with self._lock:
            sl = self._slots[slot]
            new_uid, new_pid = sl.uid, sl.pid
        # migrated: the failover-counter DELTA, not death["requeued"]
        # alone — when the data-plane client notices the dead socket
        # before _declare_dead runs, it resolves the backend tickets
        # with wire_error and the PUMP's worker-loss path does the
        # requeue (death["requeued"] reads 0 for a real migration).
        # Both paths increment router_failovers_total.
        migrated = int(self.telemetry.counter(
            "router_failovers_total").value - n_failovers)
        return {"slot": slot, "old_uid": old_uid, "old_pid": old_pid,
                "new_uid": new_uid, "new_pid": new_pid,
                "detect_s": detect_s,
                "migrated": max(migrated,
                                death["requeued"] if death else 0),
                "readmitted": bool(up)}

    # ------------------------------------------------------- inspection

    def fleet(self) -> List[dict]:
        with self._lock:
            return [{"slot": sl.slot, "uid": sl.uid, "state": sl.state,
                     "pid": sl.pid, "wire_port": sl.wire_port,
                     "deaths": sl.deaths, "stats": dict(sl.stats)}
                    for sl in self._slots.values()]

    def journal_dirs(self) -> List[Path]:
        """Every per-slot journal dir — the postmortem's input set
        (`telemetry.postmortem.fleet_reconstruct`)."""
        return [self._journal_dir(s) for s in sorted(self._slots)]

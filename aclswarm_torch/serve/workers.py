"""Supervised multi-worker execution for the serving layer (port of
`aclswarm_tpu/serve/workers.py`).

A `WorkerPool` runs N supervised worker threads and treats a worker's
death as a routine event:

- **placement**: admission shards shape buckets across workers with
  rendezvous hashing — each bucket deterministically owns one alive
  worker, and when the alive set churns only the buckets placed on the
  dead worker re-match (`place_slot`);
- **heartbeat + lease**: every worker stamps a heartbeat each loop
  iteration; the supervisor declares a worker dead when its thread exits
  or its lease lapses (a wedged thread), fences it so a zombie can never
  touch migrated jobs (per-job epoch counters make stale writes no-ops),
  and requeues its in-flight work;
- **checkpoint-backed migration**: an orphaned rollout is serialized
  through the checkpoint codec (disk when journaled, memory otherwise)
  and restored template-validated on another worker, bit for bit;
- **poison bound**: a request that keeps killing the workers it runs on
  alone terminates with a structured ``poisoned`` error after
  ``max_worker_exclusions`` such kills;
- **circuit breaker + backoff-gated rejoin**: a dead slot respawns after
  a `RetryPolicy` backoff that grows with consecutive deaths; past
  ``max_worker_restarts`` the slot retires. While capacity is degraded
  the admission retry-after hint scales by total/alive.

One card: every worker gets the service's device, and all of them launch
on its one default stream, as the reference's workers share the default
device on a single-device host. Their rounds interleave on that stream in
issue order; K1's and K2's cooperative grids never run two at once.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import TYPE_CHECKING, List, Optional, Tuple

from aclswarm_torch.resilience import InjectedCrash
from aclswarm_torch.utils.locks import OrderedLock
from aclswarm_torch.utils.retry import RetryPolicy, delay_for

if TYPE_CHECKING:                                   # pragma: no cover
    from aclswarm_torch.serve.service import SwarmService

# worker-targeted crash sites: `serve.w{slot}` consulted with the
# SLOT's cumulative round count (stable across respawns, so one drill
# can script repeated kills of the same slot); the process-level
# `serve` site counts the service's global rounds (service.py)
WORKER_SITE = "serve.w{slot}"

# worker lifecycle states
UP = "up"
COOLDOWN = "cooldown"      # dead; rejoin gated by the backoff policy
RETIRED = "retired"        # circuit open: max_worker_restarts exceeded
EXITED = "exited"          # clean exit (stop/drain) — NOT a death


@dataclasses.dataclass
class Worker:
    """One supervised worker slot. ``uid`` names the INCARNATION
    (slot.generation): exclusion sets hold uids, so a respawned slot is
    a fresh candidate while placement stays keyed on the stable slot."""

    slot: int
    gen: int = 0
    thread: Optional[threading.Thread] = None
    state: str = COOLDOWN
    last_beat: float = 0.0
    round: int = 0              # cumulative across incarnations
    fails: int = 0              # CONSECUTIVE deaths (backoff input);
    #                             reset by a completed round, so an
    #                             always-on fleet absorbing occasional
    #                             isolated deaths never retires a slot
    rejoin_at: float = 0.0
    fenced: bool = False        # lease-lapsed zombie: must not touch jobs
    inflight: List[Tuple[object, int]] = dataclasses.field(
        default_factory=list)   # [(job, epoch-at-pick)] — with the
    #                             pipeline, BOTH the dispatched-pending
    #                             round's pairs and the newly picked ones
    staging: dict = dataclasses.field(default_factory=dict)
    #                           # bucket -> serve.staging.BucketStaging:
    #                             this INCARNATION's resident batches
    #                             (reset on respawn; a dead worker's
    #                             stranded rows are read out by the new
    #                             owner under the service lock)

    @property
    def uid(self) -> str:
        return f"{self.slot}.{self.gen}"


def place_slot(bucket, candidates: List[int],
               key: Optional[bytes] = None) -> Optional[int]:
    """Rendezvous (highest-random-weight) hash of a shape bucket onto
    the candidate worker slots: every caller agrees on the owner
    without coordination, and removing one slot re-matches ONLY the
    buckets it owned — the minimal re-matching under churn that makes
    worker death cheap. Deterministic (crc32, no `random`).
    ``key`` is the precomputed ``repr(bucket).encode()`` — the hot
    eligibility path caches it per job (buckets are immutable) so
    queue scans don't re-encode on every poll.

    Candidates may be ints (thread slots) or strings (the process
    fleet's ``slot.gen`` uids — hashing over the INCARNATION set is
    what makes a respawn re-place only the dead incarnation's
    buckets); ties break to the smallest candidate either way."""
    if not candidates:
        return None
    if key is None:
        key = repr(bucket).encode()
    return min(candidates,
               key=lambda s: (-zlib.crc32(key + f":{s}".encode()), s))


class WorkerPool:
    """N supervised worker threads + one supervisor thread.

    The pool owns worker LIFECYCLE (spawn, heartbeat, lease, declare-
    dead, failover, backoff-gated rejoin); the service keeps ownership
    of request state (rounds, finish, journal). The split keeps lock
    ordering simple: admission's queue lock may nest the pool lock
    (``on_take``), the pool lock never nests admission's."""

    def __init__(self, service: "SwarmService", cfg):
        self.svc = service
        self.cfg = cfg
        self.log = service.log
        self._lock = OrderedLock("serve.pool",
                                 registry=service.telemetry)
        self._slots = [Worker(slot=i) for i in range(max(1, cfg.workers))]
        self._supervisor: Optional[threading.Thread] = None
        self._started = False
        self._rejoin_policy = RetryPolicy(
            attempts=max(1, cfg.max_worker_restarts + 1),
            base_s=cfg.rejoin_base_s, max_s=cfg.rejoin_max_s)
        # immutable snapshot of alive workers, rebuilt under the pool
        # lock and read LOCK-FREE by eligibility predicates (which run
        # under admission's queue lock — taking the pool lock there
        # would invert the lock order)
        self._alive_view: Tuple[Worker, ...] = ()
        service.telemetry.gauge("serve_workers_total").set(
            len(self._slots))

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Spawn every worker slot + the supervisor (idempotent)."""
        with self._lock:
            if self._started:
                return
            self._started = True
        for w in self._slots:
            self._spawn(w)
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True, name="swarmserve-sup")
        self._supervisor.start()

    def _spawn(self, w: Worker) -> None:
        with self._lock:
            w.gen += 1
            w.state = UP
            w.fenced = False
            w.last_beat = time.monotonic()
            w.inflight = []
            w.staging = {}
            t = threading.Thread(target=self._run_worker, args=(w,),
                                 daemon=True,
                                 name=f"swarmserve-w{w.slot}.{w.gen}")
            w.thread = t
            self._rebuild_alive_view()
        self.svc.telemetry.gauge(
            "serve_worker_up", labels={"worker": str(w.slot)}).set(1)
        self._publish_capacity()
        t.start()

    def _rebuild_alive_view(self) -> None:
        self._alive_view = tuple(w for w in self._slots if w.state == UP)

    def _publish_capacity(self) -> None:
        alive = sum(1 for w in self._slots if w.state == UP)
        self.svc._adm.set_capacity(alive, len(self._slots))
        self.svc.telemetry.gauge("serve_workers_up").set(alive)

    @property
    def started(self) -> bool:
        return self._started

    def any_alive(self) -> bool:
        """True while anything can still make progress: a live worker
        thread, or the supervisor (which can respawn one)."""
        if any(w.thread is not None and w.thread.is_alive()
               for w in self._slots):
            return True
        return (self._supervisor is not None
                and self._supervisor.is_alive())

    def inflight_total(self) -> int:
        with self._lock:
            return sum(len(w.inflight) for w in self._slots)

    def join(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        threads = [w.thread for w in self._slots if w.thread is not None]
        threads += [self._supervisor] if self._supervisor else []
        for t in threads:
            # a slot respawned this instant has its thread registered
            # before it starts (`_spawn`), and joining an unstarted thread
            # raises: it has done no work yet, so there is nothing to wait
            if t.ident is not None:
                t.join(max(0.0, deadline - time.monotonic()))

    # --------------------------------------------------------- scheduling

    def eligible(self, job, w: Worker) -> bool:
        """Is ``job`` placed on worker ``w``? Runs under admission's
        queue lock — reads the published alive view only, never the
        pool lock. A job's excluded incarnations (workers it already
        died on) are skipped; the rendezvous hash over the remaining
        alive slots names exactly one owner."""
        view = self._alive_view
        if w.fenced or w.state != UP:
            return False
        cands = [x.slot for x in view
                 if x.uid not in job.excluded_workers]
        key = job.__dict__.get("_place_key")
        if key is None:
            key = job.__dict__["_place_key"] = repr(job.bucket).encode()
        return place_slot(job.bucket, cands, key=key) == w.slot

    # -------------------------------------------------------- worker loop

    def _mark_exited(self, w: Worker, my_gen: int) -> None:
        """Record a CLEAN exit (stop/drain): the supervisor must not
        mistake it for a death and fail over nothing."""
        with self._lock:
            if w.gen == my_gen and w.state == UP:
                w.state = EXITED
                self._rebuild_alive_view()
        self._publish_capacity()

    def _drop_inflight(self, w: Worker, my_gen: int, pairs: list) -> None:
        """Unregister one round's pairs (identity-matched: `_Job` is a
        dataclass whose field-wise __eq__ must never run on tensors)."""
        with self._lock:
            if w.gen == my_gen:
                done = {id(j) for j, _ in pairs}
                w.inflight = [p for p in w.inflight
                              if id(p[0]) not in done]

    def _run_worker(self, w: Worker) -> None:
        """The double-buffered worker loop: each iteration PICKS and
        STARTS round k+1 (pack + async dispatch — the device begins
        immediately), THEN FINISHES
        round k (the one blocking host read + resolve). The host's
        pack/unpack/resolve work for one round overlaps the device's
        compute for the next; a round whose bucket or config cannot
        pipeline (single-shot kinds, ``staging=False``) completes
        inside `_round_start` and leaves no pending half."""
        from aclswarm_torch.serve.service import _Fenced

        svc = self.svc
        my_gen = w.gen
        pending = None              # the dispatched-unresolved round

        def _abandon(pend):
            """A round dropped between start and finish (scripted
            kill, fence, zombie exit) still owes its parent
            `serve.round` span — its child pack/stack/dispatch spans
            already recorded, and a missing parent would make child
            sums exceed the round sum (read as mis-nesting by the
            breakdown validator) for a cause that is span loss."""
            if pend is not None:
                svc._emit_round_span(pend.start_dur, pend.span_attrs,
                                     error=True)

        while not svc._stop.is_set():
            w.last_beat = time.monotonic()
            if w.fenced or w.gen != my_gen:
                _abandon(pending)
                return              # zombie: the supervisor replaced us
                #                     (pending work was failed over at
                #                     declare-dead with the in-flight
                #                     set — nothing to hand back)

            taken: dict = {}

            def _take(jobs, w=w, my_gen=my_gen, taken=taken):
                # runs under admission's queue lock: the dequeue, the
                # epoch capture, and the in-flight registration are ONE
                # atomic step. The picked batch is returned through
                # `taken`, never re-read from the shared slot record —
                # a replacement incarnation's in-flight list must be
                # invisible to this thread. APPEND, don't replace: the
                # pending round's pairs are still in flight.
                with self._lock:
                    pairs = [(j, j.epoch) for j in jobs]
                    taken["pairs"] = pairs
                    if w.gen == my_gen and not w.fenced:
                        w.inflight = w.inflight + pairs
                        for j in jobs:
                            j.worker = w.slot
                            j.pick_batch = len(jobs)
                    else:
                        taken["stale"] = True

            # with a round pending, poll instead of parking: the next
            # pick either overlaps the device or we go finish the round
            jobs = svc._adm.pick(self.cfg.max_batch,
                                 timeout=(0.0 if pending is not None
                                          else self.cfg.idle_poll_s),
                                 eligible=lambda j: self.eligible(j, w),
                                 on_take=_take)
            if not jobs and pending is None:
                if (svc._draining.is_set() and svc._adm.empty()
                        and self.inflight_total() == 0):
                    self._mark_exited(w, my_gen)
                    return          # all tenants idle: clean exit
                continue
            pairs = taken.get("pairs", [])
            if taken.get("stale"):
                # the slot was replaced between the loop-top gen check
                # and the pick: this thread is a zombie, but it just
                # dequeued real jobs that are registered NOWHERE — hand
                # them straight back so the live fleet runs them
                svc._requeue_unowned(pairs)
                _abandon(pending)
                return
            def _finish_now(pend, busy, w=w, my_gen=my_gen):
                """Resolve one pending round; True = this thread must
                die (scripted kill / fenced)."""
                try:
                    svc._round_finish(pend, w, busy=busy)
                except InjectedCrash as e:
                    self.log.warning(
                        "serve worker %s dying as scripted: %s",
                        w.uid, e)
                    svc._emit_round_span(pend.start_dur,
                                         pend.span_attrs, error=True)
                    return True
                except _Fenced:
                    svc._emit_round_span(pend.start_dur,
                                         pend.span_attrs, error=True)
                    return True
                except Exception as e:      # noqa: BLE001 — recorded
                    svc._fail_round(pend.pairs, e)
                self._drop_inflight(w, my_gen, pend.pairs)
                return False

            # quarantine isolation: a SUSPECT's solo round must never
            # overlap another round — a kill during its residency has
            # to implicate exactly that batch (the poison bound's
            # blame unit). With overlap allowed, every death would
            # leave two rounds' orphans and a max_batch=1 fleet under
            # load could never attribute a solo kill unambiguously —
            # the poison request would ping-pong workers into the
            # circuit breaker instead of terminating `poisoned`.
            if jobs and pending is not None and (
                    any(getattr(j, "suspect", False) for j in jobs)
                    or any(getattr(j, "suspect", False)
                           for j in pending.jobs)):
                if _finish_now(pending, 0):
                    return
                pending = None
            new_pending = None
            if jobs:
                w.round += 1
                try:
                    new_pending = svc._round_start(
                        pairs, w,
                        busy_ids=(frozenset(id(j) for j in pending.jobs)
                                  if pending is not None
                                  else frozenset()))
                except InjectedCrash as e:
                    # the scripted worker kill: die ABRUPTLY, in-flight
                    # work still registered — exactly what a SIGKILLed
                    # worker process leaves behind. The supervisor
                    # detects the dead thread and fails the work (BOTH
                    # rounds' — pending included) over to a survivor.
                    self.log.warning(
                        "serve worker %s dying as scripted: %s", w.uid, e)
                    _abandon(pending)
                    return
                except _Fenced:
                    _abandon(pending)
                    return          # fenced mid-round: jobs failed over
                except Exception as e:      # noqa: BLE001 — recorded
                    svc._fail_round(pairs, e)
                    self._drop_inflight(w, my_gen, pairs)
                if new_pending is None:
                    # round completed inside _round_start (single-shot,
                    # legacy path, pipeline off, or fully gated out)
                    self._drop_inflight(w, my_gen, pairs)
            if pending is not None:
                if _finish_now(pending,
                               len(new_pending.jobs) if new_pending
                               else 0):
                    return
            pending = new_pending
            # a COMPLETED round closes the breaker window: `fails`
            # counts consecutive deaths, not lifetime deaths — an
            # always-on fleet absorbing an isolated death every few
            # hours must never creep toward permanent retirement
            if w.gen == my_gen and not w.fenced:
                w.fails = 0
        _abandon(pending)                   # stop flag: close() sweep
        #                                     resolves the jobs; the
        #                                     round still logs its span
        self._mark_exited(w, my_gen)        # stop flag: clean exit

    # ---------------------------------------------------------- failover

    def _supervise(self) -> None:
        """Heartbeat/lease monitor + backoff-gated respawner. Exits when
        the service stops, or when every slot has retired (circuit open
        fleet-wide — pending journal frames await recovery by a new
        process), or when a drain has fully completed."""
        svc = self.svc
        cfg = self.cfg
        while not svc._stop.is_set():
            time.sleep(cfg.supervise_poll_s)
            now = time.monotonic()
            for w in self._slots:
                if w.state == UP:
                    if w.thread is not None and not w.thread.is_alive():
                        self._declare_dead(w, "worker thread died")
                    elif now - w.last_beat > cfg.lease_s:
                        w.fenced = True   # zombie fence BEFORE requeue
                        self._declare_dead(
                            w, f"heartbeat lease ({cfg.lease_s:g} s) "
                               "missed — worker wedged")
                elif w.state == COOLDOWN and now >= w.rejoin_at:
                    if svc._draining.is_set() and svc._adm.empty() \
                            and self.inflight_total() == 0:
                        continue    # nothing left to rejoin for
                    self.log.warning(
                        "serve worker slot %d rejoining after backoff "
                        "(%d consecutive death(s))", w.slot, w.fails)
                    self._spawn(w)
            states = {w.state for w in self._slots}
            if not states & {UP, COOLDOWN}:
                # nothing left to monitor or respawn
                if RETIRED in states:
                    self.log.error(
                        "serve worker fleet circuit-open: every "
                        "non-exited slot exceeded max_worker_restarts="
                        "%d — pending requests stay journaled for "
                        "recovery by a new process",
                        cfg.max_worker_restarts)
                return
            if svc._draining.is_set() and svc._adm.empty() \
                    and self.inflight_total() == 0 \
                    and not any(w.thread is not None
                                and w.thread.is_alive()
                                for w in self._slots):
                return              # drain complete

    def _declare_dead(self, w: Worker, reason: str) -> None:
        """Declare one worker dead and make its loss routine: requeue
        every in-flight job to the surviving workers (through the
        checkpoint codec), open this slot's breaker, and re-derive the
        backpressure hint from what is left."""
        svc = self.svc
        with self._lock:
            w.fails += 1
            uid = w.uid
            retire = w.fails > self.cfg.max_worker_restarts
            w.state = RETIRED if retire else COOLDOWN
            if not retire:
                w.rejoin_at = time.monotonic() + delay_for(
                    self._rejoin_policy, min(w.fails - 1,
                                             self._rejoin_policy.attempts
                                             - 1))
            orphans, w.inflight = w.inflight, []
            self._rebuild_alive_view()
        svc.telemetry.gauge(
            "serve_worker_up", labels={"worker": str(w.slot)}).set(0)
        svc.telemetry.counter("serve_failover_total").inc()
        with svc._lock:
            svc.stats["failovers"] += 1
        self._publish_capacity()
        (self.log.error if retire else self.log.warning)(
            "serve worker %s declared dead (%s): %d in-flight job(s) "
            "to fail over; slot %s", uid, reason, len(orphans),
            "RETIRED (circuit open)" if retire
            else f"rejoins in {max(0.0, w.rejoin_at - time.monotonic()):.2f} s")
        svc._journal_event("failover", worker=uid, reason=reason,
                           orphans=len(orphans), retired=retire)
        # the dead worker cannot flush its own span ring (a SIGKILLed
        # or wedged thread leaves no atexit); the supervisor flushes on
        # its behalf so the spans LEADING UP to the death survive to
        # the journal
        svc._flush_spans(f"worker {uid} declared dead: {reason}")
        # solo attribution for the poison bound, pipeline-aware: a kill
        # implicates a job only if it was ALONE in its own picked batch
        # AND it is the only such solo orphan (with the pipeline a dead
        # worker usually leaves TWO rounds' orphans — an orphan-set
        # "len == 1" test would let a poison request hide behind the
        # overlapping round's jobs forever, while blaming EVERY solo
        # orphan would let a poison kill implicate an innocent suspect
        # running its quarantine round in the overlapping slot; two
        # solos at once is ambiguous, and ambiguity quarantines but
        # never counts — the next unambiguous kill does).
        solos = [job for job, _ in orphans if job.pick_batch == 1]
        for job, epoch in orphans:
            svc._failover_job(job, epoch, uid,
                              solo=(job.pick_batch == 1
                                    and len(solos) == 1))

"""Admission control and tenant-fair scheduling (a copy of
`aclswarm_tpu/serve/admission.py`).

Two jobs, one lock:

- **Admission**: per-tenant and global queue caps, enforced at `submit`
  with an explicit `RejectedError` carrying a drain-rate-based
  ``retry_after_s`` hint. A request the service cannot promise to run is
  refused at the door, never parked on an unbounded queue.
- **Fair pick**: the worker asks for the next batch of same-bucket jobs
  and gets them round-robin across tenants — the tenant cursor advances
  every pick, and batch slots are dealt one per tenant per cycle, so a
  tenant flooding its (bounded) queue can delay another tenant by at
  most one batch residency, never starve it. Within a tenant, FIFO.

A *bucket* is the shape-compatibility key (`service._Job.bucket`):
requests in one device batch must share it. The picker chooses the
bucket of the first eligible job at the cursor, then fills the remaining
slots with same-bucket work from all tenants.

`pick` takes an ``eligible`` predicate (each worker sees only the buckets
placed on it) and an ``on_take`` callback run under the queue lock before
the batch is released (the worker registers its in-flight set atomically
with the dequeue). `set_capacity` re-derives the retry-after hint from
the surviving workers. Re-queueing (preempted or next-chunk jobs)
bypasses the caps: those requests were already accepted.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from aclswarm_torch.serve.api import E_QUEUE_FULL, RejectedError


class AdmissionControl:
    """Bounded per-tenant FIFO queues with a round-robin batch picker.

    Thread-safety: every public method takes the one internal condition
    lock; `pick` blocks on it (bounded by ``timeout``) so the worker
    parks without spinning while the service is idle."""

    def __init__(self, max_per_tenant: int = 8, max_total: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.max_per_tenant = int(max_per_tenant)
        self.max_total = int(max_total)
        self._cv = threading.Condition()
        self._queues: dict[str, list] = {}   # tenant -> FIFO of jobs
        self._order: list[str] = []          # tenant round-robin ring
        self._cursor = 0
        self._clock = clock
        # EWMA of per-request service time feeds the retry-after hint;
        # seeded pessimistically so an empty history still backs off
        self._ewma_s = 0.25
        # surviving-capacity scale on the hint: total workers / alive
        # workers (1.0 single-worker; grows as workers die, capped in
        # retry_after; set by the worker-pool supervisor)
        self._capacity_scale = 1.0

    # ------------------------------------------------------------- intake

    def admit(self, job, force: bool = False, hold: bool = False) -> None:
        """Enqueue an incoming job, enforcing the caps. ``force``
        bypasses them — recovery re-admission and preemption re-queues
        of ALREADY-accepted work must never bounce. ``hold`` enqueues
        the job *invisibly to the picker*: the slot counts toward the
        caps (so racing submits cannot oversubscribe) but the worker
        cannot start it until `release` — the submit-side ordering
        gate: caps are checked BEFORE the durable journal frame is
        written, the frame is durable AND the request's batch-layout
        row is prepped (`serve.staging` submit-time prep — every
        submit holds) before the worker can run the job."""
        with self._cv:
            q = self._queues.setdefault(job.req.tenant, [])
            if job.req.tenant not in self._order:
                self._order.append(job.req.tenant)
            if not force:
                total = sum(len(x) for x in self._queues.values())
                if len(q) >= self.max_per_tenant:
                    raise RejectedError(
                        f"{E_QUEUE_FULL}: tenant {job.req.tenant!r} at "
                        f"its {self.max_per_tenant}-request cap",
                        self.retry_after())
                if total >= self.max_total:
                    raise RejectedError(
                        f"{E_QUEUE_FULL}: service at its "
                        f"{self.max_total}-request global cap",
                        self.retry_after())
            job.held = hold
            q.append(job)
            if not hold:
                self._cv.notify_all()

    def release(self, job) -> None:
        """Make a held job visible to the picker (its journal frame is
        durable and its staging row is prepped — the acceptance
        promise exists on disk, and round-time pack owes this request
        only an index shuffle)."""
        with self._cv:
            job.held = False
            self._cv.notify_all()

    def cancel(self, job) -> bool:
        """Back out an enqueued-but-unpicked job (a failed submit, or a
        wire client dying with entries still queued): frees its caps
        slot. Returns True iff the job was queued here — False means it
        is resident in a worker batch (or already terminal) and must be
        cancelled at a chunk boundary instead, never mid-batch."""
        with self._cv:
            q = self._queues.get(job.req.tenant, [])
            if job in q:
                q.remove(job)
                return True
            return False

    def requeue(self, job) -> None:
        """Tail re-queue of an accepted job (next chunk / preempted)."""
        self.admit(job, force=True)

    def contains(self, job) -> bool:
        """Is this exact job object currently queued? The failover
        supervisor's idempotence check: a job a fenced worker already
        requeued at its boundary is SAFE — failing it over again would
        double-enqueue it (two copies in one batch, chunks executed
        twice, digest ruined)."""
        with self._cv:
            return any(job in q for q in self._queues.values())

    # ------------------------------------------------------------ picking

    def pick(self, max_jobs: int, timeout: float,
             eligible: Optional[Callable] = None,
             on_take: Optional[Callable] = None) -> List:
        """Dequeue up to ``max_jobs`` same-bucket jobs, tenant-fair.
        Blocks up to ``timeout`` for work; [] = still idle.

        ``eligible(job)`` restricts the view (worker-sharded picking:
        each worker sees only the buckets placed on it). ``on_take`` is
        called with the picked batch WHILE the queue lock is held — the
        atomic queued→in-flight handoff the failover supervisor relies
        on (a job is always either queued or registered in-flight,
        never invisible in between)."""
        ok = eligible if eligible is not None else (lambda j: True)
        deadline = self._clock() + timeout
        with self._cv:
            while True:
                lead = self._lead_job(ok)
                if lead is not None:
                    break
                remaining = deadline - self._clock()
                if remaining <= 0 or not self._cv.wait(remaining):
                    lead = self._lead_job(ok)
                    if lead is None:
                        return []
                    break
            tenant, job0 = lead
            bucket = job0.bucket
            take = [job0]
            self._queues[tenant].remove(job0)
            # suspect quarantine (serve.workers): a job
            # that was in-flight at a worker death runs ALONE until a
            # surviving chunk exonerates it — if the next kill comes,
            # the solo batch implicates exactly one request (and orphans
            # no innocents); conversely an innocent batch-mate of a
            # scripted/co-incidental kill completes its solo round and
            # never rides to the poison bound
            suspect0 = bool(getattr(job0, "suspect", False))
            # deal remaining slots one-per-tenant-per-cycle, starting
            # after the lead tenant; fall back to greedy same-bucket
            # fill once a full cycle adds nothing
            ring = self._order
            start = (ring.index(tenant) + 1) % len(ring)
            progress = not suspect0
            while len(take) < max_jobs and progress:
                progress = False
                for k in range(len(ring)):
                    if len(take) >= max_jobs:
                        break
                    t = ring[(start + k) % len(ring)]
                    j = next((x for x in self._queues.get(t, [])
                              if x.bucket == bucket and not x.held
                              and not getattr(x, "suspect", False)
                              and ok(x)), None)
                    if j is not None:
                        self._queues[t].remove(j)
                        take.append(j)
                        progress = True
            # advance the cursor PAST the lead tenant: the next pick
            # starts from its neighbor (the fairness rotation)
            self._cursor = start
            if on_take is not None:
                on_take(take)
            return take

    def _lead_job(self, ok: Callable):
        """(tenant, job) at the round-robin cursor, else None. Held
        jobs (mid-submit, journal frame not yet durable) and jobs the
        caller's ``ok`` predicate excludes (placed on another worker)
        are invisible."""
        ring = self._order
        for k in range(len(ring)):
            t = ring[(self._cursor + k) % len(ring)]
            j = next((x for x in self._queues.get(t, [])
                      if not x.held and ok(x)), None)
            if j is not None:
                return t, j
        return None

    # ---------------------------------------------------------- telemetry

    def pending(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def pending_excluding(self, job) -> int:
        """Queued work besides ``job``'s own next-chunk re-queue — the
        preemption trigger (evicting with nobody waiting is pure tax)."""
        with self._cv:
            return sum(1 for q in self._queues.values() for x in q
                       if x is not job)

    def empty(self) -> bool:
        return self.pending() == 0

    def note_service(self, dt_s: float) -> None:
        """Fold one request's service time into the drain-rate EWMA."""
        with self._cv:
            self._ewma_s = 0.8 * self._ewma_s + 0.2 * max(0.0, dt_s)

    def set_capacity(self, alive: int, total: int) -> None:
        """Re-derive the drain-rate hint from SURVIVING capacity
        (graceful degradation to fewer workers): the EWMA measured
        per-request service time against the then-alive worker set, so
        with ``alive`` of ``total`` workers up the same backlog drains
        ``total/alive`` times slower. ``alive=0`` pins the scale to the
        hint's ceiling — the honest answer while the circuit-broken
        fleet backs off toward rejoin."""
        with self._cv:
            if alive <= 0:
                self._capacity_scale = float("inf")
            else:
                self._capacity_scale = max(1.0, total / alive)

    def retry_after(self) -> float:
        """Backpressure hint: estimated time for the current backlog to
        drain (EWMA service time x pending, scaled by the surviving-
        capacity factor), clamped to [0.05, 30] s."""
        backlog = sum(len(q) for q in self._queues.values())
        est = self._ewma_s * max(1, backlog) * self._capacity_scale
        return float(min(30.0, max(0.05, est)))

    def wake(self) -> None:
        """Nudge a parked `pick` (shutdown/drain transitions)."""
        with self._cv:
            self._cv.notify_all()

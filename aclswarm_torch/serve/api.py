"""The serving layer's request and response surface (a copy of
`aclswarm_tpu/serve/api.py`; the reference documents it in
docs/SERVICE.md).

Everything a client touches lives here: the request record, the status
and error vocabulary, the streaming `Ticket` handle, and the terminal
`Result`. The contract the whole layer is built around:

    **every ACCEPTED request terminates with a `Result` carrying either
    a value or a structured `ServeError` — never a silent loss, never a
    hang.**

A `submit` that raises `RejectedError` was refused (bounded queue,
shutdown): the client holds the backpressure hint (``retry_after_s``) and
nothing was promised. A `submit` that returns a `Ticket` was accepted:
from that moment the service owes a terminal result, across preemption,
a killed worker and deadline expiry.

Request ``params`` must be checkpoint-codec-serializable (dicts, lists,
scalars, numpy arrays — `resilience.checkpoint`): an accepted request is
journaled before `submit` returns.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Iterator, Optional

# -- request lifecycle states ------------------------------------------------
QUEUED = "queued"          # accepted, waiting for a batch slot
RUNNING = "running"        # resident in the device batch
PREEMPTED = "preempted"    # evicted to checkpoint; will be rescheduled
COMPLETED = "completed"    # terminal: value delivered
FAILED = "failed"          # terminal: structured execution error
TIMED_OUT = "timed_out"    # terminal: deadline enforced at a boundary
TERMINAL = (COMPLETED, FAILED, TIMED_OUT)

# -- structured error codes (the failure-semantics table) --------------------
E_DEADLINE = "deadline_exceeded"   # deadline passed at a chunk boundary
E_EXECUTION = "execution_failed"   # retries exhausted, or a bug
E_SHUTDOWN = "service_shutdown"    # non-drain close with work still queued
E_QUEUE_FULL = "queue_full"        # RejectedError.reason (never a Result)
E_POISONED = "poisoned"            # request killed K distinct workers —
#                                    excluded everywhere, terminated
#                                    instead of ping-ponging the fleet
E_CANCELLED = "cancelled"          # cancelled before/at a boundary (wire
#                                    client death cancels its queue
#                                    entries — never the running batch)
# client-side codes (`serve.client` — never journaled; the service
# still owes the result when these are reported):
E_CLIENT_TIMEOUT = "client_timeout"   # the CLIENT stopped waiting
E_WORKER_DIED = "worker_died"         # worker dead with the ticket open


class RejectedError(RuntimeError):
    """Admission refused this submit — the bounded-queue backpressure
    signal. The request was NOT accepted (nothing journaled, nothing
    owed); ``retry_after_s`` is the service's drain estimate."""

    def __init__(self, reason: str, retry_after_s: float):
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        super().__init__(f"request rejected ({reason}); retry after "
                         f"~{self.retry_after_s:.2f} s")


@dataclasses.dataclass
class ServeError:
    """The structured error a terminal `Result` carries instead of a
    value. ``code`` is one of the ``E_*`` constants; ``detail`` is
    free-form evidence (e.g. the `ExecutionFailure` rows of a failed
    stage) — codec-serializable so it survives the journal."""

    code: str
    message: str
    detail: Optional[dict] = None

    def to_row(self) -> dict:
        row: dict = {"code": self.code, "message": self.message}
        if self.detail is not None:
            row["detail"] = self.detail
        return row


@dataclasses.dataclass
class Request:
    """One unit of admitted work. ``deadline_s`` is relative to
    acceptance (``t_submit``, wall clock — it must survive a process
    restart, so no monotonic clocks here)."""

    kind: str                 # 'rollout' | 'assign' | 'gains' | 'stats'
    #                           | 'scenario' (a registry-drawn rollout —
    #                           batches WITH plain rollouts) | registered
    params: dict
    tenant: str = "default"
    request_id: str = ""
    deadline_s: Optional[float] = None
    t_submit: float = 0.0     # wall-clock acceptance time (service-set)
    trace_id: str = ""        # swarmtrace causal id: minted at submit
    #                           (wire client or direct API) and carried
    #                           through journal frames, checkpoint
    #                           manifests, and every lifecycle event

    @property
    def t_deadline(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.t_submit + self.deadline_s


@dataclasses.dataclass
class ChunkEvent:
    """One streamed progress record: the serve analogue of the trial
    drivers' per-chunk host sync. ``payload`` carries the chunk index,
    the end tick, and a running bit-exact digest of the positions."""

    request_id: str
    seq: int
    payload: dict


@dataclasses.dataclass
class Result:
    """The terminal record (also what the journal's done-frame stores).
    Exactly one of ``value`` / ``error`` is set, keyed by ``status``."""

    request_id: str
    status: str                      # COMPLETED | FAILED | TIMED_OUT
    value: Any = None
    error: Optional[ServeError] = None
    latency_s: float = 0.0           # accept -> terminal (wall clock)
    queued_s: float = 0.0            # accept -> first scheduled
    chunks: int = 0                  # device chunks executed
    preemptions: int = 0             # checkpoint-backed evictions survived
    resumed: bool = False            # continued from a journaled checkpoint
    failovers: int = 0               # worker-death migrations survived
    #                                  (checkpoint-backed, bit-identical)
    trace_id: str = ""               # the request's trace id — the key
    #                                  its journal events carry

    @property
    def ok(self) -> bool:
        return self.status == COMPLETED


_SENTINEL = object()


class Ticket:
    """Client handle for one accepted request: stream per-chunk events
    as they land, block for the terminal result. Thread-safe — the
    worker resolves it, any number of client threads may wait."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._events: queue.Queue = queue.Queue()
        self._result: Optional[Result] = None
        self._done = threading.Event()
        # guards the resolve once-check: test-and-commit must be one
        # atomic step or two racing resolvers (worker vs recovery vs
        # wire reader) can both pass the check and the LAST writer's
        # result overwrites the first after waiters saw it
        self._resolve_lock = threading.Lock()
        # True once the service has accepted the request. In-process
        # tickets exist only post-acceptance (submit raises otherwise);
        # the wire client flips it False until the accept frame lands,
        # so open-loop clients can tell accepted-and-running from
        # still-awaiting-a-verdict without blocking on the result.
        self.accepted = True

    # -- service side ------------------------------------------------------
    def _push(self, event: ChunkEvent) -> None:
        self._events.put(event)

    def _resolve(self, result: Result) -> None:
        """Terminal: publish the result and close the event stream.
        First resolution wins (idempotent — recovery paths may race):
        the once-check and the commit share `_resolve_lock`, so the
        loser of a race observes the winner's publication instead of
        overwriting it."""
        with self._resolve_lock:
            if self._done.is_set():
                return
            self._result = result
            self._done.set()
        self._events.put(_SENTINEL)

    # -- client side -------------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Result:
        """Block for the terminal `Result` (value OR structured error —
        a timeout here means the CLIENT gave up waiting, not that the
        service dropped the request)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not terminal within "
                f"{timeout} s (still owed by the service)")
        assert self._result is not None
        return self._result

    def stream(self, timeout: Optional[float] = None
               ) -> Iterator[ChunkEvent]:
        """Yield `ChunkEvent`s until the request resolves. ``timeout``
        bounds the wait per event: lapsing raises `TimeoutError` (not
        the queue module's internal exception). Events are consumed
        once, but the end-of-stream marker is sticky — a later
        `stream()` on a resolved ticket terminates instead of blocking
        forever."""
        while True:
            try:
                ev = self._events.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no chunk event for request {self.request_id} "
                    f"within {timeout} s") from None
            if ev is _SENTINEL:
                # re-arm the sentinel for any other/later stream()
                self._events.put(_SENTINEL)
                return
            yield ev

"""Order-checked, instrumented locks for the host-side fleet (the service,
worker pool, router, wire dispatcher and telemetry).

- **rank registry**: every lock belongs to a *family* (``"serve.
  service"``, ``"serve.pool"``, ...) with a numeric rank
  (`DEFAULT_RANKS`; `register_rank` for extensions). The protocol is
  "acquire in strictly increasing rank order"; a thread acquiring a
  lock whose rank is <= the highest rank it already holds is an
  inversion. The static analyzer (`analysis.concurrency`, JC102) checks
  that the program text cannot nest locks backwards; this layer checks
  that the running fleet does not.
- **held-set tracking**: per-thread held stacks plus a cross-thread
  table of every thread's held families, so a violation report shows
  the would-be deadlock peer, not just the offender.
- **cycle detection**: for unranked families, a global first-seen
  nesting graph (family -> family edges); an acquire that closes a
  cycle in that graph is the two-thread deadlock pattern even when no
  rank was declared.
- **histograms**: construction with ``registry=`` feeds
  ``lock_wait_s{name=<family>}`` (time blocked acquiring) and
  ``lock_hold_s{name=<family>}`` (time held) into that
  `MetricsRegistry`. The registry's own metric locks pass
  ``registry=None`` (a lock that observed its own hold time into a
  histogram guarded by itself would recurse).

Checking is gated by ``ACLSWARM_LOCK_DEBUG=1`` (env, read at import;
`arm()`/`disarm()` for tests), so the always-on fleet pays only the
instrumentation cost; the procworker children inherit the variable.

Violations raise a structured `LockOrderViolation` naming the lock,
its rank, the full held set, and a snapshot of every other thread's
held families. Pure stdlib: importing this module pulls in neither
torch nor telemetry.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

__all__ = ["LockOrderViolation", "OrderedLock", "OrderedRLock",
           "DEFAULT_RANKS", "register_rank", "rank_of", "arm", "disarm",
           "debug_armed", "held_families"]

# ---------------------------------------------------------------------------
# rank registry
#
# One family per lock *role*; every instance of a family shares the
# rank (the per-metric locks are hundreds of instances of one family).
# The protocol: a thread may acquire a lock only while every lock it
# holds has a STRICTLY SMALLER rank. Ranks are spaced so new tiers can
# land between existing ones without renumbering the fleet.

DEFAULT_RANKS: dict[str, int] = {
    "serve.router":     10,   # router front door (stateless tier)
    "serve.wire":       14,   # wire dispatcher connection table
    "serve.service":    20,   # THE service lock (jobs/stats/staging)
    "serve.admission":  30,   # admission queue condition
    "serve.pool":       40,   # worker-pool lifecycle lock
    "serve.traffic":    50,   # open-loop fleet ledgers
    "telemetry.lifecycle": 60,   # journal event appender
    "telemetry.watch":  70,   # timeseries store / SLO engine / sampler
    "telemetry.registry": 80,  # metric get-or-create table
    "telemetry.spans":  85,   # flight-recorder ring
    "telemetry.metric": 90,   # leaf per-metric locks (innermost)
}

_RANKS: dict[str, int] = dict(DEFAULT_RANKS)
_RANKS_GUARD = threading.Lock()


def register_rank(family: str, rank: int) -> None:
    """Register (or re-pin) a family's rank. Extensions slot between
    the defaults; re-registering an existing family to a DIFFERENT
    rank raises — two modules disagreeing about a family's rank is
    itself a protocol bug."""
    with _RANKS_GUARD:
        old = _RANKS.get(family)
        if old is not None and old != rank:
            raise ValueError(
                f"lock family {family!r} already ranked {old}; "
                f"re-registering as {rank} would fork the protocol")
        _RANKS[family] = rank


def rank_of(family: str) -> Optional[int]:
    return _RANKS.get(family)


# ---------------------------------------------------------------------------
# debug arming (ACLSWARM_LOCK_DEBUG=1)

def _env_armed() -> bool:
    return os.environ.get("ACLSWARM_LOCK_DEBUG", "") not in ("", "0")


_armed = _env_armed()


def arm() -> None:
    """Turn the order/cycle detector on (tests; ``ACLSWARM_LOCK_DEBUG=1``
    does it for a real run)."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def debug_armed() -> bool:
    return _armed


# ---------------------------------------------------------------------------
# held-set tracking
#
# Thread-local stack of currently-held OrderedLocks (the checker's
# input), mirrored into a cross-thread table keyed by thread id so a
# violation can report what every OTHER thread held at the instant of
# the inversion — the peer of the would-be deadlock. The mirror is
# guarded by a raw lock (never an OrderedLock: the tracker must not
# recurse into itself) and only maintained while armed.

_tls = threading.local()
_PEERS: dict[int, tuple[str, tuple[str, ...]]] = {}
_PEERS_GUARD = threading.Lock()

# first-seen nesting graph over families: edges[a] = set of families
# ever acquired while a was held. Used for cycle detection on
# unranked families (ranked ones are fully ordered already).
_EDGES: dict[str, set[str]] = {}
_EDGES_GUARD = threading.Lock()


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_families() -> tuple[str, ...]:
    """The calling thread's currently-held lock families, outermost
    first (diagnostics + tests)."""
    return tuple(lk.family for lk in _held_stack())


def _publish_held() -> None:
    t = threading.current_thread()
    with _PEERS_GUARD:
        fams = tuple(lk.family for lk in _held_stack())
        if fams:
            _PEERS[t.ident or 0] = (t.name, fams)
        else:
            _PEERS.pop(t.ident or 0, None)


def _peers_snapshot() -> dict[str, tuple[str, ...]]:
    me = threading.get_ident()
    with _PEERS_GUARD:
        return {f"{name}({tid})": fams
                for tid, (name, fams) in _PEERS.items() if tid != me}


def _reaches(src: str, dst: str) -> bool:
    """Is there a path src -> ... -> dst in the first-seen nesting
    graph? (Caller holds _EDGES_GUARD.)"""
    seen = set()
    stack = [src]
    while stack:
        f = stack.pop()
        if f == dst:
            return True
        if f in seen:
            continue
        seen.add(f)
        stack.extend(_EDGES.get(f, ()))
    return False


class LockOrderViolation(RuntimeError):
    """Structured lock-order violation: the acquire that would invert
    the protocol (or close a nesting cycle), with enough context to
    fix it without a debugger attached to a wedged fleet."""

    def __init__(self, kind: str, family: str, rank: Optional[int],
                 held: tuple[str, ...], peers: dict,
                 detail: str = ""):
        self.kind = kind            # "rank" | "cycle" | "self"
        self.family = family
        self.rank = rank
        self.held = held
        self.peers = peers
        msg = (f"lock-order violation ({kind}): acquiring "
               f"{family!r} (rank {rank}) while holding "
               f"{list(held)}")
        if detail:
            msg += f" — {detail}"
        if peers:
            msg += f"; other threads hold {peers}"
        super().__init__(msg)


class OrderedLock:
    """Drop-in `threading.Lock` with rank/cycle checking and hold/wait
    instrumentation. Non-reentrant: re-acquiring a held OrderedLock is
    reported as a self-deadlock when armed (and deadlocks for real
    when not, exactly like `threading.Lock`)."""

    _reentrant = False

    def __init__(self, family: str, *, rank: Optional[int] = None,
                 registry=None, name: Optional[str] = None):
        self.family = family
        self.name = name or family
        self.rank = rank if rank is not None else rank_of(family)
        self._inner = (threading.RLock() if self._reentrant
                       else threading.Lock())
        # cache the two histograms at construction: the acquire path
        # must not pay a registry get-or-create per lock op
        self._hold_hist = self._wait_hist = None
        if registry is not None:
            labels = {"name": family}
            self._wait_hist = registry.histogram("lock_wait_s",
                                                 labels=labels)
            self._hold_hist = registry.histogram("lock_hold_s",
                                                 labels=labels)
        self._t_acquired = 0.0
        self._depth = 0             # meaningful for the RLock subclass

    # -- checking ---------------------------------------------------------
    def _check(self) -> None:
        stack = _held_stack()
        if not stack:
            return
        if any(lk is self for lk in stack):
            if self._reentrant:
                return              # legal re-entry
            raise LockOrderViolation(
                "self", self.family, self.rank, held_families(),
                _peers_snapshot(),
                "re-acquiring a non-reentrant lock this thread already "
                "holds (guaranteed deadlock)")
        held_ranked = [lk for lk in stack if lk.rank is not None]
        if self.rank is not None and held_ranked:
            top = max(held_ranked, key=lambda lk: lk.rank)
            if self.rank < top.rank:
                raise LockOrderViolation(
                    "rank", self.family, self.rank, held_families(),
                    _peers_snapshot(),
                    f"rank {self.rank} is below held {top.family!r} "
                    f"(rank {top.rank}); the protocol is strictly "
                    "increasing rank")
            if self.rank == top.rank and top.family == self.family:
                raise LockOrderViolation(
                    "rank", self.family, self.rank, held_families(),
                    _peers_snapshot(),
                    "two locks of one family nested — same-rank "
                    "sibling locks (e.g. two per-metric locks) have "
                    "no defined order, so nesting them can deadlock "
                    "against a thread nesting them the other way")
        # cycle detection over the first-seen nesting graph: catches
        # inversions BETWEEN unranked families (and ranked-vs-unranked)
        # that the rank test cannot see
        inner = self.family
        with _EDGES_GUARD:
            for lk in stack:
                if lk.family == inner:
                    continue
                if _reaches(inner, lk.family):
                    raise LockOrderViolation(
                        "cycle", self.family, self.rank,
                        held_families(), _peers_snapshot(),
                        f"the fleet has previously nested "
                        f"{inner!r} -> ... -> {lk.family!r}; acquiring "
                        f"{inner!r} under {lk.family!r} closes the "
                        "cycle (two threads doing both orders is a "
                        "deadlock)")
                _EDGES.setdefault(lk.family, set()).add(inner)

    # -- lock API ---------------------------------------------------------
    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        armed = _armed
        if armed:
            self._check()
        wh = self._wait_hist
        if wh is not None:
            t0 = time.perf_counter()
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                wh.observe(time.perf_counter() - t0)
        else:
            ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._depth += 1
            if self._depth == 1:
                self._t_acquired = time.perf_counter()
                if armed:
                    _held_stack().append(self)
                    _publish_held()
                elif getattr(_tls, "stack", None):
                    # disarmed mid-run with locks held: keep the stack
                    # coherent rather than leaking entries
                    _tls.stack = []
        return ok

    def release(self) -> None:
        self._depth -= 1
        if self._depth == 0:
            hh = self._hold_hist
            if hh is not None:
                hh.observe(time.perf_counter() - self._t_acquired)
            stack = getattr(_tls, "stack", None)
            if stack:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is self:
                        del stack[i]
                        break
                _publish_held()
        self._inner.release()

    def locked(self) -> bool:
        if self._reentrant:
            return self._depth > 0
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:    # pragma: no cover — diagnostics
        return (f"<{type(self).__name__} {self.family!r} "
                f"rank={self.rank}>")


class OrderedRLock(OrderedLock):
    """Reentrant variant: re-entry by the holding thread is legal (and
    not re-checked); everything else behaves like `OrderedLock`."""

    _reentrant = True

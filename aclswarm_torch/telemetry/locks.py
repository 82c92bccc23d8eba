"""Order-checked locks: the part of `aclswarm_tpu/utils/locks.py` that the
metrics registry and the serving tier use.

Every lock belongs to a family with a rank, and the protocol is "acquire
in strictly increasing rank order": the service lock (20) may nest the
worker pool's (40) and any telemetry lock, never the other way round; the
registry's table lock ranks below its per-metric leaf locks, so a metric
is never locked while a thread holds another metric's lock. The check
runs only when armed (``ACLSWARM_LOCK_DEBUG=1`` at import, or `arm()`); a
violation raises `LockOrderViolation`. A lock built with ``registry=``
feeds ``lock_wait_s{name=<family>}`` (time blocked acquiring) and
``lock_hold_s{name=<family>}`` (time held) into that `MetricsRegistry`.
The reference's cross-thread nesting graph (cycle detection between
unranked families) is not copied: every family the port locks is ranked.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

__all__ = ["LockOrderViolation", "OrderedLock", "DEFAULT_RANKS", "arm",
           "disarm", "debug_armed", "held_families"]

# the reference's ranks of the families the port locks
DEFAULT_RANKS: dict[str, int] = {
    "serve.router": 10,         # router front door (stateless tier)
    "serve.wire": 14,           # wire dispatcher connection table
    "serve.service": 20,        # the service lock (jobs, stats, staging)
    "serve.pool": 40,           # worker-pool lifecycle lock
    "telemetry.registry": 80,   # metric get-or-create table
    "telemetry.spans": 85,      # flight-recorder ring
    "telemetry.metric": 90,     # leaf per-metric locks (innermost)
}

_armed = os.environ.get("ACLSWARM_LOCK_DEBUG", "") not in ("", "0")
_tls = threading.local()


def arm() -> None:
    """Turn the order check on."""
    global _armed
    _armed = True


def disarm() -> None:
    global _armed
    _armed = False


def debug_armed() -> bool:
    return _armed


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def held_families() -> tuple[str, ...]:
    """The calling thread's held lock families, outermost first."""
    return tuple(lk.family for lk in _held_stack())


class LockOrderViolation(RuntimeError):
    """An acquire that would invert the rank order (``kind`` "rank") or
    re-take a held non-reentrant lock (``kind`` "self")."""

    def __init__(self, kind: str, family: str, rank: Optional[int],
                 held: tuple[str, ...], detail: str = ""):
        self.kind = kind
        self.family = family
        self.rank = rank
        self.held = held
        msg = (f"lock-order violation ({kind}): acquiring {family!r} "
               f"(rank {rank}) while holding {list(held)}")
        if detail:
            msg += f" — {detail}"
        super().__init__(msg)


class OrderedLock:
    """Drop-in `threading.Lock` with the rank check and, with
    ``registry=``, hold and wait histograms. Non-reentrant. The registry's
    own metric locks take no registry (a lock observing itself into a
    histogram it guards would recurse)."""

    def __init__(self, family: str, *, rank: Optional[int] = None,
                 registry=None):
        self.family = family
        self.rank = rank if rank is not None else DEFAULT_RANKS.get(family)
        self._inner = threading.Lock()
        self._wait_hist = self._hold_hist = None
        if registry is not None:
            labels = {"name": family}
            self._wait_hist = registry.histogram("lock_wait_s",
                                                 labels=labels)
            self._hold_hist = registry.histogram("lock_hold_s",
                                                 labels=labels)
        self._t_acquired = 0.0

    def _check(self) -> None:
        stack = _held_stack()
        if any(lk is self for lk in stack):
            raise LockOrderViolation(
                "self", self.family, self.rank, held_families(),
                "re-acquiring a non-reentrant lock this thread holds")
        ranked = [lk for lk in stack if lk.rank is not None]
        if self.rank is None or not ranked:
            return
        top = max(ranked, key=lambda lk: lk.rank)
        if self.rank < top.rank or (self.rank == top.rank
                                    and top.family == self.family):
            raise LockOrderViolation(
                "rank", self.family, self.rank, held_families(),
                f"held {top.family!r} has rank {top.rank}; the protocol "
                "is strictly increasing rank")

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        armed = _armed
        if armed:
            self._check()
        if self._wait_hist is not None:
            t0 = time.perf_counter()
            ok = self._inner.acquire(blocking, timeout)
            if ok:
                self._wait_hist.observe(time.perf_counter() - t0)
        else:
            ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._t_acquired = time.perf_counter()
            if armed:
                _held_stack().append(self)
        return ok

    def release(self) -> None:
        if self._hold_hist is not None:
            self._hold_hist.observe(time.perf_counter() - self._t_acquired)
        stack = getattr(_tls, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is self:
                    del stack[i]
                    break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

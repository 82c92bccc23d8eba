"""Order-checked locks: the part of `aclswarm_tpu/utils/locks.py` that the
metrics registry uses.

Every lock belongs to a family with a rank, and the protocol is "acquire
in strictly increasing rank order". The registry's table lock ranks
below its per-metric leaf locks, so a metric is never locked while a
thread holds another metric's lock. The check runs only when armed
(``ACLSWARM_LOCK_DEBUG=1`` at import, or `arm()`); a violation raises
`LockOrderViolation`. The reference's hold/wait histograms and its
cross-thread nesting graph serve its serving tier and are not copied.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = ["LockOrderViolation", "OrderedLock", "DEFAULT_RANKS", "arm",
           "disarm", "debug_armed", "held_families"]

# the reference's ranks of the telemetry families
DEFAULT_RANKS: dict[str, int] = {
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
    """Drop-in `threading.Lock` with the rank check. Non-reentrant."""

    def __init__(self, family: str, *, rank: Optional[int] = None):
        self.family = family
        self.rank = rank if rank is not None else DEFAULT_RANKS.get(family)
        self._inner = threading.Lock()

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
        ok = self._inner.acquire(blocking, timeout)
        if ok and armed:
            _held_stack().append(self)
        return ok

    def release(self) -> None:
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

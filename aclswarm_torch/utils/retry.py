"""Retry, backoff and failure records (a copy of the parts of
`aclswarm_tpu/utils/retry.py` that the port's executor, service and client
call).

- `RetryPolicy` / `delay_for`: exponential backoff with deterministic
  jitter (a crc32 hash of (seed, attempt), so retries replay the same in
  tests and resumed runs) and an optional wall-clock budget;
- `jittered` / `retry_after_delay`: the serve admission ``retry_after_s``
  hint as a client backoff;
- `retry_call`: bounded retry of a callable while ``retryable(exc)``
  holds, with a ``cancel`` event that ends the backoff at once;
- `ExecutionFailure`: the record a driver attaches to its results when a
  stage failed after its retries;
- `poll_until`: fixed-interval polling against a grace deadline, also
  cancellable (the transports' backpressure wait);
- `subprocess_output`: a probe in a throwaway subprocess with a time limit
  (`serve.client.probe_backend`).

The reference's `Watchdog` and `subprocess_probe` serve its bench driver
and are not copied.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import threading
import time
import zlib
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter and budget caps.

    Attempt k (0-based) sleeps ``min(base_s * factor**k, max_s)``
    scaled by ``1 + jitter * u(seed, k)`` with ``u`` a pure hash in
    [0, 1) — same policy + seed + attempt always yields the same delay
    (reproducible sweeps; no thundering-herd alignment across trials
    because each call site folds its own seed).
    """

    attempts: int = 4          # total tries (1 = no retry)
    base_s: float = 0.05       # first backoff delay
    factor: float = 2.0        # exponential growth per attempt
    max_s: float = 2.0         # per-delay ceiling
    budget_s: Optional[float] = None   # total wall-clock cap (None = off)
    jitter: float = 0.25       # fractional deterministic jitter
    seed: int = 0


def _unit_hash(seed: int, attempt: int) -> float:
    """Pure [0, 1) hash of (seed, attempt) — crc32, not `random`, so
    delays are identical across processes and resumed runs."""
    h = zlib.crc32(f"{seed}:{attempt}".encode())
    return (h & 0xFFFFFF) / float(1 << 24)


def delay_for(policy: RetryPolicy, attempt: int) -> float:
    """Backoff delay before retry number ``attempt`` (0-based)."""
    d = min(policy.base_s * (policy.factor ** attempt), policy.max_s)
    return d * (1.0 + policy.jitter * _unit_hash(policy.seed, attempt))


def jittered(delay_s: float, seed: int, attempt: int,
             frac: float = 0.25) -> float:
    """Deterministically jittered delay: the retry-after form of
    `delay_for`, for waits whose BASE the other side names (the serve
    admission ``retry_after_s`` hint). Same crc32 hash as the policy
    jitter — replays are identical, and a fleet of rejected clients
    folding distinct seeds de-aligns instead of thundering back in one
    herd."""
    return float(delay_s) * (1.0 + frac * _unit_hash(seed, attempt))


def retry_after_delay(hint_s: float, seed: int, attempt: int,
                      cap_s: float = 30.0) -> float:
    """THE serve retry-after backoff: the server's hint, floored away
    from zero, jittered deterministically, capped. One home for the
    contract every hint-honoring client shares (`serve.client`)."""
    return min(float(cap_s), jittered(max(0.01, float(hint_s)),
                                      seed, attempt))


@dataclasses.dataclass
class ExecutionFailure:
    """One stage's failure record, committed into results JSON so a
    degraded run is evidence instead of a dead artifact. ``fallback``
    names what absorbed the failure ('cpu', 'requeued', ...) or None
    when the stage ultimately failed."""

    stage: str
    error: str
    attempts: int = 1
    elapsed_s: float = 0.0
    fallback: Optional[str] = None

    def to_row(self) -> dict:
        """The reference's key set, field for field."""
        return {"stage": self.stage, "error": self.error,
                "attempts": self.attempts,
                "elapsed_s": round(self.elapsed_s, 3),
                "fallback": self.fallback}


class RetryCancelled(RuntimeError):
    """A `retry_call` was cancelled before its first attempt could run.
    Cancellation landing AFTER a failed attempt re-raises that attempt's
    exception instead — the caller sees the real failure, just without
    the remaining backoff budget."""


def retry_call(fn: Callable, *args,
               policy: RetryPolicy = RetryPolicy(),
               retryable: Callable[[BaseException], bool] = lambda e: True,
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               cancel: Optional[threading.Event] = None):
    """Call ``fn(*args)``, retrying per ``policy`` while ``retryable(exc)``
    holds and the budget allows. Non-retryable exceptions and the final
    failure propagate unchanged (callers wrap them into
    `ExecutionFailure` records with their own stage context).

    ``cancel`` (optional) propagates an external teardown into the
    in-flight budget: a set event stops further attempts immediately and
    interrupts the backoff sleep mid-wait (the event IS the sleeper, so
    a 5 s backoff ends the moment the canceller fires). Cancellation
    before the first attempt raises `RetryCancelled`; after a failure it
    re-raises that failure. It never aborts ``fn`` itself mid-call —
    attempts are the cancellation boundaries, exactly like the serve
    layer's chunk boundaries."""
    t0 = clock()
    for attempt in range(policy.attempts):
        if cancel is not None and cancel.is_set():
            raise RetryCancelled(
                f"retry budget cancelled before attempt {attempt}")
        try:
            return fn(*args)
        except BaseException as e:            # noqa: BLE001 — re-raised
            last_try = attempt >= policy.attempts - 1
            if last_try or not retryable(e):
                raise
            d = delay_for(policy, attempt)
            if policy.budget_s is not None \
                    and clock() - t0 + d > policy.budget_s:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if cancel is not None:
                if cancel.wait(d):        # interrupted backoff: surface
                    raise                 # the real failure, now
            else:
                sleep(d)
    raise AssertionError("unreachable")       # pragma: no cover


def poll_until(fn: Callable[[], bool], *, grace_s: float,
               poll_s: float = 0.001,
               sleep: Callable[[float], None] = time.sleep,
               clock: Callable[[], float] = time.monotonic,
               cancel: Optional[threading.Event] = None) -> bool:
    """Fixed-interval poll of ``fn`` until it returns truthy or the grace
    deadline passes. The backpressure shape (shm ring drain): the first
    call is immediate, and the deadline bounds TOTAL wait — False means
    the grace expired with ``fn`` still failing.

    The deadline is computed once from the monotonic ``clock`` and every
    sleep is capped to the remaining budget, so a poll interval larger
    than what is left never overshoots the deadline. After the final
    capped sleep ``fn`` gets one last immediate check before False.

    ``cancel`` (optional) aborts the poll early with False; a set event
    also cuts the in-flight inter-poll sleep short (event-based wait),
    so a cancelled poller returns within one poll interval."""
    deadline = clock() + grace_s
    while True:
        if cancel is not None and cancel.is_set():
            return False
        if fn():
            return True
        remaining = deadline - clock()
        if remaining <= 0:
            return False
        step = min(poll_s, remaining)
        if cancel is not None:
            if cancel.wait(step):
                return False
        else:
            sleep(step)


def subprocess_output(code: str, timeout_s: float,
                      cwd: Optional[str] = None) -> Optional[str]:
    """Stdout of ``python -c code`` iff it exits 0 within the budget,
    else None. Sacrificial by design: a probe of a wedged resource must
    hang a throwaway process, never the caller
    (`serve.client.probe_backend` layers on this)."""
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           timeout=timeout_s, cwd=cwd)
        return r.stdout if r.returncode == 0 else None
    except (subprocess.TimeoutExpired, OSError):
        return None

"""Chunk-level execution wrapper (port of
`aclswarm_tpu/resilience/executor.py`): retry transient device failures
and record what happened.

The trial drivers and the serving layer launch one rollout per chunk. A
launch can fail transiently (the card's allocator out of memory while
another job holds it, a status the reference's tunnel reported as
RESOURCE_EXHAUSTED or UNAVAILABLE). `ChunkExecutor` retries each launch
under the unified policy (`utils.retry`). When the retries are spent it
appends an `ExecutionFailure` record and raises. Unlike the reference it
never re-runs the chunk on the CPU: a run that asked for the card either
gets the card's answer or an error, and ``degraded`` never appears in its
record.

What is and is not retried:

- ``torch.cuda.OutOfMemoryError`` is retried, after
  ``torch.cuda.empty_cache()`` hands the cached blocks back;
- the reference's message markers of its transient class are retried, so
  an injected test fault classifies in both packages alike;
- a sticky CUDA error ("illegal memory access", "device-side assert",
  "unspecified launch failure", "misaligned address") and the port's own
  kernel errors (``"<symbol> failed: CUDA error ..."`` from
  `ops._build.launch`) are not: the CUDA context is lost after them, and
  a retry would only report garbage;
- `InjectedCrash` (scripted preemption) and `RetryCancelled` surface at
  once, as every other error does.

A retried thunk must be replay-safe: torch has no buffer donation, so the
hazard is an in-place write to the chunk's inputs, and neither
`sim.rollout` nor `sim.batched_rollout` writes to its arguments
(`tests/test_torch_executor.py` replays a chunk that failed partway).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from aclswarm_torch.resilience.crash import InjectedCrash
from aclswarm_torch.utils.retry import (ExecutionFailure, RetryCancelled,
                                        RetryPolicy, retry_call)

# the reference's markers of the transient device-failure class
TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE", "DEADLINE",
                     "ABORTED", "DATA_LOSS", "INTERNAL", "connection",
                     "socket closed", "tunnel")
# errors after which the CUDA context is unusable, and the port's own
# kernel errors (`ops._build.launch`)
STICKY_MARKERS = ("illegal memory access", "device-side assert",
                  "unspecified launch failure", "misaligned address",
                  " failed: CUDA error ")


def is_transient_device_error(e: BaseException) -> bool:
    if isinstance(e, (InjectedCrash, RetryCancelled)):
        return False
    s = str(e)
    if any(m in s for m in STICKY_MARKERS):
        return False
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return any(m in s for m in TRANSIENT_MARKERS)


class ChunkExecutor:
    """Run per-chunk device launches under the unified retry policy.

    One executor per driver run; it accumulates ``retries`` (retried
    attempts in all) and ``failures`` (one record per stage that failed
    after its retries) for the run's results row."""

    def __init__(self, policy: Optional[RetryPolicy] = None, log=None,
                 transient: Callable[[BaseException], bool]
                 = is_transient_device_error):
        self.policy = policy or RetryPolicy(attempts=3, base_s=0.2,
                                            max_s=5.0)
        self.log = log
        self.transient = transient
        self.retries = 0
        self.failures: list[ExecutionFailure] = []
        self._lock = threading.Lock()   # serve workers share one executor

    def run(self, fn: Callable, *args, stage: str = "chunk",
            cancel: Optional[threading.Event] = None):
        """``fn(*args)`` with retries. A transient failure that outlives
        the retries is recorded and raised; ``cancel`` stops the backoff
        at once (a torn-down request must not keep the card busy)."""
        t0 = time.monotonic()

        def note_retry(attempt: int, e: BaseException) -> None:
            with self._lock:
                self.retries += 1
            if isinstance(e, torch.cuda.OutOfMemoryError):
                torch.cuda.empty_cache()
            if self.log is not None:
                self.log.warning(f"{stage}: transient device failure "
                                 f"(attempt {attempt + 1}/"
                                 f"{self.policy.attempts}): {e}")

        try:
            return retry_call(fn, *args, policy=self.policy,
                              retryable=self.transient,
                              on_retry=note_retry, cancel=cancel)
        except BaseException as e:      # noqa: BLE001 — classified below
            if not self.transient(e) or (cancel is not None
                                         and cancel.is_set()):
                raise
            with self._lock:
                self.failures.append(ExecutionFailure(
                    stage=stage, error=str(e),
                    attempts=self.policy.attempts,
                    elapsed_s=time.monotonic() - t0))
            raise

    def row_fields(self) -> dict:
        """The results metadata this run earned: empty when nothing
        failed, else ``retries`` and ``execution_failures`` as the
        reference writes them."""
        out: dict = {}
        with self._lock:
            if self.retries:
                out["retries"] = self.retries
            if self.failures:
                out["execution_failures"] = [f.to_row()
                                             for f in self.failures]
        return out

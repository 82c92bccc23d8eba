"""Client-side conveniences for the serving layer (port of
`aclswarm_tpu/serve/client.py`):

- `probe_backend`: whether a CUDA card answers, asked in a throwaway
  subprocess with a time limit (a wedged driver must hang that process,
  never the caller), under the unified `RetryPolicy`;
- `submit_and_wait`: submit-then-block with every non-answer translated
  into a structured failed `Result` — admission rejection, bounded client
  patience (the service still owes the result; the client just stopped
  waiting), and a dead worker (a ticket a dead worker holds will never
  resolve; journal recovery is how it gets honored).
"""
from __future__ import annotations

import time
import uuid
import zlib
from typing import Optional

from aclswarm_torch.serve.api import (E_CLIENT_TIMEOUT, E_QUEUE_FULL,
                                    E_WORKER_DIED, FAILED, RejectedError,
                                    Result, ServeError)
from aclswarm_torch.utils.retry import (RetryPolicy, retry_after_delay,
                                      retry_call, subprocess_output)

PROBE_CODE = ("import torch; print('backend=' + "
              "('cuda' if torch.cuda.is_available() else 'cpu'))")


def probe_backend(timeout_s: float = 120.0,
                  code: str = PROBE_CODE,
                  policy: Optional[RetryPolicy] = None,
                  cwd: Optional[str] = None) -> Optional[str]:
    """``'cuda'`` when a subprocess sees a CUDA card, ``'cpu'`` when it
    sees none, None when it never answered within ``timeout_s`` (twice,
    under the retry policy): `torch.cuda.is_available()` in a throwaway
    process (`utils.retry.subprocess_output`), so a wedged driver hangs
    that process and not the caller."""
    policy = policy or RetryPolicy(attempts=2, base_s=1.0, max_s=5.0)

    def _once() -> str:
        out = subprocess_output(code, timeout_s, cwd=cwd)
        if out is None:
            raise RuntimeError("device probe gave no output within "
                               f"{timeout_s:.0f} s")
        for line in out.splitlines():
            if line.startswith("backend="):
                return line.split("=", 1)[1].strip()
        raise RuntimeError("device probe exited without a backend line")

    try:
        return retry_call(_once, policy=policy)
    except RuntimeError:
        return None


def submit_and_wait(service, kind: str, params: dict, *,
                    tenant: str = "default",
                    request_id: Optional[str] = None,
                    deadline_s: Optional[float] = None,
                    client_timeout_s: Optional[float] = None,
                    poll_s: float = 5.0,
                    trace_id: Optional[str] = None,
                    reject_retries: int = 4,
                    max_retry_wait_s: float = 30.0) -> Result:
    """Submit one request and block for its terminal `Result`. Every
    non-answer comes back as a structured result (status ``failed``) so
    callers can treat every path uniformly — only programming errors
    raise:

    - admission rejection -> retried: the service's ``retry_after_s``
      hint is honored (slept out with deterministic crc32 jitter,
      `utils.retry.jittered`, so replays are identical and a rejected
      fleet de-aligns) up to ``reject_retries`` times before the caller
      sees a structured ``queue_full`` (``reject_retries=0`` surfaces
      the first rejection);
    - ``client_timeout_s`` lapsing -> ``client_timeout`` (the service
      STILL owes the result; the client just stopped waiting);
    - the worker dying with the ticket open -> ``worker_died`` (a dead
      worker never resolves its tickets — waiting longer is a hang, and
      journal recovery is how the promise gets honored).

    The wait polls ``service.alive`` every ``poll_s`` — legitimate
    long-running work is indistinguishable from a hang without it.
    ``trace_id`` threads a caller-held trace id through to the service;
    omitted, the service mints one and the terminal `Result.trace_id`
    carries it back."""
    # the id is minted HERE when the caller brought none: it is both
    # the idempotency key across the retries and the jitter seed — a
    # fleet of auto-id callers must NOT share one crc32(tenant:kind)
    # seed, or their retries march in lockstep (the herd the jitter
    # exists to break)
    request_id = request_id or uuid.uuid4().hex[:12]
    seed = zlib.crc32(request_id.encode())
    ticket = None
    for attempt in range(max(0, reject_retries) + 1):
        try:
            ticket = service.submit(kind, params, tenant=tenant,
                                    request_id=request_id,
                                    deadline_s=deadline_s,
                                    trace_id=trace_id)
            break
        except RejectedError as e:
            if attempt >= reject_retries:
                return Result(request_id=request_id or "", status=FAILED,
                              error=ServeError(
                                  E_QUEUE_FULL, str(e),
                                  detail={"retry_after_s":
                                          e.retry_after_s}))
            time.sleep(retry_after_delay(e.retry_after_s, seed,
                                         attempt, max_retry_wait_s))
    assert ticket is not None
    deadline = (time.monotonic() + client_timeout_s
                if client_timeout_s is not None else None)
    while True:
        step = poll_s
        if deadline is not None:
            step = min(step, max(0.0, deadline - time.monotonic()))
        try:
            return ticket.result(timeout=step)
        except TimeoutError as e:
            if not service.alive and not ticket.done:
                return Result(
                    request_id=ticket.request_id, status=FAILED,
                    error=ServeError(
                        E_WORKER_DIED,
                        "serve worker died with this request in flight "
                        "(scripted crash?) — journal recovery is how "
                        "it gets honored"))
            if deadline is not None and time.monotonic() >= deadline:
                return Result(request_id=ticket.request_id, status=FAILED,
                              error=ServeError(E_CLIENT_TIMEOUT, str(e)))

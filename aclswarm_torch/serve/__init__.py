"""The in-process serving layer (port of `aclswarm_tpu.serve`).

A persistent service over the batched rollout engine: a threaded queue
front end accepts rollout, assignment and gain-design requests from many
tenants, packs compatible rollouts into shape-bucketed, power-of-two,
continuously refilled device batches, and streams per-chunk results back
per request. Its contract is the reference's:

- **admission control + backpressure**: bounded per-tenant and global
  queues; overload is an explicit `RejectedError` with a drain-rate
  ``retry_after_s`` hint (`serve.admission`);
- **zero silent losses**: accepted requests are journaled before
  `submit` returns and always terminate with a value or a structured
  `ServeError`, across deadline expiry, preemption, a killed worker and
  a killed process with its journal recovery (`serve.service`,
  `serve.smoke`);
- **deadlines and cancels at chunk boundaries**;
- **per-tenant fair scheduling**: round-robin batch slots;
- **checkpoint-backed preemption and failover**: rollouts evicted or
  migrated through the checkpoint codec resume bit for bit
  (`serve.workers`);
- **device-bound rounds**: requests are prepped into batch-layout rows at
  submit, rounds run off per-bucket staging stores with double-buffered
  pipelining, and each round's host read is one copy (`serve.staging`).

The service runs on the CUDA card unless ``ServiceConfig(device="cpu")``
asks for the CPU. ``ServiceConfig(watch=True)`` runs the health tier
(`telemetry.slo`) and the ``health`` kind reports its SLO verdicts.
Process mode: `serve.router.SwarmRouter(RouterConfig(...))` is a wire
front door over one `serve.procworker` OS process per slot, each a
`SwarmService` with its own CUDA context (``serve.smoke --procs``).
"""
from aclswarm_torch.serve.api import (COMPLETED, FAILED, PREEMPTED, QUEUED,
                                      RUNNING, TERMINAL, TIMED_OUT,
                                      ChunkEvent, RejectedError, Request,
                                      Result, ServeError, Ticket)
from aclswarm_torch.serve.client import probe_backend, submit_and_wait
from aclswarm_torch.serve.service import (BUILTIN_KINDS, ServiceConfig,
                                          SwarmService, bucket_of)
from aclswarm_torch.serve.stats import ServeStats
from aclswarm_torch.serve.workers import WorkerPool, place_slot

__all__ = [
    "COMPLETED", "FAILED", "PREEMPTED", "QUEUED", "RUNNING", "TERMINAL",
    "TIMED_OUT", "ChunkEvent", "RejectedError", "Request", "Result",
    "ServeError", "Ticket", "probe_backend", "submit_and_wait",
    "BUILTIN_KINDS", "ServiceConfig", "SwarmService", "ServeStats",
    "WorkerPool", "bucket_of", "place_slot",
]
# WireServer / WireClient live in `aclswarm_torch.serve.wire` and are
# imported from there directly, as in the reference: the shm transport
# requires the native library (make -C native), which stays optional for
# the core service. The TCP binding (`WireServer(tcp=...)`) and the
# traffic fleet (`aclswarm_torch.serve.traffic`) are pure stdlib.

"""The in-process serving layer over the batched engine (port of
`aclswarm_tpu/serve/service.py`).

A `SwarmService` is a threaded queue front end plus N supervised device
workers (`serve.workers.WorkerPool`; ``ServiceConfig.workers``). Clients
`submit` heterogeneous requests — chunked rollouts, assignment solves,
gain designs, registered extension kinds — and hold a `Ticket` that
streams per-chunk progress and resolves to a terminal `Result`. Each
worker packs compatible rollout requests into shape-bucketed,
power-of-two-padded batches and runs them through `sim.batched_rollout`
one chunk at a time (admission shards buckets across workers by
rendezvous hash), so every chunk boundary is at once:

- a **scheduling point** (new arrivals join the next round: continuous
  batching),
- a **deadline gate** (expired requests terminate with a structured
  ``deadline_exceeded`` error instead of hanging),
- a **preemption point** (a job past its quantum with other work waiting
  is evicted through the checkpoint codec and resumes bit for bit), and
- a **durability point** (with a journal, in-flight rollout state is
  checkpointed, so a killed process loses at most one chunk of work,
  never a request).

The guarantees, as the reference states them:

1. bounded queues: admission rejects with a retry-after hint
   (`serve.admission`);
2. zero silent losses: an accepted request is journaled before `submit`
   returns and terminates with a value or a structured error, across a
   killed process and its recovery;
3. bit-identical resume: preempted, migrated or recovered rollouts match
   an uninterrupted run exactly (on one device, in one dtype, under the
   same batch composition);
4. transient device failures are retried and recorded by the shared
   `ChunkExecutor`; a chunk whose retries are spent fails its requests
   with ``execution_failed``. The reference's CPU re-run has no
   counterpart: ``ServiceConfig(cpu_fallback=True)`` raises;
5. a worker's death is routine: its in-flight jobs fail over through the
   checkpoint codec to the surviving workers (`serve.workers`).

The service runs on one device in one dtype (``ServiceConfig.device``,
None = the CUDA card, which raises when there is none; ``dtype``
"float32", or "float64" for the CPU parity tests). ``watch=True`` runs
the health tier: a sampler over the service's registry, the SLO engine,
and ``alert`` events in the journal (`telemetry.slo`).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import sys
import threading
import time
import uuid
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from aclswarm_torch.core.types import resolve_device
from aclswarm_torch.resilience import ChunkExecutor, maybe_crash
from aclswarm_torch.resilience import checkpoint as ckptlib
from aclswarm_torch.serve import staging as stagelib
from aclswarm_torch.serve.admission import AdmissionControl
from aclswarm_torch.serve.api import (COMPLETED, E_CANCELLED, E_DEADLINE,
                                      E_EXECUTION, E_POISONED, E_QUEUE_FULL,
                                      E_SHUTDOWN, FAILED, PREEMPTED, QUEUED,
                                      RUNNING, TIMED_OUT, ChunkEvent,
                                      RejectedError, Request, Result,
                                      ServeError, Ticket)
from aclswarm_torch.serve.stats import ServeStats
from aclswarm_torch.telemetry import (LifecycleLog, MetricsRegistry,
                                      install_crash_dump, mint_trace_id)
from aclswarm_torch.utils.locks import OrderedLock
from aclswarm_torch.utils.retry import RetryPolicy

BUILTIN_KINDS = ("rollout", "assign", "gains", "stats", "scenario",
                 "health")
CRASH_SITE = "serve"        # maybe_crash site: one boundary per round
DTYPES = {"float32": torch.float32, "float64": torch.float64}

# lifecycle events journaled even with cfg.trace=False: the worker-failure
# ledger recovery restores its counters from
_LEDGER_EVENTS = frozenset({"failover", "migrated", "poisoned", "alert"})


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Service-level knobs (per-request knobs live in the params): the
    reference's fields and defaults, plus ``device`` and ``dtype``.
    ``cpu_fallback`` defaults to False and raises when True (see the
    module docstring)."""

    max_queue_per_tenant: int = 8     # admission cap per tenant
    max_queue_total: int = 32         # admission cap across tenants
    max_batch: int = 4                # device batch slots per round
    quantum_chunks: int = 2           # chunks before a job is preemptible
    # ---- multi-worker serving (serve.workers) ----
    workers: int = 1                  # supervised worker threads
    lease_s: float = 60.0             # heartbeat lease: a worker silent
    #                                   this long is declared dead even
    #                                   with its thread alive (wedge);
    #                                   generous by default — a first
    #                                   kernel build legitimately blocks
    #                                   the loop for seconds
    supervise_poll_s: float = 0.1     # supervisor cadence
    max_worker_exclusions: int = 2    # K SOLO-implicated kills (the job
    #                                   was alone in the batch — nobody
    #                                   else to blame) before a request
    #                                   is declared poisoned; batched
    #                                   kills quarantine but don't count
    max_worker_restarts: int = 3      # circuit breaker: consecutive
    #                                   deaths before a slot retires
    rejoin_base_s: float = 0.05       # backoff-gated rejoin (RetryPolicy)
    rejoin_max_s: float = 2.0
    # journal directory (None = in-memory only: preemption still goes
    # through the codec, but a killed process loses the promise ledger)
    journal_dir: Optional[str] = None
    default_deadline_s: Optional[float] = None
    idle_poll_s: float = 0.05         # worker park interval when idle
    retry_attempts: int = 3           # ChunkExecutor transient retries
    cpu_fallback: bool = False        # the reference's CPU re-run: no
    #                                   counterpart (True raises)
    # terminal results kept in memory for duplicate-submit idempotency
    # (oldest evicted beyond this; journal done-frames persist)
    done_retention: int = 1024
    # journal the full lifecycle-event stream to the journal's
    # events.log. Off disables only the trace events — the
    # failover/migrated/poisoned ledger recovery counts from is always
    # journaled.
    trace: bool = True
    # ---- device-bound rounds (serve.staging) ----
    # staging=True: requests are prepped into rows at submit, rounds run
    # off per-bucket staging stores, and a round's host read is ONE
    # copy of the round's positions. False = the pack-at-round-time
    # path, kept as the bit-parity reference.
    staging: bool = True
    # pipeline=True: the worker packs and dispatches round k+1 while
    # the device still runs round k, and blocks only at resolve (the
    # round's one host read). False = resolve each round before picking
    # the next. Requires staging; ignored when staging=False.
    pipeline: bool = True
    # ---- the health tier (telemetry.timeseries/slo): time series over
    # this service's registry and live SLO evaluation with a
    # pending -> firing -> resolved alert machine. Off by default (a
    # sampler thread per service would tax every short-lived test
    # service). With a journal, history persists to
    # <journal>/timeseries.log and alert transitions append to
    # events.log as ``alert`` fleet events.
    watch: bool = False
    watch_interval_s: float = 0.25    # sampler + SLO evaluation cadence
    watch_capacity: int = 1024        # points retained per series
    # SLO catalog override (tuple of telemetry.slo.SloSpec); None =
    # telemetry.slo.default_slos(max_queue_total=cfg.max_queue_total)
    slos: Optional[tuple] = None
    # ---- the journal incarnation: every req/done frame and lifecycle
    # event is stamped with it, and a FENCE frame naming a newer one
    # turns this process's journal writes into loud no-ops (the
    # reference's process mode writes fences; the port's thread mode
    # leaves it 0) ----
    incarnation: int = 0
    # ---- the port's device and precision ----
    device: Optional[str] = None      # None = the CUDA card
    dtype: str = "float32"            # "float32" | "float64"


@dataclasses.dataclass
class _Job:
    """Service-internal request state (the ticket is the client view)."""

    req: Request
    ticket: Ticket
    bucket: tuple
    status: str = QUEUED
    spec: Any = None              # parsed rollout problem (lazy-built)
    state: Any = None             # resident SimState between chunks
    chunks_total: int = 0
    chunks_done: int = 0
    run_chunks: int = 0           # consecutive chunks this residency
    preemptions: int = 0
    resumed: bool = False         # continued from a journaled checkpoint
    crc: int = 0                  # running bit-exact position digest
    chunk_digests: list = dataclasses.field(default_factory=list)
    t_accept: float = 0.0         # monotonic (in-process latency split)
    t_first_run: Optional[float] = None
    finished: bool = False        # _finish() ran (atomic once-guard)
    held: bool = False            # caps slot reserved, picker-invisible
    worker: Optional[int] = None  # slot currently holding the job
    pick_batch: int = 1           # size of the batch this job was last
    #                               PICKED into — the poison bound's
    #                               solo-attribution unit (with the
    #                               pipeline a dead worker usually has
    #                               TWO rounds in flight, so "only
    #                               orphan" would never be true and a
    #                               poison request would ping-pong the
    #                               fleet unbounded; "alone in its own
    #                               batch" is the honest blame unit)
    epoch: int = 0                # bumped on failover: a fenced zombie
    #                               worker's stale writes are no-ops
    failovers: int = 0            # worker-death migrations survived
    excluded_workers: set = dataclasses.field(default_factory=set)
    #                               worker INCARNATIONS this job died on
    #                               (the poison ping-pong bound)
    suspect: bool = False         # was in-flight at a worker death:
    #                               QUARANTINED to solo batches until a
    #                               surviving chunk exonerates it — an
    #                               innocent batch-mate of a kill must
    #                               never ride to the poison bound
    solo_kills: int = 0           # kills witnessed while SOLO in the
    #                               batch (nobody else to blame) since
    #                               the last exoneration — the poison
    #                               bound counts only these
    cancelled: Optional[str] = None    # boundary-cancel reason (wire
    #                                    client death; never mid-batch)
    _ckpt_bytes: Optional[bytes] = None   # journal-less preemption frame
    _problem: Any = None          # (formation, cgains, sparams, cfg)
    staged: Any = None            # (BucketStaging, slot) while resident
    #                               in a worker's staging store — the
    #                               job's state IS that row (job.state
    #                               stays None); cleared on preemption,
    #                               failover, and every terminal path
    _shadow: Any = None           # unjournaled failover source: a LAZY
    #                               (output-batch, row) reference set at
    #                               every resolved chunk — always
    #                               state@chunks_done by construction;
    #                               materialized (one take_row) only if
    #                               a migration actually needs it


class _Fenced(Exception):
    """Raised inside a round when the executing worker discovers it has
    been fenced (lease-lapse zombie): the thread must abandon the round
    WITHOUT touching staging buffers or job state — its in-flight jobs
    were (or are being) failed over by the supervisor."""


@dataclasses.dataclass
class _PendingRound:
    """One dispatched-but-unresolved staged rollout round (the unit the
    worker loop double-buffers). Everything `_round_finish` needs:
    the async device handles, the job/row/slot maps, and the OPEN
    parent span (entered at pack, exited at resolve — so the committed
    breakdown's ``serve.round`` covers the whole pipelined window)."""

    pairs: list                # the original (job, epoch) pick
    jobs: list                 # gated-in jobs, batch-row order
    epochs: dict               # id(job) -> epoch at pick
    rows: dict                 # id(job) -> row index in the round batch
    out: Any                   # output batch SimState (async device)
    unpacked: Any              # {"q_chunks","q_final"} (async device)
    staging: Any               # the BucketStaging this round ran from
    chunk: int                 # ticks per chunk (bucket-pinned)
    B: int                     # live batch size (pre-pow2-pad)
    P: int                     # padded batch size actually dispatched
    t0: float                  # monotonic at dispatch
    grnd: int                  # global round number (span/journal attr)
    wround: int                # worker-round AT DISPATCH (the chunk
    #                            event must name the round that ran it,
    #                            not whatever round started since)
    span_attrs: dict           # serve.round span attributes
    start_dur: float           # wall of the START phase: the round
    #                            span is emitted at finish as
    #                            start_dur + finish_dur — its two
    #                            ACTIVE phases only, NOT the pipelined
    #                            idle window in between (which belongs
    #                            to the interleaved round). Keeps
    #                            sum(serve.round) <= wall, so the
    #                            stage fractions the committed
    #                            breakdown/throughput gates consume
    #                            are not diluted ~2x by overlap.


# ---------------------------------------------------------------------------
# request parsing / problem building (rollout)

@dataclasses.dataclass
class _RolloutSpec:
    n: int
    chunk_ticks: int
    n_chunks: int
    assignment: str
    assign_every: int
    seed: int
    faults_spec: Optional[dict]
    scenario_spec: Optional[dict]
    points: Optional[np.ndarray]
    adjmat: Optional[np.ndarray]
    gains: Optional[np.ndarray]


def _parse_rollout(params: dict) -> _RolloutSpec:
    """Validate + normalize rollout params at ADMISSION time: a request
    the engine cannot run is refused at the door (ValueError), not
    accepted and failed later."""
    if "n" not in params or "ticks" not in params:
        raise ValueError("rollout params require 'n' and 'ticks'")
    n = int(params["n"])
    ticks = int(params["ticks"])
    chunk = int(params.get("chunk_ticks", 20))
    if n < 2 or ticks < 1 or chunk < 1:
        raise ValueError(f"bad rollout sizes n={n} ticks={ticks} "
                         f"chunk_ticks={chunk}")
    assign_every = int(params.get("assign_every", chunk))
    if chunk % assign_every:
        # the batch shares the decimation phase: chunk-aligned auctions
        # are what let heterogeneous requests at different progress
        # share one batch
        raise ValueError(f"chunk_ticks ({chunk}) must be a multiple of "
                         f"assign_every ({assign_every})")
    if ticks % chunk:
        # every chunk runs full-length (ONE batch shape per bucket);
        # rounding up silently would execute MORE ticks than requested
        # and report a different problem than the one submitted
        raise ValueError(f"ticks ({ticks}) must be a multiple of "
                         f"chunk_ticks ({chunk}) — chunks run whole")
    fspec = params.get("faults")
    _FKEYS = {"dropout_frac", "drop_tick", "rejoin_tick", "link_loss"}
    if fspec is not None and (not isinstance(fspec, dict)
                              or not set(fspec) <= _FKEYS):
        raise ValueError("rollout 'faults' must be a spec dict with keys "
                         f"from {sorted(_FKEYS)}, got {fspec!r}")
    sspec = params.get("scenario")
    if sspec is not None:
        # scenario requests validate against the registry AT ADMISSION
        # — an unknown family or out-of-space override is refused at
        # the door like any other malformed rollout (docs/SCENARIOS.md)
        _SKEYS = {"family", "seed", "params", "horizon"}
        if not isinstance(sspec, dict) or "family" not in sspec \
                or not set(sspec) <= _SKEYS:
            raise ValueError(
                "rollout 'scenario' must be a spec dict {'family': "
                f"<registry name>, 'seed'?, 'params'?, 'horizon'?}}, "
                f"got {sspec!r}")
        from aclswarm_torch.scenarios import registry as scenreg
        fam = scenreg.validate(str(sspec["family"]), sspec.get("params"))
        if fam.localization != "truth":
            # the serving engine runs the 'truth' information model
            # (no estimate tables in the serve rows): a family whose
            # axes only bite under flooded localization would run as a
            # silent no-op — scenario-free results sold as a scenario
            # run. Refuse at the door; the trials/suite drivers serve
            # those families (docs/SCENARIOS.md).
            raise ValueError(
                f"scenario family {sspec['family']!r} requires the "
                f"{fam.localization!r} information model; serve "
                "rollouts run 'truth' localization — drive it through "
                "harness.trials")
    arr = {k: (np.asarray(params[k]) if k in params else None)
           for k in ("points", "adjmat", "gains")}
    return _RolloutSpec(
        n=n, chunk_ticks=chunk,
        n_chunks=ticks // chunk,
        assignment=str(params.get("assignment", "auction")),
        assign_every=assign_every, seed=int(params.get("seed", 0)),
        faults_spec=fspec, scenario_spec=sspec, points=arr["points"],
        adjmat=arr["adjmat"], gains=arr["gains"])


def _bucket_from_spec(spec: _RolloutSpec) -> tuple:
    return ("rollout", spec.n, spec.chunk_ticks, spec.assignment,
            spec.assign_every)


def _scenario_to_rollout(params: dict) -> dict:
    """The `scenario` request kind is a rollout drawn from the family
    registry: flat params carry the rollout sizing keys (n, ticks, ...)
    plus the scenario draw (family, seed, params, horizon). Normalized
    here into rollout params with a nested scenario spec, so scenario
    requests share the rollout state machine — and the rollout BUCKETS:
    a scenario request batches with plain rollouts of the same shape
    (the `no_scenario` normalization; docs/SCENARIOS.md)."""
    if not isinstance(params, dict) or "family" not in params:
        raise ValueError("scenario params require 'family' (a registry "
                         "family name) plus the rollout sizing keys "
                         "('n', 'ticks', ...)")
    p = dict(params)
    sspec = {k: p.pop(k) for k in ("family", "params", "horizon")
             if k in p}
    if "seed" in p:
        # ONE seed drives both draws: the scenario script and the
        # rollout's initial cloud (reproducible from the flat params)
        sspec["seed"] = p["seed"]
    p["scenario"] = sspec
    return p


def bucket_of(kind: str, params: dict) -> tuple:
    """The shape-compatibility key a request will be scheduled under —
    the SAME encoding `_make_job` assigns (built on `_parse_rollout`,
    defaults included). The failover drills aim worker-targeted kills
    at a bucket's placed owner (`serve.smoke --multiworker`); this is
    the one helper
    they and the service share, so the drills can never drift from the
    scheduler's own bucketing. Raises ValueError for params the
    service would refuse."""
    if kind == "rollout":
        return _bucket_from_spec(_parse_rollout(params))
    if kind == "scenario":
        return _bucket_from_spec(
            _parse_rollout(_scenario_to_rollout(params)))
    return ("single", kind)


def _rollout_problem(spec: _RolloutSpec, device, dtype):
    """Seeded problem construction on ``device`` in ``dtype``: the circle
    formation and complete graph unless the request shipped explicit
    arrays; the initial cloud from the request seed. Deterministic from
    the spec alone — what makes crash re-execution and resume proofs
    possible. The default formation, safety parameters, empty fault
    schedule and inert scenario come from `serve.staging`'s caches (same
    inputs, same ops: bit-identical values)."""
    from aclswarm_torch import sim
    from aclswarm_torch.core.types import ControlGains, make_formation
    from aclswarm_torch.faults import schedule as faultlib

    n = spec.n
    if (spec.points is None and spec.adjmat is None
            and spec.gains is None):
        form = stagelib.cached_default_formation(n, dtype, device)
    else:
        if spec.points is not None:
            pts = np.asarray(spec.points, float)
        else:
            ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
            pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                            np.full(n, 2.0)], 1)
        adj = (np.asarray(spec.adjmat, float) if spec.adjmat is not None
               else np.ones((n, n)) - np.eye(n))
        gains = (np.asarray(spec.gains, float) if spec.gains is not None
                 else np.eye(n)[:, :, None, None] * np.eye(3)[None, None]
                 * 0.01)
        form = make_formation(pts, adj, gains, device=device, dtype=dtype)
    sparams = stagelib.cached_sparams(dtype, device)
    rng = np.random.default_rng(spec.seed)
    q0 = rng.normal(size=(n, 3)) * 2.0 + [0, 0, 2.0]
    # every serve rollout carries a FaultSchedule (no_faults when the
    # request scripts none): ONE container structure per bucket, so
    # faulted and fault-free requests stack into the same batch —
    # no_faults is bit-identical to faults=None
    if spec.faults_spec is not None:
        fs = faultlib.sample_schedule(spec.seed, n, device=device,
                                      dtype=dtype, **spec.faults_spec)
    else:
        fs = stagelib.cached_no_faults(n, dtype, device)
    # ... and a Scenario (no_scenario when the request scripts none),
    # the same normalization one axis up
    if spec.scenario_spec is not None:
        from aclswarm_torch.scenarios import registry as scenreg
        ss = spec.scenario_spec
        # the horizon defaults to the REQUEST's own tick count, so the
        # family's event fractions land inside the rollout being served
        scen = scenreg.sample(
            str(ss["family"]), int(ss.get("seed", spec.seed)), n,
            dtype=dtype, device=device,
            horizon=int(ss.get("horizon",
                               spec.n_chunks * spec.chunk_ticks)),
            params=ss.get("params"))
    else:
        scen = stagelib.cached_no_scenario(n, dtype, device)
    state = stagelib.init_row(
        torch.as_tensor(q0, dtype=dtype).to(device), fs, scen)
    cfg = sim.SimConfig(assignment=spec.assignment,
                        assign_every=spec.assign_every)
    return state, form, ControlGains(), sparams, cfg


# ---------------------------------------------------------------------------
# journal frames (atomic, codec-framed — no pickle)

def _write_frame(path: Path, payload, manifest: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(ckptlib.dumps(payload, manifest))
    os.replace(tmp, path)


def _read_frame(path: Path):
    return ckptlib.loads(path.read_bytes(), path)


# incarnation fence (the reference's process mode writes it): one
# codec frame in the journal dir naming the minimum incarnation allowed
# to write there
FENCE_NAME = "FENCE"


def write_fence(journal_dir, incarnation: int) -> None:
    """Stamp ``journal_dir`` as owned by ``incarnation`` (atomic codec
    frame). The SUCCESSOR writes this before it recovers the journal:
    a predecessor process that missed its lease but is still running
    observes the fence within `SwarmService.FENCE_CHECK_S` and every
    later journal write from it becomes a loud no-op — the
    declare-dead→respawn sequence never waits on the zombie actually
    exiting."""
    _write_frame(Path(journal_dir) / FENCE_NAME, {},
                 ckptlib.make_manifest("serve_fence", "-", 0, "-",
                                       incarnation=int(incarnation)))


def read_fence(journal_dir) -> Optional[int]:
    """The incarnation currently fencing ``journal_dir`` (None when
    unfenced or unreadable — an unreadable fence fails OPEN: refusing
    writes on a torn fence would turn a crash mid-`write_fence` into a
    permanently wedged slot)."""
    path = Path(journal_dir) / FENCE_NAME
    try:
        if not path.is_file():
            return None
        _, man = _read_frame(path)
    except (OSError, ckptlib.CheckpointError):
        return None
    inc = man.get("incarnation")
    return int(inc) if inc is not None else None


class SwarmService:
    """The in-process serving front end + device workers.

    Lifecycle::

        svc = SwarmService(ServiceConfig(journal_dir=...))
        t = svc.submit("rollout", {"n": 5, "ticks": 100}, tenant="a",
                       deadline_s=30.0)
        for ev in t.stream(): ...          # per-chunk progress
        res = t.result(timeout=60)         # value OR structured error
        svc.close()                        # drain, then stop — clean
                                           # shutdown once all tenants idle

    ``start=False`` builds the service without launching the worker
    (admission-control tests and staged recovery drills)."""

    def __init__(self, cfg: ServiceConfig = ServiceConfig(), *,
                 start: bool = True, log=None):
        if cfg.cpu_fallback:
            raise NotImplementedError(
                "ServiceConfig(cpu_fallback=True): the port never re-runs "
                "a chunk on the CPU; a chunk whose retries are spent "
                "fails its requests with execution_failed")
        if cfg.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                             f"{cfg.dtype!r}")
        self.cfg = cfg
        # the service's one device (None = the card; raises without one)
        self.device = resolve_device(cfg.device)
        self.dtype = DTYPES[cfg.dtype]
        self.log = log or logging.getLogger("aclswarm_torch.serve")
        self._adm = AdmissionControl(cfg.max_queue_per_tenant,
                                     cfg.max_queue_total)
        self._execu = ChunkExecutor(
            policy=RetryPolicy(attempts=cfg.retry_attempts, base_s=0.2,
                               max_s=5.0), log=self.log)
        self._kinds: dict[str, Callable[[dict], Any]] = {}
        # a PRIVATE registry per service: a crashed service and its
        # reference run in one process must not mix their ledgers.
        # Created before _recover(): recovery re-admissions and replayed
        # terminal results count like live traffic. (And before _lock,
        # which feeds its hold/wait histograms into it.)
        self.telemetry = MetricsRegistry()
        self._jobs: dict[str, _Job] = {}           # guarded-by: _lock
        self._done_prior: dict[str, Result] = {}   # guarded-by: _lock
        self._lock = OrderedLock("serve.service", registry=self.telemetry)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._closed = False          # guarded-by: _lock
        self._round = 0
        self.stats = {"accepted": 0, "completed": 0, "rejected": 0,
                      "preempted": 0, "timed_out": 0, "failed": 0,
                      "resumed": 0, "chunks": 0, "rounds": 0,
                      "workers": max(1, cfg.workers), "failovers": 0,
                      "requeued": 0, "poisoned": 0, "cancelled": 0}
        self._journal = Path(cfg.journal_dir) if cfg.journal_dir else None
        self._ckpt_dir = (self._journal / "ckpt"
                          if self._journal is not None else None)
        # the lifecycle stream shares the journal's events.log with the
        # worker ledger (one torn-tail-tolerant frame log, one reader),
        # and the span ring is armed to flush on
        # SIGTERM/atexit/worker-death so the last ~N spans survive a
        # crash (`telemetry.spans.install_crash_dump`)
        self._trace: Optional[LifecycleLog] = None
        self._span_dump = None
        # incarnation fence (process mode): checked before every journal
        # write, cached between FENCE_CHECK_S re-stats so the hot path
        # pays one monotonic read, not a stat per frame
        self._fence_path = (self._journal / FENCE_NAME
                            if self._journal is not None else None)
        self._fence_next = 0.0
        self._fence_lost = False
        # the scrape surface reports the process identity alongside the
        # fleet gauges
        self.telemetry.gauge("serve_pid").set(os.getpid())
        self.telemetry.gauge("serve_incarnation").set(cfg.incarnation)
        if self._journal is not None:
            self._journal.mkdir(parents=True, exist_ok=True)
            if not self._fence_ok():
                raise RuntimeError(
                    f"journal {self._journal} is fenced by a newer "
                    f"incarnation than {cfg.incarnation} — refusing to "
                    "recover a journal this process no longer owns")
            self._trace = LifecycleLog(self._journal / "events.log",
                                       log=self.log)
            self._span_dump = install_crash_dump(
                self.telemetry.recorder,
                self._journal / "spans_dump.jsonl", log=self.log)
            self._recover()
        # the worker fleet (serve.workers): N supervised device workers
        # with heartbeat/lease failover — worker death is routine, not
        # a service outage
        from aclswarm_torch.serve.workers import WorkerPool
        self._pool = WorkerPool(self, cfg)
        # the health tier: built after the pool so the probe can read
        # fleet liveness; alerts ride the journal's events.log (always
        # journaled, _LEDGER_EVENTS), so the live surface and the
        # postmortem share one stream
        self.watch = None
        if cfg.watch:
            from aclswarm_torch.telemetry.slo import SwarmWatch, default_slos
            specs = (list(cfg.slos) if cfg.slos is not None
                     else default_slos(max_queue_total=cfg.max_queue_total))
            self.watch = SwarmWatch(
                self.telemetry, specs,
                interval_s=cfg.watch_interval_s,
                capacity=cfg.watch_capacity,
                persist_path=(self._journal / "timeseries.log"
                              if self._journal is not None else None),
                emit=self._emit_alert, probe=self._watch_probe,
                log=self.log)
        if start:
            self.start()

    # ------------------------------------------------------------ clients

    def register(self, kind: str, fn: Callable[[dict], Any]) -> None:
        """Install an extension request kind (``fn(params) -> value``,
        executed on the worker under the retry/degrade executor).
        `bench.py` and the suites register their measurements here."""
        if kind in BUILTIN_KINDS:
            raise ValueError(f"kind {kind!r} is built in")
        self._kinds[kind] = fn

    def submit(self, kind: str, params: dict, *, tenant: str = "default",
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> Ticket:
        """Admit one request. Returns the `Ticket` the service now owes
        a terminal result on; raises `RejectedError` (backpressure /
        shutdown) or `ValueError` (malformed request) WITHOUT accepting.

        ``request_id`` is the idempotency key: re-submitting an id the
        service has seen (this process, or this journal — including
        already-terminal requests from before a crash) returns the
        existing ticket and never enqueues duplicate work.

        ``trace_id`` is the swarmtrace causal id: callers that already
        hold one (the wire client mints at its end of the pipe) pass it
        through; otherwise one is minted here — either way the id rides
        the journal acceptance frame, every checkpoint manifest, every
        lifecycle event, and the terminal `Result`."""
        if deadline_s is None:
            deadline_s = self.cfg.default_deadline_s
        rid = request_id or uuid.uuid4().hex[:12]
        req = Request(kind=kind, params=params, tenant=tenant,
                      request_id=rid, deadline_s=deadline_s,
                      t_submit=time.time(),
                      trace_id=trace_id or mint_trace_id())
        with self._lock:
            # idempotency first: re-submitting a known id must return
            # the existing ticket even while the service is draining
            if request_id is not None:
                if request_id in self._jobs:
                    return self._jobs[request_id].ticket
                prior = self._done_prior.get(request_id)
                if prior is not None:
                    t = Ticket(request_id)
                    t._resolve(prior)
                    return t
            if self._stop.is_set() or self._draining.is_set():
                raise RejectedError(E_SHUTDOWN, 0.0)
            job = self._make_job(req)      # validates; ValueError = refuse
            # the id reservation shares the duplicate check's lock: two
            # racing submits with one request_id cannot both build jobs
            # — the loser attaches to THIS ticket above
            self._jobs[rid] = job
        journaled = False      # acceptance events on disk -> the error
        #                        path owes the timeline a terminal record
        try:
            # caps-then-durable-then-prepped-then-runnable: admission
            # HOLDS a caps slot (picker-invisible) before the journal
            # frame is written, so rejected work is never journaled —
            # not even transiently (a crash between frame and rejection
            # cannot resurrect refused work) — the frame (the
            # acceptance promise) is durable before a worker that might
            # crash mid-chunk can run the job, and (with staging) the
            # request's batch-layout row is BUILT here at submit so
            # round-time pack is an index shuffle, never problem
            # construction (serve.staging)
            self._adm.admit(job, hold=True)
            if self._journal is not None:
                if not self._fence_ok():
                    # a fenced process must not take NEW acceptance
                    # promises: its journal frames would be invisible
                    # to the incarnation that owns the dir now, which
                    # is exactly a silent loss
                    raise RejectedError(E_SHUTDOWN, 0.0)
                _write_frame(
                    self._req_path(rid), {"params": params},
                    ckptlib.make_manifest(
                        "serve_req", ckptlib.config_hash(params), 0, "-",
                        request_id=rid, tenant=tenant, req_kind=kind,
                        deadline_s=deadline_s, t_submit=req.t_submit,
                        incarnation=self.cfg.incarnation,
                        trace_id=req.trace_id))
                # the acceptance events land BEFORE the job becomes
                # pickable: a fast worker's `batched` record must never
                # precede `submitted` in the causal file order
                journaled = True
                self._journal_event("submitted", job, kind=kind,
                                    tenant=tenant, deadline_s=deadline_s,
                                    t_submit=req.t_submit)
                self._journal_event("admitted", job,
                                    queue_depth=self._adm.pending())
            if self.cfg.staging and job.spec is not None:
                # submit-time prep: the initial SimState row + problem
                # pieces, cached per shape. A prep failure is NOT an
                # admission failure — the worker-side build path
                # (`_ensure_state`) keeps legacy failure semantics for
                # pathological params, so fall back silently here.
                try:
                    state, form, cgains, sparams, cfg2 = \
                        _rollout_problem(job.spec, self.device, self.dtype)
                    job.state = state
                    job._problem = (form, cgains, sparams, cfg2)
                except Exception:       # noqa: BLE001 — worker rebuilds
                    job.state = None
                    job._problem = None
            self._adm.release(job)
        except BaseException as e:
            rejected = isinstance(e, RejectedError)
            with self._lock:
                self._jobs.pop(rid, None)
                if rejected:
                    self.stats["rejected"] += 1
                # atomic terminal reservation (shared with _finish): if
                # release() raised after the job turned pickable, a
                # worker may race this cleanup — first claimant wins
                already = job.finished
                job.finished = True
            if rejected:
                # admission ledger + the backpressure hints handed out
                self.telemetry.counter("serve_rejected_total").inc()
                self.telemetry.histogram("serve_retry_after_s").observe(
                    e.retry_after_s)
            self._adm.cancel(job)
            self._sample_queue()
            if journaled and not already:
                # the acceptance events are already on disk: without a
                # terminal record this request reconstructs as a
                # journaled loss. Close the timeline BEFORE the frame
                # unlink below retracts the acceptance promise.
                self._journal_event(
                    "resolved", job, status=FAILED, chunks=0,
                    error_code=E_QUEUE_FULL if rejected else E_EXECUTION)
            if self._journal is not None and not self._fence_lost:
                # fenced submits raised BEFORE writing their frame —
                # unlinking here would delete a frame the successor
                # incarnation may have journaled under the same rid
                self._req_path(rid).unlink(missing_ok=True)
            # a duplicate submit that attached during the reservation
            # window holds this ticket: resolve it so it can never
            # dangle (the primary caller sees the raised error)
            if not already:
                job.ticket._resolve(Result(
                    request_id=rid, status=FAILED,
                    error=ServeError(
                        E_QUEUE_FULL if rejected else E_EXECUTION,
                        f"submit failed before acceptance: {e}")))
            raise
        with self._lock:
            self.stats["accepted"] += 1
            orphaned = self._closed
        self.telemetry.counter("serve_accepted_total").inc()
        self._sample_queue()   # depth is fresh the moment work exists —
        #                        not at some future chunk boundary
        if orphaned:
            # close() raced this submit and its cleanup sweep already
            # ran: nobody is left to schedule the job, so honor the
            # acceptance promise HERE with a structured error instead of
            # leaving a ticket that never resolves (the frame stays
            # un-done for a later recovery)
            self._finish(job, FAILED,
                         error=ServeError(E_SHUTDOWN,
                                          "service closed while this "
                                          "request was being accepted"),
                         journal=False)
        return job.ticket

    def result(self, ticket: Ticket, timeout: Optional[float] = None
               ) -> Result:
        return ticket.result(timeout)

    def start(self) -> None:
        """Launch the worker fleet (no-op if already started). Split
        from __init__ for admission-control tests and staged recovery
        drills (``start=False``)."""
        self._pool.start()
        if self.watch is not None:
            # after the fleet: the first sample must see live
            # worker_up gauges, not a pre-spawn fleet of zeros
            self.watch.start()

    @property
    def alive(self) -> bool:
        """True while the service can still make progress: at least one
        worker thread is alive, OR the supervisor is (it can respawn a
        dead worker after its rejoin backoff — a worker death is a
        FAILOVER, not an outage). False after a clean exit, or once the
        whole fleet is circuit-open/dead — clients waiting without a
        timeout should poll this instead of blocking forever on a
        ticket nobody will resolve (journal recovery is how such
        tickets get honored)."""
        return self._pool.any_alive()

    def close(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the service. ``drain=True`` (the clean shutdown): refuse
        new work, run every accepted request to a terminal result, then
        stop once all tenants are idle. ``drain=False``: stop after the
        current round; still-queued requests resolve with a structured
        ``service_shutdown`` error (their journal frames stay un-done,
        so a later recovery can still honor them).

        A drain that cannot finish within ``timeout`` is NOT silent: it
        is logged loudly (with the count of requests it abandons) and
        the abandoned tickets resolve with a structured error naming
        the drain timeout — the promise is downgraded audibly, never
        dropped."""
        self._draining.set()
        if not drain:
            self._stop.set()
        self._adm.wake()
        drain_timed_out = False
        if self._pool.started and self._pool.any_alive():
            self._pool.join(timeout)
            drain_timed_out = drain and self._pool.any_alive()
        self._stop.set()
        if drain_timed_out:
            err = ServeError(
                E_SHUTDOWN,
                f"close(drain=True) abandoned the drain after {timeout:g}"
                " s with this request still in flight (journal frame "
                "stays un-done for recovery)")
        else:
            err = ServeError(E_SHUTDOWN, "service closed before this "
                                         "request was scheduled")
        with self._lock:
            # ordering handshake with submit(): a submit that inserts
            # its job after this flag flips resolves it itself
            self._closed = True
            pending = [j for j in self._jobs.values() if not j.finished]
        if drain_timed_out:
            self.log.error(
                "close(drain=True): worker still busy after the %g s "
                "join — resolving %d still-pending request(s) with a "
                "structured %s error; results the worker still produces "
                "are discarded by the finish once-guard",
                timeout, len(pending), E_SHUTDOWN)
        for job in pending:
            self._finish(job, FAILED, error=err, journal=False)
        if self.watch is not None:
            # before the trace log closes: the sampler's final tick
            # covers the shutdown edge, and a last alert transition
            # still lands in events.log
            self.watch.stop()
        if self._span_dump is not None:
            # clean close: final flush, then disarm the atexit/SIGTERM
            # hooks so long-lived test processes don't accumulate them
            self._span_dump.dump("close")
            self._span_dump.uninstall()
        if self._trace is not None:
            self._trace.close()

    # --------------------------------------------------------- internals

    def _make_job(self, req: Request) -> _Job:
        if req.kind in ("rollout", "scenario"):
            spec = _parse_rollout(
                _scenario_to_rollout(req.params)
                if req.kind == "scenario" else req.params)
            job = _Job(req=req, ticket=Ticket(req.request_id),
                       bucket=_bucket_from_spec(spec),
                       spec=spec, chunks_total=spec.n_chunks)
        elif req.kind in BUILTIN_KINDS or req.kind in self._kinds:
            job = _Job(req=req, ticket=Ticket(req.request_id),
                       bucket=("single", req.kind), chunks_total=1)
        else:
            raise ValueError(f"unknown request kind {req.kind!r} "
                             f"(builtin: {BUILTIN_KINDS}, registered: "
                             f"{sorted(self._kinds)})")
        job.t_accept = time.monotonic()
        return job

    def _req_path(self, rid: str) -> Path:
        assert self._journal is not None
        return self._journal / f"req_{rid}.req"

    def _done_path(self, rid: str) -> Path:
        assert self._journal is not None
        return self._journal / f"req_{rid}.done"

    # ------------------------------------------------- incarnation fence

    FENCE_CHECK_S = 0.05    # max fence-observation latency (re-stat gap)

    def _fence_ok(self) -> bool:
        """True while this process still owns its journal. Process mode:
        a successor incarnation fences the shared per-slot journal dir
        (`write_fence`) before recovering it; this predecessor — a
        zombie that missed its lease but never exited — sees the fence
        within ``FENCE_CHECK_S`` and every subsequent journal write
        no-ops LOUDLY. Stamped frames plus this check are what make
        "declare dead on connection death" safe without waiting for
        the process to actually die. Thread mode never writes a fence,
        so the check stays a cached no-op."""
        if self._fence_path is None:
            return True
        if self._fence_lost:
            return False
        now = time.monotonic()
        if now < self._fence_next:
            return True
        self._fence_next = now + self.FENCE_CHECK_S
        fence = read_fence(self._journal)
        if fence is not None and fence > int(self.cfg.incarnation):
            self._fence_lost = True
            self.telemetry.counter("serve_fenced_total").inc()
            self.log.error(
                "journal FENCE: incarnation %d owns %s now (this "
                "process is incarnation %d) — every further journal "
                "write from this process is a no-op",
                fence, self._journal, self.cfg.incarnation)
            return False
        return True

    # ------------------------------------------------------- worker rounds
    #
    # The worker LOOP lives in `serve.workers.WorkerPool` (pick, exit
    # conditions, heartbeat, InjectedCrash handling, in-flight
    # bookkeeping); the round EXECUTION lives here with the rest of the
    # request state machine. Every per-job mutation is guarded by the
    # (job, epoch-at-pick) pairs the pool hands in: a fenced zombie
    # worker whose jobs were failed over observes a bumped epoch and
    # touches nothing.
    #
    # A round is SPLIT into two phases so the worker loop can
    # double-buffer: `_round_start` gates
    # + packs + dispatches (async — the device starts immediately), and
    # `_round_finish` syncs + unpacks + resolves. With
    # ``cfg.pipeline=True`` the pool starts round k+1 before finishing
    # round k, so the host's pack/resolve work overlaps the device's
    # chunk compute; otherwise the phases run back to back.

    def _round_start(self, pairs: list, worker,
                     busy_ids: frozenset = frozenset()
                     ) -> Optional["_PendingRound"]:
        """Phase 1 of one scheduler round: crash hooks, then the
        bucket-appropriate execution. Returns a `_PendingRound` when
        the round's device work was dispatched asynchronously (staged
        rollout buckets) — the caller owes a `_round_finish`. Returns
        None when the round already completed (single-shot kinds, the
        legacy pack-at-round-time path, an all-gated-out batch, or
        ``pipeline=False``). ``busy_ids`` are ids of jobs mid-flight in
        the caller's still-pending round: their staging rows are
        neither consistent nor evictable until that round resolves."""
        jobs = [j for j, _ in pairs]
        with self._lock:
            self._round += 1
            grnd = self._round
            self.stats["rounds"] = self._round
        # the scripted-crash hooks: the process-level site ("serve",
        # global round — the process-kill drills) and the worker-
        # targeted site ("serve.w{slot}", the slot's cumulative round —
        # the single-worker failover drills). Both fire HERE, with the
        # batch picked and registered in-flight: exactly what a killed
        # worker leaves behind.
        maybe_crash(CRASH_SITE, grnd)
        from aclswarm_torch.serve.workers import WORKER_SITE
        maybe_crash(WORKER_SITE.format(slot=worker.slot), worker.round)
        if jobs[0].bucket[0] != "rollout" or not self.cfg.staging:
            with self.telemetry.span("serve.round", round=grnd,
                                     worker=worker.slot,
                                     bucket=str(jobs[0].bucket[0]),
                                     batch=len(jobs)):
                if jobs[0].bucket[0] == "rollout":
                    self._rollout_round(pairs, worker)
                else:
                    for job, epoch in pairs:
                        self._single(job, epoch, worker)
            return None
        pending = self._rollout_round_start(pairs, worker, grnd,
                                            busy_ids)
        if pending is not None and not self.cfg.pipeline:
            self._round_finish(pending, worker)
            return None
        return pending

    def _fail_round(self, pairs: list, exc: BaseException) -> None:
        """A round-level bug must not wedge the service: every job of
        the round terminates with structured evidence."""
        err = ServeError(E_EXECUTION,
                         f"{type(exc).__name__}: {exc}",
                         detail=self._execu.row_fields() or None)
        for job, _ in pairs:
            if not job.ticket.done:
                self._finish(job, FAILED, error=err)

    def _stale(self, job: _Job, epoch: int) -> bool:
        """True when this residency no longer owns the job (finished by
        a racing path, or failed over to another worker)."""
        with self._lock:
            return job.finished or job.epoch != epoch

    # -------------------------------------------------- rollout batching

    def _ensure_state(self, job: _Job, epoch: Optional[int] = None
                      ) -> None:
        """Materialize the resident carry: fresh problem at chunk 0, or
        a template-validated restore of the preemption/crash checkpoint
        (THE checkpoint-backed path — restore goes through the codec
        even for in-memory preemption)."""
        if job.state is not None:
            return
        state, form, cgains, sparams, cfg = _rollout_problem(
            job.spec, self.device, self.dtype)
        job._problem = (form, cgains, sparams, cfg)
        frame = None
        if job._ckpt_bytes is not None:
            # NOT consumed: the frame stays until a newer checkpoint
            # overwrites it (or the job terminates). A staged job that
            # is failed over again BEFORE its next chunk resolves has
            # no resident state to serialize — this frame is then still
            # the authoritative state@chunks_done, and dropping it here
            # would turn that second failover into a silent restart
            # (caught once, the hard way: the exoneration drill's
            # double-kill).
            frame = ckptlib.loads(job._ckpt_bytes,
                                  f"<mem:{job.req.request_id}>")
        elif self._ckpt_dir is not None:
            path = ckptlib.latest_checkpoint(self._ckpt_dir,
                                             self._stem(job))
            if path is not None:
                frame = ckptlib.load_checkpoint(
                    path, expected=ckptlib.expected_manifest(
                        "serve_rollout",
                        ckptlib.config_hash(job.req.params),
                        self._fingerprint(),
                        request_id=job.req.request_id))
        if frame is not None:
            payload, man = frame
            job.state = ckptlib.restore_tree(state, payload["state"],
                                             path=self._stem(job),
                                             what="SimState")
            job.chunks_done = int(man["chunk"])
            job.crc = int(payload["crc"])
            job.chunk_digests = [int(d) for d in payload["chunk_digests"]]
            job.preemptions = int(payload["preemptions"])
            if epoch is not None:
                self._journal_event_owned("resumed", job, epoch,
                                          from_chunk=job.chunks_done,
                                          preemptions=job.preemptions)
            else:
                self._journal_event("resumed", job,
                                    from_chunk=job.chunks_done,
                                    preemptions=job.preemptions)
        else:
            if job.chunks_done > 0 and not job.finished:
                # a mid-flight job with NO checkpoint anywhere must
                # never silently restart from tick 0 under a stale
                # chunk counter — that is digest corruption, not
                # recovery. Fail the round loudly instead (the job
                # terminates with structured evidence via _fail_round).
                # A job that just RACED to terminal is exempt: its
                # fresh state is never read (epoch/finished guards).
                raise RuntimeError(
                    f"request {job.req.request_id} is at chunk "
                    f"{job.chunks_done}/{job.chunks_total} but no "
                    "checkpoint frame exists (memory or disk) — "
                    "refusing a silent restart-from-zero")
            job.state = state

    def _stem(self, job: _Job) -> str:
        return f"req_{job.req.request_id}"

    def _fingerprint(self) -> str:
        """The dtype and device a rollout checkpoint was computed in: a
        float32 card checkpoint must not resume a float64 CPU run."""
        return ckptlib.dtype_fingerprint(self.dtype, self.device)

    def _checkpoint(self, job: _Job, to_disk: bool, state=None) -> None:
        payload = {"state": ckptlib.tree_arrays(
                       job.state if state is None else state),
                   "crc": int(job.crc),
                   "chunk_digests": [int(d) for d in job.chunk_digests],
                   "preemptions": int(job.preemptions)}
        man = ckptlib.make_manifest(
            "serve_rollout", ckptlib.config_hash(job.req.params),
            job.chunks_done, self._fingerprint(),
            request_id=job.req.request_id, trace_id=job.req.trace_id)
        if to_disk:
            assert self._ckpt_dir is not None
            if not self._fence_ok():
                # a zombie's checkpoint would race the successor's
                # resume of the same request — skip the disk write
                # (the in-memory copy below is process-local and safe)
                self.telemetry.counter("serve_fenced_writes_total").inc()
            else:
                ckptlib.write_checkpoint(self._ckpt_dir, self._stem(job),
                                         payload, man)
        else:
            job._ckpt_bytes = ckptlib.dumps(payload, man)
        self._journal_event("checkpointed", job, chunk=job.chunks_done,
                            durable=bool(to_disk))

    def _rollout_round(self, pairs: list, worker) -> None:
        """One chunk for one shape bucket: deadline/cancel gate ->
        restore -> pad to the power-of-two batch -> ONE `batched_rollout`
        launch -> unstack, stream, checkpoint, then
        complete/preempt/requeue. Every mutation is epoch-guarded: a
        job failed over mid-round (this worker fenced as a zombie) is
        skipped entirely — the new owner's restored state is
        authoritative."""
        from aclswarm_torch import sim
        from aclswarm_torch.core import types

        # stage spans: the serve.round parent is split into
        # pack/stack/dispatch/device-sync/unpack/resolve children, each
        # feeding its span_serve.round.<stage>_s histogram
        span = self.telemetry.span
        wat = {"worker": worker.slot}
        with span("serve.round.pack", **wat):
            live, epochs = [], {}
            for job, epoch in pairs:
                if self._stale(job, epoch):
                    continue
                if self._expired(job):
                    self._timeout(job)
                elif job.cancelled is not None:
                    self._cancel_at_boundary(job)
                else:
                    live.append(job)
                    epochs[id(job)] = epoch
            for job in live:
                self._journal_event_owned(
                    "batched", job, epochs[id(job)], worker=worker.slot,
                    round=worker.round, batch=len(live),
                    bucket=str(job.bucket[0]), chunk=job.chunks_done)
                self._ensure_state(job, epochs[id(job)])
                job.status = RUNNING
                if job.t_first_run is None:
                    job.t_first_run = time.monotonic()
        if not live:
            return
        with span("serve.round.stack", **wat):
            form, cgains, sparams, cfg = live[0]._problem
            chunk = live[0].spec.chunk_ticks
            B = len(live)
            P = stagelib.pow2(B)
            idx = list(range(B)) + [0] * (P - B)   # pow-2 pad: bounded
            bstate = sim.stack_states([live[i].state for i in idx])
            bform = types.stack([live[i]._problem[0] for i in idx])
        t0 = time.monotonic()
        with span("serve.round.dispatch", **wat):
            bstate, metrics = self._execu.run(
                lambda: sim.batched_rollout(bstate, bform, cgains, sparams,
                                            cfg, chunk, None, 0),
                stage=f"serve:w{worker.slot}:round{self._round}")
        with span("serve.round.device_sync", **wat):
            q_all = metrics.q.cpu().numpy()    # (T, P, n, 3): the host read
        with span("serve.round.unpack", **wat):
            done_live = []
            for i, job in enumerate(live):
                qb = np.ascontiguousarray(q_all[:, i])
                # stale-check AND mutations share one lock hold: a
                # lease-lapse failover landing between an unlocked check
                # and these writes would let this (now-zombie) residency
                # repopulate job.state after the supervisor nulled it —
                # the next residency would then skip its restore and run
                # with _problem=None
                with self._lock:
                    if job.finished or job.epoch != epochs[id(job)]:
                        continue       # failed over mid-launch: zombie
                    job.state = sim.trial(bstate, i)
                    job.crc = zlib.crc32(qb.tobytes(), job.crc) & 0xFFFFFFFF
                    job.chunk_digests.append(job.crc)
                    job.chunks_done += 1
                    job.run_chunks += 1
                    if job.suspect:
                        # EXONERATED: it survived a (solo, by the
                        # quarantine pick rule) chunk — the kill it
                        # witnessed was not its doing, and the kill ledger
                        # resets with it so only a job that KEEPS killing
                        # workers can ever accumulate to the poison bound
                        job.suspect = False
                        job.solo_kills = 0
                        job.excluded_workers.clear()
                    done_live.append(job)
                    ev = ChunkEvent(
                        job.req.request_id, job.chunks_done - 1,
                        {"chunk": job.chunks_done - 1,
                         "tick_end": job.chunks_done * chunk,
                         "digest": job.crc,
                         "batch": B,
                         "worker": worker.slot,
                         "trace_id": job.req.trace_id})
                    # the chunk record lands under the same lock hold as
                    # the digest update: a concurrent failover can never
                    # journal a migration of this chunk BEFORE the chunk
                    # itself exists in the stream (causal file order)
                    self._journal_event(
                        "chunk", job, k=job.chunks_done - 1,
                        digest=int(job.crc), worker=worker.slot,
                        round=worker.round,
                        tick_end=job.chunks_done * chunk)
                job.ticket._push(ev)
            with self._lock:
                self.stats["chunks"] += len(done_live)
            dev_s = time.monotonic() - t0
            self._adm.note_service(dev_s / max(1, B))
            self._attribute_device(done_live, dev_s)
            self._sample_boundary(len(done_live), worker)

        with span("serve.round.resolve", **wat):
            self._resolve_round(done_live, epochs, chunk)

    def _resolve_round(self, done_live: list, epochs: dict,
                       chunk: int) -> None:
        """Post-chunk request state machine: complete / deadline /
        cancel / preempt / checkpoint / requeue, per job."""
        for job in done_live:
            # snapshot under the lock: a concurrent failover (fenced
            # zombie scenario) may null job.state the instant after —
            # this residency then finishes/checkpoints from ITS
            # consistent snapshot, and the once-guard/epoch checks
            # arbitrate who wins
            with self._lock:
                if job.finished or job.epoch != epochs[id(job)]:
                    continue
                state_ref = job.state
            if job.chunks_done >= job.chunks_total:
                q_final = np.array(state_ref.swarm.q.cpu())
                self._finish(job, COMPLETED, value={
                    "q": q_final,
                    "ticks": job.chunks_done * chunk,
                    "digest": int(job.crc),
                    "chunk_digests": [int(d) for d in job.chunk_digests]})
                if self._ckpt_dir is not None:
                    ckptlib.clear_checkpoints(self._ckpt_dir,
                                              self._stem(job))
                continue
            if self._expired(job):
                self._timeout(job)
                continue
            if job.cancelled is not None:
                self._cancel_at_boundary(job)
                continue
            # checkpoint-backed preemption: a job past its quantum with
            # other work waiting is evicted through the codec; the next
            # residency restores it exactly. The count increments BEFORE
            # the frame is written — the frame is the job's authoritative
            # record across restores.
            preempt = (job.run_chunks >= self.cfg.quantum_chunks
                       and self._adm.pending_excluding(job) > 0)
            if preempt:
                job.preemptions += 1
                with self._lock:
                    self.stats["preempted"] += 1
                self.telemetry.counter("serve_preempted_total").inc()
                self._journal_event("preempted", job,
                                    chunk=job.chunks_done,
                                    run_chunks=job.run_chunks)
            # durability checkpoint every chunk when journaled: a
            # SIGKILL between rounds costs at most one chunk of work
            # (from the snapshot — job.state may be nulled by a
            # concurrent failover)
            if self._ckpt_dir is not None:
                self._checkpoint(job, to_disk=True, state=state_ref)
            elif preempt:
                self._checkpoint(job, to_disk=False, state=state_ref)
            # epoch guard AND the enqueue itself share one lock hold:
            # the failover supervisor serializes against this exact
            # section (its contains-check + requeue also run under
            # _lock), so a job can never be enqueued twice by a
            # boundary requeue racing a lease-lapse failover
            with self._lock:
                if job.finished or job.epoch != epochs[id(job)]:
                    continue           # failed over while checkpointing
                if preempt:
                    job.state = None
                    job._problem = None
                    job.status = PREEMPTED
                    job.run_chunks = 0
                else:
                    job.status = QUEUED
                job.worker = None
                # journaled before the job becomes pickable (same lock
                # hold): the next residency's `batched` record must
                # follow this `queued` in the causal file order
                self._journal_event(
                    "queued", job,
                    reason="preempt" if preempt else "boundary")
                self._adm.requeue(job)

    # ------------------------------------- staged rounds (serve.staging)
    #
    # The device-bound round: requests were prepped into rows at
    # submit; pack writes newcomers into the bucket's staging store (in
    # place), the batch is ONE gather of the live slots, the rollout,
    # the scatter-back and the start of the round's one host copy are
    # all issued without a host sync, and `_round_finish` blocks exactly
    # once (the copy's event). Staging-store mutations happen ONLY on
    # the owning worker thread, under `_lock`, after re-checking the
    # fence flag — the supervisor reads rows under the same lock after
    # fencing, so a fenced zombie never writes a store another thread
    # is reading. One stream orders every device step in issue order.

    def _rollout_round_start(self, pairs: list, worker, grnd: int,
                             busy_ids: frozenset = frozenset()
                             ) -> Optional[_PendingRound]:
        from aclswarm_torch import sim

        span = self.telemetry.span
        wat = {"worker": worker.slot}
        attrs = {"round": grnd, "worker": worker.slot,
                 "bucket": "rollout", "batch": len(pairs)}
        t_phase = time.perf_counter()
        ok = False
        try:
            with span("serve.round.pack", **wat):
                live, epochs = [], {}
                for job, epoch in pairs:
                    if self._stale(job, epoch):
                        continue
                    if self._expired(job):
                        self._timeout(job)
                    elif job.cancelled is not None:
                        self._cancel_at_boundary(job)
                    else:
                        live.append(job)
                        epochs[id(job)] = epoch
                if not live:
                    return None
                st = worker.staging.get(live[0].bucket)
                if st is None:
                    st = worker.staging[live[0].bucket] = \
                        stagelib.BucketStaging()
                for job in live:
                    self._journal_event_owned(
                        "batched", job, epochs[id(job)],
                        worker=worker.slot, round=worker.round,
                        batch=len(live), bucket=str(job.bucket[0]),
                        chunk=job.chunks_done)
                    sref = job.staged
                    if sref is not None and sref[0] is not st:
                        # stranded in a dead incarnation's staging
                        # (boundary-queued at its death, so never
                        # failed over): its row is consistent — read
                        # it out under the lock, where no fenced owner
                        # can concurrently write the old store
                        with self._lock:
                            if worker.fenced:
                                raise _Fenced()
                            # re-read UNDER the lock: a failover or a
                            # terminal sweep may have nulled job.staged
                            # since the unlocked check above
                            sref = job.staged
                            if sref is not None and sref[0] is not st:
                                old, slot = sref
                                row_s, row_f = stagelib.take_row(
                                    old.store, slot)
                                job.state = row_s
                                job._problem = \
                                    (row_f,) + tuple(old.shared)
                                # the materialized row REPLACES the
                                # batch-shaped shadow (same chunk, one
                                # row pinned instead of a whole round
                                # output) — never cleared: the staging
                                # join below nulls job.state, and an
                                # unjournaled mid-flight failover
                                # after that must still find
                                # state@chunks_done somewhere
                                job._shadow = (row_s, None)
                                if old.slots[slot] is job:
                                    old.slots[slot] = None
                                job.staged = None
                    if job.staged is None and job.state is None:
                        self._ensure_state(job, epochs[id(job)])
                    job.status = RUNNING
                    if job.t_first_run is None:
                        job.t_first_run = time.monotonic()
                # staging admission: write every newcomer's row into
                # the store — one in-place write each, under the lock +
                # fence check (the staging concurrency contract).
                # Capacity is FIXED (2x the padded batch: one round in
                # flight + one being packed — see BucketStaging): a
                # full store EVICTS a non-busy resident back to its
                # per-job row instead of growing. live + busy <= cap
                # by construction, so a slot always frees up.
                with self._lock:
                    if worker.fenced:
                        raise _Fenced()
                    newcomers = [j for j in live
                                 if not (j.staged is not None
                                         and j.staged[0] is st)]
                    if newcomers and st.shared is None:
                        st.shared = tuple(newcomers[0]._problem[1:])
                    if newcomers:
                        if st.store is None:
                            st.create((newcomers[0].state,
                                       newcomers[0]._problem[0]),
                                      2 * stagelib.pow2(
                                          self.cfg.max_batch))
                        free = st.free_slots()
                        if len(free) < len(newcomers):
                            keep = {id(j) for j in live} | busy_ids
                            for slot, owner in enumerate(st.slots):
                                if len(free) >= len(newcomers):
                                    break
                                if owner is None or id(owner) in keep \
                                        or owner.finished:
                                    continue
                                # LRU-evict: the resident leaves the
                                # batch layout with its consistent row
                                # (it is neither live nor mid-flight)
                                # and re-stages on its next pick
                                row_s, row_f = stagelib.take_row(
                                    st.store, slot)
                                owner.state = row_s
                                owner._problem = \
                                    (row_f,) + tuple(st.shared)
                                # row-shadow, same reasoning as the
                                # stranded branch: replaces the
                                # batch-shaped shadow, never cleared
                                owner._shadow = (row_s, None)
                                owner.staged = None
                                st.slots[slot] = None
                                free.append(slot)
                        for job in newcomers:
                            slot = free.pop(0)
                            st.store = stagelib.write_row(
                                st.store, (job.state, job._problem[0]),
                                slot)
                            st.slots[slot] = job
                            job.staged = (st, slot)
                            job.state = None
                            job._problem = None
            with span("serve.round.stack", **wat):
                # the index shuffle: the round batch is one gather of
                # the live slots, padded to the same power-of-two batch
                # the pack-at-round-time path runs (same composition,
                # same rounding on the card). Slot
                # reads happen UNDER the lock after a fence re-check:
                # a lease-lapse failover nulls job.staged, and it can
                # only have done so after fencing this worker — so an
                # unfenced read is consistent, and a fenced one aborts
                # instead of dereferencing a migrated job's None.
                B = len(live)
                P = stagelib.pow2(B)
                rows = {id(j): i for i, j in enumerate(live)}
                with self._lock:
                    if worker.fenced:
                        raise _Fenced()
                    slot_list = [j.staged[1] for j in live]
                    idx = slot_list + [slot_list[0]] * (P - B)
                    batch_state, batch_form = stagelib.gather_rows(
                        st.store, tuple(idx))
            chunk = live[0].spec.chunk_ticks
            cgains, sparams, cfg = st.shared
            t0 = time.monotonic()
            with span("serve.round.dispatch", **wat):
                out, metrics = self._execu.run(
                    lambda: sim.batched_rollout(
                        batch_state, batch_form, cgains, sparams, cfg,
                        chunk, None, 0),
                    stage=f"serve:w{worker.slot}:round{grnd}")
                unpacked = stagelib.unpack_round(metrics.q, out.swarm.q)
                # scatter the live output rows back into the store in
                # place: the next round's gather reads the updated rows,
                # ordered after this round on the one stream
                with self._lock:
                    if worker.fenced:
                        raise _Fenced()
                    stagelib.scatter_rows(st.store[0], out, slot_list,
                                          list(range(B)))
            ok = True
            return _PendingRound(pairs=pairs, jobs=live, epochs=epochs,
                                 rows=rows, out=out, unpacked=unpacked,
                                 staging=st, chunk=chunk, B=B, P=P,
                                 t0=t0, grnd=grnd, wround=worker.round,
                                 span_attrs=attrs,
                                 start_dur=time.perf_counter() - t_phase)
        finally:
            if not ok:
                # aborted/empty round: the span is just this phase
                self._emit_round_span(
                    time.perf_counter() - t_phase, attrs,
                    error=sys.exc_info()[0] is not None)

    def _round_finish(self, pending: _PendingRound, worker,
                      busy: int = 0) -> None:
        """Phase 2 of a staged round: ONE blocking wait for the round's
        host copy (its only host sync), per-job digest/stream bookkeeping,
        then the request state machine. ``busy`` is the number of jobs
        the worker already dispatched into the NEXT (overlapping)
        round — they count as waiting work for the preemption trigger,
        exactly as they would still have been queued at this point on
        the unpipelined schedule."""
        span = self.telemetry.span
        wat = {"worker": worker.slot}
        t_phase = time.perf_counter()
        try:
            with span("serve.round.device_sync", **wat):
                host = pending.unpacked.get()
            q_chunks = host["q_chunks"]
            with span("serve.round.unpack", **wat):
                done_live = []
                for job in pending.jobs:
                    bi = pending.rows[id(job)]
                    qb = q_chunks[bi]      # request-major: contiguous
                    # stale-check AND mutations share one lock hold (the
                    # same fenced-zombie reasoning as the legacy path)
                    with self._lock:
                        if job.finished \
                                or job.epoch != pending.epochs[id(job)]:
                            continue       # failed over mid-flight
                        if self._ckpt_dir is None:
                            # in-memory failover shadow: the staging
                            # row advances at DISPATCH of the next
                            # round, so an in-flight job's consistent
                            # state@chunks_done must live somewhere a
                            # migration can serialize. LAZY — just a
                            # (batch, row) reference; `_failover_job`
                            # materializes it with one take_row only
                            # if a migration actually happens
                            # (journaled services skip this: the
                            # per-chunk disk frame is the source)
                            job._shadow = (pending.out, bi)
                        job.crc = zlib.crc32(qb.tobytes(),
                                             job.crc) & 0xFFFFFFFF
                        job.chunk_digests.append(job.crc)
                        job.chunks_done += 1
                        job.run_chunks += 1
                        if job.suspect:
                            # EXONERATED (see the legacy path)
                            job.suspect = False
                            job.solo_kills = 0
                            job.excluded_workers.clear()
                        done_live.append(job)
                        ev = ChunkEvent(
                            job.req.request_id, job.chunks_done - 1,
                            {"chunk": job.chunks_done - 1,
                             "tick_end": job.chunks_done * pending.chunk,
                             "digest": job.crc,
                             "batch": pending.B,
                             "worker": worker.slot,
                             "trace_id": job.req.trace_id})
                        self._journal_event(
                            "chunk", job, k=job.chunks_done - 1,
                            digest=int(job.crc), worker=worker.slot,
                            round=pending.wround,
                            tick_end=job.chunks_done * pending.chunk)
                    job.ticket._push(ev)
                with self._lock:
                    self.stats["chunks"] += len(done_live)
                # the round's device span (dispatch -> sync complete):
                # one wall window, attributed across the occupied rows
                dev_s = time.monotonic() - pending.t0
                self._adm.note_service(dev_s / max(1, pending.B))
                self._attribute_device(done_live, dev_s)
                self._sample_boundary(len(done_live), worker)
            with span("serve.round.resolve", **wat):
                self._resolve_round_staged(pending, done_live,
                                           host["q_final"], busy)
        finally:
            self._emit_round_span(
                pending.start_dur + (time.perf_counter() - t_phase),
                pending.span_attrs,
                error=sys.exc_info()[0] is not None)

    def _emit_round_span(self, dur_s: float, attrs: dict,
                         error: bool = False) -> None:
        """Record one ``serve.round`` span of the given duration (the
        two active phases of a pipelined round — see `_PendingRound.
        start_dur`), feeding the same recorder + histogram the span
        context manager would."""
        from aclswarm_torch.telemetry.spans import Span

        self.telemetry.recorder.record(Span(
            name="serve.round", t_wall=time.time(), dur_s=dur_s,
            attrs=dict(attrs, error=True) if error else dict(attrs)))
        self.telemetry.histogram("span_serve.round_s").observe(dur_s)

    def _resolve_round_staged(self, pending: _PendingRound,
                              done_live: list, q_final, busy: int
                              ) -> None:
        """Post-chunk request state machine for a staged round:
        complete / deadline / cancel / preempt / checkpoint / requeue.
        Durability checkpoints read from ONE host copy of the round's
        output (row views of it), not per-leaf per-job device slices."""
        from aclswarm_torch import sim
        from aclswarm_torch.core import types

        chunk = pending.chunk
        host_state = None

        def host_row(bi):
            # lazy: only rounds that actually checkpoint pay the
            # transfer, and they pay it once for the whole batch
            nonlocal host_state
            if host_state is None:
                host_state = types.tree_map(lambda x: x.cpu(), pending.out)
            return sim.trial(host_state, bi)

        for job in done_live:
            bi = pending.rows[id(job)]
            with self._lock:
                if job.finished or job.epoch != pending.epochs[id(job)]:
                    continue
            if job.chunks_done >= job.chunks_total:
                self._finish(job, COMPLETED, value={
                    "q": np.array(q_final[bi]),
                    "ticks": job.chunks_done * chunk,
                    "digest": int(job.crc),
                    "chunk_digests": [int(d) for d in job.chunk_digests]})
                if self._ckpt_dir is not None:
                    ckptlib.clear_checkpoints(self._ckpt_dir,
                                              self._stem(job))
                continue
            if self._expired(job):
                self._timeout(job)
                continue
            if job.cancelled is not None:
                self._cancel_at_boundary(job)
                continue
            preempt = (job.run_chunks >= self.cfg.quantum_chunks
                       and (busy > 0
                            or self._adm.pending_excluding(job) > 0))
            if preempt:
                job.preemptions += 1
                with self._lock:
                    self.stats["preempted"] += 1
                self.telemetry.counter("serve_preempted_total").inc()
                self._journal_event("preempted", job,
                                    chunk=job.chunks_done,
                                    run_chunks=job.run_chunks)
            if self._ckpt_dir is not None:
                self._checkpoint(job, to_disk=True, state=host_row(bi))
            elif preempt:
                self._checkpoint(job, to_disk=False, state=host_row(bi))
            with self._lock:
                if job.finished or job.epoch != pending.epochs[id(job)]:
                    continue           # failed over while checkpointing
                if preempt:
                    self._free_slot(job)
                    job.state = None
                    job._problem = None
                    job._shadow = None   # the checkpoint frame just
                    #                      written supersedes it
                    job.status = PREEMPTED
                    job.run_chunks = 0
                else:
                    job.status = QUEUED
                job.worker = None
                self._journal_event(
                    "queued", job,
                    reason="preempt" if preempt else "boundary")
                self._adm.requeue(job)

    def _free_slot(self, job: _Job) -> None:
        """Release the job's staging-store row (caller holds ``_lock``).
        Idempotent; a no-op for never-staged jobs."""
        sref = job.staged
        if sref is not None:
            st, slot = sref
            if 0 <= slot < len(st.slots) and st.slots[slot] is job:
                st.slots[slot] = None
            job.staged = None

    # ---------------------------------------------------- single-shot work

    def _single(self, job: _Job, epoch: int, worker) -> None:
        """Non-chunked kinds: the only boundaries are start and finish,
        and the deadline is enforced at both (work that finishes past
        its deadline is discarded with a structured error — the client
        was promised the deadline, not a late answer)."""
        if self._stale(job, epoch):
            return
        if self._expired(job):
            self._timeout(job)
            return
        if job.cancelled is not None:
            self._cancel_at_boundary(job)
            return
        job.status = RUNNING
        job.t_first_run = time.monotonic()
        kind = job.req.kind
        self._journal_event_owned("batched", job, epoch,
                                  worker=worker.slot, round=worker.round,
                                  batch=1, bucket=str(job.bucket[0]))
        fn = {"assign": self._do_assign,
              "gains": self._do_gains,
              "stats": self._do_stats,
              "health": self._do_health}.get(kind) or self._kinds[kind]
        t0 = time.monotonic()
        value = self._execu.run(
            lambda: fn(job.req.params),
            stage=f"{kind}:{job.req.request_id}:w{worker.slot}")
        dev_s = time.monotonic() - t0
        self._adm.note_service(dev_s)
        self._attribute_device([job], dev_s)
        self._sample_boundary(1, worker)
        if self._stale(job, epoch):
            return                     # failed over mid-execution
        if self._expired(job):
            self._timeout(job, late=True)
            return
        self._finish(job, COMPLETED, value=value)

    def _do_assign(self, params: dict):
        """Built-in ``assign``: a seeded (or shipped) q and p, solved on
        the service's device in its dtype with ``solver="sinkhorn"`` (K1
        and K2 on the card, through `sinkhorn_assign`), or on the host
        with ``solver="lap"``."""
        from aclswarm_torch.assignment import sinkhorn
        from aclswarm_torch.assignment.lapjv import solve_assignment_host

        n = int(params.get("n", 16))
        seed = int(params.get("seed", 0))
        rng = np.random.default_rng(seed)
        q = (np.asarray(params["q"], float) if "q" in params
             else rng.normal(size=(n, 3)) * 10)
        p = (np.asarray(params["p"], float) if "p" in params
             else rng.normal(size=(n, 3)) * 10)
        solver = params.get("solver", "sinkhorn")
        if solver == "lap":
            perm = solve_assignment_host(q, p)
        elif solver == "sinkhorn":
            def dev(x):
                return torch.as_tensor(x, dtype=self.dtype).to(self.device)
            r = sinkhorn.sinkhorn_assign(
                dev(q), dev(p), n_iters=int(params.get("n_iters", 50)))
            perm = r.row_to_col.cpu().numpy()
        else:
            raise ValueError(f"unknown assign solver {solver!r}")
        return {"perm": np.asarray(perm, np.int64), "solver": solver}

    def _do_gains(self, params: dict):
        """Built-in ``gains``: the ADMM design (`gains.solve_gains`) of
        the shipped points and adjacency, or of a seeded circle, on the
        service's device in its dtype; ``carry``/``warm`` thread the ADMM
        warm start through the request as codec-plain arrays."""
        from aclswarm_torch import convert
        from aclswarm_torch import gains as gainslib

        n = int(params.get("n", 6))
        seed = int(params.get("seed", 0))
        if "points" in params:
            pts = np.asarray(params["points"], float)
            adj = np.asarray(params["adjmat"], float)
        else:
            rng = np.random.default_rng(seed)
            ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
            pts = np.stack([4 * np.cos(ang), 4 * np.sin(ang),
                            2.0 + 0.1 * rng.normal(size=n)], 1)
            adj = np.ones((n, n)) - np.eye(n)
        pts_t = torch.as_tensor(pts, dtype=self.dtype).to(self.device)
        # ADMM warm start riding the request: ``carry`` is a previous
        # response's carry dict, ``warm`` truthy bootstraps warm
        # threading without one. Neither present = the stateless solve
        # and the plain response shape.
        carry_in = params.get("carry")
        if carry_in is not None or params.get("warm"):
            cold = gainslib.init_carry(pts.shape[0],
                                       gainslib.planar_of(pts),
                                       dtype=self.dtype, device=self.device)
            if carry_in is None:
                carry = cold
            else:
                carry = convert.admm_carry_from_numpy(
                    carry_in, device=self.device, dtype=self.dtype)
                if any(tuple(getattr(carry, f).shape)
                       != tuple(getattr(cold, f).shape)
                       for f in ("x2", "s2", "x1", "s1")):
                    carry = cold   # shape/planarity flip: re-seed cold
            g, new_carry = gainslib.solve_gains(pts_t, adj, carry=carry)
            return {"gains": g.cpu().numpy(), "n": n,
                    "carry": convert.admm_carry_to_numpy(new_carry)}
        g = gainslib.solve_gains(pts_t, adj)
        return {"gains": g.cpu().numpy(), "n": n}

    def _do_stats(self, params: dict):
        """Built-in ``stats`` kind: the registry's scrape surface as a
        request. ``format``: ``'prometheus'`` (default) returns ``{'text': ...}``;
        ``'snapshot'`` returns the full registry snapshot plus the
        service counter dict — both codec-serializable, so they cross
        the wire and the journal unchanged."""
        fmt = str(params.get("format", "prometheus"))
        if fmt == "prometheus":
            return {"format": fmt, "text": self.telemetry.prometheus_text()}
        if fmt == "snapshot":
            with self._lock:
                counters = {k: v for k, v in self.stats.items()}
            # pid + incarnation name the process generation serving
            # this scrape
            return {"format": fmt, "snapshot": self.telemetry.snapshot(),
                    "serve": counters, "pid": os.getpid(),
                    "incarnation": int(self.cfg.incarnation)}
        raise ValueError(f"unknown stats format {fmt!r} "
                         "(expected 'prometheus' or 'snapshot')")

    def _do_health(self, params: dict):
        """Built-in ``health`` kind: the fleet-health surface as a
        request: worker liveness, queue and in-flight levels refreshed at
        scrape time, the service's promise counters, and the SLO
        verdicts and burn rates of the health tier (null when
        ``cfg.watch`` is off)."""
        t = self.telemetry
        self._watch_probe()            # a scrape reads NOW, not stale
        per_worker = {}
        for m in t.metrics():
            if m.name == "serve_worker_up" \
                    and m.labels.get("worker") is not None:
                per_worker[m.labels["worker"]] = bool(m.value)
        with self._lock:
            counts = dict(self.stats)
        out = {
            "t_wall": time.time(),
            "alive": bool(self.alive),
            "pid": os.getpid(),
            "incarnation": int(self.cfg.incarnation),
            "watch_enabled": self.watch is not None,
            "watch": (self.watch.health()
                      if self.watch is not None else None),
            "workers": {
                "total": int(t.gauge("serve_workers_total").value),
                "up": int(t.gauge("serve_workers_up").value),
                "per_worker": per_worker,
            },
            "queue_depth": int(t.gauge("serve_queue_depth").value),
            "inflight": int(t.gauge("serve_inflight").value),
            "counts": counts,
        }
        return out

    # ------------------------------------------------------ finalization

    def _expired(self, job: _Job) -> bool:
        td = job.req.t_deadline
        return td is not None and time.time() > td

    def _timeout(self, job: _Job, late: bool = False) -> None:
        msg = (f"deadline ({job.req.deadline_s:.3f} s) exceeded at "
               f"chunk boundary {job.chunks_done}/{job.chunks_total}")
        if late:
            msg += " (work completed late; result discarded per contract)"
        self._journal_event("deadline", job, chunk=job.chunks_done,
                            late=late)
        self._finish(job, TIMED_OUT, error=ServeError(E_DEADLINE, msg))
        if self._ckpt_dir is not None:
            ckptlib.clear_checkpoints(self._ckpt_dir, self._stem(job))

    # ------------------------------------------- failover + cancellation

    def cancel(self, request_id: str,
               reason: str = "cancelled by client"):
        """Cancel one accepted request with a structured ``cancelled``
        error — the wire layer's disconnect semantics (a dead client's
        queue entries are cancelled, NEVER the running batch). Returns
        ``"queued"`` (the job was still queued: cancelled immediately),
        ``"resident"`` (mid-batch: marked, cancelled at its next chunk
        boundary — the same cancellation quantum deadlines use), or
        ``None`` (unknown or already terminal). Both non-None returns
        are truthy: callers that only care about "was there anything to
        cancel" can keep treating the result as a bool."""
        with self._lock:
            job = self._jobs.get(request_id)
            if job is None or job.finished:
                return None
            job.cancelled = reason
        if self._adm.cancel(job):      # was queued: cancel right now
            self._cancel_at_boundary(job)
            self._sample_queue()
            return "queued"
        return "resident"

    def _cancel_at_boundary(self, job: _Job) -> None:
        with self._lock:
            self.stats["cancelled"] += 1
        self._journal_event("cancelled", job,
                            reason=job.cancelled or "cancelled")
        self._finish(job, FAILED, error=ServeError(
            E_CANCELLED, job.cancelled or "cancelled"))
        if self._ckpt_dir is not None:
            ckptlib.clear_checkpoints(self._ckpt_dir, self._stem(job))

    def _failover_job(self, job: _Job, epoch: int, dead_uid: str,
                      solo: bool = False) -> None:
        """Fail one orphaned in-flight job over to the surviving
        workers (called by the pool supervisor with the dead worker's
        in-flight set). The dead incarnation joins the job's excluded
        set and the job is QUARANTINED (scheduled solo until a
        surviving chunk exonerates it). Only ``solo`` kills — the job
        was alone in the batch, with nobody else to blame — count
        toward the poison bound: at ``max_worker_exclusions`` of them
        the request terminates with a structured ``poisoned`` error
        instead of ping-ponging the fleet, while an innocent batch-mate
        of a co-incidental kill completes its quarantine round and
        walks free. Otherwise the job migrates THROUGH the checkpoint
        codec (its resident state is serialized here and restored
        template-validated on whichever surviving worker the placement
        hash names) and re-queues."""
        with self._lock:
            if job.finished or job.epoch != epoch:
                return                 # already terminal or re-owned
            if self._adm.contains(job):
                # a lease-lapsed (fenced, still-running) worker already
                # requeued this job at its chunk boundary before the
                # orphan snapshot was processed: the job is SAFE in the
                # queue — failing it over again would enqueue a second
                # copy (both picked into one batch, chunks run twice,
                # the bit-exact digest ruined). The boundary requeue
                # holds this same lock, so the check cannot race it.
                return
            job.epoch += 1
            job.worker = None
            job.excluded_workers.add(dead_uid)
            job.failovers += 1
            # quarantine: until a surviving chunk exonerates it, this
            # job is scheduled in a batch of ONE (admission pick) — the
            # next kill, if it comes, implicates exactly this request
            job.suspect = True
            if solo:
                job.solo_kills += 1
            exclusions = job.solo_kills
        if exclusions >= self.cfg.max_worker_exclusions:
            with self._lock:
                self.stats["poisoned"] += 1
            self.telemetry.counter("serve_poisoned_total").inc()
            self._journal_event("poisoned", job,
                                excluded=sorted(job.excluded_workers))
            self.log.error(
                "request %s POISONED: killed %d worker(s) while "
                "quarantined solo (%s) — terminating instead of "
                "wedging the fleet", job.req.request_id, exclusions,
                sorted(job.excluded_workers))
            self._finish(job, FAILED, error=ServeError(
                E_POISONED,
                f"request killed {exclusions} worker(s) while alone in "
                f"the batch ({sorted(job.excluded_workers)}) — excluded "
                "everywhere and terminated (max_worker_exclusions="
                f"{self.cfg.max_worker_exclusions})"))
            if self._ckpt_dir is not None:
                ckptlib.clear_checkpoints(self._ckpt_dir, self._stem(job))
            return
        # checkpoint-backed migration: serialize the orphaned resident
        # state through the codec so the next residency — on a DIFFERENT
        # worker — restores it template-validated and bit-identically
        # (the disk frame doubles as the crash-durability checkpoint).
        # Staged jobs (serve.staging): an in-flight job's staging row
        # may already hold the NEXT chunk's state (scatter-back lands
        # at dispatch, logical progress at finish), so migration never
        # reads the store — journaled services restore from the
        # per-chunk disk frame written at every resolve, unjournaled
        # ones from the consistent per-job shadow `_round_finish`
        # maintains (both proven bit-identical by the failover drills).
        if job.bucket[0] == "rollout":
            with self._lock:
                if job.state is None and job._shadow is not None:
                    # materialize the lazy shadow: state@chunks_done
                    # from the round output that resolved its last
                    # chunk (never the staging store — an in-flight
                    # job's store row may already hold the NEXT
                    # chunk's state). ``bi is None`` means the shadow
                    # is already a single materialized row (the
                    # eviction / stranded-readout form).
                    src, bi = job._shadow
                    job.state = (src if bi is None else
                                 stagelib.take_state_row(src, bi))
            if job.state is not None:
                self._checkpoint(job, to_disk=self._ckpt_dir is not None)
            with self._lock:
                self._free_slot(job)
            job.state = None
            job._problem = None
            job._shadow = None
        with self._lock:
            if job.finished:
                return                 # raced a terminal path mid-ckpt
            job.status = QUEUED
            job.run_chunks = 0
            self.stats["requeued"] += 1
            # the migration record precedes pickability (same lock
            # hold): the surviving worker's `batched` must follow it in
            # the causal file order, so a postmortem reads
            # chunk -> migrated -> batched -> resumed, gap-free
            self._journal_event("migrated", job, dead_worker=dead_uid,
                                chunk=job.chunks_done,
                                failovers=job.failovers)
            self._adm.requeue(job)
        self.telemetry.counter("serve_requeued_total").inc()

    def _requeue_unowned(self, pairs: list) -> None:
        """Hand back jobs a ZOMBIE worker dequeued but never registered
        in-flight (the slot was replaced between its generation check
        and the pick): nobody owns them — not the queue, not any
        worker's in-flight set — so without this they would silently
        never run. Epoch-guarded and queue-checked like every requeue."""
        for job, epoch in pairs:
            with self._lock:
                if job.finished or job.epoch != epoch \
                        or self._adm.contains(job):
                    continue
                job.status = QUEUED
                job.worker = None
                # the handback is a real state transition: journal it
                # in the same lock hold (like _failover_job's
                # `migrated`) so the postmortem reads an unbroken
                # ... batched -> queued -> batched ... chain instead
                # of a gap where the job silently changed hands
                self._journal_event("queued", job, reason="unowned")
                self._adm.requeue(job)

    def _journal_event_owned(self, event: str, job: _Job, epoch: int,
                             **fields) -> None:
        """Emit a request event ONLY while this residency still owns
        the job (finished/epoch checked under the lock): a fenced
        zombie worker must never append a `batched` record after the
        job's `migrated`/`resolved` — causal file order is the
        postmortem's ground truth."""
        with self._lock:
            if job.finished or job.epoch != epoch:
                return
            self._journal_event(event, job, **fields)

    def _journal_event(self, event: str, job: Optional[_Job] = None,
                       **fields) -> None:
        """Append one schema'd lifecycle record to the journal's
        torn-tail-tolerant events.log (`telemetry.lifecycle`), the stream
        a timeline is reconstructed from. ``job=None`` emits a fleet-scope event (worker death).
        With ``cfg.trace`` off only the failover/migrated/poisoned
        ledger (the recovery counters) is journaled."""
        if self._trace is None:
            return
        if not self.cfg.trace and event not in _LEDGER_EVENTS:
            return
        if not self._fence_ok():
            self.telemetry.counter("serve_fenced_writes_total").inc()
            return
        self._trace.emit(
            event,
            request_id=job.req.request_id if job is not None else None,
            trace_id=job.req.trace_id if job is not None else "",
            incarnation=self.cfg.incarnation,
            **fields)

    def _flush_spans(self, reason: str) -> None:
        """Dump the span ring to the journal NOW (the worker-death
        path: a SIGKILLed or wedged worker cannot flush itself, so the
        supervisor flushes on its behalf when it declares it dead)."""
        if self._span_dump is not None:
            self._span_dump.dump(reason)

    def _finish(self, job: _Job, status: str, value=None,
                error: Optional[ServeError] = None,
                journal: bool = True) -> None:
        with self._lock:
            # atomic once-guard: the close() sweep, the round-level
            # exception handler, and a racing submit() may all try to
            # terminate the same job — first caller wins, stats count once
            if job.finished:
                return
            job.finished = True
        t_done = time.time()
        queued_s = (((job.t_first_run or time.monotonic()) - job.t_accept)
                    if job.t_accept else 0.0)
        res = Result(
            request_id=job.req.request_id, status=status, value=value,
            error=error,
            latency_s=max(0.0, t_done - job.req.t_submit),
            queued_s=max(0.0, queued_s), chunks=job.chunks_done,
            preemptions=job.preemptions, resumed=job.resumed,
            failovers=job.failovers, trace_id=job.req.trace_id)
        # durable-then-visible: the done-frame is written before the
        # client can observe the result, so "resolved but not journaled"
        # is impossible and recovery never re-runs finished work
        if journal and self._journal is not None:
            if not self._fence_ok():
                # zombie write no-op: the successor incarnation owns
                # this journal — ITS recovery already re-admitted the
                # request, and a done-frame from us would overwrite the
                # live incarnation's ledger
                self.telemetry.counter("serve_fenced_writes_total").inc()
            else:
                _write_frame(
                    self._done_path(job.req.request_id),
                    {"value": value,
                     "error": error.to_row() if error else None},
                    ckptlib.make_manifest(
                        "serve_done", "-", job.chunks_done, "-",
                        request_id=job.req.request_id, status=status,
                        latency_s=res.latency_s, queued_s=res.queued_s,
                        preemptions=job.preemptions, resumed=job.resumed,
                        failovers=job.failovers,
                        tenant=job.req.tenant, req_kind=job.req.kind,
                        incarnation=self.cfg.incarnation,
                        t_done=t_done, trace_id=job.req.trace_id))
        # the terminal trace record: journaled whether or not the
        # done-frame was (a close()-raced submit resolves its ticket
        # with journal=False, but the timeline still owes its ending)
        self._journal_event(
            "resolved", job, status=status, chunks=job.chunks_done,
            latency_s=res.latency_s, preemptions=job.preemptions,
            failovers=job.failovers,
            error_code=error.code if error else None)
        job.status = status
        self.telemetry.counter("serve_" + {
            COMPLETED: "completed", TIMED_OUT: "deadline_miss",
            FAILED: "failed"}[status] + "_total").inc()
        self.telemetry.histogram(
            "serve_latency_s",
            labels={"tenant": job.req.tenant}).observe(res.latency_s)
        with self._lock:
            key = {COMPLETED: "completed", TIMED_OUT: "timed_out",
                   FAILED: "failed"}[status]
            self.stats[key] += 1
            # retire the request record: an always-on service must not
            # retain per-request device state (SimState rows, problem
            # arrays, checkpoint bytes, staging rows) or unbounded job
            # maps forever. The client's ticket keeps the Result alive;
            # the service keeps only a bounded terminal cache for
            # idempotent duplicate submits (journal done-frames persist
            # on disk).
            self._free_slot(job)
            job.state = None
            job._problem = None
            job._ckpt_bytes = None
            job._shadow = None
            self._jobs.pop(job.req.request_id, None)
            self._done_prior[job.req.request_id] = res
            while len(self._done_prior) > max(0, self.cfg.done_retention):
                self._done_prior.pop(next(iter(self._done_prior)))
        job.ticket._resolve(res)

    # ---------------------------------------------------------- recovery

    def _recover(self) -> None:
        """Rebuild the promise ledger from the journal: every accepted
        request without a done-frame is re-admitted (resuming from its
        rollout checkpoint when one survived) — the zero-silent-loss
        half the SIGKILL proof exercises. Already-terminal requests are
        cached so duplicate submits resolve instantly."""
        assert self._journal is not None
        if not self._journal.is_dir():
            return
        events = self._journal / "events.log"
        if events.is_file():
            # the worker-lifecycle ledger is APPEND-only: a crash
            # mid-append leaves a torn trailing record, which the
            # frame-log reader treats as clean EOF (any NON-trailing
            # corruption still raises CheckpointCorrupt loudly)
            frames, torn = ckptlib.read_frame_log(events)
            for _, man in frames:
                # `migrated` is the per-job failover record; `requeue`
                # the reference's older spelling — one reader serves
                # both generations of journal
                key = {"failover": "failovers", "requeue": "requeued",
                       "migrated": "requeued",
                       "poisoned": "poisoned"}.get(man.get("event"))
                if key is not None:
                    # construction-time replay: _recover() runs from
                    # __init__ before any worker thread exists
                    self.stats[key] += 1  # torchcheck: disable=JC101 construction-time replay
            if torn:
                self.log.warning(
                    "events.log ends in a torn record (crash "
                    "mid-append) — dropped it as clean EOF; %d prior "
                    "lifecycle record(s) recovered", len(frames))
        for done in sorted(self._journal.glob("req_*.done")):
            payload, man = _read_frame(done)
            err = payload.get("error")
            prior = Result(
                request_id=man["request_id"], status=man["status"],
                value=payload.get("value"),
                error=ServeError(**err) if err else None,
                latency_s=float(man.get("latency_s", 0.0)),
                queued_s=float(man.get("queued_s", 0.0)),
                preemptions=int(man.get("preemptions", 0)),
                resumed=bool(man.get("resumed", False)),
                failovers=int(man.get("failovers", 0)),
                trace_id=str(man.get("trace_id", "")))
            with self._lock:
                self._done_prior[man["request_id"]] = prior
        for reqf in sorted(self._journal.glob("req_*.req")):
            payload, man = _read_frame(reqf)
            rid = man["request_id"]
            with self._lock:
                already_done = rid in self._done_prior
            if already_done:
                continue
            # the acceptance frame carries the ORIGINAL trace_id: a
            # request's causal identity survives the process that
            # accepted it (the whole point of minting at submit)
            req = Request(kind=man["req_kind"], params=payload["params"],
                          tenant=man["tenant"], request_id=rid,
                          deadline_s=man.get("deadline_s"),
                          t_submit=float(man["t_submit"]),
                          trace_id=str(man.get("trace_id", "")))
            try:
                job = self._make_job(req)
            except ValueError as e:     # journaled garbage: loud error
                job = _Job(req=req, ticket=Ticket(rid), bucket=("?",))
                with self._lock:
                    self._jobs[rid] = job
                self._finish(job, FAILED,
                             error=ServeError(E_EXECUTION,
                                              f"unrecoverable params: {e}"))
                continue
            if self._ckpt_dir is not None and ckptlib.latest_checkpoint(
                    self._ckpt_dir, f"req_{rid}") is not None:
                job.resumed = True
                with self._lock:
                    self.stats["resumed"] += 1
                self.telemetry.counter("serve_resumed_total").inc()
            with self._lock:
                self._jobs[rid] = job
            # the recovery re-queue is itself a trace event: the
            # postmortem reads the crash gap as queued(recovery) ->
            # batched on whichever incarnation picks the job up
            self._journal_event("queued", job, reason="recovery")
            self._adm.admit(job, force=True)
            with self._lock:
                self.stats["accepted"] += 1
            self.telemetry.counter("serve_accepted_total").inc()
        with self._lock:
            n_jobs, n_prior = len(self._jobs), len(self._done_prior)
        if n_jobs:
            self.log.warning(
                "serve recovery: re-admitted %d unfinished request(s) "
                "from %s (%d already terminal)", n_jobs,
                self._journal, n_prior)

    # --------------------------------------------------------- telemetry

    def _sample_boundary(self, live: int, worker=None) -> None:
        """Chunk-boundary scheduler gauges: the batch-bucket occupancy
        (live device-batch slots / max_batch — the continuous-batching
        fill factor)
        and the admission queue depth, recorded both as last-value
        gauges and as distributions over the run. With a worker handed
        in, the same occupancy sample also lands in that worker's
        labeled per-worker distribution (the failover drills read it to
        show surviving workers absorbing the dead one's share)."""
        t = self.telemetry
        occ = live / max(1, self.cfg.max_batch)
        depth = self._adm.pending()
        # gauges and their distributions carry DISTINCT names (_hist):
        # snapshot() keys by name+labels and Prometheus forbids two
        # families sharing one name, so a collision would corrupt both
        # export surfaces
        t.gauge("serve_bucket_occupancy").set(occ)
        t.histogram("serve_bucket_occupancy_hist").observe(occ)
        t.gauge("serve_queue_depth").set(depth)
        t.histogram("serve_queue_depth_hist").observe(depth)
        if worker is not None:
            lbl = {"worker": str(worker.slot)}
            t.histogram("serve_worker_occupancy_hist",
                        labels=lbl).observe(occ)
            t.counter("serve_worker_chunks_total", labels=lbl).inc(live)
        t.gauge("serve_inflight").set(self._pool.inflight_total())

    def _sample_queue(self) -> None:
        """Refresh the queue-depth GAUGE outside chunk boundaries
        (submit / reject / cancel / the health scrape): an idle or
        wedged service must not show a stale depth forever, and chunk
        boundaries never come on an idle service.
        Only the gauge: the ``*_hist`` distributions stay
        boundary-sampled so the per-round statistics the committed
        throughput artifact reports keep their sampling cadence."""
        self.telemetry.gauge("serve_queue_depth").set(self._adm.pending())

    def _watch_probe(self) -> None:
        """Sampler pre-tick hook (and the health scrape's): refresh the
        liveness gauges so every sample reads CURRENT state, not the
        last chunk boundary's."""
        self._sample_queue()
        self.telemetry.gauge("serve_inflight").set(
            self._pool.inflight_total())

    def _emit_alert(self, ev: dict) -> None:
        """Append one alert transition to the journal's events.log as a
        fleet-scope ``alert`` record. Unjournaled services keep the
        in-memory engine state only."""
        self._journal_event("alert", None, **ev)

    def _attribute_device(self, jobs: list, span_s: float) -> None:
        """Per-tenant device-time cost accounting: one round's device
        span divided across the OCCUPIED batch rows into
        ``serve_device_s{tenant,kind}`` counters — padding rows bill
        nobody, so the counters sum to wall actually spent serving.
        Makes per-tenant SLOs evaluable over the sampled series and
        turns the round-robin fairness claim into a measured cost
        series (the matching-under-drift framing needs per-tenant cost,
        not spot checks)."""
        if not jobs or span_s <= 0:
            return
        share = span_s / len(jobs)
        for job in jobs:
            self.telemetry.counter(
                "serve_device_s",
                labels={"tenant": job.req.tenant,
                        "kind": job.req.kind}).inc(share)

    def serve_stats(self) -> ServeStats:
        """Plain-data snapshot of this service's registry
        (`serve.stats.ServeStats`)."""
        return ServeStats.of(self)

    def row_fields(self) -> dict:
        """Executor + service counters for results rows (the
        reference's shape)."""
        out = dict(self._execu.row_fields())
        out["serve"] = {k: v for k, v in self.stats.items()}
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

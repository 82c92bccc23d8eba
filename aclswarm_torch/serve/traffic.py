"""A replayable open-loop adversarial traffic fleet for the TCP wire
front end (a copy of `aclswarm_tpu/serve/traffic.py`).

Closed-loop clients that wait for each answer before asking again can
never overload anything: they self-throttle to the service's pace. This
fleet is the opposite on every axis:

- **open loop** — arrivals are scheduled by the clock, not by
  completions: request i of a tenant is due at its precomputed arrival
  time whether or not the service is keeping up. Offering more than
  the service drains is the point (the load-vs-SLO surface);
- **heavy-tailed** — interarrival gaps draw from a Pareto tail
  (``pareto_alpha``) normalized to the offered rate, so bursts arrive
  the way real fleets burst, not on a metronome;
- **adversarial** — alongside the honest tenants the fleet runs the
  wire front end's documented attackers: a slow-loris client trickling
  a frame byte-by-byte, a corrupt-frame client submitting bit-flipped
  records, and a kill/reconnect storm (abrupt socket death, no BYE,
  reconnect under the same client id, re-submit under the same request
  ids — the duplicate-attach path);
- **replayable** — the whole schedule (arrival times, tenant mix,
  request mix incl. scenario-registry draws, deadlines, corruption
  bits) is a pure function of ``TrafficConfig.seed``:
  `build_schedule(cfg)` twice is equal element-for-element, so a
  surprising run can be re-run exactly;
- **honest about backpressure** — rejected arrivals HONOR the
  admission ``retry_after_s`` hint (bounded re-submits under the same
  request id, deterministic crc32 jitter) and the report separates
  accepted-after-retry from shed-after-budget.

Request mixes draw from the scenario registry (truth-localization
families — the serve door refuses flooded ones), so serving stress and
scenario diversity are ONE test surface.
"""
from __future__ import annotations

import dataclasses
import heapq
import socket
import threading
import time
import zlib
from typing import Optional

import numpy as np

from aclswarm_torch.serve.api import E_QUEUE_FULL, FAILED
from aclswarm_torch.utils.log import get_logger
from aclswarm_torch.utils.retry import retry_after_delay

# wire-frame helpers for the adversarial clients (valid HELLOs, then
# deliberately broken payloads)
from aclswarm_torch.serve.wire import (K_HELLO, K_SUBMIT, WireClient,
                                       _frame)


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One replayable traffic run. Everything the run does is a pure
    function of this record — commit it next to the results."""

    seed: int = 0
    duration_s: float = 6.0
    offered_hz: float = 50.0          # aggregate arrival rate
    tenants: tuple = ("alpha", "beta", "gamma")
    tenant_weights: tuple = (0.5, 0.3, 0.2)   # skewed, like real fleets
    # request mix (kind -> weight); 'scenario' draws a family from the
    # registry at serve-compatible (truth-localization) families
    mix: tuple = (("rollout", 0.6), ("assign", 0.2), ("scenario", 0.2))
    # one rollout bucket: scenario + plain rollouts share it, so the
    # adversarial mix still packs
    n: int = 5
    ticks: int = 60
    chunk_ticks: int = 20
    pareto_alpha: float = 1.5         # heavy tail (mean exists, var huge)
    deadline_frac: float = 0.3        # fraction of arrivals with deadlines
    deadline_range_s: tuple = (5.0, 60.0)     # log-uniform
    reject_retries: int = 2           # per-arrival retry budget (hints
    #                                   honored, jittered, same rid)
    max_retry_wait_s: float = 10.0
    # adversaries (each one client thread for the run's duration)
    slowloris_clients: int = 1
    corrupt_clients: int = 1
    corrupt_hz: float = 5.0           # bit-flipped frames per second
    reconnect_storms: int = 0         # abrupt kill+reattach cycles of
    #                                   the storm tenant's client
    storm_period_s: float = 1.5
    drain_timeout_s: float = 300.0    # wait for accepted work after the
    #                                   submit window closes


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled open-loop submission."""

    t: float                    # seconds from run start
    tenant: str
    kind: str
    params: dict
    deadline_s: Optional[float]
    request_id: str


def _serve_families() -> list:
    """Scenario families the serve door accepts (truth localization),
    name-sorted for determinism."""
    from aclswarm_torch.scenarios.registry import FAMILIES
    return sorted(name for name, fam in FAMILIES.items()
                  if fam.localization == "truth")


def build_schedule(cfg: TrafficConfig) -> list[Arrival]:
    """The deterministic arrival timeline: heavy-tailed gaps at the
    offered rate, weighted tenant + kind draws, log-uniform deadlines,
    scenario-registry family draws. Pure in ``cfg`` — same config,
    same schedule, element for element."""
    rng = np.random.default_rng(cfg.seed)
    tenants = list(cfg.tenants)
    tw = np.asarray(cfg.tenant_weights, float)
    tw = tw / tw.sum()
    kinds = [k for k, _ in cfg.mix]
    kw = np.asarray([w for _, w in cfg.mix], float)
    kw = kw / kw.sum()
    fams = _serve_families()
    # Pareto(alpha) gaps: (X+1) has mean alpha/(alpha-1) for alpha>1,
    # scaled so the MEAN gap is 1/offered_hz — the offered rate holds
    # while individual gaps burst
    mean_gap = 1.0 / max(1e-9, cfg.offered_hz)
    scale = mean_gap * (cfg.pareto_alpha - 1.0) / cfg.pareto_alpha
    out: list[Arrival] = []
    t = 0.0
    i = 0
    lo, hi = cfg.deadline_range_s
    while True:
        t += float(rng.pareto(cfg.pareto_alpha) + 1.0) * scale
        if t >= cfg.duration_s:
            return out
        tenant = tenants[int(rng.choice(len(tenants), p=tw))]
        kind = kinds[int(rng.choice(len(kinds), p=kw))]
        seed = int(rng.integers(0, 2**31 - 1))
        if kind == "assign":
            params = {"n": max(4, cfg.n), "seed": seed}
        elif kind == "scenario" and fams:
            fam = fams[int(rng.integers(0, len(fams)))]
            params = {"n": cfg.n, "ticks": cfg.ticks,
                      "chunk_ticks": cfg.chunk_ticks, "seed": seed,
                      "family": fam}
        else:
            kind = "rollout"
            params = {"n": cfg.n, "ticks": cfg.ticks,
                      "chunk_ticks": cfg.chunk_ticks, "seed": seed}
        deadline = None
        if rng.random() < cfg.deadline_frac:
            deadline = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        out.append(Arrival(t=float(t), tenant=tenant, kind=kind,
                           params=params, deadline_s=deadline,
                           request_id=f"s{cfg.seed}-{i:05d}"))
        i += 1


# ---------------------------------------------------------------------------
# adversarial clients


def _loris(host: str, port: int, cid: str, stop: threading.Event,
           report: dict) -> None:
    """Slow-loris: a valid HELLO, then ONE submit frame trickled a byte
    at a time forever. The server must declare this client gone within
    its read deadline — `report['loris_dropped']` records that it did
    (the send failing = the server closed the socket)."""
    try:
        s = socket.create_connection((host, port), timeout=5)
    except OSError:
        return
    try:
        hello = _frame(K_HELLO, {"client": cid})
        s.sendall(len(hello).to_bytes(4, "little") + hello)
        sub = _frame(K_SUBMIT, {
            "request_id": f"{cid}-1", "kind": "rollout",
            "params": {"n": 5, "ticks": 100_000, "chunk_ticks": 20},
            "tenant": cid, "deadline_s": None, "trace_id": "f" * 16})
        framed = len(sub).to_bytes(4, "little") + sub
        s.settimeout(0.5)
        for b in framed:
            if stop.is_set():
                return
            s.sendall(bytes([b]))
            report["loris_bytes"] = report.get("loris_bytes", 0) + 1
            # drain responses so the server cannot blame the write side
            try:
                s.recv(1 << 16)
            except (socket.timeout, BlockingIOError):
                pass
            time.sleep(0.2)
    except OSError:
        # the server hung up on us: exactly the bound under test
        report["loris_dropped"] = report.get("loris_dropped", 0) + 1
    finally:
        s.close()


def _corruptor(host: str, port: int, cid: str, seed: int,
               hz: float, stop: threading.Event, report: dict) -> None:
    """Corrupt-frame client: a valid HELLO, then seeded bit-flipped
    submit records at ``hz``. Every one must be CRC-rejected without
    partial application; the connection survives to send the next (it
    drains the server's error frames so it never trips the write
    bound)."""
    rng = np.random.default_rng(seed)
    try:
        s = socket.create_connection((host, port), timeout=5)
    except OSError:
        return
    try:
        hello = _frame(K_HELLO, {"client": cid})
        s.sendall(len(hello).to_bytes(4, "little") + hello)
        s.settimeout(0.05)
        k = 0
        while not stop.is_set():
            sub = bytearray(_frame(K_SUBMIT, {
                "request_id": f"{cid}-{k}", "kind": "assign",
                "params": {"n": 6, "seed": k}, "tenant": cid,
                "deadline_s": None, "trace_id": "c" * 16}))
            # flip one seeded bit somewhere in the record body — the
            # codec CRC must catch every one
            pos = int(rng.integers(0, len(sub)))
            sub[pos] ^= 1 << int(rng.integers(0, 8))
            s.sendall(len(sub).to_bytes(4, "little") + bytes(sub))
            report["corrupt_sent"] = report.get("corrupt_sent", 0) + 1
            k += 1
            try:
                while s.recv(1 << 16):
                    pass
            except (socket.timeout, BlockingIOError):
                pass
            except OSError:
                return
            time.sleep(1.0 / max(0.1, hz))
    except OSError:
        pass
    finally:
        s.close()


# ---------------------------------------------------------------------------
# the fleet


class TrafficFleet:
    """Run one `TrafficConfig` against a TCP wire endpoint and report
    the client-side ledger. One `WireClient` + submitter thread per
    tenant (open-loop pacing + hint-honoring retries), plus the
    configured adversaries. `run()` blocks until the submit window
    closes AND every accepted request reached a terminal result (or
    ``drain_timeout_s`` — leftovers are reported, never dropped)."""

    def __init__(self, cfg: TrafficConfig, host: str, port: int,
                 log=None):
        self.cfg = cfg
        self.host, self.port = host, int(port)
        self.log = log or get_logger("serve.traffic")
        self.schedule = build_schedule(cfg)

    # ------------------------------------------------------------- run

    def run(self) -> dict:
        cfg = self.cfg
        stop = threading.Event()
        report: dict = {"offered": len(self.schedule)}
        lock = threading.Lock()
        # rid -> (ticket, t_submit, arrival); merged across re-submits —
        # the newest ticket wins, a wire_error outcome never overwrites
        # a real one
        tracked: dict = {}
        retry_counts = {"submits": 0, "accepted_after_retry": 0}
        hints: list = []

        by_tenant: dict[str, list] = {t: [] for t in cfg.tenants}
        for a in self.schedule:
            by_tenant[a.tenant].append(a)

        clients: dict[str, WireClient] = {}
        clients_lock = threading.Lock()
        rebuilding: set = set()     # tenants mid-storm-reconnect

        def client_for(tenant: str) -> WireClient:
            # the lock guards only the MAP: the blocking construction
            # (TCP connect + HELLO-ack wait) runs outside it behind the
            # `rebuilding` marker, so one tenant's reconnect never
            # stalls another tenant's clock-scheduled arrivals
            with clients_lock:
                if tenant in rebuilding:
                    # someone (this tenant's earlier beat, or the
                    # storm) is already swapping: transient beat
                    # failure, retried next loop — never a second
                    # same-cid client racing into existence
                    raise OSError(f"client for {tenant} reconnecting")
                c = clients.get(tenant)
                if c is not None and not c.alive:
                    # the server dropped this connection (a hardening
                    # bound, or a shed lease): a dead reader strands
                    # every ticket, so rebuild — the open loop does not
                    # stop because one connection died
                    clients.pop(tenant, None)
                    c = None
                if c is not None:
                    return c
                rebuilding.add(tenant)
            try:
                c = WireClient(
                    tcp=(self.host, self.port), tenant=tenant,
                    client_id=f"fleet-{cfg.seed}-{tenant}", ping_s=0.5)
            finally:
                with clients_lock:
                    rebuilding.discard(tenant)
            with clients_lock:
                clients[tenant] = c
            return c

        t0 = time.perf_counter()

        def submitter(tenant: str) -> None:
            """Open-loop pacing + a retry heap: due arrivals submit at
            their scheduled time regardless of prior outcomes; rejected
            submissions re-enter at now + jittered(retry_after)."""
            arrivals = by_tenant[tenant]
            retry_heap: list = []       # (due, tiebreak, attempt, arrival)
            watch: list = []            # tickets awaiting a reject verdict
            i = 0
            tie = 0
            while not stop.is_set():
                now = time.perf_counter() - t0
                try:
                    # scheduled arrivals due now (i advances only after
                    # a successful submit — a failed beat retries it)
                    while i < len(arrivals) and arrivals[i].t <= now:
                        self._submit(client_for(tenant), arrivals[i], 0,
                                     tracked, watch, lock)
                        i += 1
                    # retries due now; a popped retry that fails the
                    # beat goes BACK on the heap — its budget must not
                    # silently evaporate mid-storm
                    while retry_heap and retry_heap[0][0] <= now:
                        entry = heapq.heappop(retry_heap)
                        _, _, attempt, a = entry
                        try:
                            self._submit(client_for(tenant), a, attempt,
                                         tracked, watch, lock)
                        except OSError:
                            heapq.heappush(retry_heap, entry)
                            raise
                        with lock:
                            retry_counts["submits"] += 1
                except OSError as e:
                    # a mid-storm connect failure: skip this beat, the
                    # next loop rebuilds the client (open loop — the
                    # schedule does not stop for a flaky connection)
                    self.log.warning("traffic %s: submit beat failed "
                                     "(%s) — retrying next beat",
                                     tenant, e)
                    time.sleep(0.05)
                # harvest reject verdicts (they resolve fast); an
                # ACCEPTED ticket leaves the watch — the drain owns it.
                # A ticket neither accepted nor resolved past the stale
                # window was orphaned by a storm kill (its submit frame
                # died with the socket; the storm re-submitted under a
                # fresh ticket) — age it out, the drain waits on the
                # tracked (newest) ticket.
                stale_s = cfg.max_retry_wait_s * 2 + 5.0
                for entry in list(watch):
                    ticket, a, attempt, t_watch = entry
                    if not ticket.done:
                        if ticket.accepted \
                                or time.perf_counter() - t_watch > stale_s:
                            watch.remove(entry)
                            if ticket.accepted and attempt > 0:
                                with lock:
                                    retry_counts[
                                        "accepted_after_retry"] += 1
                        continue
                    watch.remove(entry)
                    res = ticket.result(timeout=0)
                    if res.status == FAILED and res.error is not None \
                            and res.error.code == E_QUEUE_FULL:
                        hint = float((res.error.detail or {})
                                     .get("retry_after_s", 0.1))
                        with lock:
                            hints.append(hint)
                        if attempt < cfg.reject_retries:
                            seed = zlib.crc32(a.request_id.encode())
                            due = now + retry_after_delay(
                                hint, seed, attempt,
                                cfg.max_retry_wait_s)
                            tie += 1
                            heapq.heappush(retry_heap,
                                           (due, tie, attempt + 1, a))
                    elif attempt > 0 and ticket.accepted:
                        # only count a retry the service actually
                        # ACCEPTED — a wire_error/shutdown resolution
                        # of a retried submit is a lost frame, not
                        # retry-after honesty (the accept frame always
                        # precedes the result frame, so the flag is
                        # authoritative here)
                        with lock:
                            retry_counts["accepted_after_retry"] += 1
                if i >= len(arrivals) and not retry_heap and not watch:
                    return
                if now >= cfg.duration_s * 3 + 30:
                    return              # runaway guard, never a hang
                time.sleep(0.002)

        threads = [threading.Thread(target=submitter, args=(t,),
                                    name=f"traffic-{t}", daemon=True)
                   for t in cfg.tenants]
        # adversaries
        for j in range(cfg.slowloris_clients):
            threads.append(threading.Thread(
                target=_loris,
                args=(self.host, self.port, f"loris{cfg.seed}-{j}",
                      stop, report), daemon=True))
        for j in range(cfg.corrupt_clients):
            threads.append(threading.Thread(
                target=_corruptor,
                args=(self.host, self.port, f"corrupt{cfg.seed}-{j}",
                      cfg.seed * 1000 + j, cfg.corrupt_hz, stop,
                      report), daemon=True))
        storms_done = [0]
        if cfg.reconnect_storms > 0:
            threads.append(threading.Thread(
                target=self._storm,
                args=(clients, clients_lock, rebuilding, tracked, lock,
                      stop, storms_done), daemon=True))
        for th in threads:
            th.start()
        # the submit window + per-tenant completion of retries
        for th in threads:
            if th.name.startswith("traffic-"):
                th.join(cfg.duration_s * 3 + 60)
        stop.set()

        # drain: every tracked (submitted) request must reach a
        # terminal result — the client half of zero-silent-losses
        deadline = time.monotonic() + cfg.drain_timeout_s
        outcomes: dict = {}
        latencies: list = []
        unresolved = 0
        with lock:
            items = list(tracked.items())
        for rid, (ticket, t_sub, _a) in items:
            left = max(0.0, deadline - time.monotonic())
            try:
                res = ticket.result(timeout=left)
            except TimeoutError:
                unresolved += 1
                outcomes[rid] = "unresolved"
                continue
            code = res.error.code if res.error is not None else None
            outcomes[rid] = res.status if code is None else code
            if res.ok:
                # the server's accept->terminal wall (rides the result
                # frame): the honest SLO latency — measuring at drain
                # time here would charge every request for the whole
                # run
                latencies.append(res.latency_s)
        wall = time.perf_counter() - t0
        for th in threads:
            th.join(5.0)
        with clients_lock:
            for c in clients.values():
                try:
                    c.close()
                except OSError:
                    pass

        counts: dict = {}
        for v in outcomes.values():
            counts[v] = counts.get(v, 0) + 1
        lat = np.asarray(sorted(latencies)) if latencies else None

        def pct(q):
            if lat is None or not len(lat):
                return 0.0
            return float(lat[min(len(lat) - 1,
                                 int(round(q * (len(lat) - 1))))])

        report.update({
            "schedule_seed": cfg.seed,
            "submitted": len(tracked),
            "completed": counts.get("completed", 0),
            "timed_out": counts.get("deadline_exceeded", 0),
            "rejected_final": counts.get(E_QUEUE_FULL, 0),
            "cancelled": counts.get("cancelled", 0),
            "wire_lost": counts.get("wire_error", 0),
            "failed_other": counts.get("execution_failed", 0)
            + counts.get("service_shutdown", 0)
            + counts.get("poisoned", 0),
            "unresolved": unresolved,
            "retry_submits": retry_counts["submits"],
            "accepted_after_retry":
                retry_counts["accepted_after_retry"],
            "retry_after_p50":
                float(np.median(hints)) if hints else 0.0,
            "retry_hints": len(hints),
            "storms": storms_done[0],
            "latency_p50_s": pct(0.50),
            "latency_p99_s": pct(0.99),
            "wall_s": wall,
            "outcomes": outcomes,
        })
        return report

    # -------------------------------------------------------- internals

    def _submit(self, client: WireClient, a: Arrival, attempt: int,
                tracked: dict, watch: list, lock) -> None:
        if attempt > 0:
            # re-submit under the SAME rid: the server-side atomic id
            # reservation makes the retry idempotent even if the
            # earlier attempt actually landed
            client.forget(a.request_id)
        ticket = client.submit(a.kind, a.params, tenant=a.tenant,
                               request_id=a.request_id,
                               deadline_s=a.deadline_s)
        with lock:
            prior = tracked.get(a.request_id)
            # keep the earliest submit time (end-to-end latency spans
            # the retries the client chose to make)
            t_sub = prior[1] if prior else time.perf_counter()
            tracked[a.request_id] = (ticket, t_sub, a)
        watch.append((ticket, a, attempt, time.perf_counter()))

    def _storm(self, clients: dict, clients_lock, rebuilding: set,
               tracked: dict, lock, stop: threading.Event,
               storms_done: list) -> None:
        """Kill/reconnect storm: every ``storm_period_s``, abruptly
        close one tenant's socket (no BYE — the server sees a reset or
        a lapsed lease), reconnect under the SAME client id, and
        re-submit every still-open request id — the duplicate-attach
        path. The re-submitted tickets replace the dead ones in the
        tracked map, so the drain waits on results that can still
        arrive. The ``rebuilding`` marker keeps `client_for` from
        racing a second same-cid client into existence WITHOUT holding
        the clients lock across the (blocking) reconnect — other
        tenants' open-loop pacing never pauses for a storm."""
        cfg = self.cfg
        tenant = cfg.tenants[0]
        k = 0
        while not stop.is_set() and k < cfg.reconnect_storms:
            if stop.wait(cfg.storm_period_s):
                return
            with clients_lock:
                victim = clients.pop(tenant, None)
                if victim is None:
                    continue
                rebuilding.add(tenant)
            try:
                # abrupt death: reader stopped, socket closed, no BYE
                victim.kill()
                try:
                    fresh = WireClient(
                        tcp=(self.host, self.port), tenant=tenant,
                        client_id=f"fleet-{cfg.seed}-{tenant}",
                        ping_s=0.5)
                except OSError as e:
                    self.log.error("storm reconnect failed: %s", e)
                    return
                with clients_lock:
                    clients[tenant] = fresh
            finally:
                with clients_lock:
                    rebuilding.discard(tenant)
            with lock:
                open_rids = [
                    (rid, t_sub, a) for rid, (tk, t_sub, a)
                    in tracked.items()
                    if a.tenant == tenant and not tk.done]
            for rid, t_sub, a in open_rids:
                # re-submit the ORIGINAL request under its original id:
                # if the server knows the id (the common case) the
                # atomic reservation attaches to the existing job; if
                # the submit frame died with the socket, this replays
                # it — either way exactly one execution
                ticket = fresh.submit(a.kind, a.params, request_id=rid,
                                      tenant=tenant,
                                      deadline_s=a.deadline_s)
                with lock:
                    tracked[rid] = (ticket, t_sub, a)
            storms_done[0] += 1
            k += 1
            self.log.info("storm %d: killed + reattached %s (%d open "
                          "rids)", k, tenant, len(open_rids))

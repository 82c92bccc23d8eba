"""swarmmodel — explicit-state model checker for the serve
promise/journal/fencing protocol, with trace refinement against real
crash-drill journals.

The model is a small-configuration abstraction of `serve.service`'s
request protocol: requests are submitted (durable req frame + the
acceptance events, one atomic step), admitted, dispatched to a worker,
executed chunk by chunk (checkpoint cadence < every chunk, so crash
replay genuinely re-executes work), finished (durable done frame, THEN
the client-visible resolve — durable-then-visible), SIGKILLed at any
action boundary, recovered (fence bump + journal replay), and harassed
by a fenced zombie incarnation that attempts one straggler write.
Worker-level failover (checkpoint + `migrated` + requeue) rides along
with its own budget.

BFS with state hashing explores every interleaving of those actions
over a bounded configuration (default 2 requests x 2 chunks x 2
workers x 1 crash x 1 failover + zombie) and checks five properties at
every reachable state:

  P1 no-lost-accepted-request        every req frame has a done frame
                                     once the system drains
  P2 execute-at-most-once-or-        re-executed chunks produce
     bit-identical-duplicate         bit-identical digests
  P3 terminal-once                   the done frame is written at most
                                     once per request
  P4 fenced-writes-are-no-ops        no stale-incarnation write ever
                                     lands in the journal
  P5 journal-replay-idempotence      replaying recovery twice reaches
                                     the same state as replaying once

Each property has teeth: `MUTATIONS` maps five deliberate protocol
mutations (drop the done-frame append, nondeterministic re-execution,
double-resolve, skip the fence check, unguarded replay re-attach) to
the one property each must trip, and the counterexample printer
renders the minimal violating action trace, naming the crashing
boundary.

The model is additionally tied to the implementation from both sides:

- every drained unmutated run cross-checks its per-request event
  sequences against `analysis.protocol.TRANSITIONS` (the declarative
  spec) — the model cannot drift from the spec silently;
- `--refine <journal dirs>` replays REAL drill journals
  (`serve.smoke`, `--multiworker`, `--procs`) through the same spec:
  every reconstructed per-request timeline must be an accepted trace,
  so the spec (and hence the model) cannot drift from the
  implementation silently either.

Abstraction notes: the req frame and the acceptance events are one
atomic model step (the implementation can crash between them, leaving
an eventless accepted request — `postmortem` reports that as
non-gap-free; the model's loss/duplication properties are unaffected).
Digests are deterministic functions of (request, chunk), which is
exactly the bit-identical-replay contract the resilience tier proves.

CLI:  python -m aclswarm_torch.analysis.model              # prove all
      python -m aclswarm_torch.analysis.model --self-test  # + mutations
      python -m aclswarm_torch.analysis.model --mutate double_resolve
      python -m aclswarm_torch.analysis.model --refine DIR [DIR...]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from collections import deque
from pathlib import Path
from typing import Optional

from . import protocol

__all__ = ["ModelConfig", "PROPERTIES", "MUTATIONS", "check",
           "render_trace", "refine_dir", "refine_tree", "main"]

PROPERTIES = {
    "P1": "no-lost-accepted-request",
    "P2": "execute-at-most-once-or-bit-identical-duplicate",
    "P3": "terminal-once",
    "P4": "fenced-writes-are-no-ops",
    "P5": "journal-replay-idempotence",
}

#: deliberate protocol mutation -> the ONE property it must trip
MUTATIONS = {
    "drop_done_frame": "P1",        # resolve without the durable frame
    "nondet_chunk": "P2",           # replayed chunk differs per incarnation
    "double_resolve": "P3",         # once-guard removed from finish
    "skip_fence": "P4",             # zombie write lands despite the fence
    "replay_double_resolve": "P5",  # recovery re-attach not once-guarded
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    requests: int = 2
    chunks: int = 2            # per request
    workers: int = 2
    ckpt_every: int = 2        # checkpoint cadence (< every chunk, so
    #                            crash replay re-executes real work)
    crashes: int = 1           # SIGKILL budget
    failovers: int = 1         # worker-death budget
    zombie: bool = True        # fenced straggler write attempt
    mutation: Optional[str] = None

    def __post_init__(self):
        if self.mutation is not None and self.mutation not in MUTATIONS:
            raise ValueError(f"unknown mutation {self.mutation!r} "
                             f"(known: {sorted(MUTATIONS)})")


# job phases: "none" | "queued" | "run" | "resolving" | "done"
# (worker identity is symmetric — two workers produce isomorphic
# states, so it lives in action LABELS only; this is the standard
# symmetry reduction and is what keeps the 2xW configuration small)
_NONE, _QUEUED, _RUN, _RESOLVING, _DONE = \
    "none", "queued", "run", "resolving", "done"


@dataclasses.dataclass(frozen=True)
class _S:
    """One explicit model state (hashable; BFS dedup key)."""
    alive: bool
    inc: int                   # live process incarnation
    fence: int                 # journal fence owner
    crashes: int               # SIGKILL budget spent
    failovers: int             # worker-death budget spent
    zombie: Optional[int]      # stale incarnation with one pending write
    fence_violated: bool       # P4 witness
    req: tuple                 # per-rid: req frame present
    done_writes: tuple         # per-rid: durable terminal write count
    ckpt: tuple                # per-rid: durable checkpoint position
    jobs: tuple                # per-rid job phase (see above)
    mem: tuple                 # per-rid in-memory chunks done
    resolved: tuple            # per-rid client-visible resolutions
    digests: tuple             # per-rid tuple per chunk: first digest
    diverged: tuple            # per-rid: a re-execution digest differed


def _init_state(cfg: ModelConfig) -> _S:
    n = cfg.requests
    return _S(alive=True, inc=0, fence=0, crashes=0, failovers=0,
              zombie=None, fence_violated=False,
              req=(False,) * n, done_writes=(0,) * n, ckpt=(0,) * n,
              jobs=(_NONE,) * n, mem=(0,) * n, resolved=(0,) * n,
              digests=((None,) * cfg.chunks,) * n,
              diverged=(False,) * n)


def _digest(cfg: ModelConfig, r: int, c: int, inc: int) -> tuple:
    if cfg.mutation == "nondet_chunk":
        return ("d", r, c, inc)     # replay differs across incarnations
    return ("d", r, c)


def _tset(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _replay(cfg: ModelConfig, s: _S) -> _S:
    """The recovery journal replay, as a pure function of the durable
    state: fence bump, re-admit every un-done accepted request, re-
    attach the client to every done one. P5 is literally
    `_replay(crash(_replay(s))) == _replay(s)` up to incarnation
    counters."""
    inc = s.fence + 1
    jobs, resolved = list(s.jobs), list(s.resolved)
    for r in range(cfg.requests):
        if not s.req[r]:
            continue
        if s.done_writes[r] > 0:
            jobs[r] = _DONE
            if resolved[r] == 0 \
                    or cfg.mutation == "replay_double_resolve":
                resolved[r] += 1    # duplicate-submit re-attach
        else:
            jobs[r] = _QUEUED
    return dataclasses.replace(
        s, alive=True, inc=inc, fence=inc,
        jobs=tuple(jobs), mem=(0,) * cfg.requests,
        resolved=tuple(resolved))


def _crash_effect(cfg: ModelConfig, s: _S,
                  spend_budget: bool = True) -> _S:
    return dataclasses.replace(
        s, alive=False, crashes=s.crashes + (1 if spend_budget else 0),
        zombie=s.inc if cfg.zombie else None,
        jobs=tuple(_NONE for _ in range(cfg.requests)),
        mem=(0,) * cfg.requests)


def _successors(cfg: ModelConfig, s: _S):
    """Yield (action_label, events, next_state); `events` is the list
    of (rid, event_name) lifecycle records the action appends — the
    projection the spec cross-check consumes."""
    n = cfg.requests
    if s.alive:
        for r in range(n):
            if not s.req[r] and s.resolved[r] == 0:
                # atomic accept: req frame + submitted/admitted + admit
                yield (f"submit(r{r})",
                       [(r, "submitted"), (r, "admitted")],
                       dataclasses.replace(
                           s, req=_tset(s.req, r, True),
                           jobs=_tset(s.jobs, r, _QUEUED)))
        for r in range(n):
            if s.jobs[r] == _QUEUED:
                resume = s.ckpt[r] > 0
                mem = max(s.mem[r], s.ckpt[r])
                evs = [(r, "batched")] + \
                    ([(r, "resumed")] if resume else [])
                # one action per (symmetric) worker pool — see _RUN note
                yield (f"dispatch(r{r}"
                       + (",resume" if resume else "") + ")",
                       evs,
                       dataclasses.replace(
                           s, jobs=_tset(s.jobs, r, _RUN),
                           mem=_tset(s.mem, r, mem)))
        for r in range(n):
            ph = s.jobs[r]
            if ph == _RUN:
                if s.mem[r] < cfg.chunks:
                    c = s.mem[r]
                    mem = c + 1
                    dig = _digest(cfg, r, c, s.inc)
                    prior = s.digests[r][c]
                    do_ckpt = (mem % cfg.ckpt_every == 0
                               or mem == cfg.chunks)
                    evs = [(r, "chunk")] + \
                        ([(r, "checkpointed")] if do_ckpt else [])
                    yield (f"chunk(r{r}#{c})"
                           + ("+ckpt" if do_ckpt else ""),
                           evs,
                           dataclasses.replace(
                               s, mem=_tset(s.mem, r, mem),
                               ckpt=_tset(s.ckpt, r,
                                          mem if do_ckpt else s.ckpt[r]),
                               digests=_tset(
                                   s.digests, r,
                                   _tset(s.digests[r], c,
                                         prior if prior is not None
                                         else dig)),
                               diverged=_tset(
                                   s.diverged, r,
                                   s.diverged[r]
                                   or (prior is not None
                                       and prior != dig))))
                elif s.done_writes[r] == 0:
                    # durable terminal first (durable-then-visible)
                    writes = 0 if cfg.mutation == "drop_done_frame" else 1
                    yield (f"finish_frame(r{r})"
                           + ("[dropped]" if not writes else ""),
                           [(r, "resolved")],
                           dataclasses.replace(
                               s, jobs=_tset(s.jobs, r, _RESOLVING),
                               done_writes=_tset(s.done_writes, r,
                                                 s.done_writes[r]
                                                 + writes)))
                if s.failovers < cfg.failovers:
                    # worker dies; _failover_job checkpoints the live
                    # state, journals `migrated`, requeues under lock
                    yield (f"worker_fail(r{r})",
                           [(r, "checkpointed"), (r, "migrated")],
                           dataclasses.replace(
                               s, failovers=s.failovers + 1,
                               jobs=_tset(s.jobs, r, _QUEUED),
                               ckpt=_tset(s.ckpt, r, s.mem[r])))
            elif ph == _RESOLVING:
                yield (f"resolve(r{r})", [],
                       dataclasses.replace(
                           s, jobs=_tset(s.jobs, r, _DONE),
                           resolved=_tset(s.resolved, r,
                                          s.resolved[r] + 1)))
            elif ph == _DONE and cfg.mutation == "double_resolve" \
                    and s.done_writes[r] == 1:
                # the once-guard is gone: a second terminal path runs
                # the whole finish again — duplicate durable terminal
                yield (f"dup_finish(r{r})",
                       [(r, "resolved")],
                       dataclasses.replace(
                           s, done_writes=_tset(s.done_writes, r, 2),
                           resolved=_tset(s.resolved, r,
                                          s.resolved[r] + 1)))
        if s.crashes < cfg.crashes:
            yield ("crash", [], _crash_effect(cfg, s))
        if s.zombie is not None and s.zombie != s.fence:
            # the straggler thread of a fenced incarnation attempts one
            # journal append; the fence check must make it a no-op
            if cfg.mutation == "skip_fence":
                r = 0
                yield (f"zombie_write(r{r})[LANDED]",
                       [(r, "batched")],
                       dataclasses.replace(s, zombie=None,
                                           fence_violated=True))
            else:
                yield ("zombie_write[fenced no-op]", [],
                       dataclasses.replace(s, zombie=None))
    else:
        yield ("recover", None, _replay(cfg, s))
        #      ^ events for recover are per-rid queued(recovery); the
        #        spec projection recomputes them from the state delta


_PROGRESS = ("submit(", "dispatch(", "chunk(", "finish_frame(",
             "resolve(", "dup_finish(")


def _drained(cfg: ModelConfig, s: _S) -> bool:
    if not s.alive:
        return False
    for label, _evs, _nxt in _successors(cfg, s):
        if label.startswith(_PROGRESS):
            return False
    return True


def _p5_projection(s: _S) -> tuple:
    return (s.jobs, s.mem, s.ckpt, s.done_writes, s.resolved, s.req)


def _check_state(cfg: ModelConfig, s: _S) -> Optional[tuple[str, str]]:
    """(property, detail) for the first violated property, else None."""
    # P3 terminal-once: at most one durable terminal per request
    for r in range(cfg.requests):
        if s.done_writes[r] > 1:
            return ("P3", f"r{r}: done frame written "
                          f"{s.done_writes[r]} times")
    # P2 at-most-once-or-bit-identical: re-execution must reproduce
    # the recorded digest bit for bit
    for r in range(cfg.requests):
        if s.diverged[r]:
            return ("P2", f"r{r}: a re-executed chunk produced a "
                          f"digest different from its first run")
    # P4 fenced-writes-are-no-ops
    if s.fence_violated:
        return ("P4", "a stale-incarnation write landed in the journal")
    # P5 replay idempotence (checked analytically at dead states)
    if not s.alive:
        once = _replay(cfg, s)
        twice = _replay(cfg, _crash_effect(cfg, once,
                                           spend_budget=False))
        if _p5_projection(once) != _p5_projection(twice):
            return ("P5", f"replaying recovery twice diverges: "
                          f"{_p5_projection(once)} vs "
                          f"{_p5_projection(twice)}")
    # P1 no-lost-accepted-request, at drained states
    if _drained(cfg, s):
        for r in range(cfg.requests):
            if s.req[r] and s.done_writes[r] == 0:
                return ("P1", f"r{r}: accepted (req frame) but no done "
                              f"frame once the system drained")
            if s.req[r] and s.resolved[r] == 0:
                return ("P1", f"r{r}: accepted but the client promise "
                              f"was never resolved")
    return None


@dataclasses.dataclass
class CheckResult:
    ok: bool
    states: int
    config: ModelConfig
    property: Optional[str] = None      # violated property key
    detail: str = ""
    trace: list = dataclasses.field(default_factory=list)  # action labels


def _events_of_path(cfg: ModelConfig, path: list) -> dict[int, list]:
    """Per-request lifecycle event projection of an action path —
    `recover` steps contribute queued(recovery) per re-admitted rid."""
    out: dict[int, list] = {r: [] for r in range(cfg.requests)}
    for label, evs, before, after in path:
        if evs is None:     # recover: recompute from the state delta
            for r in range(cfg.requests):
                if before.jobs[r] != _QUEUED \
                        and after.jobs[r] == _QUEUED:
                    out[r].append("queued")
        else:
            for r, ev in evs:
                out[r].append(ev)
    return out


def check(cfg: ModelConfig,
          max_states: int = 2_000_000) -> CheckResult:
    """BFS the configuration's full state graph; return the first
    property violation (minimal trace — BFS order) or the proof
    summary."""
    s0 = _init_state(cfg)
    parent: dict = {s0: None}   # state -> (prev_state, label, events)
    frontier = deque([s0])
    explored = 0

    def path_to(s: _S) -> list:
        out = []
        cur = s
        while parent[cur] is not None:
            prev, label, evs = parent[cur]
            out.append((label, evs, prev, cur))
            cur = prev
        out.reverse()
        return out

    while frontier:
        s = frontier.popleft()
        explored += 1
        bad = _check_state(cfg, s)
        if bad is not None:
            prop, detail = bad
            return CheckResult(ok=False, states=explored, config=cfg,
                               property=prop, detail=detail,
                               trace=path_to(s))
        if cfg.mutation is None and _drained(cfg, s):
            # model <-> spec refinement: the model's own event streams
            # must be accepted, complete traces of the declarative
            # protocol — the two layers cannot drift apart silently
            evmap = _events_of_path(cfg, path_to(s))
            for r, evs in evmap.items():
                if not evs:
                    continue
                ok, phase, problem = protocol.accepts(evs)
                if not ok or phase != protocol.TERMINAL_PHASE:
                    return CheckResult(
                        ok=False, states=explored, config=cfg,
                        property="SPEC",
                        detail=(f"model trace for r{r} is not an "
                                f"accepted complete protocol trace: "
                                f"{problem or f'final phase {phase}'} "
                                f"(events: {evs})"),
                        trace=path_to(s))
        for label, evs, nxt in _successors(cfg, s):
            if nxt not in parent:
                parent[nxt] = (s, label, evs)
                frontier.append(nxt)
                if len(parent) > max_states:
                    raise RuntimeError(
                        f"state-space blowup: > {max_states} states "
                        f"for {cfg}")
    return CheckResult(ok=True, states=explored, config=cfg)


def render_trace(result: CheckResult) -> str:
    """The counterexample printer: numbered minimal action trace; crash
    steps name the boundary they interrupted."""
    cfg = result.config
    head = [f"PROPERTY VIOLATED: {result.property} "
            f"{PROPERTIES.get(result.property, '')}".rstrip(),
            f"  mutation: {cfg.mutation or 'none'}",
            f"  detail:   {result.detail}",
            f"  states explored: {result.states}",
            f"  trace ({len(result.trace)} steps):"]
    lines = []
    prev_label = "<initial state>"
    for i, (label, _evs, _before, _after) in enumerate(result.trace, 1):
        note = ""
        if label == "crash":
            note = f"   <- boundary: after {prev_label}"
        lines.append(f"    {i:2d}. {label}{note}")
        prev_label = label
    return "\n".join(head + lines)


# ---------------------------------------------------------------------------
# trace refinement against real journals

def refine_dir(journal_dir, fragment: bool = False,
               stats: Optional[dict] = None) -> list[str]:
    """Replay one journal's reconstructed per-request timelines through
    the protocol. Returns problem strings (empty = refined).

    ``fragment``: a per-slot journal of a process fleet holds only a
    SLICE of a migrated request's history — accept mid-stream
    fragments and leave completeness to the fleet-level merge.
    ``stats`` (a dict) gains the counts of requests and events refined."""
    from ..telemetry import postmortem
    rep = postmortem.reconstruct(journal_dir, timelines=True)
    problems: list[str] = []
    for rid, r in sorted(rep["requests"].items()):
        evs = [row["event"] for row in r.get("timeline", [])
               if row.get("event") in protocol.VOCABULARY
               and row.get("event") not in
               ("failover", "alert")]     # fleet-scope: not per-request
        if not evs:
            continue            # frames without events: trace was off
        if stats is not None:
            stats["requests"] = stats.get("requests", 0) + 1
            stats["events"] = stats.get("events", 0) + len(evs)
        if evs[0] == "submitted" or not fragment:
            ok, phase, problem = protocol.accepts(evs)
            if not ok:
                problems.append(f"{rid}: {problem} (events: {evs})")
            elif r.get("complete") \
                    and phase != protocol.TERMINAL_PHASE:
                problems.append(
                    f"{rid}: journal says complete but the trace ends "
                    f"in phase '{phase}', not terminal (events: {evs})")
        else:
            ok, problem = protocol.accepts_fragment(evs)
            if not ok:
                problems.append(f"{rid}: fragment {problem} "
                                f"(events: {evs})")
    return problems


def refine_tree(root) -> dict:
    """Refine every journal under `root` (a dir holding events.log
    itself, or a tree of smoke-kept journals — `--procs` keeps per-slot
    dirs, which are refined as fleet fragments). The report counts the
    journals, requests and events refined, beside the problems."""
    root = Path(root)
    singles: list[Path] = []
    if (root / "events.log").is_file() or list(root.glob("req_*.req")):
        singles.append(root)
    else:
        for d in sorted(p for p in root.rglob("*") if p.is_dir()):
            if not ((d / "events.log").is_file()
                    or list(d.glob("req_*.req"))):
                continue
            if any(d.is_relative_to(s) for s in singles):
                continue
            singles.append(d)
    # sibling journal dirs under one parent = one fleet's slots
    by_parent: dict[Path, list[Path]] = {}
    for d in singles:
        by_parent.setdefault(d.parent, []).append(d)
    report = {"journals": 0, "requests": 0, "events": 0, "problems": []}
    for _parent, dirs in sorted(by_parent.items()):
        fleet = len(dirs) > 1
        for d in dirs:
            probs = refine_dir(d, fragment=fleet, stats=report)
            report["journals"] += 1
            report["problems"] += [f"{d}: {p}" for p in probs]
    return report


# ---------------------------------------------------------------------------
# CLI

def _run_properties(cfg: ModelConfig, quiet: bool) -> int:
    res = check(cfg)
    if res.ok:
        if not quiet:
            print(f"model: all {len(PROPERTIES)} properties hold on "
                  f"{cfg.requests}x{cfg.workers} "
                  f"(chunks={cfg.chunks}, crashes={cfg.crashes}, "
                  f"failovers={cfg.failovers}, "
                  f"zombie={cfg.zombie}) — {res.states} states")
        return 0
    print(render_trace(res))
    return 1


def _self_test(quiet: bool) -> int:
    rc = 0
    for requests in (2, 3):
        cfg = ModelConfig(requests=requests)
        rc |= _run_properties(cfg, quiet)
    for mutation, expected in sorted(MUTATIONS.items()):
        res = check(ModelConfig(mutation=mutation))
        if res.ok:
            print(f"FAIL: mutation {mutation} tripped nothing "
                  f"(expected {expected})")
            rc = 1
        elif res.property != expected:
            print(f"FAIL: mutation {mutation} tripped {res.property}, "
                  f"expected {expected}")
            print(render_trace(res))
            rc = 1
        elif not quiet:
            print(f"mutation {mutation}: trips exactly {expected} "
                  f"({PROPERTIES[expected]}) in {len(res.trace)} steps")
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.analysis.model",
        description="swarmmodel: explicit-state protocol checker + "
                    "journal trace refinement")
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--crashes", type=int, default=1)
    ap.add_argument("--mutate", choices=sorted(MUTATIONS),
                    help="inject one protocol mutation and print the "
                         "counterexample")
    ap.add_argument("--self-test", action="store_true",
                    help="prove all properties AND check every "
                         "mutation trips exactly its property")
    ap.add_argument("--refine", nargs="+", metavar="DIR",
                    help="refinement gate: real journals under DIR "
                         "must be accepted protocol traces")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.refine:
        rc = 0
        total = {"journals": 0, "problems": []}
        for root in args.refine:
            rep = refine_tree(root)
            total["journals"] += rep["journals"]
            total["problems"] += rep["problems"]
        for p in total["problems"]:
            print(f"REFINEMENT FAIL: {p}")
            rc = 1
        if not args.quiet:
            print(f"refinement: {total['journals']} journal(s), "
                  f"{len(total['problems'])} problem(s)")
        if total["journals"] == 0:
            print("REFINEMENT FAIL: no journals found under "
                  + ", ".join(args.refine))
            rc = 1
        return rc

    if args.self_test:
        return _self_test(args.quiet)

    cfg = ModelConfig(requests=args.requests, workers=args.workers,
                      chunks=args.chunks, crashes=args.crashes,
                      mutation=args.mutate)
    rc = _run_properties(cfg, args.quiet)
    if args.mutate:
        # a mutation that trips its property is the EXPECTED outcome
        # when eyeballing counterexamples; exit 0 iff it tripped
        return 0 if rc else 1
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""Postmortem: reconstruct request timelines from the serve journal alone
(a copy of `aclswarm_tpu/telemetry/postmortem.py`).

    python -m aclswarm_torch.telemetry.postmortem <journal-dir> \
        [--request-id RID] [--all] [--json]

The serve journal is the ONLY input: the ``events.log`` lifecycle
stream (`telemetry.lifecycle`, torn-tail-tolerant), the ``req_*.req``
acceptance frames, and the ``req_*.done`` terminal frames. No process
memory, no registry — which is exactly what makes this work AFTER a
worker crash: the killed process's appends survive on disk and the
recovery process appends strictly after them, so file order is causal
order across incarnations.

For every request the reconstruction produces:

- the **causally-ordered timeline** (every lifecycle event, in append
  order, with wall + monotonic timestamps);
- a **completeness verdict** (``submitted`` ... terminal ``resolved``
  both present) and a **gap-free verdict**: chunk indices cover
  ``0..chunks-1`` with no holes, re-executed chunks (at-least-once
  after a crash restore) must carry BIT-IDENTICAL digests, the
  terminal event is last, and one ``trace_id`` names every record;
- the **per-stage latency breakdown**: queue wait (admitted → first
  batched), batch wait (boundary requeue → next batched), device time
  (batched → chunk landed), preemption time (evicted → rescheduled),
  and the failover gap (worker death / crash recovery → rescheduled).

Wall-clock timestamps order the breakdown because a timeline may span
processes (monotonic clocks are only comparable within one ``pid`` —
the envelope records both, and same-pid spans prefer monotonic).

Exit status: 0 when every reconstructed request is complete and
gap-free, 1 otherwise — the CLI doubles as the postmortem drill's
assertion (`serve.smoke --postmortem`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

from aclswarm_torch.telemetry.lifecycle import (EVENTS, TERMINAL_EVENTS,
                                                LifecycleLog)

__all__ = ["load_journal", "analyze_request", "reconstruct",
           "fleet_summary", "fleet_merge_summary", "fleet_reconstruct",
           "main"]

EVENTS_LOG = "events.log"

# stage keys of the per-request latency breakdown (exported order)
STAGES = ("queue_wait_s", "batch_wait_s", "device_s", "preempted_s",
          "failover_gap_s", "total_s")


@dataclasses.dataclass
class Journal:
    """One serve journal, parsed: the lifecycle stream in causal order
    plus the acceptance/terminal frame ledgers."""

    path: str
    events: list            # lifecycle rows, file order (= causal order)
    torn_tail: bool
    reqs: dict              # request_id -> acceptance manifest
    dones: dict             # request_id -> (payload, manifest)


def load_journal(journal_dir) -> Journal:
    from aclswarm_torch.resilience import checkpoint as ckptlib

    d = Path(journal_dir)
    if not d.is_dir():
        raise FileNotFoundError(f"journal directory {d} does not exist")
    events, torn = [], False
    log = d / EVENTS_LOG
    if log.is_file():
        events, torn = LifecycleLog.read(log)
    reqs, dones = {}, {}
    for reqf in sorted(d.glob("req_*.req")):
        _, man = ckptlib.loads(reqf.read_bytes(), reqf)
        reqs[man["request_id"]] = man
    for donef in sorted(d.glob("req_*.done")):
        payload, man = ckptlib.loads(donef.read_bytes(), donef)
        dones[man["request_id"]] = (payload, man)
    return Journal(path=str(d), events=events, torn_tail=torn,
                   reqs=reqs, dones=dones)


def _request_rows(journal: Journal, rid: str) -> list[dict]:
    return [r for r in journal.events if r.get("request_id") == rid]


def analyze_request(rows: list[dict], rid: str,
                    req_man: Optional[dict] = None,
                    done_man: Optional[dict] = None) -> dict:
    """Verdicts + per-stage breakdown for one request's causally-ordered
    event rows. ``problems`` lists every violated invariant; the
    request is ``gap_free`` iff that list is empty."""
    problems: list[str] = []
    report: dict = {"request_id": rid, "trace_id": "", "events": len(rows),
                    "complete": False, "gap_free": False, "status": None,
                    "chunks": 0, "duplicate_chunks": 0, "migrations": 0,
                    "preemptions": 0, "resumes": 0, "problems": problems,
                    "stages": {k: 0.0 for k in STAGES}}
    if not rows:
        problems.append("no lifecycle events (accepted but traceless)")
        return report

    # -- trace identity: ONE id must name every record -------------------
    tids = {r.get("trace_id") for r in rows if r.get("trace_id")}
    if len(tids) > 1:
        problems.append(f"trace_id drift across the timeline: "
                        f"{sorted(tids)}")
    report["trace_id"] = sorted(tids)[0] if tids else ""
    if req_man is not None and req_man.get("trace_id") \
            and tids and req_man["trace_id"] not in tids:
        problems.append(
            f"acceptance frame trace_id {req_man['trace_id']!r} absent "
            "from the event stream")

    names = [r.get("event") for r in rows]
    for n in set(names):
        if n not in EVENTS:
            problems.append(f"unknown event kind {n!r} in the timeline")

    # -- completeness: submitted ... resolved, resolved last -------------
    if names[0] != "submitted":
        problems.append(f"timeline does not start at 'submitted' "
                        f"(starts at {names[0]!r})")
    resolved_idx = [i for i, n in enumerate(names)
                    if n in TERMINAL_EVENTS]
    resolved = rows[resolved_idx[-1]] if resolved_idx else None
    report["complete"] = "submitted" in names and resolved is not None
    if resolved is None:
        problems.append("no terminal 'resolved' event")
    else:
        report["status"] = resolved.get("status")
        trailing = [n for n in names[resolved_idx[-1] + 1:]]
        if trailing:
            problems.append(f"event(s) after the terminal resolved: "
                            f"{trailing}")
    if done_man is not None and resolved is not None \
            and done_man.get("status") != resolved.get("status"):
        problems.append(
            f"journal done-frame status {done_man.get('status')!r} != "
            f"resolved event status {resolved.get('status')!r}")

    # -- chunk coverage: contiguous, duplicates bit-identical ------------
    chunk_rows = [r for r in rows if r.get("event") == "chunk"]
    digests: dict[int, int] = {}
    dups = 0
    for r in chunk_rows:
        k, dg = int(r.get("k", -1)), int(r.get("digest", -1))
        if k in digests:
            dups += 1
            if digests[k] != dg:
                problems.append(
                    f"chunk {k} re-executed with a DIFFERENT digest "
                    f"({digests[k]:#x} then {dg:#x}) — resume was not "
                    "bit-identical")
        else:
            digests[k] = dg
    ks = sorted(digests)
    report["chunks"] = len(ks)
    report["duplicate_chunks"] = dups
    if ks and ks != list(range(ks[-1] + 1)):
        missing = sorted(set(range(ks[-1] + 1)) - set(ks))
        problems.append(f"chunk coverage has hole(s): missing {missing}")
    if resolved is not None and "chunks" in resolved \
            and int(resolved["chunks"]) != len(ks):
        problems.append(
            f"resolved event says {resolved['chunks']} chunk(s) but the "
            f"timeline records {len(ks)} distinct chunk event(s)")

    report["migrations"] = names.count("migrated")
    report["preemptions"] = names.count("preempted")
    report["resumes"] = names.count("resumed")
    batched = names.count("batched")
    if chunk_rows and batched < len(ks):
        problems.append(f"{len(ks)} chunk(s) but only {batched} "
                        "batched event(s) — a chunk ran unscheduled")

    # -- per-stage latency breakdown (wall clock: may span processes) ----
    st = report["stages"]
    t_sub = next((r["t_wall"] for r in rows
                  if r.get("event") in ("submitted", "admitted")), None)
    # queue wait anchors at ADMISSION (entering the picker queue);
    # total anchors at submit — the gap between them is the acceptance
    # path itself (journal frame write), charged to neither stage
    t_adm = next((r["t_wall"] for r in rows
                  if r.get("event") == "admitted"), t_sub)
    pending_t: Optional[float] = None
    pending_kind: Optional[str] = None
    last_batched: Optional[float] = None
    first_batched: Optional[float] = None
    for r in rows:
        ev, t = r.get("event"), r.get("t_wall")
        if t is None:
            continue
        if ev == "queued":
            pending_t, pending_kind = t, str(r.get("reason", "boundary"))
        elif ev == "preempted":
            pending_t, pending_kind = t, "preempt"
        elif ev == "migrated":
            pending_t, pending_kind = t, "failover"
        elif ev == "batched":
            if first_batched is None:
                first_batched = t
                if pending_kind in ("failover", "recovery") \
                        and pending_t is not None:
                    # crashed/failed over BEFORE ever being scheduled:
                    # the wait up to the failure marker is queue time,
                    # everything after it is the failover gap — a
                    # crash-at-admission must not masquerade as a
                    # quietly queue-bound request
                    if t_adm is not None:
                        st["queue_wait_s"] += max(0.0, pending_t - t_adm)
                    st["failover_gap_s"] += max(0.0, t - pending_t)
                elif t_adm is not None:
                    st["queue_wait_s"] += max(0.0, t - t_adm)
            elif pending_t is not None:
                gap = max(0.0, t - pending_t)
                key = {"boundary": "batch_wait_s",
                       "preempt": "preempted_s",
                       "failover": "failover_gap_s",
                       "recovery": "failover_gap_s"}.get(
                           pending_kind, "batch_wait_s")
                st[key] += gap
            pending_t = pending_kind = None
            last_batched = t
        elif ev == "chunk" and last_batched is not None:
            st["device_s"] += max(0.0, t - last_batched)
            last_batched = t      # next chunk of the same residency
        elif ev in TERMINAL_EVENTS:
            if t_sub is not None:
                st["total_s"] = max(0.0, t - t_sub)
            if not chunk_rows and last_batched is not None:
                # single-shot kinds: execution is batched -> resolved
                st["device_s"] += max(0.0, t - last_batched)
    for k in STAGES:
        st[k] = round(st[k], 6)

    report["gap_free"] = not problems
    return report


def reconstruct(journal_dir, request_id: Optional[str] = None,
                timelines: bool = False) -> dict:
    """Reconstruct every request's timeline (or one, via
    ``request_id``) from the journal directory alone. Returns the
    summary report; per-request event rows ride along when
    ``timelines`` is set."""
    journal = load_journal(journal_dir)
    rids = ([request_id] if request_id is not None else
            sorted(set(journal.reqs)
                   | {r["request_id"] for r in journal.events
                      if r.get("request_id")}))
    requests: dict = {}
    for rid in rids:
        rows = _request_rows(journal, rid)
        done = journal.dones.get(rid)
        rep = analyze_request(rows, rid, req_man=journal.reqs.get(rid),
                              done_man=done[1] if done else None)
        if timelines:
            rep["timeline"] = rows
        requests[rid] = rep
    complete = sum(1 for r in requests.values() if r["complete"])
    gap_free = sum(1 for r in requests.values() if r["gap_free"])
    return {
        "journal": journal.path,
        "torn_tail": journal.torn_tail,
        "accepted": len(journal.reqs),
        "reconstructed": len(requests),
        "complete": complete,
        "gap_free": gap_free,
        "events": len(journal.events),
        "requests": requests,
    }


def fleet_reconstruct(journal_dirs, timelines: bool = False) -> dict:
    """Reconstruct across a PROCESS FLEET's per-slot journals (the
    router tier's `journal_dirs()`): one request may have frames in
    several journals — journaled on the process that first accepted
    it, SIGKILLed, then re-journaled and finished on the survivor the
    router migrated it to. The merge rule is the promise rule:

    - a request is **resolved** iff SOME journal holds its terminal;
      its verdict (complete / gap-free / stages) is taken from that
      RESOLVING journal — the predecessor's truncated timeline is not
      a gap, it is a migration (counted, listed per-request);
    - a request journaled somewhere but terminal NOWHERE is a
      **loss** — the number the zero-loss drills assert is empty;
    - a request terminal in MORE THAN ONE journal is counted in
      ``duplicate_terminals``: the fleet is at-least-once across
      slots (the router re-places a dead slot's work onto a survivor
      while the dead slot's successor independently recovers its
      journal and honors the same promise) — bounded duplicate
      compute, never a lost or corrupted result. WITHIN a journal the
      fence makes zombie duplicates structurally impossible.
    """
    reports = [reconstruct(d, timelines=timelines)
               for d in journal_dirs]
    requests: dict = {}
    dup_terminals: list = []
    for rep in reports:
        for rid, r in rep["requests"].items():
            entry = dict(r)
            entry["journal"] = rep["journal"]
            prior = requests.get(rid)
            if prior is None:
                entry["migrated"] = False
                requests[rid] = entry
                continue
            if r["complete"] and prior["complete"]:
                dup_terminals.append(rid)
                continue
            if r["complete"]:
                # terminal wins; the earlier journal is the migration
                # source
                entry["migrated"] = True
                requests[rid] = entry
            else:
                prior["migrated"] = True
    resolved = sum(1 for r in requests.values() if r["complete"])
    gap_free = sum(1 for r in requests.values()
                   if r["complete"] and r["gap_free"])
    losses = sorted(rid for rid, r in requests.items()
                    if not r["complete"])
    return {
        "journals": [rep["journal"] for rep in reports],
        "torn_tail": any(rep["torn_tail"] for rep in reports),
        "accepted": len(requests),
        "resolved": resolved,
        "gap_free": gap_free,
        "migrated": sum(1 for r in requests.values()
                        if r.get("migrated")),
        "losses": losses,
        "duplicate_terminals": sorted(dup_terminals),
        "events": sum(rep["events"] for rep in reports),
        "requests": requests,
    }


def fleet_summary(report: dict) -> dict:
    """One-pass fleet rollup over a `reconstruct` report: verdict
    counts, terminal-status census, chaos counters, and the AGGREGATE
    per-stage latency table (sum / mean / max across every request) —
    the `--all` CLI surface. Shares the loaders: the report is the
    same object the per-request CLI renders."""
    reqs = report["requests"]
    statuses: dict[str, int] = {}
    stages = {k: {"sum_s": 0.0, "max_s": 0.0} for k in STAGES}
    migrations = preemptions = resumes = dup_chunks = chunks = 0
    for rep in reqs.values():
        statuses[str(rep.get("status"))] = \
            statuses.get(str(rep.get("status")), 0) + 1
        migrations += rep.get("migrations", 0)
        preemptions += rep.get("preemptions", 0)
        resumes += rep.get("resumes", 0)
        dup_chunks += rep.get("duplicate_chunks", 0)
        chunks += rep.get("chunks", 0)
        for k, v in rep.get("stages", {}).items():
            if k in stages and isinstance(v, (int, float)):
                stages[k]["sum_s"] += v
                stages[k]["max_s"] = max(stages[k]["max_s"], v)
    n = max(1, len(reqs))
    for k in stages:
        stages[k] = {"sum_s": round(stages[k]["sum_s"], 6),
                     "mean_s": round(stages[k]["sum_s"] / n, 6),
                     "max_s": round(stages[k]["max_s"], 6)}
    return {
        "journal": report["journal"],
        "accepted": report["accepted"],
        "reconstructed": report["reconstructed"],
        "complete": report["complete"],
        "gap_free": report["gap_free"],
        "events": report["events"],
        "torn_tail": report["torn_tail"],
        "statuses": statuses,
        "chunks": chunks,
        "duplicate_chunks": dup_chunks,
        "migrations": migrations,
        "preemptions": preemptions,
        "resumes": resumes,
        "stages": stages,
        "incomplete": sorted(rid for rid, r in reqs.items()
                             if not (r["complete"] and r["gap_free"])),
    }


def fleet_merge_summary(rep: dict) -> dict:
    """`fleet_summary` over a `fleet_reconstruct` merge: the same
    rollup table, plus the cross-journal columns the single-journal
    path cannot have — ``losses`` (journaled, terminal nowhere) and
    ``duplicate_terminals`` (terminal in MORE than one slot journal:
    legal at-least-once duplicate compute, but a nonzero count is a
    budget the `--all` gate makes visible and enforceable)."""
    base = fleet_summary({
        "journal": " + ".join(str(j) for j in rep["journals"]),
        "accepted": rep["accepted"],
        "reconstructed": rep["resolved"],
        "complete": rep["resolved"],
        "gap_free": rep["gap_free"],
        "events": rep["events"],
        "torn_tail": rep["torn_tail"],
        "requests": rep["requests"],
    })
    base["migrated"] = rep["migrated"]
    base["losses"] = rep["losses"]
    base["duplicate_terminals"] = rep["duplicate_terminals"]
    return base


def _print_fleet(summary: dict) -> None:
    print(f"journal {summary['journal']}: {summary['accepted']} "
          f"accepted, {summary['reconstructed']} reconstructed — "
          f"{summary['complete']} complete, {summary['gap_free']} "
          f"gap-free"
          + (" [torn tail dropped]" if summary["torn_tail"] else ""))
    print(f"  statuses: {json.dumps(summary['statuses'], sort_keys=True)}")
    print(f"  chunks {summary['chunks']} "
          f"(dup {summary['duplicate_chunks']})  "
          f"migrations {summary['migrations']}  "
          f"preemptions {summary['preemptions']}  "
          f"resumes {summary['resumes']}  events {summary['events']}")
    if "duplicate_terminals" in summary:       # fleet-merge columns
        print(f"  migrated {summary['migrated']}  "
              f"losses {len(summary['losses'])}  "
              f"duplicate_terminals "
              f"{len(summary['duplicate_terminals'])}")
    print(f"  {'stage':<16} {'sum_s':>10} {'mean_s':>10} {'max_s':>10}")
    for k in STAGES:
        st = summary["stages"][k]
        print(f"  {k:<16} {st['sum_s']:>10.3f} {st['mean_s']:>10.3f} "
              f"{st['max_s']:>10.3f}")
    for rid in summary.get("duplicate_terminals", ()):
        print(f"  DUPLICATE: {rid} terminal in more than one journal "
              f"(at-least-once duplicate compute)")
    for rid in summary["incomplete"]:
        print(f"  PROBLEM: {rid} does not reconstruct complete+gap-free")


def _fmt_event(r: dict, t0: float) -> str:
    skip = {"event", "request_id", "trace_id", "t_wall", "t_mono",
            "seq", "pid"}
    extras = " ".join(f"{k}={r[k]}" for k in sorted(r) if k not in skip)
    dt = (r["t_wall"] - t0) if r.get("t_wall") is not None else 0.0
    return f"  +{dt:9.3f}s  {r.get('event', '?'):<12} {extras}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("journal", nargs="+",
                    help="serve journal directory — pass SEVERAL "
                         "(one per process-fleet slot) for the "
                         "cross-journal merge: migrated requests "
                         "resolve wherever their terminal landed, "
                         "and the exit code asserts zero losses")
    ap.add_argument("--request-id", default=None,
                    help="reconstruct one request (default: all)")
    ap.add_argument("--all", action="store_true", dest="fleet",
                    help="one-pass fleet summary over every request "
                         "(verdict counts + aggregate per-stage latency "
                         "table) instead of per-request timelines; with "
                         "SEVERAL journals the summary adds the merge "
                         "columns (migrated / losses / duplicate "
                         "terminals) and a nonzero duplicate-terminal "
                         "count fails the gate")
    ap.add_argument("--json", action="store_true",
                    help="emit the full machine-readable report")
    args = ap.parse_args(argv)
    if len(args.journal) > 1:
        rep = fleet_reconstruct(args.journal)
        if args.fleet:
            # fleet-merge summary table: duplicate terminals are legal
            # at-least-once behavior on the plain merge path, but the
            # --all gate treats a nonzero count as a failure — the
            # duplicate-compute budget is an assertable surface
            summary = fleet_merge_summary(rep)
            if args.json:
                print(json.dumps(summary, indent=1, sort_keys=True,
                                 default=str))
            else:
                _print_fleet(summary)
            return 0 if not (rep["losses"]
                             or rep["duplicate_terminals"]) else 1
        if args.json:
            print(json.dumps(rep, indent=1, sort_keys=True,
                             default=str))
        else:
            print(f"fleet merge of {len(rep['journals'])} journals: "
                  f"{rep['accepted']} accepted, {rep['resolved']} "
                  f"resolved, {rep['gap_free']} gap-free, "
                  f"{rep['migrated']} migrated, "
                  f"{len(rep['duplicate_terminals'])} duplicate "
                  f"terminal(s), {rep['events']} events"
                  + (" [torn tail dropped]" if rep["torn_tail"]
                     else ""))
            for rid in rep["losses"]:
                print(f"  LOSS: {rid} journaled but terminal in NO "
                      f"journal")
        return 0 if not rep["losses"] else 1
    report = reconstruct(args.journal[0], request_id=args.request_id,
                         timelines=not args.fleet)
    if args.fleet:
        summary = fleet_summary(report)
        if args.json:
            print(json.dumps(summary, indent=1, sort_keys=True,
                             default=str))
        else:
            _print_fleet(summary)
        return 0 if not summary["incomplete"] else 1
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True, default=str))
    else:
        print(f"journal {report['journal']}: {report['accepted']} "
              f"accepted, {report['reconstructed']} reconstructed, "
              f"{report['complete']} complete, {report['gap_free']} "
              f"gap-free"
              + (" [torn tail dropped]" if report["torn_tail"] else ""))
        for rid, rep in sorted(report["requests"].items()):
            rows = rep.get("timeline", [])
            t0 = rows[0]["t_wall"] if rows and rows[0].get("t_wall") \
                else 0.0
            verdict = ("OK" if rep["gap_free"] else
                       "INCOMPLETE" if not rep["complete"] else "GAPPY")
            print(f"\n{rid}  trace={rep['trace_id'] or '?'}  "
                  f"status={rep['status']}  chunks={rep['chunks']}  "
                  f"[{verdict}]")
            for r in rows:
                print(_fmt_event(r, t0))
            stages = " ".join(f"{k}={v:.3f}"
                              for k, v in rep["stages"].items())
            print(f"  stages: {stages}")
            for p in rep["problems"]:
                print(f"  PROBLEM: {p}")
    bad = [rid for rid, rep in report["requests"].items()
           if not (rep["complete"] and rep["gap_free"])]
    if bad:
        print(f"\nPOSTMORTEM FAILED: {len(bad)} request(s) do not "
              f"reconstruct to complete, gap-free timelines: "
              f"{sorted(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

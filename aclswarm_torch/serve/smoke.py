"""serve smoke (port of `aclswarm_tpu/serve/smoke.py`): kill the serving
process mid-batch, recover, prove zero losses and a bit-identical resume.

1. a CHILD process starts a journaled `SwarmService`, submits 3 mixed
   requests (a faulted rollout, an assignment, a gain design), and is
   ``SIGKILL``ed by the env-armed `CrashPlan` at serve round boundary
   `KILL_ROUND` — mid-batch, with the rollout partly done and
   checkpointed;
2. the parent checks that the child died by the signal, then starts a
   SECOND child on the SAME journal: recovery re-admits every accepted but
   unfinished request (the rollout from its checkpoint) and drains;
3. the parent asserts that every accepted request has a terminal
   done-frame (zero silent losses) and that the resumed rollout's final
   digest equals an uninterrupted in-parent run's (served while the
   first child runs), bit for bit.

    python -m aclswarm_torch.serve.smoke [--device cpu --dtype float64]
                                         [--n N]

``--multiworker`` runs the worker-crash half instead: a 2-worker
journaled service with the health tier on (``watch=True``), the worker
owning the rollout's bucket killed mid-batch by a worker-targeted
`CrashPlan`, the orphaned rollout failed over to the surviving worker
through the checkpoint codec — zero losses, the migrated resume
bit-identical to an uncontended run, the service serving throughout, and
the kill visible live: a ``worker_up`` alert fired on the ``health``
surface and journaled, and ``watch --log`` over the persisted
``timeseries.log`` replays the transitions the live engine journaled.

``--postmortem`` kills a worker mid-rollout the same way, then rebuilds
the migrated request's story from the journal alone
(`telemetry.postmortem.reconstruct`): complete, gap-free, one trace id
equal to the result's, a migration, chunk coverage equal to the
result's, and the supervisor's "declared dead" span dump.

``--procs`` is the process-mode drill: a router (`serve.router`) over
two `serve.procworker` processes, each serving on its own CUDA context;
the process holding the rollout is SIGKILLed mid-flight. The three
router promises complete with zero losses, the migrated rollout's digest
equals an uncontended in-parent run's, a rolling restart re-admits a
new pid per slot, and `telemetry.postmortem.fleet_reconstruct` over the
per-slot journals alone finds the rollout complete and gap-free and no
losses. Its JSON line carries each child's boot seconds (spawn to
READY), the detection ms, the failover and restart seconds, and the
children's kernel launches (each child's last heartbeat).

Without ``--device`` everything runs on the CUDA card (the children
too). ``--n`` sizes the rollout and the assignment (the gain design
stays at n=5). The rollout assigns by Sinkhorn (the reference's smoke:
the auction), so on the card it runs through K1 and K2; on the CPU their
plain versions.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from aclswarm_torch import ops
from aclswarm_torch.resilience.crash import ENV_VAR, CrashPlan, arm
from aclswarm_torch.serve import (ServiceConfig, SwarmService, bucket_of,
                                  place_slot)
from aclswarm_torch.serve.service import _read_frame
from aclswarm_torch.telemetry import postmortem
from aclswarm_torch.telemetry.lifecycle import LifecycleLog
from aclswarm_torch.telemetry.slo import default_slos
from aclswarm_torch.telemetry.watch import replay_log

# On the pipelined schedule (`_round_start` dispatches round k+1 before
# round k resolves), round 1 dispatches the rollout's chunk 1, round 2
# runs a single-shot request while chunk 1 resolves and checkpoints, and
# round 3 re-picks the rollout: killing at 3 lands with exactly one chunk
# durable and the next in flight.
KILL_ROUND = 3


def requests(n: int = 5) -> list:
    """The smoke's three requests; ``n`` sizes the rollout and the
    assignment."""
    return [
        {"kind": "rollout", "tenant": "a", "request_id": "smoke-roll",
         "params": {"n": n, "ticks": 80, "chunk_ticks": 20, "seed": 11,
                    "assignment": "sinkhorn",
                    "faults": {"dropout_frac": 0.4, "drop_tick": 15,
                               "rejoin_tick": 45}}},
        {"kind": "assign", "tenant": "b", "request_id": "smoke-assign",
         "params": {"n": 12 if n == 5 else n, "seed": 3}},
        {"kind": "gains", "tenant": "c", "request_id": "smoke-gains",
         "params": {"n": 5, "seed": 0}},
    ]


@contextlib.contextmanager
def _journal_dir(tag: str):
    """The smoke's journal directory: temporary by default; kept under
    ``$ACLSWARM_KEEP_JOURNALS/<tag>/`` when that variable names a
    directory."""
    keep = os.environ.get("ACLSWARM_KEEP_JOURNALS")
    if keep:
        d = Path(keep) / tag
        d.mkdir(parents=True, exist_ok=True)
        yield str(d)
        return
    with tempfile.TemporaryDirectory(
            prefix=f"aclswarm_torch_{tag}_smoke_") as d:
        yield d


def _cfg(args, **kw) -> ServiceConfig:
    return ServiceConfig(device=args.device, dtype=args.dtype, **kw)


def _service(args, journal: str) -> SwarmService:
    # max_batch=1 serializes the rounds so the kill boundary is
    # deterministic
    return SwarmService(_cfg(args, max_batch=1, quantum_chunks=1,
                             journal_dir=journal))


def child(args) -> int:
    svc = _service(args, args.dir)
    tickets = [svc.submit(r["kind"], r["params"], tenant=r["tenant"],
                          request_id=r["request_id"])
               for r in requests(args.n)]
    # armed: the SIGKILL lands inside the worker loop; this wait never
    # finishes in run 1 and drains cleanly in run 2
    for t in tickets:
        t.result(timeout=600)
    svc.close()
    print("child: all requests terminal")
    print(json.dumps({"child_launches": dict(ops.LAUNCHES)}), flush=True)
    return 0


def _child_launches(stdout: str) -> dict:
    for line in stdout.splitlines():
        if line.startswith('{"child_launches"'):
            return json.loads(line)["child_launches"]
    return {}


def _child_cmd(args, d: str) -> list:
    cmd = [sys.executable, "-m", "aclswarm_torch.serve.smoke", "--child",
           "--dir", d, "--n", str(args.n), "--dtype", args.dtype]
    if args.device is not None:
        cmd += ["--device", args.device]
    return cmd


def run_smoke(args) -> int:
    reqs = requests(args.n)
    timing = {}
    with _journal_dir("serve") as d:
        env = dict(os.environ, **{ENV_VAR: f"serve:{KILL_ROUND}:kill"})
        t0 = time.time()
        child1 = subprocess.Popen(_child_cmd(args, d), env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        try:
            # the uninterrupted run the resume is held against serves in
            # the parent while the first child runs to its kill
            t1 = time.time()
            before = dict(ops.LAUNCHES)
            ref = SwarmService(_cfg(args, max_batch=1))
            ref_res = ref.submit(reqs[0]["kind"],
                                 reqs[0]["params"]).result(600)
            ref.close()
            timing["reference_s"] = time.time() - t1
            ref_launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
            out1, err1 = child1.communicate(timeout=900)
        finally:
            if child1.poll() is None:
                child1.kill()
                child1.wait()
        timing["killed_child_s"] = time.time() - t0
        if child1.returncode != -signal.SIGKILL:
            print(f"FAIL: child exited {child1.returncode}, expected "
                  f"{-signal.SIGKILL} (SIGKILL)\n{out1}\n{err1}")
            return 1
        accepted = sorted(p.name for p in Path(d).glob("req_*.req"))
        if len(accepted) != len(reqs):
            print(f"FAIL: journal lost acceptances: {accepted}")
            return 1
        print(f"worker SIGKILL'd at serve round {KILL_ROUND} after "
              f"{timing['killed_child_s']:.1f}s; journal: {len(accepted)} "
              "accepted requests survive")

        env2 = dict(os.environ)
        env2.pop(ENV_VAR, None)
        t0 = time.time()
        r2 = subprocess.run(_child_cmd(args, d), env=env2,
                            capture_output=True, text=True, timeout=900)
        timing["recovery_child_s"] = time.time() - t0
        if r2.returncode != 0:
            print(f"FAIL: recovery child exited {r2.returncode}\n"
                  f"{r2.stdout}\n{r2.stderr}")
            return 1

        # zero silent losses: every accepted request is terminal
        ledger = {}
        for reqf in Path(d).glob("req_*.req"):
            rid = reqf.name[len("req_"):-len(".req")]
            donef = reqf.with_suffix(".done")
            if not donef.exists():
                print(f"FAIL: request {rid} accepted but never terminal "
                      "(SILENT LOSS)")
                return 1
            _, man = _read_frame(donef)
            ledger[rid] = man
        statuses = {k: v["status"] for k, v in ledger.items()}
        print(f"ledger: {json.dumps(statuses, sort_keys=True)}")
        if set(statuses.values()) != {"completed"}:
            print("FAIL: expected every smoke request to complete")
            return 1
        if not ledger["smoke-roll"].get("resumed"):
            print("FAIL: rollout did not resume from its checkpoint")
            return 1

        # bit-identical resume: against the uninterrupted run
        payload, _ = _read_frame(Path(d) / "req_smoke-roll.done")
        resumed_digest = payload["value"]["digest"]
        launches = {"recovery_child": _child_launches(r2.stdout),
                    "reference": ref_launches}
        if ref_res.value["digest"] != resumed_digest:
            print(f"FAIL: resumed digest {resumed_digest:#x} != "
                  f"uninterrupted {ref_res.value['digest']:#x}")
            return 1
    print(json.dumps({"serve_smoke": "recovery", "n": args.n,
                      "digest": resumed_digest, "launches": launches,
                      **{k: round(v, 3) for k, v in timing.items()}}))
    print("PASS: SIGKILL mid-batch lost nothing — 3/3 accepted requests "
          "terminal after recovery, resumed rollout bit-identical "
          f"(digest {resumed_digest:#010x})")
    return 0


def run_multiworker(args) -> int:
    """The worker-crash failover drill: kill one of two workers (an
    abrupt thread death, in-flight work orphaned), assert zero losses and
    a bit-identical cross-worker migrated resume."""
    t0 = time.time()
    reqs = requests(args.n)
    roll = reqs[0]["params"]
    # the bit-parity reference: an uncontended single-worker run
    ref = SwarmService(_cfg(args, max_batch=1))
    want = ref.submit("rollout", roll).result(600)
    ref.close()
    assert want.ok, want.error

    with _journal_dir("mw") as d:
        # the health tier rides the drill: the kill below must surface
        # on the live health surface, not just in the journal. Rejoin
        # backoff > sampler interval, so the dead slot's gauge is
        # sampled down at least once before the respawn flips it back.
        svc = SwarmService(_cfg(
            args, workers=2, max_batch=1, quantum_chunks=8, journal_dir=d,
            supervise_poll_s=0.02, rejoin_base_s=0.3,
            watch=True, watch_interval_s=0.05))
        # kill the worker that OWNS the rollout bucket, at its round 2:
        # one chunk done and checkpointed, the next in flight. The
        # rollout goes in ALONE so the victim's round schedule is
        # deterministic; the single-shot requests follow once the kill
        # has landed, proving the degraded fleet keeps serving.
        slot = place_slot(bucket_of("rollout", roll), [0, 1])
        arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        tickets = [svc.submit(reqs[0]["kind"], roll,
                              tenant=reqs[0]["tenant"],
                              request_id=reqs[0]["request_id"])]
        deadline = time.monotonic() + 300
        while svc.stats["failovers"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        tickets += [svc.submit(r["kind"], r["params"], tenant=r["tenant"],
                               request_id=r["request_id"])
                    for r in reqs[1:]]
        results = {r["request_id"]: t.result(timeout=600)
                   for r, t in zip(reqs, tickets)}
        arm(None)
        stats = dict(svc.stats)
        alive_through = svc.alive
        health = svc.submit("health", {}, tenant="ops").result(60)
        svc.close()
        if not health.ok or health.value["workers"]["total"] != 2 \
                or not health.value.get("watch_enabled"):
            print(f"FAIL: health scrape unusable: {health.status}")
            return 1
        wu = (health.value.get("watch") or {}).get(
            "verdicts", {}).get("worker_up", {})
        if int(wu.get("fired", 0)) < 1:
            print("FAIL: the worker kill never fired a worker_up alert "
                  f"on the live health surface (verdict: {wu})")
            return 1
        rows, _ = LifecycleLog.read(Path(d) / "events.log")
        live = [(r["slo"], r["labels"], r["state"]) for r in rows
                if r.get("event") == "alert"]
        if ("worker_up", f"{{worker={slot}}}", "firing") not in live:
            print("FAIL: no worker_up firing alert record in the "
                  f"journal's events.log (alerts: {live})")
            return 1
        # the postmortem twin: the persisted history, replayed through
        # the same catalog, fires what the live engine journaled
        replay = replay_log(Path(d) / "timeseries.log", specs=default_slos(
            max_queue_total=svc.cfg.max_queue_total))
        replayed = [(e["slo"], e["labels"], e["state"])
                    for e in replay["transitions"]]
        if replayed != live:
            print(f"FAIL: watch --log replays {replayed}, the live "
                  f"engine journaled {live}")
            return 1
        losses = [rid for rid, res in results.items()
                  if res.status != "completed"]
        if losses:
            print(f"FAIL: requests did not complete across the worker "
                  f"kill: {losses}")
            return 1
        roll_res = results["smoke-roll"]
        if roll_res.failovers < 1:
            print("FAIL: the rollout never migrated (failovers="
                  f"{roll_res.failovers}) — the kill missed its worker")
            return 1
        if roll_res.value["digest"] != want.value["digest"]:
            print(f"FAIL: migrated digest {roll_res.value['digest']:#x} "
                  f"!= uncontended {want.value['digest']:#x}")
            return 1
        if stats["failovers"] < 1 or stats["requeued"] < 1:
            print(f"FAIL: failover not recorded in stats: {stats}")
            return 1
        if not alive_through:
            print("FAIL: service reported dead during a routine "
                  "worker failover")
            return 1
    print(json.dumps({"serve_smoke": "multiworker", "n": args.n,
                      "launches": dict(ops.LAUNCHES), "alerts": live,
                      "seconds": round(time.time() - t0, 3)}))
    print("PASS: worker kill mid-batch lost nothing — 3/3 requests "
          f"terminal, rollout migrated off worker {slot} after "
          f"{roll_res.failovers} failover(s), resume bit-identical "
          f"(digest {roll_res.value['digest']:#010x}); the health tier "
          f"saw the kill live (worker_up fired {int(wu.get('fired', 0))}x "
          f"on the health surface, {len(live)} journaled alert "
          f"transition(s), replayed alike from timeseries.log), "
          f"{time.time() - t0:.1f}s")
    return 0


def run_postmortem(args) -> int:
    """The postmortem drill: kill a worker mid-rollout, then prove the
    migrated request's whole story reconstructs from the journal alone
    — complete, causally ordered, gap-free — with the failover visible
    in the per-stage latency breakdown."""
    t0 = time.time()
    roll = requests(args.n)[0]["params"]
    with _journal_dir("pm") as d:
        svc = SwarmService(_cfg(
            args, workers=2, max_batch=1, quantum_chunks=8, journal_dir=d,
            supervise_poll_s=0.02, rejoin_base_s=0.05))
        slot = place_slot(bucket_of("rollout", roll), [0, 1])
        arm(CrashPlan(f"serve.w{slot}", 2, "raise"))
        res = svc.submit("rollout", roll, tenant="a",
                         request_id="pm-roll").result(timeout=600)
        arm(None)
        svc.close()
        if not res.ok or res.failovers < 1:
            print(f"FAIL: expected a migrated completion, got "
                  f"{res.status} (failovers={res.failovers})")
            return 1

        # reconstruction from disk alone: the service object above is
        # deliberately not consulted
        report = postmortem.reconstruct(d)
        rep = report["requests"].get("pm-roll")
        if rep is None:
            print("FAIL: postmortem found no timeline for pm-roll")
            return 1
        problems = []
        if not rep["complete"]:
            problems.append("timeline incomplete")
        if not rep["gap_free"]:
            problems.append(f"timeline not gap-free: {rep['problems']}")
        if rep["migrations"] < 1:
            problems.append("no migrated event in the timeline")
        if rep["trace_id"] != res.trace_id:
            problems.append(
                f"trace_id drift: result {res.trace_id!r} vs journal "
                f"{rep['trace_id']!r}")
        if rep["chunks"] != res.chunks:
            problems.append(f"chunk coverage {rep['chunks']} != "
                            f"result chunks {res.chunks}")
        # the close() dump always writes the file — only a header whose
        # reason names the worker death proves the supervisor flushed
        # (the path a killed worker depends on)
        dumpf = Path(d) / "spans_dump.jsonl"
        headers = []
        if dumpf.is_file():
            headers = [json.loads(ln)
                       for ln in dumpf.read_text().splitlines()
                       if '"span_dump"' in ln]
        if not any("declared dead" in h.get("span_dump", "")
                   for h in headers):
            problems.append(
                "supervisor did not flush the span ring on the worker "
                "death (no 'declared dead' dump header; saw "
                f"{[h.get('span_dump') for h in headers]})")
        if problems:
            print("FAIL: " + "; ".join(problems))
            return 1
        st = rep["stages"]
    print(json.dumps({"serve_smoke": "postmortem", "n": args.n,
                      "launches": dict(ops.LAUNCHES), "stages": st,
                      "events": rep["events"], "chunks": rep["chunks"],
                      "seconds": round(time.time() - t0, 3)}))
    print("PASS: killed worker %s mid-rollout; postmortem reconstructed "
          "a complete, gap-free timeline from the journal alone — "
          "%d events, %d chunks, %d migration(s), trace %s, stages "
          "queue=%.3fs device=%.3fs failover_gap=%.3fs (%.1fs)"
          % (slot, rep["events"], rep["chunks"], rep["migrations"],
             rep["trace_id"], st["queue_wait_s"], st["device_s"],
             st["failover_gap_s"], time.time() - t0))
    return 0


def run_procs(args) -> int:
    """The process-mode drill: a router tier over two procworker OS
    processes, SIGKILL the one holding the rollout mid-flight, and prove
    (a) the router's promises survive — every ticket resolves completed,
    the rollout with a digest equal to an uncontended run's, (b) a
    graceful rolling restart re-admits a NEW incarnation per slot while
    the fleet keeps serving, (c) zero journaled losses and a gap-free
    story reconstruct from the per-slot journals alone
    (`postmortem.fleet_reconstruct` — the killed pid is gone)."""
    from aclswarm_torch.serve.router import RouterConfig, SwarmRouter

    t0 = time.time()
    reqs = requests(args.n)
    roll = reqs[0]["params"]
    service = {"max_batch": 1, "quantum_chunks": 1, "dtype": args.dtype}
    if args.device is not None:
        service["device"] = args.device
    with _journal_dir("proc") as d:
        router = SwarmRouter(RouterConfig(journal_root=d, slots=2,
                                          worker={"service": service}))
        try:
            router.start()
            # the bit-parity reference, an uncontended in-parent run,
            # serves while the children boot
            before = dict(ops.LAUNCHES)
            ref = SwarmService(_cfg(args, max_batch=1))
            want = ref.submit("rollout", roll).result(600)
            ref.close()
            assert want.ok, want.error
            ref_launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
            timing = {"reference_s": time.time() - t0}
            if not router.wait_ready(300):
                print(f"FAIL: fleet never came up: {router.fleet()}")
                return 1
            pids0 = {f["slot"]: f["pid"] for f in router.fleet()}
            tickets = [router.submit(r["kind"], r["params"],
                                     tenant=r["tenant"],
                                     request_id=r["request_id"])
                       for r in reqs]
            # kill the PROCESS that holds the rollout once its route is
            # placed there
            deadline = time.monotonic() + 120
            uid = ""
            while not uid and time.monotonic() < deadline:
                uid = router.route_uid("smoke-roll")
                time.sleep(0.005)
            if not uid:
                print("FAIL: the rollout was never dispatched")
                return 1
            t_kill = time.time()
            drill = router.kill_slot(int(uid.split(".")[0]))
            timing["readmit_s"] = time.time() - t_kill
            results = {r["request_id"]: t.result(timeout=600)
                       for r, t in zip(reqs, tickets)}
            timing["failover_s"] = time.time() - t_kill
            losses = [rid for rid, res in results.items()
                      if res.status != "completed"]
            if losses:
                print(f"FAIL: lost across the process kill: {losses} "
                      f"({ {k: v.status for k, v in results.items()} })")
                return 1
            roll_res = results["smoke-roll"]
            if roll_res.value["digest"] != want.value["digest"]:
                print(f"FAIL: migrated digest "
                      f"{roll_res.value['digest']:#x} != uncontended "
                      f"{want.value['digest']:#x}")
                return 1
            if drill["migrated"] < 1 or not drill["readmitted"]:
                print(f"FAIL: kill drill did not migrate + readmit: "
                      f"{drill}")
                return 1
            restart = router.rolling_restart()
        finally:
            jdirs = [str(p) for p in router.journal_dirs()]
            router.close()
        bad = [row for row in restart
               if not (row["readmitted"] and row["drained"])]
        if bad:
            print(f"FAIL: rolling restart rows not clean: {bad}")
            return 1
        pids1 = {row["slot"]: row["new_pid"] for row in restart}
        if any(pids1[sl] == pids0.get(sl) for sl in pids1):
            print(f"FAIL: rolling restart reused a pid: {pids0} -> "
                  f"{pids1}")
            return 1
        # the journals are all that's left of the killed pid — the
        # whole story must reconstruct from disk alone
        fleet = postmortem.fleet_reconstruct(jdirs)
        if fleet["losses"]:
            print(f"FAIL: journaled losses after the drill: "
                  f"{fleet['losses']}")
            return 1
        rep = fleet["requests"].get("smoke-roll")
        if rep is None or not rep["complete"] or not rep["gap_free"]:
            print(f"FAIL: smoke-roll does not reconstruct "
                  f"complete+gap-free from the fleet journals: "
                  f"{rep and rep['problems']}")
            return 1
    children = {k: sum(c["launches"].get(k, 0)
                       for c in router.child_launches.values())
                for k in ops.LAUNCHES}
    print(json.dumps({
        "serve_smoke": "procs", "n": args.n,
        "digest": roll_res.value["digest"],
        "launches": {"children": children, "reference": ref_launches},
        "child_launches": router.child_launches,
        "boots": router.boots, "detect_ms": (drill["detect_s"] or 0) * 1e3,
        "migrated": drill["migrated"],
        "restart_s": [row["restart_s"] for row in restart],
        "pids": {"start": pids0, "killed": drill["old_pid"],
                 "respawned": drill["new_pid"], "restarted": pids1},
        "fleet": {k: fleet[k] for k in ("resolved", "gap_free")},
        **{k: round(v, 3) for k, v in timing.items()},
        "seconds": round(time.time() - t0, 3)}))
    print("PASS: SIGKILL'd procworker pid %s mid-rollout — 3/3 router "
          "promises completed, migrated digest bit-identical (%#010x), "
          "detection %.0f ms, %d route(s) migrated; rolling restart "
          "re-admitted %d fresh incarnation(s); fleet postmortem from %d "
          "journals: %d resolved, %d gap-free, 0 losses (%.1fs)"
          % (drill["old_pid"], roll_res.value["digest"],
             (drill["detect_s"] or 0) * 1e3, drill["migrated"],
             len(restart), len(jdirs), fleet["resolved"],
             fleet["gap_free"], time.time() - t0))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help="(internal) the killable service run")
    ap.add_argument("--dir", default=None,
                    help="(internal) journal directory")
    ap.add_argument("--multiworker", action="store_true",
                    help="worker-crash failover drill (2 workers, kill "
                         "one mid-batch, bit-identical migrated resume)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the CUDA card)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--n", type=int, default=5,
                    help="rollout and assignment size (default 5)")
    ap.add_argument("--postmortem", action="store_true",
                    help="postmortem drill (kill a worker mid-rollout, "
                         "rebuild its timeline from the journal alone)")
    ap.add_argument("--procs", action="store_true",
                    help="process-mode drill: router + 2 procworker "
                         "processes, SIGKILL the rollout's mid-flight, "
                         "assert zero-loss migration, bit-identical "
                         "digest, rolling restart, and a gap-free fleet "
                         "postmortem from the per-slot journals alone")
    args = ap.parse_args(argv)
    if args.procs:
        return run_procs(args)
    if args.child:
        return child(args)
    if args.multiworker:
        return run_multiworker(args)
    if args.postmortem:
        return run_postmortem(args)
    return run_smoke(args)


if __name__ == "__main__":
    sys.exit(main())

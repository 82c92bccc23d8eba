"""Process-mode worker: one `SwarmService` slot per OS process (port of
`aclswarm_tpu/serve/procworker.py`).

``python -m aclswarm_torch.serve.procworker --slot 0 --incarnation 3
--supervisor 127.0.0.1:PORT --journal-dir /path/w0`` is the supervised
child entrypoint the router tier (`serve.router`) spawns: it hosts ONE
worker cell — its own torch runtime and CUDA context on the card, its own
`SwarmService` (workers=1), its own `WireServer` data plane on an
ephemeral TCP port — and speaks the codec-framed wire protocol back to the
router as its supervision channel:

- **HELLO** (`wire.K_HELLO`) carries ``slot`` + ``incarnation`` +
  ``pid``: the router's admission decides duplicate-slot races —
  exactly one claimant wins, the loser is refused with a structured
  `wire.K_ERROR` *before it ever builds a service*, so a refused
  process cannot write a single journal frame;
- **heartbeats are wire frames** (`wire.K_PING` with a compact stats
  payload, the process's kernel launch counts (``launches`` =
  `ops.LAUNCHES`) and the kernel library it loaded (``library`` =
  `ops._build.LOADED`, whose ``cached`` says it was not rebuilt)): the
  thread-fleet lease semantics from `serve.workers` carry over with
  "thread death" replaced by "connection death OR process exit". A
  clean exit sends one last beat, so the router's count of a child's
  launches is exact for a child that exits and runs to its last beat
  for one that is SIGKILLed;
- **fencing is incarnation-stamped journal frames**: before recovery
  this process stamps its per-slot journal dir with its own
  incarnation (`service.write_fence`), so a zombie predecessor that
  missed its lease but never exited observes the fence and every
  journal write it still attempts is a loud no-op
  (`SwarmService._fence_ok`);
- **READY** (`wire.K_EVENT`) is sent only after the service is built,
  the journal recovered, and the optional warmup served — the router
  re-admits the slot into placement exactly when it can serve;
- **control** frames from the router (`wire.K_EVENT` with ``ctl``):
  ``drain`` (acknowledge; the router stops placing — admission stays
  open for duplicate-attach re-submits), ``die`` (clean close + exit
  0). A dead supervision connection means the router is gone or this
  incarnation is fenced: exit promptly (code 2), leaving un-done
  journal frames for the successor's recovery.

``--config``'s ``service`` block is `ServiceConfig` overrides in JSON;
its ``device`` and ``dtype`` are strings, and a child given no ``device``
serves on the CUDA card. The kernel library is loaded from the build the
parent (or an earlier process) left; a child never rebuilds a current
library.

The lifecycle is the rolling-restart drill's substrate:
drain → fence → respawn → re-admit, each step observable over the wire.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from aclswarm_torch.interop import transport
from aclswarm_torch.utils.log import get_logger

# exit codes (the router and the drills assert on these)
EXIT_CLEAN = 0          # router sent `die`; drained and closed
EXIT_SUPERVISOR_LOST = 2   # supervision connection died
EXIT_REFUSED = 3        # HELLO refused (duplicate slot / stale gen)

ROLE = "procworker"


def _recv_frame(chan, timeout_s: float, poll_s: float = 0.01):
    """Block up to ``timeout_s`` for one raw frame (None on timeout;
    OSError propagates — a dead supervisor is the caller's signal)."""
    t_end = time.monotonic() + timeout_s
    while time.monotonic() < t_end:
        raw = chan.recv_bytes()
        if raw is not None:
            return raw
        time.sleep(poll_s)
    return None


def hello(chan, slot: int, incarnation: int,
          timeout_s: float = 10.0) -> dict:
    """Send the supervision HELLO and block for the router's verdict.
    Returns the ack payload; raises `PermissionError` on a structured
    refusal (duplicate slot claim — the loser's exit path) and
    `OSError` on a dead/ silent supervisor."""
    from aclswarm_torch.serve import wire

    chan.send_bytes(wire._frame(wire.K_HELLO, {
        "client": f"proc.w{slot}.{incarnation}", "role": ROLE,
        "slot": int(slot), "incarnation": int(incarnation),
        "pid": os.getpid()}))
    chan.flush()
    raw = _recv_frame(chan, timeout_s)
    if raw is None:
        raise OSError(f"supervisor never answered the HELLO within "
                      f"{timeout_s:g} s")
    from aclswarm_torch.resilience import checkpoint as ckptlib
    payload, man = ckptlib.loads(raw, chan.name)
    kind = man.get("kind")
    if kind == wire.K_ERROR:
        raise PermissionError(str(payload.get("error", "refused")))
    if kind != wire.K_HELLO_ACK:
        raise OSError(f"unexpected first supervisor frame kind {kind!r}")
    return payload


def run_worker(args, log=None) -> int:
    """The supervised child main loop (post-argparse): HELLO → fence →
    build → READY → heartbeat/control until `die` or supervisor
    death."""
    log = log or get_logger(f"serve.procworker.w{args.slot}")
    host, port = args.supervisor.rsplit(":", 1)
    chan = transport.connect_when_ready(host, int(port),
                                        grace_s=args.grace_s)
    try:
        ack = hello(chan, args.slot, args.incarnation,
                    timeout_s=args.grace_s)
    except PermissionError as e:
        print(json.dumps({"verdict": "REFUSED", "slot": args.slot,
                          "incarnation": args.incarnation,
                          "error": str(e)}), flush=True)
        chan.close()
        return EXIT_REFUSED
    log.info("admitted by router %s as w%d.%d",
             ack.get("server", "?"), args.slot, args.incarnation)
    if args.handshake_only:
        # test hook (duplicate-HELLO races): prove admission without
        # paying for a service build. Hold the claim with heartbeats
        # until the router sends ``die`` (exit 0), hangs up (exit 2) or
        # the bounded window lapses (exit 0) — the OTHER claimant must
        # stay refused the whole time.
        print(json.dumps({"verdict": "ADMITTED", "slot": args.slot,
                          "incarnation": args.incarnation,
                          "pid": os.getpid()}), flush=True)
        from aclswarm_torch.resilience import checkpoint as ckptlib
        from aclswarm_torch.serve import wire
        t_end = time.monotonic() + args.handshake_hold_s
        try:
            while time.monotonic() < t_end:
                chan.send_bytes(wire._frame(wire.K_PING, {
                    "slot": args.slot,
                    "incarnation": args.incarnation,
                    "pid": os.getpid()}))
                chan.flush()
                raw = chan.recv_bytes()
                if raw is not None:
                    payload, man = ckptlib.loads(raw, chan.name)
                    if man.get("kind") == wire.K_EVENT \
                            and payload.get("ctl") == "die":
                        break       # released: the claim is done
                    continue        # drain other control frames, held
                time.sleep(0.05)
        except OSError:
            return EXIT_SUPERVISOR_LOST
        chan.close()
        return EXIT_CLEAN

    # ---- build the cell: fence predecessors, recover, serve ----------
    from aclswarm_torch import ops
    from aclswarm_torch.ops import _build
    from aclswarm_torch.serve import wire
    from aclswarm_torch.serve.service import (ServiceConfig, SwarmService,
                                              write_fence)
    from aclswarm_torch.serve.stats import ServeStats

    cfg_kw = dict(args.config.get("service") or {})
    cfg_kw.update(journal_dir=str(args.journal_dir),
                  incarnation=int(args.incarnation), workers=1)
    Path(args.journal_dir).mkdir(parents=True, exist_ok=True)
    # fence BEFORE recovery: from this point a lingering predecessor's
    # journal writes are no-ops, so replaying its frames is safe
    write_fence(args.journal_dir, args.incarnation)
    svc = SwarmService(ServiceConfig(**cfg_kw), log=log)
    server = wire.WireServer(svc, base=None, tcp=("127.0.0.1", 0))
    wire_port = int(server.tcp_address[1])
    # pre-READY warmup: serve the serving shapes once now (the kernel
    # library's load, the allocator's first blocks) so the router admits
    # a slot that is actually fast. ``warm`` is one group submitted
    # together; ``warm_groups`` is a list of groups run one group at a
    # time — each group's co-submitted requests PACK into one batch,
    # so a groups list [4, 3, 2, 1 requests] runs every batch SIZE the
    # scheduler can form.
    groups = [list(g) for g in (args.config.get("warm_groups") or [])]
    if args.config.get("warm"):
        groups.append(list(args.config["warm"]))
    for g, group in enumerate(groups):
        warm_tickets = [
            svc.submit(kind, params, tenant="_warmup",
                       request_id=f"warm-w{args.slot}-"
                                  f"{args.incarnation}-{g}-{i}")
            for i, (kind, params) in enumerate(group)]
        for t in warm_tickets:
            t.result(timeout=600)
    chan.send_bytes(wire._frame(wire.K_EVENT, {
        "event": "ready", "slot": args.slot,
        "incarnation": args.incarnation, "pid": os.getpid(),
        "wire_port": wire_port}))
    chan.flush()
    log.info("ready: data plane on 127.0.0.1:%d, journal %s",
             wire_port, args.journal_dir)

    def beat() -> None:
        try:
            compact = ServeStats.of(svc).compact()
        except Exception:   # noqa: BLE001 — beat must not die
            compact = {}
        chan.send_bytes(wire._frame(wire.K_PING, {
            "slot": args.slot, "incarnation": args.incarnation,
            "pid": os.getpid(), "stats": compact,
            "launches": dict(ops.LAUNCHES),
            "library": dict(_build.LOADED)}))
        chan.flush()

    rc = EXIT_SUPERVISOR_LOST
    last_beat = 0.0
    try:
        while True:
            now = time.monotonic()
            if now - last_beat >= args.beat_s:
                last_beat = now
                beat()
            raw = chan.recv_bytes()
            if raw is None:
                time.sleep(0.02)
                continue
            from aclswarm_torch.resilience import checkpoint as ckptlib
            try:
                payload, man = ckptlib.loads(raw, chan.name)
            except ckptlib.CheckpointError as e:
                log.error("corrupt supervision frame: %s", e)
                continue
            kind = man.get("kind")
            if kind == wire.K_BYE or (
                    kind == wire.K_EVENT
                    and payload.get("ctl") == "die"):
                log.info("router sent %s — clean shutdown",
                         payload.get("ctl", "bye"))
                rc = EXIT_CLEAN
                break
            if kind == wire.K_EVENT and payload.get("ctl") == "drain":
                # placement already stopped router-side; acknowledge so
                # the drill can assert the drain round-tripped
                chan.send_bytes(wire._frame(wire.K_EVENT, {
                    "event": "draining", "slot": args.slot,
                    "incarnation": args.incarnation,
                    "inflight": int(svc.stats.get("accepted", 0)
                                    - svc.stats.get("completed", 0)
                                    - svc.stats.get("failed", 0)
                                    - svc.stats.get("timed_out", 0))}))
                chan.flush()
    except OSError as e:
        # supervision death IS the fence signal for a live process:
        # the router declared us dead (or died itself) — stop serving
        # promptly and leave un-done frames for the successor
        log.error("supervision connection lost (%s) — exiting", e)
        rc = EXIT_SUPERVISOR_LOST
    server.close()
    svc.close(drain=(rc == EXIT_CLEAN),
              timeout=args.drain_timeout_s if rc == EXIT_CLEAN else 5.0)
    if rc == EXIT_CLEAN:
        try:
            beat()          # the last launch counts, after the drain
        except OSError:
            pass
    chan.close()
    return rc


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.serve.procworker",
        description="supervised process-mode worker cell (one "
                    "SwarmService slot + wire data plane per process)")
    ap.add_argument("--slot", type=int, required=True)
    ap.add_argument("--incarnation", type=int, required=True)
    ap.add_argument("--supervisor", required=True,
                    help="router supervision endpoint host:port")
    ap.add_argument("--journal-dir", default=None,
                    help="per-slot journal dir (stable across "
                    "incarnations — respawn recovery reads it)")
    ap.add_argument("--config", type=json.loads, default={},
                    help="JSON: {'service': ServiceConfig overrides "
                         "(device and dtype as strings; no device = the "
                         "CUDA card), 'warm': [[kind, params], ...]}")
    ap.add_argument("--beat-s", type=float, default=0.5)
    ap.add_argument("--grace-s", type=float, default=15.0)
    ap.add_argument("--drain-timeout-s", type=float, default=30.0)
    ap.add_argument("--handshake-only", action="store_true",
                    help="claim the slot and hold it with heartbeats, "
                         "never building a service (race tests)")
    ap.add_argument("--handshake-hold-s", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not args.handshake_only and not args.journal_dir:
        ap.error("--journal-dir is required outside --handshake-only")
    return args


def main(argv=None) -> int:
    return run_worker(parse(argv))


if __name__ == "__main__":        # pragma: no cover — subprocess entry
    sys.exit(main())

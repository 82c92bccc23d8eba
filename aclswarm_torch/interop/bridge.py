"""Planner bridge process: the planner daemon on the wire transport (port
of `aclswarm_tpu/interop/bridge.py`, the reference's `backend=tpu`
daemon).

The deployment shape: one host process owns the planner (`TorchPlanner`,
on the CUDA card) and speaks the wire API over shm channels — the
coordination-stack replacement the rest of a vehicle/SIL system talks to.
Channels (one directed ring each, created by this process):

    <ns>-formation   in   Formation        (operator dispatches)
    <ns>-flightmode  in   FlightMode       (operator GO/LAND/KILL broadcast)
    <ns>-estimates   in   VehicleEstimates (state feed, one per tick)
    <ns>-central-assignment
                     in   Assignment       (operator-pushed centralized
                                            permutation, comparison mode —
                                            the `/central_assignment` topic,
                                            `coordination_ros.cpp:46-51`)
    <ns>-distcmd     out  DistCmd          (velocity goals per tick)
    <ns>-assignment  out  Assignment       (on newly accepted assignments)
    <ns>-safety      out  SafetyStatusArray (ca-active flags per tick)

Run:  python -m aclswarm_torch.interop.bridge --n 6 --ns /asw [--ticks K]
          [--device cpu --dtype float64]

Without ``--device`` the planner runs on the card (and the daemon exits
with an error when there is none). The loop is deliberately dumb: drain
formation channel -> commit; read one estimates message -> tick -> write
outputs. Pacing is driven by the estimate producer (the aclswarm
coordination node is likewise driven by its 100 Hz timer against the
latest state, `coordination_ros.cpp:370-378`). Exits after --ticks
estimate messages (0 = run until the formation channel delivers a
`Formation` named "__shutdown__"), then prints ``bridge served N ticks``
and one JSON line ``{"bridge": {...}}``: ticks, the kernel launches
(`ops.LAUNCHES`), each formation commit's milliseconds, the planner's
milliseconds per tick, and the frames and bytes per channel.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from aclswarm_torch.interop import codec
from aclswarm_torch.interop import messages as m
from aclswarm_torch.utils.log import get_logger

log = get_logger("interop.bridge")

SHUTDOWN = "__shutdown__"
CHANNELS = ("formation", "flightmode", "estimates", "central-assignment",
            "distcmd", "assignment", "safety")


class _Counted:
    """A channel that counts the frames and bytes it moves."""

    def __init__(self, chan):
        self.chan = chan
        self.frames = 0
        self.bytes = 0

    def recv(self):
        raw = self.chan.recv_bytes()
        if raw is None:
            return None
        self.frames += 1
        self.bytes += len(raw)
        return codec.decode(raw)

    def send(self, msg, reliable: bool = False, grace_s: float = 1.0
             ) -> bool:
        from aclswarm_torch.interop.transport import send_bytes_reliable

        raw = codec.encode(msg)
        ok = (send_bytes_reliable(self.chan, raw, grace_s=grace_s, log=log,
                                  what=type(msg).__name__) if reliable
              else self.chan.send_bytes(raw))
        if ok:
            self.frames += 1
            self.bytes += len(raw)
        return ok


def run_bridge(n: int, ns: str = "/asw", ticks: int = 0,
               assignment: str = "auction", assign_every: int = 120,
               poll_s: float = 0.001, idle_timeout_s: float = 60.0,
               central_assignment: bool = False, device=None,
               dtype: str = "float32", verbose: bool = False,
               report: dict | None = None) -> int:
    """Serve the planner over shm channels; returns ticks served.
    ``report`` (a dict) receives the daemon's counts: commit ms, tick ms,
    frames and bytes per channel."""
    from aclswarm_torch.interop.planner import TorchPlanner
    from aclswarm_torch.interop.transport import Channel

    planner = TorchPlanner(n, assignment=assignment,
                           assign_every=assign_every,
                           central_assignment=central_assignment,
                           device=device, dtype=dtype)
    served = 0
    commit_ms, tick_ms = [], []
    # the formation ring must hold a dispatch WITH explicit gains
    # (9 n^2 f32 dominates: 36 MB at n=1000) — the creator dictates ring
    # capacity, so size it here rather than failing in the operator
    form_cap = max(1 << 20, 2 * (9 * n * n * 4 + n * n + 24 * n + 4096))
    chans = {}
    try:
        for name in CHANNELS:
            cap = {"capacity": form_cap} if name == "formation" else {}
            try:
                chans[name] = _Counted(Channel(f"{ns}-{name}", create=True,
                                               **cap))
            except OSError as e:
                raise OSError(f"{e} (capacity "
                              f"{cap.get('capacity', 'default')} B)") from e
        ch_form, ch_mode, ch_est, ch_cen, ch_cmd, ch_asn, ch_safe = (
            chans[c] for c in CHANNELS)
        if verbose:
            log.info("bridge up: ns=%s n=%d device=%s", ns, n,
                     planner.device)
        deadline = time.time() + idle_timeout_s
        shutdown = False
        discarded_central_warned = False
        while True:
            progressed = False
            # drain the formation channel: a burst of operator dispatches
            # commits only the newest (each commit may trigger a full gain
            # solve, so solving superseded formations is pure waste)
            latest = None
            while isinstance(msg := ch_form.recv(), m.Formation):
                if msg.name == SHUTDOWN:
                    shutdown = True
                    break
                latest = msg
                progressed = True
            if latest is not None:
                t0 = time.perf_counter()
                planner.handle_formation(latest)
                commit_ms.append((time.perf_counter() - t0) * 1e3)
                if verbose:
                    log.info("committed formation %r", latest.name)
            if shutdown:
                break
            # drain flight-mode broadcasts BEFORE the tick so a KILL cuts
            # the distcmd output on this very tick (`safety.cpp:116-120`)
            while isinstance(fm := ch_mode.recv(), m.FlightMode):
                planner.handle_flightmode(fm)
                progressed = True
                if verbose:
                    log.info("flight mode %d (killed=%s)", fm.mode,
                             planner.killed)
            # drain centralized-assignment pushes: only the newest matters
            # (the queue-size-1 subscription, `coordination_ros.cpp:49-51`);
            # outside comparison mode nothing subscribes, so frames are
            # discarded
            while isinstance(ca := ch_cen.recv(), m.Assignment):
                progressed = True
                if planner.central_assignment:
                    ok = planner.handle_central_assignment(ca)
                    if not ok:
                        log.warning("rejected malformed central assignment")
                    elif verbose:
                        log.info("central assignment received")
                elif not discarded_central_warned:
                    # a client IS pushing but this daemon was started
                    # without --central-assignment: silent discard would
                    # look like the opposite mode (loud once)
                    discarded_central_warned = True
                    log.warning(
                        "central-assignment push received but this bridge "
                        "runs WITHOUT --central-assignment; pushes are "
                        "discarded and the daemon keeps auctioning")
            est = ch_est.recv()
            if isinstance(est, m.VehicleEstimates):
                t0 = time.perf_counter()
                out = planner.tick(est)
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                # ORDER MATTERS: safety and assignment go out BEFORE the
                # distcmd, so a consumer that blocks on the distcmd for
                # this tick (ShmPlannerClient matches header.seq) finds
                # the same tick's other frames already in their rings
                if out.safety is not None:
                    # per-tick health stream; a dropped frame is stale the
                    # next tick, so plain best-effort send (queue-size-1
                    # semantics like the SafetyStatus topic)
                    ch_safe.send(m.SafetyStatusArray(header=est.header,
                                                     active=out.safety))
                if out.assignment is not None:
                    # an Assignment is emitted once per acceptance and
                    # never re-sent — a silent drop would leave consumers
                    # on a stale permutation permanently, so block through
                    # transient backpressure
                    ch_asn.send(m.Assignment(header=est.header,
                                             perm=out.assignment),
                                reliable=True, grace_s=5.0)
                ch_cmd.send(m.DistCmd(header=est.header, vel=out.distcmd),
                            reliable=True)
                served += 1
                progressed = True
                if ticks and served >= ticks:
                    break
            if progressed:
                deadline = time.time() + idle_timeout_s
            elif time.time() > deadline:
                break
            else:
                time.sleep(poll_s)
    finally:
        for c in chans.values():
            c.chan.close()
    if report is not None:
        report.update(
            commit_ms=commit_ms,
            tick_ms=float(np.mean(tick_ms)) if tick_ms else None,
            channels={name: {"frames": c.frames, "bytes": c.bytes}
                      for name, c in chans.items()})
    return served


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--ns", default="/asw")
    ap.add_argument("--ticks", type=int, default=0)
    ap.add_argument("--assignment", default="auction")
    ap.add_argument("--assign-every", type=int, default=120)
    ap.add_argument("--idle-timeout", type=float, default=60.0)
    ap.add_argument("--central-assignment", action="store_true",
                    help="comparison mode: adopt operator-pushed "
                         "permutations from <ns>-central-assignment "
                         "instead of auctioning "
                         "(`/operator/central_assignment`)")
    ap.add_argument("--device", default=None,
                    help="device to plan on (default: the CUDA card)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    from aclswarm_torch import ops

    report = {}
    served = run_bridge(args.n, args.ns, args.ticks, args.assignment,
                        args.assign_every,
                        idle_timeout_s=args.idle_timeout,
                        central_assignment=args.central_assignment,
                        device=args.device, dtype=args.dtype,
                        verbose=args.verbose, report=report)
    print(f"bridge served {served} ticks", flush=True)
    print(json.dumps({"bridge": {"ticks": served,
                                 "launches": dict(ops.LAUNCHES),
                                 **report}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

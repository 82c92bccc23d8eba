"""The health CLI (a copy of `aclswarm_tpu/telemetry/watch.py`): the live
fleet-health surface, three ways:

    # one-shot scrape of a serving fleet over the TCP front end
    python -m aclswarm_torch.telemetry.watch --tcp HOST:PORT

    # live: re-scrape every --interval seconds until interrupted
    python -m aclswarm_torch.telemetry.watch --tcp HOST:PORT --follow

    # postmortem: replay a persisted timeseries.log from DISK ALONE
    # through the SLO engine (the process that sampled it may be
    # SIGKILLed and gone)
    python -m aclswarm_torch.telemetry.watch --log <journal>/timeseries.log

Live modes submit the built-in ``health`` request kind through a
`WireClient` — the same codec, CRC, and versioning surface every other
request crosses, so any fleet reachable over the TCP listener is
watchable without importing torch or the engine. The from-disk mode
rebuilds the `TimeSeriesStore` from the resilience frame log
(`timeseries.load_store`) and re-evaluates the default SLO catalog at
every persisted tick, printing the alert transitions the live engine
would have produced — the postmortem twin of the live surface.

Exit status: 0 when nothing is firing (live: this scrape; from-disk:
at the final tick), 1 when an alert is firing, 2 on transport/parse
failure — so the CLI doubles as a health probe.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["render_health", "replay_log", "identities",
           "identity_delta", "main"]


def _fmt_val(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def identities(h: dict) -> dict:
    """Extract the PROCESS identity map from a ``health`` payload:
    ``{name: (pid, incarnation)}``. The serving process itself is
    ``"service"``; a router aggregate adds one entry per worker SLOT
    (``w0``, ``w1``, ...) so the same slot compares across
    incarnations. Identity is what tells a RESPAWN (new pid, bumped
    incarnation — the old process is gone, its journal was fenced and
    recovered) from a RECONNECT (same pid + incarnation — only the
    watcher's connection blinked)."""
    out = {"service": (h.get("pid"), h.get("incarnation"))}
    for uid, row in (h.get("processes") or {}).items():
        slot = str(uid).split(".")[0]
        out[f"w{slot}"] = (row.get("pid"), row.get("incarnation"))
    return out


def identity_delta(prev: dict, cur: dict) -> list:
    """Human-readable identity transitions between two consecutive
    `identities` maps (pure — unit-testable without a fleet). Silent
    on steady state; loud on every generation change."""
    lines = []
    for name in sorted(set(prev) | set(cur)):
        p, c = prev.get(name), cur.get(name)
        if p == c or c is None:
            continue
        if p is None:
            lines.append(f"{name}: appeared (pid {c[0]}, "
                         f"incarnation {c[1]})")
        elif p[0] != c[0] or (c[1] or 0) > (p[1] or 0):
            lines.append(
                f"{name}: RESPAWN pid {p[0]}->{c[0]} "
                f"incarnation {p[1]}->{c[1]} (old process is gone — "
                "journal fenced + recovered by the successor)")
        else:
            lines.append(f"{name}: identity changed {p}->{c}")
    return lines


def render_health(h: dict, origin: str = "") -> str:
    """One human-readable block for a ``health`` payload (the wire
    kind's value dict)."""
    lines = []
    w = h.get("workers") or {}
    ident = ""
    if h.get("pid") is not None:
        ident = (f"pid {h.get('pid')} gen {h.get('incarnation', '?')}"
                 f"   ")
    lines.append(
        f"swarmwatch{' @ ' + origin if origin else ''}   "
        f"{ident}"
        f"workers {w.get('up', '?')}/{w.get('total', '?')} up   "
        f"queue {h.get('queue_depth', '?')}   "
        f"inflight {h.get('inflight', '?')}   "
        f"alive {h.get('alive', '?')}")
    procs = h.get("processes")
    if isinstance(procs, dict) and procs:
        # router aggregate: one line per worker PROCESS, identity first
        lines.append(f"  {'worker':<8} {'pid':<8} {'gen':<5} up")
        for uid in sorted(procs):
            row = procs[uid]
            lines.append(f"  w{uid:<7} {str(row.get('pid', '?')):<8} "
                         f"{str(row.get('incarnation', '?')):<5} "
                         f"{row.get('up', '?')}")
    watch = h.get("watch")
    if not h.get("watch_enabled") or not isinstance(watch, dict):
        lines.append("  (swarmwatch disabled on this service — liveness "
                     "only; start it with ServiceConfig(watch=True))")
        return "\n".join(lines)
    verdicts = watch.get("verdicts") or {}
    lines.append(f"  {'SLO':<18} {'state':<9} {'burn s/l':<17} "
                 f"{'value':<10} fired")
    for name in sorted(verdicts):
        v = verdicts[name]
        burn = f"{v.get('burn_short', 0):.2f}/{v.get('burn_long', 0):.2f}"
        lines.append(
            f"  {name:<18} {v.get('state', '?'):<9} {burn:<17} "
            f"{_fmt_val(v.get('value')):<10} {v.get('fired', 0)}")
        labels = v.get("labels") or {}
        bad = {k: s for k, s in labels.items() if s != "ok"}
        if bad:
            lines.append(f"    {'':<16} labels: " + ", ".join(
                f"{k}={s}" for k, s in sorted(bad.items())))
    firing = watch.get("firing") or []
    lines.append(f"  firing: {firing if firing else 'none'}")
    s = watch.get("sampler") or {}
    lines.append(
        f"  sampler: {s.get('samples', 0)} samples @ "
        f"{s.get('interval_s', '?')}s, {s.get('series', 0)} series, "
        f"spent {s.get('spent_s', 0)}s, "
        f"dropped {s.get('points_dropped', 0)} point(s)")
    return "\n".join(lines)


def _scrape(client, timeout_s: float) -> dict:
    """One ``health`` submit over an open wire client; raises on any
    failure (the caller maps it to exit 2). The client is OWNED by the
    caller: ``--follow`` reuses one connection across the loop instead
    of paying a TCP connect + HELLO (and churning the server's accept
    path and client ledger) per sample."""
    res = client.submit_and_wait("health", {}, timeout=timeout_s)
    if not res.ok:
        code = res.error.code if res.error else "?"
        raise RuntimeError(f"health scrape failed: {code} "
                           f"({res.error.message if res.error else ''})")
    return res.value


def replay_log(path, capacity: int = 4096, specs=None) -> dict:
    """Re-evaluate the SLO catalog over a persisted ``timeseries.log``
    from disk alone: sample ticks are replayed in file order
    (`timeseries.read_ticks` — the ONE home for the on-disk tick
    contract), the engine evaluates at every persisted tick, and the
    transitions it emits are collected. Returns ``{verdicts,
    transitions, ticks, torn_tail, series, firing}`` — the postmortem
    twin of the live surface. ``specs`` must match the live service's
    catalog for the twin claim to hold (the CLI exposes the
    cap-sensitive knob as ``--queue-cap``)."""
    from aclswarm_torch.telemetry.slo import SloEngine, default_slos
    from aclswarm_torch.telemetry.timeseries import (TimeSeriesStore,
                                                     read_ticks)

    store = TimeSeriesStore(capacity=capacity)
    transitions: list = []
    engine = SloEngine(list(specs) if specs is not None
                       else default_slos(), store,
                       emit=transitions.append)
    ticks, torn = read_ticks(path)
    for t, vals in ticks:
        for name, v in vals.items():
            store.append(name, t, v)
        engine.evaluate(now=t)
    return {
        "verdicts": engine.verdicts(),
        "transitions": transitions,
        "ticks": len(ticks),
        "torn_tail": torn,
        "series": len(store.names()),
        "firing": engine.firing(),
    }


def _print_replay(rep: dict, path: str, as_json: bool) -> None:
    if as_json:
        print(json.dumps(rep, indent=1, sort_keys=True, default=str))
        return
    print(f"swarmwatch replay of {path}: {rep['ticks']} tick(s), "
          f"{rep['series']} series"
          + (" [torn tail dropped]" if rep["torn_tail"] else ""))
    if rep["transitions"]:
        print("  alert transitions (as the live engine would have "
              "fired them):")
        t0 = rep["transitions"][0].get("t_wall", 0.0)
        for ev in rep["transitions"]:
            print(f"    +{ev.get('t_wall', 0) - t0:9.3f}s  "
                  f"{ev.get('slo', '?')}{ev.get('labels', '')} "
                  f"{str(ev.get('state', '?')).upper()}  "
                  f"(burn {ev.get('burn_short', 0)}/"
                  f"{ev.get('burn_long', 0)}, value {ev.get('value')})")
    else:
        print("  no alert transitions — clean history")
    print(f"  final verdicts: " + ", ".join(
        f"{k}={v['state']}" for k, v in sorted(rep["verdicts"].items())))
    if rep["firing"]:
        print(f"  STILL FIRING at end of history: {rep['firing']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m aclswarm_torch.telemetry.watch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--tcp", metavar="HOST:PORT",
                     help="scrape a live fleet's `health` kind over the "
                          "TCP wire front end")
    src.add_argument("--log", metavar="TIMESERIES_LOG",
                     help="replay a persisted timeseries.log from disk "
                          "through the SLO engine (postmortem mode)")
    ap.add_argument("--follow", action="store_true",
                    help="(--tcp) keep scraping every --interval s")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="--follow cadence in seconds (default 2)")
    ap.add_argument("--timeout", type=float, default=30.0,
                    help="per-scrape client timeout (default 30 s)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON instead of the "
                         "rendered table")
    ap.add_argument("--queue-cap", type=int, default=32,
                    help="(--log) the replayed service's "
                         "max_queue_total — the queue-saturation SLO "
                         "is cap-relative, so replay must use the LIVE "
                         "service's cap or the postmortem twin "
                         "diverges from what actually fired "
                         "(default 32 = ServiceConfig default)")
    args = ap.parse_args(argv)

    if args.log is not None:
        from aclswarm_torch.telemetry.slo import default_slos
        try:
            rep = replay_log(args.log, specs=default_slos(
                max_queue_total=args.queue_cap))
        except Exception as e:      # noqa: BLE001 — CLI boundary
            print(f"swarmwatch: cannot replay {args.log}: {e}",
                  file=sys.stderr)
            return 2
        _print_replay(rep, args.log, args.json)
        return 1 if rep["firing"] else 0

    try:
        host, port = args.tcp.rsplit(":", 1)
        port = int(port)
    except ValueError:
        print(f"swarmwatch: --tcp wants HOST:PORT, got {args.tcp!r}",
              file=sys.stderr)
        return 2
    from aclswarm_torch.serve.wire import WireClient
    firing = None
    client = None
    try:
        try:
            client = WireClient(tcp=(host, port), tenant="swarmwatch")
        except Exception as e:      # noqa: BLE001 — CLI boundary
            print(f"swarmwatch: cannot connect to {args.tcp}: {e}",
                  file=sys.stderr)
            return 2
        prev_ident = None
        while True:
            try:
                h = _scrape(client, args.timeout)
            except KeyboardInterrupt:
                raise
            except Exception as e:      # noqa: BLE001 — CLI boundary
                if not args.follow:
                    print(f"swarmwatch: scrape of {args.tcp} failed: "
                          f"{e}", file=sys.stderr)
                    return 2
                # --follow rides through server churn: rebuild the
                # connection, then let the HELLO-ack identity say
                # WHICH kind of churn — same (pid, incarnation) means
                # only our connection blinked (reconnect); a new one
                # means the server process itself was replaced
                old_info = dict(client.server_info)
                try:
                    client.close(bye=False)
                except Exception:   # noqa: BLE001 — already broken
                    pass
                try:
                    client = WireClient(tcp=(host, port),
                                        tenant="swarmwatch")
                except Exception as e2:  # noqa: BLE001 — CLI boundary
                    print(f"swarmwatch: scrape failed ({e}) and "
                          f"reconnect failed ({e2})", file=sys.stderr)
                    return 2
                old = (old_info.get("pid"), old_info.get("incarnation"))
                new = (client.server_info.get("pid"),
                       client.server_info.get("incarnation"))
                if old == new:
                    print(f"swarmwatch: RECONNECT to the same server "
                          f"process (pid {new[0]}, incarnation "
                          f"{new[1]}) — only the connection blinked",
                          file=sys.stderr)
                else:
                    print(f"swarmwatch: server RESPAWN detected — pid "
                          f"{old[0]}->{new[0]}, incarnation "
                          f"{old[1]}->{new[1]}", file=sys.stderr)
                continue
            if args.json:
                print(json.dumps(h, indent=1, sort_keys=True,
                                 default=str))
            else:
                print(render_health(h, origin=args.tcp))
                cur_ident = identities(h)
                if prev_ident is not None:
                    for line in identity_delta(prev_ident, cur_ident):
                        print(f"  !! {line}")
                prev_ident = cur_ident
            firing = ((h.get("watch") or {}).get("firing")
                      if h.get("watch_enabled") else None)
            if not args.follow:
                return 1 if firing else 0
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        # detaching from --follow is not a failure: keep the documented
        # health-probe contract (0/1 from the last completed scrape,
        # never a traceback) so wrappers keying on exit codes stay
        # honest
        return 1 if firing else 0
    finally:
        if client is not None:
            try:
                client.close()
            except Exception:       # noqa: BLE001 — already detaching
                pass


if __name__ == "__main__":
    sys.exit(main())

"""Telemetry tax measurement (port of `aclswarm_tpu/telemetry/overhead.py`;
acceptance bar: telemetry-on < 5% of trial wall at n=10, default
cadence).

The same real driver the checkpoint overhead measurement uses
(`harness.trials.run_trial`, simform10, on the CUDA card unless
``--device`` names another device), telemetry off vs on, median relative
wall overhead over ``reps``. The ON run pays the device counters in the
rollout carry (a handful of () int32 adds per tick), the chunk-final
snapshot riding the existing copies, and the host-side registry publish
per chunk; plus a microbench row for the raw registry publish cost.

Run:

    python -m aclswarm_torch.telemetry.overhead [--device cpu]
        [--out rows.jsonl]

Rows go to stdout; nothing is written unless ``--out`` names a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def run_overhead(out: str | None = None, n: int = 10, reps: int = 3,
                 device=None) -> int:
    from aclswarm_torch.core.types import resolve_device
    from aclswarm_torch.harness import trials as triallib
    from aclswarm_torch.telemetry import device as devtel
    from aclswarm_torch.telemetry import registry as reglib

    dev = resolve_device(device)
    base = dict(formation=f"simform{n}", trials=1, seed=1, verbose=False,
                out="/dev/null", device=str(dev))
    # warm BOTH variants outside the timed region
    triallib.run_trial(triallib.TrialConfig(**base), 0)
    triallib.run_trial(triallib.TrialConfig(telemetry="on", **base), 0)

    offs, ons = [], []
    chunks = [0]
    for _ in range(reps):
        t0 = time.perf_counter()
        fsm = triallib.run_trial(triallib.TrialConfig(**base), 0)
        offs.append(time.perf_counter() - t0)
        chunks[0] = int(np.ceil((fsm.tick_count + 1)
                                / triallib.TrialConfig.chunk_ticks))
        t0 = time.perf_counter()
        triallib.run_trial(triallib.TrialConfig(telemetry="on", **base), 0)
        ons.append(time.perf_counter() - t0)
    off_s, on_s = float(np.median(offs)), float(np.median(ons))
    frac = max(0.0, on_s / off_s - 1.0)

    # microbench: the host-side registry publish (one ChunkPublisher
    # fold of a chunk-final snapshot) — the per-chunk host tax alone
    reg = reglib.MetricsRegistry()
    pub = devtel.ChunkPublisher(reg, prefix="bench")
    snap = {"auctions": 3, "assign_rounds": 40, "reassigns": 1,
            "ca_ticks": 17, "flood_stale_max": 2, "admm_iters": 9,
            "admm_residual": 0.01}
    k = 2000
    t0 = time.perf_counter()
    for i in range(k):
        snap["auctions"] = 3 + i          # deltas every call
        pub.publish(0, snap)
    publish_us = (time.perf_counter() - t0) / k * 1e6

    rows = [
        {"name": f"telemetry_overhead_frac_n{n}", "n": n,
         "value": round(frac, 4), "unit": "ratio",
         "wall_off_s": round(off_s, 3), "wall_on_s": round(on_s, 3),
         "chunks": chunks[0], "reps": reps,
         "note": f"run_trial simform{n} on {dev.type}, telemetry on vs "
                 "off at the default chunk cadence; acceptance < 0.05"},
        {"name": "telemetry_publish_us", "n": n,
         "value": round(publish_us, 2), "unit": "us",
         "note": "host-side ChunkPublisher.publish per chunk-final "
                 "snapshot (registry counters + gauges)"},
    ]
    for r in rows:
        print(json.dumps(r), flush=True)
    if frac >= 0.05:
        print(f"FAIL: telemetry-on overhead {frac:.1%} >= 5% acceptance "
              "bar")
        return 1
    if out:
        p = Path(out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
        print(f"wrote {p}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="rows file (default: write nothing)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    return run_overhead(args.out or None, reps=args.reps,
                        device=args.device)


if __name__ == "__main__":
    sys.exit(main())

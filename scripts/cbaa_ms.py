"""Time CBAA's local alignment, its bids and one cold auction on the card.

    python3 scripts/cbaa_ms.py [--seed 1] [--reps 11]

On the `cbaa` phase's first input of `chip_smoke.py` (n=1000, float32,
estimates from a flooded table, task blocks of 64) it times
`core.geometry.align_formation_local`, `assignment.cbaa.bid_prices` on
that alignment, and `cbaa_from_state` (host clock, synchronized; the
median of ``--reps``) and prints one JSON line with the card's name and
power limit. It times the package of the checkout it sits in: a copy in
each of two checkouts, run in one call, compares them. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from aclswarm_torch.assignment import cbaa  # noqa: E402
from aclswarm_torch.core import geometry  # noqa: E402


def median_ms(fn, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=11)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cbaa_ms: no CUDA card is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    formation, q, est, v2f = cs._flooded_inputs(args.seed, dev)
    pts, adj = formation.points, formation.adjmat
    block = cs.ENGINE_CBAA["cbaa_task_block"]
    al = geometry.align_formation_local(q, pts, adj, v2f, est=est)
    res = cbaa.cbaa_from_state(q, pts, adj, v2f, est=est, task_block=block)
    print(json.dumps({
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0],
        "checkout": str(Path(__file__).resolve().parents[1]),
        "n": int(q.shape[0]), "seed": args.seed, "reps": args.reps,
        "align_ms": median_ms(lambda: geometry.align_formation_local(
            q, pts, adj, v2f, est=est), args.reps),
        "bid_ms": median_ms(lambda: cbaa.bid_prices(q, al), args.reps),
        "auction_ms": median_ms(lambda: cbaa.cbaa_from_state(
            q, pts, adj, v2f, est=est, task_block=block), args.reps),
        "rounds": int(res.rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Per-phase A/B of `chip_smoke.py` runs: each phase's median seconds on
the parent and on the change, from the runs' logs (their
``{"phase": ..., "phase_seconds": ...}`` lines), and the sums over the
phases both trees ran, `device` and `build` left out.

    python3 scripts/phase_ab.py --parent P1.log P2.log --change C1.log C2.log

Record the runs parent, change, change, parent in one call on one card
(`chip_smoke.py --phases ...` from each tree), so that both trees see the
same machine.
"""
from __future__ import annotations

import argparse
import json
import statistics

SKIP = ("device", "build")


def phase_seconds(path: str) -> dict:
    """{phase: seconds} of one log; a phase run twice sums."""
    out: dict = {}
    with open(path) as fh:
        for line in fh:
            if '"phase_seconds"' not in line:
                continue
            row = json.loads(line)
            if row["phase"] not in SKIP:
                out[row["phase"]] = out.get(row["phase"], 0.0) \
                    + row["phase_seconds"]
    return out


def medians(paths: list) -> dict:
    runs = [phase_seconds(p) for p in paths]
    names = [k for k in runs[0] if all(k in r for r in runs)]
    return {k: statistics.median(r[k] for r in runs) for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", nargs="+", required=True)
    ap.add_argument("--change", nargs="+", required=True)
    args = ap.parse_args(argv)
    par, chg = medians(args.parent), medians(args.change)
    both = [k for k in chg if k in par]
    for k in both:
        print(f"{k:22s} {par[k]:9.2f} {chg[k]:9.2f} {chg[k] - par[k]:+9.2f}")
    for k in (k for k in chg if k not in par):
        print(f"{k:22s} {'-':>9s} {chg[k]:9.2f} {chg[k]:+9.2f}  (change only)")
    sp, sc = sum(par.values()), sum(chg.values())
    print(json.dumps({"parent_sum": sp, "change_sum": sc,
                      "difference": sc - sp,
                      "phases_both": len(both),
                      "phases_change_only": sorted(set(chg) - set(par))}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

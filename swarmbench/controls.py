"""The readings that the checks' limits are set from, on the card.

    python3 swarmbench/controls.py --workload <cell> --seeds 1,2,3

For each seed: the cell's set-up and the replay of its sampled chunks (no
measured window: the outputs are the window's, chunk for chunk), then
three candidates judged by the same reference:

- ``program``: the program as the configuration states it (the lower
  readings);
- ``bf16``: the reference in bfloat16 in the program's place, stage by
  stage (the control for every stage);
- ``tf32``: the program with TF32 matrix products switched on, its gains
  designed and its ticks flown so (the program's own lower-precision
  path);
- ``admm_2_steps``, ``admm_5_steps``, ``scale_1pct``: the seeded trial's
  gain design stopped early or scaled wrong (gain numbers only).

Prints one JSON line per seed and candidate. The benchmark's own runs do
not run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def design_faults(S, seed: int) -> dict:
    """The seeded trial's design broken in the ways a faster set-up could
    break it: the ADMM stopped after 2 or 5 of its 10 steps, and the gain
    scale 1% off. Gain numbers only."""
    import numpy as np
    import torch

    from aclswarm_torch.gains import solve_gains
    from aclswarm_torch.gains.params import AdmmParams
    from swarmbench import judge
    from swarmbench.reference import swarm as ref

    b = judge.seeded_trial(seed, len(S.gains))
    tr = S.trials[b]
    pts = torch.as_tensor(tr["points"], dtype=torch.float64, device=S.device)
    adj = torch.as_tensor(tr["adj"], dtype=torch.float64, device=S.device)
    n = pts.shape[0]
    out = {}
    for itr in (2, 5):
        A = solve_gains(np.asarray(tr["points"], dtype=S.cfg["dtype"]),
                        tr["adj"], params=AdmmParams(max_itr=itr),
                        max_nonedges=max(n - 4, 1), device=S.device).double()
        rep = ref.gain_report(A, pts, adj)
        out[f"admm_{itr}_steps"] = dict(
            judge.design_numbers(S, b, A), gain_trace=rep["trace"],
            gain_indefinite=rep["indefinite"], gain_kernel=rep["kernel"])
    A = S.gains[b].double() / S.cfg["gain_scale"] * 1.01
    out["scale_1pct"] = dict(judge.design_numbers(S, b, A),
                             gain_trace=ref.gain_report(A, pts, adj)["trace"])
    return out


def readings(cell, seed: int, device: str = "cuda", tf32: bool = True):
    """{candidate: numbers} for one seed."""
    import torch

    from swarmbench import harness, judge

    S = harness.build(cell.config, cell.traffic, seed, device)
    chunks = int(cell.traffic["segment_ticks"]) // int(cell.traffic["chunk"])
    cap, recs, carry = judge.replay(S, seed, chunks)
    out = {"program": dict(judge.gain_numbers(S, S.gains, seed),
                           **judge.tick_numbers(S, cap, recs, carry))}
    out["bf16"] = judge.tick_numbers(S, cap, recs, carry,
                                     control=torch.bfloat16)
    del cap, recs, carry
    out.update(design_faults(S, seed))
    if tf32 and torch.device(device).type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            T = harness.build(cell.config, cell.traffic, seed, device,
                              trials=S.trials)
            cap, recs, carry = judge.replay(T, seed, chunks)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        out["tf32"] = dict(judge.gain_numbers(T, T.gains, seed),
                           **judge.tick_numbers(T, cap, recs, carry))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--no-tf32", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from swarmbench import harness

    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        for cand, nums in readings(cell, seed, tf32=not args.no_tf32).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "candidate": cand, "numbers": nums,
                              "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

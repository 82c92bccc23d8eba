"""Recorded-rollout reviewer (port of `aclswarm_tpu/harness/review.py`):
the `review_bag.py` pattern, bag-free.

The reference replays rosbagged hardware experiments through the same
metric FSM the sim supervisor uses (`aclswarm/nodes/review_bag.py:29-47`,
`launch/review.launch`), so hardware and sim runs are scored by one
oracle. Here the "bag" is a compressed npz of the rollout observables
(`StepMetrics` — the signals the supervisor consumes, plus what is needed
to re-derive them), written by `record()` during a trial
(``TrialConfig.record_dir``) and replayed by `review()` through the
`TrialFSM` with fresh thresholds:

- re-score an old run after tuning supervisor thresholds;
- archive Monte-Carlo evidence next to the CSV, so any row can be audited
  tick by tick;
- cross-check a live `TrialFSM` outcome against a replay of its inputs.

Format (the reference's, so either package reads the other's files): npz
with ``q`` (T, n, 3), ``distcmd_norm`` (T, n), ``ca_active`` (T, n),
``reassigned`` (T,), ``auctioned`` (T,), ``assign_valid`` (T,), ``mode``
(T, n), ``v2f`` (T, n), scalar ``dt``, plus free-form metadata under
``meta_*`` keys.

Run:
    python -m aclswarm_torch.harness.review trial_0.npz [--formations K]
        [--trial-timeout S] [--interactive [--gate-period S]]
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from aclswarm_torch.harness.supervisor import NAMES, TrialFSM

FIELDS = ("q", "distcmd_norm", "ca_active", "reassigned", "auctioned",
          "assign_valid", "mode", "v2f")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def record(path: str, metrics, dt: float = 0.01, **meta) -> str:
    """Write a rollout's metric stack (leading time axis: a `StepMetrics`
    of tensors, or any object or mapping with its fields as arrays) to a
    compressed npz "bag"."""
    def get(f):
        return metrics[f] if isinstance(metrics, dict) \
            else getattr(metrics, f)

    arrays = {f: _host(get(f)) for f in FIELDS}
    arrays["dt"] = np.asarray(dt)
    for k, v in meta.items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)
    return path


class Recording:
    """A loaded bag; attribute access mirrors `StepMetrics`.

    Accepts a recording ``.npz`` (written by `record()`) or a rosbag
    ``.bag`` from a hardware flight, which the pure-Python reader
    (`harness.rosbag1.bag_to_recording`) resamples onto the reviewer's
    50 Hz grid."""

    def __init__(self, path: str):
        if str(path).endswith(".bag"):
            from aclswarm_torch.harness import rosbag1
            data = rosbag1.bag_to_recording(path)
        else:
            data = np.load(path)
        for f in FIELDS:
            setattr(self, f, data[f])
        self.dt = float(data["dt"])
        files = data.files if hasattr(data, "files") else data.keys()
        self.meta = {k[5:]: data[k] for k in files
                     if k.startswith("meta_")}

    @property
    def n_ticks(self) -> int:
        return self.q.shape[0]

    @property
    def n(self) -> int:
        return self.q.shape[1]


def review(path: str, n_formations: int = 1,
           takeoff_alt: Optional[float] = None,
           trial_timeout: Optional[float] = None,
           verbose: bool = False,
           in_formation_gate=None) -> TrialFSM:
    """Replay a recorded rollout through the trial supervisor FSM. The
    recording must start on the ground for the takeoff phase to evaluate.
    Returns the finished (or exhausted) FSM.

    ``trial_timeout`` defaults to the recording's own
    ``meta_trial_timeout`` (the trial driver stamps it), falling back to
    the reference's 600 s, so a replay judges a trial against the
    watchdog budget it flew under.

    ``in_formation_gate`` enables the human-in-the-loop mode
    (`rosservice call /in_formation`, `review_bag.py:29-60`): a callable
    ``gate(tick, fsm) -> bool`` polled every tick, True on the tick the
    human declares the formation converged; it then replaces the machine
    convergence predicate (and aborts the trial if it fires during
    gridlock, see `TrialFSM.step`). The CLI's ``--interactive`` builds a
    stdin gate."""
    rec = Recording(path)
    if takeoff_alt is None:
        from aclswarm_torch.core.types import SafetyParams
        takeoff_alt = float(SafetyParams().takeoff_alt)
    if trial_timeout is None:
        from aclswarm_torch.harness.supervisor import TRIAL_TIMEOUT
        trial_timeout = float(rec.meta.get("trial_timeout", TRIAL_TIMEOUT))
    fsm = TrialFSM(rec.n, n_formations, takeoff_alt=takeoff_alt, dt=rec.dt,
                   trial_timeout=trial_timeout)
    auction_ok = rec.auctioned & rec.assign_valid
    # events are re-derived as the trial driver derives them: after each
    # dispatch, the first valid auction counts as an accepted assignment
    # even if unchanged (`auctioneer.cpp:310-316`)
    awaiting_first = False
    for t in range(rec.n_ticks):
        event = bool(rec.reassigned[t])
        if awaiting_first and bool(auction_ok[t]):
            event = True
            awaiting_first = False
        gate = (None if in_formation_gate is None
                else bool(in_formation_gate(t, fsm)))
        action = fsm.step(rec.q[t], rec.distcmd_norm[t], rec.ca_active[t],
                          event, in_formation=gate)
        if action == "dispatch":
            awaiting_first = True
        if fsm.done:
            break
    if verbose:
        print(f"review: {NAMES[fsm.state]} after {t + 1}/{rec.n_ticks} "
              f"ticks; conv times {[round(x, 2) for x in fsm.times]}")
    return fsm


def stdin_gate(dt: float, period_s: float = 1.0):
    """Interactive `/in_formation` gate: once per ``period_s`` of replay
    time while the FSM is in a gateable state, ask the operator whether
    the formation has converged."""
    from aclswarm_torch.harness.supervisor import TrialState
    every = max(1, int(round(period_s / dt)))

    def gate(t: int, fsm) -> bool:
        if fsm.state not in (TrialState.FLYING, TrialState.GRIDLOCK):
            return False
        if t % every:
            return False
        name = NAMES[fsm.state]
        try:
            ans = input(f"t={t * dt:7.2f}s  state={name:9s} formation "
                        f"{fsm.curr_formation_idx}: in formation? [y/N] ")
        except EOFError:        # stdin exhausted: no confirmation
            return False
        return ans.strip().lower().startswith("y")

    return gate


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Replay a recorded rollout through the trial "
                    "supervisor FSM (the review_bag.py analogue).")
    ap.add_argument("path", help="recording .npz written by record(), or "
                                 "a hardware .bag (rosbag v2.0)")
    ap.add_argument("--formations", type=int, default=1)
    ap.add_argument("--trial-timeout", type=float, default=None)
    ap.add_argument("--interactive", action="store_true",
                    help="human-in-the-loop convergence gate "
                         "(`rosservice call /in_formation` analogue)")
    ap.add_argument("--gate-period", type=float, default=1.0,
                    help="seconds of replay time between interactive "
                         "prompts")
    args = ap.parse_args(argv)
    gate = None
    if args.interactive:
        if args.path.endswith(".bag"):
            dt = 0.02        # the bag resampler's reviewer-rate grid
        else:
            dt = float(np.load(args.path)["dt"])
        gate = stdin_gate(dt, args.gate_period)
    fsm = review(args.path, n_formations=args.formations,
                 trial_timeout=args.trial_timeout, verbose=True,
                 in_formation_gate=gate)
    return 0 if fsm.completed else 1


if __name__ == "__main__":
    raise SystemExit(main())

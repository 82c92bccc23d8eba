"""Crash-resume smoke: SIGKILL a tiny rollout, resume, prove bit-parity
(port of `aclswarm_tpu/resilience/smoke.py`).

The fastest end-to-end proof of the resilience layer:

1. a CHILD process runs a chunked n=5 rollout with chunk-boundary
   checkpointing and a scripted ``SIGKILL`` at boundary 1
   (`resilience.crash`, env-armed — a real kill, nothing survives);
2. the parent verifies the child died by signal, then RESUMES from the
   checkpoint the child left behind;
3. the resumed chunks' metrics and the final state are compared
   BIT-EXACTLY against an uninterrupted run.

    python -m aclswarm_torch.resilience.smoke [--device cpu]

Both processes run on the CUDA card unless ``--device`` names another
device; the child runs on the parent's device.

``--overhead`` instead measures the checkpoint tax in the trial driver
(acceptance bar: < 5% wall at n=10, checkpointing every 10th chunk; the
pessimal every-chunk cadence is reported beside it). Nothing is written
unless ``--out`` names a file:

    python -m aclswarm_torch.resilience.smoke --overhead [--out rows.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N = 5
CHUNK = 10
N_CHUNKS = 4
KILL_AT = 1


def _problem(n: int, device=None, dtype=torch.float32):
    from aclswarm_torch import sim
    from aclswarm_torch.core.types import (ControlGains, SafetyParams,
                                           make_formation)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.full(n, 2.0)], 1)
    adj = np.ones((n, n)) - np.eye(n)
    gains = np.eye(n)[:, :, None, None] * np.eye(3)[None, None] * 0.01
    form = make_formation(pts, adj, gains, device=device, dtype=dtype)
    sparams = SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                           bounds_max=(50.0, 50.0, 10.0))
    rng = np.random.default_rng(0)
    q0 = rng.normal(size=(n, 3)) * 2.0 + [0, 0, 2.0]
    state = sim.init_state(q0, device=device, dtype=dtype)
    cfg = sim.SimConfig(assignment="auction", assign_every=CHUNK)
    return state, form, ControlGains(), sparams, cfg


def _host_metrics(m):
    """`StepMetrics` with every tensor copied to the host (numpy)."""
    import dataclasses

    return dataclasses.replace(m, **{
        f.name: getattr(m, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(m)
        if isinstance(getattr(m, f.name), torch.Tensor)})


def chunked_run(ckpt_dir=None, resume: bool = True, n: int = N,
                chunk: int = CHUNK, n_chunks: int = N_CHUNKS,
                keep_metrics: bool = True, device=None,
                dtype=torch.float32):
    """The minimal chunked driver: rollout per chunk, checkpoint at each
    boundary, scripted-crash hook; on ``device`` (None = the CUDA card) in
    ``dtype``. Returns (final_state, [(chunk_idx, metrics), ...]), the
    metrics as host copies."""
    from aclswarm_torch import convert, sim
    from aclswarm_torch.resilience import checkpoint as ckptlib
    from aclswarm_torch.resilience import maybe_crash

    state, form, cgains, sparams, cfg = _problem(n, device, dtype)
    dev = state.swarm.q.device
    cfg_hash = ckptlib.config_hash(
        {"n": n, "chunk": chunk, "n_chunks": n_chunks})
    fingerprint = ckptlib.dtype_fingerprint(dtype, dev)
    stem = "smoke"
    k0 = 0
    if ckpt_dir is not None and resume:
        path = ckptlib.latest_checkpoint(ckpt_dir, stem)
        if path is not None:
            payload, man = ckptlib.load_checkpoint(
                path, expected=ckptlib.expected_manifest("smoke", cfg_hash,
                                                         fingerprint))
            state = ckptlib.restore_state(state, payload["state"],
                                          path=path)
            k0 = int(man["chunk"])
    out = []
    for k in range(k0, n_chunks):
        state, m = sim.rollout(state, form, cgains, sparams, cfg, chunk)
        if keep_metrics:
            out.append((k, _host_metrics(m)))
        if ckpt_dir is not None:
            ckptlib.write_checkpoint(
                ckpt_dir, stem, {"state": convert.sim_state_to_numpy(state)},
                ckptlib.make_manifest("smoke", cfg_hash, k + 1, fingerprint))
        maybe_crash("smoke", k + 1)
    return state, out


def _leaves(tree):
    from aclswarm_torch.resilience import checkpoint as ckptlib
    return ckptlib.tree_arrays(tree)


def _same(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(la, lb))


def run_smoke(device=None) -> int:
    from aclswarm_torch.core.types import resolve_device
    from aclswarm_torch.resilience import checkpoint as ckptlib
    from aclswarm_torch.resilience.crash import ENV_VAR

    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(prefix="aclswarm_smoke_") as d:
        # 1. child: checkpoint every chunk, SIGKILL at boundary KILL_AT
        env = dict(os.environ,
                   **{ENV_VAR: f"smoke:{KILL_AT}:kill"})
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "aclswarm_torch.resilience.smoke",
             "--child", "--dir", d, "--device", str(dev)],
            env=env, capture_output=True, text=True, timeout=600)
        if r.returncode != -signal.SIGKILL:
            print(f"FAIL: child exited {r.returncode}, expected "
                  f"{-signal.SIGKILL} (SIGKILL)\n{r.stdout}\n{r.stderr}")
            return 1
        left = ckptlib.latest_checkpoint(d, "smoke")
        if left is None:
            print("FAIL: killed child left no checkpoint")
            return 1
        print(f"child SIGKILL'd at chunk boundary {KILL_AT} after "
              f"{time.time() - t0:.1f}s; checkpoint: {left.name}")

        # 2. resume + 3. bit-parity against an uninterrupted run
        state_res, metrics_res = chunked_run(ckpt_dir=d, device=dev)
        state_ref, metrics_ref = chunked_run(ckpt_dir=None, device=dev)
        ref_by_chunk = dict(metrics_ref)
        if [k for k, _ in metrics_res] != list(range(KILL_AT, N_CHUNKS)):
            print(f"FAIL: resume ran chunks "
                  f"{[k for k, _ in metrics_res]}, expected "
                  f"{list(range(KILL_AT, N_CHUNKS))}")
            return 1
        for k, m in metrics_res:
            if not _same(m, ref_by_chunk[k]):
                print(f"FAIL: chunk {k} metrics differ after resume")
                return 1
        if not _same(state_res, state_ref):
            print("FAIL: final state differs after resume")
            return 1
    print(f"PASS: resumed rollout is bit-identical to the uninterrupted "
          f"run (n={N}, {N_CHUNKS} chunks, killed at {KILL_AT}, "
          f"{dev.type})")
    return 0


def run_overhead(out: str | None = None, n: int = 10, reps: int = 3,
                 device=None) -> int:
    """Checkpoint tax in the REAL driver (`harness.trials.run_trial`,
    simform{n}, on ``device``, None = the CUDA card): median relative wall
    overhead vs checkpointing off, at the default cadence (acceptance:
    < 5%) and at the pessimal every-chunk cadence (reported for honesty —
    it is file-IO-bound on sub-second trials). Rows go to stdout, and to
    ``out`` only when it names a file."""
    from aclswarm_torch.core.types import resolve_device
    from aclswarm_torch.harness import trials as triallib

    dev = resolve_device(device)
    base = dict(formation=f"simform{n}", trials=1, seed=1, verbose=False,
                out="/dev/null", device=str(dev))
    default_every = triallib.TrialConfig.checkpoint_every
    n_chunks = [0]
    with tempfile.TemporaryDirectory(prefix="aclswarm_ovh_") as d:
        # warm the caches outside the timed region
        triallib.run_trial(triallib.TrialConfig(**base), 0)
        offs, ons, ons1 = [], [], []
        for r in range(reps):
            t0 = time.perf_counter()
            fsm = triallib.run_trial(triallib.TrialConfig(**base), 0)
            offs.append(time.perf_counter() - t0)
            n_chunks[0] = int(np.ceil((fsm.tick_count + 1)
                                      / triallib.TrialConfig.chunk_ticks))
            for every, acc in ((default_every, ons), (1, ons1)):
                sub = str(Path(d) / f"rep{r}_e{every}")
                cfg = triallib.TrialConfig(checkpoint_dir=sub,
                                           resume=False,
                                           checkpoint_every=every,
                                           **base)
                t0 = time.perf_counter()
                triallib.run_trial(cfg, 0)
                acc.append(time.perf_counter() - t0)
    off = float(np.median(offs))
    on = float(np.median(ons))
    on1 = float(np.median(ons1))
    frac = on / off - 1.0
    rows = [
        {"name": f"checkpoint_overhead_frac_n{n}", "n": n,
         "value": round(frac, 4), "unit": "ratio",
         "wall_off_s": round(off, 3), "wall_on_s": round(on, 3),
         "chunks": n_chunks[0], "checkpoint_every": default_every,
         "reps": reps,
         "note": f"run_trial simform{n} on {dev.type} at the default "
                 "cadence; acceptance < 0.05"},
        {"name": f"checkpoint_overhead_frac_n{n}_every1", "n": n,
         "value": round(on1 / off - 1.0, 4), "unit": "ratio",
         "wall_on_s": round(on1, 3),
         "note": "pessimal every-chunk cadence (file-IO-bound on "
                 "sub-second trials) — context row, no acceptance bar"},
        {"name": f"checkpoint_write_ms_n{n}", "n": n,
         "value": round(max(0.0, (on1 - off) / max(1, n_chunks[0]))
                        * 1e3, 3),
         "unit": "ms"},
    ]
    for row in rows:
        print(json.dumps(row))
    if out:
        p = Path(out)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"wrote {p}")
    return 0 if frac < 0.05 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true",
                    help="(internal) the to-be-killed child run")
    ap.add_argument("--dir", default=None,
                    help="(internal) checkpoint directory")
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the CUDA card)")
    ap.add_argument("--overhead", action="store_true",
                    help="measure the checkpoint tax instead")
    ap.add_argument("--out", default=None,
                    help="(with --overhead) rows file; default: none")
    args = ap.parse_args(argv)
    if args.child:
        chunked_run(ckpt_dir=args.dir, resume=False, keep_metrics=False,
                    device=args.device)
        return 0
    if args.overhead:
        return run_overhead(args.out, device=args.device)
    return run_smoke(args.device)


if __name__ == "__main__":
    sys.exit(main())

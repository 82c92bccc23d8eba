#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`aclswarm_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Phases, one JSON line each; any failure raises, so the run exits non-zero
and prints no result line:

1. device  — the card's name, count, and `nvidia-smi` name + power limit;
2. build   — the CUDA kernels built from `aclswarm_torch/csrc/` with nvcc
             (seconds, ptxas register/shared-memory lines) and the opcode
             counts of the two flood-merge kernels in the library's SASS
             (`cuobjdump -sass`), which show the DPX instruction K3's fold
             compiles to;
3. gains   — the ADMM gain design (`aclswarm_torch.gains`): card against
             CPU at n=200 in float64 and float32; at n=1000 in float32 the
             main path's design with the launch counters read around it
             (no kernel of the port runs there), exact zero blocks, the
             trace, `validate_gains(tol=2e-4)`, cold and warm ms, ADMM and
             Newton steps, host reads, peak memory, each subproblem's and
             the Gram pseudo-inverse's ms; and, as a finding, how far gains
             on cuSOLVER's kernel basis land from the port's (printed, not
             checked). Every slice below flies these designed gains, x 0.15
             as the suite scales them (`design`, `problem`);
4. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (n=1000): K1 Sinkhorn atol 5e-5 and
             marginals 1e-4, K2 rounding (permutation and round count) and
             K3 flood merge bit-identical; kernel, previous-design and plain
             times from CUDA events — K2's two designs from the profiler's
             device time, with its first round alone and the lines its
             rounds rescanned; then the edge cases (K3: w=37, an
             empty comm row, packed 0 and SENTINEL, n=1001; K1: n=1001,
             n=64, pin/forbid, n=2500 past the stripe limit; K2: all ties,
             n=1, n=64, n=1001, -inf lines and signed-zero ties, pin/forbid,
             max_rounds=3, n=14000), each with the launches it made;
5. reference — the Sinkhorn slice and the CBAA slice at a small size on
             the card (f32, kernels) against the same runs on the CPU (f32,
             plain versions), one copy of the designed gains for both;
6. slice   — the `simform1000_flooded` deployment
             (`benchmarks/trials_suite.py`) at n=1000, float32: a seeded
             formation, 240 ticks through `sim.init_state` + `sim.rollout`,
             with the launch counters read around that run;
7. profile — one auction period of the slice under `torch.profiler`:
             device time by kernel, the device's idle share, and each
             kernel's launches as the profiler saw them against its
             launch counter; then phases 6 and 7 once more on the random
             gains earlier runs flew, for the record;
8. auction — one `auction_lap` at n=1000 on the card against the same call
             on the CPU from one benefit matrix: assignment, rounds,
             validity and prices equal; rounds, phases, host reads (the
             profiler's device-to-host copies), ms, and the total cost
             beside Sinkhorn's; a tie-heavy integer matrix the same way;
9. cbaa    — one cold `cbaa_from_state` at n=1000 (`task_block=64`, `est`
             from a flooded table) on the card against the CPU, then a
             second auction seeded with the first's tables; rounds, ms per
             round and per auction, the local alignment's ms; and n=64
             dense against `task_block=16`, bit-identical;
10. slice_cbaa — the `simform1000_cbaa_flooded` deployment, 121 ticks (two
             auctions), with the launch counters read around that run: K3
             once per tick, K1 and K2 never; ms per tick on and off
             auction ticks;
11. slice_auction — the same start under the default assignment
             ('auction', ground truth), 121 ticks, no kernel of the port on
             its path; and the default `SimConfig()` at n=6 (random gains)
             for 240 ticks on the card against the CPU;
12. trial   — the `simform1000_flooded` row flown as a trial through
             `harness.trials.run_trial` (float32, `trial_timeout` cut to
             14 s): takeoff, hover, one dispatch whose ADMM design is
             validated, Sinkhorn auctions after it; the FSM's path, the
             launch counts (K3 every tick, K1 = K2 = the auctions after
             the dispatch), the device-to-host copies of whole chunks, ms
             per tick of hover and flying chunks, the FSM's host ms per
             chunk, wall against simulated seconds; then `swarm6_3d` (seed
             1, library gains) on the card against the CPU;
13. batch_kernels — each kernel's batched launch (B=5 problems at n=1000,
             the main path's inputs of seeds S..S+4) against B single
             launches, bit for bit (K1 too: a batch keeps each line's
             reduction order), and against its plain batched version (K1
             atol 5e-5, marginals 1e-4); launches, ms per batched call
             against the B single calls' ms, the bound for B problems;
             K2's batched design against one single-block launch per
             plan; edge cases B=1 and B=3 at n=1001;
14. slice_batch — `sim.batched_rollout` of five `simform1000_flooded`
             airborne starts (seeds S..S+4, designed gains x 0.15), 240
             ticks, beside five serial `rollout`s of the same starts:
             `v2f` and `auctioned` equal, K3 once per tick for the whole
             wave, K1 in its residency waves and K2 once per auction tick;
             max |dq| against the serial runs, ms and launches per batched
             tick, device busy and idle share from the profiler, peak
             memory;
15. trial_batch — `run_trials` with batch=5, trials=5: the
             `simform1000_flooded` row at chunk_ticks 120 (as the suite
             flies batched rows), float32, `trial_timeout` cut to 14 s as
             in `trial`: every trial's FSM path and dispatch ticks, the
             first dispatch's design validated, launch counts, the
             device-to-host copies of profiled chunks, compactions, peak
             memory and the wave's simulated trial-seconds per wall
             second; trial 0 beside the same trial flown alone at the same
             chunking;
16. faults — the fault grid of `benchmarks/faults_suite.py` (eight
             (dropout, link loss) rows, one `sample_schedule` each) on
             eight copies of the slice's start as one batched rollout of
             360 ticks, drops at 60 and rejoins at 180: K1 (atol 5e-5 plus
             2^-22 |plain| for the forbidden entries, marginals 1e-4) and
             K2 on the tick-120 masked cost of the 0.5-dropout row, K3 on
             its lossy dead-masked comm of the (0.3, 0.6) row (both
             bit-identical); link masks card against CPU bit for bit; the
             dead frozen and pinned; the recovery clock per trial; the
             link draw's launches and device ms; launches and device busy
             over ticks 120-159; `no_faults` against ``faults=None``
             serially, bit for bit, over 240 ticks;
17. slice_scenarios — one draw of each of the eight scenario families on
             eight copies of the slice's start, one batched rollout of
             240 ticks: every trial's events fire; `no_scenario` against
             ``scenario=None`` bit for bit; uniform draws card against CPU
             bit for bit, normal draws' max |dz| reported; each axis
             draw's launches and device ms; profiled over ticks 120-159
             (as `faults`);
18. trial_scenarios — the `trial_batch` wave with a `kitchen_sink` draw
             per trial over a 160-tick horizon: outcomes, paths,
             trial-seconds per wall second beside `trial_batch`'s, copies
             of the profiled chunk 11; then `swarm6_3d` under `wind_gust`
             (cut at 30 s) on the card against the CPU;
19. checks — the slice's 240 ticks with ``check_mode`` and ``telemetry``
             off, then on, from one start: every invariant code 0, q and
             v2f bit-identical, the off run's launches equal `slice`'s,
             the counters equal their recomputation from the metrics; ms
             and kernel launches per tick, on against off; then four
             mutations on the card, each tripping its own contract at its
             own tick (a NaN pose at tick 150, a duplicated row in K2's
             tick-120 permutation, an asymmetric adjacency, K1's tick-120
             plan with its mass doubled);
20. checks_faults — the `faults` batch off and on: every trial clean,
             bit-identical, counters recomputed; a stale alive mask
             injected into one trial trips `mask_consistency` on that
             trial alone; ms per batched tick, on against off;
21. trial_checked — the `trial` configuration with every observability
             field on: `trial`'s verdict, path, times and CSV row; the
             recording replayed to the live FSM's state and times; the
             dumped counters equal the carry's; the trace written; the
             device-to-host reads Python makes per chunk (wrapped
             `Tensor` methods) within the bound; simulated seconds per
             wall second against `trial`'s;
22. trial_batch_checked — the `trial_batch` wave checked and counted:
             its verdicts, paths and CSV rows, each trial's counters
             published; trial-seconds per wall second against
             `trial_batch`'s;
23. churn — the reference's churn/lag curve (n=24, CBAA under
             `goal_drift`, 2400 ticks, assign_eps 0 and 0.05) read from the
             `reassigns` and `auctions` counters;
24. the `kernels` line, then the result line. Each kernel row carries the
   contract's keys plus `design`, `prev_design` and `prev_ms` (the first
   design, timed in this run), `launches_by_path` and `batched` (the
   batch_kernels figures); K2's row also its rounds and the dense bound
   that earlier runs reported.

Each phase is followed by a line with its seconds. The `gains` phase's
cuSOLVER-basis finding and the `cbaa` phase's cold card-against-CPU
auction run at seeds S, S+1 and S+2. ``--phases a,b`` runs the device and
build phases and then only the named ones, for debugging: it prints no
kernels line and no result line.

Needs a CUDA card and the repository (it imports `aclswarm_torch`).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

N = 1000
TICKS = 240             # two auctions (ticks 0 and 120) at assign_every=120
SINKHORN_ITERS = 200    # `sinkhorn_assign`'s default, as the engine calls it
K1_LAUNCHES_PER_SOLVE = 1   # the persistent design at n=1000
K2_LAUNCHES_PER_CALL = 1    # one cooperative launch per rounding
# K2's designs as the profiler names their kernels: the current one and
# the first port's single-block kernel
K2_KERNELS = ("round_persistent_kernel",)
K2_PREV_KERNELS = ("round_dominant_kernel",)
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM rate, and 32-bit
# non-tensor-core operations — the kernels' float and integer vector work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# the simform1000_flooded row of benchmarks/trials_suite.py
SUITE = dict(sim_l=130.0, sim_w=130.0, sim_h=3.0, sim_min_dist=3.0,
             init_area_w=120.0, init_area_h=120.0, init_radius=1.0,
             room=(200.0, 200.0, 30.0))
SAFETY = dict(max_vel_xy=1.0, max_vel_z=0.5, max_accel_xy=1.0,
              max_accel_z=1.0)
GAINS = dict(e_xy_thr=1.0, e_z_thr=0.3, kd=0.0005, K1_xy=0.005)
ENGINE = dict(assignment="sinkhorn", localization="flooded", flood_block=64,
              flood_phases=2, colavoid_neighbors=16, assign_eps=0.01,
              dynamics="doubleint")
# the simform1000_cbaa_flooded row: the same boxes and limits, CBAA in
# task blocks of 64, no hysteresis, the keep-out escape on
ENGINE_CBAA = dict(assignment="cbaa", cbaa_task_block=64,
                   localization="flooded", flood_block=64, flood_phases=2,
                   colavoid_neighbors=16, dynamics="doubleint")
KEEPOUT_REPULSE_VEL = 0.3
# the default assignment on the same start: the centralized auction reads
# ground truth, so no estimate tables and no flood
ENGINE_AUCTION = dict(assignment="auction", localization="truth",
                      colavoid_neighbors=16, dynamics="doubleint")
TICKS_AUCTIONS = 121    # two auctions: ticks 0 and 120
GAIN_SCALE = 0.15       # the simform1000 rows' gain_scale
# the simform1000_flooded row of benchmarks/trials_suite.py, as a trial
TRIAL_ROW = dict(
    formation="simform1000", assignment="sinkhorn", localization="flooded",
    flood_block=64, flood_phases=2, colavoid_neighbors=16, chunk_ticks=100,
    sim_l=130.0, sim_w=130.0, sim_h=3.0, sim_min_dist=3.0,
    init_area_w=120.0, init_area_h=120.0, init_radius=1.0,
    room_x=200.0, room_y=200.0, room_z=30.0, max_vel_xy=1.0, max_vel_z=0.5,
    max_accel_xy=1.0, max_accel_z=1.0, trial_timeout=1200.0,
    e_xy_thr=1.0, e_z_thr=0.3, kd=0.0005, K1_xy=0.005, gain_scale=0.15,
    assign_eps=0.01)
# the one cut: takeoff (~6 s with the 1 s CMD_GO latency), the full 5 s
# hover, a dispatch at a chunk boundary near tick 1100 and at least two
# auctions after it
TRIAL_TIMEOUT_CUT = 14.0
# device-to-host copies a trial chunk may make: the FSM's signals
# (`trials._host_signals`), and per auction tick the global alignment's
# (`geometry.align` makes two on the card: a (2, 2) SVD, two determinants)
CHUNK_READS, AUCTION_READS = 2, 2
# a wave of batched trials: the simform1000_flooded row's five trials
BATCH = 5
# K1's residency waves for a batch of n=1000 solves on a 132-SM H100:
# three solves share a cooperative launch (csrc/sinkhorn.cu)
K1_WAVES = {1: 1, 2: 1, 3: 1, 4: 2, 5: 2}
# the suite runs batched rows at chunk_ticks 120, a multiple of
# assign_every (benchmarks/trials_suite.py, --batch)
BATCH_CHUNK = 120


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _group(n: int, seed: int, k: int = 1) -> tuple[list, np.ndarray]:
    """The seeded formations (k of them, one graph) in the suite's boxes."""
    from aclswarm_torch.harness import formgen

    group = formgen.generate_group(n, seed=seed, l=SUITE["sim_l"],
                                   w=SUITE["sim_w"], h=SUITE["sim_h"],
                                   min_dist=SUITE["sim_min_dist"], k=k)
    return ([np.asarray(f["points"]) for f in group["formations"]],
            np.asarray(group["adjmat"], float))


@functools.lru_cache(maxsize=None)
def design(n: int, seed: int) -> torch.Tensor:
    """The seeded formation's (3n, 3n) gains as the trial harness designs
    them on dispatch (`harness.trials._dispatch_gains`): ADMM on the card
    in float32, non-edges in the n-4 bucket, before the suite's
    gain_scale. Designed once per (n, seed)."""
    from aclswarm_torch.harness import formations, trials

    (points,), adj = _group(n, seed)
    cfg = trials.TrialConfig(formation=f"simform{n}", device="cuda")
    spec = formations.FormationSpec("A", points, adj, None)
    return trials._dispatch_gains(cfg, spec, n,
                                  device=torch.device("cuda"))[0]


def problem(n: int, seed: int, device, dtype, start_min_dist: float,
            localization: bool = True, gains: str = "admm", **safety):
    """Formation, parameters and airborne start state from one seed, with
    the suite's generation boxes. ``gains='admm'``: the designed gains
    (`design`) scaled by the suite's gain_scale, one numpy copy for every
    device; ``'random'``: (n, n, 3, 3) normal blocks x 0.01 from the seed,
    the gains earlier runs flew. ``safety`` overrides `SafetyParams`
    fields."""
    from aclswarm_torch import sim
    from aclswarm_torch.core import types
    from aclswarm_torch.harness import formgen

    (points,), adj = _group(n, seed)
    rng = np.random.default_rng(seed)
    random_gains = rng.normal(size=(n, n, 3, 3)) * 0.01
    gain = random_gains if gains == "random" \
        else design(n, seed).cpu().numpy() * GAIN_SCALE
    q0 = formgen.sample_cylinder_points(rng, n, SUITE["init_area_w"],
                                        SUITE["init_area_h"], 0.0,
                                        start_min_dist)
    q0[:, 2] = 1.0                              # airborne at takeoff_alt
    formation = types.make_formation(points, adj, gain, device=device,
                                     dtype=dtype)
    rx, ry, rz = SUITE["room"]
    sparams = types.SafetyParams(bounds_min=(-rx, -ry, 0.0),
                                 bounds_max=(rx, ry, rz),
                                 **dict(SAFETY, **safety))
    state = sim.init_state(q0, flying=True, localization=localization,
                           device=device, dtype=dtype)
    return formation, types.ControlGains(**GAINS), sparams, state


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernels: tuple, per_call: int = 1) -> float:
    """Mean device milliseconds per call of ``fn`` spent in the named
    kernels, from `torch.profiler`'s kernel events over ``reps`` calls
    after one warm-up: the mean event times ``per_call``, the events one
    call launches. For a kernel shorter than its wrapper's host work:
    CUDA events around back-to-back calls would time the host there.
    CUPTI can lose a window's records (PERF.md, PR 5 and PR 7), so a
    window short of ``reps * per_call`` events is traced again, up to
    three times in all, and the mean per event does not count a lost
    record as zero time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best: list = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if any(k + "(" in e.name for k in kernels)]
        if len(us) > len(best):
            best = us
        if len(best) >= reps * per_call:
            break
    if not best:
        raise AssertionError(f"the profiler saw no kernel of {kernels} in "
                             "three traced windows")
    return sum(best) / len(best) * per_call / 1e3


def _ab_device_ms(new, prev, reps: int) -> tuple[float, float]:
    """Device ms of two versions, each (fn, kernel names), in turns (new,
    prev, prev, new)."""
    t = [device_ms(fn, reps, k) for fn, k in (new, prev, prev, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def _sass_opcodes(library: str) -> dict:
    """Opcode counts of each flood-merge kernel in the library's SASS."""
    from aclswarm_torch.ops import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", library],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts: dict[str, Counter] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            current = next((k for k in ("flood_merge_bytemask_kernel",
                                        "flood_merge_kernel") if k in name),
                           None)
            if current:
                counts[current] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)", line)
        if current and m:
            counts[current][m.group(1)] += 1
    if set(counts) != {"flood_merge_kernel", "flood_merge_bytemask_kernel"}:
        raise AssertionError(f"SASS of the flood kernels not found: "
                             f"{sorted(counts)}")
    return {k: {"total": sum(c.values()),
                "min_ops": {op: x for op, x in c.items() if "MNMX" in op},
                "top": dict(c.most_common(10))} for k, c in counts.items()}


def phase_build() -> None:
    from aclswarm_torch import ops

    t0 = time.perf_counter()
    log = ops.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": log["library"], "cached": log["cached"],
          "ptxas": [ln for ln in log["ptxas"].splitlines()
                    if "registers" in ln or "Compiling entry" in ln],
          "sass": _sass_opcodes(log["library"])})


def _counted(name: str, fn):
    """``fn()`` and the launches wrapper ``name`` counted during it."""
    from aclswarm_torch import ops

    before = ops.LAUNCHES[name]
    out = fn()
    return out, ops.LAUNCHES[name] - before


def _sinkhorn_multi(cost, tau, iters):
    """K1's multi-launch design, called past the size rule that routes
    n=1000 to the persistent design: its time is the `prev_ms` baseline.
    Not counted: it is no launch of the main path."""
    from aclswarm_torch.ops import _build

    n = cost.shape[0]
    out = torch.empty_like(cost)
    f = torch.zeros(n, dtype=torch.float32, device=cost.device)
    g = torch.zeros_like(f)
    launched = ctypes.c_int(0)
    _build.launch("sinkhorn_log_multi_launch", cost.device, cost.data_ptr(),
                  out.data_ptr(), f.data_ptr(), g.data_ptr(), n, float(tau),
                  int(iters), -math.log(n), ctypes.byref(launched))
    return out


def _flood_bytemask(packed, comm):
    """K3's byte-mask design (the `prev_ms` baseline), not counted; one
    problem (n, w) or a batch (B, n, w)."""
    from aclswarm_torch.ops import _build

    *lead, n, w = packed.shape
    out = torch.empty_like(packed)
    _build.launch("flood_merge_bytemask_launch", packed.device,
                  packed.data_ptr(), comm.data_ptr(), out.data_ptr(),
                  lead[0] if lead else 1, n, w)
    return out


def _round_single_block(plan):
    """K2's single-block design (the `prev_ms` baseline), not counted; one
    plan (n, n) or a batch (B, n, n), one block per plan."""
    from aclswarm_torch.ops import _build

    *lead, n = plan.shape[:-1]
    out = torch.empty((*lead, n), dtype=torch.int32, device=plan.device)
    rounds = torch.empty(tuple(lead), dtype=torch.int32, device=plan.device)
    _build.launch("round_dominant_single_block_launch", plan.device,
                  plan.data_ptr(), out.data_ptr(), rounds.data_ptr(),
                  lead[0] if lead else 1, n, n)
    return out, rounds


def _ab_ms(new, prev, reps: int) -> tuple[float, float]:
    """Mean ms of two versions timed in turns (new, prev, prev, new)."""
    t = [time_ms(fn, reps) for fn in (new, prev, prev, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def _masses(plan):
    return [torch.exp(torch.logsumexp(plan, dim=d)) for d in (-2, -1)]


def _check_sinkhorn(label, cost, tau, iters, launches_expected,
                    rtol=0.0) -> dict:
    """K1 against its plain version: |kernel - plain| <= 5e-5 + rtol |plain|
    and row/column masses within 1e-4 of the plain version's."""
    from aclswarm_torch import ops

    plan, launches = _counted("sinkhorn_log",
                              lambda: ops.sinkhorn_log(cost, tau, iters))
    ref = ops.sinkhorn_log_plain(cost, tau, iters)
    torch.cuda.synchronize()
    excess = ((plan - ref).abs() - rtol * ref.abs()).max().item()
    err = (plan - ref).abs().max().item()
    marg = max((a - b).abs().max().item()
               for a, b in zip(_masses(plan), _masses(ref)))
    info = {"check": label, "shape": list(cost.shape), "launches": launches,
            "max_abs_err": err, "mass_err_vs_plain": marg}
    if not (excess <= 5e-5 and marg <= 1e-4
            and launches == launches_expected):
        raise AssertionError(f"K1 edge check failed: {info} (launches "
                             f"expected {launches_expected}, rtol {rtol})")
    return info


def _check_flood(label, packed, comm) -> dict:
    from aclswarm_torch import ops

    merged, launches = _counted("flood_merge",
                                lambda: ops.flood_merge(packed, comm))
    ref = ops.flood_merge_plain(packed, comm, block=64)
    info = {"check": label, "shape": list(packed.shape),
            "launches": launches, "bit_identical": torch.equal(merged, ref),
            "baseline_identical": torch.equal(_flood_bytemask(packed, comm),
                                              ref)}
    if not (info["bit_identical"] and info["baseline_identical"]
            and launches == 1):
        raise AssertionError(f"K3 edge check failed: {info}")
    return info


def _check_rounding(label, plan, max_rounds=None) -> dict:
    """K2 against its plain version, permutation and round count."""
    from aclswarm_torch import ops

    (perm, rounds), launches = _counted(
        "round_dominant", lambda: ops.round_dominant(plan, max_rounds))
    ref, ref_rounds = ops.round_dominant_plain(plan, max_rounds)
    info = {"check": label, "shape": list(plan.shape),
            "max_rounds": max_rounds, "launches": launches,
            "rounds": rounds.tolist(),
            "bit_identical": bool(torch.equal(perm, ref)
                                  and torch.equal(rounds, ref_rounds)),
            "assigned": int((perm >= 0).sum())}
    if not (info["bit_identical"] and launches == K2_LAUNCHES_PER_CALL):
        raise AssertionError(f"K2 edge check failed: {info}")
    return info


def _rounding_edge_plan(n, seed, dev):
    """Small integers (many exact ties, +0.0 and -0.0 among them), two rows
    and two columns all -inf and 1% of the entries -inf."""
    g = torch.Generator(device=dev).manual_seed(seed)
    plan = torch.randint(-3, 4, (n, n), generator=g, device=dev).float()
    signs = torch.rand(n, n, generator=g, device=dev) < 0.5
    plan = torch.where((plan == 0) & signs, torch.full_like(plan, -0.0), plan)
    plan[[3, n // 2]] = -math.inf
    plan[:, [5, n - 1]] = -math.inf
    plan[torch.rand(n, n, generator=g, device=dev) < 0.01] = -math.inf
    return plan.contiguous()


def _flood_edge_case(n, w, seed, dev):
    """Packed values over their whole range with 0, SENTINEL and the
    largest real value (AGE_CAP << 16 | 0xffff) planted; comm at 30% with
    an empty receiver row and a receiver whose one sender holds SENTINEL
    everywhere."""
    from aclswarm_torch.ops.flood import SENTINEL
    from aclswarm_torch.sim import localization as loclib

    rng = np.random.default_rng(seed)
    packed = rng.integers(0, SENTINEL, (n, w), endpoint=True)
    for value in (0, SENTINEL, (loclib.AGE_CAP << 16) | 0xFFFF):
        packed.flat[rng.choice(n * w, n, replace=False)] = value
    comm = rng.random((n, n)) < 0.3
    comm[0] = False
    comm[1] = False
    comm[1, 2] = True
    packed[2] = SENTINEL
    return (torch.tensor(packed.astype(np.int32), device=dev),
            torch.tensor(comm, device=dev))


def _uniform_cost(n, seed, dev):
    rng = np.random.default_rng(seed)
    q, p = rng.uniform(-65, 65, (n, 3)), rng.uniform(-65, 65, (n, 3))
    c = np.linalg.norm(q[:, None] - p[None], axis=-1)
    return torch.tensor(c / c.mean(), dtype=torch.float32, device=dev)


def phase_kernels(seed: int) -> dict:
    """Each kernel vs its plain version on the main path's inputs: the
    first auction's normalized cost, its plan, and the flood's packed
    stripes under the formation's comm graph; then the edge cases."""
    from aclswarm_torch import ops
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.faults import masking
    from aclswarm_torch.ops import rounding
    from aclswarm_torch.sim import localization as loclib

    dev = torch.device("cuda")
    formation, _, _, state = problem(N, seed, dev, torch.float32,
                                     2 * SUITE["init_radius"])
    q = state.swarm.q
    p_al = geometry.align(formation.points,
                          permutil.veh_to_formation_order(q, state.v2f))
    raw = geometry.cdist_fast(q, p_al)
    cost = (raw / (torch.mean(raw) + 1e-12)).contiguous()
    tau, iters = 0.03, SINKHORN_ITERS
    out = {}

    plan, launches = _counted("sinkhorn_log",
                              lambda: ops.sinkhorn_log(cost, tau, iters))
    plan_ref = ops.sinkhorn_log_plain(cost, tau, iters)
    plan_prev = _sinkhorn_multi(cost, tau, iters)
    torch.cuda.synchronize()
    err = (plan - plan_ref).abs().max().item()
    err_prev = (plan_prev - plan_ref).abs().max().item()
    marg = max((m - 1.0 / N).abs().max().item() for m in _masses(plan))
    if not (err <= 5e-5 and marg <= 1e-4 and err_prev <= 5e-5
            and launches == K1_LAUNCHES_PER_SOLVE):
        raise AssertionError(f"K1 sinkhorn_log: max |kernel - plain| {err} "
                             f"(limit 5e-5), marginal error {marg} (1e-4), "
                             f"previous design {err_prev}, launches "
                             f"{launches} (expected {K1_LAUNCHES_PER_SOLVE})")
    b, by = bound_ms(10 * N * N * iters + 2 * N * N, 8 * N * N)
    ms, prev_ms = _ab_ms(lambda: ops.sinkhorn_log(cost, tau, iters),
                         lambda: _sinkhorn_multi(cost, tau, iters), 10)
    out["sinkhorn_log"] = dict(
        max_abs_err=err, marginal_err=marg, prev_max_abs_err=err_prev,
        launches_per_solve=launches, bound_ms=b, bound_by=by, ms=ms,
        prev_ms=prev_ms,
        plain_ms=time_ms(lambda: ops.sinkhorn_log_plain(cost, tau, iters),
                         3))

    (perm, rounds), launches = _counted("round_dominant",
                                        lambda: ops.round_dominant(plan))
    perm_ref, rounds_ref = ops.round_dominant_plain(plan)
    perm_prev, rounds_prev = _round_single_block(plan)
    if not (torch.equal(perm, perm_ref) and int(rounds) == int(rounds_ref)
            and bool(permutil.is_valid(perm))
            and torch.equal(perm_prev, perm_ref)
            and int(rounds_prev) == int(rounds_ref)
            and launches == K2_LAUNCHES_PER_CALL):
        raise AssertionError(f"K2 round_dominant: a design's permutation or "
                             f"round count differs from the plain version's,"
                             f" or launches {launches} != "
                             f"{K2_LAUNCHES_PER_CALL}")
    rounds = int(rounds)
    seen = rounding.rescans(rounding.launch(plan, None)[2], N)
    # what these inputs need: the plan read once and the permutation written
    # once; a compare and a select per entry that a scan reads — round 1
    # reads every entry for its row and for its column, later rounds the
    # live entries of the lines they rescan
    entries = 2 * N * N + seen["entries"]
    b, by = bound_ms(2 * entries, 4 * N * N + 4 * N)
    # earlier runs' yardstick: the TPU kernel's ten dense sweeps per round
    b_dense, by_dense = bound_ms(10 * N * N * rounds, 4 * N * N + 4 * N)
    # device time from the profiler: one call is shorter than the
    # wrapper's host work, so CUDA events around back-to-back calls time
    # the host (call_ms)
    new = (lambda: ops.round_dominant(plan), K2_KERNELS)
    ms, prev_ms = _ab_device_ms(new, (lambda: _round_single_block(plan),
                                      K2_PREV_KERNELS), 20)
    out["round_dominant"] = dict(
        max_abs_err=0.0, rounds=rounds, launches_per_call=launches,
        rescanned_rows=seen["rows"], rescanned_cols=seen["cols"],
        entries_read=entries, bound_ms=b, bound_by=by, dense_bound_ms=b_dense,
        dense_bound_by=by_dense, ms=ms, prev_ms=prev_ms,
        first_round_ms=device_ms(lambda: ops.round_dominant(plan, 1), 20,
                                 K2_KERNELS),
        call_ms=time_ms(lambda: ops.round_dominant(plan), 20),
        plain_ms=time_ms(lambda: ops.round_dominant_plain(plan), 3))

    comm = loclib.comm_mask(formation.adjmat, state.v2f).contiguous()
    rng = np.random.default_rng(seed)
    age = torch.tensor(rng.integers(0, 200, (N, N)), dtype=torch.int32,
                       device=dev)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    nnz = int(comm.sum())
    for w in (N // 2, N):
        packed = ((torch.clamp(age[:, :w], max=loclib.AGE_CAP) << 16)
                  | ids[:, None]).contiguous()
        merged = ops.flood_merge(packed, comm)
        ref = ops.flood_merge_plain(packed, comm)
        if not (torch.equal(merged, ref)
                and torch.equal(_flood_bytemask(packed, comm), ref)):
            raise AssertionError(f"K3 flood_merge (n={N}, w={w}): a kernel "
                                 "differs from the plain version")
        # a masked product: count the (receiver, sender) pairs this comm
        # graph holds, each a select + a min per target
        b, by = bound_ms(2 * nnz * w, 4 * N * w * 2 + N * N)
        ms, prev_ms = _ab_ms(lambda: ops.flood_merge(packed, comm),
                             lambda: _flood_bytemask(packed, comm), 50)
        out[f"flood_merge_w{w}"] = dict(
            max_abs_err=0.0, comm_nnz=nnz, bound_ms=b, bound_by=by, ms=ms,
            prev_ms=prev_ms,
            plain_ms=time_ms(lambda: ops.flood_merge_plain(packed, comm),
                             3))
    for name, v in out.items():
        emit({"phase": "kernel", "name": name, "kernel_ms": v["ms"],
              **{k: x for k, x in v.items() if k != "ms"}})

    edges = [_check_flood("w=37, formation comm",
                          packed[:, :37].contiguous(), comm)]
    empty = comm.clone()
    empty[0] = False
    edges.append(_check_flood("empty comm row, w=500",
                              packed[:, :N // 2].contiguous(), empty))
    for n, w in ((N, N // 2), (N + 1, N + 1), (N + 1, 37)):
        edges.append(_check_flood(
            "packed 0/SENTINEL/max planted, empty row, SENTINEL-only sender",
            *_flood_edge_case(n, w, seed + n + w, dev)))
    plain_multi = 2 * iters + 2
    edges.append(_check_sinkhorn("n=1001", _uniform_cost(N + 1, seed, dev),
                                 tau, iters, 1))
    edges.append(_check_sinkhorn("n=64", _uniform_cost(64, seed, dev), tau,
                                 iters, 1))
    pin = torch.zeros(N, N, dtype=torch.bool, device=dev)
    pin[torch.arange(0, N, 50, device=dev),
        torch.arange(7, N, 50, device=dev)] = True
    forbid = (torch.rand(N, N, generator=torch.Generator(device=dev)
                         .manual_seed(seed), device=dev) < 0.01) & ~pin
    # forbidden entries reach |plan| ~ 600, where one float32 step is 6e-5:
    # 5e-5 plus 2^-22 |plain| allows that last bit
    edges.append(_check_sinkhorn(
        "pin/forbid (faults.masking.apply_pin_forbid)",
        masking.apply_pin_forbid(cost, pin, forbid).contiguous(), tau,
        iters, 1, rtol=2.0**-22))
    edges.append(_check_sinkhorn("n=2500, past the stripe limit",
                                 _uniform_cost(2500, seed, dev), tau, iters,
                                 plain_multi))
    # K2: every edge against the plain version, with the launches it made
    ties = torch.zeros(N, N, device=dev)
    info = _check_rounding("all ties (zeros), n=1000: one commit per round",
                           ties)
    new = (lambda: ops.round_dominant(ties), K2_KERNELS)
    info["ms"], info["prev_ms"] = _ab_device_ms(
        new, (lambda: _round_single_block(ties), K2_PREV_KERNELS), 2)
    edges.append(info)
    for n in (1, 64, N + 1):
        edges.append(_check_rounding(
            f"n={n}, Sinkhorn plan",
            ops.sinkhorn_log_plain(_uniform_cost(n, seed + n, dev), tau,
                                   iters)))
    edges.append(_check_rounding("-inf rows, columns, entries; +-0.0 ties",
                                 _rounding_edge_plan(N, seed, dev)))
    edges.append(_check_rounding(
        "pin/forbid plan (faults.masking.apply_pin_forbid)",
        ops.sinkhorn_log(masking.apply_pin_forbid(cost, pin, forbid)
                         .contiguous(), tau, iters)))
    edges.append(_check_rounding("max_rounds=3, main plan", plan, 3))
    big = torch.randn(14000, 14000, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    edges.append(_check_rounding(
        "n=14000 normal plan, past the single block's limit", big))
    del big
    for e in edges:
        emit({"phase": "edge", **e})
    return out


def _gains_kw(n: int, dev) -> dict:
    return dict(max_nonedges=n - 4, device=dev)


def _nonedge_blocks(flat: torch.Tensor, adj: np.ndarray) -> torch.Tensor:
    """The (3 x 3) blocks of ``flat`` at the graph's non-edges."""
    n = adj.shape[0]
    off = torch.as_tensor((adj == 0) & ~np.eye(n, dtype=bool),
                          device=flat.device)
    return flat.reshape(n, 3, n, 3).permute(0, 2, 1, 3)[off]


def _cusolver_problem(prob, points: np.ndarray):
    """``prob`` with both kernel bases from the card's SVD (cuSOLVER)
    instead of LAPACK's gesdd on the host."""
    p = torch.as_tensor(points, device=prob.q2.device)
    one, zero = torch.ones_like(p[:, 0]), torch.zeros_like(p[:, 0])
    N2 = torch.stack([p[:, :2].reshape(-1),
                      torch.stack([-p[:, 1], p[:, 0]], 1).reshape(-1),
                      torch.stack([one, zero], 1).reshape(-1),
                      torch.stack([zero, one], 1).reshape(-1)], 1)
    q2 = torch.linalg.svd(N2, full_matrices=True)[0][:, 4:]
    q1 = torch.linalg.svd(torch.stack([p[:, 2], one], 1),
                          full_matrices=True)[0][:, 2:]
    return prob._replace(q2=q2[None], q1=q1[None])


def _cusolver_distance(prob, A, points, params, seed: int) -> dict:
    """How far gains designed on cuSOLVER's kernel basis land from ``A``,
    the port's (gesdd's basis) for the same problem."""
    from aclswarm_torch.gains import admm

    cu = _cusolver_problem(prob, points)
    g_cu, _, it_cu, _ = admm.solve(cu, params)
    return {"seed": seed,
            "max_abs_q2_diff": (cu.q2 - prob.q2).abs().max().item(),
            "max_abs_q1_diff": (cu.q1 - prob.q1).abs().max().item(),
            "max_abs_gains_diff": (g_cu[0] - A).abs().max().item(),
            "iters": int(it_cu[0])}


def phase_gains(seed: int) -> dict:
    """The ADMM gain design (`aclswarm_torch.gains`), before the slices
    that fly its gains:

    - card against CPU at n=200, float64 (eigh) and float32 (Newton):
      gains within 1e-10 / 1e-4, ADMM iterations equal;
    - n=1000, float32, the main path's design (`design`) with the launch
      counters read around it: zero blocks exact at the non-edges, the
      trace within 1e-4 relative, `validate_gains(tol=2e-4)` and its
      seconds on the host; cold ms, ADMM and Newton steps per
      subproblem, host reads (the profiler's device-to-host copies),
      device time by kernel, peak memory; each subproblem's ms and the
      Gram pseudo-inverse's (Hermitian, and the SVD-based form beside
      it); the warm start into the group's second formation and into the
      same formation; and, printed as a finding and not checked, how far
      gains designed on cuSOLVER's kernel basis land from the port's.
    """
    from aclswarm_torch import gains, ops
    from aclswarm_torch.gains import admm

    dev = torch.device("cuda")
    params = gains.AdmmParams()
    n = 200
    (pts,), adj = _group(n, seed)
    gains.solve_gains(pts.astype(np.float32), adj, **_gains_kw(n, dev))
    for dtype, tol in (("float64", 1e-10), ("float32", 1e-4)):
        p = pts.astype(dtype)
        (card, st), ms = _sync_ms(lambda: gains.solve_gains(
            p, adj, telemetry=True, **_gains_kw(n, dev)))
        t0 = time.perf_counter()
        cpu, st_cpu = gains.solve_gains(p, adj, telemetry=True,
                                        **_gains_kw(n, "cpu"))
        info = {"phase": "gains", "check": f"card vs CPU, n={n}, {dtype}",
                "max_abs_diff": (card.cpu() - cpu).abs().max().item(),
                "tol": tol, "iters": st.iters, "iters_cpu": st_cpu.iters,
                "residual": st.residual, "residual_cpu": st_cpu.residual,
                "ms": ms, "cpu_ms": (time.perf_counter() - t0) * 1e3}
        emit(info)
        if not (info["max_abs_diff"] <= tol and st.iters == st_cpu.iters):
            raise AssertionError(f"gains: card and CPU disagree: {info}")

    (pa, pb), adj = _group(N, seed, k=2)
    pa, pb = pa.astype(np.float32), pb.astype(np.float32)
    kw = _gains_kw(N, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    A, first_ms = _sync_ms(lambda: design(N, seed))      # the main path's
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    v = gains.validate_gains(A.double(), pa.astype(np.float64), tol=2e-4)
    validate_s = time.perf_counter() - t0
    trace = torch.trace(A.double()).item()
    zero_exact = bool((_nonedge_blocks(A, adj) == 0).all())

    prob = admm.problem(pa[None], adj[None], gains.planar_of(pa), N - 4, dev)
    rec = admm.new_record()
    (flat, _, iters, resid), rec_ms = _sync_ms(
        lambda: admm.solve(prob, params, rec=rec))
    cold_ms = [_sync_ms(lambda: gains.solve_gains(pa, adj, **kw))[1]
               for _ in range(2)]
    prof = _device_profile(lambda: gains.solve_gains(pa, adj, **kw), top=8)
    sub_ms = {}
    for d, q in ((2, prob.q2), (1, prob.q1)):
        sub_ms[f"{d}d"] = _sync_ms(lambda: admm._subproblem(
            q, prob.i_idx, prob.j_idx, prob.valid, d, params, None,
            admm.POLL_EVERY, admm.new_record()))[1]
        U, W, vmask = admm._rows(q, prob.i_idx, prob.j_idx, prob.valid, d)
        G = admm._gram(U, W, vmask, d)
        sub_ms[f"{d}d_gram_size"] = G.shape[-1]
        sub_ms[f"{d}d_gram_ms"] = _sync_ms(
            lambda: admm._gram(U, W, vmask, d))[1]
        sub_ms[f"{d}d_pinv_hermitian_ms"] = _sync_ms(
            lambda: torch.linalg.pinv(G, rtol=1e-12, hermitian=True))[1]
        sub_ms[f"{d}d_pinv_svd_ms"] = _sync_ms(
            lambda: torch.linalg.pinv(G, rtol=1e-12))[1]

    # warm starts: the group's next formation from this one's fixed point
    # (a dispatch), and this formation from its own (a re-dispatch)
    carry0 = gains.init_carry(N, gains.planar_of(pa), device=dev)
    (a_warm, carry_a), _ = _sync_ms(lambda: gains.solve_gains(
        pa, adj, carry=carry0, **kw))
    (_, st_b), b_cold_ms = _sync_ms(lambda: gains.solve_gains(
        pb, adj, telemetry=True, **kw))
    (gb, _, st_bw), b_warm_ms = _sync_ms(lambda: gains.solve_gains(
        pb, adj, carry=carry_a, telemetry=True, **kw))
    (_, _, st_aw), a_again_ms = _sync_ms(lambda: gains.solve_gains(
        pa, adj, carry=carry_a, telemetry=True, **kw))
    gb_cold = gains.solve_gains(pb, adj, **kw)

    # the cuSOLVER basis, a finding at three seeds: this formation's
    # design, then the seeds after it
    basis = [_cusolver_distance(prob, A, pa, params, seed)]
    for s in (seed + 1, seed + 2):
        (ps,), adj_s = _group(N, s)
        ps = ps.astype(np.float32)
        prob_s = admm.problem(ps[None], adj_s[None], gains.planar_of(ps),
                              N - 4, dev)
        basis.append(_cusolver_distance(
            prob_s, admm.solve(prob_s, params)[0][0], ps, params, s))
    for line in basis:
        emit({"phase": "gains", "check": "cuSOLVER kernel basis (finding, "
              "not checked)", **line})
    info = {"phase": "gains", "n": N, "dtype": "float32",
            "nonedges": int(prob.valid.sum()), "bucket": N - 4,
            "launches": launches, "first_ms": first_ms, "cold_ms": cold_ms,
            "recorded_ms": rec_ms, "admm_iters": int(iters[0]),
            "admm_steps_2d_1d": [int(s[0]) for s in rec["admm"]],
            "newton_steps_per_psd": [int(s[0]) for s in rec["newton_live"]],
            "newton_steps_run": rec["newton_run"],
            "flag_reads": rec["host_reads"], "poll_every": admm.POLL_EVERY,
            "residual": float(resid[0]),
            "same_as_entry_point": torch.equal(flat[0], A),
            "cold_carry_bitwise_cold": torch.equal(a_warm, A),
            **{k: x for k, x in prof.items()},
            "subproblem_ms": sub_ms,
            "peak_memory_bytes": peak, "memory_before_bytes": before,
            "zero_blocks_exact": zero_exact, "trace": trace,
            "trace_expected": -3.0 * (N - 2),
            "validate": {k: v[k] for k in ("no_positive", "kernel_ok",
                                           "strictly_negative_rest",
                                           "nullity")},
            "kernel_eigs": v["eigenvalues"][-6:].tolist(),
            "largest_rest_eig": float(v["eigenvalues"][-7]),
            "validate_seconds": validate_s,
            "warm_next_formation": {
                "cold_iters": st_b.iters, "cold_ms": b_cold_ms,
                "warm_iters": st_bw.iters, "warm_ms": b_warm_ms,
                "max_abs_diff_warm_vs_cold": (gb - gb_cold).abs().max()
                .item()},
            "warm_same_formation": {"iters": st_aw.iters,
                                    "ms": a_again_ms},
            "cusolver_basis": basis[0]}
    emit(info)
    if not (zero_exact and not any(launches.values())
            and abs(trace - info["trace_expected"]) <= 1e-4 * 3 * (N - 2)
            and v["no_positive"] and v["kernel_ok"]
            and v["strictly_negative_rest"] and info["same_as_entry_point"]
            and info["cold_carry_bitwise_cold"]
            and bool(torch.isfinite(A).all())):
        raise AssertionError(f"gains check failed at n={N}: {info}")
    return info


def _slice_cfg(**kw):
    from aclswarm_torch import sim
    return sim.SimConfig(**dict(ENGINE, **kw))


def phase_reference(seed: int) -> None:
    """The Sinkhorn slice and the CBAA slice at n=64 for 40 ticks, an
    auction every 10: the card (f32, CUDA kernels) against the CPU (f32,
    plain versions). Starts spaced wider than the avoidance shell so no
    vehicle is in another's range in 0.4 s: k-pruned avoidance's
    duplicate-sector coin flip (ROADMAP.md) would otherwise rest on the
    last bit of two math libraries."""
    from aclswarm_torch import sim

    n, ticks = 64, 40
    for label, engine in (("sinkhorn", ENGINE),
                          ("cbaa", dict(ENGINE_CBAA, cbaa_task_block=16))):
        cfg = sim.SimConfig(**dict(engine, assign_every=10))
        finals = {}
        for dev in ("cuda", "cpu"):
            formation, gains, sparams, state = problem(n, seed, dev,
                                                       torch.float32, 3.5)
            finals[dev], metrics = sim.rollout(state, formation, gains,
                                               sparams, cfg, ticks)
            finals[dev + "_auctions"] = int(metrics.auctioned.sum())
            finals[dev + "_valid"] = int(metrics.assign_valid.sum())
        torch.cuda.synchronize()
        dq = (finals["cuda"].swarm.q.cpu()
              - finals["cpu"].swarm.q).abs().max()
        same_v2f = torch.equal(finals["cuda"].v2f.cpu(), finals["cpu"].v2f)
        same_age = torch.equal(finals["cuda"].loc.age.cpu(),
                               finals["cpu"].loc.age)
        emit({"phase": "reference", "assignment": label, "n": n,
              "ticks": ticks, "auctions": finals["cuda_auctions"],
              "valid_ticks": finals["cuda_valid"],
              "max_abs_dq": dq.item(), "v2f_equal": same_v2f,
              "ages_equal": same_age})
        if not (dq.item() <= 1e-3 and same_v2f and same_age
                and finals["cuda_valid"] == finals["cpu_valid"]):
            raise AssertionError(f"the {label} slice on the card disagrees "
                                 "with the plain CPU run")


def phase_slice(seed: int, gains_kind: str = "admm") -> dict:
    """The slice's 240 ticks on designed gains (the main path) or on the
    random gains earlier runs flew (for the record)."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.core import perm as permutil

    dev = torch.device("cuda")
    formation, gains, sparams, state = problem(
        N, seed, dev, torch.float32, 2 * SUITE["init_radius"],
        gains=gains_kind)
    cfg = _slice_cfg()
    sim.rollout(state, formation, gains, sparams, cfg, 2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, metrics = sim.rollout(state, formation, gains, sparams, cfg,
                                 TICKS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    tensors = [final.swarm.q, final.swarm.vel, final.goal.pos, final.goal.vel,
               final.loc.est, metrics.q, metrics.distcmd_norm]
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    auctions = TICKS // cfg.assign_every + (TICKS % cfg.assign_every > 0)
    info = {"phase": "slice", "gains": gains_kind, "n": N, "ticks": TICKS,
            "dtype": "float32", "ms_per_tick": seconds / TICKS * 1e3,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "auctions": auctions,
            "reassigned_ticks": int(metrics.reassigned.sum()),
            "ca_active_vehicle_ticks": int(metrics.ca_active.sum()),
            "mean_distcmd_norm": metrics.distcmd_norm.mean().item(),
            "finite": finite, "v2f_valid": bool(permutil.is_valid(final.v2f)),
            "q_shape": list(final.swarm.q.shape)}
    emit(info)
    # one K1 (a persistent solve) and one K2 (a persistent rounding) per
    # auction; one K3 stripe per tick
    if not (finite and info["v2f_valid"]
            and final.swarm.q.shape == (N, 3)
            and launches["sinkhorn_log"] == auctions * K1_LAUNCHES_PER_SOLVE
            and launches["round_dominant"] == auctions * K2_LAUNCHES_PER_CALL
            and launches["flood_merge"] == TICKS):
        raise AssertionError(f"slice check failed: {info}")
    return info


# device kernel -> the wrapper that launches it (K1's multi-launch kernels
# run only past its stripe limit, K2's single-block kernel only when timed: not
# on this path)
_KERNEL_OF = {"sinkhorn_persistent_kernel": "sinkhorn_log",
              "row_lse_kernel": "sinkhorn_log", "col_lse_kernel":
              "sinkhorn_log", "neg_scale_kernel": "sinkhorn_log",
              "add_potentials_kernel": "sinkhorn_log",
              "round_persistent_kernel": "round_dominant",
              "round_dominant_kernel": "round_dominant",
              "flood_merge_kernel": "flood_merge"}


def _traced_window(run, ticks: int) -> tuple[dict, dict, dict]:
    """``run(ticks)`` under the profiler, device activity only, after one
    warm-up step that traces and drops its records, so CUPTI is already
    recording when the window opens; the launch counters are reset just
    before it. Returns the counters, the kernel events per wrapper or
    kernel name ([count, device ms]) and where missing K3 events fell."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from aclswarm_torch import ops

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        run(2)
        torch.cuda.synchronize()
        prof.step()
        ops.reset_launches()
        run(ticks)
        torch.cuda.synchronize()
        counted = dict(ops.LAUNCHES)
        prof.step()
    by_name: dict[str, list] = {}
    k3_starts = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ours = [v for k, v in _KERNEL_OF.items() if k + "(" in e.name]
            key = ours[0] if ours else e.name[:80]
            acc = by_name.setdefault(key, [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e3
            if key == "flood_merge":
                k3_starts.append(e.time_range.start)
    # K3 runs once per tick: a gap of g tick spacings inside the window
    # hides g - 1 events; the rest of the shortfall lies at its edges
    gaps = np.diff(np.sort(k3_starts)) if len(k3_starts) > 1 else []
    inside = (int(np.maximum(np.rint(gaps / np.median(gaps)) - 1, 0).sum())
              if len(gaps) else 0)
    missing = counted.get("flood_merge", 0) - len(k3_starts)
    return counted, by_name, {"k3_missing": missing, "k3_missing_inside":
                              min(inside, max(missing, 0))}


def phase_profile(seed: int, ms_per_tick: float,
                  gains_kind: str = "admm") -> None:
    """Where a tick's time goes: one auction period (120 ticks) of the
    slice under `torch.profiler`. Device time is summed from the kernel
    events; the idle share compares it with the untraced run's time per
    tick (the traced run's own host clock includes the profiler). Each
    port kernel's device events must number what its launch counter read
    over the same run. The profiler can lose activity records (runs have
    lost 4 and 5 of 120 K3 events), so a window that saw fewer events is
    traced again, up to three times in all; an event the counter did not
    count fails at once, and so does a shortfall in every attempt."""
    from aclswarm_torch import sim

    formation, gains, sparams, state = problem(
        N, seed, torch.device("cuda"), torch.float32,
        2 * SUITE["init_radius"], gains=gains_kind)
    cfg, ticks = _slice_cfg(), 120
    sim.rollout(state, formation, gains, sparams, cfg, 2)   # warm-up

    def run(k):
        sim.rollout(state, formation, gains, sparams, cfg, k)

    attempts = []
    for _ in range(3):
        counted, by_name, lost = _traced_window(run, ticks)
        traced = {k: by_name.get(k, [0])[0] for k in counted}
        attempts.append({"launches_counted": counted,
                         "launches_traced": traced, **lost})
        if any(traced[k] > counted[k] for k in counted):
            raise AssertionError(f"the profiler saw kernel events {traced} "
                                 f"that the launch counters {counted} missed")
        if traced == counted:
            break
    busy = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    emit({"phase": "profile", "gains": gains_kind, "ticks": ticks,
          "window": "ticks 0-119 "
          "(one auction)", "device_time_measured": busy > 0,
          "launches_counted": counted, "launches_traced": traced,
          "attempts": len(attempts),
          "short_attempts": attempts[:-1] if traced == counted else attempts,
          "device_busy_ms_per_tick": busy / ticks,
          "untraced_ms_per_tick": ms_per_tick,
          "idle_share": (1.0 - busy / ticks / ms_per_tick) if busy else None,
          "kernel_launches_per_tick": sum(v[0] for v in by_name.values())
          / ticks,
          "top": [{"name": k, "launches": v[0], "device_ms": v[1]}
                  for k, v in top]})
    if traced != counted or not all(counted.values()):
        raise AssertionError(f"launch counters {counted} disagree with the "
                             f"profiler's kernel events {traced} in each of "
                             f"{len(attempts)} traced runs: {attempts}")


def _sync_ms(fn):
    """``fn()`` and its host-clock milliseconds, ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_profile(fn, top: int = 6) -> dict:
    """``fn()`` under the profiler, device activity only: the
    device-to-host copies (each read of a flag by the host is one), the
    kernel launches, the device's busy ms and the kernels that took most
    of it. A warm-up step of one small kernel, traced and dropped, has
    CUPTI recording before ``fn`` starts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    reads, by_name = 0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if "Memcpy DtoH" in e.name:
            reads += 1
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            acc = by_name.setdefault(e.name[:80], [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"host_reads": reads,
            "kernel_launches": sum(v[0] for v in by_name.values()),
            "device_busy_ms": sum(v[1] for v in by_name.values()),
            "top": [{"name": k, "launches": v[0], "device_ms": v[1]}
                    for k, v in ranked]}


def _auction_reads(iters: int, max_rounds: int, poll_every: int) -> int:
    """Host reads of one `auction_lap`: it polls after every
    ``poll_every``-th step, the step after the last live round raises the
    flag, and no more than ``max_rounds + 1`` steps run."""
    return min(-(-(iters + 1) // poll_every), (max_rounds + 1) // poll_every)


def _same_auction(card, cpu) -> dict:
    return {"row_to_col_equal": torch.equal(card.row_to_col.cpu(),
                                            cpu.row_to_col),
            "iters": int(card.iters), "iters_cpu": int(cpu.iters),
            "valid": bool(card.valid), "valid_cpu": bool(cpu.valid),
            "prices_equal": torch.equal(card.prices.cpu(), cpu.prices)}


def _auction_agrees(info: dict) -> bool:
    return (info["row_to_col_equal"] and info["prices_equal"]
            and info["iters"] == info["iters_cpu"]
            and info["valid"] == info["valid_cpu"])


def phase_auction(seed: int) -> None:
    """The auction LAP at n=1000, float32, on the slice's own start and
    formation. The benefit matrix is computed once on the card and copied:
    two math libraries' distances may differ in the last bit."""
    from aclswarm_torch.assignment import auction, sinkhorn
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil

    dev = torch.device("cuda")
    formation, _, _, state = problem(N, seed, dev, torch.float32,
                                     2 * SUITE["init_radius"])
    q = state.swarm.q
    p_al = geometry.align(formation.points,
                          permutil.veh_to_formation_order(q, state.v2f))
    cost = geometry.cdist(q, p_al)
    benefit = -cost
    auction.auction_lap(benefit, max_rounds=64)              # warm-up
    card, ms = _sync_ms(lambda: auction.auction_lap(benefit))
    # the profiler holds every kernel event of its window, so it watches a
    # solve cut at 1000 rounds; the full solve's reads follow the same rule
    cut = 1000
    expected = _auction_reads(cut, cut, auction.POLL_EVERY)
    # the profiler can lose activity records (see phase_profile): a window
    # that saw fewer reads is traced again, up to three times in all
    for _ in range(3):
        prof = _device_profile(lambda: auction.auction_lap(benefit,
                                                           max_rounds=cut))
        if prof["host_reads"] >= expected:
            break
    t0 = time.perf_counter()
    cpu = auction.auction_lap(benefit.cpu())
    cpu_s = time.perf_counter() - t0
    # scaling phases of a solve that runs to its end
    eps = max(float(benefit.abs().max()), 1.0) / 2.0
    phases = 1
    while eps > 1e-4:
        eps, phases = max(eps / 5.0, 1e-4), phases + 1
    rows = torch.arange(N, device=dev)
    sk = sinkhorn.sinkhorn_assign(q, p_al).row_to_col
    iters = int(card.iters)
    info = {"phase": "auction", "n": N, "dtype": "float32",
            **_same_auction(card, cpu), "max_rounds": 10000,
            "phases_to_eps_min": phases, "poll_every": auction.POLL_EVERY,
            "host_reads": _auction_reads(iters, 10000, auction.POLL_EVERY),
            "ms": ms, "ms_per_round": ms / max(iters, 1),
            "cpu_seconds": cpu_s,
            "first_1000_rounds": {
                **prof, "device_busy_ms_per_round": prof["device_busy_ms"]
                / cut, "launches_per_round": prof["kernel_launches"] / cut},
            "sinkhorn_total_cost": cost[rows, sk.long()].sum().item()}
    if info["valid"]:
        info["total_cost"] = cost[rows, card.row_to_col.long()].sum().item()
    emit(info)
    if not (_auction_agrees(info) and prof["host_reads"] == expected
            and (not info["valid"]
                 or bool(permutil.is_valid(card.row_to_col)))):
        raise AssertionError(f"auction check failed: {info} (host reads "
                             f"expected in the cut solve: {expected})")

    # ties: integer benefits, many equal bids for one object, so each
    # first-hit argmax (over objects, over bidders) decides
    n = 257
    g = torch.Generator(device=dev).manual_seed(seed)
    ties = torch.randint(0, 4, (n, n), generator=g, device=dev).float()
    info = {"phase": "auction", "check": f"integer ties, n={n}",
            **_same_auction(auction.auction_lap(ties),
                            auction.auction_lap(ties.cpu()))}
    emit(info)
    if not (_auction_agrees(info) and info["valid"]):
        raise AssertionError(f"auction tie check failed: {info}")


def _flooded_inputs(seed: int, dev, ticks: int = 6):
    """q, est and v2f as a CBAA auction finds them: the slice's start after
    a few hold-mode ticks, so the estimate table holds flooded, slightly
    stale positions."""
    from aclswarm_torch import sim

    formation, gains, sparams, state = problem(
        N, seed, dev, torch.float32, 2 * SUITE["init_radius"],
        keepout_repulse_vel=KEEPOUT_REPULSE_VEL)
    cfg = sim.SimConfig(**dict(ENGINE_CBAA, assignment="none"))
    state, _ = sim.rollout(state, formation, gains, sparams, cfg, ticks)
    return formation, state.swarm.q, state.loc.est, state.v2f


def _same_cbaa(card, cpu) -> dict:
    out = {k + "_equal": torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
           for k in ("v2f", "f2v", "who")}
    out.update(rounds=int(card.rounds), rounds_cpu=int(cpu.rounds),
               valid=bool(card.valid), valid_cpu=bool(cpu.valid),
               price_max_rel_diff=((card.price.cpu() - cpu.price).abs()
                                   / cpu.price.abs().clamp(min=1e-30))
               .max().item())
    return out


def _cbaa_agrees(info: dict) -> bool:
    return (info["v2f_equal"] and info["f2v_equal"] and info["who_equal"]
            and info["rounds"] == info["rounds_cpu"]
            and info["valid"] == info["valid_cpu"])


def phase_cbaa(seed: int) -> None:
    """CBAA at n=1000, float32, `task_block=64`, estimates from a flooded
    table: a cold auction and one seeded with its tables, each on the card
    against the CPU from the same q, est and v2f; then the cold auction
    card against CPU at seeds ``seed`` + 1 and + 2, one line each (a
    near-tie within the alignments' ~1e-6 would flip a winner at one seed
    and not another)."""
    from aclswarm_torch.assignment import cbaa
    from aclswarm_torch.core import geometry

    dev = torch.device("cuda")
    formation, q, est, v2f = _flooded_inputs(seed, dev)
    pts, adj = formation.points, formation.adjmat
    block = ENGINE_CBAA["cbaa_task_block"]

    def run(warm=None, on=dev):
        tab = None if warm is None else cbaa.CbaaTables(
            price=warm.price.to(on), who=warm.who.to(on))
        return cbaa.cbaa_from_state(q.to(on), pts.to(on), adj.to(on),
                                    v2f.to(on), est=est.to(on),
                                    task_block=block, warm=tab)

    cbaa.cbaa_from_state(q, pts, adj, v2f, est=est, task_block=block,
                         n_iters=2)                          # warm-up
    align_ms = time_ms(lambda: geometry.align_formation_local(
        q, pts, adj, v2f, est=est), 5)
    torch.cuda.reset_peak_memory_stats()
    cold, cold_ms = _sync_ms(run)
    peak = torch.cuda.max_memory_allocated()
    cold_prof = _device_profile(run)
    cold_cpu = run(on="cpu")
    carried = cbaa.CbaaTables(price=cold.price, who=cold.who)
    warm, warm_ms = _sync_ms(lambda: run(carried))
    warm_cpu = run(cbaa.CbaaTables(price=cold_cpu.price, who=cold_cpu.who),
                   on="cpu")
    # the card's and the CPU's alignments come from two SVD libraries
    al = geometry.align_formation_local(q, pts, adj, v2f, est=est)
    al_cpu = geometry.align_formation_local(q.cpu(), pts.cpu(), adj.cpu(),
                                            v2f.cpu(), est=est.cpu())
    for label, card, cpu, ms in (("cold", cold, cold_cpu, cold_ms),
                                 ("warm", warm, warm_cpu, warm_ms)):
        info = {"phase": "cbaa", "auction": label, "seed": seed, "n": N,
                "dtype": "float32", "task_block": block,
                **_same_cbaa(card, cpu), "poll_every": cbaa.POLL_EVERY,
                "ms": ms, "ms_per_round": (ms - align_ms)
                / max(int(card.rounds), 1), "align_ms": align_ms}
        if label == "cold":
            info.update(**cold_prof, peak_memory_bytes=peak,
                        align_max_abs_diff=(al.cpu() - al_cpu).abs().max()
                        .item())
        emit(info)
        if not _cbaa_agrees(info):
            raise AssertionError(f"cbaa check failed: {info}")
    # float32 sums of up to n weighted positions in two orders: the two
    # alignments may differ by ~1e-4 m on a 130 m formation
    if not (bool(cold.valid) and bool(warm.valid)
            and (al.cpu() - al_cpu).abs().max().item() <= 1e-2):
        raise AssertionError("cbaa: an auction at n=1000 was invalid, or "
                             "the card's alignment is off the CPU's")

    for s in (seed + 1, seed + 2):
        formation, q, est, v2f = _flooded_inputs(s, dev)
        args = (formation.points, formation.adjmat, v2f)
        card, ms = _sync_ms(lambda: cbaa.cbaa_from_state(
            q, *args, est=est, task_block=block))
        cpu = cbaa.cbaa_from_state(q.cpu(), *(a.cpu() for a in args),
                                   est=est.cpu(), task_block=block)
        info = {"phase": "cbaa", "auction": "cold", "seed": s, "n": N,
                **_same_cbaa(card, cpu), "ms": ms}
        emit(info)
        if not _cbaa_agrees(info):
            raise AssertionError(f"cbaa check failed at seed {s}: {info}")

    # dense against blocked on the card, bit for bit
    n = 64
    formation, _, _, state = problem(n, seed, dev, torch.float32, 3.5)
    args = (state.swarm.q, formation.points, formation.adjmat, state.v2f)
    dense = cbaa.cbaa_from_state(*args)
    blocked = cbaa.cbaa_from_state(*args, task_block=16)
    same = all(torch.equal(a, b) for a, b in zip(dense, blocked))
    emit({"phase": "cbaa", "check": "n=64 dense vs task_block=16",
          "bit_identical": same, "rounds": int(dense.rounds),
          "valid": bool(dense.valid)})
    if not same:
        raise AssertionError("cbaa: task_block=16 differs from dense")


def _cbaa_tick_inputs(state, formation, cfg):
    """What `step` hands the CBAA auction at ``state``'s tick: positions,
    the estimate table after this tick's flood, the assignment."""
    from aclswarm_torch.sim import localization as loclib

    loc = loclib.tick_phased(state.loc, state.swarm.q, formation.adjmat,
                             state.v2f, state.tick, cfg.flood_every,
                             cfg.flood_phases, target_block=cfg.flood_block)
    return state.swarm.q, loc.est, state.v2f


def _rollout_in_pieces(state, formation, gains, sparams, cfg) -> dict:
    """121 ticks as tick 0 (auction), ticks 1-119, tick 120 (auction), each
    piece ended by a synchronize: the final state, the ms of each auction
    tick, the ms per tick of the others, the stacked `assign_valid` and
    `auctioned`, and the state before each auction tick."""
    from aclswarm_torch import sim

    out = {"auction_tick_ms": [], "befores": []}
    valid, auctioned = [], []
    for ticks in (1, TICKS_AUCTIONS - 2, 1):
        before = state
        (state, m), ms = _sync_ms(lambda: sim.rollout(
            before, formation, gains, sparams, cfg, ticks))
        valid.append(m.assign_valid)
        auctioned.append(m.auctioned)
        if ticks == 1:
            out["auction_tick_ms"].append(ms)
            out["befores"].append(before)
        else:
            out["other_ms_per_tick"] = ms / ticks
    out.update(final=state, valid=torch.cat(valid),
               auctioned=torch.cat(auctioned))
    return out


def phase_slice_cbaa(seed: int) -> dict:
    """The suite's `simform1000_cbaa_flooded` row at full width: n=1000,
    CBAA in task blocks of 64 on flooded estimates, cold auctions (the
    trial harness carries no warm tables), 121 ticks."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.assignment import cbaa
    from aclswarm_torch.core import perm as permutil

    dev = torch.device("cuda")
    formation, gains, sparams, state = problem(
        N, seed, dev, torch.float32, 2 * SUITE["init_radius"],
        keepout_repulse_vel=KEEPOUT_REPULSE_VEL)
    cfg = sim.SimConfig(**ENGINE_CBAA)

    def auction_at(before, on):
        q, est, v2f = _cbaa_tick_inputs(before, formation, cfg)
        return cbaa.cbaa_from_state(
            q.to(on), formation.points.to(on), formation.adjmat.to(on),
            v2f.to(on), est=est.to(on), task_block=cfg.cbaa_task_block)

    sim.rollout(state, formation, gains, sparams,
                sim.SimConfig(**dict(ENGINE_CBAA, assignment="none")), 2)
    torch.cuda.synchronize()                                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = _rollout_in_pieces(state, formation, gains, sparams, cfg)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    final = run["final"]

    # outside the counted run: each auction once more for its round count,
    # and an invalid one against the CPU on the same inputs
    rounds = []
    for before, ok in zip(run["befores"],
                          run["valid"][run["auctioned"]].tolist()):
        again = auction_at(before, dev)
        rounds.append(int(again.rounds))
        if not ok:
            same = _same_cbaa(again, auction_at(before, "cpu"))
            emit({"phase": "slice_cbaa",
                  "invalid_auction_at_tick": before.tick, **same})
            if not _cbaa_agrees(same):
                raise AssertionError("slice_cbaa: an invalid auction on the "
                                     f"card differs from the CPU's: {same}")

    tensors = [final.swarm.q, final.swarm.vel, final.goal.pos, final.goal.vel,
               final.loc.est]
    finite = all(bool(torch.isfinite(t).all()) for t in tensors)
    info = {"phase": "slice_cbaa", "n": N, "ticks": TICKS_AUCTIONS,
            "dtype": "float32", "auction_tick_ms": run["auction_tick_ms"],
            "other_ms_per_tick": run["other_ms_per_tick"],
            "max_memory_allocated_bytes": peak, "launches": launches,
            "auctions": int(run["auctioned"].sum()),
            "valid_auctions": int((run["valid"] & run["auctioned"]).sum()),
            "rounds_per_auction": rounds, "finite": finite,
            "v2f_valid": bool(permutil.is_valid(final.v2f)),
            "cbaa_warm": final.cbaa_warm is not None}
    emit(info)
    if not (finite and info["v2f_valid"] and info["auctions"] == 2
            and final.swarm.q.shape == (N, 3)
            and launches["flood_merge"] == TICKS_AUCTIONS
            and launches["sinkhorn_log"] == 0
            and launches["round_dominant"] == 0):
        raise AssertionError(f"slice_cbaa check failed: {info}")
    return info


def phase_slice_auction(seed: int) -> dict:
    """The same start under the engine's default assignment, and the
    default `SimConfig()` at n=6 on the card against the CPU."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.assignment import auction
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.core import types

    dev = torch.device("cuda")
    formation, gains, sparams, state = problem(
        N, seed, dev, torch.float32, 2 * SUITE["init_radius"],
        localization=False)
    cfg = sim.SimConfig(**ENGINE_AUCTION)

    sim.rollout(state, formation, gains, sparams,
                sim.SimConfig(**dict(ENGINE_AUCTION, assignment="none")), 2)
    torch.cuda.synchronize()                                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = _rollout_in_pieces(state, formation, gains, sparams, cfg)
    launches = dict(ops.LAUNCHES)
    final = run["final"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (final.swarm.q, final.swarm.vel, final.goal.pos))
    # an auction that ran out of rounds holds the assignment, as in the
    # reference; it must then equal the CPU's on the same benefit matrix
    iters = []
    for before, ok in zip(run["befores"],
                          run["valid"][run["auctioned"]].tolist()):
        p_al = geometry.align(formation.points, permutil.veh_to_formation_order(
            before.swarm.q, before.v2f))
        benefit = -geometry.cdist(before.swarm.q, p_al)
        again = auction.auction_lap(benefit)
        iters.append(int(again.iters))
        if not ok:
            same = _same_auction(again, auction.auction_lap(benefit.cpu()))
            emit({"phase": "slice_auction",
                  "invalid_auction_at_tick": before.tick, **same})
            if not _auction_agrees(same):
                raise AssertionError("slice_auction: an invalid auction on "
                                     f"the card differs from the CPU's: "
                                     f"{same}")
    info = {"phase": "slice_auction", "n": N, "ticks": TICKS_AUCTIONS,
            "dtype": "float32", "auction_tick_ms": run["auction_tick_ms"],
            "other_ms_per_tick": run["other_ms_per_tick"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "auctions": int(run["auctioned"].sum()),
            "valid_auctions": int((run["valid"] & run["auctioned"]).sum()),
            "rounds_per_auction": iters, "finite": finite,
            "v2f_valid": bool(permutil.is_valid(final.v2f))}
    emit(info)
    # no kernel of the port is on this path: ground truth, no flood, no
    # Sinkhorn
    if not (finite and info["v2f_valid"] and info["auctions"] == 2
            and not any(launches.values())):
        raise AssertionError(f"slice_auction check failed: {info}")

    # the default configuration, six vehicles on a pentagonal pyramid
    n, ticks = 6, 240
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    pts = np.concatenate([np.stack([2 * np.cos(ang), 2 * np.sin(ang),
                                    np.zeros(5)], 1), [[0.0, 0.0, 2.0]]])
    rng = np.random.default_rng(seed)
    gains_np = rng.normal(size=(n, n, 3, 3)) * 0.05
    q0 = rng.normal(size=(n, 3)) * 3.0 + [0.0, 0.0, 2.0]
    finals = {}
    for on in ("cuda", "cpu"):
        form = types.make_formation(pts, np.ones((n, n)) - np.eye(n),
                                    gains_np, device=on, dtype=torch.float32)
        sp = types.SafetyParams(bounds_min=(-20.0, -20.0, 0.0),
                                bounds_max=(20.0, 20.0, 10.0))
        st = sim.init_state(q0, device=on, dtype=torch.float32)
        finals[on], m = sim.rollout(st, form, types.ControlGains(), sp,
                                    sim.SimConfig(), ticks)
        finals[on + "_valid"] = int((m.assign_valid & m.auctioned).sum())
    dq = (finals["cuda"].swarm.q.cpu() - finals["cpu"].swarm.q).abs().max()
    same = torch.equal(finals["cuda"].v2f.cpu(), finals["cpu"].v2f)
    emit({"phase": "slice_auction", "check": "default SimConfig(), n=6, "
          "240 ticks, card vs CPU", "max_abs_dq": dq.item(),
          "v2f_equal": same, "valid_auctions": finals["cuda_valid"]})
    if not (dq.item() <= 1e-3 and same and finals["cuda_valid"] == 2
            and finals["cpu_valid"] == 2):
        raise AssertionError("the default configuration on the card "
                             "disagrees with the CPU run")
    return info


def _as_asked(out, kw):
    """A probe's telemetry solve returned as its caller asked: the stats
    dropped unless the caller wanted them too (a telemetered trial)."""
    if kw.get("telemetry"):
        return out
    return out[:-1] if len(out) > 2 else out[0]


class _TrialProbe:
    """Wraps the harness's `sim.rollout`, `gains.solve_gains` and
    `TrialFSM._next_state` for one trial (the harness itself is not
    touched): per chunk the synchronized rollout ms, the host ms until the
    next chunk starts, its configuration and its launch counts; the
    transitions; each dispatch's design (gains, ms, ADMM iterations); and,
    on the card, the profiler's device-to-host copies, kernel launches and
    device busy time over whole chosen chunks and over the dispatch (from
    the decision to the next chunk)."""

    def __init__(self, profile_chunks=(), cuda: bool = True):
        self.chunks, self.transitions, self.designs = [], [], []
        self.profile_chunks, self.cuda = set(profile_chunks), cuda
        self.final_state = self._last_end = self._prof = None
        self._prof_label = None
        self.windows: dict = {}       # profiled window -> device counts
        self.auctioned = 0
        self.profiler_seconds = 0.0   # opening and reading the profiler

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _start_profile(self, label):
        from torch.profiler import ProfilerActivity, profile

        self._stop_profile()
        t0 = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._prof_label = label
        self.profiler_seconds += time.perf_counter() - t0

    def _stop_profile(self):
        if self._prof is None:
            return
        self._sync()
        t0 = time.perf_counter()
        self._prof.stop()
        from torch.autograd import DeviceType

        events = [e for e in self._prof.events()
                  if e.device_type == DeviceType.CUDA]
        kernels = [e for e in events
                   if "Memcpy" not in e.name and "Memset" not in e.name]
        self.windows[self._prof_label] = {
            "host_reads": sum("Memcpy DtoH" in e.name for e in events),
            "kernel_launches": len(kernels),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in kernels) / 1e3}
        self._prof = self._prof_label = None
        self.profiler_seconds += time.perf_counter() - t0

    def install(self, stack):
        """Patch the three hooks for the life of ``stack`` (an ExitStack)."""
        from aclswarm_torch import gains, ops, sim
        from aclswarm_torch.harness import supervisor

        rollout, solve = sim.rollout, gains.solve_gains
        next_state = supervisor.TrialFSM._next_state
        probe = self

        def _rollout(state, formation, cgains, sparams, cfg, n_ticks,
                     inputs=None):
            probe._sync()
            start = time.perf_counter()
            if probe._last_end is not None:
                probe.chunks[-1]["host_ms"] = (start - probe._last_end) * 1e3
            probe._stop_profile()
            i = len(probe.chunks)
            if probe.cuda and i in probe.profile_chunks:
                probe._start_profile(i)
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            final, metrics = rollout(state, formation, cgains, sparams, cfg,
                                     n_ticks, inputs)
            probe._sync()
            t1 = time.perf_counter()
            auctions = 0 if cfg.assignment == "none" else sum(
                (state.tick + t) % cfg.assign_every == 0
                for t in range(n_ticks))
            probe.chunks.append({
                "chunk": i, "assignment": cfg.assignment,
                "tick0": state.tick, "ticks": n_ticks, "auctions": auctions,
                "ms": (t1 - t0) * 1e3, "profiled": probe._prof is not None,
                "launches": {k: ops.LAUNCHES[k] - before[k]
                             for k in before}})
            probe.auctioned = probe.auctioned + metrics.auctioned.sum()
            probe.final_state, probe._last_end = final, t1
            return final, metrics

        def _solve(points, adj, *args, **kw):
            probe._sync()
            t0 = time.perf_counter()
            out = solve(points, adj, *args, **dict(kw, telemetry=True))
            probe._sync()
            probe.designs.append({"ms": (time.perf_counter() - t0) * 1e3,
                                  "iters": out[-1].iters,
                                  "residual": out[-1].residual,
                                  "gains": out[0], "points": points,
                                  "adj": np.asarray(adj)})
            return _as_asked(out, kw)

        def _next_state(fsm, state, reset=True):
            probe.transitions.append((supervisor.NAMES[state],
                                      fsm.tick_count))
            if probe.cuda and state == \
                    supervisor.TrialState.WAITING_ON_ASSIGNMENT:
                probe._start_profile("dispatch")
            return next_state(fsm, state, reset)

        for mod, name, fn in ((sim, "rollout", _rollout),
                              (gains, "solve_gains", _solve),
                              (supervisor.TrialFSM, "_next_state",
                               _next_state)):
            original = getattr(mod, name)
            setattr(mod, name, fn)
            stack.callback(setattr, mod, name, original)
        stack.callback(self._stop_profile)


def _fly_trial(cfg, profile_chunks=()):
    """``run_trial(cfg, 0)`` under a `_TrialProbe`: (fsm, probe, wall s)."""
    from aclswarm_torch.harness import trials

    probe = _TrialProbe(profile_chunks, cuda=cfg.device == "cuda")
    with contextlib.ExitStack() as stack:
        probe.install(stack)
        t0 = time.perf_counter()
        fsm = trials.run_trial(cfg, 0)
        probe._sync()
        wall = time.perf_counter() - t0
    return fsm, probe, wall


def _mean(xs):
    return float(np.mean(xs)) if xs else None


def _row_digest(row) -> str:
    """A CSV row's digest (its n distances are too long to print)."""
    import hashlib

    return hashlib.sha256(np.asarray(row, np.float64).tobytes()).hexdigest()


def phase_trial(seed: int) -> dict:
    """The `simform1000_flooded` row flown as a trial through the port's
    `run_trial` on the card in float32, `trial_timeout` cut to
    `TRIAL_TIMEOUT_CUT`: takeoff, hover, one dispatch (ADMM on the card in
    the n-4 bucket, x 0.15) and the Sinkhorn auctions after it
    (`_check_trial`). Then `swarm6_3d` (seed 1, library gains, float32) on
    the card against the CPU: the same verdict and states, the transition
    ticks side by side."""
    from aclswarm_torch.harness import trials

    cfg = trials.TrialConfig(**TRIAL_ROW, seed=seed, trials=1,
                             verbose=False, device="cuda", dtype="float32")
    info = _check_trial(dataclasses.replace(
        cfg, trial_timeout=TRIAL_TIMEOUT_CUT))

    # a small trial, card against CPU: the same verdict and FSM states
    small = trials.TrialConfig(formation="swarm6_3d", seed=1, trials=1,
                               verbose=False, dtype="float32")
    runs = {}
    for dev in ("cuda", "cpu"):
        s_fsm, s_probe, s_wall = _fly_trial(
            dataclasses.replace(small, device=dev))
        runs[dev] = (s_fsm, s_probe.transitions, s_wall)
    (c_fsm, c_tr, c_wall), (h_fsm, h_tr, h_wall) = runs["cuda"], runs["cpu"]
    same_ticks = c_tr == h_tr
    emit({"phase": "trial", "check": "swarm6_3d seed 1 float32, card vs CPU",
          "verdict": trials.NAMES[c_fsm.state],
          "verdict_cpu": trials.NAMES[h_fsm.state],
          "transitions": [[s, t, th] for (s, t), (_, th) in zip(c_tr, h_tr)]
          if [s for s, _ in c_tr] == [s for s, _ in h_tr]
          else {"card": c_tr, "cpu": h_tr},
          "transition_ticks_equal": same_ticks,
          "times": c_fsm.times, "times_cpu": h_fsm.times,
          "wall_seconds": c_wall, "wall_seconds_cpu": h_wall})
    if not (c_fsm.state == h_fsm.state
            and [s for s, _ in c_tr] == [s for s, _ in h_tr]):
        raise AssertionError("trial: swarm6_3d on the card disagrees with "
                             f"the CPU: {c_tr} vs {h_tr}")
    return info


def _check_trial(cfg, profile_chunks=(6, 12)) -> dict:
    """Fly ``cfg`` (trial 0) and check it: the FSM's path through FLYING,
    the one dispatch's design (`validate_gains(tol=2e-4)`, zero blocks
    exact), K3 once per tick and K1 = K2 = the auctions after the
    dispatch (none before), a finite final state with `v2f` a permutation,
    and the device-to-host copies of the chunks in ``profile_chunks`` (a
    hover chunk and the second after the dispatch); prints ms per tick of
    the hover and the flying chunks, the FSM's host ms per chunk, the
    design's ms and iterations, wall against simulated seconds, peak
    memory and the transition ticks."""
    from aclswarm_torch import gains, ops
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.harness import trials

    cuda = cfg.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    fsm, probe, wall = _fly_trial(cfg, profile_chunks)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    chunks = probe.chunks
    hover = [c for c in chunks if c["assignment"] == "none"]
    fly = [c for c in chunks if c["assignment"] != "none"]
    ticks = sum(c["ticks"] for c in chunks)
    fly_ticks = sum(c["ticks"] for c in fly)
    auctions_expected = -(-fly_ticks // cfg.assign_every)
    auctioned = int(probe.auctioned)
    dispatched = [c["chunk"] for c in chunks if c["chunk"] and
                  c["tick0"] == 0]
    # timed chunks: not the first, none under the profiler; the host
    # gap of the chunk whose FSM decided the dispatch holds the design
    timed = [c for c in chunks[1:] if not c["profiled"]]
    host = [c["host_ms"] for c in timed
            if "host_ms" in c and c["chunk"] + 1 not in dispatched]

    (design,) = probe.designs if len(probe.designs) == 1 else (None,)
    if design is None:
        raise AssertionError(f"trial: {len(probe.designs)} gain designs, "
                             "expected exactly one dispatch")
    A, pts, adj = design["gains"], design["points"], design["adj"]
    t0 = time.perf_counter()
    v = gains.validate_gains(A.double(), np.asarray(pts, np.float64),
                             tol=2e-4)
    validate_s = time.perf_counter() - t0
    zero_exact = bool((_nonedge_blocks(A, adj) == 0).all())
    final = probe.final_state
    finite = all(bool(torch.isfinite(t).all()) for t in (
        final.swarm.q, final.swarm.vel, final.goal.pos, final.goal.vel,
        final.loc.est))
    states = [s for s, _ in probe.transitions]
    info = {
        "phase": "trial", "formation": cfg.formation, "n": fsm.n,
        "seed": cfg.seed, "dtype": cfg.dtype,
        "trial_timeout": cfg.trial_timeout,
        "verdict": trials.NAMES[fsm.state], "transitions": probe.transitions,
        "times": fsm.times, "csv_digest": _row_digest(fsm.csv_row(0)),
        "chunks": len(chunks), "ticks": ticks,
        "simulated_seconds": ticks * cfg.control_dt, "wall_seconds": wall,
        "profiler_seconds": probe.profiler_seconds,
        "wall_seconds_less_profiler": wall - probe.profiler_seconds,
        "hover_ms_per_tick": _mean([c["ms"] / c["ticks"] for c in timed
                                    if c["assignment"] == "none"]),
        "flying_ms_per_tick": _mean([c["ms"] / c["ticks"] for c in timed
                                     if c["assignment"] != "none"]),
        "fsm_host_ms_per_chunk": _mean(host),
        "chunk_ms": [round(c["ms"], 3) for c in chunks],
        "profiled_chunks": sorted(probe.profile_chunks),
        "dispatch_chunks": dispatched,
        "design_ms": design["ms"], "design_admm_iters": design["iters"],
        "design_residual": design["residual"],
        "validate": {k: v[k] for k in ("no_positive", "kernel_ok",
                                       "strictly_negative_rest")},
        "validate_seconds": validate_s, "zero_blocks_exact": zero_exact,
        "profiled": [dict(w, window=k) if k == "dispatch" else dict(
            w, window=f"chunk {k}", assignment=chunks[k]["assignment"],
            auctions=chunks[k]["auctions"],
            kernel_launches_per_tick=w["kernel_launches"] / chunks[k]["ticks"],
            device_busy_ms_per_tick=w["device_busy_ms"] / chunks[k]["ticks"])
            for k, w in probe.windows.items()],
        "launches": launches,
        "launches_hover": {k: sum(c["launches"][k] for c in hover)
                           for k in launches},
        "auctions_after_dispatch": auctioned,
        "auctions_expected": auctions_expected,
        "peak_memory_bytes": peak, "finite": finite,
        "v2f_valid": bool(permutil.is_valid(final.v2f))}
    emit(info)
    # two copies per chunk (`trials._host_signals`), plus the alignment's
    # per auction tick
    reads_ok = [w["host_reads"] <= CHUNK_READS
                + AUCTION_READS * chunks[k]["auctions"]
                for k, w in probe.windows.items() if k != "dispatch"]
    ok = (states[:4] == ["TAKING_OFF", "HOVERING", "WAITING_ON_ASSIGNMENT",
                         "FLYING"]
          and fsm.done and len(dispatched) == 1
          and v["no_positive"] and v["kernel_ok"]
          and v["strictly_negative_rest"] and zero_exact
          and auctioned == auctions_expected >= 2
          and finite and info["v2f_valid"])
    # the wrappers count kernel launches, and the profiler traces, only
    # on the card
    if cuda:
        ok = ok and (launches["flood_merge"] == ticks
                     and launches["sinkhorn_log"] == auctioned
                     and launches["round_dominant"] == auctioned
                     and not any(info["launches_hover"][k]
                                 for k in ("sinkhorn_log", "round_dominant"))
                     and len(reads_ok) == len(profile_chunks)
                     and all(reads_ok))
    if not ok:
        raise AssertionError(f"trial check failed: {info}")
    return info


def _auction_inputs(seed: int, dev):
    """The main path's first-auction cost (the normalized `cdist_fast` of
    the aligned formation) and the flood's comm graph, for one seed."""
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.sim import localization as loclib

    formation, _, _, state = problem(N, seed, dev, torch.float32,
                                     2 * SUITE["init_radius"])
    q = state.swarm.q
    p_al = geometry.align(formation.points,
                          permutil.veh_to_formation_order(q, state.v2f))
    raw = geometry.cdist_fast(q, p_al)
    return ((raw / (torch.mean(raw) + 1e-12)).contiguous(),
            loclib.comm_mask(formation.adjmat, state.v2f).contiguous())


def _batch_masses_err(plans):
    return max((torch.exp(torch.logsumexp(plans, dim=d)) - 1.0
                / plans.shape[-1]).abs().max().item() for d in (-1, -2))


def _check_batch(label, batched, singles, plain=None, atol=0.0):
    """A batched launch against its single launches (bit for bit) and its
    plain batched version (``atol``; 0 = bit for bit)."""
    same = all(torch.equal(x, y) for x, y in zip(batched, singles))
    err = 0.0 if plain is None else max(
        (x.double() - y.double()).abs().max().item()
        for x, y in zip(batched, plain))
    if not (same and err <= atol):
        raise AssertionError(f"batch_kernels {label}: batched launch equal "
                             f"to single launches {same}, max |batched - "
                             f"plain| {err} (limit {atol})")
    return err


def phase_batch_kernels(seed: int) -> dict:
    """Each kernel's batched launch at B=5, n=1000 on the main path's
    inputs of five seeds, against the five single launches (bit for bit)
    and its plain batched version; launches, ms for the batch against the
    singles' ms, and the bound for five problems. Then B=1 and B=3 at
    n=1001."""
    from aclswarm_torch import ops
    from aclswarm_torch.ops import rounding

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inputs = [_auction_inputs(s, dev) for s in range(seed, seed + BATCH)]
    cost = torch.stack([c for c, _ in inputs])
    comm = torch.stack([m for _, m in inputs])
    tau, iters = 0.03, SINKHORN_ITERS
    out = {}

    # K1: residency waves of cooperative launches
    singles = [ops.sinkhorn_log(c, tau, iters) for c in cost]
    plans, launches = _counted("sinkhorn_log",
                               lambda: ops.sinkhorn_log(cost, tau, iters))
    plain = ops.sinkhorn_log_plain(cost, tau, iters)
    err = _check_batch("K1 B=5", plans, singles, plain, 5e-5)
    marg = _batch_masses_err(plans)
    waves = K1_WAVES[BATCH] if sms == 132 else None
    if marg > 1e-4 or (waves is not None and launches != waves):
        raise AssertionError(f"batch_kernels K1: marginal error {marg}, "
                             f"launches {launches} (expected {waves})")
    b, by = bound_ms(BATCH * (10 * N * N * iters + 2 * N * N),
                     BATCH * 8 * N * N)
    ms = time_ms(lambda: ops.sinkhorn_log(cost, tau, iters), 10)
    singles_ms = time_ms(lambda: [ops.sinkhorn_log(c, tau, iters)
                                  for c in cost], 10)
    out["sinkhorn_log"] = dict(batch=BATCH, launches=launches,
                               max_abs_err=err, marginal_err=marg, ms=ms,
                               singles_ms=singles_ms, bound_ms=b, bound_by=by,
                               sms=sms)

    # K2: the SMs split among the plans, one launch
    singles = [ops.round_dominant(p) for p in plans]
    (perm, rnds), launches = _counted("round_dominant",
                                      lambda: ops.round_dominant(plans))
    perm_ref, rnds_ref = ops.round_dominant_plain(plans)
    perm_prev, rnds_prev = _round_single_block(plans)
    _check_batch("K2 B=5 permutations", perm, [s[0] for s in singles],
                 perm_ref)
    _check_batch("K2 B=5 rounds", rnds, [s[1] for s in singles], rnds_ref)
    _check_batch("K2 B=5 single-block design", perm_prev, perm_ref)
    if launches != 1 or not torch.equal(rnds_prev, rnds_ref):
        raise AssertionError(f"batch_kernels K2: launches {launches}, "
                             "single-block rounds differ")
    scratch = rounding.launch(plans, None)[2]
    entries = sum(2 * N * N + rounding.rescans(scratch[k], N)["entries"]
                  for k in range(BATCH))
    b, by = bound_ms(2 * entries, BATCH * (4 * N * N + 4 * N))
    ms = device_ms(lambda: ops.round_dominant(plans), 20, K2_KERNELS)
    singles_ms = device_ms(lambda: [ops.round_dominant(p) for p in plans],
                           20, K2_KERNELS, per_call=BATCH)
    out["round_dominant"] = dict(
        batch=BATCH, launches=launches, rounds=rnds.tolist(), ms=ms,
        singles_ms=singles_ms, bound_ms=b, bound_by=by,
        # ~1.6 ms of device work a call: CUDA events time it well
        single_block_grid_ms=time_ms(lambda: _round_single_block(plans),
                                     5),
        call_ms=time_ms(lambda: ops.round_dominant(plans), 20),
        timing="device time (profiler)")

    # K3: the trial axis on grid z, full width and the phased stripe
    rng = np.random.default_rng(seed)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    age = torch.tensor(rng.integers(0, 200, (BATCH, N, N)), dtype=torch.int32,
                       device=dev)
    nnz = int(comm.sum())
    for w in (N, N // 2):
        packed = ((age[:, :, :w] << 16) | ids[:, None]).contiguous()
        singles = [ops.flood_merge(pk, cm) for pk, cm in zip(packed, comm)]
        merged, launches = _counted("flood_merge",
                                    lambda: ops.flood_merge(packed, comm))
        _check_batch(f"K3 B=5 w={w}", merged, singles,
                     ops.flood_merge_plain(packed, comm, block=100))
        _check_batch(f"K3 B=5 w={w} byte-mask design",
                     _flood_bytemask(packed, comm), singles)
        if launches != 1:
            raise AssertionError(f"batch_kernels K3: {launches} launches")
        b, by = bound_ms(2 * nnz * w, BATCH * (4 * N * w * 2 + N * N))
        out[f"flood_merge_w{w}"] = dict(
            batch=BATCH, launches=launches, comm_nnz=nnz, bound_ms=b,
            bound_by=by, ms=time_ms(lambda: ops.flood_merge(packed, comm),
                                    50),
            singles_ms=time_ms(lambda: [ops.flood_merge(pk, cm) for pk, cm
                                        in zip(packed, comm)], 50))
    for name, v in out.items():
        emit({"phase": "batch_kernel", "name": name, **v})

    # edges: one problem through the batched entry, three at n=1001
    edges = []
    for B, n in ((1, N), (3, N + 1)):
        c = torch.stack([_uniform_cost(n, seed + k, dev) for k in range(B)])
        p1, l1 = _counted("sinkhorn_log", lambda: ops.sinkhorn_log(c))
        e1 = _check_batch(f"K1 B={B} n={n}", p1, [ops.sinkhorn_log(x)
                                                  for x in c],
                          ops.sinkhorn_log_plain(c), 5e-5)
        (pp, rr), l2 = _counted("round_dominant",
                                lambda: ops.round_dominant(p1))
        pr, rr_ref = ops.round_dominant_plain(p1)
        _check_batch(f"K2 B={B} n={n}", pp, [ops.round_dominant(x)[0]
                                             for x in p1], pr)
        _check_batch(f"K2 B={B} n={n} rounds", rr, rr_ref)
        pk = torch.randint(0, 2**30, (B, n, 37), device=dev,
                           dtype=torch.int32)
        cm = torch.rand(B, n, n, device=dev) < 0.3
        m3, l3 = _counted("flood_merge", lambda: ops.flood_merge(pk, cm))
        _check_batch(f"K3 B={B} n={n} w=37", m3, [ops.flood_merge(x, y) for
                                                  x, y in zip(pk, cm)],
                     ops.flood_merge_plain(pk, cm))
        if (l1, l2, l3) != (1, 1, 1):
            raise AssertionError(f"batch_kernels B={B} n={n}: launches "
                                 f"{(l1, l2, l3)}, expected one each")
        edges.append({"phase": "batch_edge", "batch": B, "n": n,
                      "launches": [l1, l2, l3], "k1_max_abs_err": e1,
                      "k2_rounds": rr.tolist()})
    for e in edges:
        emit(e)
    return out


def phase_slice_batch(seed: int) -> dict:
    """Five `simform1000_flooded` airborne starts (seeds S..S+4, designed
    gains x 0.15) rolled 240 ticks by `sim.batched_rollout`, beside five
    serial `rollout`s of the same starts on the card."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.core import types

    dev = torch.device("cuda")
    probs = [problem(N, s, dev, torch.float32, 2 * SUITE["init_radius"])
             for s in range(seed, seed + BATCH)]
    gains, sparams = probs[0][1], probs[0][2]
    bform = types.stack([p[0] for p in probs])
    bstate = sim.stack_states([p[3] for p in probs])
    cfg = _slice_cfg()
    sim.batched_rollout(bstate, bform, gains, sparams, cfg, 2)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    final, metrics = sim.batched_rollout(bstate, bform, gains, sparams, cfg,
                                         TICKS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    serial = [sim.rollout(p[3], p[0], gains, sparams, cfg, TICKS)
              for p in probs]
    torch.cuda.synchronize()
    serial_seconds = time.perf_counter() - t0
    dq = max((m.q - metrics.q[:, b]).abs().max().item()
             for b, (_, m) in enumerate(serial))
    same_v2f = all(torch.equal(m.v2f, metrics.v2f[:, b])
                   for b, (_, m) in enumerate(serial))
    same_auc = all(torch.equal(m.auctioned, metrics.auctioned[:, b])
                   for b, (_, m) in enumerate(serial))

    def run(k):
        sim.batched_rollout(bstate, bform, gains, sparams, cfg, k)

    counted, by_name, lost = _traced_window(run, cfg.assign_every)
    busy = sum(v[1] for v in by_name.values())
    ms_per_tick = seconds / TICKS * 1e3
    auctions = TICKS // cfg.assign_every + (TICKS % cfg.assign_every > 0)
    finite = all(bool(torch.isfinite(t).all()) for t in (
        final.swarm.q, final.swarm.vel, final.loc.est, metrics.q))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    info = {"phase": "slice_batch", "batch": BATCH, "n": N, "ticks": TICKS,
            "dtype": "float32", "ms_per_batched_tick": ms_per_tick,
            "serial_ms_per_tick": serial_seconds / (BATCH * TICKS) * 1e3,
            "max_abs_dq_vs_serial": dq, "v2f_equal_serial": same_v2f,
            "auctioned_equal_serial": same_auc, "launches": launches,
            "auctions": auctions,
            "traced_window_ticks": cfg.assign_every,
            "launches_traced": {k: by_name.get(k, [0])[0] for k in counted},
            "kernel_launches_per_batched_tick":
                sum(v[0] for v in by_name.values()) / cfg.assign_every,
            "device_busy_ms_per_batched_tick": busy / cfg.assign_every,
            "idle_share": 1.0 - busy / cfg.assign_every / ms_per_tick,
            "k3_missing_in_trace": lost["k3_missing"],
            "top": [{"name": k, "launches": v[0], "device_ms": v[1]}
                    for k, v in top],
            "max_memory_allocated_bytes": peak, "finite": finite,
            "v2f_valid": bool(permutil.is_valid(final.v2f).all())}
    emit(info)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    k1 = auctions * K1_WAVES[BATCH] if sms == 132 else launches[
        "sinkhorn_log"]
    if not (same_v2f and same_auc and finite and info["v2f_valid"]
            and launches["flood_merge"] == TICKS
            and launches["round_dominant"] == auctions
            and launches["sinkhorn_log"] == k1
            and launches["sinkhorn_log"] < BATCH * auctions):
        raise AssertionError(f"slice_batch check failed: {info}")
    return info


class _WaveProbe:
    """Wraps the harness's `summary.batched_rollout_summary` and
    `summary.to_host`, `gains.solve_gains`, `SummaryTrialFSM._to` and
    `formation_dispatched`, and `trials.run_trial_batch` for one
    `run_trials` call (the harness itself is not touched): per chunk the
    batch size, the synchronized rollout ms and its launch counts; each
    trial's transitions and dispatch ticks; each design; and, over the
    chunks in ``profile_chunks``, the profiler's device-to-host copies,
    kernel launches and device busy time from the rollout's start to the
    end of its two host copies."""

    def __init__(self, profile_chunks=()):
        self.chunks, self.designs, self.waves = [], [], []
        self.transitions: dict = {}
        self.dispatches: dict = {}
        self.profile_chunks = set(profile_chunks)
        self.windows: dict = {}
        self.final_state = self._prof = None
        self.profiler_seconds = 0.0

    def _stop_profile(self):
        if self._prof is None:
            return
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.stop()
        events = [e for e in self._prof.events()
                  if e.device_type == DeviceType.CUDA]
        kernels = [e for e in events
                   if "Memcpy" not in e.name and "Memset" not in e.name]
        self.windows[len(self.chunks) - 1] = {
            "host_reads": sum("Memcpy DtoH" in e.name for e in events),
            "kernel_launches": len(kernels),
            "device_busy_ms": sum(e.time_range.elapsed_us()
                                  for e in kernels) / 1e3}
        self._prof = None
        self.profiler_seconds += time.perf_counter() - t0

    def install(self, stack):
        from torch.profiler import ProfilerActivity, profile

        from aclswarm_torch import gains, ops
        from aclswarm_torch.harness import supervisor, trials
        from aclswarm_torch.sim import summary

        run, to_host = summary.batched_rollout_summary, summary.to_host
        solve, batch = gains.solve_gains, trials.run_trial_batch
        to, dispatched = (supervisor.SummaryTrialFSM._to,
                          supervisor.SummaryTrialFSM.formation_dispatched)
        probe = self

        def _run(state, carry, formation, cgains, sparams, cfg, n_ticks,
                 *args, **kw):
            i = len(probe.chunks)
            torch.cuda.synchronize()
            if i in probe.profile_chunks:
                t0 = time.perf_counter()
                probe._prof = profile(activities=[ProfilerActivity.CUDA])
                probe._prof.start()
                probe.profiler_seconds += time.perf_counter() - t0
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            out = run(state, carry, formation, cgains, sparams, cfg,
                      n_ticks, *args, **kw)
            torch.cuda.synchronize()
            probe.chunks.append({
                "chunk": i, "batch": len(state.v2f), "ticks": n_ticks,
                "auctions": -(-n_ticks // cfg.assign_every),
                "ms": (time.perf_counter() - t0) * 1e3,
                "profiled": probe._prof is not None,
                "launches": {k: ops.LAUNCHES[k] - before[k]
                             for k in before}})
            probe.final_state = out[0]
            return out

        def _to_host(summ):
            out = to_host(summ)
            probe._stop_profile()
            return out

        def _solve(points, adj, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = solve(points, adj, *args, **dict(kw, telemetry=True))
            torch.cuda.synchronize()
            probe.designs.append({"ms": (time.perf_counter() - t0) * 1e3,
                                  "iters": out[-1].iters, "gains": out[0],
                                  "points": points, "adj": np.asarray(adj)})
            return _as_asked(out, kw)

        def _to(fsm, state, reset=True):
            probe.transitions.setdefault(id(fsm), []).append(
                (supervisor.NAMES[state], fsm.tick_count))
            return to(fsm, state, reset)

        def _dispatched(fsm):
            probe.dispatches.setdefault(id(fsm), []).append(fsm.tick_count)
            return dispatched(fsm)

        def _batch(cfg, idx):
            fsms = batch(cfg, idx)
            probe.waves.append((list(idx), fsms))
            return fsms

        for mod, name, fn in ((summary, "batched_rollout_summary", _run),
                              (summary, "to_host", _to_host),
                              (gains, "solve_gains", _solve),
                              (supervisor.SummaryTrialFSM, "_to", _to),
                              (supervisor.SummaryTrialFSM,
                               "formation_dispatched", _dispatched),
                              (trials, "run_trial_batch", _batch)):
            original = getattr(mod, name)
            setattr(mod, name, fn)
            stack.callback(setattr, mod, name, original)
        stack.callback(self._stop_profile)


def phase_trial_batch(seed: int, serial: dict | None,
                      slice_batch: dict | None) -> dict:
    """`run_trials` with batch=5, trials=5 on the card: the
    `simform1000_flooded` row at chunk_ticks 120, float32, seed S,
    `trial_timeout` cut to `TRIAL_TIMEOUT_CUT`. Then trial 0 flown alone
    through `run_trial` at the same chunking, beside the wave's trial 0
    and the `trial` phase's path."""
    import tempfile

    from aclswarm_torch import gains, ops
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.harness import trials

    row = dict(TRIAL_ROW, chunk_ticks=BATCH_CHUNK,
               trial_timeout=TRIAL_TIMEOUT_CUT)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = trials.TrialConfig(**row, seed=seed, trials=BATCH, batch=BATCH,
                                 verbose=False, device="cuda",
                                 dtype="float32", out=f"{tmp}/wave.csv")
        probe = _WaveProbe(profile_chunks=(4, 11))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with contextlib.ExitStack() as stack:
            probe.install(stack)
            t0 = time.perf_counter()
            stats = trials.run_trials(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        ((idx, fsms),) = probe.waves
        alone_fsm, alone_probe, alone_wall = _fly_trial(dataclasses.replace(
            cfg, trials=1, batch=1, out=f"{tmp}/alone.csv"))

    chunks = probe.chunks
    ticks = sum(c["ticks"] for c in chunks)
    trial_ticks = sum(c["ticks"] * c["batch"] for c in chunks)
    auction_ticks = sum(c["auctions"] for c in chunks)
    k1_expected = sum(c["auctions"] * K1_WAVES[c["batch"]] for c in chunks)
    compactions = [[a["chunk"], a["batch"], b["batch"]] for a, b in
                   zip(chunks, chunks[1:]) if b["batch"] != a["batch"]]
    paths = [probe.transitions.get(id(f), []) for f in fsms]
    dispatch_ticks = [probe.dispatches.get(id(f), []) for f in fsms]
    timed = [c for c in chunks[1:] if not c["profiled"]]
    design = probe.designs[0] if probe.designs else None
    if design is None:
        raise AssertionError("trial_batch: no gain design at a dispatch")
    A, pts, adj = design["gains"], design["points"], design["adj"]
    v = gains.validate_gains(A.double(), np.asarray(pts, np.float64),
                             tol=2e-4)
    zero_exact = bool((_nonedge_blocks(A, adj) == 0).all())
    final = probe.final_state
    finite = all(bool(torch.isfinite(t).all()) for t in (
        final.swarm.q, final.swarm.vel, final.goal.pos, final.loc.est))
    less_prof = wall - probe.profiler_seconds
    alone_path = alone_probe.transitions
    serial_path = None if serial is None else [
        tuple(t) for t in serial["transitions"]]
    info = {
        "phase": "trial_batch", "formation": cfg.formation, "n": N,
        "batch": BATCH, "trials": idx, "seed": seed, "dtype": cfg.dtype,
        "chunk_ticks": cfg.chunk_ticks, "trial_timeout": cfg.trial_timeout,
        "verdicts": [trials.NAMES[f.state] for f in fsms],
        "paths": paths, "dispatch_ticks": dispatch_ticks,
        "csv_digests": [_row_digest(f.csv_row(t)) for t, f in zip(idx, fsms)],
        "completed": stats["trials_completed"],
        "chunks": len(chunks), "ticks": ticks, "trial_ticks": trial_ticks,
        "compactions": compactions,
        "wall_seconds": wall, "profiler_seconds": probe.profiler_seconds,
        "wall_seconds_less_profiler": less_prof,
        "trial_seconds_per_wall_second":
            trial_ticks * cfg.control_dt / less_prof,
        "ms_per_batched_tick": _mean([c["ms"] / c["ticks"] for c in timed]),
        "chunk_ms": [round(c["ms"], 3) for c in chunks],
        "designs": len(probe.designs),
        "design_ms": [round(d["ms"], 1) for d in probe.designs],
        "design_admm_iters": [int(d["iters"]) for d in probe.designs],
        "validate_first": {k: v[k] for k in ("no_positive", "kernel_ok",
                                             "strictly_negative_rest")},
        "zero_blocks_exact": zero_exact,
        "profiled": [dict(w, chunk=k, batch=chunks[k]["batch"],
                          auctions=chunks[k]["auctions"],
                          kernel_launches_per_tick=w["kernel_launches"]
                          / chunks[k]["ticks"],
                          device_busy_ms_per_tick=w["device_busy_ms"]
                          / chunks[k]["ticks"])
                     for k, w in probe.windows.items()],
        "launches": launches, "auction_ticks": auction_ticks,
        "sinkhorn_log_expected": k1_expected,
        "peak_memory_bytes": peak, "finite": finite,
        "v2f_valid": bool(permutil.is_valid(final.v2f).all()),
        "trial0_path": paths[0], "alone_path": alone_path,
        "alone_chunk_ticks": cfg.chunk_ticks,
        "trial0_equals_alone": paths[0] == alone_path,
        "alone_wall_seconds": alone_wall,
        "serial_phase_path": serial_path,
        "trial0_equals_serial_phase": paths[0] == serial_path,
        "serial_phase_chunk_ticks": TRIAL_ROW["chunk_ticks"]}
    emit(info)
    reads_ok = [w["host_reads"] <= CHUNK_READS + AUCTION_READS
                * chunks[k]["auctions"] for k, w in probe.windows.items()]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = (all(f.done for f in fsms) and len(fsms) == BATCH
          and v["no_positive"] and v["kernel_ok"]
          and v["strictly_negative_rest"] and zero_exact
          and launches["flood_merge"] == ticks
          and launches["round_dominant"] == auction_ticks
          and (sms != 132 or launches["sinkhorn_log"] == k1_expected)
          and len(reads_ok) == len(probe.profile_chunks) and all(reads_ok)
          and finite and info["v2f_valid"])
    # trial 0 equals the same trial flown alone only if a batch reproduces
    # serial bits on the card
    if slice_batch is not None and slice_batch["max_abs_dq_vs_serial"] == 0:
        ok = ok and info["trial0_equals_alone"]
    if not ok:
        raise AssertionError(f"trial_batch check failed: {info}")
    return info


# the fault grid of benchmarks/faults_suite.py: (dropout, link loss) per
# trial row of one batched rollout; (0, 0) is the no-fault control row
FAULT_GRID = [(0.0, 0.0), (0.1, 0.0), (0.3, 0.0), (0.5, 0.0),
              (0.1, 0.3), (0.3, 0.3), (0.1, 0.6), (0.3, 0.6)]
# drops land between the auctions at ticks 0 and 120, rejoins between 120
# and 240: the tick-120 auction solves with dead vehicles
FAULT_TICKS, FAULT_DROP, FAULT_REJOIN = 360, 60, 180
FAULT_WINDOW = 100          # the supervisor window W: 1 s of ticks
SCENARIO_TICKS = 240        # the families' horizon and the rollout's length
# the profiled window of a faulted or scenario batch: ticks 120-159, one
# auction; at ~800-2,100 launches a tick a longer one costs the profiler
# more than the run
FAULT_TRACE_TICKS = 40
# the small card-against-CPU trial under wind, cut at 30 s: two
# formations flown, the wind on from tick 720 of each
SMALL_SCENARIO_TIMEOUT = 30.0
# the wave's scenario horizon: events land in the ~200 flying ticks
# before the `TRIAL_TIMEOUT_CUT` watchdog
WAVE_SCENARIO_HORIZON = 160


def _profile_call(fn, reps: int = 3) -> dict:
    """Kernel launches and device ms per call of ``fn``, from the
    profiler's kernel events over ``reps`` calls after one warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "Memcpy" not in e.name and "Memset" not in e.name]
    return {"launches_per_call": len(kernels) / reps,
            "device_ms_per_call": sum(e.time_range.elapsed_us()
                                      for e in kernels) / reps / 1e3}


def _batch_of(seed: int, B: int, **init_kw):
    """B copies of the slice's start (one formation, designed gains),
    trial ``b`` carrying ``init_kw[k][b]``: (bstate, bform, gains,
    sparams)."""
    from aclswarm_torch import sim
    from aclswarm_torch.core import types

    dev = torch.device("cuda")
    formation, gains, sparams, state = problem(N, seed, dev, torch.float32,
                                               2 * SUITE["init_radius"])
    states = [sim.init_state(state.swarm.q, flying=True, localization=True,
                             device=dev, dtype=torch.float32,
                             **{k: v[b] for k, v in init_kw.items()})
              for b in range(B)]
    return (sim.stack_states(states), types.stack([formation] * B), gains,
            sparams)


def _batched_traced(bstate, bform, gains, sparams, cfg, tick0: int,
                    ticks: int, ms_per_tick: float) -> dict:
    """Launches and device busy per batched tick over ``ticks`` ticks from
    ``bstate`` (at shared phase ``tick0``) under the profiler, beside the
    untraced ms per tick."""
    from aclswarm_torch import sim

    def run(k):
        sim.batched_rollout(bstate, bform, gains, sparams, cfg, k, None,
                            tick0)

    counted, by_name, lost = _traced_window(run, ticks)
    busy = sum(v[1] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"traced_window_ticks": ticks, "traced_from_tick": tick0,
            "launches_counted": counted,
            "launches_traced": {k: by_name.get(k, [0])[0] for k in counted},
            "kernel_launches_per_batched_tick":
                sum(v[0] for v in by_name.values()) / ticks,
            "device_busy_ms_per_batched_tick": busy / ticks,
            "idle_share": 1.0 - busy / ticks / ms_per_tick,
            "k3_missing_in_trace": lost["k3_missing"],
            "top": [{"name": k, "launches": v[0], "device_ms": v[1]}
                    for k, v in top]}


def _masked_auction_cost(state, formation, alive):
    """What `sinkhorn_assign` hands K1 at ``state``'s auction tick under
    the fault mask: the normalized `cdist_fast` of the aligned formation
    with pinned pairs 0 and forbidden ones `4 (max c + 1)`."""
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.faults import masking

    q, v2f = state.swarm.q, state.v2f
    p_al = geometry.align(formation.points,
                          permutil.veh_to_formation_order(q, v2f))
    raw = geometry.cdist_fast(q, p_al)
    pin, forbid = masking.pin_forbid(alive, v2f)
    return masking.apply_pin_forbid(raw / (torch.mean(raw) + 1e-12), pin,
                                    forbid).contiguous(), pin, forbid


def phase_faults(seed: int) -> dict:
    """The fault grid of `benchmarks/faults_suite.py` at n=1000: eight
    trials of the slice's start, each with its own `sample_schedule` (seed
    S*1000+i), flown as one `sim.batched_rollout` of 360 ticks on the
    `simform1000_flooded` engine, float32, designed gains; drops at tick
    60, rejoins at 180, auctions at 0, 120 and 240. K1, K2 and K3 against
    their plain versions on the tick-120 inputs the faults shape (the
    masked cost of the 0.5-dropout trial, the lossy dead-masked comm of
    the (0.3, 0.6) trial); the card's link masks against the CPU's; the
    dead frozen, pinned at the auction, every `v2f` a permutation; the
    recovery clock (`summary.summarize_chunk`, W=100); then, serially,
    `no_faults` against ``faults=None`` bit for bit over 240 ticks."""
    from aclswarm_torch import faults, ops, sim
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.core import types
    from aclswarm_torch.sim import localization as loclib
    from aclswarm_torch.sim import summary as sumlib
    from aclswarm_torch.sim.engine import StepMetrics

    dev, B = torch.device("cuda"), len(FAULT_GRID)
    scheds = [faults.sample_schedule(seed * 1000 + i, N, dropout_frac=df,
                                     drop_tick=FAULT_DROP,
                                     rejoin_tick=FAULT_REJOIN, link_loss=pl,
                                     device=dev, dtype=torch.float32)
              for i, (df, pl) in enumerate(FAULT_GRID)]
    bstate, bform, gains, sparams = _batch_of(seed, B, faults=scheds)
    cfg = _slice_cfg()
    sim.batched_rollout(bstate, bform, gains, sparams, cfg, 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    mid, m1 = sim.batched_rollout(bstate, bform, gains, sparams, cfg,
                                  cfg.assign_every)
    final, m2 = sim.batched_rollout(mid, bform, gains, sparams, cfg,
                                    FAULT_TICKS - cfg.assign_every, None,
                                    cfg.assign_every)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    metrics = StepMetrics(**{k: None if getattr(m1, k) is None else
                             torch.cat([getattr(m1, k), getattr(m2, k)])
                             for k in vars(m1)})
    ms_per_tick = seconds / FAULT_TICKS * 1e3

    # the recovery clock over the run, per trial
    batch_major = StepMetrics(**{k: None if v is None else v.movedim(0, 1)
                                 for k, v in vars(metrics).items()})
    summ, _ = sumlib.summarize_chunk(
        batch_major, sumlib.init_carry(N, FAULT_WINDOW, device=dev,
                                       batch=B), FAULT_WINDOW,
        float(sparams.takeoff_alt))
    rec = summ.recovery_ticks.cpu().numpy()
    chn = summ.fault_churn.cpu().numpy()
    recovery = [[[int(t), int(rec[b, t]), int(chn[b, t])]
                 for t in np.flatnonzero(rec[b] >= 0)] for b in range(B)]

    # the kernels on the inputs the faults shape, tick 120
    drop_b, lossy_b = FAULT_GRID.index((0.5, 0.0)), FAULT_GRID.index(
        (0.3, 0.6))
    t_auc = cfg.assign_every
    alive = faults.alive_at(scheds[drop_b], t_auc)
    cost, pin, forbid = _masked_auction_cost(sim.trial(mid, drop_b),
                                             types.row(bform, drop_b), alive)
    # forbidden entries reach |plan| ~ 10^3, where one float32 step is
    # 6e-5: 5e-5 plus 2^-22 |plain| allows that last bit (as `kernels`)
    k1 = _check_sinkhorn("faults: tick-120 masked cost, 0.5 dropout", cost,
                         0.03, SINKHORN_ITERS, K1_LAUNCHES_PER_SOLVE,
                         rtol=2.0**-22)
    k2 = _check_rounding("faults: tick-120 masked plan, 0.5 dropout",
                         ops.sinkhorn_log(cost, 0.03, SINKHORN_ITERS))
    lossy = sim.trial(mid, lossy_b)
    alive_l = faults.alive_at(scheds[lossy_b], t_auc)
    comm = loclib.comm_mask(bform.adjmat[lossy_b], lossy.v2f) \
        & faults.link_up_at(scheds[lossy_b], t_auc) \
        & alive_l[:, None] & alive_l[None, :]
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    age = torch.clamp(lossy.loc.age + 1, max=loclib.AGE_CAP)
    packed = ((age << 16) | ids[:, None])[:, :N // 2].contiguous()
    k3 = _check_flood("faults: tick-120 lossy dead-masked comm, (0.3, 0.6)",
                      packed, comm.contiguous())
    k3.update(comm_edges=int(comm.sum()), full_comm_edges=int(
        loclib.comm_mask(bform.adjmat[lossy_b], lossy.v2f).sum()))

    # the card's link draws against the CPU's, bit for bit
    links_equal = []
    for b in (FAULT_GRID.index((0.1, 0.3)), lossy_b):
        cpu = types.tree_map(lambda x: x.cpu(), scheds[b])
        for t in (0, t_auc, FAULT_TICKS - 1):
            links_equal.append(torch.equal(
                faults.link_up_at(scheds[b], t).cpu(),
                faults.link_up_at(cpu, t)))

    # the dead: frozen from drop to rejoin, pinned at the tick-120 auction
    alive_t, q, v2f = metrics.alive, metrics.q, metrics.v2f
    frozen, pinned, dead_counts = [], [], []
    for b in range(B):
        dead = ~alive_t[FAULT_DROP, b]
        dead_counts.append(int(dead.sum()))
        frozen.append(bool((q[FAULT_DROP:FAULT_REJOIN, b][:, dead]
                            == q[FAULT_DROP, b][dead]).all()))
        pinned.append(bool((v2f[t_auc, b][dead]
                            == v2f[t_auc - 1, b][dead]).all()))
    perms = bool(permutil.is_valid(v2f.reshape(-1, N)).all())
    finite = all(bool(torch.isfinite(t).all()) for t in (
        final.swarm.q, final.swarm.vel, final.loc.est, metrics.q))

    # the link draw alone, for the batch at the shared tick
    ticks_dev = torch.full((B,), t_auc, dtype=torch.int32, device=dev)
    link = _profile_call(lambda: faults.link_up_at(bstate.faults,
                                                   ticks_dev))
    traced = _batched_traced(mid, bform, gains, sparams, cfg, t_auc,
                             FAULT_TRACE_TICKS, ms_per_tick)

    # serially: no_faults against faults=None, bit for bit
    formation, _, _, state = problem(N, seed, dev, torch.float32,
                                     2 * SUITE["init_radius"])
    f0, n0 = sim.rollout(state, formation, gains, sparams, cfg, TICKS)
    f1, n1 = sim.rollout(dataclasses.replace(
        state, faults=faults.no_faults(N, device=dev)), formation, gains,
        sparams, cfg, TICKS)
    no_fault_equal = all(torch.equal(getattr(n0, k), getattr(n1, k)) for k in
                         ("q", "v2f", "distcmd_norm", "ca_active",
                          "auctioned")) and torch.equal(f0.loc.est,
                                                        f1.loc.est)

    auctions = -(-FAULT_TICKS // cfg.assign_every)
    info = {"phase": "faults", "n": N, "batch": B, "ticks": FAULT_TICKS,
            "dtype": "float32", "grid": FAULT_GRID,
            "drop_tick": FAULT_DROP, "rejoin_tick": FAULT_REJOIN,
            "dead": dead_counts, "ms_per_batched_tick": ms_per_tick,
            "launches": launches, "auctions": auctions, **traced,
            "link_draw": link, "recovery": recovery,
            "recovery_format": "[tick, recovery_ticks, fault_churn]",
            "fault_events": summ.fault_event.sum(dim=1).tolist(),
            "k1": k1, "k2": k2, "k3": k3,
            "link_masks_card_equal_cpu": links_equal,
            "dead_frozen": frozen, "dead_pinned_at_auction": pinned,
            "v2f_permutations": perms, "finite": finite,
            "no_faults_equal_none": no_fault_equal,
            "max_memory_allocated_bytes": peak}
    emit(info)
    if not (all(links_equal) and all(frozen) and all(pinned) and perms
            and finite and no_fault_equal and dead_counts[drop_b] > 0
            and launches["flood_merge"] == FAULT_TICKS
            and launches["round_dominant"] == auctions
            and launches["sinkhorn_log"] >= auctions):
        raise AssertionError(f"faults check failed: {info}")
    return info


def phase_slice_scenarios(seed: int) -> dict:
    """Eight trials of the slice's start at n=1000, one draw of each
    registry family in registry order (seed S+i, horizon 240) — the
    reference's heterogeneous-batch case at full width — as one
    `sim.batched_rollout` of 240 ticks on the `simform1000_flooded`
    engine. Checks: every trial's `scen_event` fires; `no_scenario`
    equals ``scenario=None`` bit for bit on the card (B=2, 121 ticks);
    uniform draws on the card equal the CPU's bit for bit (normal draws'
    max |dz| reported). Timings as `faults`, and each axis draw alone."""
    from aclswarm_torch import ops, scenarios, sim
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.core import prng
    from aclswarm_torch.scenarios import timeline

    dev = torch.device("cuda")
    names = list(scenarios.FAMILIES)
    B = len(names)
    scens = [scenarios.sample(name, seed + i, N, horizon=SCENARIO_TICKS,
                              device=dev, dtype=torch.float32)
             for i, name in enumerate(names)]
    bstate, bform, gains, sparams = _batch_of(seed, B, scenario=scens)
    cfg = _slice_cfg()
    sim.batched_rollout(bstate, bform, gains, sparams, cfg, 2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    half = cfg.assign_every
    t0 = time.perf_counter()
    mid, m1 = sim.batched_rollout(bstate, bform, gains, sparams, cfg, half)
    final, m2 = sim.batched_rollout(mid, bform, gains, sparams, cfg,
                                    SCENARIO_TICKS - half, None, half)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ms_per_tick = seconds / SCENARIO_TICKS * 1e3
    events = torch.cat([m1.scen_event, m2.scen_event]).sum(dim=0).tolist()
    v2f = torch.cat([m1.v2f, m2.v2f])
    perms = bool(permutil.is_valid(v2f.reshape(-1, N)).all())
    finite = all(bool(torch.isfinite(t).all()) for t in (
        final.swarm.q, final.swarm.vel, final.loc.est))
    traced = _batched_traced(mid, bform, gains, sparams, cfg, half,
                             FAULT_TRACE_TICKS, ms_per_tick)

    # each axis draw alone, for the batch at tick 120 (all on by then)
    ticks_dev = torch.full((B,), half, dtype=torch.int32, device=dev)
    q = mid.swarm.q
    draws = {
        "byzantine": _profile_call(lambda: timeline.reported_positions(
            mid.scenario, q, ticks_dev)),
        "gust": _profile_call(lambda: timeline.wind_at(
            mid.scenario, ticks_dev, cfg.control_dt, N, q.dtype)),
        "noise": _profile_call(lambda: timeline.est_noise_at(
            mid.scenario, ticks_dev, N, q.dtype))}
    draws["noise"]["normals_per_call"] = B * N * N * 3

    # card against CPU: uniforms bit for bit, normals reported
    key = prng.fold_in(mid.scenario.key, ticks_dev)
    uniform_equal = all(torch.equal(
        prng.uniform(key, shape, dt).cpu(),
        prng.uniform(key.cpu(), shape, dt))
        for shape in ((N, N), (N, 3)) for dt in (torch.float32,
                                                  torch.float64))
    dz = {}
    for label, family, fn in (
            ("noise", "sensor_noise", lambda s, t: timeline.est_noise_at(
                s, t, N, torch.float32)[0]),
            ("gust", "wind_gust", lambda s, t: timeline.wind_at(
                s, t, cfg.control_dt, N, torch.float32)[0]),
            ("byzantine", "byzantine_bidders",
             lambda s, t: timeline.reported_positions(
                 s, q[names.index("byzantine_bidders")].to(s.key.device),
                 t))):
        card = scens[names.index(family)]
        cpu = timeline.from_numpy(
            {k: v.cpu().numpy() for k, v in vars(card).items()
             if not k.startswith("_")}, device="cpu", dtype=torch.float32)
        diff = (fn(card, half).cpu() - fn(cpu, half)).abs()
        dz[label] = {"max_abs_dz": diff.max().item(),
                     "elements_differing": int((diff > 0).sum()),
                     "elements": diff.numel()}
    normal_card_cpu = (prng.normal(key, (N, 3), torch.float32).cpu()
                       - prng.normal(key.cpu(), (N, 3), torch.float32)
                       ).abs().max().item()

    # no_scenario against scenario=None on the card, bit for bit (B=2)
    b0, bf0, _, _ = _batch_of(seed, 2)
    b1, _, _, _ = _batch_of(seed, 2, scenario=[
        scenarios.no_scenario(N, device=dev) for _ in range(2)])
    r0 = sim.batched_rollout(b0, bf0, gains, sparams, cfg, TICKS_AUCTIONS)
    r1 = sim.batched_rollout(b1, bf0, gains, sparams, cfg, TICKS_AUCTIONS)
    no_scenario_equal = all(torch.equal(getattr(r0[1], k), getattr(r1[1], k))
                            for k in ("q", "v2f", "distcmd_norm",
                                      "ca_active")) \
        and torch.equal(r0[0].loc.est, r1[0].loc.est)

    auctions = -(-SCENARIO_TICKS // cfg.assign_every)
    info = {"phase": "slice_scenarios", "n": N, "batch": B,
            "ticks": SCENARIO_TICKS, "dtype": "float32", "families": names,
            "scen_events": events, "ms_per_batched_tick": ms_per_tick,
            "launches": launches, "auctions": auctions, **traced,
            "axis_draws": draws, "uniform_card_equal_cpu": uniform_equal,
            "normal_max_abs_dz_card_vs_cpu": normal_card_cpu,
            "scenario_draw_max_abs_dz_card_vs_cpu": dz,
            "no_scenario_equal_none": no_scenario_equal,
            "v2f_permutations": perms, "finite": finite,
            "max_memory_allocated_bytes": peak}
    emit(info)
    if not (all(e > 0 for e in events) and uniform_equal
            and no_scenario_equal and perms and finite
            and launches["flood_merge"] == SCENARIO_TICKS
            and launches["round_dominant"] == auctions
            and launches["sinkhorn_log"] >= auctions):
        raise AssertionError(f"slice_scenarios check failed: {info}")
    return info


def phase_trial_scenarios(seed: int, trial_batch: dict | None) -> dict:
    """A wave with scenarios: the `simform1000_flooded` row through
    `run_trials(batch=5)` as `trial_batch` flies it (chunk_ticks 120, the
    14 s cut), each trial with its own `kitchen_sink` draw over a 160-tick
    horizon, so its events land in the flying ticks. Outcomes, FSM paths,
    trial-seconds per wall second beside `trial_batch`'s, copies per
    profiled chunk. Then `swarm6_3d` (seed 1, float32) under `wind_gust`
    on the card and on the CPU: the same verdict and states."""
    import tempfile

    from aclswarm_torch import ops
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.harness import trials

    row = dict(TRIAL_ROW, chunk_ticks=BATCH_CHUNK,
               trial_timeout=TRIAL_TIMEOUT_CUT)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = trials.TrialConfig(**row, seed=seed, trials=BATCH, batch=BATCH,
                                 scenario="kitchen_sink",
                                 scenario_horizon=WAVE_SCENARIO_HORIZON,
                                 verbose=False, device="cuda",
                                 dtype="float32", out=f"{tmp}/wave.csv")
        probe = _WaveProbe(profile_chunks=(11,))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        with contextlib.ExitStack() as stack:
            probe.install(stack)
            t0 = time.perf_counter()
            stats = trials.run_trials(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    ((idx, fsms),) = probe.waves
    chunks = probe.chunks
    ticks = sum(c["ticks"] for c in chunks)
    trial_ticks = sum(c["ticks"] * c["batch"] for c in chunks)
    auction_ticks = sum(c["auctions"] for c in chunks)
    less_prof = wall - probe.profiler_seconds
    final = probe.final_state
    finite = all(bool(torch.isfinite(t).all()) for t in (
        final.swarm.q, final.swarm.vel, final.goal.pos, final.loc.est))
    info = {
        "phase": "trial_scenarios", "formation": cfg.formation, "n": N,
        "batch": BATCH, "trials": idx, "seed": seed,
        "scenario": cfg.scenario, "scenario_horizon": cfg.scenario_horizon,
        "chunk_ticks": cfg.chunk_ticks, "trial_timeout": cfg.trial_timeout,
        "verdicts": [trials.NAMES[f.state] for f in fsms],
        "paths": [probe.transitions.get(id(f), []) for f in fsms],
        "dispatch_ticks": [probe.dispatches.get(id(f), []) for f in fsms],
        "completed": stats["trials_completed"], "chunks": len(chunks),
        "ticks": ticks, "trial_ticks": trial_ticks,
        "wall_seconds": wall, "profiler_seconds": probe.profiler_seconds,
        "trial_seconds_per_wall_second":
            trial_ticks * cfg.control_dt / less_prof,
        "trial_batch_trial_seconds_per_wall_second": None
        if trial_batch is None
        else trial_batch["trial_seconds_per_wall_second"],
        "ms_per_batched_tick": _mean([c["ms"] / c["ticks"]
                                      for c in chunks[1:]
                                      if not c["profiled"]]),
        "profiled": [dict(w, chunk=k, batch=chunks[k]["batch"],
                          auctions=chunks[k]["auctions"],
                          kernel_launches_per_tick=w["kernel_launches"]
                          / chunks[k]["ticks"],
                          device_busy_ms_per_tick=w["device_busy_ms"]
                          / chunks[k]["ticks"])
                     for k, w in probe.windows.items()],
        "launches": launches, "auction_ticks": auction_ticks,
        "peak_memory_bytes": peak, "finite": finite,
        "v2f_valid": bool(permutil.is_valid(final.v2f).all())}
    emit(info)
    if not (all(f.done for f in fsms) and len(fsms) == BATCH
            and launches["flood_merge"] == ticks
            and launches["round_dominant"] == auction_ticks
            and launches["sinkhorn_log"] >= auction_ticks > 0
            and finite and info["v2f_valid"]):
        raise AssertionError(f"trial_scenarios check failed: {info}")

    small = trials.TrialConfig(formation="swarm6_3d", seed=1, trials=1,
                               verbose=False, dtype="float32",
                               scenario="wind_gust",
                               trial_timeout=SMALL_SCENARIO_TIMEOUT)
    runs = {}
    for dev in ("cuda", "cpu"):
        s_fsm, s_probe, s_wall = _fly_trial(
            dataclasses.replace(small, device=dev))
        runs[dev] = (s_fsm, s_probe.transitions, s_wall)
    (c_fsm, c_tr, c_wall), (h_fsm, h_tr, h_wall) = runs["cuda"], runs["cpu"]
    emit({"phase": "trial_scenarios",
          "check": "swarm6_3d seed 1 float32 wind_gust, card vs CPU",
          "verdict": trials.NAMES[c_fsm.state],
          "verdict_cpu": trials.NAMES[h_fsm.state],
          "transitions": c_tr, "transitions_cpu": h_tr,
          "transition_ticks_equal": c_tr == h_tr,
          "wall_seconds": c_wall, "wall_seconds_cpu": h_wall})
    if not (c_fsm.state == h_fsm.state
            and [s for s, _ in c_tr] == [s for s, _ in h_tr]):
        raise AssertionError("trial_scenarios: swarm6_3d under wind_gust on "
                             f"the card disagrees with the CPU: {c_tr} vs "
                             f"{h_tr}")
    return info


# ---------------------------------------------------------------------------
# invariants, device counters and recordings (`analysis.invariants`,
# `telemetry.device`, `harness.review`): the checked and counted paths

# a NaN pose at this tick of the checked slice (after the tick-120 auction,
# before the rollout's end: no solver sees it)
CHECK_NAN_TICK = 150
# the stale alive mask of `checks_faults`: the fault grid's 0.5-dropout row
STALE_ROW = (0.5, 0.0)
# the reference's churn/lag curve (`benchmarks/pipeline_rate.py`
# `churn_rows`)
CHURN_N, CHURN_TICKS, CHURN_EPS = 24, 2400, (0.0, 0.05)
# its committed rows (float64 on the CPU), one per `CHURN_EPS`: churn and
# valid auctions are held exactly, the lag to within CHURN_LAG_ATOL
CHURN_REFERENCE = ({"assign_eps": 0.0, "auctions": 40, "churn_rate": 0.125,
                    "lag_rms_m": 0.745},
                   {"assign_eps": 0.05, "auctions": 40, "churn_rate": 0.025,
                    "lag_rms_m": 0.869})
CHURN_LAG_ATOL = 0.01


def _with_carries(state, batch=None):
    """``state`` with a clean invariant carry and zeroed counters."""
    from aclswarm_torch.analysis import invariants as invlib
    from aclswarm_torch.telemetry import device as devtel

    return dataclasses.replace(
        state, inv=invlib.init_invariants(batch, state.swarm.q.device),
        tel=devtel.init_telemetry(batch, state.swarm.q.dtype,
                                  state.swarm.q.device))


def _cat_metrics(parts):
    """`StepMetrics` of consecutive rollouts joined on the time axis."""
    from aclswarm_torch.core import types
    from aclswarm_torch.sim.engine import StepMetrics

    return StepMetrics(**{k: None if getattr(parts[0], k) is None
                          else types.tree_map(lambda *xs: torch.cat(xs),
                                              *[getattr(m, k) for m in parts])
                          for k in vars(parts[0])})


def _first(codes, tick0: int = 0) -> list | None:
    """(tick, contract id) of the first violation in a (T,) code stack
    whose first tick is ``tick0``."""
    from aclswarm_torch.analysis import invariants as invlib

    hit = invlib.first_violation(codes.cpu().numpy(), tick0)
    return None if hit is None else [hit[0], hit[1].id]


@contextlib.contextmanager
def _patched(mod, name, fn):
    original = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield original
    finally:
        setattr(mod, name, original)


def _path_kernel_inputs(run) -> dict:
    """``run()`` with the first inputs the path hands each kernel's wrapper
    kept (cloned), with the launches that call made."""
    from aclswarm_torch import ops

    seen = {}
    with contextlib.ExitStack() as stack:
        for name in ("sinkhorn_log", "round_dominant", "flood_merge"):
            def keep(*args, _name=name, _wrapped=getattr(ops, name)):
                before = ops.LAUNCHES[_name]
                out = _wrapped(*args)
                seen.setdefault(_name, (
                    [a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args], ops.LAUNCHES[_name] - before))
                return out
            stack.enter_context(_patched(ops, name, keep))
        run()
    missing = {"sinkhorn_log", "round_dominant", "flood_merge"} - set(seen)
    if missing:
        raise AssertionError(f"the path launched no {sorted(missing)}")
    return seen


def _hold_path_kernels(label, run, rtol=0.0) -> dict:
    """K1, K2 and K3 against their plain versions on the inputs the path
    hands them in ``run()`` (`_check_sinkhorn`, `_check_rounding`,
    `_check_flood`: K1 within 5e-5 + ``rtol`` |plain| with masses within
    1e-4 of the plain version's, K2 and K3 bit for bit), each launched as
    often as the path launched it."""
    seen = _path_kernel_inputs(run)
    (cost, tau, iters), k1_launches = seen["sinkhorn_log"]
    (plan, *rounds_cap), _ = seen["round_dominant"]
    (packed, comm, *_), _ = seen["flood_merge"]
    return {"k1": _check_sinkhorn(f"{label}: K1", cost, tau, iters,
                                  k1_launches, rtol),
            "k2": _check_rounding(f"{label}: K2", plan, *rounds_cap),
            "k3": _check_flood(f"{label}: K3", packed, comm)}


def _roll_pieces(state, formation, gains, sparams, cfg, bounds):
    """One rollout cut at ``bounds`` (ticks); returns the state at each
    cut, the final state, the joined metrics and the synchronized
    seconds."""
    from aclswarm_torch import sim

    cuts, parts = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a, b in zip(bounds, bounds[1:]):
        cuts.append(state)
        state, m = sim.rollout(state, formation, gains, sparams, cfg, b - a)
        parts.append(m)
    torch.cuda.synchronize()
    return cuts, state, _cat_metrics(parts), time.perf_counter() - t0


def _nan_inputs(ticks: int, n: int, dtype):
    """No command; a NaN joystick velocity on vehicle 0 at the first tick."""
    from aclswarm_torch.sim.vehicle import ExternalInputs

    dev = torch.device("cuda")
    vel = torch.zeros((ticks, n, 3), dtype=dtype, device=dev)
    active = torch.zeros((ticks, n), dtype=torch.bool, device=dev)
    vel[0, 0] = float("nan")
    active[0, 0] = True
    return ExternalInputs(
        cmd=torch.zeros((ticks,), dtype=torch.int32, device=dev),
        joy_vel=vel, joy_yawrate=torch.zeros((ticks, n), dtype=dtype,
                                             device=dev),
        joy_active=active)


def phase_checks(seed: int, slice_info: dict | None) -> dict:
    """The slice (cell 1, 240 ticks) twice from one start: with
    ``check_mode`` and ``telemetry`` off, then both on. Every code 0; q
    and v2f bit-identical; the off run's kernel launches equal the
    `slice` phase's; the counters equal their recomputation from the
    metrics (auctions, reassigns and avoidance vehicle-ticks summed, no
    Sinkhorn rounds, the largest estimate age seen, read tick by tick in
    a third, unchecked run); ms and kernel launches per tick, on against
    off; K1, K2 and K3 against their plain versions on the inputs the
    checked run hands them at the tick-120 auction. Then four mutations
    from the checked run's states, each tripping
    its own contract at its own tick: a NaN pose at tick 150
    (`state_finite`), a duplicated row in K2's tick-120 permutation
    (`assign_perm`; that auction is made a dispatch's first, which the
    hysteresis never vetoes), an asymmetric adjacency (`adj_sym` at tick
    0), K1's tick-120 plan with its mass doubled (`sinkhorn_marginal`)."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.assignment import sinkhorn

    dev = torch.device("cuda")
    formation, gains, sparams, state = problem(
        N, seed, dev, torch.float32, 2 * SUITE["init_radius"])
    cfgs = {"off": _slice_cfg(),
            "on": _slice_cfg(check_mode="on", telemetry="on"),
            "check_mode": _slice_cfg(check_mode="on"),
            "telemetry": _slice_cfg(telemetry="on")}
    starts = {k: state if k == "off" else _with_carries(state)
              for k in cfgs}
    for k in cfgs:                                      # warm-up
        sim.rollout(starts[k], formation, gains, sparams, cfgs[k], 2)
    bounds = (0, cfgs["on"].assign_every, CHECK_NAN_TICK, TICKS)
    runs = {}
    for k in ("off", "on"):
        ops.reset_launches()
        cuts, final, metrics, seconds = _roll_pieces(
            starts[k], formation, gains, sparams, cfgs[k], bounds)
        runs[k] = dict(cuts=cuts, final=final, metrics=metrics,
                       ms_per_tick=seconds / TICKS * 1e3,
                       launches=dict(ops.LAUNCHES))
    off, on = runs["off"], runs["on"]
    same = all(torch.equal(getattr(off["metrics"], k),
                           getattr(on["metrics"], k))
               for k in ("q", "v2f", "distcmd_norm", "ca_active",
                         "reassigned", "auctioned", "assign_valid")) \
        and torch.equal(off["final"].swarm.q, on["final"].swarm.q) \
        and torch.equal(off["final"].loc.age, on["final"].loc.age)
    m, tel = on["metrics"], on["final"].tel

    # the largest age seen, tick by tick, in an unchecked run
    s, ages = state, []
    for _ in range(TICKS):
        s, _ = sim.step(s, formation, gains, sparams, cfgs["off"])
        ages.append(torch.amax(s.loc.age))
    host = {"auctions": int(m.auctioned.sum()),
            "assign_rounds": 0,
            "reassigns": int(m.reassigned.sum()),
            "ca_ticks": int(m.ca_active.sum()),
            "flood_stale_max": int(torch.stack(ages).max())}
    counters = {f: int(getattr(tel, f)) for f in host}

    # launches per tick under the profiler, one auction and 39 more ticks
    def traced(k):
        def run(ticks):
            sim.rollout(starts[k], formation, gains, sparams, cfgs[k],
                        ticks)
        _, by_name, _ = _traced_window(run, 40)
        return sum(v[0] for v in by_name.values()) / 40

    launches_per_tick = {k: traced(k) for k in cfgs}
    # each mode alone, for the record
    alone_ms = {}
    for k in ("check_mode", "telemetry"):
        _, _, _, seconds = _roll_pieces(starts[k], formation, gains, sparams,
                                        cfgs[k], (0, TICKS))
        alone_ms[k] = seconds / TICKS * 1e3

    # the mutations, from the checked run's states at ticks 0, 120, 150
    at0, at120, at150 = on["cuts"]
    held = _hold_path_kernels("checks: tick 120", lambda: sim.rollout(
        at120, formation, gains, sparams, cfgs["on"], 1))
    mutations = {}
    _, mm = sim.rollout(at150, formation, gains, sparams, cfgs["on"], 5,
                        _nan_inputs(5, N, torch.float32))
    mutations["nan_pose"] = [_first(mm.inv_code, CHECK_NAN_TICK),
                             [CHECK_NAN_TICK, "state_finite"]]
    first120 = dataclasses.replace(
        at120, first_auction=torch.ones((), dtype=torch.bool, device=dev))

    def duplicated(plan, max_rounds=None):
        v = ops.round_dominant(plan, max_rounds)[0].clone()
        v[..., 1] = v[..., 0]
        return v

    with _patched(sinkhorn, "round_dominant", duplicated):
        _, mm = sim.rollout(first120, formation, gains, sparams,
                            cfgs["on"], 1)
    mutations["duplicate_row"] = [_first(mm.inv_code, bounds[1]),
                                  [bounds[1], "assign_perm"]]
    adj = formation.adjmat.clone()
    adj[0, 1] = 1.0 - adj[0, 1]
    _, mm = sim.rollout(at0, dataclasses.replace(formation, adjmat=adj),
                        gains, sparams, cfgs["on"], 2)
    mutations["asymmetric_adjacency"] = [_first(mm.inv_code),
                                         [0, "adj_sym"]]
    log = sinkhorn.sinkhorn_log
    with _patched(sinkhorn, "sinkhorn_log",
                  lambda *a, **k: log(*a, **k) + math.log(2.0)):
        _, mm = sim.rollout(at120, formation, gains, sparams, cfgs["on"],
                            1)
    mutations["doubled_plan_mass"] = [_first(mm.inv_code, bounds[1]),
                                      [bounds[1], "sinkhorn_marginal"]]

    slice_launches = None if slice_info is None else {
        k: slice_info["launches"][k] for k in off["launches"]}
    info = {"phase": "checks", "n": N, "ticks": TICKS, "dtype": "float32",
            "launches": on["launches"],
            "codes_clean": not bool(m.inv_code.any()),
            "first_violation": _first(m.inv_code),
            "q_v2f_bit_identical": same,
            "counters": counters, "counters_from_metrics": host,
            "admm": {"iters": int(tel.admm_iters),
                     "residual": float(tel.admm_residual)},
            "launches_off": off["launches"], "launches_on": on["launches"],
            "launches_slice_phase": slice_launches,
            "ms_per_tick": {"off": off["ms_per_tick"],
                            "on": on["ms_per_tick"], **alone_ms},
            "kernel_launches_per_tick": launches_per_tick,
            "kernels_vs_plain": held, "mutations": mutations}
    emit(info)
    ok = (info["codes_clean"] and same and counters == host
          and all(on["launches"].values())
          and off["launches"] == on["launches"]
          and (slice_launches is None or off["launches"] == slice_launches)
          and all(got == want for got, want in mutations.values()))
    if not ok:
        raise AssertionError(f"checks failed: {info}")
    return info


def phase_checks_faults(seed: int) -> dict:
    """The `faults` phase's batch (the fault grid, B=8, 360 ticks) with
    both modes off and on from one start: every trial clean, q and v2f
    bit-identical, each trial's counters equal their recomputation from
    its metrics; ms per batched tick, on against off; K1, K2 and K3 against
    their plain versions on the inputs the checked batch hands them at the
    tick-120 auction. Then a one-tick-stale
    alive mask injected into the 0.5-dropout trial alone, from tick 58:
    `mask_consistency` at that trial's drop tick 60, every other trial
    clean."""
    from aclswarm_torch import faults, ops, sim
    from aclswarm_torch.sim import engine

    dev, B = torch.device("cuda"), len(FAULT_GRID)
    scheds = [faults.sample_schedule(seed * 1000 + i, N, dropout_frac=df,
                                     drop_tick=FAULT_DROP,
                                     rejoin_tick=FAULT_REJOIN, link_loss=pl,
                                     device=dev, dtype=torch.float32)
              for i, (df, pl) in enumerate(FAULT_GRID)]
    bstate, bform, gains, sparams = _batch_of(seed, B, faults=scheds)
    cfgs = {"off": _slice_cfg(),
            "on": _slice_cfg(check_mode="on", telemetry="on")}
    starts = {"off": bstate, "on": _with_carries(bstate, B)}
    for k in cfgs:                                      # warm-up
        sim.batched_rollout(starts[k], bform, gains, sparams, cfgs[k], 2)
    cut, t_auc = FAULT_DROP - 2, _slice_cfg().assign_every
    runs = {}
    for k in ("off", "on"):
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        states, parts = [starts[k]], []
        for a, b in ((0, cut), (cut, t_auc), (t_auc, FAULT_TICKS)):
            s, m = sim.batched_rollout(states[-1], bform, gains, sparams,
                                       cfgs[k], b - a, None, a)
            states.append(s)
            parts.append(m)
        torch.cuda.synchronize()
        runs[k] = dict(mid=states[1], at_auction=states[2],
                       final=states[3], metrics=_cat_metrics(parts),
                       ms=(time.perf_counter() - t0) / FAULT_TICKS * 1e3,
                       launches=dict(ops.LAUNCHES))
    off, on = runs["off"]["metrics"], runs["on"]["metrics"]
    same = all(torch.equal(getattr(off, k), getattr(on, k))
               for k in ("q", "v2f", "reassigned", "auctioned", "alive"))
    tel = runs["on"]["final"].tel
    host = {"auctions": on.auctioned.sum(0).tolist(),
            "reassigns": on.reassigned.sum(0).tolist(),
            "ca_ticks": on.ca_active.sum((0, 2)).tolist()}
    counters = {f: getattr(tel, f).tolist() for f in host}
    clean = [_first(on.inv_code[:, b]) for b in range(B)]
    # masked costs: 5e-5 plus 2^-22 |plain| (as `faults`)
    held = _hold_path_kernels(
        "checks_faults: tick 120", lambda: sim.batched_rollout(
            runs["on"]["at_auction"], bform, gains, sparams, cfgs["on"], 1,
            None, t_auc), rtol=2.0**-22)

    stale_b = FAULT_GRID.index(STALE_ROW)
    only = torch.zeros(B, dtype=torch.bool, device=dev)
    only[stale_b] = True
    fresh = engine.faultlib.alive_at

    def stale(sched, tick):
        return torch.where(only[:, None], fresh(sched, tick - 1),
                           fresh(sched, tick))

    with _patched(engine.faultlib, "alive_at", stale):
        _, mm = sim.batched_rollout(runs["on"]["mid"], bform, gains,
                                    sparams, cfgs["on"], 5, None, cut)
    stale_hits = [_first(mm.inv_code[:, b], cut) for b in range(B)]
    want = [None] * B
    want[stale_b] = [FAULT_DROP, "mask_consistency"]
    info = {"phase": "checks_faults", "n": N, "batch": B,
            "ticks": FAULT_TICKS, "grid": FAULT_GRID,
            "launches": runs["on"]["launches"],
            "launches_off": runs["off"]["launches"],
            "first_violations": clean, "q_v2f_bit_identical": same,
            "counters": counters, "counters_from_metrics": host,
            "flood_stale_max": tel.flood_stale_max.tolist(),
            "ms_per_batched_tick": {"off": runs["off"]["ms"],
                                    "on": runs["on"]["ms"]},
            "stale_mask_trial": stale_b,
            "stale_mask_from_tick": cut,
            "stale_mask_first_violations": stale_hits,
            "kernels_vs_plain": held}
    emit(info)
    if not (all(c is None for c in clean) and same and counters == host
            and all(runs["on"]["launches"].values())
            and runs["on"]["launches"] == runs["off"]["launches"]
            and stale_hits == want):
        raise AssertionError(f"checks_faults failed: {info}")
    return info


class _HostReads:
    """Counts the device-to-host reads Python makes of card tensors: the
    `Tensor` methods that copy to the host (`cpu`, `to` a host device,
    `item`, `tolist`, and the conversions to bool, int and float), while
    installed. Reads that ATen makes inside an operation (a linear-algebra
    error check) are not seen."""

    def __init__(self):
        self.count = 0

    def install(self, stack):
        reads = self
        for name in ("cpu", "to", "item", "tolist", "__bool__", "__int__",
                     "__float__"):
            original = getattr(torch.Tensor, name)

            def counted(t, *a, _original=original, **k):
                out = _original(t, *a, **k)
                if t.is_cuda and not (isinstance(out, torch.Tensor)
                                      and out.is_cuda):
                    reads.count += 1
                return out

            setattr(torch.Tensor, name, counted)
            stack.callback(setattr, torch.Tensor, name, original)


def phase_trial_checked(seed: int, trial_info: dict | None) -> dict:
    """The `trial` configuration (cell 4) through `run_trials` with
    ``check_mode``, ``telemetry``, ``telemetry_dump``, ``profile_dir``
    (chunk 3, a hover chunk) and ``record_dir`` on: the verdict, path,
    times and CSV row of the `trial` phase's unchecked run; `review` of the
    recording reaches the live FSM's state and times; the dumped trial
    counters equal the carry's; the trace file is not empty; the
    device-to-host reads Python makes per chunk stay within
    `CHUNK_READS` + `AUCTION_READS` per auction tick (counted by wrapping
    the reading methods, not from the profiler, which drops records);
    simulated seconds per wall second, on against off."""
    import json
    import tempfile
    from pathlib import Path

    from aclswarm_torch import ops, sim, telemetry
    from aclswarm_torch.harness import review, trials

    with tempfile.TemporaryDirectory() as tmp:
        cfg = trials.TrialConfig(
            **dict(TRIAL_ROW, trial_timeout=TRIAL_TIMEOUT_CUT), seed=seed,
            trials=1, verbose=False, device="cuda", dtype="float32",
            check_mode="on", telemetry="on",
            telemetry_dump=f"{tmp}/tel.jsonl", profile_dir=f"{tmp}/prof",
            profile_chunk=3, record_dir=f"{tmp}/rec", out=f"{tmp}/t.csv")
        telemetry.reset_registry()
        probe = _TrialProbe()
        reads = _HostReads()
        per_chunk = []
        fsms = []
        record_s = []
        write = review.record

        def timed_record(*a, **k):
            t0 = time.perf_counter()
            out = write(*a, **k)
            record_s.append(time.perf_counter() - t0)
            return out

        with contextlib.ExitStack() as stack:
            probe.install(stack)
            probe_rollout, run_trial = sim.rollout, trials.run_trial

            def rollout(*a, **k):
                per_chunk.append(reads.count)
                return probe_rollout(*a, **k)

            def trial(*a, **k):
                fsms.append(run_trial(*a, **k))
                return fsms[-1]

            stack.enter_context(_patched(sim, "rollout", rollout))
            stack.enter_context(_patched(trials, "run_trial", trial))
            stack.enter_context(_patched(review, "record", timed_record))
            reads.install(stack)
            ops.reset_launches()
            t0 = time.perf_counter()
            trials.run_trials(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
        (fsm,) = fsms
        dumped = {}
        for line in Path(cfg.telemetry_dump).read_text().splitlines():
            row = json.loads(line)
            if row["name"].startswith("trial_") and row["kind"] == "counter":
                dumped[row["name"]] = row["value"]
        tel = probe.final_state.tel
        carry = {f"trial_{f}_total": int(getattr(tel, f)) for f in
                 ("auctions", "assign_rounds", "reassigns", "ca_ticks")}
        carry = {k: v for k, v in carry.items() if v}
        replay = review.review(f"{cfg.record_dir}/trial_0.npz",
                               n_formations=fsm.n_formations,
                               takeoff_alt=float(
                                   trials._trial_sparams(cfg).takeoff_alt))
        traces = [p.stat().st_size for p in Path(cfg.profile_dir).iterdir()]
    chunks = probe.chunks
    per_chunk.append(reads.count)
    # reads from a chunk's start to the next chunk's: its rollout and the
    # host's work after it; a dispatch's design reads its stop flags
    dispatched = {c["chunk"] for c in chunks if c["chunk"] and
                  c["tick0"] == 0}
    reads_per_chunk = [b - a for a, b in zip(per_chunk, per_chunk[1:])]
    bounded = [r <= CHUNK_READS + AUCTION_READS * c["auctions"]
               for c, r in zip(chunks, reads_per_chunk)
               if c["chunk"] + 1 not in dispatched]
    ticks = sum(c["ticks"] for c in chunks)
    # the probe's own profiler (the dispatch window) is not the trial's
    rate = ticks * cfg.control_dt / (wall - probe.profiler_seconds)
    off = None if trial_info is None else {
        "verdict": trial_info["verdict"],
        "transitions": [tuple(t) for t in trial_info["transitions"]],
        "times": trial_info["times"], "csv_digest": trial_info["csv_digest"],
        "simulated_seconds_per_wall_second":
            trial_info["simulated_seconds"]
            / trial_info["wall_seconds_less_profiler"]}
    info = {"phase": "trial_checked", "formation": cfg.formation, "n": N,
            "seed": seed, "verdict": trials.NAMES[fsm.state],
            "launches": launches,
            "transitions": probe.transitions, "times": fsm.times,
            "csv_digest": _row_digest(fsm.csv_row(0)),
            "replay": {"verdict": trials.NAMES[replay.state],
                       "ticks": replay.tick_count, "times": replay.times},
            "dumped_counters": dumped, "carry_counters": carry,
            "admm": {"iters": int(tel.admm_iters),
                     "residual": float(tel.admm_residual)},
            "trace_bytes": traces, "chunks": len(chunks),
            "record_write_seconds": record_s,
            "profiled_chunk": {k: chunks[cfg.profile_chunk].get(k) for k in
                               ("ms", "host_ms", "ticks")},
            "chunk_ms": [round(c["ms"], 3) for c in chunks],
            "host_reads_per_chunk": reads_per_chunk,
            "dispatch_chunks": sorted(dispatched),
            "ticks": ticks, "wall_seconds": wall,
            "probe_profiler_seconds": probe.profiler_seconds,
            "simulated_seconds_per_wall_second": rate,
            "unchecked_trial_phase": off}
    emit(info)
    ok = (fsm.done and replay.state == fsm.state
          and replay.tick_count == fsm.tick_count
          and replay.times == fsm.times and dumped == carry
          and carry.get("trial_auctions_total", 0) >= 2
          and int(tel.admm_iters) > 0 and traces and all(traces)
          and all(launches.values())
          and bounded and all(bounded))
    if off is not None:
        ok = ok and (off["verdict"] == info["verdict"]
                     and off["transitions"] == [tuple(t) for t in
                                                probe.transitions]
                     and off["times"] == fsm.times
                     and off["csv_digest"] == info["csv_digest"])
    if not ok:
        raise AssertionError(f"trial_checked failed: {info}")
    return info


def phase_trial_batch_checked(seed: int, trial_batch: dict | None) -> dict:
    """The `trial_batch` wave (B=5, chunk_ticks 120, the 14 s cut) with
    ``check_mode`` and ``telemetry`` on: the verdicts, paths and CSV rows
    of `trial_batch`'s unchecked wave, every live trial's counters
    published under its own index, trial-seconds per wall second against
    `trial_batch`'s."""
    import tempfile

    from aclswarm_torch import ops
    from aclswarm_torch.harness import trials
    from aclswarm_torch.telemetry import device as devtel

    row = dict(TRIAL_ROW, chunk_ticks=BATCH_CHUNK,
               trial_timeout=TRIAL_TIMEOUT_CUT)
    published = []
    publish = devtel.ChunkPublisher.publish

    def record(self, key, tel):
        published.append(key)
        return publish(self, key, tel)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = trials.TrialConfig(**row, seed=seed, trials=BATCH, batch=BATCH,
                                 verbose=False, device="cuda",
                                 dtype="float32", out=f"{tmp}/wave.csv",
                                 check_mode="on", telemetry="on")
        probe = _WaveProbe()
        with contextlib.ExitStack() as stack:
            probe.install(stack)
            stack.enter_context(_patched(devtel.ChunkPublisher, "publish",
                                         record))
            ops.reset_launches()
            t0 = time.perf_counter()
            stats = trials.run_trials(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
    ((idx, fsms),) = probe.waves
    trial_ticks = sum(c["ticks"] * c["batch"] for c in probe.chunks)
    info = {"phase": "trial_batch_checked", "batch": BATCH, "trials": idx,
            "launches": launches,
            "verdicts": [trials.NAMES[f.state] for f in fsms],
            "paths": [probe.transitions.get(id(f), []) for f in fsms],
            "csv_digests": [_row_digest(f.csv_row(t))
                            for t, f in zip(idx, fsms)],
            "completed": stats["trials_completed"],
            "published_per_trial": [published.count(t) for t in idx],
            "wall_seconds": wall,
            "trial_seconds_per_wall_second":
                trial_ticks * cfg.control_dt / wall,
            "unchecked_trial_seconds_per_wall_second":
                None if trial_batch is None
                else trial_batch["trial_seconds_per_wall_second"]}
    emit(info)
    ok = (all(f.done for f in fsms) and all(info["published_per_trial"])
          and all(launches.values()))
    if trial_batch is not None:
        ok = ok and all(info[k] == trial_batch[k]
                        for k in ("verdicts", "paths", "csv_digests"))
    if not ok:
        raise AssertionError(f"trial_batch_checked failed: {info}")
    return info


def phase_churn(seed: int) -> dict:
    """The reference's churn/lag curve (`benchmarks/pipeline_rate.py`
    `churn_rows`, n=24, 2400 ticks) on the card in
    float32: CBAA every 30 ticks under `goal_drift` (speed 0.08 m/s,
    re-matching every 60 ticks) on a full-graph circle with designed
    gains; assign_eps 0 without warm tables (the baseline row) and 0.05
    with them. Churn = the `reassigns` counter over the `auctions`
    counter; also the valid auctions and the lag (the shape error against
    the drifted formation every 30 ticks after the onset). Held to the
    reference's committed rows (`CHURN_REFERENCE`): churn 0.125 and 0.025
    and 40/40 valid auctions exactly, the lag within 0.01 m. The
    seed is the benchmark's own (formation 21, start 3, scenario 5)."""
    from aclswarm_torch import gains as gainslib
    from aclswarm_torch import ops, sim
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil
    from aclswarm_torch.core import types
    from aclswarm_torch.scenarios import registry as scenreg

    dev, n, ticks = torch.device("cuda"), CHURN_N, CHURN_TICKS
    rng = np.random.default_rng(21)
    radius = max(4.0, n / (2 * np.pi))
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([radius * np.cos(ang), radius * np.sin(ang),
                    2.0 + 0.35 * rng.standard_normal(n)], axis=1)
    adj = np.ones((n, n)) - np.eye(n)
    g = gainslib.solve_gains(pts.astype(np.float32), adj, max_nonedges=1,
                             device=dev)
    form = types.make_formation(pts, adj, g, device=dev,
                                dtype=torch.float32)
    sp = types.SafetyParams(bounds_min=(-200.0, -200.0, 0.0),
                            bounds_max=(200.0, 200.0, 50.0))
    rng = np.random.default_rng(3)
    q0 = pts + rng.normal(scale=1.5, size=(n, 3)) * [1, 1, 0.2]
    q0[:, 2] = np.maximum(q0[:, 2], 0.5)
    assign_every, rematch_every, speed = 30, 60, 0.08
    scen = scenreg.sample("goal_drift", 5, n, horizon=ticks,
                          params={"drift.speed": speed,
                                  "drift.rematch_every": rematch_every},
                          device=dev, dtype=torch.float32)
    drift_vel = scen.drift_vel.cpu().numpy()
    drift_tick = int(scen.drift_tick)
    rows = []
    ops.reset_launches()
    for eps in CHURN_EPS:
        warm = eps > 0
        cfg = sim.SimConfig(assignment="cbaa", assign_every=assign_every,
                            assign_eps=eps, telemetry="on")
        st = sim.init_state(q0, scenario=scen, cbaa_warm=warm,
                            telemetry=True, device=dev, dtype=torch.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, m = sim.rollout(st, form, types.ControlGains(), sp, cfg,
                               ticks)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        errs = []
        for t in range(drift_tick, ticks, assign_every):
            pts_t = torch.as_tensor(pts + drift_vel * ((t - drift_tick)
                                                       * 0.01),
                                    dtype=torch.float32, device=dev)
            q_form = permutil.veh_to_formation_order(m.q[t], m.v2f[t])
            resid = (q_form - geometry.align(pts_t, q_form, d=2)).cpu()
            resid[:, 2] -= resid[:, 2].mean()
            errs.append(float(torch.sqrt(torch.mean(
                torch.sum(resid ** 2, -1)))))
        tel = final.tel
        auctions, reassigns = int(tel.auctions), int(tel.reassigns)
        rows.append({"assign_eps": eps, "warm_tables": warm,
                     "auctions": auctions, "reassigns": reassigns,
                     "valid_auctions": int((m.auctioned
                                            & m.assign_valid).sum()),
                     "churn_rate": reassigns / max(auctions, 1),
                     "reassigned_ticks": int(m.reassigned.sum()),
                     "assign_rounds": int(tel.assign_rounds),
                     "lag_rms_m": float(np.mean(errs)),
                     "ms_per_tick": seconds / ticks * 1e3})
    info = {"phase": "churn", "n": n, "ticks": ticks, "dtype": "float32",
            "launches": dict(ops.LAUNCHES),
            "assign_every": assign_every, "rematch_every": rematch_every,
            "drift_speed": speed, "rows": rows,
            "reference_rows": CHURN_REFERENCE,
            "lag_tolerance_m": CHURN_LAG_ATOL}
    emit(info)
    if not all(r["reassigns"] == r["reassigned_ticks"]
               and r["auctions"] == r["valid_auctions"] == ref["auctions"]
               and r["churn_rate"] == ref["churn_rate"]
               and abs(r["lag_rms_m"] - ref["lag_rms_m"]) <= CHURN_LAG_ATOL
               for r, ref in zip(rows, CHURN_REFERENCE)):
        raise AssertionError(f"churn failed: {info}")
    return info



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run after device and "
                    "build (debugging; no kernels or result line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    import aclswarm_torch  # noqa: F401  (needs the repository)

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        emit({"phase": name, "phase_seconds": time.perf_counter() - t0})
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    if args.phases:
        table = {"gains": phase_gains, "kernels": phase_kernels,
                 "reference": phase_reference, "slice": phase_slice,
                 "auction": phase_auction, "cbaa": phase_cbaa,
                 "slice_cbaa": phase_slice_cbaa,
                 "slice_auction": phase_slice_auction,
                 "trial": phase_trial, "batch_kernels": phase_batch_kernels,
                 "slice_batch": phase_slice_batch, "faults": phase_faults,
                 "slice_scenarios": phase_slice_scenarios,
                 "checks_faults": phase_checks_faults, "churn": phase_churn}
        done = {}
        for name in args.phases.split(","):
            if name == "trial_batch":
                done[name] = timed(name, phase_trial_batch, args.seed,
                                   done.get("trial"),
                                   done.get("slice_batch"))
            elif name == "trial_scenarios":
                done[name] = timed(name, phase_trial_scenarios, args.seed,
                                   done.get("trial_batch"))
            elif name == "checks":
                done[name] = timed(name, phase_checks, args.seed,
                                   done.get("slice"))
            elif name == "trial_checked":
                done[name] = timed(name, phase_trial_checked, args.seed,
                                   done.get("trial"))
            elif name == "trial_batch_checked":
                done[name] = timed(name, phase_trial_batch_checked,
                                   args.seed, done.get("trial_batch"))
            else:
                done[name] = timed(name, table[name], args.seed)
        print("chip_smoke: partial run (--phases), no result line",
              flush=True)
        return 0
    gn = timed("gains", phase_gains, args.seed)
    kern = timed("kernels", phase_kernels, args.seed)
    timed("reference", phase_reference, args.seed)
    sl = timed("slice", phase_slice, args.seed)
    timed("profile", phase_profile, args.seed, sl["ms_per_tick"])
    sl_random = timed("slice", phase_slice, args.seed, "random")
    timed("profile", phase_profile, args.seed, sl_random["ms_per_tick"],
          "random")
    timed("auction", phase_auction, args.seed)
    timed("cbaa", phase_cbaa, args.seed)
    sl_cbaa = timed("slice_cbaa", phase_slice_cbaa, args.seed)
    sl_auction = timed("slice_auction", phase_slice_auction, args.seed)
    tr = timed("trial", phase_trial, args.seed)
    bk = timed("batch_kernels", phase_batch_kernels, args.seed)
    sb = timed("slice_batch", phase_slice_batch, args.seed)
    tb = timed("trial_batch", phase_trial_batch, args.seed, tr, sb)
    fl = timed("faults", phase_faults, args.seed)
    ss = timed("slice_scenarios", phase_slice_scenarios, args.seed)
    ts = timed("trial_scenarios", phase_trial_scenarios, args.seed, tb)
    ck = timed("checks", phase_checks, args.seed, sl)
    ckf = timed("checks_faults", phase_checks_faults, args.seed)
    tc = timed("trial_checked", phase_trial_checked, args.seed, tr)
    tbc = timed("trial_batch_checked", phase_trial_batch_checked, args.seed,
                tb)
    ch = timed("churn", phase_churn, args.seed)

    sources = {"sinkhorn_log": ("aclswarm_torch/csrc/sinkhorn.cu",
                                "aclswarm_tpu/ops/sinkhorn_pallas.py:81"),
               "round_dominant": ("aclswarm_torch/csrc/rounding.cu",
                                  "aclswarm_tpu/ops/rounding_pallas.py:82"),
               "flood_merge": ("aclswarm_torch/csrc/flood.cu",
                               "aclswarm_tpu/ops/flood_pallas.py:70")}
    designs = {"sinkhorn_log": ("one cooperative launch per solve, one "
                                "block per SM, logK stripes in shared "
                                "memory, iteration-tagged potentials in "
                                "place of a grid barrier",
                                "one launch per half-iteration"),
               "round_dominant": ("stale-only rescans: one cooperative "
                                  "launch, one block per SM owning rows and "
                                  "columns, round-tagged published argmaxes "
                                  "in place of a grid barrier, every block "
                                  "deciding every commit",
                                  "whole loop in one 1024-thread block"),
               "flood_merge": ("bit-packed mask, one DPX add-min "
                               "(VIADDMNMX) per triple, cp.async double "
                               "buffer, senders split over 4 groups",
                               "byte-mask tile, select + signed min")}
    rows = []
    for name, key in (("sinkhorn_log", "sinkhorn_log"),
                      ("round_dominant", "round_dominant"),
                      ("flood_merge", f"flood_merge_w{N // 2}")):
        k = kern[key]
        row = {"name": name, "route": "cuda", "source": sources[name][0],
               "replaces": sources[name][1],
               "launches": sl["launches"][name],
               "launches_by_path": {
                   "gains": gn["launches"][name],
                   "slice": sl["launches"][name],
                   "slice_cbaa": sl_cbaa["launches"][name],
                   "slice_auction": sl_auction["launches"][name],
                   "trial": tr["launches"][name],
                   "slice_batch": sb["launches"][name],
                   "trial_batch": tb["launches"][name],
                   "faults": fl["launches"][name],
                   "slice_scenarios": ss["launches"][name],
                   "trial_scenarios": ts["launches"][name],
                   "checks": ck["launches"][name],
                   "checks_faults": ckf["launches"][name],
                   "trial_checked": tc["launches"][name],
                   "trial_batch_checked": tbc["launches"][name],
                   "churn": ch["launches"][name]},
               "max_abs_err": k["max_abs_err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": None,
               "design": designs[name][0]}
        row.update(prev_design=designs[name][1], prev_ms=k["prev_ms"],
                   batched=bk[key])
        if name == "round_dominant":
            row.update(dense_bound_ms=k["dense_bound_ms"],
                       rounds=k["rounds"])
        rows.append(row)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

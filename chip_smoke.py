#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`aclswarm_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

Phases, one JSON line each; any failure raises, so the run exits non-zero
and prints no result line:

1. device  — the card's name, count, and `nvidia-smi` name + power limit;
2. build   — the CUDA kernels built from `aclswarm_torch/csrc/` with nvcc
             and, beside them, the native wire library (`make -C
             native`: the shm rings; its failure fails the run)
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
             its path, each auction that ran out of rounds equal to the
             CPU's on its benefit matrix (tick 0's is the `auction`
             phase's: its CPU result is reused); and the default
             `SimConfig()` at n=6 (random gains) for 240 ticks on the card
             against the CPU;
12. trial   — the `simform1000_flooded` row flown as a trial through
             `harness.trials.run_trial` (float32, `trial_timeout` cut to
             14 s): takeoff, hover, one dispatch whose ADMM design is
             validated, Sinkhorn auctions after it; the FSM's path, the
             launch counts (K3 every tick, K1 = K2 = the auctions after
             the dispatch), the device-to-host copies of whole chunks, ms
             per tick of hover and flying chunks, the FSM's host ms per
             chunk, wall against simulated seconds; then `swarm6_3d` (seed
             1, library gains, the whole trial) on the card against the
             CPU, the CPU's run in a child process at the same time;
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
             (cut at 30 s) on the card against the CPU (in a child
             process, at the same time);
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
24. serve  — a journaled one-worker `SwarmService` (`max_batch=4`, staged
             and pipelined, float32) serves eight n=1000 Sinkhorn
             rollouts of two tenants (`simform1000`'s points, 80 ticks
             in chunks of 20, two faulted), one n=1000 `assign` and one
             `simform1000` `gains` design: all complete; the rollouts
             equal a `staging=False` service's bit for bit; every K1
             and K2 call of the served run (the 4-row rollout rounds,
             the faulted rows' masked costs among them, and the assign)
             against its plain version; each rollout bit-identical to
             the same request served alone (digests, q, final `v2f`);
             the postmortem of its journal (every request complete and
             gap-free under its result's trace id and chunk count,
             `--all` exit 0); requests per second, ms per round, each
             round stage's share, launches, peak memory;
25. serve_preempt — one slot, a one-chunk quantum: two contending
             rollouts preempted through the codec every chunk, equal to
             their uncontended runs (`serve`'s lone serves) bit for bit;
26. serve_failover — two workers, the rollout bucket's owner killed at
             its round 2: one migration, bit-identical to the uncontended
             run;
27. serve_recovery — `python -m aclswarm_torch.serve.smoke --n 1000`:
             the serving process SIGKILLed at round 3, its journal
             recovered by a second process, zero losses, a bit-identical
             digest;
28. serve_wire — a journaled `max_batch=2` service with the health tier
             behind one `WireServer` on TCP and shm: `serve`'s roll0
             over TCP (dropped after its second chunk, reattached by
             request id) and roll1 over shm, submitted together, each
             equal to its lone serve bit for bit (digests, q, final
             `v2f`); every K1 and K2 call against its plain version;
             `stats` and `health` over each transport, `watch --tcp`
             exit 0, the journal's postmortem; ms per round, the wire's
             share of each request, frames and bytes per transport;
29. serve_watch — `serve.smoke --postmortem --n 1000` and
             `--multiworker --n 1000` side by side, both PASS (the
             journal-only timeline of a migrated request; a worker kill
             fired, journaled, on `health`, and replayed alike by
             `watch --log`);
30. serve_procs — `serve.smoke --procs --n 1000`: a router over two
             procworker processes (each its own CUDA context), the one
             holding the rollout SIGKILLed mid-flight and respawned, then
             a rolling restart: PASS (zero losses, the migrated digest
             equal to the in-parent run's, new pids, a gap-free fleet
             postmortem); the children's boot seconds, detection ms,
             failover and restart seconds and launches (K1 > 0, K3 0),
             each child on the library `build` left;
31. bridge — the planner daemon (`interop.bridge --n 1000 --assignment
             sinkhorn`) on the card, driven over the shm rings by this
             process as operator (`simform1000` without gains: the daemon
             designs them) and vehicles, 360 ticks, then a KILL: every
             tick equal bit for bit to an in-process `TorchPlanner` fed
             the decoded stream, whose K1 and K2 calls hold against their
             plain versions; zero distcmd from the KILL; `swarm6_3d` card
             against CPU; boot seconds, design ms, ms per tick through
             the wire and in process, frames and bytes per ring;
32. offline — the offline tools: (a) the `trial` configuration flown
             again in a child process with checkpoints every chunk,
             SIGKILLed at the first chunk boundary after the dispatch and
             its first auction, resumed here to the watchdog: verdict,
             every transition tick, the FSM times, the CSV row and every
             leaf of the final `SimState` bit for bit the `trial` phase's
             run, K3 once per resumed tick and K1 = K2 = the resumed
             auctions, each kernel's first call against its plain
             version; the child's boot seconds, the checkpoint's bytes
             and write ms, the resume's seconds. While the child flies:
             (b) `resilience.smoke` (its n=5 child SIGKILLed and resumed,
             PASS); (c) libgen then precalc in float64 on the card on a
             scratch copy of the library: all twelve designs validate,
             each within 1e-9 of the shipped gains, the rest of the file
             equal, the shipped file untouched; (d) a ground-truth CBAA
             rollout at n=1000 (task blocks of 64, an auction every 30
             ticks, 61 ticks) recorded, through the npz, each record
             replayed to its `v2f_new` bit for bit; `swarm15`'s formations
             on their sparse graph and the complete graph, 24 records, each
             replayed on the card and by the sequential oracle: every
             decision equal, at least 90% valid. Then (e) `timing_stats`
             of one n=1000 K1 solve within [the `kernels` phase's K1 ms,
             2x it + 0.5 ms], and `timing.trace` (in a process of its own)
             naming K1's kernel;
33. audit — the analysis tier on the card: (a) the trace audit of all
             29 entry points at the tier-1 grid (n=5, B=2, one point per
             solver, faulted and flooded), each call under
             `torch.cuda.set_sync_debug_mode("warn")`: its synchronizing
             calls at or below the entry's declared budget, the second
             identical call dispatching the first's ATen op stream and
             kernel launches, no float64 leaf, K1 and K2 launched at the
             sinkhorn point and K3 at the flooded one; (b) the main path,
             `simform1000_flooded` at n=1000 in float32, 20 ticks from a
             fresh start under the same counter, one `sim.rollout` per
             tick: syncs per ordinary and per auction tick within the
             rollout's per-tick budget (`trace_audit.TICK_SYNCS`); (c)
             `lint`, `--concurrency` and `--protocol` over
             `aclswarm_torch/` with 0 violations each, and the model
             checker's default configuration with P1-P5 holding. The serve
             phases' journals (`serve`, `serve_wire`, and the drills of
             `serve_recovery`, `serve_watch` and `serve_procs`, kept with
             ``ACLSWARM_KEEP_JOURNALS``) are refined against the protocol
             (`analysis.model.refine_dir`, a process fleet's slots as
             fragments) in their own phases; this phase reports the
             journals, requests and events refined;
34. the `kernels` line, then the result line. Each kernel row carries the
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
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# (`trials._host_signals`); an auction tick adds none (`geometry.align`
# takes its rotation in closed form on the card)
CHUNK_READS = 2
# offline: precalc's float64 designs on the card against the shipped
# gains (the library's twelve formations with gains: swarm4 2, swarm6_3d
# 3, swarm6_sparse 2, grid9 2, swarm15 3; swarm100 ships none)
PRECALC_ATOL = 1e-9
PRECALC_DESIGNS = 12
# offline: the replayed CBAA rollouts — an auction every 30 ticks; at
# full width 61 ticks (three auctions), at n=15 120 ticks a rollout (six
# rollouts, 24 records)
REPLAY_EVERY = 30
REPLAY_TICKS = 61
REPLAY_SMALL_TICKS = 120
REPLAY_SMALL_RECORDS = 20
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
    """The kernels (`ops.build`: one nvcc per source, in parallel) and,
    beside them, the native wire library (``make -C native``: the shm
    rings the wire phases serve over). Either failing fails the run."""
    from aclswarm_torch import ops
    from aclswarm_torch.interop import native

    t0 = time.perf_counter()
    make = subprocess.Popen(
        ["make", "-C", str(Path(__file__).resolve().parent / "native")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log = ops.build()
    finally:
        make_out, _ = make.communicate(timeout=300)
    if make.returncode != 0 or not native.available():
        raise RuntimeError(f"make -C native failed (exit {make.returncode})"
                           f":\n{make_out}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": log["library"], "cached": log["cached"],
          "native_library": str(native._LIB_PATH),
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


def phase_auction(seed: int) -> dict:
    """The auction LAP at n=1000, float32, on the slice's own start and
    formation. The benefit matrix is computed once on the card and copied:
    two math libraries' distances may differ in the last bit. Returns the
    benefit matrix and the CPU's result on it (`phase_slice_auction`'s
    first auction solves the same matrix)."""
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
    return {"benefit": benefit, "cpu": cpu}


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


def phase_slice_auction(seed: int, auction_phase: dict) -> dict:
    """The same start under the engine's default assignment, and the
    default `SimConfig()` at n=6 on the card against the CPU. Each auction
    the rollout solves is kept (`auction.auction_lap`'s input and result);
    one that ran out of rounds must equal the CPU's on its benefit matrix
    — the `auction` phase's CPU result when the matrix is that phase's
    (tick 0 starts from the same state), else solved here."""
    from aclswarm_torch import ops, sim
    from aclswarm_torch.assignment import auction
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
    solved = []

    def kept(benefit, **kw):
        res = lap(benefit, **kw)
        solved.append((benefit, res))
        return res

    ops.reset_launches()
    with _patched(auction, "auction_lap", kept) as lap:
        run = _rollout_in_pieces(state, formation, gains, sparams, cfg)
    launches = dict(ops.LAUNCHES)
    final = run["final"]
    finite = all(bool(torch.isfinite(t).all())
                 for t in (final.swarm.q, final.swarm.vel, final.goal.pos))
    # an auction that ran out of rounds holds the assignment, as in the
    # reference; it must then equal the CPU's on the same benefit matrix
    iters = []
    for before, (benefit, card) in zip(run["befores"], solved):
        iters.append(int(card.iters))
        if not bool(card.valid):
            reuse = torch.equal(benefit, auction_phase["benefit"])
            cpu = (auction_phase["cpu"] if reuse
                   else auction.auction_lap(benefit.cpu()))
            same = _same_auction(card, cpu)
            emit({"phase": "slice_auction",
                  "invalid_auction_at_tick": before.tick,
                  "cpu_from_auction_phase": reuse, **same})
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
            and len(solved) == 2 and not any(launches.values())):
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


def _device_counts(events) -> dict:
    """Device-to-host copies, kernel launches and busy ms of a profiled
    window's device activity, given as (name, duration in ns)."""
    kernels = [ns for name, ns in events
               if "Memcpy" not in name and "Memset" not in name]
    return {"host_reads": sum("Memcpy DtoH" in name for name, _ in events),
            "kernel_launches": len(kernels),
            "device_busy_ms": sum(kernels) / 1e6}


def _window_counts(prof, both: bool = False) -> dict:
    """A stopped profiler's device activity (`_device_counts`), read from
    its raw activity records (building `prof.events()` costs tens of
    microseconds an event, seconds for a chunk of a batched trial's
    ~160,000 launches). With ``both`` the counts are also taken from
    `prof.events()`, as before, and must be the same: copies and
    launches equal, busy ms within 1e-6 relative (ns against float us)."""
    from torch.autograd import DeviceType

    counts = _device_counts(
        [(e.name(), e.duration_ns())
         for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA])
    if both:
        old = _device_counts([(e.name, e.time_range.elapsed_us() * 1e3)
                              for e in prof.events()
                              if e.device_type == DeviceType.CUDA])
        counts["from_events"] = old
        if (old["host_reads"] != counts["host_reads"]
                or old["kernel_launches"] != counts["kernel_launches"]
                or not math.isclose(old["device_busy_ms"],
                                    counts["device_busy_ms"],
                                    rel_tol=1e-6)):
            raise AssertionError("a profiled window's raw activity records "
                                 f"and prof.events() disagree: {counts}")
    return counts


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
        # the first window is counted from both sources (`_window_counts`)
        self.windows[self._prof_label] = _window_counts(
            self._prof, both=not self.windows)
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


# the CPU half of `_card_and_cpu_trial`, run in a child process: the
# TrialConfig as JSON in, the FSM's state, times and transitions and the
# wall seconds out
_CPU_TRIAL = """
import json, sys
import chip_smoke
from aclswarm_torch.harness import trials
fsm, probe, wall = chip_smoke._fly_trial(
    trials.TrialConfig(**json.loads(sys.argv[1])))
print(json.dumps({"state": fsm.state, "times": fsm.times,
                  "transitions": probe.transitions, "wall": wall}))
"""


def _card_and_cpu_trial(cfg) -> tuple:
    """``cfg`` flown on the card here while a child process flies it on
    the CPU (the host's cores are idle under a card trial): ((state,
    times, transitions, wall) on the card, the same on the CPU), the
    transitions as [state, tick] lists."""
    child = subprocess.Popen(
        [sys.executable, "-c", _CPU_TRIAL,
         json.dumps(dataclasses.asdict(dataclasses.replace(
             cfg, device="cpu")))], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)
    try:
        fsm, probe, wall = _fly_trial(dataclasses.replace(cfg,
                                                          device="cuda"))
        out, err = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"the CPU trial failed (exit "
                             f"{child.returncode}):\n{err[-4000:]}")
    cpu = json.loads(out.strip().splitlines()[-1])
    return ((fsm.state, fsm.times, [list(t) for t in probe.transitions],
             wall),
            (cpu["state"], cpu["times"], cpu["transitions"], cpu["wall"]))


def _mean(xs):
    return float(np.mean(xs)) if xs else None


def _row_digest(row) -> str:
    """A CSV row's digest (its n distances are too long to print)."""
    import hashlib

    return hashlib.sha256(np.asarray(row, np.float64).tobytes()).hexdigest()


def _trial_cfg(seed: int):
    """The `trial` configuration: `TRIAL_ROW` in float32 on the card,
    ``trial_timeout`` cut to `TRIAL_TIMEOUT_CUT`."""
    from aclswarm_torch.harness import trials

    return trials.TrialConfig(**dict(TRIAL_ROW,
                                     trial_timeout=TRIAL_TIMEOUT_CUT),
                              seed=seed, trials=1, verbose=False,
                              device="cuda", dtype="float32")


def phase_trial(seed: int) -> dict:
    """The `simform1000_flooded` row flown as a trial through the port's
    `run_trial` on the card in float32, `trial_timeout` cut to
    `TRIAL_TIMEOUT_CUT`: takeoff, hover, one dispatch (ADMM on the card in
    the n-4 bucket, x 0.15) and the Sinkhorn auctions after it
    (`_check_trial`). Then the whole `swarm6_3d` trial (seed 1, library
    gains, float32) on the card against the CPU (`_card_and_cpu_trial`):
    the same verdict and states, the transition ticks side by side."""
    from aclswarm_torch.harness import trials

    info = _check_trial(_trial_cfg(seed))

    # a small trial, card against CPU: the same verdict and FSM states
    small = trials.TrialConfig(formation="swarm6_3d", seed=1, trials=1,
                               verbose=False, dtype="float32")
    ((c_state, c_times, c_tr, c_wall),
     (h_state, h_times, h_tr, h_wall)) = _card_and_cpu_trial(small)
    same_ticks = c_tr == h_tr
    emit({"phase": "trial", "check": "swarm6_3d seed 1 float32, card vs CPU",
          "verdict": trials.NAMES[c_state],
          "verdict_cpu": trials.NAMES[h_state],
          "transitions": [[s, t, th] for (s, t), (_, th) in zip(c_tr, h_tr)]
          if [s for s, _ in c_tr] == [s for s, _ in h_tr]
          else {"card": c_tr, "cpu": h_tr},
          "transition_ticks_equal": same_ticks,
          "times": c_times, "times_cpu": h_times,
          "wall_seconds": c_wall, "wall_seconds_cpu": h_wall,
          "cpu_in_a_child_process": True})
    if not (c_state == h_state
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
    from aclswarm_torch import convert, gains, ops
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
    # two copies per chunk (`trials._host_signals`)
    reads_ok = [w["host_reads"] <= CHUNK_READS
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
    # kept for `offline`, which holds a killed and resumed run to it
    info["final_state"] = convert.sim_state_to_numpy(final)
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.stop()
        self.windows[len(self.chunks) - 1] = _window_counts(self._prof)
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
    reads_ok = [w["host_reads"] <= CHUNK_READS
                for w in probe.windows.values()]
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
    uniform and normal draws on the card equal the CPU's bit for bit (the
    sensor noise, 3*10^6 normals, and a (1000, 3) draw). Timings as
    `faults`, and each axis draw alone."""
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

    # card against CPU: uniforms and normals bit for bit
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

    normals_equal = normal_card_cpu == 0.0 and all(
        dz[k]["elements_differing"] == 0 for k in ("noise", "gust"))
    auctions = -(-SCENARIO_TICKS // cfg.assign_every)
    info = {"phase": "slice_scenarios", "n": N, "batch": B,
            "ticks": SCENARIO_TICKS, "dtype": "float32", "families": names,
            "scen_events": events, "ms_per_batched_tick": ms_per_tick,
            "launches": launches, "auctions": auctions, **traced,
            "axis_draws": draws, "uniform_card_equal_cpu": uniform_equal,
            "normal_max_abs_dz_card_vs_cpu": normal_card_cpu,
            "normal_card_equal_cpu": normals_equal,
            "scenario_draw_max_abs_dz_card_vs_cpu": dz,
            "no_scenario_equal_none": no_scenario_equal,
            "v2f_permutations": perms, "finite": finite,
            "max_memory_allocated_bytes": peak}
    emit(info)
    if not (all(e > 0 for e in events) and uniform_equal and normals_equal
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
    ((c_state, _, c_tr, c_wall),
     (h_state, _, h_tr, h_wall)) = _card_and_cpu_trial(small)
    emit({"phase": "trial_scenarios",
          "check": "swarm6_3d seed 1 float32 wind_gust, card vs CPU",
          "verdict": trials.NAMES[c_state],
          "verdict_cpu": trials.NAMES[h_state],
          "transitions": c_tr, "transitions_cpu": h_tr,
          "transition_ticks_equal": c_tr == h_tr,
          "wall_seconds": c_wall, "wall_seconds_cpu": h_wall,
          "cpu_in_a_child_process": True})
    if not (c_state == h_state
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


def _path_kernel_calls(run, names=("sinkhorn_log", "round_dominant",
                                    "flood_merge")) -> dict:
    """``run()`` with the inputs of every call the path makes to each
    kernel wrapper of ``names`` kept (cloned on the card), each beside the
    launches that call made."""
    from aclswarm_torch import ops

    seen = {}
    with contextlib.ExitStack() as stack:
        for name in names:
            def keep(*args, _name=name, _wrapped=getattr(ops, name)):
                before = ops.LAUNCHES[_name]
                out = _wrapped(*args)
                seen.setdefault(_name, []).append((
                    [a.clone() if isinstance(a, torch.Tensor) else a
                     for a in args], ops.LAUNCHES[_name] - before))
                return out
            stack.enter_context(_patched(ops, name, keep))
        run()
    missing = set(names) - set(seen)
    if missing:
        raise AssertionError(f"the path launched no {sorted(missing)}")
    return seen


def _hold_path_kernels(label, run, rtol=0.0) -> dict:
    """K1, K2 and K3 against their plain versions on the first inputs the
    path hands them in ``run()`` (`_check_sinkhorn`, `_check_rounding`,
    `_check_flood`: K1 within 5e-5 + ``rtol`` |plain| with masses within
    1e-4 of the plain version's, K2 and K3 bit for bit), each launched as
    often as the path launched it."""
    return _hold_first_calls(label, _path_kernel_calls(run), rtol)


def _hold_first_calls(label, seen: dict, rtol=0.0) -> dict:
    """`_hold_path_kernels` on the calls `_path_kernel_calls` kept."""
    (cost, tau, iters), k1_launches = seen["sinkhorn_log"][0]
    (plan, *rounds_cap), _ = seen["round_dominant"][0]
    (packed, comm, *_), _ = seen["flood_merge"][0]
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
    `CHUNK_READS` (counted by wrapping
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
    bounded = [r <= CHUNK_READS for c, r in zip(chunks, reads_per_chunk)
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



# ---------------------------------------------------------------------------
# the serving layer (`aclswarm_torch.serve`) at n=1000

# 80 ticks (four chunks): the depth the card budget leaves (PERF.md §4,
# cell 10); every check of the serve phases holds at it
SERVE_ROLLOUT = dict(n=N, ticks=80, chunk_ticks=20, assign_every=20,
                     assignment="sinkhorn")
# the rollouts fly `simform1000`'s points (shipped in the request): the
# serve default formation is a radius-3 circle whose 1000 points lie 1.9
# cm apart, a generator of near-tied assignments (PERF.md §6)
# the drop and the rejoin inside the horizon, an auction (every 20 ticks)
# after each
SERVE_FAULTS = dict(dropout_frac=0.1, drop_tick=20, rejoin_tick=60)
SERVE_FAULTED = (1, 6)         # which of the eight rollouts carry faults
SERVE_STAGES = ("pack", "stack", "dispatch", "device_sync", "unpack",
                "resolve")


@functools.lru_cache(maxsize=None)
def _simform_spec(seed: int):
    """`simform1000`'s first formation, read through the trial driver's
    formation loader in the suite's boxes."""
    from aclswarm_torch.harness import trials

    cfg = trials.TrialConfig(formation=f"simform{N}", device="cuda",
                             sim_l=SUITE["sim_l"], sim_w=SUITE["sim_w"],
                             sim_h=SUITE["sim_h"],
                             sim_min_dist=SUITE["sim_min_dist"])
    return trials._formations_for_trial(cfg, seed)[0]


def _serve_rollouts(seed: int) -> list:
    """The eight n=1000 Sinkhorn rollout requests of two tenants, flying
    `simform1000`'s points: (kind, params, tenant, request_id)."""
    points = _simform_spec(seed).points
    out = []
    for i in range(8):
        p = dict(SERVE_ROLLOUT, seed=seed + i, points=points)
        if i in SERVE_FAULTED:
            p["faults"] = dict(SERVE_FAULTS)
        out.append(("rollout", p, "ab"[i % 2], f"roll{i}"))
    return out


def _serve_singles(seed: int) -> list:
    """The n=1000 `assign` (Sinkhorn: K1, K2) and the `gains` design of
    `simform1000`'s points and graph, from a third tenant."""
    spec = _simform_spec(seed)
    return [("assign", {"n": N, "seed": seed, "solver": "sinkhorn"}, "c",
             "assign"),
            ("gains", {"n": N, "points": spec.points,
                       "adjmat": spec.adjmat}, "c", "gains")]


def _serve(reqs, **cfg):
    """``reqs`` through one `SwarmService` on the card: every result by
    id, the wall seconds from the first submit to each result, and the
    service (closed)."""
    from aclswarm_torch.serve import ServiceConfig, SwarmService

    svc = SwarmService(ServiceConfig(**cfg), start=False)
    t0 = time.perf_counter()
    tickets = {rid: svc.submit(k, p, tenant=t, request_id=rid)
               for k, p, t, rid in reqs}
    svc.start()
    results, walls = {}, {}
    for rid, tk in tickets.items():
        results[rid] = tk.result(timeout=600)
        walls[rid] = time.perf_counter() - t0
    svc.close()
    bad = {rid: (r.status, r.error) for rid, r in results.items()
           if not r.ok}
    if bad:
        raise AssertionError(f"serve: requests did not complete: {bad}")
    return results, walls, svc


def _round_stats(svc) -> dict:
    """Rollout rounds of one service from its spans: count, ms per round,
    mean batch, each stage's share of the round time."""
    rounds = [sp for sp in svc.telemetry.recorder.spans()
              if sp.name == "serve.round"
              and sp.attrs.get("bucket") == "rollout"]
    total = sum(sp.dur_s for sp in rounds)
    stages = {st: svc.telemetry.histogram(
        f"span_serve.round.{st}_s").to_row()["sum"] for st in SERVE_STAGES}
    return {"rollout_rounds": len(rounds),
            "ms_per_round": total / max(1, len(rounds)) * 1e3,
            "mean_batch": sum(sp.attrs["batch"] for sp in rounds)
            / max(1, len(rounds)),
            "stage_share": {k: v / total for k, v in stages.items()},
            "rounds_all": svc.stats["rounds"]}


def _same_digests(label, got: dict, want: dict) -> None:
    for rid, w in want.items():
        g = got[rid]
        if not (g.value["digest"] == w.value["digest"]
                and g.value["chunk_digests"] == w.value["chunk_digests"]
                and np.array_equal(g.value["q"], w.value["q"])):
            raise AssertionError(
                f"{label}: {rid} digest {g.value['digest']:#x} != "
                f"{w.value['digest']:#x}")


def _final_rows(calls: list, q: np.ndarray):
    """The v2f of the batch row whose final positions are ``q`` bit for
    bit, among the recorded `batched_rollout` outputs of one run."""
    for q_dev, v2f_dev in calls:
        qs = q_dev.cpu().numpy()
        for b in range(len(qs)):
            if np.array_equal(qs[b], q):
                return v2f_dev[b].cpu().numpy()
    raise AssertionError("serve: no recorded batch row ends at the "
                         "result's positions")


@contextlib.contextmanager
def _recorded_rollouts(calls: list):
    """`sim.batched_rollout` with each call's final positions and `v2f`
    appended to ``calls`` (the service's results carry no `v2f`)."""
    from aclswarm_torch import sim

    real = sim.batched_rollout

    def recording(*a, **kw):
        out, m = real(*a, **kw)
        calls.append((out.swarm.q, out.v2f))
        return out, m

    with _patched(sim, "batched_rollout", recording):
        yield


def _serve_alone(rolls: list) -> tuple[dict, dict, dict]:
    """Each rollout request served alone (`max_batch=1`, its own service):
    the results, each one's recorded batch outputs and seconds."""
    results, calls, seconds = {}, {}, {}
    for r in rolls:
        calls[r[3]] = []
        t0 = time.perf_counter()
        with _recorded_rollouts(calls[r[3]]):
            results.update(_serve([r], max_batch=1)[0])
        seconds[r[3]] = time.perf_counter() - t0
    return results, calls, seconds


def _served_kernels(held: dict) -> dict:
    """Every K1 and K2 call of a served run against its plain version:
    K1 within 5e-5 + 2^-22 |plain| on a batch (the faulted rows' masked
    costs, as `faults`) and 5e-5 on a lone plan, masses within 1e-4; K2
    bit for bit. A summary per kernel."""
    k1 = [_check_sinkhorn(f"serve: K1 call {i}", cost, tau, iters, launches,
                          0.0 if cost.ndim == 2 else 2.0**-22)
          for i, ((cost, tau, iters), launches)
          in enumerate(held["sinkhorn_log"])]
    k2 = [_check_rounding(f"serve: K2 call {i}", plan, *cap)
          for i, ((plan, *cap), _) in enumerate(held["round_dominant"])]
    return {"k1": {"calls": len(k1),
                   "shapes": sorted({tuple(c["shape"]) for c in k1}),
                   "launches": sum(c["launches"] for c in k1),
                   "max_abs_err": max(c["max_abs_err"] for c in k1),
                   "mass_err_vs_plain": max(c["mass_err_vs_plain"]
                                            for c in k1)},
            "k2": {"calls": len(k2),
                   "shapes": sorted({tuple(c["shape"]) for c in k2}),
                   "bit_identical": all(c["bit_identical"] for c in k2),
                   "max_rounds": max(int(np.max(c["rounds"]))
                                     for c in k2)}}


def phase_serve(seed: int) -> dict:
    """A journaled single-worker `SwarmService` (max_batch=4, staged and
    pipelined, float32) serves eight n=1000 Sinkhorn rollouts of two
    tenants (seeds S..S+7, two faulted), one n=1000 `assign` and one
    `simform1000` `gains` design. Held: all complete; the rollouts equal
    a ``staging=False`` service's bit for bit; every K1 and K2 call of the
    served run, on the inputs the path handed it (the 4-row rollout
    rounds, the faulted rows' masked costs among them, and the assign),
    against its plain version (`_served_kernels`); each rollout equal to
    the same request served alone (max_batch=1) bit for bit: digest, every
    chunk's digest, q and the final `v2f`. Reported: requests per second,
    ms per rollout round, rounds, mean batch, each round stage's share,
    launches, peak memory. Returns the lone serves too, which
    `serve_preempt` and `serve_failover` take as their uncontended runs."""
    import tempfile

    from aclswarm_torch import ops

    rolls = _serve_rollouts(seed)
    reqs = rolls + _serve_singles(seed)
    calls, served = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp, _recorded_rollouts(calls):
        ops.reset_launches()
        held = _path_kernel_calls(
            lambda: served.update(zip(("res", "walls", "svc"), _serve(
                reqs, max_batch=4, journal_dir=tmp))),
            ("sinkhorn_log", "round_dominant"))
        launches = dict(ops.LAUNCHES)
        postmortem = _journal_postmortem("serve", tmp, served["res"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res, walls, svc = served["res"], served["walls"], served["svc"]
    wall = max(walls.values())
    roll_wall = max(walls[r[3]] for r in rolls)
    info = {"phase": "serve", "n": N, "dtype": "float32", "max_batch": 4,
            "requests": len(reqs), "launches": launches,
            "wall_s": wall, "requests_per_s": len(reqs) / wall,
            "rollout_wall_s": roll_wall,
            "rollouts_per_s": len(rolls) / roll_wall,
            "single_s": {rid: walls[rid] for rid in ("assign", "gains")},
            "peak_gb": peak_gb,
            # the kernel inputs kept for the checks below live on the card
            # through the run and count in its peak
            "held_inputs_gb": sum(a.nbytes for kept in held.values()
                                  for args, _ in kept for a in args
                                  if isinstance(a, torch.Tensor)) / 1e9,
            **_round_stats(svc), "preempted": svc.stats["preempted"],
            "chunks": svc.stats["chunks"], "postmortem": postmortem}
    emit(info)
    if not (launches["sinkhorn_log"] > 0 and launches["round_dominant"] > 0
            and launches["flood_merge"] == 0):
        raise AssertionError(f"serve launches: {launches}")

    kernels = _served_kernels(held)
    del held
    if not any(len(s) == 3 and s[0] == 4 for s in kernels["k1"]["shapes"]):
        raise AssertionError(f"serve: no 4-row K1 call held: {kernels}")

    # the pack-at-round-time path, same rollouts, same batches
    legacy, lwalls, lsvc = _serve(rolls, max_batch=4, staging=False)
    _same_digests("serve: staged vs staging=False",
                  res, {r[3]: legacy[r[3]] for r in rolls})
    legacy_info = {"rollout_wall_s": max(lwalls.values()),
                   **_round_stats(lsvc)}

    # each rollout against the same request served alone, bit for bit
    alone, alone_calls, alone_s = _serve_alone(rolls)
    _same_digests("serve: batched vs alone", res, alone)
    solo = {rid: bool(np.array_equal(
        _final_rows(calls, res[rid].value["q"]),
        _final_rows(alone_calls[rid], alone[rid].value["q"])))
        for _, _, _, rid in rolls}
    out = {"phase": "serve_checks", "legacy": legacy_info,
           "kernels": kernels, "alone_v2f_equal": solo,
           "alone_s": alone_s,
           "gains_shape": list(res["gains"].value["gains"].shape)}
    emit(out)
    if not all(solo.values()):
        raise AssertionError(f"serve: final v2f differ from alone: {solo}")
    g = res["gains"].value["gains"]
    if g.shape != (3 * N, 3 * N) or not np.isfinite(g).all():
        raise AssertionError(f"serve: gains {g.shape}")
    info.update(out)
    alone_v2f = {rid: _final_rows(alone_calls[rid], alone[rid].value["q"])
                 for _, _, _, rid in rolls}
    return {**info, "alone": alone, "alone_v2f": alone_v2f}


def _alone(seed: int, serve: dict | None, ids) -> tuple[dict, float]:
    """The uncontended runs of the rollouts ``ids`` (by index) and their
    seconds: `serve`'s lone serves, or served alone here."""
    rolls = [r for i, r in enumerate(_serve_rollouts(seed)) if i in ids]
    if serve is None:
        want, _, seconds = _serve_alone(rolls)
    else:
        want = {r[3]: serve["alone"][r[3]] for r in rolls}
        seconds = {r[3]: serve["alone_s"][r[3]] for r in rolls}
    return want, sum(seconds.values())


def phase_serve_preempt(seed: int, serve: dict | None) -> dict:
    """One batch slot, a one-chunk quantum: two contending n=1000 Sinkhorn
    rollouts (one faulted) are preempted through the checkpoint codec at
    every chunk and finish bit-identical to each served uncontended
    (max_batch=1, alone: `serve`'s lone serves)."""
    from aclswarm_torch import ops

    rolls = [r for i, r in enumerate(_serve_rollouts(seed)) if i in (0, 1)]
    want, alone_s = _alone(seed, serve, (0, 1))
    ops.reset_launches()
    t0 = time.perf_counter()
    got, _, svc = _serve(rolls, max_batch=1, quantum_chunks=1)
    contended_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    info = {"phase": "serve_preempt", "launches": launches,
            "preemptions": {rid: r.preemptions for rid, r in got.items()},
            "uncontended_s": alone_s, "contended_s": contended_s,
            **_round_stats(svc)}
    emit(info)
    if not all(r.preemptions > 0 for r in got.values()):
        raise AssertionError(f"serve_preempt: no preemption: {info}")
    _same_digests("serve_preempt", got, want)
    return info


def phase_serve_failover(seed: int, serve: dict | None) -> dict:
    """Two workers; a worker-targeted `CrashPlan` kills the owner of the
    rollout bucket at its round 2 (one chunk checkpointed, the next in
    flight). Zero losses; the rollout migrates through the checkpoint
    codec and ends bit-identical to its uncontended run (`serve`'s lone
    serve)."""
    import tempfile

    from aclswarm_torch import ops
    from aclswarm_torch.resilience import crash
    from aclswarm_torch.serve import bucket_of, place_slot

    roll = _serve_rollouts(seed)[0]
    want, _ = _alone(seed, serve, (0,))
    slot = place_slot(bucket_of("rollout", roll[1]), [0, 1])
    ops.reset_launches()
    t0 = time.perf_counter()
    crash.arm(crash.CrashPlan(f"serve.w{slot}", 2, "raise"))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            got, _, svc = _serve([roll], workers=2, max_batch=1,
                                 quantum_chunks=8, journal_dir=tmp,
                                 supervise_poll_s=0.02, rejoin_base_s=0.3)
    finally:
        crash.arm(None)
    info = {"phase": "serve_failover", "launches": dict(ops.LAUNCHES),
            "seconds": time.perf_counter() - t0, "killed_worker": slot,
            "failovers": got[roll[3]].failovers,
            "service_failovers": svc.stats["failovers"],
            "requeued": svc.stats["requeued"]}
    emit(info)
    if got[roll[3]].failovers < 1 or svc.stats["requeued"] < 1:
        raise AssertionError(f"serve_failover: no migration: {info}")
    _same_digests("serve_failover", got, want)
    return info


def phase_serve_recovery(seed: int) -> dict:
    """`python -m aclswarm_torch.serve.smoke --n 1000` on the card (its
    rollout assigns by Sinkhorn): the child SIGKILLed at serve round 3 with a
    chunk durable and the next in flight, a second child recovering the
    journal, zero losses and a bit-identical final digest against an
    uninterrupted run."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="aclswarm_keep_") as keep:
        r = subprocess.run([sys.executable, "-m",
                            "aclswarm_torch.serve.smoke", "--n", str(N)],
                           capture_output=True, text=True, timeout=600,
                           env=_kept_journals_env(keep))
        seconds = time.perf_counter() - t0
        line = next((json.loads(ln) for ln in r.stdout.splitlines()
                     if ln.startswith('{"serve_smoke"')), None)
        if r.returncode != 0 or "PASS" not in r.stdout or line is None:
            raise AssertionError(f"serve_recovery failed (exit "
                                 f"{r.returncode}):\n{r.stdout}\n"
                                 f"{r.stderr[-4000:]}")
        refined = _refine("serve_recovery", keep)
    launches = {k: sum(part.get(k, 0) for part in line["launches"].values())
                for k in ("sinkhorn_log", "round_dominant", "flood_merge")}
    info = {"phase": "serve_recovery", "seconds": seconds,
            "launches": launches, "smoke": line, "refined": refined}
    emit(info)
    if not launches["sinkhorn_log"] or launches["flood_merge"]:
        raise AssertionError(f"serve_recovery launches: {launches}")
    return info


def _journal_postmortem(label: str, journal: str, results: dict) -> dict:
    """`telemetry.postmortem` over a served journal, from disk alone: every
    request of ``results`` complete and gap-free (chunk coverage without a
    hole, duplicate executions bit-identical, the terminal event last),
    under one trace id equal to its result's, with its result's chunk
    count; ``postmortem --all`` exits 0; and the journal refines against
    the serve protocol (`_refine`)."""
    import io

    from aclswarm_torch.telemetry import postmortem

    rep = postmortem.reconstruct(journal)
    bad = {}
    for rid, res in results.items():
        row = rep["requests"].get(rid)
        if row is None or not (row["complete"] and row["gap_free"]
                               and row["trace_id"] == res.trace_id
                               and row["chunks"] == res.chunks):
            bad[rid] = row and {k: row[k] for k in (
                "complete", "gap_free", "trace_id", "chunks", "problems")}
    with contextlib.redirect_stdout(io.StringIO()):
        cli_rc = postmortem.main([journal, "--all"])
    out = {"requests": len(results), "reconstructed": rep["reconstructed"],
           "complete": rep["complete"], "gap_free": rep["gap_free"],
           "events": rep["events"], "torn_tail": rep["torn_tail"],
           "duplicate_chunks": sum(r["duplicate_chunks"]
                                   for r in rep["requests"].values()),
           "all_exit": cli_rc}
    if bad or cli_rc != 0:
        raise AssertionError(f"{label}: postmortem failed: {bad} {out}")
    out["refined"] = _refine(label, journal)
    return out


@contextlib.contextmanager
def _counted_frames(counts: dict):
    """Every frame sent on a TCP or shm channel counted with its bytes,
    by transport (both ends live in this process: each frame counts once,
    at its sender)."""
    from aclswarm_torch.interop import transport

    def counting(cls, kind):
        real = cls.send_bytes

        def send(self, data, *a, **kw):
            ok = real(self, data, *a, **kw)
            if ok:
                c = counts.setdefault(kind, {"frames": 0, "bytes": 0})
                c["frames"] += 1
                c["bytes"] += len(data)
            return ok
        return send

    with _patched(transport.SocketChannel, "send_bytes",
                  counting(transport.SocketChannel, "tcp")), \
            _patched(transport.Channel, "send_bytes",
                     counting(transport.Channel, "shm")):
        yield


def _wedge(client) -> None:
    """The client stops reading and pinging, its socket left open: a
    dropped client the server has not noticed yet (the reattach path)."""
    client._stop.set()
    client._thread.join(5)


def phase_serve_wire(seed: int, serve: dict | None) -> dict:
    """The wire front end on the card: one journaled `SwarmService`
    (max_batch=2, staged, float32, the health tier on) behind one
    `WireServer` on TCP (port 0) and on one shm channel at once. Two of
    `serve`'s n=1000 rollouts (roll0 by a TCP `WireClient`, roll1, the
    faulted one, by a shm `WireClient`) are submitted together before the
    worker starts, so they share rounds. Held: each result equals its lone
    serve from `serve` bit for bit (digest, every chunk's digest, q, the
    final `v2f`); the TCP client drops after its second chunk, reattaches
    by request id under its client id and gets that same result; a
    `stats` and a `health` scrape over each transport; ``python -m
    aclswarm_torch.telemetry.watch --tcp HOST:PORT`` exits 0; every K1
    and K2 call against its plain version (`_served_kernels`); the
    journal's postmortem. Reported: ms per round, the wire's share of each
    request (submit-to-result wall less the service's accept-to-terminal
    latency), frames and bytes per transport, launches."""
    import tempfile
    import uuid

    from aclswarm_torch import ops
    from aclswarm_torch.serve import ServiceConfig, SwarmService
    from aclswarm_torch.serve.wire import WireClient, WireServer

    rolls = [r for i, r in enumerate(_serve_rollouts(seed)) if i in (0, 1)]
    (_, p_tcp, t_tcp, rid_tcp), (_, p_shm, t_shm, rid_shm) = rolls
    if serve is None:
        want, want_calls, _ = _serve_alone(rolls)
        want_v2f = {rid: _final_rows(want_calls[rid], want[rid].value["q"])
                    for rid in want}
    else:
        want = {r[3]: serve["alone"][r[3]] for r in rolls}
        want_v2f = {r[3]: serve["alone_v2f"][r[3]] for r in rolls}
    base = "asw-chipwire-" + uuid.uuid4().hex[:8]
    calls, frames, walls, got, scrapes = [], {}, {}, {}, {}
    torch.cuda.synchronize()
    ops.reset_launches()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, _recorded_rollouts(calls), \
            _counted_frames(frames):
        svc = SwarmService(ServiceConfig(max_batch=2, journal_dir=tmp,
                                         watch=True), start=False)
        srv = WireServer(svc, base, tcp=("127.0.0.1", 0))
        host, port = srv.tcp_address
        tcp = WireClient(tcp=(host, port), tenant=t_tcp,
                         client_id="chip-tcp", hello_timeout_s=60.0)
        shm = WireClient(base, tenant=t_shm, hello_timeout_s=60.0)
        clients = {"shm": shm}
        try:
            def drive():
                t0 = time.perf_counter()
                tk_tcp = tcp.submit("rollout", p_tcp, request_id=rid_tcp)
                tk_shm = shm.submit("rollout", p_shm, request_id=rid_shm)
                deadline = time.monotonic() + 120
                while svc.stats["accepted"] < 2 \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
                if svc.stats["accepted"] < 2:
                    raise AssertionError("serve_wire: submits not accepted")
                svc.start()
                # the TCP client drops after its second chunk event ...
                seen = [ev.payload["chunk"]
                        for _, ev in zip(range(2),
                                         tk_tcp.stream(timeout=600))]
                if seen != [0, 1]:
                    raise AssertionError(f"serve_wire: TCP events {seen}")
                _wedge(tcp)
                # ... and a new connection under its client id reattaches
                clients["tcp"] = WireClient(
                    tcp=(host, port), tenant=t_tcp, client_id="chip-tcp",
                    hello_timeout_s=60.0)
                got[rid_tcp] = clients["tcp"].submit(
                    "rollout", p_tcp, request_id=rid_tcp).result(600)
                walls[rid_tcp] = time.perf_counter() - t0
                got[rid_shm] = tk_shm.result(timeout=600)
                walls[rid_shm] = time.perf_counter() - t0
            held = _path_kernel_calls(drive, ("sinkhorn_log",
                                              "round_dominant"))
            launches = dict(ops.LAUNCHES)
            accepted = svc.stats["accepted"]      # one execution each
            for label, cli in clients.items():
                st = cli.submit("stats", {"format": "prometheus"}).result(120)
                hl = cli.submit("health", {}).result(120)
                scrapes[label] = {
                    "stats_ok": st.ok and "serve_accepted_total"
                    in st.value["text"],
                    "health_ok": hl.ok and hl.value["watch_enabled"]
                    and hl.value["workers"]["up"] == 1}
            watch = subprocess.run(
                [sys.executable, "-m", "aclswarm_torch.telemetry.watch",
                 "--tcp", f"{host}:{port}"], capture_output=True,
                text=True, timeout=120, cwd=Path(__file__).resolve().parent)
            scrapes["watch_tcp_exit"] = watch.returncode
        finally:
            tcp._c2s.close()          # the wedged client's socket
            for cli in clients.values():
                cli.close()
            srv.close()
            svc.close()
        postmortem = _journal_postmortem("serve_wire", tmp, got)
    seconds = time.perf_counter() - t_phase
    bad = {rid: (r.status, r.error) for rid, r in got.items() if not r.ok}
    if bad:
        raise AssertionError(f"serve_wire: requests failed: {bad}")
    info = {"phase": "serve_wire", "n": N, "dtype": "float32",
            "max_batch": 2, "seconds": seconds, "launches": launches,
            **_round_stats(svc),
            "wire_share": {rid: {"wall_s": walls[rid],
                                 "service_s": got[rid].latency_s,
                                 "wire_s": walls[rid] - got[rid].latency_s}
                           for rid in got},
            "frames": frames, "scrapes": scrapes,
            "watch_tcp_stdout": watch.stdout[-2000:],
            "watch_tcp_stderr": watch.stderr[-2000:],
            "postmortem": postmortem,
            "reattached": {"client_id": "chip-tcp", "request_id": rid_tcp,
                           "reconnects": svc.telemetry.counter(
                               "wire_reconnects_total").value,
                           "accepted": accepted}}
    emit(info)
    _same_digests("serve_wire: wire vs alone", got, want)
    v2f_equal = {rid: bool(np.array_equal(
        _final_rows(calls, got[rid].value["q"]), want_v2f[rid]))
        for rid in got}
    kernels = _served_kernels(held)
    del held
    out = {"phase": "serve_wire_checks", "alone_v2f_equal": v2f_equal,
           "kernels": kernels}
    emit(out)
    if not (all(v2f_equal.values())
            and all(v for k, sc in scrapes.items() if k != "watch_tcp_exit"
                    for v in sc.values())
            and scrapes["watch_tcp_exit"] == 0
            and info["reattached"]["reconnects"] >= 1
            and info["reattached"]["accepted"] == 2
            and info["rollout_rounds"] > 0 and info["mean_batch"] > 1.0
            and launches["sinkhorn_log"] > 0
            and launches["round_dominant"] > 0
            and launches["flood_merge"] == 0
            and frames.get("tcp") and frames.get("shm")):
        raise AssertionError(f"serve_wire check failed: {info} {out}")
    info.update(out)
    return info


def phase_serve_watch(seed: int) -> dict:
    """The health-tier drills on the card, as subprocesses side by side:
    ``python -m aclswarm_torch.serve.smoke --postmortem --n 1000`` (a
    worker killed mid-rollout, the migrated request's timeline rebuilt
    from the journal alone) and ``--multiworker --n 1000`` (the kill
    fires a ``worker_up`` alert, journaled and on the ``health`` surface,
    and ``watch --log`` over the persisted ``timeseries.log`` replays the
    transitions the live engine journaled). Both must print PASS."""
    t0 = time.perf_counter()
    # one kept-journal root per drill: siblings under one root would be
    # refined as one fleet's slots
    keeps = {flag: tempfile.mkdtemp(prefix="aclswarm_keep_")
             for flag in ("--postmortem", "--multiworker")}
    procs = {flag: subprocess.Popen(
        [sys.executable, "-m", "aclswarm_torch.serve.smoke", flag,
         "--n", str(N)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=Path(__file__).resolve().parent,
        env=_kept_journals_env(keeps[flag]))
        for flag in ("--postmortem", "--multiworker")}
    outs, seconds, refined = {}, {}, {}
    try:
        for flag, pr in procs.items():
            out, err = pr.communicate(timeout=600)
            outs[flag] = (pr.returncode, out, err)
            seconds[flag] = time.perf_counter() - t0
        for flag, (rc, _, _) in outs.items():
            if rc == 0:
                refined[flag] = _refine(f"serve_watch{flag}", keeps[flag])
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        for keep in keeps.values():
            shutil.rmtree(keep, ignore_errors=True)
    lines = {flag: next((json.loads(ln) for ln in out.splitlines()
                         if ln.startswith('{"serve_smoke"')), None)
             for flag, (_, out, _) in outs.items()}
    info = {"phase": "serve_watch", "seconds": time.perf_counter() - t0,
            "drill_seconds": seconds, "drills": lines, "refined": refined,
            "pass": {flag: next((ln for ln in out.splitlines()
                                 if ln.startswith("PASS")), None)
                     for flag, (_, out, _) in outs.items()}}
    for flag, (rc, out, err) in outs.items():
        if rc != 0 or info["pass"][flag] is None or lines[flag] is None:
            emit(info)
            raise AssertionError(f"serve_watch {flag} failed (exit {rc}):"
                                 f"\n{out}\n{err[-4000:]}")
    info["launches"] = {k: sum(ln["launches"].get(k, 0)
                               for ln in lines.values())
                        for k in ("sinkhorn_log", "round_dominant",
                                  "flood_merge")}
    emit(info)
    if not info["launches"]["sinkhorn_log"] \
            or info["launches"]["flood_merge"]:
        raise AssertionError(f"serve_watch launches: {info['launches']}")
    return info


def phase_serve_procs(seed: int) -> dict:
    """`python -m aclswarm_torch.serve.smoke --procs --n 1000` on the card:
    a router over two procworker processes, each with its own CUDA
    context, the one holding the n=1000 Sinkhorn rollout SIGKILLed
    mid-flight, the slot respawned, a rolling restart. The drill must
    print PASS (zero losses, the migrated digest equal to the uncontended
    in-parent run's, new pids after the restart, a gap-free fleet
    postmortem); the children's K1 launches (each child's last heartbeat)
    must be > 0 and K3's 0, and every child that launched a kernel must
    have loaded the library `build` left (no rebuild)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="aclswarm_keep_") as keep:
        r = subprocess.run([sys.executable, "-m",
                            "aclswarm_torch.serve.smoke", "--procs", "--n",
                            str(N)], capture_output=True, text=True,
                           timeout=900, cwd=Path(__file__).resolve().parent,
                           env=_kept_journals_env(keep))
        seconds = time.perf_counter() - t0
        line = next((json.loads(ln) for ln in r.stdout.splitlines()
                     if ln.startswith('{"serve_smoke"')), None)
        if r.returncode != 0 or "PASS" not in r.stdout or line is None:
            raise AssertionError(f"serve_procs failed (exit "
                                 f"{r.returncode}):\n{r.stdout}\n"
                                 f"{r.stderr[-4000:]}")
        refined = _refine("serve_procs", keep)
    launches = line["launches"]["children"]
    rebuilt = {uid: c["library"] for uid, c in line["child_launches"].items()
               if any(c["launches"].values())
               and not c["library"].get("cached")}
    info = {"phase": "serve_procs", "seconds": seconds,
            "launches": launches, "refined": refined,
            "boot_s": {b["uid"]: b["boot_s"] for b in line["boots"]},
            "detect_ms": line["detect_ms"],
            "failover_s": line["failover_s"],
            "readmit_s": line["readmit_s"],
            "restart_s": line["restart_s"],
            "child_launches": {uid: c["launches"] for uid, c
                               in line["child_launches"].items()},
            "reference_launches": line["launches"]["reference"],
            "pass": next(ln for ln in r.stdout.splitlines()
                         if ln.startswith("PASS"))}
    emit(info)
    if not launches["sinkhorn_log"] or launches["flood_merge"] or rebuilt:
        raise AssertionError(f"serve_procs launches: {launches}, children "
                             f"that rebuilt the library: {rebuilt}")
    return info


BRIDGE_TICKS = 360          # three auctions (ticks 0, 120, 240)
BRIDGE_AFTER_KILL = 5       # ticks served after the KILL: all zero
BRIDGE_SMALL_TICKS = 240    # swarm6_3d, card against the CPU
# swarm6_3d card against CPU, float32 both: the assignment and the
# avoidance flags equal, distcmd within 1e-5 + 1e-5 |cpu| (the card's
# float32 roots and reductions in control round otherwise than the CPU's)
BRIDGE_SMALL_TOL = (1e-5, 1e-5)


def _open_rings(ns: str, proc, log, deadline_s: float) -> dict:
    """The daemon's seven rings, opened as it creates them; ``log`` is
    the file that holds the daemon's standard error."""
    from aclswarm_torch.interop.bridge import CHANNELS
    from aclswarm_torch.interop.transport import Channel

    chans = {}
    t_end = time.monotonic() + deadline_s
    for name in CHANNELS:
        while True:
            try:
                chans[name] = Channel(f"{ns}-{name}")
                break
            except OSError:
                if proc.poll() is not None or time.monotonic() > t_end:
                    for c in chans.values():
                        c.close()
                    shm = subprocess.run(["df", "-B1", "/dev/shm"],
                                         capture_output=True,
                                         text=True).stdout
                    log.seek(0)
                    raise AssertionError(
                        f"bridge: ring {ns}-{name} never opened (daemon "
                        f"exit {proc.poll()}; df /dev/shm:\n{shm})\n"
                        f"{log.read()[-4000:]}")
                time.sleep(0.05)
    return chans


def _bridge_small(seed: int) -> dict:
    """`swarm6_3d` (library gains, Sinkhorn every 120 ticks) through two
    in-process planners, on the card and on the CPU in float32, fed one
    estimate stream (integrated from the CPU's commands) for 240 ticks:
    equal assignments and flags, distcmd within `BRIDGE_SMALL_TOL`."""
    from aclswarm_torch.harness import formgen
    from aclswarm_torch.interop.operator import Operator
    from aclswarm_torch.interop.planner import TorchPlanner

    fmsg = Operator("swarm6_3d").next_formation()
    planners = [TorchPlanner(6, assignment="sinkhorn", assign_every=120,
                             device=dev) for dev in ("cuda", "cpu")]
    for pl in planners:
        pl.handle_formation(fmsg)
    rng = np.random.default_rng(seed)
    q = formgen.sample_cylinder_points(rng, 6, 10.0, 10.0, 0.0, 1.5)
    q[:, 2] = 1.5
    vel = np.zeros((6, 3))
    atol, rtol = BRIDGE_SMALL_TOL
    err, excess, assignments, mismatch = 0.0, -math.inf, 0, []
    for k in range(BRIDGE_SMALL_TICKS):
        card, cpu = (pl.tick(q, vel=vel) for pl in planners)
        same_asn = (card.assignment is None) == (cpu.assignment is None) \
            and (cpu.assignment is None
                 or np.array_equal(card.assignment, cpu.assignment))
        assignments += cpu.assignment is not None
        d = np.abs(card.distcmd.astype(np.float64) - cpu.distcmd)
        err = max(err, float(d.max()))
        excess = max(excess, float((d - atol - rtol
                                    * np.abs(cpu.distcmd)).max()))
        if not (same_asn and np.array_equal(card.safety, cpu.safety)):
            mismatch.append(k)
        vel += (0.01 / 0.15) * (cpu.distcmd - vel)
        q = q + vel * 0.01
    info = {"ticks": BRIDGE_SMALL_TICKS, "assignments": assignments,
            "max_abs_err": err, "tolerance": [atol, rtol],
            "mismatched_ticks": mismatch[:10]}
    if mismatch or excess > 0.0 or not assignments:
        raise AssertionError(f"bridge: swarm6_3d card against CPU: {info}")
    return info


def phase_bridge(seed: int) -> dict:
    """The planner daemon on the card at full width: ``python -m
    aclswarm_torch.interop.bridge --n 1000 --assignment sinkhorn`` as a
    subprocess; this process plays the operator (`simform1000`'s points
    and graph WITHOUT gains — the daemon designs them on the card — then
    a GO) and the vehicles: VehicleEstimates in, distcmd out, integrated
    on the host (velocity tracking, tau 0.15 s), 360 ticks (three
    auctions), then a KILL (distcmd zero from that tick), five ticks and
    the shutdown sentinel. Held: the decoded message stream, fed to an
    in-process `TorchPlanner` on the card, gives every tick's distcmd,
    flags and published assignment bit for bit; every K1 call of that
    planner within 5e-5 + 2^-22 |plain| of its plain version and every K2
    call bit-identical; the daemon's launches K1 = K2 = 3, K3 = 0; and
    `swarm6_3d` card against CPU (`_bridge_small`, run while the daemon
    boots). Reported: the daemon's boot seconds, the design's ms, ms per
    tick through the wire and in process, frames and bytes per channel."""
    from aclswarm_torch.harness import formgen
    from aclswarm_torch.interop import codec
    from aclswarm_torch.interop import messages as m
    from aclswarm_torch.interop.bridge import SHUTDOWN
    from aclswarm_torch.interop.planner import TorchPlanner
    from aclswarm_torch.interop.transport import send_bytes_reliable

    shm = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                         text=True).stdout
    emit({"phase": "bridge", "df_dev_shm": shm.strip().splitlines()})
    spec = _simform_spec(seed)
    ns = f"/asw-chip-{os.getpid()}"
    dt, tau = 0.01, 0.15
    log = tempfile.TemporaryFile("w+")
    t0 = time.perf_counter()
    daemon = subprocess.Popen(
        [sys.executable, "-m", "aclswarm_torch.interop.bridge", "--n",
         str(N), "--ns", ns, "--assignment", "sinkhorn", "--assign-every",
         "120", "--idle-timeout", "300"], stdout=subprocess.PIPE,
        stderr=log, text=True, cwd=Path(__file__).resolve().parent)
    chans = {}
    sent = []          # (ring, decoded message) in send order
    wire_ms, ticks = [], []
    try:
        # the small card-against-CPU check runs while the daemon boots
        # (a few seconds against its ~6-10; boot_s is exact while it is
        # the shorter)
        small = _bridge_small(seed)
        small["seconds"] = time.perf_counter() - t0
        chans = _open_rings(ns, daemon, log, 300.0)
        boot_s = time.perf_counter() - t0

        def send(name, msg):
            raw = codec.encode(msg)
            if not send_bytes_reliable(chans[name], raw, grace_s=60.0):
                raise AssertionError(f"bridge: {name} ring full")
            sent.append((name, codec.decode(raw)))

        send("formation", m.Formation(
            header=m.Header(seq=1), name=spec.name, points=spec.points,
            adjmat=np.asarray(spec.adjmat, np.uint8), gains=None))
        send("flightmode", m.FlightMode(header=m.Header(seq=2),
                                        mode=m.MODE_GO))
        rng = np.random.default_rng(seed)
        q = formgen.sample_cylinder_points(rng, N, SUITE["init_area_w"],
                                           SUITE["init_area_h"], 0.0,
                                           SUITE["sim_min_dist"])
        q[:, 2] = 1.0
        vel = np.zeros((N, 3))
        for k in range(BRIDGE_TICKS + BRIDGE_AFTER_KILL):
            if k == BRIDGE_TICKS:
                send("flightmode", m.FlightMode(header=m.Header(seq=3),
                                                mode=m.MODE_KILL))
            t1 = time.perf_counter()
            send("estimates", m.VehicleEstimates(
                header=m.Header(seq=k + 1, stamp=k * dt), positions=q,
                stamps=np.full(N, k * dt)))
            cmd, t_end = None, time.monotonic() + 300
            while cmd is None:
                cmd = chans["distcmd"].recv()
                if cmd is None:
                    if daemon.poll() is not None \
                            or time.monotonic() > t_end:
                        raise AssertionError(
                            f"bridge: no distcmd at tick {k} (daemon exit "
                            f"{daemon.poll()})")
                    time.sleep(0.0002)
            wire_ms.append((time.perf_counter() - t1) * 1e3)
            asn = safe = None
            while (x := chans["assignment"].recv()) is not None:
                asn = x
            while (x := chans["safety"].recv()) is not None:
                safe = x
            if cmd.header.seq != k + 1 or safe is None \
                    or safe.header.seq != k + 1:
                raise AssertionError(f"bridge: tick {k} out of step")
            ticks.append((cmd.vel.copy(), safe.active.astype(bool),
                          None if asn is None else asn.perm.copy()))
            vel += (dt / tau) * (cmd.vel - vel)
            q = q + vel * dt
        send("formation", m.Formation(
            header=m.Header(), name=SHUTDOWN, points=spec.points,
            adjmat=np.asarray(spec.adjmat, np.uint8)))
        out = daemon.communicate(timeout=120)[0]
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        for c in chans.values():
            c.close()
        log.seek(0)
        err = log.read()
        log.close()
    report = next((json.loads(ln)["bridge"] for ln in out.splitlines()
                   if ln.startswith('{"bridge"')), None)
    if daemon.returncode != 0 or report is None \
            or f"bridge served {len(ticks)} ticks" not in out:
        raise AssertionError(f"bridge daemon failed (exit "
                             f"{daemon.returncode}):\n{out}\n{err[-4000:]}")
    killed = ticks[BRIDGE_TICKS:]
    if any(np.any(v != 0.0) for v, _, _ in killed):
        raise AssertionError("bridge: distcmd not zero after the KILL")

    # the same decoded stream through an in-process planner on the card
    planner = TorchPlanner(N, assignment="sinkhorn", assign_every=120)
    local, design_ms, local_ms = [], [], []

    def replay():
        for name, msg in sent:
            if name == "formation" and msg.name != SHUTDOWN:
                t1 = time.perf_counter()
                planner.handle_formation(msg)
                torch.cuda.synchronize()
                design_ms.append((time.perf_counter() - t1) * 1e3)
            elif name == "flightmode":
                planner.handle_flightmode(msg)
            elif name == "estimates":
                t1 = time.perf_counter()
                local.append(planner.tick(msg))
                local_ms.append((time.perf_counter() - t1) * 1e3)

    seen = _path_kernel_calls(replay, names=("sinkhorn_log",
                                             "round_dominant"))
    differ = [k for k, ((v, sf, asn), o) in enumerate(zip(ticks, local))
              if not (np.array_equal(v, o.distcmd.astype(np.float64))
                      and np.array_equal(sf, o.safety)
                      and (asn is None) == (o.assignment is None)
                      and (asn is None or np.array_equal(asn,
                                                         o.assignment)))]
    k1 = [_check_sinkhorn(f"bridge: K1 call {i}", cost, tau_, iters,
                          launches, 2.0**-22)
          for i, ((cost, tau_, iters), launches)
          in enumerate(seen["sinkhorn_log"])]
    k2 = [_check_rounding(f"bridge: K2 call {i}", plan, *cap)
          for i, ((plan, *cap), _) in enumerate(seen["round_dominant"])]
    auction = set(range(0, BRIDGE_TICKS, 120))
    steady = [i for i in range(1, BRIDGE_TICKS) if i not in auction]
    info = {"phase": "bridge", "boot_s": boot_s,
            "ticks": len(ticks), "assignments": sum(
                a is not None for _, _, a in ticks),
            "daemon_design_ms": report["commit_ms"],
            "inprocess_design_ms": design_ms,
            "wire_ms_per_tick": float(np.mean([wire_ms[i] for i in steady])),
            "wire_ms_auction_tick": [wire_ms[i] for i in sorted(auction)],
            "daemon_tick_ms": report["tick_ms"],
            "inprocess_ms_per_tick": float(np.mean([local_ms[i]
                                                    for i in steady])),
            "inprocess_ms_auction_tick": [local_ms[i]
                                          for i in sorted(auction)],
            "channels": report["channels"], "launches": report["launches"],
            "differing_ticks": differ[:10],
            "k1": {"calls": len(k1),
                   "max_abs_err": max(c["max_abs_err"] for c in k1),
                   "mass_err_vs_plain": max(c["mass_err_vs_plain"]
                                            for c in k1)},
            "k2": {"calls": len(k2),
                   "bit_identical": all(c["bit_identical"] for c in k2)}}
    emit(info)
    if differ:
        raise AssertionError(f"bridge: the wire's ticks differ from the "
                             f"in-process planner's at {differ[:10]}")
    want = {"sinkhorn_log": len(auction), "round_dominant": len(auction),
            "flood_merge": 0}
    if report["launches"] != want or len(k1) != len(auction):
        raise AssertionError(f"bridge launches {report['launches']}, "
                             f"in-process K1 calls {len(k1)}; want {want}")
    info["swarm6_3d"] = small
    emit({"phase": "bridge", "swarm6_3d": small})
    return info


# ---------------------------------------------------------------------------
# offline: the crash-resume smoke at full width, the library tools, the
# auction replay and the timer

# the child of `offline` (a): the `trial` configuration with checkpoints,
# SIGKILLed by `ACLSWARM_CRASH`; prints one JSON line when it is ready, at
# each FSM transition and at each checkpoint (its bytes, and the ms of the
# state's host copy and of the write), flushed before the kill
_KILLED_TRIAL = """
import json, sys, time
import torch
from aclswarm_torch import convert
from aclswarm_torch.harness import supervisor, trials
from aclswarm_torch.resilience import checkpoint as ckptlib

def out(**kw):
    print(json.dumps(kw), flush=True)

cfg = trials.TrialConfig(**json.loads(sys.argv[1]))
if cfg.device == "cuda":
    torch.cuda.init()
out(ready=time.time())
to_numpy, write = convert.sim_state_to_numpy, ckptlib.write_checkpoint
next_state = supervisor.TrialFSM._next_state
copy_ms = []

def timed_to_numpy(state):
    t0 = time.perf_counter()
    arrays = to_numpy(state)
    copy_ms.append((time.perf_counter() - t0) * 1e3)
    return arrays

def timed_write(directory, stem, payload, manifest, keep=2):
    t0 = time.perf_counter()
    path = write(directory, stem, payload, manifest, keep)
    out(chunk=manifest["chunk"], bytes=path.stat().st_size,
        state_copy_ms=copy_ms[-1], write_ms=(time.perf_counter() - t0) * 1e3)
    return path

def logged_next_state(fsm, state, reset=True):
    out(transition=[supervisor.NAMES[state], fsm.tick_count])
    return next_state(fsm, state, reset)

convert.sim_state_to_numpy = timed_to_numpy
ckptlib.write_checkpoint = timed_write
supervisor.TrialFSM._next_state = logged_next_state
trials.run_trial(cfg, 0)
out(finished=True)
"""


def _start_killed_trial(cfg, kill_at: int, ckpt_dir: str):
    """``cfg`` with checkpoints every chunk into ``ckpt_dir``, in a child
    process armed to be SIGKILLed at chunk boundary ``kill_at``: (the
    child, its stderr file, the spawn time)."""
    from aclswarm_torch.resilience.crash import ENV_VAR

    child_cfg = dataclasses.replace(cfg, checkpoint_dir=ckpt_dir,
                                    checkpoint_every=1)
    err = tempfile.TemporaryFile("w+")
    t0 = time.time()
    child = subprocess.Popen(
        [sys.executable, "-c", _KILLED_TRIAL,
         json.dumps(dataclasses.asdict(child_cfg))],
        stdout=subprocess.PIPE, stderr=err, text=True,
        cwd=Path(__file__).resolve().parent,
        env=dict(os.environ, **{ENV_VAR: f"trial:{kill_at}:kill"}))
    return child, err, t0


def _killed_trial_lines(child, err, t0: float, timeout: float) -> dict:
    """Wait for the child of `_start_killed_trial`; raise unless it died
    by SIGKILL. Returns its boot seconds (spawn to ready), its seconds in
    all, its transitions and its checkpoint lines."""
    import signal

    try:
        out, _ = child.communicate(timeout=timeout)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        err.seek(0)
        tail = err.read()[-4000:]
        err.close()
    seconds = time.time() - t0
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    if child.returncode != -signal.SIGKILL or not lines \
            or "ready" not in lines[0] or any("finished" in x for x in lines):
        raise AssertionError(f"offline: the trial child exited "
                             f"{child.returncode}, expected "
                             f"{-signal.SIGKILL} (SIGKILL):\n{out}\n{tail}")
    return {"boot_s": lines[0]["ready"] - t0, "seconds": seconds,
            "transitions": [x["transition"] for x in lines
                            if "transition" in x],
            "checkpoints": [x for x in lines if "chunk" in x]}


def _tree_diff(a, b, path: str = "") -> list:
    """The leaves (by path) where two nested dicts of arrays differ in
    presence, dtype, shape or any bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) \
                or set(a) != set(b):
            return [path or "."]
        return [d for k in sorted(a)
                for d in _tree_diff(a[k], b[k], f"{path}.{k}")]
    if a is None or b is None:
        return [] if a is None and b is None else [path]
    a, b = np.asarray(a), np.asarray(b)
    same = a.dtype == b.dtype and a.shape == b.shape and (
        a.tobytes() == b.tobytes())
    return [] if same else [path]


def _resume_killed_trial(cfg, ckpt_dir: str, kill_at: int, trial: dict,
                         child: dict) -> dict:
    """Resume ``cfg`` from the checkpoint the killed child left in
    ``ckpt_dir`` in this process, to the watchdog, with every K1, K2 and
    K3 call kept: the verdict, the transition ticks (the child's, then the
    resumed run's), the FSM times, the CSV row and every leaf of the final
    `SimState` must equal ``trial`` (the uninterrupted run's `_check_trial`
    result) bit for bit; K3 once per resumed tick, K1 = K2 = the resumed
    auctions, each kernel's first call held against its plain version."""
    from aclswarm_torch import convert, ops
    from aclswarm_torch.harness import trials
    from aclswarm_torch.resilience import checkpoint as ckptlib

    left = ckptlib.latest_checkpoint(ckpt_dir, "trial00000")
    if left is None:
        raise AssertionError("offline: the killed child left no checkpoint")
    _, man = ckptlib.load_checkpoint(left)
    cuda = cfg.device == "cuda"
    resume_cfg = dataclasses.replace(cfg, checkpoint_dir=ckpt_dir,
                                     checkpoint_every=1)
    flown = {}

    def resume():
        flown["fsm"], flown["probe"], flown["wall"] = _fly_trial(resume_cfg)

    ops.reset_launches()
    seen = _path_kernel_calls(resume) if cuda else resume()
    launches = dict(ops.LAUNCHES)
    held = _hold_first_calls("offline: resumed trial", seen) if cuda \
        else None
    fsm, probe = flown["fsm"], flown["probe"]
    ticks = sum(c["ticks"] for c in probe.chunks)
    auctions = int(probe.auctioned)
    transitions = child["transitions"] + [list(t) for t in
                                          probe.transitions]
    want_transitions = [list(t) for t in trial["transitions"]]
    state_diff = _tree_diff(convert.sim_state_to_numpy(probe.final_state),
                            trial["final_state"])
    info = {"phase": "offline", "check": "the trial SIGKILLed in a child "
            "and resumed here, against the uninterrupted `trial` run",
            "kill_boundary": kill_at, "checkpoint": left.name,
            "checkpoint_chunk": int(man["chunk"]),
            "checkpoint_ticks_done": int(man["ticks_done"]),
            "verdict": trials.NAMES[fsm.state],
            "verdict_uninterrupted": trial["verdict"],
            "transitions_equal": transitions == want_transitions,
            "times_equal": list(fsm.times) == list(trial["times"]),
            "csv_row_equal": _row_digest(fsm.csv_row(0))
            == trial["csv_digest"],
            "final_state_leaves_differing": state_diff,
            "resumed_chunks": len(probe.chunks), "resumed_ticks": ticks,
            "resumed_auctions": auctions, "launches": launches,
            "resume_seconds": flown["wall"],
            "kernels_held": held}
    emit(info)
    ok = (int(man["chunk"]) == kill_at
          and info["verdict"] == trial["verdict"]
          and info["transitions_equal"] and info["times_equal"]
          and info["csv_row_equal"] and not state_diff and auctions >= 1
          and probe.chunks[0]["tick0"] > 0)
    if cuda:
        ok = ok and (launches["flood_merge"] == ticks
                     and launches["sinkhorn_log"] == auctions
                     and launches["round_dominant"] == auctions)
    if not ok:
        raise AssertionError(f"offline: the resumed trial differs from the "
                             f"uninterrupted run: {info}")
    return info


def _resilience_smoke() -> dict:
    """`resilience.smoke.run_smoke()` on the card, as its user runs it:
    its n=5 child SIGKILLed at boundary 1, resumed, compared bit for bit;
    the check is its PASS line."""
    import io

    from aclswarm_torch.resilience import smoke

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = smoke.run_smoke()
    lines = buf.getvalue().strip().splitlines()
    info = {"phase": "offline", "check": "resilience.smoke on the card",
            "rc": rc, "lines": lines,
            "seconds": time.perf_counter() - t0}
    emit(info)
    if rc != 0 or not lines or not lines[-1].startswith("PASS"):
        raise AssertionError(f"offline: resilience.smoke failed: {info}")
    return info


def _library_gains(lib: dict) -> tuple[dict, dict]:
    """(the parsed library without its gains, {(group, formation name):
    gains})."""
    import copy

    lib = copy.deepcopy(lib)
    gains = {}
    for g, group in lib.items():
        if isinstance(group, dict):
            for f in group["formations"]:
                if "gains" in f:
                    gains[(g, f["name"])] = np.asarray(f.pop("gains"),
                                                       np.float64)
    return lib, gains


def _precalc_on_a_copy(device="cuda") -> dict:
    """libgen, then precalc in float64 on ``device``, on a scratch copy of
    the port's library: every design validates, each within
    `PRECALC_ATOL` of the shipped gains, the regenerated file equal to
    the shipped one outside its gains, and the shipped file untouched."""
    import shutil

    import yaml

    from aclswarm_torch.harness import formations, libgen, precalc

    shipped = formations.DEFAULT_LIBRARY.read_bytes()
    ship_rest, ship_gains = _library_gains(yaml.safe_load(shipped))
    with tempfile.TemporaryDirectory(prefix="aclswarm_precalc_") as d:
        lib = Path(d) / "formations.yaml"
        shutil.copy(formations.DEFAULT_LIBRARY, lib)
        t0 = time.perf_counter()
        libgen.extend_library(lib, verbose=False)
        designs = precalc.precalc(lib, verbose=False, device=device)
        seconds = time.perf_counter() - t0
        rest, written = _library_gains(yaml.safe_load(lib.read_text()))
    rows = []
    for x in designs:
        key = (x["group"], x["name"])
        rows.append({"formation": "/".join(key), "n": x["n"], "ms": x["ms"],
                     "valid": x["no_positive"] and x["kernel_ok"]
                     and x["strictly_negative_rest"],
                     "max_abs_err_vs_shipped": float(np.abs(
                         x["gains"] - ship_gains[key]).max()),
                     "written_max_abs_err": float(np.abs(
                         written[key] - ship_gains[key]).max())})
    untouched = formations.DEFAULT_LIBRARY.read_bytes() == shipped
    info = {"phase": "offline", "check": "libgen + precalc (float64) on a "
            "scratch copy of the library", "device": str(device),
            "designs": rows, "seconds": seconds,
            "max_abs_err": max(r["max_abs_err_vs_shipped"] for r in rows),
            "tolerance": PRECALC_ATOL,
            "equal_outside_gains": rest == ship_rest,
            "shipped_file_untouched": untouched}
    emit(info)
    if not (len(rows) == len(ship_gains) == PRECALC_DESIGNS
            and {(r["formation"]) for r in rows}
            == {"/".join(k) for k in ship_gains}
            and all(r["valid"] for r in rows)
            and info["max_abs_err"] <= PRECALC_ATOL
            and info["equal_outside_gains"] and untouched):
        raise AssertionError(f"offline: precalc check failed: {info}")
    return info


def _records_roundtrip(records: list) -> list:
    """`save_records` then `load_records` through a scratch file; raise
    unless every field of every record comes back equal, dtype too."""
    from aclswarm_torch.assignment import replay

    with tempfile.TemporaryDirectory(prefix="aclswarm_replay_") as d:
        path = Path(d) / "auctions.npz"
        replay.save_records(records, path)
        loaded = replay.load_records(path)
    bad = [(k, f.name) for k, (a, b) in enumerate(zip(records, loaded))
           for f in dataclasses.fields(replay.AuctionRecord)
           if not (np.asarray(getattr(a, f.name)).dtype
                   == getattr(b, f.name).dtype
                   and np.array_equal(getattr(a, f.name),
                                      getattr(b, f.name)))]
    if len(loaded) != len(records) or bad:
        raise AssertionError(f"offline: records changed through the npz: "
                             f"{len(records)} -> {len(loaded)}, {bad[:5]}")
    return loaded


def _replayed_v2f(valid: bool, f2v: np.ndarray,
                  v2f_prev: np.ndarray) -> np.ndarray:
    """The assignment the engine adopts from a replayed auction: the
    inverse of its consensus ``f2v`` when valid, else the current one."""
    v2f = np.array(v2f_prev)
    if valid:
        v2f[f2v] = np.arange(len(f2v), dtype=v2f.dtype)
    return v2f


def _replay_full_width(seed: int, device="cuda", n: int = N) -> dict:
    """A ground-truth CBAA rollout of `simform1000`'s points (task blocks
    of `ENGINE_CBAA`, an auction every `REPLAY_EVERY` ticks,
    `REPLAY_TICKS` ticks), its records through the npz, and each replayed
    by `replay_device` (its defaults: the dense consensus) to the recorded
    `v2f_new` bit for bit. The oracle cannot finish at this n."""
    from aclswarm_torch import sim
    from aclswarm_torch.assignment import replay

    dev = torch.device(device)
    formation, gains, sparams, state = problem(
        n, seed, dev, torch.float32, 2 * SUITE["init_radius"],
        localization=False, keepout_repulse_vel=KEEPOUT_REPULSE_VEL)
    cfg = sim.SimConfig(**dict(ENGINE_CBAA, localization="truth",
                               assign_every=REPLAY_EVERY))
    q0, v2f0 = state.swarm.q.clone(), state.v2f.clone()
    t0 = time.perf_counter()
    _, metrics = sim.rollout(state, formation, gains, sparams, cfg,
                             REPLAY_TICKS)
    records = replay.record_auctions(metrics, q0, v2f0, formation)
    rollout_s = time.perf_counter() - t0
    loaded = _records_roundtrip(records)
    out = []
    for rec in loaded:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        res = replay.replay_device(rec, device=dev)
        v2f = _replayed_v2f(bool(res.valid), res.f2v.cpu().numpy(),
                            rec.v2f_prev)
        out.append({
            "valid": bool(res.valid), "rounds": int(res.rounds),
            "ms": (time.perf_counter() - t1) * 1e3,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if dev.type == "cuda" else None),
            "reproduced": bool(np.array_equal(v2f, rec.v2f_new)),
            "reassigned": bool(not np.array_equal(rec.v2f_new,
                                                  rec.v2f_prev))})
    info = {"phase": "offline", "check": "replay at full width", "n": n,
            "ticks": REPLAY_TICKS, "assign_every": REPLAY_EVERY,
            "task_block": cfg.cbaa_task_block, "rollout_s": rollout_s,
            "records": len(loaded), "replays": out}
    emit(info)
    if len(loaded) != -(-REPLAY_TICKS // REPLAY_EVERY) \
            or not all(r["reproduced"] for r in out):
        raise AssertionError(f"offline: a full-width replay differs from "
                             f"its record: {info}")
    return info


def _replay_small(seed: int, device="cuda") -> dict:
    """`swarm15`'s three formations on their sparse graph (library gains)
    and on the complete graph (gains designed on ``device``), each a
    ground-truth CBAA rollout of `REPLAY_SMALL_TICKS` ticks on
    ``device`` in float32 with an auction every `REPLAY_EVERY`: every
    record through the npz, replayed by `replay_record` (the port's CBAA
    on ``device`` and the sequential oracle on the host) to its recorded
    `v2f_new`, every decision equal to the oracle's, at least 90% of the
    auctions valid (`tests/test_replay.py`)."""
    from aclswarm_torch import gains as gainslib
    from aclswarm_torch import sim
    from aclswarm_torch.assignment import replay
    from aclswarm_torch.core import types
    from aclswarm_torch.harness import formations, formgen

    dev = torch.device(device)
    specs = formations.load_group(None, "swarm15")
    n = specs[0].n
    fc = np.ones((n, n)) - np.eye(n)
    sparams = types.SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                                 bounds_max=(50.0, 50.0, 20.0))
    cfg = sim.SimConfig(assignment="cbaa", assign_every=REPLAY_EVERY)
    records, t0 = [], time.perf_counter()
    for k, (spec, graph) in enumerate([(s, "sparse") for s in specs]
                                      + [(s, "fc") for s in specs]):
        if graph == "sparse":
            adj, g = spec.adjmat, spec.gains
        else:
            adj = fc
            g = gainslib.solve_gains(np.asarray(spec.points, np.float64),
                                     fc, device=dev)
        formation = types.make_formation(spec.points, adj, g, device=dev)
        rng = np.random.default_rng(seed + k)
        q0 = rng.normal(size=(n, 3)) * 4 + [0, 0, 3]
        state = sim.init_state(q0, device=dev)
        q_start = state.swarm.q.clone()
        _, m = sim.rollout(state, formation, types.ControlGains(), sparams,
                           cfg, REPLAY_SMALL_TICKS)
        records += replay.record_auctions(m, q_start,
                                          np.arange(n, dtype=np.int32),
                                          formation)
    rollout_s = time.perf_counter() - t0
    loaded = _records_roundtrip(records)
    t0 = time.perf_counter()
    matched = reproduced = valid = 0
    for rec in loaded:
        out = replay.replay_record(rec, device=dev)
        matched += out["match"]
        valid += out["device_valid"]
        v2f = _replayed_v2f(out["device_valid"], out["device_f2v"],
                            rec.v2f_prev)
        reproduced += bool(np.array_equal(v2f, rec.v2f_new))
    info = {"phase": "offline", "check": "replay against the oracle",
            "n": n, "rollouts": 2 * len(specs),
            "ticks_each": REPLAY_SMALL_TICKS, "records": len(loaded),
            "match": matched, "reproduced": reproduced, "valid": valid,
            "rollout_s": rollout_s, "replay_s": time.perf_counter() - t0}
    emit(info)
    if not (len(loaded) >= REPLAY_SMALL_RECORDS
            and matched == reproduced == len(loaded)
            and valid >= 0.9 * len(loaded)):
        raise AssertionError(f"offline: replay against the oracle failed: "
                             f"{info}")
    return info


def _k1_cost(seed: int) -> torch.Tensor:
    """The first auction's normalized (n, n) cost, K1's main-path input
    (as `phase_kernels` builds it)."""
    from aclswarm_torch.core import geometry
    from aclswarm_torch.core import perm as permutil

    dev = torch.device("cuda")
    formation, _, _, state = problem(N, seed, dev, torch.float32,
                                     2 * SUITE["init_radius"])
    q = state.swarm.q
    p_al = geometry.align(formation.points,
                          permutil.veh_to_formation_order(q, state.v2f))
    raw = geometry.cdist_fast(q, p_al)
    return (raw / (torch.mean(raw) + 1e-12)).contiguous()


# `offline` (e)'s trace, in a process of its own: K1's cost from an .npy
# file, one warm solve, then `timing.trace` around one solve; one JSON
# line for the trace
_TRACE_K1 = """
import json, os, sys
import numpy as np, torch
from aclswarm_torch import ops
from aclswarm_torch.utils import timing

cost = torch.from_numpy(np.load(sys.argv[1])).cuda()
iters, logdir = int(sys.argv[2]), sys.argv[3]
timing.readback_sync(ops.sinkhorn_log(cost, 0.03, iters))
with timing.trace(logdir):
    timing.readback_sync(ops.sinkhorn_log(cost, 0.03, iters))
path = os.path.join(logdir, "trace.json")
with open(path) as f:
    events = json.load(f).get("traceEvents", [])
names = sorted({e.get("name", "") for e in events
                if "sinkhorn_persistent_kernel" in e.get("name", "")})
print(json.dumps({"trace_bytes": os.path.getsize(path),
                  "events": len(events), "k1_names": names}), flush=True)
"""


def _start_trace_child(cost: torch.Tensor, d: str):
    """`_TRACE_K1` on ``cost`` in a child process writing under ``d``:
    the profiler state of a fresh process (in this long one, CUPTI has
    lost a trace's kernel records; PERF.md, the offline phase)."""
    path = Path(d) / "k1_cost.npy"
    np.save(path, cost.cpu().numpy())
    return subprocess.Popen(
        [sys.executable, "-c", _TRACE_K1, str(path), str(SINKHORN_ITERS),
         str(Path(d) / "trace")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)


def _timing_checks(cost: torch.Tensor, k1_ms: float, tracer) -> dict:
    """`utils.timing` on one n=1000 K1 solve of ``cost``:
    `timing_stats(per=1, reps=5)`'s median within [the `kernels` phase's
    K1 ms, 2x it + 0.5 ms] (a timer that returned at dispatch would read
    microseconds), and `timing.trace` around one solve, in the process
    ``tracer`` (`_start_trace_child`), writing a Chrome trace that names
    K1's kernel."""
    from aclswarm_torch import ops
    from aclswarm_torch.utils import timing

    def solve(c):
        return ops.sinkhorn_log(c, 0.03, SINKHORN_ITERS)

    try:
        out, err = tracer.communicate(timeout=300)
    finally:
        if tracer.poll() is None:
            tracer.kill()
            tracer.wait()
    traced = [json.loads(ln) for ln in out.splitlines()
              if ln.startswith("{")]
    stats = timing.timing_stats(solve, cost, per=1, reps=5)
    median_ms = stats["median_s"] * 1e3
    info = {"phase": "offline", "check": "utils.timing on one K1 solve",
            "median_ms": median_ms, "min_ms": stats["min_s"] * 1e3,
            "max_ms": stats["max_s"] * 1e3, "reps": stats["reps"],
            "kernels_phase_k1_ms": k1_ms,
            "window_ms": [k1_ms, 2 * k1_ms + 0.5],
            "trace": traced[0] if traced else None}
    emit(info)
    if not (k1_ms <= median_ms <= 2 * k1_ms + 0.5 and tracer.returncode == 0
            and len(traced) == 1 and traced[0]["k1_names"]):
        raise AssertionError(f"offline: timing check failed: {info}\n"
                             f"{err[-3000:]}")
    return info


def phase_offline(seed: int, trial: dict, kernels: dict) -> dict:
    """The offline tools on the card. (a) The `trial` configuration flown
    again in a child process with checkpoints every chunk, SIGKILLed
    (`ACLSWARM_CRASH`) at the first chunk boundary after the dispatch and
    its first auction, then resumed here to the watchdog
    (`_resume_killed_trial`: bit for bit the `trial` phase's run, whose
    result ``trial`` is). While the child flies: (b)
    `resilience.smoke` as its user runs it, (c) libgen and precalc on a
    scratch copy of the library, (d) the auction replay at full width
    and against the oracle at n=15; and, in a process of its own, the
    trace of one K1 solve (`_start_trace_child`). After the resume: (e)
    the timer on one K1 solve against ``kernels``' K1 ms, and the trace's
    K1 kernel."""
    kill_at = trial["dispatch_chunks"][0] + 1
    cost = _k1_cost(seed)
    with tempfile.TemporaryDirectory(prefix="aclswarm_offline_") as d:
        child, err, t0 = _start_killed_trial(_trial_cfg(seed), kill_at, d)
        tracer = _start_trace_child(cost, d)
        try:
            smoke = _resilience_smoke()
            lib = _precalc_on_a_copy()
            full = _replay_full_width(seed)
            small = _replay_small(seed)
        except BaseException:
            for proc in (child, tracer):
                proc.kill()
                proc.wait()
            err.close()
            raise
        killed = _killed_trial_lines(child, err, t0, 900.0)
        ck = killed["checkpoints"]
        emit({"phase": "offline", "check": "the killed trial child",
              "kill_boundary": kill_at, "boot_s": killed["boot_s"],
              "child_seconds": killed["seconds"],
              "checkpoints": len(ck),
              "checkpoint_bytes": ck[-1]["bytes"] if ck else None,
              "checkpoint_state_copy_ms": [c["state_copy_ms"] for c in ck],
              "checkpoint_write_ms": [c["write_ms"] for c in ck],
              "checkpoint_write_ms_median": float(np.median(
                  [c["state_copy_ms"] + c["write_ms"] for c in ck]))
              if ck else None,
              "contended": "the child's boot, copies and writes were timed "
              "while (b)-(d) and the trace child ran on the same card and "
              "host"})
        if [c["chunk"] for c in ck] != list(range(1, kill_at + 1)):
            raise AssertionError(f"offline: the child checkpointed chunks "
                                 f"{[c['chunk'] for c in ck]}, expected "
                                 f"1..{kill_at}")
        resumed = _resume_killed_trial(_trial_cfg(seed), d, kill_at, trial,
                                       killed)
        timing = _timing_checks(cost, kernels["sinkhorn_log"]["ms"], tracer)
    return {"launches": resumed["launches"], "kill_boundary": kill_at,
            "child": killed, "resumed": resumed, "smoke": smoke,
            "precalc": lib, "replay": full, "replay_small": small,
            "timing": timing}


# journals the serve phases refined against the serve protocol
# (`_refine`), by phase; `audit` reports them
REFINED: dict = {}
# the audit's main path: ticks from a fresh start (tick 0 auctions)
AUDIT_TICKS = 20


def _refine(label: str, root: str) -> dict:
    """`analysis.model.refine_tree` over the journals under ``root``: every
    reconstructed request an accepted trace of the serve protocol (a
    process fleet's sibling slot journals as fragments, as the reference
    refines them). Fails on any problem, and when no journal or request
    was found."""
    from aclswarm_torch.analysis import model

    rep = model.refine_tree(root)
    out = {k: rep[k] for k in ("journals", "requests", "events")}
    if rep["problems"] or not rep["journals"] or not rep["requests"]:
        raise AssertionError(f"{label}: journal refinement failed: {out} "
                             f"{rep['problems'][:5]}")
    REFINED[label] = out
    return out


def _kept_journals_env(keep: str) -> dict:
    return dict(os.environ, ACLSWARM_KEEP_JOURNALS=keep)


def _audit_entries() -> tuple[list, dict]:
    """Every registered entry at each of its tier-1 grid points on the
    card: per call, the synchronizing calls and the kernel launches; the
    op stream of the two recorded calls equal; no float64 leaf."""
    from aclswarm_torch.analysis import trace_audit as ta

    rows, bad, launched = [], [], {}
    for entry in ta.ENTRY_POINTS:
        for gp in ta.grid_points(entry):
            t0 = time.perf_counter()
            try:
                r = ta.audit_entry(entry, gp, "cuda")
            except ta.Skip:
                continue
            budget = entry.budget(gp)
            row = {"entry": entry.name, "solver": gp.solver,
                   "faults": gp.faults, "localization": gp.localization,
                   "syncs": list(r.syncs), "budget": budget,
                   "ops": r.n_ops, "launches": r.launches[1],
                   "f64": list(r.f64_leaves), "changed": r.changed,
                   "launches_changed": r.launches_changed,
                   "sync_sites": r.sync_sites,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            for k, v in r.launches[1].items():
                launched[k] = launched.get(k, 0) + v
            if not r.ok or max(r.syncs) > budget:
                bad.append(row)
    return rows, {"bad": bad, "launched": launched}


def _main_path_syncs(seed: int) -> dict:
    """`simform1000_flooded` at n=1000, float32: AUDIT_TICKS ticks from a
    fresh start, one `sim.rollout` call per tick under the sync counter;
    syncs per ordinary and per auction tick."""
    from aclswarm_torch import sim
    from aclswarm_torch.analysis import trace_audit as ta

    dev = torch.device("cuda")
    formation, gains, sparams, state = problem(
        N, seed, dev, torch.float32, 2 * SUITE["init_radius"])
    cfg = _slice_cfg()
    sim.rollout(state, formation, gains, sparams, cfg, 2)     # warm-up
    torch.cuda.synchronize()
    per_tick, auctioned, sites = [], [], {}
    t0 = time.perf_counter()
    for _ in range(AUDIT_TICKS):
        counts: list = []
        tick_sites: dict = {}
        with ta.count_syncs(dev, counts, tick_sites):
            state, m = sim.rollout(state, formation, gains, sparams, cfg, 1)
        per_tick.append(counts[0])
        auctioned.append(bool(m.auctioned[0]))
        kind = "auction" if auctioned[-1] else "tick"
        for k, v in tick_sites.items():
            sites.setdefault(kind, {})[k] = sites.get(kind, {}).get(k,
                                                                   0) + v
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / AUDIT_TICKS * 1e3
    ordinary = [c for c, a in zip(per_tick, auctioned) if not a]
    auction = [c for c, a in zip(per_tick, auctioned) if a]
    checked = cfg.check_mode == "on"
    budget = {"tick": ta.tick_budget(cfg.localization, checked),
              "auction_tick": ta.tick_budget(cfg.localization, checked,
                                             cfg.assignment)}
    return {"n": N, "ticks": AUDIT_TICKS, "assignment": cfg.assignment,
            "syncs_per_tick": per_tick, "auction_ticks":
            [t for t, a in enumerate(auctioned) if a],
            "ordinary_max": max(ordinary), "ordinary_mean": _mean(ordinary),
            "auction_max": max(auction), "budget": budget,
            "sync_sites": sites,
            "ms_per_tick_counted": ms,
            "finite": bool(torch.isfinite(state.swarm.q).all())}


def _lints() -> dict:
    """The three lint tiers over the port and the model checker's default
    configuration, in this process (no card needed): each exit code 0."""
    import io

    from aclswarm_torch.analysis import lint, model

    pkg = str(Path(__file__).resolve().parent / "aclswarm_torch")
    out = {}
    for name, argv in (("lint", [pkg]), ("concurrency", ["--concurrency"]),
                       ("protocol", ["--protocol"])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            rc = lint.main(argv)
        out[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                     "summary": buf.getvalue().strip().splitlines()[-1]}
    t0 = time.perf_counter()
    res = model.check(model.ModelConfig())
    out["model"] = {"ok": res.ok, "states": res.states,
                    "property": res.property,
                    "seconds": time.perf_counter() - t0}
    return out


def _start_lints():
    """`_lints` in a child process (host work only), beside the card's
    part of the phase."""
    return subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke._lints()))"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=Path(__file__).resolve().parent)


def phase_audit(seed: int) -> dict:
    """The analysis tier on the card (the docstring's phase 33)."""
    from aclswarm_torch.analysis import trace_audit as ta

    t0 = time.perf_counter()
    child = _start_lints()
    try:
        rows, summary = _audit_entries()
        audit_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        main_path = _main_path_syncs(seed)
        main_s = time.perf_counter() - t1
        t2 = time.perf_counter()
        out, err = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    lint_wait_s = time.perf_counter() - t2
    if child.returncode != 0 or not out.strip():
        raise AssertionError(f"audit: the lint child failed (exit "
                             f"{child.returncode}):\n{out}\n{err[-4000:]}")
    lints = json.loads(out.strip().splitlines()[-1])
    by_entry = {}
    for r in rows:
        e = by_entry.setdefault(r["entry"], {"syncs_max": 0, "budget": 0})
        e["syncs_max"] = max(e["syncs_max"], max(r["syncs"]))
        e["budget"] = max(e["budget"], r["budget"])
    launched = summary["launched"]
    sink = {k: sum(r["launches"].get(k, 0) for r in rows
                   if r["solver"] == "sinkhorn")
            for k in ("sinkhorn_log", "round_dominant")}
    flood = sum(r["launches"].get("flood_merge", 0) for r in rows
                if r["localization"] == "flooded")
    info = {"phase": "audit", "entries": len(by_entry),
            "cells": len(rows), "syncs_by_entry": by_entry,
            "launched": launched, "sinkhorn_point_launches": sink,
            "flooded_point_k3": flood, "bad": summary["bad"],
            "main_path": main_path, "lints": lints,
            "journals_refined": {
                "by_phase": REFINED,
                **{k: sum(v[k] for v in REFINED.values())
                   for k in ("journals", "requests", "events")}},
            "seconds": {"entries": audit_s, "main_path": main_s,
                        "lint_wait": lint_wait_s,
                        "total": time.perf_counter() - t0}}
    emit(info)
    emit({"phase": "audit_cells", "rows": rows})
    problems = []
    if len(by_entry) != len(ta.ENTRY_POINTS):
        problems.append(f"{len(by_entry)} entries audited, not "
                        f"{len(ta.ENTRY_POINTS)}")
    if summary["bad"]:
        problems.append(f"entries over budget or unstable: "
                        f"{summary['bad']}")
    if not (sink["sinkhorn_log"] and sink["round_dominant"] and flood):
        problems.append(f"kernels not launched in the audit: {sink}, "
                        f"K3 {flood}")
    mp = main_path
    if not (mp["finite"] and mp["auction_ticks"]
            and mp["ordinary_max"] <= mp["budget"]["tick"]
            and mp["auction_max"] <= mp["budget"]["auction_tick"]):
        problems.append(f"main path syncs over budget: {mp}")
    for name in ("lint", "concurrency", "protocol"):
        if lints[name]["rc"] != 0:
            problems.append(f"{name}: {lints[name]}")
    if not lints["model"]["ok"]:
        problems.append(f"model checker: {lints['model']}")
    if problems:
        raise AssertionError("audit failed: " + "; ".join(problems))
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
                 "trial": phase_trial, "batch_kernels": phase_batch_kernels,
                 "slice_batch": phase_slice_batch, "faults": phase_faults,
                 "slice_scenarios": phase_slice_scenarios,
                 "checks_faults": phase_checks_faults, "churn": phase_churn,
                 "serve": phase_serve,
                 "serve_recovery": phase_serve_recovery,
                 "serve_watch": phase_serve_watch,
                 "serve_procs": phase_serve_procs, "bridge": phase_bridge,
                 "audit": phase_audit}
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
            elif name == "slice_auction":
                if "auction" not in done:
                    done["auction"] = timed("auction", phase_auction,
                                            args.seed)
                done[name] = timed(name, phase_slice_auction, args.seed,
                                   done["auction"])
            elif name == "offline":
                for need, fn in (("kernels", phase_kernels),
                                 ("trial", phase_trial)):
                    if need not in done:
                        done[need] = timed(need, fn, args.seed)
                done[name] = timed(name, phase_offline, args.seed,
                                   done["trial"], done["kernels"])
            elif name == "trial_checked":
                done[name] = timed(name, phase_trial_checked, args.seed,
                                   done.get("trial"))
            elif name == "trial_batch_checked":
                done[name] = timed(name, phase_trial_batch_checked,
                                   args.seed, done.get("trial_batch"))
            elif name in ("serve_preempt", "serve_failover", "serve_wire"):
                fn = {"serve_preempt": phase_serve_preempt,
                      "serve_failover": phase_serve_failover,
                      "serve_wire": phase_serve_wire}[name]
                done[name] = timed(name, fn, args.seed, done.get("serve"))
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
    au = timed("auction", phase_auction, args.seed)
    timed("cbaa", phase_cbaa, args.seed)
    sl_cbaa = timed("slice_cbaa", phase_slice_cbaa, args.seed)
    sl_auction = timed("slice_auction", phase_slice_auction, args.seed, au)
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
    sv = timed("serve", phase_serve, args.seed)
    sp = timed("serve_preempt", phase_serve_preempt, args.seed, sv)
    sf = timed("serve_failover", phase_serve_failover, args.seed, sv)
    sr = timed("serve_recovery", phase_serve_recovery, args.seed)
    sw = timed("serve_wire", phase_serve_wire, args.seed, sv)
    sh = timed("serve_watch", phase_serve_watch, args.seed)
    spr = timed("serve_procs", phase_serve_procs, args.seed)
    br = timed("bridge", phase_bridge, args.seed)
    off = timed("offline", phase_offline, args.seed, tr, kern)
    timed("audit", phase_audit, args.seed)

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
                   "churn": ch["launches"][name],
                   "serve": sv["launches"][name],
                   "serve_preempt": sp["launches"][name],
                   "serve_failover": sf["launches"][name],
                   "serve_recovery": sr["launches"][name],
                   "serve_wire": sw["launches"][name],
                   "serve_watch": sh["launches"][name],
                   "serve_procs": spr["launches"][name],
                   "bridge": br["launches"][name],
                   "offline": off["launches"][name]},
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

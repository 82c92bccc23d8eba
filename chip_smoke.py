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
12. the `kernels` line, then the result line. Each kernel row carries the
   contract's keys plus `design`, `prev_design` and `prev_ms` (the first
   design, timed in this run) and `launches_by_path`; K2's row also its
   rounds and the dense bound that earlier runs reported.

Needs a CUDA card and the repository (it imports `aclswarm_torch`).
"""
from __future__ import annotations

import argparse
import ctypes
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
    them on dispatch (`aclswarm_tpu/harness/trials.py:274-319,408-415`):
    ADMM on the card in float32, non-edges in the n-4 bucket. Designed
    once per (n, seed)."""
    from aclswarm_torch import gains

    (points,), adj = _group(n, seed)
    return gains.solve_gains(points.astype(np.float32), adj,
                             max_nonedges=max(n - 4, 1),
                             device=torch.device("cuda"))


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


def device_ms(fn, reps: int, kernels: tuple) -> float:
    """Mean device milliseconds per call of ``fn`` spent in the named
    kernels, from `torch.profiler`'s kernel events over ``reps`` calls
    after one warm-up. For a kernel shorter than its wrapper's host work:
    CUDA events around back-to-back calls would time the host there."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if any(k + "(" in e.name for k in kernels)]
    if not us:
        raise AssertionError(f"the profiler saw no kernel of {kernels}")
    return sum(us) / reps / 1e3


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
    """K3's byte-mask design (the `prev_ms` baseline), not counted."""
    from aclswarm_torch.ops import _build

    n, w = packed.shape
    out = torch.empty_like(packed)
    _build.launch("flood_merge_bytemask_launch", packed.device,
                  packed.data_ptr(), comm.data_ptr(), out.data_ptr(), n, w)
    return out


def _round_single_block(plan):
    """K2's single-block design (the `prev_ms` baseline), not counted."""
    from aclswarm_torch.ops import _build

    n = plan.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=plan.device)
    rounds = torch.empty((), dtype=torch.int32, device=plan.device)
    _build.launch("round_dominant_single_block_launch", plan.device,
                  plan.data_ptr(), out.data_ptr(), rounds.data_ptr(), n, n)
    return out, rounds


def _ab_ms(new, prev, reps: int) -> tuple[float, float]:
    """Mean ms of two versions timed in turns (new, prev, prev, new)."""
    t = [time_ms(fn, reps) for fn in (new, prev, prev, new)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def _masses(plan):
    return [torch.exp(torch.logsumexp(plan, dim=d)) for d in (0, 1)]


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
    info = {"check": label, "n": cost.shape[0], "launches": launches,
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
    info = {"check": label, "n": packed.shape[0], "w": packed.shape[1],
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
    info = {"check": label, "n": plan.shape[0], "max_rounds": max_rounds,
            "launches": launches, "rounds": int(rounds),
            "bit_identical": bool(torch.equal(perm, ref)
                                  and int(rounds) == int(ref_rounds)),
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

    cu = _cusolver_problem(prob, pa)
    g_cu, _, it_cu, _ = admm.solve(cu, params)
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
            "cusolver_basis": {
                "max_abs_q2_diff": (cu.q2 - prob.q2).abs().max().item(),
                "max_abs_gains_diff": (g_cu[0] - A).abs().max().item(),
                "iters": int(it_cu[0])}}
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
    against the CPU from the same q, est and v2f."""
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
        info = {"phase": "cbaa", "auction": label, "n": N,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    import aclswarm_torch  # noqa: F401  (needs the repository)

    phase_device()
    phase_build()
    gn = phase_gains(args.seed)
    kern = phase_kernels(args.seed)
    phase_reference(args.seed)
    sl = phase_slice(args.seed)
    phase_profile(args.seed, sl["ms_per_tick"])
    sl_random = phase_slice(args.seed, "random")
    phase_profile(args.seed, sl_random["ms_per_tick"], "random")
    phase_auction(args.seed)
    phase_cbaa(args.seed)
    sl_cbaa = phase_slice_cbaa(args.seed)
    sl_auction = phase_slice_auction(args.seed)

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
                   "slice_auction": sl_auction["launches"][name]},
               "max_abs_err": k["max_abs_err"], "ms": k["ms"],
               "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
               "bound_by": k["bound_by"], "library_ms": None,
               "design": designs[name][0]}
        row.update(prev_design=designs[name][1], prev_ms=k["prev_ms"])
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

"""Monte-Carlo trial driver (port of `aclswarm_tpu/harness/trials.py`):
the reference's `trials.sh`/`trial.sh` stack on the torch engine.

Each seeded trial generates (`simformN`) or loads its formation group,
samples non-overlapping ground starts, takes off through the flight FSM,
and cycles through the group's formations under the supervisor FSM
(`harness.supervisor.TrialFSM`), which observes every control tick. The
fleet rolls in chunks of `chunk_ticks` (`sim.rollout`); FSM actions
(CMD_GO, formation dispatch) take effect at the next chunk boundary — the
analogue of the reference's dispatch latency — and assignment events
between a dispatch decision and its application are suppressed, since
they belong to the outgoing formation. A dispatch designs the
formation's gains on the device (`gains.solve_gains`, the n-4 bucket for
`simformN`, x `gain_scale`, optionally warm from the previous design),
resets the assignment to the identity and re-phases the tick so an
auction runs on the first tick of the formation. Completed trials append
one CSV row each in the reference schema.

The trial runs on ``TrialConfig.device`` (None = the card, which must be
present) in ``TrialConfig.dtype``. The host reads the chunk's signals in
two device-to-host copies per chunk, never per tick. A chunk that fails
on the device raises: there is no CPU re-run.

With ``batch`` > 1 the trials fly in waves of ``batch`` (`run_trial_batch`):
one batched rollout per chunk advances every trial of the wave with one
set of launches (`sim.batched_rollout`), the supervisor's per-tick
predicates are reduced on the device (`sim.summary`), and the host reads
(B, chunk) flags and (B, n) distances in two copies per chunk for the whole
wave, which drive one `SummaryTrialFSM` per trial. The trials share the
auction phase, so ``chunk_ticks`` must be a multiple of ``assign_every``
(and, flooded, ``assign_every`` of ``flood_every``); before its first
dispatch a trial's auctions are gated off instead of configured off. A
formation commit rewrites its trial's row at the chunk boundary, and once
half the rows are done the wave is compacted to the next power of two.

Run:
    python -m aclswarm_torch.harness.trials -f swarm6_3d -m 1 \\
        --set device=cpu --set dtype=float64
    python -m aclswarm_torch.harness.trials -f simform8 -m 2 \\
        --set batch=2 --set chunk_ticks=120 --set device=cpu \\
        --set dtype=float64
    python -m aclswarm_torch.harness.trials --analyze trials.csv -n 6 -m 1

``scenario`` names a registry family (`aclswarm_torch.scenarios`): each
trial flies its own seeded draw, whose clock restarts with every dispatch
(the tick is re-phased), over ``scenario_horizon`` ticks.

``check_mode='on'`` runs the invariant sanitizer in the engine
(`analysis.invariants`) and raises `InvariantViolation` naming the trial,
its tick and the contract at the first violated chunk; ``telemetry='on'``
carries the device counters (`telemetry.device`) and publishes them into
the process registry at every chunk boundary (``telemetry_dump`` writes
the registry as JSONL at the end of `run_trials`). Both ride the chunk's
two copies. ``profile_dir`` writes a `torch.profiler` trace of chunk
``profile_chunk`` (TensorBoard/Perfetto); ``record_dir`` writes each
serial trial's metric stack as ``trial_<i>.npz`` for `harness.review`.

    python -m aclswarm_torch.harness.trials -f swarm4 -m 1 \\
        --set device=cpu --set dtype=float64 --set check_mode=on \\
        --set telemetry=on --set telemetry_dump=tel.jsonl \\
        --set record_dir=rec
    python -m aclswarm_torch.harness.review rec/trial_0.npz
"""
from __future__ import annotations

import argparse
import contextlib
import csv
import dataclasses
import re
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from aclswarm_torch import convert
from aclswarm_torch import gains as gainslib
from aclswarm_torch import sim
from aclswarm_torch.analysis import invariants as invlib
from aclswarm_torch.core import config as configlib
from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core import types as typeslib
from aclswarm_torch.core.types import (ControlGains, SafetyParams,
                                       make_formation, resolve_device)
from aclswarm_torch.harness import formations as formlib
from aclswarm_torch.harness import formgen
from aclswarm_torch.harness.formations import FormationSpec
from aclswarm_torch.harness.supervisor import (BUFFER_SECONDS, NAMES,
                                               TRIAL_TIMEOUT,
                                               SummaryTrialFSM, TrialFSM)
from aclswarm_torch.resilience import checkpoint as ckptlib
from aclswarm_torch.resilience.crash import maybe_crash
from aclswarm_torch.sim import summary as sumlib
from aclswarm_torch.sim.vehicle import CMD_GO, ExternalInputs
from aclswarm_torch.telemetry import device as devtel
from aclswarm_torch.telemetry import get_registry


@dataclasses.dataclass
class TrialConfig:
    """Trial parameterization: every field and default of the reference's
    `TrialConfig` (see it for each field's meaning and measured reasons),
    plus where and in what precision the port runs."""

    formation: str = "swarm6_3d"    # library group name, or simformN
    library: Optional[str] = None   # formations.yaml path (None = shipped)
    trials: int = 1                 # Monte-Carlo trial count (trials.sh -m)
    seed: int = 1                   # trial t runs with seed+t
    out: str = "trials.csv"         # CSV results path (append)
    batch: int = 1                  # > 1: waves of `batch` trials
    # engine knobs (SimConfig mirror)
    assignment: str = "auction"     # auction | sinkhorn | cbaa
    dynamics: str = "doubleint"     # doubleint | tracking | firstorder
    localization: str = "truth"     # truth | flooded
    flood_block: Optional[int] = None
    flood_phases: int = 1
    cbaa_task_block: Optional[int] = None
    tau: float = 0.15
    control_dt: float = 0.01
    assign_every: int = 120
    assign_eps: float = 0.0
    check_mode: str = "off"
    telemetry: str = "off"
    telemetry_dump: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_chunk: int = 1
    colavoid_neighbors: Optional[int] = None
    scenario: Optional[str] = None
    scenario_seed: Optional[int] = None
    scenario_horizon: Optional[int] = None
    chunk_ticks: int = 50           # FSM action latency bound (0.5 s)
    # initial-condition sampling (trial.sh:7-9: 20 x 20 area, r=0.75)
    init_area_w: float = 20.0
    init_area_h: float = 20.0
    init_radius: float = 0.75
    # room bounds (trial.sh:96)
    room_x: float = 100.0
    room_y: float = 100.0
    room_z: float = 30.0
    # simformN generation (trial.sh:60: -l 15 -w 15 -h 2)
    sim_l: float = 15.0
    sim_w: float = 15.0
    sim_h: float = 2.0
    sim_min_dist: float = 2.0
    sim_formations: int = 2
    sim_fc: bool = False
    # scale knobs (None = the reference SIL defaults)
    max_vel_xy: Optional[float] = None
    max_vel_z: Optional[float] = None
    max_accel_xy: Optional[float] = None
    max_accel_z: Optional[float] = None
    keepout_repulse_vel: Optional[float] = None
    colavoid_dz_ignore: Optional[float] = None
    trial_timeout: Optional[float] = None
    e_xy_thr: Optional[float] = None
    e_z_thr: Optional[float] = None
    kd: Optional[float] = None
    K1_xy: Optional[float] = None
    K2_xy: Optional[float] = None
    K1_z: Optional[float] = None
    K2_z: Optional[float] = None
    gain_scale: Optional[float] = None
    # warm-start each on-dispatch gain design from the previous one's
    # fixed point (`gains.AdmmCarry`); off = the reference's cold solve
    warm_gains: bool = False
    verbose: bool = True
    record_dir: Optional[str] = None
    # chunk-boundary checkpoints every `checkpoint_every` chunks into
    # `checkpoint_dir` (None = off); with `resume`, a matching checkpoint
    # continues the run bit for bit, a mismatched one is refused
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    resume: bool = True
    # where and in what precision the port runs: None = the card
    device: Optional[str] = None
    dtype: str = "float32"          # float32 | float64


# config fields that cannot change results: excluded from the checkpoint
# manifest's config hash
_CKPT_EXCLUDE = ("out", "verbose", "checkpoint_dir", "checkpoint_every",
                 "resume", "telemetry_dump", "profile_dir",
                 "profile_chunk")

_DTYPES = {"float32": torch.float32, "float64": torch.float64}

_SIMFORM = re.compile(r"^simform(\d+)$")


def _check_dtype(cfg: TrialConfig) -> None:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r} "
                         f"(expected one of {sorted(_DTYPES)})")


def _ckpt_cfg_hash(cfg: TrialConfig) -> str:
    d = {k: v for k, v in dataclasses.asdict(cfg).items()
         if k not in _CKPT_EXCLUDE}
    return ckptlib.config_hash(d)


def _fingerprint(cfg: TrialConfig) -> str:
    return ckptlib.dtype_fingerprint(_DTYPES[cfg.dtype],
                                     resolve_device(cfg.device))


def _formations_for_trial(cfg: TrialConfig, seed: int
                          ) -> list[FormationSpec]:
    m = _SIMFORM.match(cfg.formation)
    if m:
        return formgen.generate_specs(
            int(m.group(1)), seed=seed, l=cfg.sim_l, w=cfg.sim_w,
            h=cfg.sim_h, min_dist=cfg.sim_min_dist, k=cfg.sim_formations,
            fc=cfg.sim_fc)
    return formlib.load_group(cfg.library, cfg.formation)


def _trial_overrides(cfg: TrialConfig, *fields) -> dict:
    """Optional scale knobs: None = keep the reference default."""
    return {k: getattr(cfg, k) for k in fields
            if getattr(cfg, k) is not None}


def _trial_sparams(cfg: TrialConfig) -> SafetyParams:
    """Room bounds + the launch-file-class scale knobs, as host tuples."""
    return SafetyParams(
        bounds_min=(-cfg.room_x, -cfg.room_y, 0.0),
        bounds_max=(cfg.room_x, cfg.room_y, cfg.room_z),
        **_trial_overrides(cfg, "max_vel_xy", "max_vel_z", "max_accel_xy",
                           "max_accel_z", "keepout_repulse_vel",
                           "colavoid_dz_ignore"))


def _trial_cgains(cfg: TrialConfig) -> ControlGains:
    return ControlGains(**_trial_overrides(
        cfg, "e_xy_thr", "e_z_thr", "kd", "K1_xy", "K2_xy", "K1_z", "K2_z"))


# the default per-formation scenario horizon in ticks (24 s at 100 Hz):
# the driver re-phases the engine tick at every dispatch, so a family's
# event fractions must land inside a formation phase
_SCENARIO_HORIZON = 2400


def _trial_scenario(cfg: TrialConfig, trial_seed: int, trial_idx: int,
                    n: int, trial_timeout: float, device, dtype):
    """The trial's scenario draw (None = the scenario-free engine): the
    registry family ``cfg.scenario``, seeded per trial (``scenario_seed +
    trial_idx``, else the trial's own seed), over ``scenario_horizon``
    ticks, else the trial budget capped at `_SCENARIO_HORIZON`."""
    if cfg.scenario is None:
        return None
    from aclswarm_torch.scenarios import registry as scenreg

    seed = (trial_seed if cfg.scenario_seed is None
            else cfg.scenario_seed + trial_idx)
    if cfg.scenario_horizon is not None:
        horizon = int(cfg.scenario_horizon)
    else:
        budget = max(1, int(trial_timeout / cfg.control_dt))
        horizon = min(budget, _SCENARIO_HORIZON)
    return scenreg.sample(cfg.scenario, seed, n, horizon=horizon,
                          device=device, dtype=dtype)


def _engine_kw(cfg: TrialConfig) -> dict:
    """The TrialConfig -> SimConfig mirror (minus `assignment`)."""
    return dict(control_dt=cfg.control_dt, assign_every=cfg.assign_every,
                dynamics=cfg.dynamics, tau=cfg.tau,
                localization=cfg.localization,
                flood_block=cfg.flood_block,
                flood_phases=cfg.flood_phases,
                colavoid_neighbors=cfg.colavoid_neighbors,
                assign_eps=cfg.assign_eps,
                cbaa_task_block=cfg.cbaa_task_block,
                check_mode=cfg.check_mode,
                telemetry=cfg.telemetry,
                flight_fsm=True)


def _dispatch_gains(cfg: TrialConfig, spec: FormationSpec, n: int,
                    carry=None, device=None, dtype=torch.float32):
    """On-dispatch gain design: library gains if shipped, else the device
    ADMM solve in ``dtype`` on ``device`` with the padded-constraint
    bucket rule: complete graphs have no non-edges (a 1-slot bucket),
    random `simformN` graphs remove at most n-4 edges, a static bound
    shared by every seed; library groups use their exact count. x
    ``cfg.gain_scale``. Returns ``(gains, new_carry, stats)``: the carry
    None without ``cfg.warm_gains`` (``carry`` seeds the warm solve; None
    or a carry of another shape falls back to the cold `init_carry`, which
    equals the carry-free solve bit for bit; library gains pass it
    through), the `AdmmSolveStats` None unless ``cfg.telemetry='on'`` and
    a solve ran."""
    warm, stats, st = cfg.warm_gains, cfg.telemetry == "on", None
    if spec.gains is not None:
        g = np.asarray(spec.gains)
    else:
        if not _SIMFORM.match(cfg.formation):
            bucket = None
        elif cfg.sim_fc:
            bucket = 1
        else:
            bucket = max(n - 4, 1)
        pts = np.asarray(spec.points,
                         dtype=str(dtype).removeprefix("torch."))
        if warm:
            cold = gainslib.init_carry(pts.shape[0], gainslib.planar_of(pts),
                                       dtype=dtype, device=device)
            if carry is None or any(
                    tuple(getattr(carry, f).shape) != tuple(
                        getattr(cold, f).shape)
                    for f in ("x2", "s2", "x1", "s1")):
                carry = cold
        out = gainslib.solve_gains(pts, spec.adjmat, max_nonedges=bucket,
                                   telemetry=stats,
                                   carry=carry if warm else None,
                                   device=device)
        out = out if isinstance(out, tuple) else (out,)
        g = out[0]
        carry = out[1] if warm else None
        st = out[-1] if stats else None
    if cfg.gain_scale is not None:
        g = g * cfg.gain_scale
    return g, carry if warm else None, st


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _carry_payload(carry):
    """`AdmmCarry` -> checkpoint payload (dict of arrays | None), so a
    resumed trial's next dispatch is as warm as the uninterrupted run's."""
    if carry is None:
        return None
    return {k: _host(v) for k, v in carry._asdict().items()}


def _carry_restore(d, device, dtype):
    """Checkpoint payload -> `AdmmCarry` (None passes through)."""
    if d is None:
        return None
    return convert.admm_carry_from_numpy(d, device=device, dtype=dtype)


def _chunk_inputs(chunk: int, n: int, device, dtype, go: bool
                  ) -> ExternalInputs:
    """A chunk's operator inputs: no joystick, CMD_GO on its first tick
    when ``go``."""
    cmd = torch.zeros((chunk,), dtype=torch.int32, device=device)
    if go:
        cmd[0] = CMD_GO
    return ExternalInputs(
        cmd=cmd,
        joy_vel=torch.zeros((chunk, n, 3), dtype=dtype, device=device),
        joy_yawrate=torch.zeros((chunk, n), dtype=dtype, device=device),
        joy_active=torch.zeros((chunk, n), dtype=torch.bool, device=device))


def _host_signals(metrics, record: bool = False) -> dict:
    """What the driver reads of a chunk's stacked `StepMetrics`, in two
    device-to-host copies: one float copy of the positions ``q`` (T, n, 3)
    and ``distcmd_norm`` (T, n), and one int32 copy of the flags
    ``ca_active`` (T, n), ``reassigned`` and ``auction_ok`` (T,). The
    invariant codes ``inv_code`` (T,) and the counters after the chunk
    (``tel``, the `telemetry.device.to_host` dict) ride the same copies
    when the rollout carries them, and with ``record`` the rest of a
    recording's fields (``mode``, ``v2f``, ``auctioned``,
    ``assign_valid``). Returns numpy arrays keyed by name."""
    floats = {"q": metrics.q, "distcmd_norm": metrics.distcmd_norm}
    ints = {"ca_active": metrics.ca_active,
            "reassigned": metrics.reassigned,
            "auction_ok": metrics.auctioned & metrics.assign_valid}
    if metrics.inv_code is not None:
        ints["inv_code"] = metrics.inv_code
    if metrics.tel is not None:
        ints.update({f"tel.{f}": getattr(metrics.tel, f)[-1]
                     for f in devtel.INT_FIELDS})
        floats["tel.admm_residual"] = metrics.tel.admm_residual[-1]
    if record:
        ints.update(mode=metrics.mode, v2f=metrics.v2f,
                    auctioned=metrics.auctioned,
                    assign_valid=metrics.assign_valid)
    fflat, flay = sumlib.pack(floats, metrics.q.dtype)
    iflat, ilay = sumlib.pack(ints, torch.int32)
    out = sumlib.unpack(fflat.cpu().numpy(), flay)
    out.update(sumlib.unpack(iflat.cpu().numpy(), ilay))
    for k in ("ca_active", "reassigned", "auction_ok", "auctioned",
              "assign_valid"):
        if k in out:
            out[k] = out[k].astype(bool)
    if metrics.tel is not None:
        out["tel"] = devtel.to_host({f: out.pop(f"tel.{f}")
                                     for f in devtel.FIELDS})
    return out


def _profiler(cfg: TrialConfig, chunk_idx: int, dev):
    """A `torch.profiler` capture of chunk ``profile_chunk`` into
    ``profile_dir`` (CPU activity, and the card's on CUDA), written as a
    TensorBoard/Perfetto trace when the chunk ends; a null context for
    every other chunk."""
    if cfg.profile_dir is None or chunk_idx != cfg.profile_chunk:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(cfg.profile_dir))


def _set_solve(tel, st, b=None) -> None:
    """A dispatch's `AdmmSolveStats` into the counter carry (trial ``b``
    of a batch), in place: fills, no host-to-device copy."""
    if b is None:
        tel.admm_iters.fill_(st.iters)
        tel.admm_residual.fill_(st.residual)
    else:
        tel.admm_iters[b] = st.iters
        tel.admm_residual[b] = st.residual


def run_trial(cfg: TrialConfig, trial_idx: int) -> TrialFSM:
    """One seeded trial: ground start -> takeoff -> cycle through the
    group's formations -> COMPLETE/TERMINATE. Returns the finished FSM."""
    _check_dtype(cfg)
    dev = resolve_device(cfg.device)
    dtype = _DTYPES[cfg.dtype]
    seed = cfg.seed + trial_idx
    rng = np.random.default_rng(seed)
    specs = _formations_for_trial(cfg, seed)
    n = specs[0].n

    # non-overlapping ground starts (z = 0)
    q0 = formgen.sample_cylinder_points(
        rng, n, cfg.init_area_w, cfg.init_area_h, 0.0,
        min_dist=2 * cfg.init_radius)

    sparams = _trial_sparams(cfg)
    trial_timeout = (TRIAL_TIMEOUT if cfg.trial_timeout is None
                     else cfg.trial_timeout)

    # fail fast on formations that planar avoidance can never reach
    for spec in specs:
        formlib.check_feasible(spec, float(sparams.r_keep_out))

    engine_kw = _engine_kw(cfg)
    hover_cfg = sim.SimConfig(assignment="none", **engine_kw)
    fly_cfg = sim.SimConfig(assignment=cfg.assignment, **engine_kw)

    # pre-dispatch: no formation committed -> no graph, no gains, no control
    hover_formation = make_formation(specs[0].points, np.zeros((n, n)), None,
                                     device=dev, dtype=dtype)
    gains_cache: dict = {}
    # warm-start seed for the next dispatch solve (None until the first
    # solve, and always None with warm_gains off)
    admm_carry = None

    checks = cfg.check_mode == "on"
    tel_on = cfg.telemetry == "on"
    state = sim.init_state(q0, flying=False,
                           localization=cfg.localization == "flooded",
                           checks=checks, telemetry=tel_on,
                           scenario=_trial_scenario(cfg, seed, trial_idx, n,
                                                    trial_timeout, dev,
                                                    dtype),
                           device=dev, dtype=dtype)
    fsm = TrialFSM(n, len(specs), takeoff_alt=sparams.takeoff_alt,
                   dt=cfg.control_dt, trial_timeout=trial_timeout)
    cgains = _trial_cgains(cfg)

    cur_formation, cur_cfg = hover_formation, hover_cfg
    pending_go = False
    pending_dispatch: Optional[int] = None
    # the last committed formation index (None = pre-dispatch hover):
    # enough, with `gains_cache`, to rebuild `cur_formation` on resume
    committed_idx: Optional[int] = None
    # the first valid auction after a formation commit always counts as
    # an accepted assignment, even if unchanged (the reference's
    # `formation_just_received_`)
    formation_just_received = False
    chunk = cfg.chunk_ticks
    max_ticks = int(trial_timeout / cfg.control_dt) + 10 * chunk
    ticks_done = 0
    chunk_idx = 0
    inputs = {go: _chunk_inputs(chunk, n, dev, dtype, go)
              for go in (False, True)}
    recorded: list = []
    if tel_on:
        publisher = devtel.ChunkPublisher(get_registry(), prefix="trial")

    ckpt_dir = cfg.checkpoint_dir
    if ckpt_dir is not None and cfg.record_dir is not None:
        raise ValueError("checkpoint_dir with record_dir is unsupported: "
                         "the recorded metric stack does not survive a "
                         "crash, so a resumed recording would be a lie")
    stem = f"trial{trial_idx:05d}"
    if ckpt_dir is not None:
        cfg_hash, fingerprint = _ckpt_cfg_hash(cfg), _fingerprint(cfg)
    if ckpt_dir is not None and cfg.resume:
        path = ckptlib.latest_checkpoint(ckpt_dir, stem)
        if path is not None:
            payload, man = ckptlib.load_checkpoint(
                path, expected=ckptlib.expected_manifest(
                    "trial", cfg_hash, fingerprint, trial=trial_idx))
            state = ckptlib.restore_state(state, payload["state"], path=path)
            fsm.restore(payload["fsm"])
            # copies: the codec's arrays are read-only views of the file
            gains_cache = {int(k): np.array(v)
                           for k, v in payload["gains_cache"].items()}
            admm_carry = _carry_restore(payload.get("admm_carry"), dev,
                                        dtype)
            pending_go = payload["pending_go"]
            pending_dispatch = payload["pending_dispatch"]
            formation_just_received = payload["formation_just_received"]
            committed_idx = payload["committed_idx"]
            ticks_done = payload["ticks_done"]
            chunk_idx = int(man["chunk"])
            if committed_idx is not None:
                spec = specs[committed_idx]
                cur_formation = make_formation(
                    spec.points, spec.adjmat, gains_cache[committed_idx],
                    device=dev, dtype=dtype)
                cur_cfg = fly_cfg

    while chunk_idx < max_ticks // chunk + 1:
        if fsm.done:
            break
        with _profiler(cfg, chunk_idx, dev):
            state, metrics = sim.rollout(state, cur_formation, cgains,
                                         sparams, cur_cfg, chunk,
                                         inputs[pending_go])
        pending_go = False
        host = _host_signals(metrics, record=cfg.record_dir is not None)
        if cfg.record_dir is not None:
            recorded.append(host)
        if checks:
            # the codes ride the chunk's copies; tick0 is the trial's wall
            # tick (the engine's own tick re-phases at each dispatch)
            invlib.raise_on_violation(host["inv_code"], trial=trial_idx,
                                      tick0=ticks_done)
        if tel_on:
            publisher.publish(trial_idx, host["tel"])
        ticks_done += chunk
        q, dn, ca = host["q"], host["distcmd_norm"], host["ca_active"]
        reassigned, auction_ok = host["reassigned"], host["auction_ok"]

        suppress_events = False
        for t in range(chunk):
            event = bool(reassigned[t])
            if formation_just_received and bool(auction_ok[t]):
                event = True
                formation_just_received = False
            event = event and not suppress_events
            action = fsm.step(q[t], dn[t], ca[t], event)
            if action == "takeoff":
                pending_go = True
            elif action == "dispatch":
                pending_dispatch = fsm.curr_formation_idx
                suppress_events = True   # stale events belong to the old form
            if fsm.done:
                break

        if pending_dispatch is not None and not fsm.done:
            spec = specs[pending_dispatch]
            solve_st = None
            if pending_dispatch not in gains_cache:
                g, new_carry, solve_st = _dispatch_gains(
                    cfg, spec, n, carry=admm_carry, device=dev, dtype=dtype)
                if cfg.warm_gains:
                    admm_carry = new_carry
                gains_cache[pending_dispatch] = g
            cur_formation = make_formation(spec.points, spec.adjmat,
                                           gains_cache[pending_dispatch],
                                           device=dev, dtype=dtype)
            cur_cfg = fly_cfg
            # the auctioneer resets to the identity assignment on a new
            # formation, and control starts only after the formation's
            # first assignment: re-phasing the tick puts an auction on the
            # first post-dispatch tick (assignment runs before the control
            # law inside `step`)
            state = dataclasses.replace(
                state, v2f=permutil.identity(n, dev), tick=0,
                first_auction=torch.ones((), dtype=torch.bool, device=dev))
            if tel_on and solve_st is not None:
                # the dispatch's solve rides the carry: it checkpoints and
                # reads back with everything else
                _set_solve(state.tel, solve_st)
            formation_just_received = True
            committed_idx = pending_dispatch
            pending_dispatch = None

        # chunk boundary: checkpoint first, then the scripted-preemption
        # hook, so a crash at boundary k resumes from k
        chunk_idx += 1
        if ckpt_dir is not None and not fsm.done \
                and chunk_idx % max(1, cfg.checkpoint_every) == 0:
            payload = {
                "state": convert.sim_state_to_numpy(state),
                "fsm": fsm.snapshot(),
                "gains_cache": {str(k): _host(v)
                                for k, v in gains_cache.items()},
                "admm_carry": _carry_payload(admm_carry),
                "pending_go": pending_go,
                "pending_dispatch": pending_dispatch,
                "formation_just_received": formation_just_received,
                "committed_idx": committed_idx,
                "ticks_done": ticks_done,
            }
            ckptlib.write_checkpoint(
                ckpt_dir, stem, payload,
                ckptlib.make_manifest("trial", cfg_hash, chunk_idx,
                                      fingerprint, trial=trial_idx,
                                      ticks_done=ticks_done))
        maybe_crash("trial", chunk_idx)

    if ckpt_dir is not None and fsm.done:
        # finished: interim checkpoints are dead weight; the done-marker
        # (`run_trials`) carries the result
        ckptlib.clear_checkpoints(ckpt_dir, stem)
    # the reference's executor records CPU re-runs here; the port has none
    fsm.execution = {}

    if cfg.record_dir is not None and recorded:
        from aclswarm_torch.harness import review
        stacked = {f: np.concatenate([r[f] for r in recorded])
                   for f in review.FIELDS}
        outdir = Path(cfg.record_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        review.record(str(outdir / f"trial_{trial_idx}.npz"), stacked,
                      dt=cfg.control_dt, seed=seed, formation=cfg.formation,
                      trial_timeout=trial_timeout)
    return fsm


def _batch_inputs(chunk: int, batch: int, n: int, go: list, device,
                  dtype) -> ExternalInputs:
    """A wave's chunk inputs, (chunk, B, ...): no joystick, CMD_GO on the
    first tick of each trial in ``go``."""
    cmd = torch.zeros((chunk, batch), dtype=torch.int32, device=device)
    for b in go:
        cmd[0, b] = CMD_GO
    return ExternalInputs(
        cmd=cmd,
        joy_vel=torch.zeros((chunk, batch, n, 3), dtype=dtype,
                            device=device),
        joy_yawrate=torch.zeros((chunk, batch, n), dtype=dtype,
                                device=device),
        joy_active=torch.zeros((chunk, batch, n), dtype=torch.bool,
                               device=device))


def _formation_payload(f) -> dict:
    return {k: _host(v) for k, v in vars(f).items()}


def run_trial_batch(cfg: TrialConfig, trial_indices: list[int]
                    ) -> list[SummaryTrialFSM]:
    """B seeded trials in one batched rollout per chunk: per chunk the
    device runs every trial's next `chunk_ticks` ticks with one set of
    launches and reduces the supervisor's observables on the device
    (`sim.summary.batched_rollout_summary`); the host reads (B, chunk)
    flags and (B, n) distances in two copies for the whole wave.

    Lifecycle actions (CMD_GO, formation commits) stay at chunk
    boundaries, as in `run_trial`; a commit designs that trial's gains
    (one formation at a time, warm from its own `AdmmCarry` with
    ``warm_gains``) and rewrites its row of the batched formation and
    state. ``chunk_ticks % assign_every == 0`` keeps the auction phase
    shared across the wave. Once at least half the rows are done the wave
    is compacted: the live trials are gathered into the next power-of-two
    batch. Returns the trials' `SummaryTrialFSM`s in ``trial_indices``
    order."""
    if cfg.record_dir is not None:
        raise ValueError("record_dir needs the per-tick metric stack; run "
                         "with batch=1 to record rollouts")
    _check_dtype(cfg)
    chunk = cfg.chunk_ticks
    if chunk % cfg.assign_every:
        raise ValueError(
            f"batched trials require chunk_ticks ({chunk}) to be a "
            f"multiple of assign_every ({cfg.assign_every}) so all trials "
            "share the auction phase")
    dev = resolve_device(cfg.device)
    dtype = _DTYPES[cfg.dtype]
    B = len(trial_indices)
    flooded = cfg.localization == "flooded"

    specs_per, q0s = [], []
    for t in trial_indices:
        seed = cfg.seed + t
        rng = np.random.default_rng(seed)
        specs = _formations_for_trial(cfg, seed)
        specs_per.append(specs)
        q0s.append(formgen.sample_cylinder_points(
            rng, specs[0].n, cfg.init_area_w, cfg.init_area_h, 0.0,
            min_dist=2 * cfg.init_radius))
    n = specs_per[0][0].n
    n_forms = len(specs_per[0])
    if any(sp[0].n != n or len(sp) != n_forms for sp in specs_per):
        raise ValueError("batched trials need a uniform formation shape "
                         "across the batch")

    sparams = _trial_sparams(cfg)
    trial_timeout = (TRIAL_TIMEOUT if cfg.trial_timeout is None
                     else cfg.trial_timeout)
    for specs in specs_per:
        for spec in specs:
            formlib.check_feasible(spec, float(sparams.r_keep_out))

    fly_cfg = sim.SimConfig(assignment=cfg.assignment, **_engine_kw(cfg))
    if flooded and cfg.assign_every % fly_cfg.flood_every:
        raise ValueError("batched flooded trials require assign_every to "
                         "be a multiple of flood_every (a shared flood "
                         "phase)")

    checks = cfg.check_mode == "on"
    tel_on = cfg.telemetry == "on"
    bstate = sim.stack_states([
        sim.init_state(q0, flying=False, localization=flooded,
                       checks=checks, telemetry=tel_on,
                       scenario=_trial_scenario(cfg, cfg.seed + t, t, n,
                                                trial_timeout, dev, dtype),
                       device=dev, dtype=dtype)
        for t, q0 in zip(trial_indices, q0s)])
    # before its first dispatch a trial's auctions are gated off: the wave
    # shares one configuration, so the serial driver's hover
    # assignment='none' becomes this per-trial gate
    bstate.assign_enabled.zero_()
    # pre-dispatch rows: the first formation's points, no graph, no gains
    bform = typeslib.make_formations(
        np.stack([np.asarray(sp[0].points) for sp in specs_per]),
        np.zeros((B, n, n)), None, device=dev, dtype=dtype)

    cgains = _trial_cgains(cfg)
    dt = cfg.control_dt
    window = max(1, int(round(BUFFER_SECONDS / dt)))
    fsms = [SummaryTrialFSM(n, n_forms,
                            takeoff_alt=float(sparams.takeoff_alt), dt=dt,
                            trial_timeout=trial_timeout)
            for _ in range(B)]
    all_fsms = list(fsms)         # trial_indices order, for the return
    torig = list(trial_indices)   # the trial of each current row
    scarry = sumlib.init_carry(n, window, dtype=dtype, device=dev, batch=B)
    gains_cache: list[dict] = [dict() for _ in range(B)]
    # per-row warm-start seeds (`run_trial`'s `admm_carry`)
    admm_carries: list = [None] * B
    pending_go = [False] * B
    pending_dispatch: list[Optional[int]] = [None] * B
    max_ticks = int(trial_timeout / dt) + 10 * chunk
    ticks_done = 0
    chunk_idx = 0
    specs_per_orig = list(specs_per)

    if tel_on:
        publisher = devtel.ChunkPublisher(get_registry(), prefix="trial")
    ckpt_dir = cfg.checkpoint_dir
    stem = f"wave{trial_indices[0]:05d}_b{B}"
    if ckpt_dir is not None:
        cfg_hash, fingerprint = _ckpt_cfg_hash(cfg), _fingerprint(cfg)
        trials_key = list(map(int, trial_indices))
    if ckpt_dir is not None and cfg.resume:
        path = ckptlib.latest_checkpoint(ckpt_dir, stem)
        if path is not None:
            payload, man = ckptlib.load_checkpoint(
                path, expected=ckptlib.expected_manifest(
                    "trial_batch", cfg_hash, fingerprint,
                    trials=trials_key))
            # a compaction may have shrunk the trial axis: restore against
            # the full-B templates with a flexible leading axis
            bstate = ckptlib.restore_state(bstate, payload["state"],
                                           batch_flex=True, path=path)
            ckptlib.check_leaves(_formation_payload(bform), payload["bform"],
                                 batch_flex=True, path=path,
                                 what="Formation")
            bform = convert.formation_from_numpy(payload["bform"], dev,
                                                 dtype)
            ckptlib.check_leaves(convert.summary_carry_to_numpy(scarry),
                                 payload["scarry"], batch_flex=True,
                                 path=path, what="SummaryCarry")
            scarry = convert.summary_carry_from_numpy(payload["scarry"], dev,
                                                      dtype)
            for f, snap in zip(all_fsms, payload["fsms"]):
                f.restore(snap)
            live_rows = [int(i) for i in payload["live_rows"]]
            fsms = [all_fsms[i] for i in live_rows]
            torig = [trial_indices[i] for i in live_rows]
            specs_per = [specs_per_orig[i] for i in live_rows]
            # copies: the codec's arrays are read-only views of the file
            gains_cache = [{int(k): np.array(v) for k, v in g.items()}
                           for g in payload["gains_cache"]]
            admm_carries = [_carry_restore(d, dev, dtype)
                            for d in payload["admm_carries"]]
            pending_go = list(payload["pending_go"])
            pending_dispatch = list(payload["pending_dispatch"])
            ticks_done = payload["ticks_done"]
            chunk_idx = int(man["chunk"])

    while chunk_idx < max_ticks // chunk + 1:
        if all(f.done for f in fsms):
            break
        # compact: once half the rows are dead weight, gather the live
        # trials into the next power-of-two batch
        live = [i for i, f in enumerate(fsms) if not f.done]
        if len(fsms) > 1 and len(live) <= len(fsms) // 2:
            new_b = 1
            while new_b < len(live):
                new_b *= 2
            fillers = [i for i, f in enumerate(fsms) if f.done]
            keep = sorted(live + fillers[:new_b - len(live)])
            rows = torch.as_tensor(keep, dtype=torch.int64).to(dev)
            bstate = sim.take_trials(bstate, keep)
            bform = typeslib.take_rows(bform, rows)
            scarry = typeslib.take_rows(scarry, rows)
            fsms = [fsms[k] for k in keep]
            torig = [torig[k] for k in keep]
            specs_per = [specs_per[k] for k in keep]
            gains_cache = [gains_cache[k] for k in keep]
            admm_carries = [admm_carries[k] for k in keep]
            pending_go = [pending_go[k] for k in keep]
            pending_dispatch = [pending_dispatch[k] for k in keep]
        bc = len(fsms)
        inputs = _batch_inputs(chunk, bc, n,
                               [b for b in range(bc) if pending_go[b]], dev,
                               dtype)
        pending_go = [False] * bc
        with _profiler(cfg, chunk_idx, dev):
            bstate, scarry, summ = sumlib.batched_rollout_summary(
                bstate, scarry, bform, cgains, sparams, fly_cfg, chunk,
                inputs, 0, window=window,
                takeoff_alt=float(sparams.takeoff_alt))
        # the chunk's host reads: two copies for the whole wave
        host = sumlib.to_host(summ)
        if checks:
            # each live trial's codes, attributed to its original index
            for b, fsm in enumerate(fsms):
                if not fsm.done:
                    invlib.raise_on_violation(host["inv_code"][b],
                                              trial=torig[b],
                                              tick0=ticks_done)
        if tel_on:
            # finished rows stop publishing (their counters froze)
            for b, fsm in enumerate(fsms):
                if not fsm.done:
                    publisher.publish(torig[b],
                                      devtel.to_host(host["tel"], index=b))
        ticks_done += chunk
        auc_ok = host["auctioned"] & host["assign_valid"]

        for b, fsm in enumerate(fsms):
            if fsm.done:
                continue
            acts = fsm.process_chunk(host["conv_all"][b], host["grid_any"][b],
                                     host["taken_off"][b], auc_ok[b],
                                     host["reassigned"][b])
            fsm.observe_cumdist(host["cumdist"][b])
            for act in acts:
                if act == "takeoff":
                    pending_go[b] = True
                elif act == "dispatch":
                    pending_dispatch[b] = fsm.curr_formation_idx

        # formation commits take effect at the chunk boundary (the serial
        # driver's dispatch latency), rewriting one row each
        for b, fsm in enumerate(fsms):
            idx = pending_dispatch[b]
            pending_dispatch[b] = None
            if idx is None or fsm.done:
                continue
            spec = specs_per[b][idx]
            solve_st = None
            if idx not in gains_cache[b]:
                g, new_carry, solve_st = _dispatch_gains(
                    cfg, spec, n, carry=admm_carries[b], device=dev,
                    dtype=dtype)
                if cfg.warm_gains:
                    admm_carries[b] = new_carry
                gains_cache[b][idx] = g
            typeslib.set_row(bform, b, make_formation(
                spec.points, spec.adjmat, gains_cache[b][idx], device=dev,
                dtype=dtype))
            # the auctioneer's identity reset and an auction on the
            # formation's first tick, as `run_trial` re-phases
            bstate.v2f[b] = permutil.identity(n, dev)
            bstate.first_auction[b] = True
            bstate.assign_enabled[b] = True
            bstate.tick[b] = 0
            if tel_on and solve_st is not None:
                _set_solve(bstate.tel, solve_st, b)
            fsm.formation_dispatched()

        # chunk boundary: checkpoint first, then the scripted-preemption
        # hook, so a crash at boundary k resumes from k
        chunk_idx += 1
        if ckpt_dir is not None and not all(f.done for f in fsms) \
                and chunk_idx % max(1, cfg.checkpoint_every) == 0:
            row_of = {t: i for i, t in enumerate(trial_indices)}
            payload = {
                "state": convert.sim_state_to_numpy(bstate),
                "bform": _formation_payload(bform),
                "scarry": convert.summary_carry_to_numpy(scarry),
                "fsms": [f.snapshot() for f in all_fsms],
                "live_rows": [row_of[t] for t in torig],
                "gains_cache": [{str(k): _host(v) for k, v in g.items()}
                                for g in gains_cache],
                "admm_carries": [_carry_payload(c) for c in admm_carries],
                "pending_go": list(pending_go),
                "pending_dispatch": list(pending_dispatch),
                "ticks_done": ticks_done,
            }
            ckptlib.write_checkpoint(
                ckpt_dir, stem, payload,
                ckptlib.make_manifest("trial_batch", cfg_hash, chunk_idx,
                                      fingerprint, trials=trials_key,
                                      ticks_done=ticks_done))
        maybe_crash("batch", chunk_idx)

    if ckpt_dir is not None and all(f.done for f in all_fsms):
        ckptlib.clear_checkpoints(ckpt_dir, stem)
    for f in all_fsms:
        f.execution = {}
    return all_fsms


def analyze(data: np.ndarray, n: int, m: int) -> dict:
    """CSV reduction (`analyze_simtrials.m`): completion %, totals across
    the formation cycle, mean/std statistics."""
    data = np.atleast_2d(np.asarray(data, dtype=np.float64))
    if data.size == 0:
        return {"completion_pct": 0.0, "trials_completed": 0, "trials": m}
    f = (data.shape[1] - 1 - n) // 3
    r = 1
    dist = data[:, r:r + n]; r += n
    time = data[:, r:r + f]; r += f
    coltime = data[:, r:r + f]; r += f
    nassign = data[:, r:r + f]
    total_time = time.sum(axis=1)
    total_col = coltime.sum(axis=1)
    total_assign = nassign.sum(axis=1)
    avgdist = dist.mean(axis=1)
    return {
        "trials": m,
        "trials_completed": int(data.shape[0]),
        "completion_pct": 100.0 * data.shape[0] / m,
        "formations_per_trial": int(f),
        "time_mean_s": float(total_time.mean()),
        "time_std_s": float(total_time.std()),
        "colavoid_time_mean_s": float(total_col.mean()),
        "colavoid_time_std_s": float(total_col.std()),
        "assignments_mean": float(total_assign.mean()),
        "assignments_std": float(total_assign.std()),
        "dist_min_m": float(avgdist.min()),
        "dist_mean_m": float(avgdist.mean()),
        "dist_std_m": float(avgdist.std()),
    }


def print_analysis(stats: dict) -> None:
    print(f"Completion: {stats['completion_pct']:.2f} % "
          f"({stats['trials_completed']}/{stats['trials']})")
    if stats["trials_completed"] == 0:
        return
    print(f"Average Time: {stats['time_mean_s']:.2f} s "
          f"(std {stats['time_std_s']:.2f})")
    print(f"Average Time in ColAvoid: {stats['colavoid_time_mean_s']:.2f} s "
          f"(std {stats['colavoid_time_std_s']:.2f})")
    print(f"Average Num Assignments: {stats['assignments_mean']:.2f} "
          f"(std {stats['assignments_std']:.2f})")
    print(f"Average Distance: min {stats['dist_min_m']:.2f} / "
          f"mean {stats['dist_mean_m']:.2f} / std {stats['dist_std_m']:.2f} m")


def _csv_trial_ids(path: str) -> set[int]:
    """Trial ids (column 0) already appended to the CSV, read once at
    `run_trials` start: resumed runs use them to make appends
    idempotent."""
    p = Path(path)
    ids: set[int] = set()
    if not p.exists():
        return ids
    with open(p) as f:
        for line in f:
            first = line.split(",", 1)[0].strip()
            try:
                ids.add(int(float(first)))
            except ValueError:
                continue
    return ids


_FSM_CLASSES = {"TrialFSM": TrialFSM, "SummaryTrialFSM": SummaryTrialFSM}


def _write_done_marker(cfg: TrialConfig, key: str, pairs: list) -> None:
    """Persist finished trials (``pairs`` = [(trial_idx, fsm), ...]) so a
    resumed `run_trials` replays their results instead of recomputing
    them."""
    payload = {"trials": [
        {"trial": int(t), "cls": type(f).__name__, "snap": f.snapshot(),
         "ctor": {"n_vehicles": f.n, "n_formations": f.n_formations,
                  "takeoff_alt": float(f.takeoff_alt), "dt": f.dt,
                  "trial_timeout": f.trial_timeout}}
        for t, f in pairs]}
    ckptlib.write_checkpoint(
        cfg.checkpoint_dir, f"{key}.done", payload,
        ckptlib.make_manifest("trials_done", _ckpt_cfg_hash(cfg), 0,
                              _fingerprint(cfg), key=key),
        keep=1)


def _load_done_marker(cfg: TrialConfig, key: str):
    """[(trial_idx, restored fsm), ...] from a done-marker, or None when
    there is none. A mismatched marker raises `CheckpointMismatch`."""
    path = ckptlib.latest_checkpoint(cfg.checkpoint_dir, f"{key}.done")
    if path is None:
        return None
    payload, _ = ckptlib.load_checkpoint(
        path, expected=ckptlib.expected_manifest(
            "trials_done", _ckpt_cfg_hash(cfg), _fingerprint(cfg), key=key))
    out = []
    for rec in payload["trials"]:
        fsm = _FSM_CLASSES[rec.get("cls", "TrialFSM")](**rec["ctor"])
        fsm.restore(rec["snap"])
        out.append((int(rec["trial"]), fsm))
    return out


def run_trials(cfg: TrialConfig) -> dict:
    """The `trials.sh` loop: K seeded trials, completed rows appended to
    the CSV as each trial finishes, the `analyze_simtrials` summary
    returned (and printed when verbose).

    With ``cfg.batch`` > 1 the trials fly in waves of ``batch``
    (`run_trial_batch`); rows are appended as each trial (serial) or wave
    (batched) finishes, in trial order either way.

    With ``cfg.checkpoint_dir`` every finished trial or wave leaves a
    done-marker and the trial or wave in flight checkpoints at chunk
    boundaries: a killed run resumed with the same config replays finished
    results and continues the interrupted one bit for bit; CSV appends are
    idempotent by trial id."""
    _check_dtype(cfg)
    rows = []
    n = None
    ckpt = cfg.checkpoint_dir is not None
    appended_ids = _csv_trial_ids(cfg.out) if ckpt else set()

    def _log_and_append(t, fsm, replayed=False):
        nonlocal n
        n = fsm.n
        if cfg.verbose:
            times = ", ".join(f"{x:.2f}" for x in fsm.times)
            replay = " [resumed]" if replayed else ""
            print(f"trial {t} (seed {cfg.seed + t}): {NAMES[fsm.state]}"
                  f" [conv times: {times}]{replay}", flush=True)
        if fsm.completed:
            row = fsm.csv_row(t)
            rows.append(row)
            if not (ckpt and t in appended_ids):
                with open(cfg.out, "a", newline="") as f:
                    csv.writer(f).writerow(row)
                appended_ids.add(t)

    if cfg.batch > 1:
        waves = [list(range(start, min(start + cfg.batch, cfg.trials)))
                 for start in range(0, cfg.trials, cfg.batch)]
    else:
        waves = [[t] for t in range(cfg.trials)]
    for idxs in waves:
        key = f"wave{idxs[0]:05d}" if cfg.batch > 1 else f"trial{idxs[0]:05d}"
        done = _load_done_marker(cfg, key) if ckpt and cfg.resume else None
        if done is not None:
            for t, fsm in done:
                _log_and_append(t, fsm, replayed=True)
            continue
        if cfg.batch > 1:
            pairs = list(zip(idxs, run_trial_batch(cfg, idxs)))
        else:
            pairs = [(idxs[0], run_trial(cfg, idxs[0]))]
        for t, fsm in pairs:
            _log_and_append(t, fsm)
        if ckpt:
            _write_done_marker(cfg, key, pairs)
    if rows:
        stats = analyze(np.asarray(rows, dtype=np.float64), n, cfg.trials)
    else:
        stats = analyze(np.empty((0, 0)), n or 0, cfg.trials)
    if cfg.telemetry_dump:
        get_registry().dump(cfg.telemetry_dump)
        if cfg.verbose:
            print(f"telemetry: wrote {cfg.telemetry_dump}")
    if cfg.verbose:
        print_analysis(stats)
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Monte-Carlo formation trials (trials.sh equivalent)")
    ap.add_argument("-f", "--formation", default=None,
                    help="formation group or simformN")
    ap.add_argument("-m", "--trials", type=int, default=None)
    ap.add_argument("-s", "--seed", type=int, default=None)
    ap.add_argument("-o", "--out", default=None, help="CSV output path")
    ap.add_argument("--config", default=None, help="yaml config file")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="config override")
    ap.add_argument("--save-config", default=None,
                    help="write the resolved config to this yaml and exit")
    ap.add_argument("--analyze", default=None, metavar="CSV",
                    help="only analyze an existing results file")
    ap.add_argument("-n", "--agents", type=int, default=None,
                    help="(with --analyze) vehicle count of the CSV")
    args = ap.parse_args(argv)

    if args.analyze:
        if args.agents is None or args.trials is None:
            ap.error("--analyze requires -n (agents) and -m (total trials)")
        data = np.loadtxt(args.analyze, delimiter=",", ndmin=2)
        print_analysis(analyze(data, args.agents, args.trials))
        return 0

    overrides = dict(configlib.parse_overrides(args.set))
    for key in ("formation", "trials", "seed", "out"):
        val = getattr(args, key)
        if val is not None:
            overrides[key] = str(val)
    cfg = configlib.load_layers(TrialConfig, file=args.config,
                                overrides=overrides)
    if args.save_config:
        configlib.to_yaml(cfg, args.save_config)
        print(f"wrote {args.save_config}")
        return 0
    stats = run_trials(cfg)
    return 0 if stats["trials_completed"] == stats["trials"] else 1


if __name__ == "__main__":
    sys.exit(main())

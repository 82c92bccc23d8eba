"""One run of one cell: set-up, the measured window, the replay that
captures the stages the reference checks, and the reading of a trace.

The program under test is `aclswarm_torch`. The window drives its per-chunk
path of a batched Monte-Carlo wave, `sim.summary.batched_rollout_summary`
then `sim.summary.to_host`, chunk after chunk, flying segments of
``segment_ticks`` ticks that each start again from a device copy of one
start state. Nothing else of the program is called in the window.

Everything particular to a configuration, a traffic mix, a cell or a
per-layer metric is a file found by name: `configs/<config>.json`,
`traffic/<traffic>.json`, `workloads/<cell>.json`, `metrics/<metric>.py`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

from swarmbench.traffic import formgen

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUFFER_SECONDS = 1.0     # the supervisor's trailing window (upstream)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict        # the cell's entry in BENCHMARK.json
    config: dict       # configs/<config>.json
    traffic: dict      # traffic/<traffic>.json
    workload: dict     # workloads/<cell>.json (limits of the checks)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name=name, entry=entry, config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                workload=load_json(HERE / "workloads" / f"{name}.json"))


def load_reader(metric: str):
    """The per-layer metric's reader, `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "swarmbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- set-up ---------------------------------------------------------------

@dataclasses.dataclass
class Setup:
    cfg: dict
    traffic: dict
    device: torch.device
    dtype: torch.dtype
    trials: list           # per trial: {"adj", "points", "start"} (host)
    gains: list            # per trial: the program's (3n, 3n) design
    form: object           # the program's batched Formation
    start: object          # the program's batched SimState at dispatch
    carry: object          # the summary carry at dispatch
    simcfg: object
    cgains: object
    sparams: object
    window: int
    takeoff_alt: float


def program_params(cfg: dict, traffic: dict, telemetry: bool):
    """The configuration's `SimConfig`, `ControlGains`, `SafetyParams`, as
    the trial driver builds them (its ``_engine_kw``, ``flight_fsm=True``,
    the sanitizer off)."""
    from aclswarm_torch import sim
    from aclswarm_torch.core.types import ControlGains, SafetyParams

    simcfg = sim.SimConfig(
        assignment=cfg["assignment"], control_dt=cfg["control_dt"],
        assign_every=traffic["assign_every"], dynamics=cfg["dynamics"],
        tau=cfg["tau"], kp_track=cfg["kp_track"], kd_track=cfg["kd_track"],
        localization=cfg["localization"], flood_every=cfg["flood_every"],
        flood_block=cfg["flood_block"], flood_phases=cfg["flood_phases"],
        colavoid_neighbors=cfg["colavoid_neighbors"],
        assign_eps=cfg["assign_eps"],
        cbaa_task_block=cfg["cbaa_task_block"], check_mode="off",
        telemetry="on" if telemetry else "off", flight_fsm=True)
    cgains = ControlGains(**cfg["control"])
    sparams = SafetyParams(
        bounds_min=(-cfg["room_x"], -cfg["room_y"], 0.0),
        bounds_max=(cfg["room_x"], cfg["room_y"], cfg["room_z"]),
        **cfg["safety"])
    return simcfg, cgains, sparams


def design_gains(cfg: dict, trial: dict, device):
    """The trial's gains as a formation dispatch designs them: the port's
    ADMM solve in float32 with the n-4 non-edge bucket of a random simformN
    graph, times the configuration's gain scale."""
    from aclswarm_torch.gains import solve_gains

    n = trial["points"].shape[0]
    pts = np.asarray(trial["points"], dtype=cfg["dtype"])
    g = solve_gains(pts, trial["adj"], max_nonedges=max(n - 4, 1),
                    device=device)
    return g * cfg["gain_scale"]


def build(cfg: dict, traffic: dict, seed: int, device, telemetry=False,
          trials: list | None = None, timings: dict | None = None) -> Setup:
    """The wave's B trials, their gains, and the batched state a wave
    reaches at its first dispatch. Trial b is drawn from ``seed + b``, as
    the wave driver draws it. The state is airborne at the takeoff
    altitude over the sampled starts, FLYING, tables holding the true
    starts, the formation committed, auctions enabled and the first one
    due. ``timings`` gets the host seconds of the draws and the design."""
    from aclswarm_torch import sim
    from aclswarm_torch.core import types as typeslib
    from aclswarm_torch.sim import summary as sumlib

    dev = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    B = int(traffic["batch"])
    timings = {} if timings is None else timings
    t = time.perf_counter()
    if trials is None:
        trials = [formgen.draw_trial(cfg, seed + b) for b in range(B)]
    timings["draw_s"] = time.perf_counter() - t
    simcfg, cgains, sparams = program_params(cfg, traffic, telemetry)
    t = time.perf_counter()
    gains = [design_gains(cfg, tr, dev) for tr in trials]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    timings["design_s"] = time.perf_counter() - t
    alt = float(sparams.takeoff_alt)
    starts = []
    for tr in trials:
        q0 = np.array(tr["start"], dtype=np.float64)
        q0[:, 2] = alt
        starts.append(q0)
    start = sim.stack_states([
        sim.init_state(q0, flying=True, localization=True,
                       telemetry=telemetry, device=dev, dtype=dtype)
        for q0 in starts])
    form = typeslib.make_formations(
        np.stack([t["points"] for t in trials]),
        np.stack([t["adj"] for t in trials]), torch.stack(gains),
        device=dev, dtype=dtype)
    window = max(1, int(round(BUFFER_SECONDS / cfg["control_dt"])))
    carry = sumlib.init_carry(int(cfg["n"]), window, dtype=dtype,
                              device=dev, batch=B)
    return Setup(cfg=cfg, traffic=traffic, device=dev, dtype=dtype,
                 trials=trials, gains=gains, form=form, start=start,
                 carry=carry, simcfg=simcfg, cgains=cgains, sparams=sparams,
                 window=window, takeoff_alt=alt)


def clone_tree(tree):
    from aclswarm_torch.core import types as typeslib

    return typeslib.tree_map(torch.clone, tree)


def chunk_inputs(S: Setup):
    """A chunk's operator inputs, as the wave driver builds them every
    chunk: no command, no joystick."""
    from aclswarm_torch.sim.vehicle import ExternalInputs

    T, B, n = S.traffic["chunk"], S.traffic["batch"], S.cfg["n"]
    z = dict(device=S.device)
    return ExternalInputs(
        cmd=torch.zeros((T, B), dtype=torch.int32, **z),
        joy_vel=torch.zeros((T, B, n, 3), dtype=S.dtype, **z),
        joy_yawrate=torch.zeros((T, B, n), dtype=S.dtype, **z),
        joy_active=torch.zeros((T, B, n), dtype=torch.bool, **z))


def run_chunk(S: Setup, state, carry):
    """The timed entry: one chunk of the wave and its two host copies."""
    from aclswarm_torch.sim import summary as sumlib

    state, carry, summ = sumlib.batched_rollout_summary(
        state, carry, S.form, S.cgains, S.sparams, S.simcfg,
        S.traffic["chunk"], chunk_inputs(S), 0, window=S.window,
        takeoff_alt=S.takeoff_alt)
    return state, carry, sumlib.to_host(summ)


FLAGS = ("conv_all", "grid_any", "taken_off", "all_flying", "auctioned",
         "assign_valid", "reassigned")


def summary_record(host: dict) -> dict:
    out = {k: np.asarray(host[k]) for k in FLAGS}
    out["cumdist"] = np.asarray(host["cumdist"])
    if "tel" in host:
        out["tel"] = {k: np.asarray(v) for k, v in host["tel"].items()}
    return out


# --- spans and captures: module attributes the engine looks up per call ---

def _targets():
    import aclswarm_torch.control as control
    from aclswarm_torch import ops
    from aclswarm_torch.assignment import cbaa, sinkhorn
    from aclswarm_torch.sim import engine
    from aclswarm_torch.sim import localization as loclib

    return {
        "engine.step": (engine, "step"),
        "engine.assign": (engine, "assign"),
        "localization.tick_phased": (loclib, "tick_phased"),
        "localization.tick": (loclib, "tick"),
        "control.compute": (control, "compute"),
        "control.collision_avoidance": (control, "collision_avoidance"),
        "sinkhorn.sinkhorn_assign": (sinkhorn, "sinkhorn_assign"),
        "sinkhorn.round_dominant": (sinkhorn, "round_dominant"),
        "cbaa.cbaa_assign": (cbaa, "cbaa_assign"),
        "ops.sinkhorn_log": (ops, "sinkhorn_log"),
        "ops.round_dominant": (ops, "round_dominant"),
        "ops.flood_merge": (ops, "flood_merge"),
    }


@contextlib.contextmanager
def patched(wrappers: dict):
    """Replace the named module attributes by ``wrappers[name](orig)`` for
    the block, and put the originals back after it."""
    targets = _targets()
    saved = []
    try:
        for name, make in wrappers.items():
            mod, attr = targets[name]
            orig = getattr(mod, attr)
            saved.append((mod, attr, orig))
            setattr(mod, attr, make(orig))
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


SPANS = ("engine.step", "engine.assign", "localization.tick_phased",
         "localization.tick", "control.compute",
         "control.collision_avoidance")


class SpanTimer:
    """`record_function` spans around the engine's layer calls, and the
    host seconds inside ``engine.step`` while ``count`` is on."""

    def __init__(self):
        self.count = False
        self.step_s = 0.0
        self.steps = 0
        self.kernel_calls: list = []     # (kernel, shapes) while ``record``
        self.record = False

    def wrappers(self) -> dict:
        from torch.profiler import record_function

        def span(name):
            def make(orig):
                def wrapped(*a, **kw):
                    with record_function(name):
                        return orig(*a, **kw)
                return wrapped
            return make

        out = {name: span(name) for name in SPANS}

        def step(orig):
            inner = span("engine.step")(orig)

            def wrapped(*a, **kw):
                if not self.count:
                    return inner(*a, **kw)
                t = time.perf_counter()
                res = inner(*a, **kw)
                self.step_s += time.perf_counter() - t
                self.steps += 1
                return res
            return wrapped
        out["engine.step"] = step

        def shapes(kernel):
            def make(orig):
                def wrapped(*a, **kw):
                    if self.record:
                        self.kernel_calls.append((kernel, call_shape(
                            kernel, a, kw)))
                    return orig(*a, **kw)
                return wrapped
            return make
        out["ops.sinkhorn_log"] = shapes("K1")
        out["ops.round_dominant"] = shapes("K2")
        out["ops.flood_merge"] = shapes("K3")
        return out


def call_shape(kernel: str, a: tuple, kw: dict) -> dict:
    """The sizes a kernel call's operations and bytes follow from."""
    if kernel == "K1":
        cost = a[0]
        iters = a[2] if len(a) > 2 else kw.get("n_iters", 200)
        return {"shape": tuple(cost.shape), "iters": int(iters)}
    if kernel == "K2":
        return {"shape": tuple(a[0].shape)}
    packed, comm = a[0], a[1]
    return {"shape": tuple(packed.shape), "comm": tuple(comm.shape)}


# --- the measured window -------------------------------------------------

@dataclasses.dataclass
class Window:
    records: list          # (chunk index in its segment, summary record)
    ticks: int
    seconds: float
    attempted: int
    failed: int
    peak_bytes: int
    chunk_s: list          # host seconds of each chunk
    trace: dict | None = None


def tally(rec: dict) -> tuple[int, int]:
    """Trial-auctions attempted, and those that failed plus trial-chunks
    whose state went non-finite."""
    auc, ok = rec["auctioned"], rec["assign_valid"]
    bad = int(np.sum(auc & ~ok))
    bad += int(np.sum(~np.all(np.isfinite(rec["cumdist"]), axis=-1)))
    return int(np.sum(auc)), bad


def run_window(S: Setup, seconds: float, trace: bool = False,
               spans: SpanTimer | None = None) -> Window:
    """Chunks from the start state until ``seconds`` have passed, to the
    next chunk boundary; every ``segment_ticks`` ticks the wave starts
    again from a device copy of the start. A traced run profiles chunk 1
    for the device alone and chunk 2 with the host's spans, and times the
    host inside ``engine.step`` over the chunks not profiled."""
    T, seg = S.traffic["chunk"], S.traffic["segment_ticks"]
    per_seg = max(1, seg // T)
    cuda = S.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    records, traced, chunk_s = [], {}, []
    state, carry = clone_tree(S.start), clone_tree(S.carry)
    k = chunks = 0
    sync()
    t0 = time.perf_counter()
    while True:
        tc = time.perf_counter()
        prof_kind = None
        if trace and chunks in (1, 2):
            prof_kind = "device" if chunks == 1 else "spans"
        if spans is not None:
            spans.count = trace and prof_kind is None
            spans.record = prof_kind == "device"
        if prof_kind is None:
            state, carry, host = run_chunk(S, state, carry)
        else:
            with profiled(prof_kind) as box:
                state, carry, host = run_chunk(S, state, carry)
            traced[prof_kind] = box
        records.append((k, summary_record(host)))
        chunk_s.append(time.perf_counter() - tc)
        chunks += 1
        k += 1
        if k >= per_seg:
            state, carry = clone_tree(S.start), clone_tree(S.carry)
            k = 0
        if time.perf_counter() - t0 >= seconds and (not trace or chunks >= 3):
            break
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    att = bad = 0
    for _, rec in records:
        a, b = tally(rec)
        att, bad = att + a, bad + b
    if spans is not None:
        spans.count = spans.record = False
    return Window(records=records, ticks=chunks * T, seconds=elapsed,
                  attempted=att, failed=bad, peak_bytes=peak,
                  chunk_s=chunk_s, trace=traced or None)


@contextlib.contextmanager
def profiled(kind: str):
    """Profile the block: ``device`` records the card's activity alone
    (no host-side recording to slow the host), ``spans`` the host's spans
    and runtime calls beside it. A traced warm-up step of one small kernel
    comes first, so the tracer records before the block starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA]
    if kind == "spans":
        acts.append(ProfilerActivity.CPU)
    box = {}
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t = time.perf_counter()
        yield box
        torch.cuda.synchronize()
        box["host_s"] = time.perf_counter() - t
        prof.step()
    box["events"] = [event_tuple(e)
                     for e in prof.profiler.kineto_results.events()]


def event_tuple(e) -> tuple:
    """(name, device type, start ns, duration ns, correlation id, linked
    correlation id, is a user annotation) of a profiler event."""
    linked = getattr(e, "linked_correlation_id", None)
    annot = getattr(e, "is_user_annotation", None)
    return (e.name(), str(e.device_type()), e.start_ns(), e.duration_ns(),
            e.correlation_id(), linked() if linked else -1,
            bool(annot()) if annot else e.name() in SPANS)


# --- the result ----------------------------------------------------------

def device_info(cuda: bool) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    import subprocess

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def sim_s_per_s(S: Setup, w: Window) -> float:
    """Simulated trial-seconds over wall seconds, summed over the wave:
    every tick of the window for each of its B trials."""
    return w.ticks * S.traffic["batch"] * S.cfg["control_dt"] / w.seconds


def per_layer(cell: Cell, bench: dict, reading) -> dict:
    """Each per-layer metric of this cell that its reader finds."""
    out = {}
    for m in bench["per_layer"]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        value = load_reader(m["name"]).read(reading)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def needs_telemetry(cell: Cell, bench: dict) -> bool:
    for m in bench["per_layer"]:
        if cell.name in m.get("workloads", [cell.name]) and getattr(
                load_reader(m["name"]), "NEEDS_TELEMETRY", False):
            return True
    return False


def json_line(obj) -> str:
    def fix(x):
        if isinstance(x, float) and not math.isfinite(x):
            return None
        if isinstance(x, dict):
            return {k: fix(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [fix(v) for v in x]
        return x
    return json.dumps(fix(obj))

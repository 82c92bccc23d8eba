"""The comparison that decides a run's ``correct``.

After the window closes, the harness flies a segment again from its start
through the furthest sampled chunk, through the same entry
(`harness.run_chunk`), with the engine's stage calls wrapped to keep what
each sampled tick read and produced. Its chunk summaries are held equal to
the window's, so these are the window's ticks. The plain reference (`reference/swarm.py`, float64) then redoes each
stage of each trial at the sampled ticks from the program's state before
the tick, and each number below counts or measures how far the program's
output lies from it:

- ``replay_diff``: summary entries of the window that differ from the
  replay's, or from the same chunk of another segment (exact);
- ``gain_kernel``, ``gain_offgraph``, ``gain_trace``, ``gain_indefinite``:
  every gain design of the set-up against what a design guarantees (its
  kernel, its graph, its trace, negative definite off the kernel);
  ``gain_gap``, ``gain_margin``: the design of one trial drawn from the
  seed against the float64 reference design (`reference/gains.py`) of
  the same formation, by the relative distance of the matrices and of
  the objective the design maximizes (its eigenvalue margin);
- ``loc_off``: estimate-table entries off the reference's flood (exact);
- ``align_excess``, ``plan_err``, ``round_off``, ``price_off``,
  ``assign_gap``: the assignment's alignment (the relative excess of the
  least-squares cost it minimizes over the reference's, per vehicle for
  CBAA's local ones: a rotation is ill-determined where the swarm and
  the formation hardly correlate, and this cost is flat there), then,
  from the program's alignment, Sinkhorn's plan (K1), its
  rounding (K2, on K1's plan), CBAA's consensus (tasks whose winner or
  price differ from the reference auction's on the program's alignment,
  prices beyond 1e-6 relative), and the relative
  excess distance of the assignment the program took over the
  reference's;
- ``ctrl_off``, ``avoid_off``: vehicles whose control command, or whose
  saturated and avoided velocity, is off the reference's by more than
  1 mm/s (or whose avoidance flag differs); a command may also differ by
  what its pairs within 1 mm of a deadband would change if they switched
  sides (rounding of the desired distances flips such near-ties);
- ``state_err``: the largest gap of position, velocity and goal after the
  shim, the flight modes and the dynamics (m, m/s);
- ``summary_off``: supervisor flags and path lengths of a chunk off the
  reference's reduction of that chunk's ticks.

A stage's input is the program's own state or the output of the stage
before it, which the reference has judged: the reference follows the
program tick by tick and stage by stage, as it cannot follow a chaotic
swarm of 1000 for a segment on its own. The control is the reference run
in bfloat16 in the program's place (`control_outputs`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from swarmbench import harness
from swarmbench.reference import gains as refgains
from swarmbench.reference import swarm as ref

TOL_VEL = 1e-3       # m/s: a vehicle's command is "off" beyond this
TIE = 1e-3           # m: a range error this near a deadband may flip
PRICE_TOL = 1e-6     # relative: a consensus price is "off" beyond this
SUMMARY_TOL = 1e-4   # relative: a path length is "off" beyond this


# --- the replay and its captures ------------------------------------------

class Capture:
    """Wrappers that keep, at the sampled ticks of the replay, each
    stage's inputs and outputs, and every tick's metrics of one chunk."""

    def __init__(self, ticks: set, summary_chunk: int, chunk: int):
        self.want, self.summary_chunk, self.T = ticks, summary_chunk, chunk
        self.k = self.t = 0
        self.cur = None
        self.ticks: dict = {}
        self.summary_metrics: list = []

    def wrappers(self) -> dict:
        def step(orig):
            def wrapped(state, *a, **kw):
                key = (self.k, self.t)
                if key in self.want:
                    self.cur = {"state_in": state, "cbaa": []}
                    out = orig(state, *a, **kw)
                    self.cur.update(state_out=out[0], metrics=out[1],
                                    shared_tick=kw.get("shared_tick"))
                    self.ticks[key] = self.cur
                    self.cur = None
                else:
                    out = orig(state, *a, **kw)
                if self.k == self.summary_chunk:
                    self.summary_metrics.append(out[1])
                self.t += 1
                if self.t == self.T:
                    self.k, self.t = self.k + 1, 0
                return out
            return wrapped

        def keep(name, args=()):
            def make(orig):
                def wrapped(*a, **kw):
                    out = orig(*a, **kw)
                    if self.cur is not None:
                        rec = {"args": [a[i] for i in args], "out": out}
                        if name == "cbaa":
                            self.cur["cbaa"].append(rec)
                        else:
                            self.cur[name] = rec
                    return out
                return wrapped
            return make

        return {"engine.step": step,
                "sinkhorn.sinkhorn_assign": keep("sinkhorn", (0, 1)),
                "sinkhorn.round_dominant": keep("round", (0,)),
                "cbaa.cbaa_assign": keep("cbaa", (1,)),
                "control.compute": keep("ctrl", (2,)),
                "control.collision_avoidance": keep("avoid", (0, 1))}


def sample_ticks(seed: int, traffic: dict, chunks: int) -> tuple[list, int]:
    """The sampled ticks, drawn from the seed over the first ``chunks``
    chunks of a segment (at most a segment, and no further than the window
    flew): the first tick of chunk 0 (the first auction after the
    dispatch), the first tick of another chunk (an auction under
    hysteresis), one other tick of each of two chunks, and the chunk whose
    summary is checked."""
    T = int(traffic["chunk"])
    K = max(1, min(chunks, int(traffic["segment_ticks"]) // T))
    rng = np.random.default_rng(seed)
    k = [int(x) for x in rng.integers(0, K, size=4)]
    t = [int(x) for x in rng.integers(1, T, size=2)] if T > 1 else [0, 0]
    auction = int(rng.integers(1, K)) if K > 1 else 0
    ticks = [(0, 0), (auction, 0), (k[0], t[0]), (k[1], t[1])]
    return sorted(set(ticks)), k[2]


def replay(S, seed: int, chunks: int):
    """The sampled chunks of a segment again, from its start through the
    furthest of them, through the timed entry, with the stage captures on.
    Returns (capture, [summary record per chunk], the summary carry before
    the checked chunk)."""
    ticks, sc = sample_ticks(seed, S.traffic, chunks)
    cap = Capture(set(ticks), sc, int(S.traffic["chunk"]))
    state, carry = harness.clone_tree(S.start), harness.clone_tree(S.carry)
    recs, carry_in = [], None
    with harness.patched(cap.wrappers()):
        for k in range(max(max(t[0] for t in ticks), sc) + 1):
            if k == sc:
                carry_in = carry
            state, carry, host = harness.run_chunk(S, state, carry)
            recs.append(harness.summary_record(host))
    return cap, recs, carry_in


def replay_diff(window_records: list, recs: list) -> int:
    """Entries of the window's chunk summaries unequal to the replay's
    (chunks the replay ran) or to the window's first run of that chunk."""
    first: dict = {}
    bad = 0
    for k, rec in window_records:
        base = recs[k] if k < len(recs) else first.setdefault(k, rec)
        for key in harness.FLAGS + ("cumdist",):
            a, b = np.asarray(rec[key]), np.asarray(base[key])
            bad += int(np.sum(a != b)) if a.shape == b.shape else a.size
    return bad


# --- the reference, and the candidate outputs it judges -------------------

def _f(x, dtype=torch.float64):
    return x.detach().to(dtype)


def _knobs(S):
    """The control law's and the shim's values, from the configuration."""
    s = dict(S.cfg["safety"])
    s["bounds_min"] = (-S.cfg["room_x"], -S.cfg["room_y"], 0.0)
    s["bounds_max"] = (S.cfg["room_x"], S.cfg["room_y"], S.cfg["room_z"])
    return dict(S.cfg["control"]), s


def trial_inputs(S, tick: dict, b: int, dev) -> dict:
    """Trial ``b``'s state before the tick (float64), and the benchmark's
    own formation of it."""
    st = tick["state_in"]
    tr = S.trials[b]
    return {
        "q": _f(st.swarm.q[b]), "vel": _f(st.swarm.vel[b]),
        "goal": {"pos": _f(st.goal.pos[b]), "vel": _f(st.goal.vel[b]),
                 "yaw": _f(st.goal.yaw[b]), "dyaw": _f(st.goal.dyaw[b])},
        "mode": st.flight.mode[b], "est": _f(st.loc.est[b]),
        "age": st.loc.age[b], "v2f": st.v2f[b].long(),
        "first": bool(st.first_auction[b]),
        "enabled": bool(st.assign_enabled[b]),
        "points": torch.as_tensor(tr["points"], dtype=torch.float64,
                                  device=dev),
        "adj": torch.as_tensor(tr["adj"], dtype=torch.float64, device=dev),
    }


def program_outputs(S, tick: dict, b: int) -> dict:
    """What the program produced at the tick for trial ``b``."""
    out = tick["state_out"]
    res = {"est": _f(out.loc.est[b]), "age": out.loc.age[b],
           "v2f": out.v2f[b].long(), "q": _f(out.swarm.q[b]),
           "vel": _f(out.swarm.vel[b]), "goal_pos": _f(out.goal.pos[b]),
           "goal_vel": _f(out.goal.vel[b]), "mode": out.flight.mode[b],
           "ctrl": _f(tick["ctrl"]["out"][b]),
           "avoid": _f(tick["avoid"]["out"][0][b]),
           "avoid_flag": tick["avoid"]["out"][1][b]}
    if "sinkhorn" in tick:
        res["aligned"] = _f(tick["sinkhorn"]["args"][1][b])
        res["plan"] = _f(tick["sinkhorn"]["out"].plan_log[b])
        res["round_in"] = tick["round"]["args"][0][b].detach()
        res["round"] = tick["round"]["out"][b].long()
    if tick["cbaa"]:
        c = tick["cbaa"][b]
        res["aligned"] = _f(c["args"][0])
        res["price"] = _f(c["out"].price[0])
        res["who"] = c["out"].who[0].long()
    return res


def control_outputs(S, tick: dict, b: int, inp: dict, prog: dict,
                    dtype) -> dict:
    """The reference in ``dtype`` in the program's place: each stage from
    the same inputs the program's stage had."""
    k, s = _knobs(S)
    c = S.cfg
    lo = {key: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                else v) for key, v in inp.items()}
    est, age = ref.flood_tick(lo["est"], inp["age"], lo["q"], lo["adj"],
                              inp["v2f"], tick["shared_tick"],
                              c["flood_every"], c["flood_phases"])
    res = {"est": _f(est), "age": age}
    if "sinkhorn" in tick:
        r = ref.sinkhorn_assign(lo["q"], lo["points"], inp["v2f"],
                                inp["first"], c["assign_eps"])
        res.update(aligned=_f(r["aligned"]), plan=_f(r["plan"]),
                   v2f=r["v2f"],
                   round=ref.greedy_round(prog["round_in"].to(dtype)))
    elif tick["cbaa"]:
        al = ref.align_local(lo["q"], prog["est"].to(dtype), lo["points"],
                             lo["adj"], inp["v2f"])
        r = ref.cbaa(lo["q"], al, lo["adj"], inp["v2f"])
        res.update(aligned=_f(al), price=_f(r["price"][0]),
                   who=r["who"][0], v2f=r["v2f"])
    else:
        res["v2f"] = inp["v2f"]
    gains = S.gains[b].to(dtype)
    u = ref.control_law(lo["vel"], ref.relative_views(prog["est"].to(dtype)),
                        lo["points"],
                        lo["adj"], gains, prog["v2f"], k)
    res["ctrl"] = _f(u)
    flying = (inp["mode"] == ref.FLYING)[:, None]
    ain = ref.saturate(torch.where(flying, prog["ctrl"].to(dtype), 0.0), s)
    v, flag = ref.avoid(lo["q"], ain, s, c["colavoid_neighbors"])
    res["avoid"], res["avoid_flag"] = _f(v), flag & flying[:, 0]
    goal = {key: val.to(dtype) for key, val in inp["goal"].items()}
    q, vel, g, ok = ref.fly(lo["q"], lo["vel"], goal, inp["mode"],
                            prog["avoid"].to(dtype), s, c["control_dt"])
    res.update(q=_f(q), vel=_f(vel), goal_pos=_f(g["pos"]),
               goal_vel=_f(g["vel"]),
               mode=inp["mode"] if ok else torch.full_like(inp["mode"], -1))
    return res


def judge_tick(S, tick: dict, b: int, inp: dict, cand: dict,
               R: dict) -> dict:
    """The numbers of one trial at one tick: ``cand`` (the program's or a
    control's outputs) against the float64 reference ``R``."""
    out = {"loc_off": int((cand["est"] != R["est"]).any(-1).sum()
                          + (cand["age"] != R["age"]).sum())}
    if "aligned" in R:
        best = R["align_cost"](R["aligned"])
        got = R["align_cost"](cand["aligned"].to(best.dtype))
        out["align_excess"] = float(torch.clamp(
            (got - best) / best, min=0.0).max())
    if "plan" in R:
        n = R["plan"].shape[0]
        out["plan_err"] = float((cand["plan"].exp() - R["plan"].exp())
                                .abs().max() * n)
        out["round_off"] = int((cand["round"] != R["round"]).sum())
    if "price" in R:
        rp = R["price"]
        out["price_off"] = int((((cand["price"] - rp).abs()
                                 > PRICE_TOL * rp.abs())
                                | (cand["who"] != R["who"])).sum())
    if "cost" in R:
        idx = torch.arange(R["cost"].shape[0], device=R["cost"].device)
        c_ref = float(R["cost"][idx, R["v2f"]].sum())
        c_got = float(R["cost"][idx, cand["v2f"]].sum())
        out["assign_gap"] = max(0.0, c_got - c_ref) / c_ref
    du = (cand["ctrl"] - R["ctrl"]).abs().amax(-1)
    out["ctrl_off"] = int((du > TOL_VEL + R["ctrl_tie"]).sum())
    dv = (cand["avoid"] - R["avoid"]).abs().amax(-1)
    out["avoid_off"] = int(((dv > TOL_VEL)
                            | (cand["avoid_flag"] != R["avoid_flag"])).sum())
    err = max(float((cand[key] - R[key]).abs().max())
              for key in ("q", "vel", "goal_pos", "goal_vel"))
    if bool((cand["mode"] != R["mode"]).any()):
        err = math.inf
    out["state_err"] = err
    return out


def reference_outputs(S, tick: dict, b: int, inp: dict, prog: dict) -> dict:
    """The float64 reference's outputs at the tick, each stage from the
    program's state before it or its judged output of the stage before."""
    k, s = _knobs(S)
    c = S.cfg
    est, age = ref.flood_tick(inp["est"], inp["age"], inp["q"], inp["adj"],
                              inp["v2f"], tick["shared_tick"],
                              c["flood_every"], c["flood_phases"])
    R = {"est": est, "age": age}
    # the alignment is judged by the cost it minimizes, against the
    # reference's own; the solve after it from the program's alignment
    if "sinkhorn" in tick:
        al = ref.align_global(inp["points"], inp["q"], inp["v2f"])
        r = ref.sinkhorn_assign(inp["q"], inp["points"], inp["v2f"],
                                inp["first"], c["assign_eps"],
                                aligned=prog["aligned"])
        R.update(align_cost=lambda a: ref.align_cost_global(
            inp["q"], inp["v2f"], a), aligned=al, plan=r["plan"],
            v2f=r["v2f"], cost=r["cost"],
            round=ref.greedy_round(prog["round_in"].double()))
    elif tick["cbaa"]:
        al = ref.align_local(inp["q"], est, inp["points"], inp["adj"],
                             inp["v2f"])
        r = ref.cbaa(inp["q"], prog["aligned"], inp["adj"], inp["v2f"])
        d = torch.linalg.vector_norm(inp["q"][:, None, :] - prog["aligned"],
                                     dim=-1)
        R.update(align_cost=lambda a: ref.align_cost_local(
            est, inp["adj"], inp["v2f"], a), aligned=al,
            price=r["price"][0], who=r["who"][0], v2f=r["v2f"], cost=d)
    R["ctrl"], R["ctrl_tie"] = ref.control_law(
        inp["vel"], ref.relative_views(est), inp["points"], inp["adj"],
        _f(S.gains[b]), prog["v2f"], k, tie=TIE)
    flying = (inp["mode"] == ref.FLYING)[:, None]
    ain = ref.saturate(torch.where(flying, prog["ctrl"], 0.0), s)
    v, flag = ref.avoid(inp["q"], ain, s, c["colavoid_neighbors"])
    R["avoid"], R["avoid_flag"] = v, flag & flying[:, 0]
    q, vel, g, ok = ref.fly(inp["q"], inp["vel"], inp["goal"], inp["mode"],
                            prog["avoid"], s, c["control_dt"])
    R.update(q=q, vel=vel, goal_pos=g["pos"], goal_vel=g["vel"],
             mode=inp["mode"] if ok else torch.full_like(inp["mode"], -1))
    return R


def summary_numbers(S, cap: Capture, recs: list, carry, b: int,
                    dtype=None) -> int:
    """Flags and path lengths of the checked chunk for trial ``b`` that
    are off the reference's reduction of its ticks (``dtype``: the control
    reduces in that precision and is judged in its place)."""
    ms = cap.summary_metrics
    dt = torch.float64 if dtype is None else dtype
    dn = torch.stack([_f(m.distcmd_norm[b], dt) for m in ms])
    ca = torch.stack([m.ca_active[b] for m in ms])
    qs = torch.stack([_f(m.q[b], dt) for m in ms])
    modes = torch.stack([m.mode[b] for m in ms])
    thr = {"conv": 1.0, "grid": 0.95, "zero_pos": 0.05, "ewma": 0.98}
    args = (_f(carry.dn_hist[b], dt), _f(carry.ca_hist[b], dt),
            _f(carry.fx[b], dt), _f(carry.fy[b], dt),
            _f(carry.cumdist[b], dt), bool(carry.inited[b]))
    got = ref.summarize(dn, ca, qs, modes, *args, window=S.window, thr=thr)
    if dtype is None:
        rec = recs[cap.summary_chunk]
        cand = {k: [bool(x) for x in rec[k][b]] for k in
                ("conv_all", "grid_any", "taken_off", "all_flying")}
        cand["cumdist"] = torch.as_tensor(rec["cumdist"][b],
                                          dtype=torch.float64)
        R = got
    else:
        cand = got
        R = ref.summarize(*(
            [torch.stack([_f(m.distcmd_norm[b]) for m in ms]), ca,
             torch.stack([_f(m.q[b]) for m in ms]), modes]
            + [_f(carry.dn_hist[b]), _f(carry.ca_hist[b]),
               _f(carry.fx[b]), _f(carry.fy[b]), _f(carry.cumdist[b]),
               bool(carry.inited[b])]), window=S.window, thr=thr)
    off = sum(int(a != r) for k in ("conv_all", "grid_any", "taken_off",
                                    "all_flying")
              for a, r in zip(cand[k], R[k]))
    rc = R["cumdist"].to(cand["cumdist"].device, torch.float64)
    cc = cand["cumdist"].to(torch.float64)
    off += int(((cc - rc).abs() > SUMMARY_TOL * (1 + rc.abs())).sum())
    return off


def merge(into: dict, nums: dict) -> None:
    for k, v in nums.items():
        into[k] = v if k not in into else (into[k] + v if isinstance(v, int)
                                           else max(into[k], v))


def gain_numbers(S, gains: list, seed: int) -> dict:
    """The gain numbers over the wave's designs (each divided by the
    configuration's gain scale): every design against what a design
    guarantees, and the design of one trial drawn from the seed against
    the float64 reference design of its formation."""
    out: dict = {}
    scale = float(S.cfg["gain_scale"])
    for b, g in enumerate(gains):
        tr = S.trials[b]
        pts = torch.as_tensor(tr["points"], dtype=torch.float64,
                              device=g.device)
        adj = torch.as_tensor(tr["adj"], dtype=torch.float64,
                              device=g.device)
        rep = ref.gain_report(_f(g) / scale, pts, adj)
        merge(out, {"gain_kernel": rep["kernel"],
                    "gain_offgraph": rep["offgraph"],
                    "gain_trace": rep["trace"],
                    "gain_indefinite": rep["indefinite"]})
    b = seeded_trial(seed, len(gains))
    out.update(design_numbers(S, b, _f(gains[b]) / scale))
    return out


def seeded_trial(seed: int, batch: int) -> int:
    """The trial whose design is held against the reference design."""
    return int(np.random.default_rng(seed + 1).integers(batch))


def design_numbers(S, b: int, A: torch.Tensor) -> dict:
    """``gain_gap`` and ``gain_margin`` of trial ``b``'s design ``A``
    (float64, before the gain scale) against the reference design."""
    tr = S.trials[b]
    pts = torch.as_tensor(tr["points"], dtype=torch.float64, device=A.device)
    adj = torch.as_tensor(tr["adj"], dtype=torch.float64, device=A.device)
    R = refgains.design(pts, adj)
    nullity = ref.kernel_basis(pts, refgains.is_flat(pts)).shape[1]
    m_ref = refgains.margin(R, nullity)
    return {"gain_gap": float(torch.linalg.matrix_norm(A - R)
                              / torch.linalg.matrix_norm(R)),
            "gain_margin": abs(refgains.margin(A, nullity) - m_ref) / m_ref}


def tick_numbers(S, cap: Capture, recs: list, carry,
                 control=None) -> dict:
    """Every tick number over the sampled ticks and all trials, for the
    program's outputs, or with ``control`` (a dtype) for the reference run
    in that precision in the program's place."""
    out: dict = {}
    dev = S.device
    for key in sorted(cap.ticks):
        tick = cap.ticks[key]
        for b in range(int(S.traffic["batch"])):
            inp = trial_inputs(S, tick, b, dev)
            prog = program_outputs(S, tick, b)
            R = reference_outputs(S, tick, b, inp, prog)
            cand = prog if control is None else control_outputs(
                S, tick, b, inp, prog, control)
            merge(out, judge_tick(S, tick, b, inp, cand, R))
    for b in range(int(S.traffic["batch"])):
        merge(out, {"summary_off": summary_numbers(S, cap, recs, carry, b,
                                                   control)})
    return out


def checks(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit; correct iff every number is known,
    finite or within a limit, and no larger than its limit."""
    out, ok = {}, True
    for name in sorted(set(numbers) | set(limits)):
        v = numbers.get(name)
        lim = limits.get(name)
        good = v is not None and lim is not None and not (
            isinstance(v, float) and math.isnan(v)) and v <= lim
        ok = ok and good
        out[name] = {"value": v, "limit": lim}
    return ok, out

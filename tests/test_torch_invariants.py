"""The invariant sanitizer and the device counters in the engine
(`aclswarm_torch.analysis.invariants`, `telemetry.device`) against the
reference's, float64 on the CPU at n=6 over 8 ticks (an auction every 2
ticks, flooded localization).

- The contract table, each predicate on one trial and on a (B,) batch,
  and the host decoders equal the reference's.
- Clean rollouts: for the auction LAP, Sinkhorn and CBAA, a fault-free
  trial and a faulted one (drops at tick 1, rejoins at tick 5, 20% link
  loss) flown in one batch by the reference's `batched_rollout` and by
  the port's, batched and trial by trial: the per-tick codes (all 0) and
  every counter after every tick are equal, integers exactly (Sinkhorn's
  two clean trials fly beside the data mutations).
- Mutations: the reference's four (a duplicated assignment row, a NaN
  pose mid-rollout, an asymmetric adjacency, a one-tick-stale alive
  mask) and one each for `dead_distcmd` (a distcmd norm that leaks into
  dead rows), `dead_frozen` (a NaN pose on a dead vehicle), `scen_points`
  (a NaN in a scenario stage), `sinkhorn_marginal` (K1's plan with its
  mass doubled) and `admm_residual` (a warm carry from a solve at another
  ``mu``) trip the same (contract, tick, trial) in both packages, batched
  and serially, each trial its own.
- ``'on'`` leaves the trajectory bit-identical to ``'off'`` (the three
  solvers, batched and serially), and ``'off'``
  adds no operation: the ATen ops one `step` dispatches equal the count
  of the engine before the sanitizer existed, pinned below.

The reference runs batched only, one compiled program per group of
trials (its batched rollout equals its serial one, by its own tests); the
port's serial rollouts are held to the same outcome trial by trial.
"""
import types
from functools import partial

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from aclswarm_torch import convert
from aclswarm_torch import gains as tgains
from aclswarm_torch import sim as tsim
from aclswarm_torch.analysis import invariants as tinv
from aclswarm_torch.assignment import sinkhorn as tsinkhorn
from aclswarm_torch.core import types as typeslib
from aclswarm_torch.core.types import (ControlGains, SafetyParams,
                                       make_formation)
from aclswarm_torch.faults import schedule as tfaults
from aclswarm_torch.harness import formgen
from aclswarm_torch.sim import engine as tengine
from aclswarm_torch.telemetry import device as tdev
from aclswarm_tpu import faults as jfaults
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.analysis import invariants as jinv
from aclswarm_tpu.assignment import sinkhorn as jsinkhorn
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from aclswarm_tpu.gains import admm as jadmm
from aclswarm_tpu.scenarios import timeline as jscen
from aclswarm_tpu.sim import engine as jengine

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

N, TICKS = 6, 8
CPU64 = dict(device="cpu", dtype=torch.float64)
NEVER = int(jfaults.NEVER)
CHECKED = dict(assign_every=2, localization="flooded", flood_every=2,
               check_mode="on", telemetry="on")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(*trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _points():
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    return np.stack([3 * np.cos(ang), 3 * np.sin(ang),
                     2.0 + 0.2 * np.arange(N)], 1)


def _jform(asym=False):
    adj = np.ones((N, N)) - np.eye(N)
    adj[0, 2] = adj[2, 0] = 0.0
    if asym:
        adj[0, 1] = 0.0
    gains = np.eye(N)[:, :, None, None] * np.eye(3)[None, None] * 0.01
    return jmake_formation(jnp.asarray(_points()), jnp.asarray(adj),
                           jnp.asarray(gains))


def _q0(seed):
    q = np.random.default_rng(seed).normal(size=(N, 3)) * 2.0
    q[:, 2] = 2.0
    return q


JSP = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                    bounds_max=jnp.asarray([50.0, 50.0, 10.0]))
TSP = SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                   bounds_max=(50.0, 50.0, 10.0))


def _schedule(drop, rejoin=None):
    """A fault script of explicit per-vehicle drop/rejoin ticks."""
    drop = np.asarray(drop, np.int32)
    rejoin = np.full(N, NEVER, np.int32) if rejoin is None \
        else np.asarray(rejoin, np.int32)
    return jfaults.FaultSchedule(
        drop_tick=jnp.asarray(drop), rejoin_tick=jnp.asarray(rejoin),
        link_loss=jnp.zeros((N, N)), key=jnp.zeros((2,), jnp.uint32))


def _faulted():
    return jfaults.sample_schedule(3, N, dropout_frac=0.4, drop_tick=1,
                                   rejoin_tick=5, link_loss=0.2,
                                   dtype=jnp.float64)


def _jstate(q0, **kw):
    return jsim.init_state(jnp.asarray(q0), localization=True, checks=True,
                           telemetry=True, **kw)


def _fresh_batched():
    """A private jit of the reference's batched rollout, so monkeypatched
    functions are traced (the module's own caches the honest program)."""
    return jax.jit(partial(jengine.batched_rollout.__wrapped__),
                   static_argnames=("n_ticks", "cfg"))


def _inputs(B, nan_at):
    """(TICKS, B, ...) joystick inputs: a NaN velocity override on vehicle
    0 of each trial ``nan_at`` maps to a tick, none elsewhere."""
    vel = np.zeros((TICKS, B, N, 3))
    active = np.zeros((TICKS, B, N), bool)
    for b, k in nan_at.items():
        vel[k, b, 0] = np.nan
        active[k, b, 0] = True
    return dict(cmd=np.zeros((TICKS, B), np.int32), joy_vel=vel,
                joy_yawrate=np.zeros((TICKS, B, N)), joy_active=active)


def _run_both(jstates, jforms, cfg_kw, inputs=None, fresh=False):
    """One batch through the reference's batched rollout and the port's,
    batched and trial by trial. Returns the reference's and the port's
    batched metrics and final states, and the port's serial metrics."""
    jb, jf = _stack(*jstates), _stack(*jforms)
    tb = convert.sim_state_from_numpy(_np(jb), **CPU64)
    tf = convert.formation_from_numpy(_np(jf), **CPU64)
    jin = tin = None
    if inputs is not None:
        jin = jsim.ExternalInputs(**{k: jnp.asarray(v)
                                     for k, v in inputs.items()})
        tin = tsim.ExternalInputs(**{k: torch.as_tensor(v)
                                     for k, v in inputs.items()})
    run = _fresh_batched() if fresh else jsim.batched_rollout
    jfin, jm = run(jb, jf, JControlGains(), JSP,
                   cfg=jsim.SimConfig(**cfg_kw), n_ticks=TICKS,
                   inputs=jin)
    cfg = tsim.SimConfig(**cfg_kw)
    tfin, tm = tsim.batched_rollout(tb, tf, ControlGains(), TSP, cfg,
                                    TICKS, tin)
    serial = []
    for b in range(len(jstates)):
        sin = None if tin is None else tsim.ExternalInputs(
            **{k: v[:, b] for k, v in vars(tin).items()})
        serial.append(tsim.rollout(
            tsim.trial(tb, b), convert.formation_from_numpy(
                _np(jforms[b]), **CPU64),
            ControlGains(), TSP, cfg, TICKS, sin)[1])
    return jm, jfin, tm, tfin, serial


def _tel_np(tel) -> dict:
    return {f: np.asarray(getattr(tel, f)) for f in tdev.FIELDS}


def _outcome(codes):
    hit = jinv.first_violation(np.asarray(codes))
    return None if hit is None else (hit[0], hit[1].id)


def _assert_codes_and_counters(jm, jfin, tm, tfin, serial, counters=True):
    """Codes equal tick by tick, batched and serially; with ``counters``
    every counter too (a mutated trial's counters part once its NaN meets
    a solver: the port's solvers see it as 0 under the sanitizer)."""
    np.testing.assert_array_equal(tm.inv_code.numpy(),
                                  np.asarray(jm.inv_code))
    jt, tt = _tel_np(jm.tel), _tel_np(tm.tel)
    for f in tdev.FIELDS if counters else ():
        np.testing.assert_array_equal(tt[f], jt[f], err_msg=f)
    np.testing.assert_array_equal(tfin.inv.code.numpy(),
                                  np.asarray(jfin.inv.code))
    np.testing.assert_array_equal(tfin.inv.tick.numpy(),
                                  np.asarray(jfin.inv.tick))
    for b, sm in enumerate(serial):
        np.testing.assert_array_equal(sm.inv_code.numpy(),
                                      tm.inv_code[:, b].numpy())
        for f in tdev.FIELDS if counters else ():
            assert torch.equal(getattr(sm.tel, f), getattr(tm.tel, f)[:, b])


# ------------------------------------------------------------ the table

def test_contract_table_matches_reference():
    assert tinv.CONTRACTS == tuple(
        tinv.Contract(c.id, c.code, c.summary, c.scope)
        for c in jinv.CONTRACTS)
    assert tinv.CODES == jinv.CODES
    assert (tinv.SINKHORN_MARGINAL_TOL, tinv.BOUNDS_MARGIN) \
        == (jinv.SINKHORN_MARGINAL_TOL, jinv.BOUNDS_MARGIN)
    for code in range(12):
        a, b = tinv.contract_of(code), jinv.contract_of(code)
        assert (a is None and b is None) or a.id == b.id
    codes = np.array([0, 0, 7, 3])
    assert tinv.first_violation(codes, 10)[0] == 12
    with pytest.raises(tinv.InvariantViolation) as err:
        tinv.raise_on_violation(codes, trial=2, tick0=10)
    assert str(err.value) == str(jinv.InvariantViolation(
        jinv.contract_of(7), 12, trial=2))
    assert tinv.first_violation(np.array([0, 99]))[1].id == "unknown"


def _predicate_inputs(rng, B):
    lead = () if B is None else (B,)
    v2f = np.stack([rng.permutation(N) for _ in range(B or 1)])
    v2f[-1, 1] = v2f[-1, 0]                       # a duplicate row
    if B:
        v2f[0, 2] = N                             # out of range
    adj = (rng.random(lead + (N, N)) < 0.5).astype(float)
    adj = np.maximum(adj, np.swapaxes(adj, -1, -2))
    adj[..., 0, 1] = 1 - adj[..., 0, 1]           # asymmetric, every trial
    if B:
        adj[0] = np.maximum(adj[0], adj[0].T)     # trial 0 symmetric
    alive = rng.random(lead + (N,)) < 0.7
    dn = rng.random(lead + (N,)) * (rng.random(lead + (N,)) < 0.5)
    q = rng.normal(size=lead + (N, 3)) * 30
    q_prev = np.where(rng.random(lead + (N, 1)) < 0.3, q + 1e-9, q)
    q_bad = q.copy()
    q_bad[..., 1, 2] = np.nan
    return dict(v2f=v2f if B else v2f[0], adj=adj, alive=alive, dn=dn, q=q,
                q_prev=q_prev, q_bad=q_bad,
                tick=np.full(lead, 3, np.int32),
                drop=rng.integers(0, 6, lead + (N,)).astype(np.int32),
                rejoin=rng.integers(2, 9, lead + (N,)).astype(np.int32))


@pytest.mark.parametrize("B", [None, 3], ids=["serial", "batched"])
def test_predicates_match_reference(B):
    """Each predicate on the same random inputs, one trial or a batch (the
    reference's vmapped over the trial axis)."""
    x = _predicate_inputs(np.random.default_rng(4), B)
    t = {k: torch.as_tensor(v) for k, v in x.items()}

    def ref(fn, *args):
        f = fn if B is None else jax.vmap(fn)
        return np.asarray(f(*[jnp.asarray(a) for a in args]))

    def same(got, want):
        np.testing.assert_array_equal(got.numpy(), want)

    same(tinv.perm_violated(t["v2f"].int()), ref(jinv.perm_violated,
                                                  x["v2f"]))
    same(tinv.adjacency_asymmetric(t["adj"]),
         ref(jinv.adjacency_asymmetric, x["adj"]))
    sched = types.SimpleNamespace(drop_tick=t["drop"],
                                  rejoin_tick=t["rejoin"])
    same(tinv.alive_mask_stale(t["alive"], sched, t["tick"]),
         ref(lambda a, d, r, k: jinv.alive_mask_stale(
             a, types.SimpleNamespace(drop_tick=d, rejoin_tick=r), k),
             x["alive"], x["drop"], x["rejoin"], x["tick"]))
    same(tinv.dead_rows_active(t["dn"], t["alive"]),
         ref(jinv.dead_rows_active, x["dn"], x["alive"]))
    same(tinv.dead_rows_moved(t["q"], t["q_prev"], t["alive"]),
         ref(jinv.dead_rows_moved, x["q"], x["q_prev"], x["alive"]))
    for q in ("q", "q_bad"):
        same(tinv.nonfinite_points(t[q]), ref(jinv.nonfinite_points, x[q]))
        st = types.SimpleNamespace(q=t[q], vel=t["q_prev"])
        goal = types.SimpleNamespace(pos=t["q_prev"], vel=t["q_prev"])
        same(tinv.nonfinite_state(st, goal), ref(
            lambda a, b: jinv.nonfinite_state(
                types.SimpleNamespace(q=a, vel=b),
                types.SimpleNamespace(pos=b, vel=b)), x[q], x["q_prev"]))
        same(tinv.out_of_bounds(t[q], TSP),
             ref(lambda a: jinv.out_of_bounds(a, JSP), x[q]))
    errs = np.array([0.01, 0.06, 0.05, 0.2])[:(B or 1)]
    rev = errs[::-1].copy()
    same(tinv.sinkhorn_marginals_violated(torch.as_tensor(errs),
                                          torch.as_tensor(rev)),
         np.asarray(jinv.sinkhorn_marginals_violated(errs, rev)))


def test_marginal_errors_match_reference_batched():
    rng = np.random.default_rng(1)
    plans = rng.normal(size=(3, N, N)) - 2 * np.log(N)
    rows, cols = tsinkhorn.marginal_errors(torch.as_tensor(plans))
    for b in range(3):
        jr, jc = jsinkhorn.marginal_errors(jnp.asarray(plans[b]))
        np.testing.assert_allclose(rows[b].item(), float(jr), rtol=1e-13)
        np.testing.assert_allclose(cols[b].item(), float(jc), rtol=1e-13)


# -------------------------------------------------------- clean rollouts

@pytest.fixture(scope="module", params=["auction", "cbaa"])
def clean(request):
    jstates = [_jstate(_q0(0), faults=jfaults.no_faults(N, jnp.float64)),
               _jstate(_q0(1), faults=_faulted())]
    return request.param, _run_both(jstates, [_jform(), _jform()],
                                    dict(CHECKED, assignment=request.param))


def test_clean_rollouts_match_reference(clean):
    mode, (jm, jfin, tm, tfin, serial) = clean
    _assert_codes_and_counters(jm, jfin, tm, tfin, serial)
    assert not tm.inv_code.any()
    assert (tm.tel.auctions[-1] == TICKS // 2).all()
    assert (tm.tel.flood_stale_max[-1] > 0).all()
    np.testing.assert_array_equal(tm.v2f.numpy(), np.asarray(jm.v2f))
    assert (tm.tel.assign_rounds[-1] > 0).all()


def _clean_port_inputs():
    jstates = [_jstate(_q0(0), faults=jfaults.no_faults(N, jnp.float64)),
               _jstate(_q0(1), faults=_faulted())]
    return (convert.sim_state_from_numpy(_np(_stack(*jstates)), **CPU64),
            convert.formation_from_numpy(_np(_stack(_jform(), _jform())),
                                         **CPU64))


def _assert_on_equals_off(mode, checked=None):
    """The unchecked port's batched rollout of the clean inputs and its
    serial rollout of trial 1 against the checked ones (``checked``: the
    (batched metrics, final state, serial metrics) of `_run_both`, else
    flown here)."""
    tb, tf = _clean_port_inputs()
    runs = {}
    for on in ("off", "on") if checked is None else ("off",):
        cfg = tsim.SimConfig(**dict(CHECKED, assignment=mode,
                                    check_mode=on, telemetry=on))
        (fin, m) = tsim.batched_rollout(tb, tf, ControlGains(), TSP, cfg,
                                        TICKS)
        runs[on] = (m, fin, tsim.rollout(tsim.trial(tb, 1),
                                         typeslib.row(tf, 1), ControlGains(),
                                         TSP, cfg, TICKS)[1])
    on_m, on_fin, on_serial = runs["on"] if checked is None else checked
    off_m, off_fin, off_serial = runs["off"]
    for m_off, m_on in ((off_m, on_m), (off_serial, on_serial)):
        assert m_off.inv_code is None and m_on.inv_code is not None
        for k, v in vars(m_off).items():
            if v is not None and k != "tel":
                assert torch.equal(v, getattr(m_on, k)), k
    for k in ("q", "vel"):
        assert torch.equal(getattr(off_fin.swarm, k),
                           getattr(on_fin.swarm, k))
    assert torch.equal(off_fin.v2f, on_fin.v2f)
    assert torch.equal(off_fin.loc.age, on_fin.loc.age)


def test_on_equals_off_bit_for_bit(clean):
    """The checked, counted rollouts of the clean batch fly the unchecked
    ones' trajectories exactly, batched and serially."""
    mode, (_, _, tm, tfin, serial) = clean
    _assert_on_equals_off(mode, (tm, tfin, serial[1]))


def test_on_equals_off_bit_for_bit_sinkhorn():
    _assert_on_equals_off("sinkhorn")


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


# ATen ops one `step` dispatches at n=8 on the CPU (float64), counted on
# the engine before the sanitizer and the counters existed (2391, 1098,
# 1801), plus 13 where the step aligns the formation with `geometry.align`
# since its 2-D rotation is taken in closed form (66 ops a call, the SVD's
# 53), and 9 where CBAA's local alignment takes the same closed form
# (`_rotation2`: 27 ops, the batched SVD with its sign fix 18), and 6
# more where the control law computes elementwise
# (`control.distcntrl`: the gain product 11 ops a call, the einsum's 14;
# the row sum's pairwise fold at n=8 10, `torch.sum`'s 1), and 25 more
# where CBAA's local alignment rounds in one order on every device
# (`geometry._align_rows`: its sums over the points a pairwise fold, its
# 2x2 products written out; 127 ops a call at n=8, the form with
# `torch.sum` and two einsums 102)
OPS_BEFORE = {"sinkhorn_flooded": 2391 + 13 + 6,
              "cbaa_faults": 1098 + 9 + 6 + 25,
              "auction_fsm": 1801 + 13 + 6}


@pytest.mark.parametrize("case", list(OPS_BEFORE))
def test_off_adds_no_operation(case):
    n = 8
    group = formgen.generate_group(n, seed=5, l=12.0, w=12.0, h=3.0,
                                   min_dist=2.0, k=1)
    rng = np.random.default_rng(5)
    form = make_formation(np.asarray(group["formations"][0]["points"]),
                          np.asarray(group["adjmat"], float),
                          rng.normal(size=(n, n, 3, 3)) * 0.01, **CPU64)
    q0 = rng.uniform(-4, 4, size=(n, 3))
    q0[:, 2] = rng.uniform(1, 3, n)
    cfg_kw, init_kw = {
        "sinkhorn_flooded": (dict(assignment="sinkhorn",
                                  localization="flooded", flood_phases=2,
                                  colavoid_neighbors=4, assign_eps=0.01,
                                  dynamics="doubleint", assign_every=10),
                             dict(localization=True)),
        "cbaa_faults": (dict(assignment="cbaa"), dict(faults=True)),
        "auction_fsm": (dict(flight_fsm=True), {}),
    }[case]
    if init_kw.get("faults"):
        drop = np.full(n, NEVER, np.int32)
        rejoin = drop.copy()
        drop[2], rejoin[2] = 0, 50
        init_kw = dict(init_kw, faults=tfaults.from_numpy(
            drop, rejoin, np.full((n, n), 0.2), np.array([0, 7]), **CPU64))
    state = tsim.init_state(q0, **CPU64, **init_kw)
    with _OpCount() as count:
        tsim.step(state, form, ControlGains(), TSP,
                  tsim.SimConfig(**cfg_kw))
    assert count.n == OPS_BEFORE[case]
    # the same step with both carries allocated but both modes off
    state = tsim.init_state(q0, **CPU64, **init_kw, checks=True,
                            telemetry=True)
    with _OpCount() as count:
        tsim.step(state, form, ControlGains(), TSP,
                  tsim.SimConfig(**cfg_kw))
    assert count.n == OPS_BEFORE[case]


# ------------------------------------------------------------- mutations

def _assert_mutations(runs, expected):
    jm, jfin, tm, tfin, serial = runs
    _assert_codes_and_counters(jm, jfin, tm, tfin, serial, counters=False)
    clean = [b for b, e in enumerate(expected) if e is None]
    jt, tt = _tel_np(jm.tel), _tel_np(tm.tel)
    for f in tdev.FIELDS:
        np.testing.assert_array_equal(tt[f][:, clean], jt[f][:, clean],
                                      err_msg=f)
        for b in clean:
            assert torch.equal(getattr(serial[b].tel, f),
                               getattr(tm.tel, f)[:, b])
    got = [_outcome(tm.inv_code[:, b].numpy())
           for b in range(tm.inv_code.shape[1])]
    assert got == expected
    assert got == [_outcome(np.asarray(jm.inv_code)[:, b])
                   for b in range(len(expected))]
    assert [_outcome(m.inv_code.numpy()) for m in serial] == expected


def test_data_mutations_trip_their_contracts():
    """No patch: trials 0 and 6 clean (6 faulted: the Sinkhorn case of
    the clean rollouts, counters equal too); 1 a duplicated row in the
    held assignment (auctions gated off); 2 a NaN joystick velocity at
    tick 3; 3 an asymmetric adjacency; 4 a NaN pose on a vehicle dead from
    tick 0; 5 a scenario stage with a NaN point from tick 3."""
    clean = jfaults.no_faults(N, jnp.float64)
    dead0 = _schedule([0] + [NEVER] * (N - 1))
    q_nan = _q0(4)
    q_nan[0] = np.nan
    scen = jscen.no_scenario(N, dtype=jnp.float64)
    stage = np.stack([_points()] * scen.seq_points.shape[0])
    stage[0, 0, 1] = np.nan
    bad_scen = scen.replace(
        seq_points=jnp.asarray(stage),
        seq_tick=scen.seq_tick.at[0].set(3))
    jstates = [
        _jstate(_q0(0), faults=clean, scenario=scen),
        _jstate(_q0(1), faults=clean, scenario=scen,
                v2f0=np.array([1, 1, 2, 3, 4, 5])),
        _jstate(_q0(2), faults=clean, scenario=scen),
        _jstate(_q0(3), faults=clean, scenario=scen),
        _jstate(q_nan, faults=dead0, scenario=scen),
        _jstate(_q0(5), faults=clean, scenario=bad_scen),
        _jstate(_q0(1), faults=_faulted(), scenario=scen)]
    gate_off = (1, 4)
    jstates = [s.replace(assign_enabled=jnp.asarray(b not in gate_off))
               for b, s in enumerate(jstates)]
    jforms = [_jform(asym=b == 3) for b in range(len(jstates))]
    runs = _run_both(jstates, jforms, dict(CHECKED, assignment="sinkhorn"),
                     inputs=_inputs(len(jstates), {2: 3}))
    _assert_mutations(runs, [None, (0, "assign_perm"), (3, "state_finite"),
                             (0, "adj_sym"), (0, "dead_frozen"),
                             (3, "scen_points"), None])
    tm = runs[2]
    assert (tm.tel.flood_stale_max[-1, [0, 6]] > 0).all()
    assert (tm.tel.auctions[-1, [0, 6]] == TICKS // 2).all()


class _NormLeak:
    """A module proxy whose distcmd norm leaks 1 into every row, dead or
    alive: the engine's dead-row masking made ineffective."""

    def __init__(self, mod, linalg_attr, fn):
        self._mod = mod
        self.linalg = types.SimpleNamespace(**{
            linalg_attr: lambda *a, **k: fn(*a, **k) + 1.0})

    def __getattr__(self, name):
        return getattr(self._mod, name)


def test_patched_mutations_trip_their_contracts(monkeypatch):
    """With three regressions patched into both engines at once: a
    one-tick-stale alive mask (trial 0 drops at tick 2: `mask_consistency`
    there; the mask check recomputes the schedule's own rule), a distcmd
    norm that ignores the dead mask (trial 1, a vehicle down throughout:
    `dead_distcmd` at tick 0), and K1's plan with its mass doubled, which
    rounds to the same permutation (trial 2, the only one auctioning:
    `sinkhorn_marginal` at tick 0)."""
    for faultmod in (jengine.faultlib, tengine.faultlib):
        orig = faultmod.alive_at
        monkeypatch.setattr(faultmod, "alive_at",
                            lambda s, t, orig=orig: orig(s, t - 1))
    monkeypatch.setattr(jengine, "jnp", _NormLeak(
        jnp, "norm", jnp.linalg.norm))
    monkeypatch.setattr(tengine, "torch", _NormLeak(
        torch, "vector_norm", torch.linalg.vector_norm))
    for mod in (jsinkhorn, tsinkhorn):
        log = mod.sinkhorn_log
        monkeypatch.setattr(mod, "sinkhorn_log",
                            lambda *a, log=log, **k: log(*a, **k)
                            + np.log(2.0))
    stale = _schedule([NEVER, NEVER, 2, NEVER, 2, NEVER],
                      [NEVER, NEVER, 5, NEVER, 6, NEVER])
    down = _schedule([NEVER, -5] + [NEVER] * (N - 2))
    jstates = [_jstate(_q0(0), faults=stale),
               _jstate(_q0(1), faults=down),
               _jstate(_q0(2), faults=jfaults.no_faults(N, jnp.float64))]
    jstates = [s.replace(assign_enabled=jnp.asarray(b == 2))
               for b, s in enumerate(jstates)]
    runs = _run_both(jstates, [_jform()] * 3,
                     dict(CHECKED, assignment="sinkhorn"), fresh=True)
    _assert_mutations(runs, [(2, "mask_consistency"), (0, "dead_distcmd"),
                             (0, "sinkhorn_marginal")])
    jm, _, tm, _, _ = runs
    np.testing.assert_array_equal(tm.v2f.numpy(), np.asarray(jm.v2f))


def test_admm_residual_trips_in_both():
    """A warm start from the fixed point of a solve at mu=1 (the port's;
    its iterates are the reference's to ~1e-12), re-solved at mu=10 for
    four steps with the stopping rules off: the residual ends above its
    first step's, and both packages raise `admm_residual`; at mu=1 the
    port does not, and its checked gains equal the unchecked ones."""
    pts = _points()
    adj = np.asarray(_jform().adjmat)
    free = dict(thresh=0.0, thresh_tr=-1e9)
    tc = tgains.init_carry(N, tgains.planar_of(pts), **CPU64)
    for params in (tgains.AdmmParams(), tgains.AdmmParams(max_itr=60,
                                                          **free)):
        _, tc = tgains.solve_gains(pts, adj, carry=tc, params=params,
                                   device="cpu")
    tripping = dict(max_itr=4, mu=10.0, **free)
    with pytest.raises(jinv.InvariantViolation) as jerr:
        jadmm.solve_gains(pts, adj, check_mode="on", carry=jadmm.AdmmCarry(
            **{k: jnp.asarray(v) for k, v in
               convert.admm_carry_to_numpy(tc).items()}),
            params=jadmm.AdmmParams(**tripping))
    with pytest.raises(tinv.InvariantViolation) as terr:
        tgains.solve_gains(pts, adj, carry=tc, check_mode="on",
                           params=tgains.AdmmParams(**tripping),
                           device="cpu")
    assert (terr.value.contract.id, terr.value.tick) \
        == (jerr.value.contract.id, jerr.value.tick) == ("admm_residual", -1)
    calm = tgains.AdmmParams(max_itr=4, **free)
    g, _ = tgains.solve_gains(pts, adj, carry=tc, params=calm,
                              check_mode="on", device="cpu")
    off, _ = tgains.solve_gains(pts, adj, carry=tc, params=calm,
                                device="cpu")
    assert torch.equal(g, off)

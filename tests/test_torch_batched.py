"""Batched trials: the reference's `batched_rollout`, summaries and
`SummaryTrialFSM` against the port's, float64 on the CPU.

- `sim.batched_rollout` against the reference's on its own cases
  (`tests/test_batched.py`): B = 3, n = 6, 130 ticks, an auction every 60
  ticks under the flight FSM, in the 'auction', 'sinkhorn' and 'cbaa' modes
  on ground truth; flooded CBAA (B = 2); flooded Sinkhorn with two phased
  stripes and the hysteresis. The assignment, the flight modes, the ages
  and every boolean metric must be equal on every tick. Positions and
  |distcmd| are held at atol 1e-9 through tick 60, and the final
  positions at 1e-4 and velocities at 1e-2: the port's serial rollout
  differs from the reference's in summation order only
  (`test_torch_engine.py`), and on these cases the closed loop grows that
  ~1e-15 seed to ~2e-5 in positions by tick 130 in the serial rollouts
  alike (a control deadband flip then moves |distcmd| by up to ~4e-3 and a
  velocity by ~1.3e-3), so no batched rollout can equal the reference's
  bit for bit.
- Batch = serial in the port, bit for bit (`assert_array_equal`): the same
  cases against B serial port rollouts. The trap is a product or a
  reduction that rounds otherwise with a trial axis.
- The hover gate: ``assign_enabled`` False holds a trial's assignment.
- `summarize_chunk` and `batched_rollout_summary` against the reference's
  across two chunks, and `SummaryTrialFSM` against the reference's class
  fed the same summaries (gridlock, no gridlock, the watchdog).
- The plain batched kernels against B calls of the single plain version:
  exact for K1, K2 and K3.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch import convert, ops
from aclswarm_torch import sim
from aclswarm_torch.core import types
from aclswarm_torch.core.types import ControlGains
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.sim import summary as tsum
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.sim import summary as jsum

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ATOL = 1e-9
TICKS_AT_ATOL = 60     # floats held at ATOL through here (see above)
FINAL_ATOL = 1e-4
CPU64 = dict(device="cpu", dtype=torch.float64)
METRICS_EXACT = ("ca_active", "assign_valid", "reassigned", "auctioned",
                 "mode", "v2f")
METRICS_FLOAT = ("distcmd_norm", "q")

# (B, seed, SimConfig fields, flooded)
CASES = {
    "auction": (3, 1, dict(assignment="auction"), False),
    "sinkhorn": (3, 1, dict(assignment="sinkhorn"), False),
    "cbaa": (3, 1, dict(assignment="cbaa"), False),
    "cbaa_flooded": (2, 2, dict(assignment="cbaa", localization="flooded"),
                     True),
    "sinkhorn_flooded_phased": (
        3, 3, dict(assignment="sinkhorn", localization="flooded",
                   flood_phases=2, assign_eps=0.01, colavoid_neighbors=3,
                   dynamics="doubleint"), True),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_problem(B, n, seed=0, flying=True, localization=False):
    """The reference's `tests/test_batched.py` problem: B formations on a
    complete graph with random gains and B starts, stacked both ways."""
    rng = np.random.default_rng(seed)
    adj = np.ones((n, n)) - np.eye(n)
    forms, states = [], []
    for _ in range(B):
        pts = rng.normal(size=(n, 3)) * 5
        gains = rng.normal(size=(n, n, 3, 3)) * 0.01
        forms.append(jmake_formation(jnp.asarray(pts), jnp.asarray(adj),
                                     jnp.asarray(gains)))
        states.append(jsim.init_state(
            rng.normal(size=(n, 3)) * 5 + np.array([0, 0, 2.0]),
            flying=flying, localization=localization))
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 20.0]))
    bstate = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    bform = jax.tree.map(lambda *xs: jnp.stack(xs), *forms)
    return bstate, bform, sp


def _port(bstate, bform, sp):
    return (convert.sim_state_from_numpy(_np(bstate), **CPU64),
            convert.formation_from_numpy(_np(bform), **CPU64),
            convert.safety_params_from_numpy(_np(sp)))


def _case(name, T=130):
    B, seed, kw, flooded = CASES[name]
    bstate, bform, sp = _batch_problem(B, 6, seed=seed,
                                       localization=flooded)
    kw = dict(kw, assign_every=60, flight_fsm=True)
    return bstate, bform, sp, kw, T


def _assert_metrics(tm, jm):
    for k in METRICS_EXACT:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k in METRICS_FLOAT:
        a, b = getattr(tm, k).numpy(), np.asarray(getattr(jm, k))
        np.testing.assert_allclose(a[:TICKS_AT_ATOL], b[:TICKS_AT_ATOL],
                                   rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_batched_rollout_matches_reference(name):
    bstate, bform, sp, kw, T = _case(name)
    # the reference's batched rollout donates its state: convert first
    tstate, tform, tsp = _port(bstate, bform, sp)
    jf, jm = jsim.batched_rollout(bstate, bform, JControlGains(), sp,
                                  jsim.SimConfig(**kw), T)
    tf, tm = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                 sim.SimConfig(**kw), T)
    _assert_metrics(tm, jm)
    assert int(tm.auctioned.sum()) == 3 * len(tf.v2f)
    np.testing.assert_array_equal(tf.v2f.numpy(), np.asarray(jf.v2f))
    np.testing.assert_array_equal(tf.tick, np.asarray(jf.tick))
    for part, atol in (("q", FINAL_ATOL), ("vel", 100 * FINAL_ATOL)):
        np.testing.assert_allclose(getattr(tf.swarm, part).numpy(),
                                   np.asarray(getattr(jf.swarm, part)),
                                   rtol=0, atol=atol)
    if CASES[name][3]:
        np.testing.assert_array_equal(tf.loc.age.numpy(),
                                      np.asarray(jf.loc.age))
        np.testing.assert_allclose(tf.loc.est.numpy(),
                                   np.asarray(jf.loc.est), rtol=0,
                                   atol=FINAL_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_batched_rollout_equals_serial_rollouts(name):
    """B serial port rollouts from the same starts, bit for bit."""
    bstate, bform, sp, kw, T = _case(name)
    tstate, tform, tsp = _port(bstate, bform, sp)
    cfg = sim.SimConfig(**kw)
    bf, bm = sim.batched_rollout(tstate, tform, ControlGains(), tsp, cfg, T)
    for b in range(len(bf.v2f)):
        sf, sm = sim.rollout(sim.trial(tstate, b), types.row(tform, b),
                             ControlGains(), tsp, cfg, T)
        for f in dataclasses.fields(sm):
            if getattr(sm, f.name) is None:     # no faults, no scenario
                assert getattr(bm, f.name) is None, f.name
                continue
            np.testing.assert_array_equal(getattr(sm, f.name).numpy(),
                                          getattr(bm, f.name)[:, b].numpy(),
                                          err_msg=f.name)
        for x, y in ((sf.swarm.q, bf.swarm.q), (sf.swarm.vel, bf.swarm.vel),
                     (sf.goal.pos, bf.goal.pos), (sf.v2f, bf.v2f)):
            np.testing.assert_array_equal(x.numpy(), y[b].numpy())
        assert sf.tick == bf.tick[b] == T
        if CASES[name][3]:
            np.testing.assert_array_equal(sf.loc.est.numpy(),
                                          bf.loc.est[b].numpy())
            np.testing.assert_array_equal(sf.loc.age.numpy(),
                                          bf.loc.age[b].numpy())


def test_assign_enabled_gate_holds_assignment():
    """``assign_enabled`` False freezes a trial's v2f and suppresses its
    auction events, as in the reference (the batched driver's hover
    gate)."""
    bstate, bform, sp = _batch_problem(2, 6, seed=3)
    bstate = bstate.replace(assign_enabled=jnp.asarray([True, False]))
    cfg = dict(assignment="auction", assign_every=30)
    tstate, tform, tsp = _port(bstate, bform, sp)
    jf, jm = jsim.batched_rollout(bstate, bform, JControlGains(), sp,
                                  jsim.SimConfig(**cfg), 90)
    v2f0 = tstate.v2f.clone()
    tf, tm = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                 sim.SimConfig(**cfg), 90)
    assert tm.auctioned[:, 0].any() and not tm.auctioned[:, 1].any()
    assert not tm.reassigned[:, 1].any()
    np.testing.assert_array_equal(tf.v2f[1].numpy(), v2f0[1].numpy())
    _assert_metrics(tm, jm)


def test_batched_step_needs_the_shared_tick():
    bstate, bform, sp = _batch_problem(2, 6, seed=3)
    tstate, tform, tsp = _port(bstate, bform, sp)
    with pytest.raises(ValueError, match="shared_tick"):
        sim.step(tstate, tform, ControlGains(), tsp, sim.SimConfig())


def test_batched_state_roundtrips_and_compacts():
    """The reference's batched state crosses to the port and back, and
    `take_trials` gathers rows as `stack_states` of the chosen trials."""
    bstate, _, _ = _batch_problem(3, 6, seed=4, localization=True)
    tstate = convert.sim_state_from_numpy(_np(bstate), **CPU64)
    back = convert.sim_state_to_numpy(tstate)
    ref = _np(bstate)
    np.testing.assert_array_equal(back["swarm"]["q"], ref.swarm.q)
    np.testing.assert_array_equal(back["loc"]["est"], ref.loc.est)
    np.testing.assert_array_equal(back["tick"], ref.tick)
    np.testing.assert_array_equal(back["first_auction"], ref.first_auction)
    picked = sim.take_trials(tstate, [2, 0])
    rows = sim.stack_states([sim.trial(tstate, 2), sim.trial(tstate, 0)])
    for a, b in zip(jax.tree.leaves(convert.sim_state_to_numpy(picked)),
                    jax.tree.leaves(convert.sim_state_to_numpy(rows))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- summaries

def _jax_summaries(jm, carry, chunk, W, T):
    out = []
    for c0 in range(0, T, chunk):
        part = jax.tree.map(lambda x: jnp.moveaxis(x[c0:c0 + chunk], 1, 0),
                            jm)
        summ, carry = jax.vmap(
            lambda m, c: jsum.summarize_chunk(m, c, W, 1.0,
                                              pose_every=5))(part, carry)
        out.append(summ)
    return out, carry


def _assert_summary(ts, js):
    for k in ("conv_all", "grid_any", "taken_off", "all_flying",
              "auctioned", "assign_valid", "reassigned"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(ts.cumdist.numpy(), np.asarray(js.cumdist),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ts.q_dec.numpy(), np.asarray(js.q_dec),
                               rtol=0, atol=ATOL)


def test_summarize_chunk_matches_reference():
    """Two chunks of the reference's batched metrics reduced by both
    packages, the carry crossing the chunk boundary: every flag equal,
    the EWMA distance and the carried histories at 1e-12."""
    B, n, T, W, chunk = 2, 6, 150, 20, 75
    bstate, bform, sp = _batch_problem(B, n, seed=4)
    _, jm = jsim.batched_rollout(bstate, bform, JControlGains(), sp,
                                 jsim.SimConfig(assignment="auction",
                                                assign_every=50), T)
    jcarry = jsum.init_carry(n, W, dtype=jnp.float64, batch=B)
    jout, jcarry = _jax_summaries(jm, jcarry, chunk, W, T)
    tcarry = tsum.init_carry(n, W, dtype=torch.float64, device="cpu",
                             batch=B)
    npm = _np(jm)
    for i, c0 in enumerate(range(0, T, chunk)):
        part = sim.StepMetrics(**{
            f.name: None if getattr(npm, f.name) is None
            else torch.from_numpy(np.moveaxis(
                getattr(npm, f.name)[c0:c0 + chunk], 1, 0).copy())
            for f in dataclasses.fields(sim.StepMetrics)})
        ts, tcarry = tsum.summarize_chunk(part, tcarry, W, 1.0,
                                          pose_every=5)
        _assert_summary(ts, jout[i])
    ref = _np(jcarry)
    for k in ("dn_hist", "ca_hist", "fx", "fy", "cumdist"):
        np.testing.assert_allclose(getattr(tcarry, k).numpy(),
                                   getattr(ref, k), rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_array_equal(tcarry.inited.numpy(), ref.inited)
    # the carry crosses `convert` both ways
    again = convert.summary_carry_from_numpy(
        convert.summary_carry_to_numpy(tcarry), **CPU64)
    np.testing.assert_array_equal(again.dn_hist.numpy(),
                                  tcarry.dn_hist.numpy())


def test_batched_rollout_summary_matches_reference():
    """The fused rollout + reduction of both packages over two chunks from
    the same carried state: the summaries' flags equal, distances close,
    and the host copy (`to_host`) returns them."""
    B, n, W, chunk = 2, 6, 20, 60
    bstate, bform, sp = _batch_problem(B, n, seed=5, flying=False)
    cfg = dict(assignment="sinkhorn", assign_every=60, flight_fsm=True)
    jcarry = jsum.init_carry(n, W, dtype=jnp.float64, batch=B)
    tstate, tform, tsp = _port(bstate, bform, sp)
    tcarry = tsum.init_carry(n, W, dtype=torch.float64, device="cpu",
                             batch=B)
    cmd = np.zeros((chunk, B), np.int32)
    cmd[0, :] = jsim.vehicle.CMD_GO
    jin = jsim.ExternalInputs(
        cmd=jnp.asarray(cmd), joy_vel=jnp.zeros((chunk, B, n, 3)),
        joy_yawrate=jnp.zeros((chunk, B, n)),
        joy_active=jnp.zeros((chunk, B, n), bool))
    tin = sim.ExternalInputs(
        cmd=torch.from_numpy(cmd), joy_vel=torch.zeros(chunk, B, n, 3,
                                                       dtype=torch.float64),
        joy_yawrate=torch.zeros(chunk, B, n, dtype=torch.float64),
        joy_active=torch.zeros(chunk, B, n, dtype=torch.bool))
    for k in range(2):
        bstate, jcarry, js = jsum.batched_rollout_summary(
            bstate, jcarry, bform, JControlGains(), sp,
            jsim.SimConfig(**cfg), chunk, jin, 0, window=W,
            takeoff_alt=1.0, pose_every=5)
        tstate, tcarry, ts = tsum.batched_rollout_summary(
            tstate, tcarry, tform, ControlGains(), tsp,
            sim.SimConfig(**cfg), chunk, tin, 0, window=W, takeoff_alt=1.0,
            pose_every=5)
        _assert_summary(ts, js)
        host = tsum.to_host(ts)
        assert set(host) == set(tsum.FLAGS) | {"cumdist"}
        np.testing.assert_array_equal(host["conv_all"], ts.conv_all.numpy())
        assert host["cumdist"].shape == (B, n)
        jin = jin.replace(cmd=jnp.zeros_like(jin.cmd))
        tin = dataclasses.replace(tin, cmd=torch.zeros_like(tin.cmd))


# ------------------------------------------------------- SummaryTrialFSM

def _drive_summary(fsm, q, dn, ca, events, chunk, W):
    """The batched driver's loop on synthetic per-tick signals (the
    reference's `tests/test_batched.py` helper)."""
    T = q.shape[0]
    rm_dn = jsup.rolling_mean(dn, W)
    rm_ca = jsup.rolling_mean(ca.astype(float), W)
    conv = np.all(np.nan_to_num(rm_dn, nan=np.inf) < 1.0, axis=1)
    grid = np.any(np.nan_to_num(rm_ca, nan=0.0) > 0.95, axis=1)
    toff = np.all(np.abs(q[:, :, 2] - 1.0) < 0.05, axis=1)
    fx, fy = q[0, :, 0].copy(), q[0, :, 1].copy()
    cum = np.zeros((T, q.shape[1]))
    run = np.zeros(q.shape[1])
    for t in range(1, T):
        nx = 0.98 * fx + 0.02 * q[t, :, 0]
        ny = 0.98 * fy + 0.02 * q[t, :, 1]
        run += np.hypot(nx - fx, ny - fy)
        fx, fy = nx, ny
        cum[t] = run
    pending, actions = False, []
    for c0 in range(0, T, chunk):
        if fsm.done:
            break
        if pending:
            fsm.formation_dispatched()
            pending = False
        e1 = min(c0 + chunk, T)
        acts = fsm.process_chunk(conv[c0:e1], grid[c0:e1], toff[c0:e1],
                                 events[c0:e1], events[c0:e1])
        fsm.observe_cumdist(cum[e1 - 1])
        actions.append(list(acts))
        if "dispatch" in acts:
            pending = True
    return actions


def _synthetic_trial(T=4200, n=3, gridlock=False):
    """Takeoff ramp, auctions every 12 ticks, an optional long CA burst (a
    gridlock episode), convergence, a second formation."""
    q = np.zeros((T, n, 3))
    q[:, :, 2] = np.clip(np.arange(T) * 0.02, 0.0, 1.0)[:, None]
    q[:, :, 0] = np.linspace(0, 4, T)[:, None] + np.arange(n)[None, :]
    dn = np.full((T, n), 3.0)
    dn[900:] = 0.1
    dn[1500:2200] = 3.0
    dn[2200:] = 0.1
    ca = np.zeros((T, n), bool)
    if gridlock:
        dn[900:] = 3.0
        ca[700:1800, 0] = True
        dn[1900:] = 0.1
    events = np.zeros(T, bool)
    events[::12] = True
    return q, dn, ca, events


@pytest.mark.parametrize("case", ["converge", "gridlock", "timeout"])
def test_summary_fsm_matches_reference(case):
    """Both packages' `SummaryTrialFSM` fed the same chunk summaries: the
    same actions per chunk, states, ticks, times, assignment counts,
    gridlock episodes, distances and snapshots."""
    dt, chunk = 0.1, 60
    W = max(1, int(round(tsup.BUFFER_SECONDS / dt)))
    if case == "timeout":
        q, dn, ca, events = _synthetic_trial(T=7000)
        dn[:] = 3.0
    else:
        q, dn, ca, events = _synthetic_trial(gridlock=case == "gridlock")
    a = jsup.SummaryTrialFSM(3, 2, takeoff_alt=1.0, dt=dt)
    b = tsup.SummaryTrialFSM(3, 2, takeoff_alt=1.0, dt=dt)
    acts_a = _drive_summary(a, q, dn, ca, events, chunk, W)
    acts_b = _drive_summary(b, q, dn, ca, events, chunk, W)
    assert acts_a == acts_b
    assert tsup.NAMES[b.state] == jsup.NAMES[a.state]
    assert (b.tick_count, b.curr_formation_idx, b.assignments) == \
        (a.tick_count, a.curr_formation_idx, a.assignments)
    assert b.times == a.times and b.time_avoidance == a.time_avoidance
    np.testing.assert_array_equal(b.dist, a.dist)
    assert b.csv_row(0) == a.csv_row(0)
    if case == "gridlock":
        assert b.time_avoidance and b.time_avoidance[0] > 0
    if case == "timeout":
        assert b.state == tsup.TrialState.TERMINATE
    sa, sb = a.snapshot(), b.snapshot()
    assert sa.keys() == sb.keys()
    restored = tsup.SummaryTrialFSM(3, 2, takeoff_alt=1.0,
                                    dt=dt).restore(sb)
    assert restored.csv_row(0) == b.csv_row(0)


# ------------------------------------------------- plain batched kernels

@pytest.mark.parametrize("n", [6, 33])
def test_plain_batched_kernels_equal_single_calls(n):
    """Each kernel's plain version over a (B, ...) batch equals B calls on
    the single problems, exactly (the same operations in the same order):
    K1 Sinkhorn, K2 rounding with its per-problem round counts (one plan of
    all ties, one cut by max_rounds), K3 flood merge blocked and not."""
    rng = np.random.default_rng(n)
    B = 3
    cost = torch.from_numpy(rng.uniform(0.0, 2.0, (B, n, n)))
    plans = ops.sinkhorn_log_plain(cost, 0.03, 60)
    np.testing.assert_array_equal(
        plans.numpy(), torch.stack([ops.sinkhorn_log_plain(c, 0.03, 60)
                                    for c in cost]).numpy())
    plans = torch.cat([plans, torch.zeros(1, n, n, dtype=plans.dtype)])
    for max_rounds in (None, 2):
        perm, rounds = ops.round_dominant_plain(plans, max_rounds)
        single = [ops.round_dominant_plain(p, max_rounds) for p in plans]
        np.testing.assert_array_equal(
            perm.numpy(), torch.stack([s[0] for s in single]).numpy())
        np.testing.assert_array_equal(
            rounds.numpy(), torch.stack([s[1] for s in single]).numpy())
    packed = torch.from_numpy(
        rng.integers(0, 2**31 - 1, (B, n, 7)).astype(np.int32))
    comm = torch.from_numpy(rng.uniform(size=(B, n, n)) < 0.4)
    comm[0, 1] = False                       # a receiver with no sender
    for block in (None, 3):
        np.testing.assert_array_equal(
            ops.flood_merge_plain(packed, comm, block).numpy(),
            torch.stack([ops.flood_merge_plain(p, c, block)
                         for p, c in zip(packed, comm)]).numpy())

"""Scenario timelines in the port (`aclswarm_torch.scenarios`, the five
axes of `sim.engine.step`, obstacles in `control.colavoid`,
`localization.noised_view`) against the reference's on its own cases
(`tests/test_scenarios.py`), float64 on the CPU; the JAX side runs as its
own tests run it.

- Every timeline evaluator equals the reference's on the same leaves and
  ticks (serial and batched); the obstacle columns of the avoidance too.
- Registry draws: every family's leaves equal the reference's for the same
  ``(family, seed, n)``.
- Rollouts (here the no-scenario ones; the rest in
  `tests/test_torch_scenarios_rollouts.py`): discrete fields equal on
  every tick (`v2f`, `mode`, `auctioned`, `assign_valid`, `reassigned`,
  `ca_active`, `scen_event`, the summary's `recovery_ticks` and
  `fault_churn`), positions and |distcmd| at 1e-9 through tick 60, as
  `tests/test_torch_batched.py` holds them. The byzantine lie, the gusts
  and the noise are normal draws a few ulp off JAX's
  (`tests/test_torch_prng.py`); no tick of these cases holds an auction
  or avoidance tie within that, so their discrete fields still agree.
- Port against port, bit for bit: `no_scenario` against ``scenario=None``
  (serial, flooded with faults, batched, resumed from a checkpoint), a
  live scenario resumed from a checkpoint, and a heterogeneous batch
  against its serial rollouts.

The reference's swarmcheck contract test (`scen_points`), fuzzer, serve
and sharded cases have no counterpart: invariants, serving and the mesh
are later slices. Serial time of this file on one CPU host: ~50 s.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch import control, convert, faults, scenarios as tscn, sim
from aclswarm_torch.core.types import ControlGains, SafetyParams
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.scenarios import timeline as ttl
from aclswarm_torch.sim import localization as tloc
from aclswarm_torch.sim import summary as tsum
from aclswarm_tpu import control as jcontrol
from aclswarm_tpu import faults as jfaults
from aclswarm_tpu import scenarios as jscn
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from aclswarm_tpu.scenarios import timeline as jtl
from aclswarm_tpu.sim import localization as jloc
from aclswarm_tpu.sim import summary as jsum

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

CPU64 = dict(device="cpu", dtype=torch.float64)
N, T, ASSIGN_EVERY = 6, 130, 60
# the port-only parity runs: two auctions (ticks 0 and 60) are enough to
# show a bit-identical pass-through, and keep tier-1 short
T_PARITY = 70
ATOL, TICKS_AT_ATOL = 1e-9, 60
EXACT = ("v2f", "mode", "auctioned", "assign_valid", "reassigned",
         "ca_active", "scen_event")
PORT_FIELDS = ("distcmd_norm", "ca_active", "assign_valid", "reassigned",
               "auctioned", "q", "mode", "v2f")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _problem(B=1, n=N, seed=0, localization=False, scenarios=None,
             scheds=None):
    rng = np.random.default_rng(seed)
    adj = np.ones((n, n)) - np.eye(n)
    forms, states = [], []
    for b in range(B):
        pts = rng.normal(size=(n, 3)) * 5
        gains = rng.normal(size=(n, n, 3, 3)) * 0.01
        forms.append(jmake_formation(jnp.asarray(pts), jnp.asarray(adj),
                                     jnp.asarray(gains)))
        states.append(jsim.init_state(
            rng.normal(size=(n, 3)) * 5 + np.array([0, 0, 2.0]),
            localization=localization,
            faults=None if scheds is None else scheds[b],
            scenario=None if scenarios is None else scenarios[b]))
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 20.0]))
    return states, forms, sp


def _stack(xs):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *xs)


def _port(state, form, sp):
    return (convert.sim_state_from_numpy(_np(state), **CPU64),
            convert.formation_from_numpy(_np(form), **CPU64),
            convert.safety_params_from_numpy(_np(sp)))


def _cfg(pkg, **kw):
    kw.setdefault("assignment", "auction")
    kw.setdefault("assign_every", ASSIGN_EVERY)
    return pkg.SimConfig(**kw)


def _assert_matches_reference(tm, jm, names=EXACT):
    for k in names:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k in ("q", "distcmd_norm"):
        np.testing.assert_allclose(
            getattr(tm, k).numpy()[:TICKS_AT_ATOL],
            np.asarray(getattr(jm, k))[:TICKS_AT_ATOL], rtol=0, atol=ATOL,
            err_msg=k)


def _assert_port_equal(m1, m2, f1, f2):
    for k in PORT_FIELDS:
        assert torch.equal(getattr(m1, k), getattr(m2, k)), k
    for a, b in ((f1.swarm.q, f2.swarm.q), (f1.swarm.vel, f2.swarm.vel),
                 (f1.v2f, f2.v2f)):
        assert torch.equal(a, b)


def _with(tstate, **kw):
    from dataclasses import replace
    return replace(tstate, **kw)


def _tno(n=N):
    return tscn.no_scenario(n, **CPU64)


# --------------------------------------------------------------------------
# 1. no_scenario == scenario=None, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("assignment", ["auction", "sinkhorn", "cbaa"])
def test_no_scenario_bit_parity_serial(assignment):
    states, forms, sp = _problem(seed=1)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    cfg = _cfg(sim, assignment=assignment, flight_fsm=True)
    f1, m1 = sim.rollout(tstate, tform, ControlGains(), tsp, cfg, T_PARITY)
    f2, m2 = sim.rollout(_with(tstate, scenario=_tno()), tform,
                         ControlGains(), tsp, cfg, T_PARITY)
    _assert_port_equal(m1, m2, f1, f2)
    assert m1.scen_event is None and not m2.scen_event.any()


def test_no_scenario_bit_parity_flooded_with_faults():
    scheds = [jfaults.sample_schedule(7, N, dropout_frac=0.3, drop_tick=30,
                                      rejoin_tick=90, link_loss=0.2,
                                      dtype=jnp.float64)]
    states, forms, sp = _problem(seed=2, localization=True, scheds=scheds)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    cfg = _cfg(sim, assignment="cbaa", localization="flooded",
               flight_fsm=True)
    f1, m1 = sim.rollout(tstate, tform, ControlGains(), tsp, cfg, T)
    f2, m2 = sim.rollout(_with(tstate, scenario=_tno()), tform,
                         ControlGains(), tsp, cfg, T)
    _assert_port_equal(m1, m2, f1, f2)
    assert torch.equal(m1.alive, m2.alive)
    assert torch.equal(f1.loc.est, f2.loc.est)


def test_no_scenario_bit_parity_batched():
    B = 3
    states, forms, sp = _problem(B, seed=3)
    tstate, tform, tsp = _port(_stack(states), _stack(forms), sp)
    cfg = _cfg(sim)
    nos = sim.stack_states([_with(sim.trial(tstate, b), scenario=_tno())
                            for b in range(B)])
    f1, m1 = sim.batched_rollout(tstate, tform, ControlGains(), tsp, cfg,
                                 T_PARITY)
    f2, m2 = sim.batched_rollout(nos, tform, ControlGains(), tsp, cfg,
                                 T_PARITY)
    _assert_port_equal(m1, m2, f1, f2)


def test_no_scenario_bit_parity_resumed_from_checkpoint():
    """Chunk 1 -> the checkpoint codec -> restore -> chunk 2 equals the
    uninterrupted scenario=None run."""
    states, forms, sp = _problem(seed=4)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    cfg = _cfg(sim)
    f_ref, m_ref = sim.rollout(tstate, tform, ControlGains(), tsp, cfg, T)
    template = _with(tstate, scenario=_tno())
    mid, _ = sim.rollout(template, tform, ControlGains(), tsp, cfg, T // 2)
    blob = tckpt.dumps({"state": convert.sim_state_to_numpy(mid)},
                       tckpt.make_manifest("test", "h", 1, "f"))
    payload, _ = tckpt.loads(blob, "<mem>")
    restored = tckpt.restore_state(template, payload["state"])
    assert restored.tick == T // 2 and restored.scenario is not None
    f2, m2 = sim.rollout(restored, tform, ControlGains(), tsp, cfg,
                         T - T // 2)
    assert torch.equal(f_ref.swarm.q, f2.swarm.q)
    assert torch.equal(f_ref.v2f, f2.v2f)
    for k in ("q", "v2f"):
        assert torch.equal(getattr(m_ref, k)[T // 2:], getattr(m2, k)), k


def test_scenario_resumed_from_checkpoint_is_bit_identical():
    """A live scenario (and a fault schedule) crosses the codec: the
    resumed half equals the uninterrupted run bit for bit."""
    scen = tscn.sample("kitchen_sink", 3, N, horizon=T, **CPU64)
    states, forms, sp = _problem(seed=4)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    start = _with(tstate, scenario=scen, faults=faults.sample_schedule(
        5, N, dropout_frac=0.34, drop_tick=40, rejoin_tick=100,
        link_loss=0.3, **CPU64))
    cfg = _cfg(sim, assignment="sinkhorn")
    f_ref, m_ref = sim.rollout(start, tform, ControlGains(), tsp, cfg, T)
    mid, _ = sim.rollout(start, tform, ControlGains(), tsp, cfg, T // 2)
    blob = tckpt.dumps({"state": convert.sim_state_to_numpy(mid)},
                       tckpt.make_manifest("test", "h", 1, "f"))
    restored = tckpt.restore_state(start, tckpt.loads(blob)[0]["state"])
    f2, m2 = sim.rollout(restored, tform, ControlGains(), tsp, cfg,
                         T - T // 2)
    assert torch.equal(f_ref.swarm.q, f2.swarm.q)
    for k in ("q", "v2f", "scen_event", "alive"):
        assert torch.equal(getattr(m_ref, k)[T // 2:], getattr(m2, k)), k


# --------------------------------------------------------------------------
# 3. axis semantics and the evaluators
# --------------------------------------------------------------------------

def _jscen_obstacle():
    dt = jnp.float64
    K = jtl.DEFAULT_MAX_OBSTACLES
    return jscn.no_scenario(N, dtype=dt).replace(
        obs_center=jnp.zeros((K, 3), dt).at[0].set(
            jnp.asarray([1.0, 0.0, 2.0], dt)),
        obs_vel=jnp.zeros((K, 3), dt).at[0].set(
            jnp.asarray([0.5, 0.0, 0.0], dt)),
        obs_radius=jnp.zeros((K,), dt).at[0].set(1.2),
        obs_appear=jnp.full((K,), jtl.NEVER, jnp.int32).at[0].set(10),
        obs_vanish=jnp.full((K,), jtl.NEVER, jnp.int32).at[0].set(50))


def test_obstacle_pops_up_moves_and_vanishes():
    scen = convert.scenario_from_numpy(_np(_jscen_obstacle()), **CPU64)
    pos, act = ttl.obstacles_at(scen, 0, 0.01)
    assert not act[0]
    pos, act = ttl.obstacles_at(scen, 20, 0.01)
    assert act[0]
    np.testing.assert_allclose(pos[0, 0].item(), 1.0 + 0.5 * 0.2)
    _, act = ttl.obstacles_at(scen, 50, 0.01)
    assert not act[0]
    for t, want in ((9, False), (10, True), (11, False), (50, True)):
        assert bool(ttl.scenario_event_at(scen, t)) is want, t


def _evaluators(mod, scen, base, q, t, n):
    """Every evaluator of one package at tick ``t``."""
    pos, act = mod.obstacles_at(scen, t, 0.01)
    pts, changed = mod.formation_points_at(scen, base, t, 0.01)
    dq, won = mod.wind_at(scen, t, 0.01, n, base.dtype)
    nz, non = mod.est_noise_at(scen, t, n, base.dtype)
    return dict(pos=pos, act=act, stage=mod.stage_at(scen, t), pts=pts,
                changed=changed, rep=mod.reported_positions(scen, q, t),
                dq=dq, won=won, noise=nz, non=non,
                rematch=mod.rematch_ok_at(scen, t),
                event=mod.scenario_event_at(scen, t))


# the reference's evaluators compiled once (eagerly each would dispatch
# its operations one by one)
_jevaluators = jax.jit(lambda scen, base, q, t, n: _evaluators(
    jtl, scen, base, q, t, n), static_argnums=(4,))

# exact: masks, stages, flags; the tracks (`pos`) and the drifted points
# (`pts`) are a multiply and an add, which compiled XLA fuses into one
# (a last-bit difference), held at 8 ulp with the draws
UNIFORM_EXACT = ("act", "stage", "changed", "won", "non", "rematch",
                 "event")


@pytest.mark.parametrize("family", list(jscn.FAMILIES))
def test_timeline_evaluators_match_reference(family):
    """Each evaluator at ticks around every event, one trial and a batch
    of two with per-trial ticks: equal to the reference's compiled
    evaluators (the three normal draws, the tracks and the drifted points
    within 8 ulp)."""
    n, horizon = 7, 100
    rng = np.random.default_rng(0)
    base = rng.normal(size=(n, 3))
    q = rng.normal(size=(n, 3)) * 3
    js = [jscn.sample(family, s, n, horizon=horizon, dtype=jnp.float64)
          for s in (1, 2)]
    ts = [tscn.sample(family, s, n, horizon=horizon, **CPU64)
          for s in (1, 2)]
    for t in (0, 20, 25, 26, 30, 35, 70, 75, 240):   # the events, around
        want = _jevaluators(js[0], jnp.asarray(base), jnp.asarray(q),
                            jnp.asarray(t, jnp.int32), n)
        got = _evaluators(ttl, ts[0], torch.as_tensor(base),
                          torch.as_tensor(q), t, n)
        for k in UNIFORM_EXACT:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), (t, k))
        for k in ("pos", "pts", "rep", "dq", "noise"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=8 * 2.0**-52, atol=1e-14,
                                       err_msg=str((t, k)))
    # a batch of two scenarios at per-trial ticks, against lone calls
    batch = sim.stack_states([sim.init_state(q, scenario=s, **CPU64)
                              for s in ts]).scenario
    tt = torch.tensor([25, 70], dtype=torch.int32)
    got = _evaluators(ttl, batch, torch.as_tensor(base).expand(2, n, 3),
                      torch.as_tensor(q).expand(2, n, 3), tt, n)
    for b in range(2):
        lone = _evaluators(ttl, ts[b], torch.as_tensor(base),
                           torch.as_tensor(q), int(tt[b]), n)
        for k, v in lone.items():
            assert torch.equal(got[k][b], v), (b, k)


@pytest.mark.slow   # as the reference marks its own
def test_obstacle_casts_sector_for_head_on_vehicle():
    """Obstacle columns against the reference's, and an inactive obstacle
    bit-identical to none (dense and k-pruned, one trial and a batch)."""
    rng = np.random.default_rng(3)
    q = np.concatenate([[[0.0, 0.0, 2.0], [40.0, 40.0, 2.0]],
                        rng.uniform(-3, 3, size=(6, 3))])
    vel = rng.normal(size=(8, 3)) * 0.4
    vel[:2] = [[0.5, 0.0, 0.0], [0.5, 0.0, 0.0]]
    obs_pos = np.array([[1.4, 0.0, 2.0], [-2.0, 1.0, 2.0]])
    obs_r = np.array([1.2, 0.8])
    jsp, tsp = JSafetyParams(), SafetyParams()
    javoid = jax.jit(jcontrol.collision_avoidance,
                     static_argnames=("max_neighbors",))
    for active in ([True, True], [True, False], [False, False]):
        jobs = (jnp.asarray(obs_pos), jnp.asarray(obs_r),
                jnp.asarray(active))
        tobs = (torch.as_tensor(obs_pos), torch.as_tensor(obs_r),
                torch.as_tensor(active))
        for k in (None, 3):
            jv, jmod = javoid(jnp.asarray(q), jnp.asarray(vel), jsp,
                              max_neighbors=k, obstacles=jobs)
            tv, tmod = control.collision_avoidance(
                torch.as_tensor(q), torch.as_tensor(vel), tsp,
                max_neighbors=k, obstacles=tobs)
            np.testing.assert_array_equal(tmod.numpy(), np.asarray(jmod))
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                       atol=1e-12)
            if not any(active):
                rv, rmod = control.collision_avoidance(
                    torch.as_tensor(q), torch.as_tensor(vel), tsp,
                    max_neighbors=k)
                assert torch.equal(rv, tv) and torch.equal(rmod, tmod)
            else:
                assert tmod[0] and not tmod[1]
            # a batch of two trials: each row as its lone call
            bv, bmod = control.collision_avoidance(
                torch.as_tensor(q).expand(2, 8, 3),
                torch.as_tensor(vel).expand(2, 8, 3), tsp, max_neighbors=k,
                obstacles=tuple(x.expand(2, *x.shape) for x in tobs))
            assert torch.equal(bv[1], tv) and torch.equal(bmod[0], tmod)


def test_noised_view_matches_reference():
    rng = np.random.default_rng(4)
    est = rng.normal(size=(N, N, 3))
    age = rng.integers(0, 9, size=(N, N)).astype(np.int32)
    draw = rng.normal(size=(N, N, 3)) * 0.1
    for on in (True, False):
        want = jloc.noised_view(
            jloc.EstimateTable(est=jnp.asarray(est), age=jnp.asarray(age)),
            (jnp.asarray(draw), jnp.asarray(on)))
        got = tloc.noised_view(
            tloc.EstimateTable(est=torch.as_tensor(est),
                               age=torch.as_tensor(age)),
            (torch.as_tensor(draw), torch.as_tensor(on)))
        np.testing.assert_array_equal(got.est.numpy(), np.asarray(want.est))
        np.testing.assert_array_equal(got.age.numpy(), age)
    # a batch: per-trial flags
    tab = tloc.EstimateTable(est=torch.as_tensor(est).expand(2, N, N, 3),
                             age=torch.as_tensor(age).expand(2, N, N))
    out = tloc.noised_view(tab, (torch.as_tensor(draw).expand(2, N, N, 3),
                                 torch.tensor([True, False])))
    assert torch.equal(out.est[1], tab.est[1])
    assert not torch.equal(out.est[0], tab.est[0])


def test_sequence_and_drift_move_effective_formation():
    dt = jnp.float64
    base = np.random.default_rng(0).normal(size=(N, 3))
    scen = jscn.no_scenario(N, dtype=dt).replace(
        seq_points=jnp.asarray(np.ones((2, N, 3)), dt) * 7.0,
        seq_tick=jnp.asarray([50, jtl.NEVER], jnp.int32),
        drift_vel=jnp.asarray([0.1, 0.0, 0.0], dt),
        drift_tick=jnp.asarray(100, jnp.int32))
    ts = convert.scenario_from_numpy(_np(scen), **CPU64)
    tb = torch.as_tensor(base)
    pts, changed = ttl.formation_points_at(ts, tb, 0, 0.01)
    assert torch.equal(pts, tb) and not changed
    pts, changed = ttl.formation_points_at(ts, tb, 60, 0.01)
    assert changed
    np.testing.assert_allclose(pts.numpy(), 7.0)
    pts, _ = ttl.formation_points_at(ts, tb, 200, 0.01)
    np.testing.assert_allclose(pts.numpy()[:, 0], 7.0 + 0.1 * 1.0,
                               rtol=1e-6)
    for t in (50, 100):
        assert ttl.scenario_event_at(ts, t)
    assert not ttl.scenario_event_at(ts, 75)


def test_rematch_cadence_throttles_accepted_auctions():
    states, forms, sp = _problem(seed=8)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    leaves = ttl.no_scenario_numpy(N, dtype=np.float64)
    leaves["rematch_every"] = np.int32(120)
    scen = ttl.from_numpy(leaves, **CPU64)
    _, m = sim.rollout(_with(tstate, scenario=scen), tform, ControlGains(),
                       tsp, _cfg(sim), T)
    assert m.auctioned.nonzero()[:, 0].tolist() == [
        t for t in range(T) if t % ASSIGN_EVERY == 0 and t % 120 == 0]
    _, m0 = sim.rollout(_with(tstate, scenario=_tno()), tform,
                        ControlGains(), tsp, _cfg(sim), T)
    assert m0.auctioned.nonzero()[:, 0].tolist() == [
        t for t in range(T) if t % ASSIGN_EVERY == 0]


# --------------------------------------------------------------------------
# 4. recovery clock and registry
# --------------------------------------------------------------------------

@pytest.mark.slow   # as the reference marks its own
def test_scenario_events_feed_recovery_clock():
    dt = jnp.float64
    B = 2
    wind = jscn.compose(N, 31, {"wind": dict(wind=0.2, onset_frac=0.25)},
                        dtype=dt, horizon=120)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(N, 3)) * 4 + np.array([0, 0, 3.0])
    form = jmake_formation(jnp.asarray(pts, dt),
                           jnp.asarray(np.ones((N, N)) - np.eye(N), dt))
    sp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                       bounds_max=jnp.asarray([50.0, 50.0, 20.0]))
    jb = _stack([jsim.init_state(jnp.asarray(pts, dt), scenario=wind)] * B)
    jfm = _stack([form] * B)
    tstate, tform, tsp = _port(jb, jfm, sp)
    kw = dict(assign_every=30)
    _, _, js = jsum.batched_rollout_summary(
        jb, jsum.init_carry(N, 5, dtype=dt, batch=B), jfm, JControlGains(),
        sp, _cfg(jsim, **kw), 120, None, 0, window=5, takeoff_alt=3.0)
    _, _, ts = tsum.batched_rollout_summary(
        tstate, tsum.init_carry(N, 5, batch=B, **CPU64), tform,
        ControlGains(), tsp, _cfg(sim, **kw), 120, None, 0, window=5,
        takeoff_alt=3.0)
    for k in ("scen_event", "recovery_ticks", "fault_churn", "conv_all"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), k)
    assert ts.fault_event is None and ts.n_alive is None
    ev = ts.scen_event.numpy()
    assert ev[:, 30].all() and ev.sum(axis=1).tolist() == [1, 1]
    assert (ts.recovery_ticks >= 0).any()


def test_registry_families_sample_deterministic_and_validate():
    """Every family's draw equals the reference's leaf for leaf (float32
    and float64), deterministic, validated at the door."""
    from dataclasses import fields

    for name, fam in tscn.FAMILIES.items():
        for tdt, jdt in ((torch.float64, jnp.float64),
                         (torch.float32, jnp.float32)):
            s1 = tscn.sample(name, 5, N, horizon=200, device="cpu",
                             dtype=tdt)
            s2 = tscn.sample(name, 5, N, horizon=200, device="cpu",
                             dtype=tdt)
            js = jscn.sample(name, 5, N, horizon=200, dtype=jdt)
            for f in fields(tscn.Scenario):
                a, b = getattr(s1, f.name), getattr(s2, f.name)
                assert torch.equal(a, b), (name, f.name)
                want = np.asarray(getattr(js, f.name))
                np.testing.assert_array_equal(a.numpy(), want,
                                              err_msg=f"{name}.{f.name}")
                if f.name not in ("key",) and a.is_floating_point():
                    assert a.dtype == tdt
        assert s1.n == N
        assert s1.max_obstacles == ttl.DEFAULT_MAX_OBSTACLES
        assert s1.max_stages == ttl.DEFAULT_MAX_STAGES
        assert fam.localization == jscn.FAMILIES[name].localization
        assert fam.space == jscn.FAMILIES[name].space
    with pytest.raises(ValueError, match="unknown scenario family"):
        tscn.validate("nope")
    with pytest.raises(ValueError, match="no parameter"):
        tscn.validate("wind_gust", {"wind.bogus": 1.0})
    with pytest.raises(ValueError, match="outside the"):
        tscn.validate("sensor_noise", {"noise.sigma": 1e6})
    with pytest.raises(ValueError, match="outside the"):
        tscn.validate("wind_gust", {"wind.wind": True})
    tscn.validate("wind_gust", {"wind.wind": 0.2})
    with pytest.raises(ValueError, match="unknown scenario axis"):
        tscn.compose(N, 1, {"bogus": {}}, device="cpu")
    s = tscn.sample("wind_gust", 5, N, horizon=200,
                    params={"wind.wind": 0.2}, **CPU64)
    js = jscn.sample("wind_gust", 5, N, horizon=200,
                     params={"wind.wind": 0.2}, dtype=jnp.float64)
    np.testing.assert_array_equal(s.wind_vel.numpy(),
                                  np.asarray(js.wind_vel))


def test_init_state_checks_the_scenario_width():
    with pytest.raises(ValueError, match="scenario scripts n=4"):
        sim.init_state(np.zeros((5, 3)), scenario=tscn.no_scenario(
            4, **CPU64), **CPU64)

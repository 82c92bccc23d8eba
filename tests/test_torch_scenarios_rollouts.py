"""Scenario rollouts in the port against the reference's, float64 on the
CPU (the engine-level half of `tests/test_torch_scenarios.py`, whose
docstring states the tolerances and whose helpers these tests share):

- the reference's heterogeneous batch (no scenario, wind, obstacles with
  drift and a re-matching cadence, byzantine bidders with a formation
  sequence): equal to the reference's batched rollout in every discrete
  field, and each trial to its serial port rollout bit for bit;
- one draw of each of the eight families at n=10 over 100 ticks, the
  eight as one batch on the flooded model in each package (a batch equals
  its serial rollouts, the heterogeneous case), with the recovery clock;
- wind with a dead fleet, sensor noise on the flooded model, and the
  byzantine lie under all three assignment solvers.

Serial time of this file on one CPU host: ~20 s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aclswarm_torch import convert, sim
from aclswarm_torch.core import types as ttypes
from aclswarm_torch.core.types import ControlGains
from aclswarm_torch.sim import summary as tsum
from aclswarm_tpu import faults as jfaults
from aclswarm_tpu import scenarios as jscn
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.scenarios import timeline as jtl
from aclswarm_tpu.sim import summary as jsum
from test_torch_scenarios import (CPU64, EXACT, N, PORT_FIELDS, T,
                                  _assert_matches_reference, _cfg, _np,
                                  _port, _problem, _stack, _with)

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers


@pytest.mark.slow   # as the reference marks its own
def test_heterogeneous_scenarios_batched_matches_serial():
    dt = jnp.float64
    scens = [
        jscn.no_scenario(N, dtype=dt),
        jscn.compose(N, 11, {"wind": dict(wind=0.2, onset_frac=0.2)},
                     dtype=dt, horizon=T),
        jscn.compose(N, 12, {"obstacles": dict(count=2, radius=1.0),
                             "drift": dict(speed=0.05,
                                           rematch_every=120)},
                     dtype=dt, horizon=T),
        jscn.compose(N, 13, {"byzantine": dict(frac=0.3, sigma=2.0),
                             "sequence": dict(stages=2)},
                     dtype=dt, horizon=T),
    ]
    B = len(scens)
    states, forms, sp = _problem(B, seed=5, scenarios=scens)
    jb, jfm = _stack(states), _stack(forms)
    tstate, tform, tsp = _port(jb, jfm, sp)
    jf, jm = jsim.batched_rollout(jb, jfm, JControlGains(), sp, _cfg(jsim),
                                  T)
    tf, tm = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                 _cfg(sim), T)
    _assert_matches_reference(tm, jm)
    for b in range(B):
        fs, ms = sim.rollout(sim.trial(tstate, b), ttypes.row(tform, b),
                             ControlGains(), tsp, _cfg(sim), T)
        for k in PORT_FIELDS + ("scen_event",):
            assert torch.equal(getattr(ms, k), getattr(tm, k)[:, b]), (b, k)


FAMILIES = list(jscn.FAMILIES)
# a family's events land between 20 % and 75 % of its horizon
T_FAMILY = 100


@functools.lru_cache(maxsize=None)
def _family_runs():
    """One draw of each family (seed 7, horizon 100) on its own start of
    the reference's `_problem` (n=10, seed 12), all eight as one batch on
    the flooded model (the sensor-noise family bites only there),
    Sinkhorn with the hysteresis (the n=1000 engine's assignment) at an
    auction every 60, flown 100 ticks by both packages' batched rollouts:
    ``(port metrics, reference metrics)``."""
    n = 10
    js = [jscn.sample(f, 7, n, horizon=T_FAMILY, dtype=jnp.float64)
          for f in FAMILIES]
    states, forms, sp = _problem(len(FAMILIES), n, seed=12,
                                 localization=True, scenarios=js)
    jb, jfm = _stack(states), _stack(forms)
    tstate, tform, tsp = _port(jb, jfm, sp)
    kw = dict(assignment="sinkhorn", assign_eps=0.01, localization="flooded")
    _, jm = jsim.batched_rollout(jb, jfm, JControlGains(), sp,
                                 _cfg(jsim, **kw), T_FAMILY)
    _, tm = sim.batched_rollout(tstate, tform, ControlGains(), tsp,
                                _cfg(sim, **kw), T_FAMILY)
    return tm, jm


@pytest.mark.parametrize("family", FAMILIES)
def test_family_rollout_matches_reference(family):
    """Each family's trial of the batch against the reference's, and the
    recovery clock (W=20) over its metrics in both packages."""
    n, W, b = 10, 20, FAMILIES.index(family)
    tm_all, jm_all = _family_runs()
    tm = sim.StepMetrics(**{k: None if v is None else v[:, b]
                            for k, v in vars(tm_all).items()})
    jm = jax.tree.map(lambda x: x[:, b], jm_all)
    _assert_matches_reference(tm, jm)
    assert tm.scen_event.any()
    jsumm, jc = jsum.summarize_chunk(jm, jsum.init_carry(
        n, W, dtype=jnp.float64), W, 2.0)
    tsumm, tc = tsum.summarize_chunk(tm, tsum.init_carry(n, W, **CPU64), W,
                                     2.0)
    for k in ("scen_event", "recovery_ticks", "fault_churn", "conv_all"):
        np.testing.assert_array_equal(getattr(tsumm, k).numpy(),
                                      np.asarray(getattr(jsumm, k)), k)
    for k in ("rec_pending", "rec_since", "rec_churn"):
        assert getattr(tc, k).item() == np.asarray(getattr(jc, k)).item()


def test_wind_displaces_but_dead_vehicles_stay_frozen():
    dt = jnp.float64
    wind = jscn.no_scenario(N, dtype=dt).replace(
        wind_vel=jnp.asarray([0.2, 0.0, 0.0], dt),
        wind_tick=jnp.asarray(0, jnp.int32))
    sched = jfaults.sample_schedule(3, N, dropout_frac=0.5, drop_tick=20,
                                    dtype=dt)
    states, forms, sp = _problem(seed=6, scheds=[sched])
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    f1, _ = sim.rollout(tstate, tform, ControlGains(), tsp, _cfg(sim), T)
    jf, jm = jsim.rollout(states[0].replace(scenario=wind), forms[0],
                          JControlGains(), sp, _cfg(jsim), T)
    f2, m2 = sim.rollout(_with(tstate, scenario=convert.scenario_from_numpy(
        _np(wind), **CPU64)), tform, ControlGains(), tsp, _cfg(sim), T)
    _assert_matches_reference(m2, jm, EXACT + ("alive",))
    assert not torch.equal(f1.swarm.q, f2.swarm.q)
    dead = ~m2.alive[-1]
    assert dead.any()
    assert torch.equal(m2.q[-1][dead], m2.q[25][dead])


@pytest.mark.slow   # as the reference marks its own
def test_sensor_noise_perturbs_only_flooded_estimates():
    dt = jnp.float64
    noisy = jscn.no_scenario(N, dtype=dt).replace(
        noise_std=jnp.asarray(0.2, dt),
        noise_tick=jnp.asarray(40, jnp.int32),
        key=jnp.asarray(jtl.key_leaves(9), jnp.uint32))
    states, forms, sp = _problem(seed=7, localization=True)
    tstate, tform, tsp = _port(states[0], forms[0], sp)
    kw = dict(assignment="cbaa", localization="flooded")
    f1, m1 = sim.rollout(tstate, tform, ControlGains(), tsp,
                         _cfg(sim, **kw), T)
    jf, jm = jsim.rollout(states[0].replace(scenario=noisy), forms[0],
                          JControlGains(), sp, _cfg(jsim, **kw), T)
    f2, m2 = sim.rollout(_with(tstate, scenario=convert.scenario_from_numpy(
        _np(noisy), **CPU64)), tform, ControlGains(), tsp,
        _cfg(sim, **kw), T)
    _assert_matches_reference(m2, jm)
    assert torch.equal(m1.q[:40], m2.q[:40])
    assert not torch.equal(f1.loc.est, f2.loc.est)
    # the carried tables stay clean: the ages are the noiseless run's
    np.testing.assert_array_equal(f2.loc.age.numpy(), np.asarray(jf.loc.age))


@pytest.mark.parametrize("assignment", ["auction", "sinkhorn", "cbaa"])
def test_byzantine_corrupts_assignment_but_extraction_stays_honest(
        assignment):
    dt = jnp.float64
    byz = jscn.no_scenario(N, dtype=dt).replace(
        byz_mask=jnp.asarray([True, True, False, False, False, False]),
        byz_std=jnp.asarray(8.0, dt),
        byz_tick=jnp.asarray(0, jnp.int32),
        key=jnp.asarray(jtl.key_leaves(21), jnp.uint32))
    states, forms, sp = _problem(seed=9)
    q0 = np.asarray(states[0].swarm.q).copy()
    q0[:, 2] = np.abs(q0[:, 2]) + 2.0
    kw = dict(assignment=assignment)
    ticks = 70          # lies from tick 0: the auctions at 0 and 60
    jf, jm = jsim.rollout(jsim.init_state(q0, scenario=byz), forms[0],
                          JControlGains(), sp, _cfg(jsim, **kw), ticks)
    _, tform, tsp = _port(states[0], forms[0], sp)
    clean = sim.init_state(q0, **CPU64)
    _, m1 = sim.rollout(clean, tform, ControlGains(), tsp, _cfg(sim, **kw),
                        ticks)
    _, m2 = sim.rollout(_with(clean, scenario=convert.scenario_from_numpy(
        _np(byz), **CPU64)), tform, ControlGains(), tsp, _cfg(sim, **kw),
        ticks)
    _assert_matches_reference(m2, jm)
    assert not torch.equal(m1.v2f, m2.v2f)
    for row in m2.v2f.reshape(-1, N):
        assert sorted(row.tolist()) == list(range(N))

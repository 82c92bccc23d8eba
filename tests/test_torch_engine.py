"""The slice as a whole: the reference's `rollout` vs the port's `rollout`
from the same numpy state, float64 on the CPU.

The main case is the `simform1000_flooded` deployment scaled down to
n=24: Sinkhorn assignment with the assign_eps hysteresis, flooded
localization with two phased stripes, k-pruned avoidance, doubleint
dynamics, an auction every 10 ticks — 40 ticks, on random gains and on
gains each package designs itself. Variants: the truth
information model under each dynamics model, the flight FSM from a ground
start under an operator schedule, and the hold ('none') mode.

The 'auction' (the default) and 'cbaa' modes run the same loop at n=16, in
both information models, CBAA with and without its warm tables, plus the
default configuration on the shipped six-vehicle formation for 240 ticks.
There positions are held at atol 1e-9.

Tolerances: positions, velocities and goals atol 1e-8 (f64, summation
order only); assignment, tick, flight modes, ages and the per-tick
boolean metrics exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch import convert
from aclswarm_torch import gains as tgains
from aclswarm_torch import sim
from aclswarm_torch.core.types import make_formation
from aclswarm_torch.harness import formgen
from aclswarm_tpu import gains as jgains
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from aclswarm_tpu.harness import formgen as jformgen
from aclswarm_tpu.sim.vehicle import CMD_GO, ExternalInputs as JInputs

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

N, TICKS, ATOL = 24, 40, 1e-8
# Not every seed can pass at this tolerance: where an agent has fewer than
# k vehicles in range and vehicle 0 is one of them, the k-pruned
# avoidance repeats vehicle 0's sector, and whether its edges count as
# free rests on the last bit of atan2/asin, where the reference's and the
# port's math libraries differ (ROADMAP.md, "Faults in the port";
# `test_torch_control.py::test_colavoid_duplicate_sector_coin_flip`).
# Seed 3 hits that at tick 37 of the tracking variant; seeds 4-8 do not.
SEED = 4
GAIN_SCALE = 0.15   # the simform1000 rows' gain_scale (trials_suite.py)
SLICE = dict(assignment="sinkhorn", localization="flooded", flood_phases=2,
             colavoid_neighbors=8, assign_eps=0.01, dynamics="doubleint",
             assign_every=10)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _problem(seed=SEED, ground=False):
    """Formation, gains, parameters and start state, from one seed (the
    simform boxes of the n=1000 deployment, scaled to n=24)."""
    group = formgen.generate_group(N, seed=seed, l=24.0, w=24.0, h=3.0,
                                   min_dist=3.0, k=1)
    pts = np.asarray(group["formations"][0]["points"])
    adj = np.asarray(group["adjmat"], float)
    rng = np.random.default_rng(seed)
    gains = rng.normal(size=(N, N, 3, 3)) * 0.01
    q0 = rng.uniform(-4.0, 4.0, size=(N, 3))     # a crowd: avoidance engages
    q0[:, 2] = 0.0 if ground else rng.uniform(1.0, 3.0, N)
    jform = jmake_formation(pts, adj, gains)
    jsp = JSafetyParams(bounds_min=jnp.asarray([-50.0, -50.0, 0.0]),
                        bounds_max=jnp.asarray([50.0, 50.0, 10.0]),
                        max_vel_xy=1.0, max_vel_z=0.5, max_accel_xy=1.0,
                        max_accel_z=1.0, spinup_time=0.05, takeoff_inc=0.02,
                        takeoff_alt=1.0)
    jcg = JControlGains(e_xy_thr=1.0, e_z_thr=0.3, kd=0.02, K1_xy=0.05)
    return jform, jsp, jcg, q0


def _roll_both(cfg_kw, ground=False, inputs=None, ticks=TICKS,
               cbaa_warm=False, problem=None, tform=None):
    """Both rollouts from one problem; ``tform`` replaces the port's copy
    of the reference's formation."""
    jform, jsp, jcg, q0 = problem or _problem(ground=ground)
    loc = cfg_kw.get("localization") == "flooded"
    jst = jsim.init_state(jnp.asarray(q0), flying=not ground,
                          localization=loc, cbaa_warm=cbaa_warm)
    jin = None if inputs is None else JInputs(
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    jf, jm = jsim.rollout(jst, jform, jcg, jsp, jsim.SimConfig(**cfg_kw),
                          ticks, jin)
    f64 = dict(device="cpu", dtype=torch.float64)
    tin = None if inputs is None else sim.ExternalInputs(
        cmd=torch.as_tensor(inputs["cmd"]),
        joy_vel=torch.as_tensor(inputs["joy_vel"]),
        joy_yawrate=torch.as_tensor(inputs["joy_yawrate"]),
        joy_active=torch.as_tensor(inputs["joy_active"]))
    tf, tm = sim.rollout(convert.sim_state_from_numpy(_np(jst), **f64),
                         tform or convert.formation_from_numpy(_np(jform),
                                                               **f64),
                         convert.control_gains_from_numpy(_np(jcg)),
                         convert.safety_params_from_numpy(_np(jsp)),
                         sim.SimConfig(**cfg_kw), ticks, tin)
    return jf, jm, tf, tm


def _assert_parity(jf, jm, tf, tm, atol=ATOL):
    out = convert.sim_state_to_numpy(tf)
    ref = _np(jf)
    for part, keys in (("swarm", ("q", "vel")),
                       ("goal", ("pos", "vel", "yaw", "dyaw"))):
        for k in keys:
            np.testing.assert_allclose(out[part][k],
                                       getattr(getattr(ref, part), k),
                                       rtol=0, atol=atol)
    np.testing.assert_array_equal(out["v2f"], ref.v2f)
    assert int(out["tick"]) == int(ref.tick)
    np.testing.assert_array_equal(out["flight"]["mode"], ref.flight.mode)
    np.testing.assert_array_equal(out["flight"]["ticks_in_mode"],
                                  ref.flight.ticks_in_mode)
    assert bool(out["first_auction"]) == bool(ref.first_auction)
    if ref.loc is not None:
        np.testing.assert_array_equal(out["loc"]["age"], ref.loc.age)
        np.testing.assert_allclose(out["loc"]["est"], ref.loc.est, rtol=0,
                                   atol=atol)
    assert (out["cbaa_warm"] is None) == (ref.cbaa_warm is None)
    if ref.cbaa_warm is not None:
        np.testing.assert_array_equal(out["cbaa_warm"]["who"],
                                      ref.cbaa_warm.who)
        np.testing.assert_allclose(out["cbaa_warm"]["price"],
                                   ref.cbaa_warm.price, rtol=1e-9, atol=0)
    for k in ("ca_active", "assign_valid", "reassigned", "auctioned", "mode",
              "v2f"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k in ("distcmd_norm", "q"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("flood_block", [None, 5])
def test_slice_rollout_parity(flood_block):
    """The scaled-down simform1000_flooded loop, tick for tick."""
    jf, jm, tf, tm = _roll_both(dict(SLICE, flood_block=flood_block))
    _assert_parity(jf, jm, tf, tm)
    assert int(tm.auctioned.sum()) == TICKS // SLICE["assign_every"]
    assert bool(tm.ca_active.any())          # avoidance really engaged


def test_slice_rollout_parity_on_designed_gains():
    """The slice flying gains each package designs itself, as the trial
    harness designs them on dispatch (`harness/trials.py:274-319,414-415`):
    ADMM in the n-4 bucket, scaled by the suite's gain_scale 0.15. The two
    designs agree to 1e-12; the rollouts at the file's tolerances."""
    jform, jsp, jcg, q0 = _problem()
    pts, adj = np.asarray(jform.points), np.asarray(jform.adjmat)
    jgain = np.asarray(jgains.solve_gains(pts, adj, max_nonedges=N - 4)) \
        * GAIN_SCALE
    tgain = tgains.solve_gains(pts, adj, max_nonedges=N - 4,
                               device="cpu") * GAIN_SCALE
    np.testing.assert_allclose(tgain.numpy(), jgain, rtol=0, atol=1e-12)
    tform = make_formation(pts, adj, tgain, device="cpu",
                           dtype=torch.float64)
    jf, jm, tf, tm = _roll_both(
        SLICE, problem=(jmake_formation(pts, adj, jgain), jsp, jcg, q0),
        tform=tform)
    _assert_parity(jf, jm, tf, tm)
    assert int(tm.auctioned.sum()) == TICKS // SLICE["assign_every"]


@pytest.mark.parametrize("dynamics", ["tracking", "firstorder", "doubleint"])
def test_truth_mode_rollout_parity(dynamics):
    jf, jm, tf, tm = _roll_both(dict(SLICE, localization="truth",
                                     dynamics=dynamics, flood_phases=1))
    _assert_parity(jf, jm, tf, tm)


def test_flight_fsm_rollout_parity():
    """Ground start, GO at tick 0, joystick override on two vehicles: the
    auction is gated until the whole fleet is FLYING."""
    rng = np.random.default_rng(5)
    cmd = np.zeros(TICKS, np.int32)
    cmd[0] = CMD_GO
    active = np.zeros((TICKS, N), bool)
    active[:, :2] = True
    inputs = dict(cmd=cmd, joy_vel=rng.normal(size=(TICKS, N, 3)) * 0.3,
                  joy_yawrate=rng.normal(size=(TICKS, N)) * 0.1,
                  joy_active=active)
    jf, jm, tf, tm = _roll_both(dict(SLICE, flight_fsm=True), ground=True,
                                inputs=inputs)
    _assert_parity(jf, jm, tf, tm)
    assert (tm.mode[0] == sim.vehicle.TAKEOFF).all()


def test_hold_mode_rollout_parity():
    jf, jm, tf, tm = _roll_both(dict(SLICE, assignment="none",
                                     flood_phases=1), ticks=12)
    _assert_parity(jf, jm, tf, tm)


def test_formgen_matches_reference():
    ref = jformgen.generate_group(30, seed=11, l=40.0, w=40.0, h=3.0,
                                  min_dist=3.0, k=2)
    assert formgen.generate_group(30, seed=11, l=40.0, w=40.0, h=3.0,
                                  min_dist=3.0, k=2) == ref


@pytest.mark.parametrize("cfg_kw,init_kw", [
    (dict(check_mode="on"), dict(checks=True)),
    (dict(telemetry="on"), dict(telemetry=True)),
    (dict(check_mode="on"), dict(checks=True, telemetry=True)),
    (dict(telemetry="on"), dict(checks=True, telemetry=True)),
], ids=["check_mode", "telemetry", "checks_carried", "telemetry_carried"])
def test_checked_and_counted_modes_run(cfg_kw, init_kw):
    """The modes and carries that used to raise: one auction tick each on
    the CPU (the default configuration on a six-vehicle ring). A clean
    tick records no violation and the counters count its auction; a carry
    the configuration does not use rides along untouched; a mode without
    its carry is refused."""
    n = 6
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3 * np.cos(ang), 3 * np.sin(ang), np.full(n, 2.0)], 1)
    cpu64 = dict(device="cpu", dtype=torch.float64)
    form = make_formation(pts, np.ones((n, n)) - np.eye(n),
                          np.eye(n)[:, :, None, None] * np.eye(3) * 0.01,
                          **cpu64)
    q0 = np.random.default_rng(1).normal(size=(n, 3)) * 2.0
    q0[:, 2] = 2.0
    from aclswarm_torch.core.types import ControlGains, SafetyParams
    args = (form, ControlGains(),
            SafetyParams(bounds_min=(-50.0, -50.0, 0.0),
                         bounds_max=(50.0, 50.0, 10.0)),
            sim.SimConfig(**cfg_kw))
    state = sim.init_state(q0, **cpu64, **init_kw)
    new, m = sim.step(state, *args)
    assert bool(m.auctioned) and sorted(new.v2f.tolist()) == list(range(n))
    if "check_mode" in cfg_kw:
        assert int(m.inv_code) == 0 and int(new.inv.tick) == -1
        assert m.tel is None
    else:
        assert m.inv_code is None
        assert int(m.tel.auctions) == 1 and int(new.tel.auctions) == 1
        assert int(m.tel.assign_rounds) > 0     # the auction LAP's rounds
    if "checks" in init_kw and "check_mode" not in cfg_kw:
        assert new.inv is state.inv
    if "telemetry" in init_kw and "telemetry" not in cfg_kw:
        assert new.tel is state.tel
    with pytest.raises(ValueError, match="checks=True|telemetry=True"):
        sim.step(sim.init_state(q0, **cpu64), *args)


@pytest.mark.parametrize("cfg_kw,init_kw", [
    (dict(), {}),                               # the default: 'auction'
    (dict(assignment="cbaa"), {}),
    (dict(assignment="cbaa", cbaa_task_block=3), dict(cbaa_warm=True)),
    (dict(), dict(faults=True)),
    (dict(), dict(scenario=True)),
], ids=["auction", "cbaa", "cbaa_warm", "faults", "scenarios"])
def test_ported_modes_run(cfg_kw, init_kw):
    """The modes that used to raise: one auction tick each on the CPU
    (the fault and scenario carries with their inert scripts)."""
    from aclswarm_torch import faults, scenarios

    jform, jsp, jcg, q0 = _problem()
    cpu64 = dict(device="cpu", dtype=torch.float64)
    init_kw = dict(init_kw)
    if init_kw.get("faults"):
        init_kw["faults"] = faults.no_faults(N, **cpu64)
    if init_kw.get("scenario"):
        init_kw["scenario"] = scenarios.no_scenario(N, **cpu64)
    state = sim.init_state(q0, **cpu64, **init_kw)
    new, m = sim.step(state, convert.formation_from_numpy(_np(jform), "cpu",
                                                          torch.float64),
                      convert.control_gains_from_numpy(_np(jcg)),
                      convert.safety_params_from_numpy(_np(jsp)),
                      sim.SimConfig(**cfg_kw))
    assert bool(m.auctioned) and new.tick == 1
    assert sorted(new.v2f.tolist()) == list(range(N))
    assert (new.cbaa_warm is not None) == ("cbaa_warm" in init_kw)


def test_flooded_needs_tables():
    jform, jsp, jcg, q0 = _problem()
    state = sim.init_state(q0, device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="flooded"):
        sim.step(state, convert.formation_from_numpy(_np(jform), "cpu",
                                                     torch.float64),
                 convert.control_gains_from_numpy(_np(jcg)),
                 convert.safety_params_from_numpy(_np(jsp)),
                 sim.SimConfig(localization="flooded", assignment="none"))


def test_state_roundtrip_through_numpy():
    _, _, _, q0 = _problem()
    st = sim.init_state(q0, localization=True, cbaa_warm=True, device="cpu",
                        dtype=torch.float64)
    back = convert.sim_state_from_numpy(convert.sim_state_to_numpy(st),
                                        "cpu", torch.float64)
    assert torch.equal(back.swarm.q, st.swarm.q) and back.tick == 0
    assert torch.equal(back.loc.age, st.loc.age)
    assert torch.equal(back.cbaa_warm.who, st.cbaa_warm.who)
    assert back.cbaa_warm.price.dtype == torch.float64
    assert (back.cbaa_warm.who == -1).all()


# --- the 'auction' and 'cbaa' assignment modes ------------------------------

N_AUC, ATOL_AUC = 16, 1e-9
AUCTION = dict(SLICE, assignment="auction", assign_eps=0.0)
CBAA = dict(SLICE, assignment="cbaa", assign_eps=0.0, cbaa_task_block=5)


def _small_problem(seed=5, n=N_AUC, ground=False):
    """`_problem` at n=16 on a 16 m box. Seed 4 meets the duplicate-sector
    coin flip at tick 17 here (with dense avoidance it agrees to 1e-15);
    seeds 5-8 keep clear of it over these 40 ticks."""
    group = formgen.generate_group(n, seed=seed, l=16.0, w=16.0, h=3.0,
                                   min_dist=3.0, k=1)
    pts = np.asarray(group["formations"][0]["points"])
    adj = np.asarray(group["adjmat"], float)
    rng = np.random.default_rng(seed)
    gains = rng.normal(size=(n, n, 3, 3)) * 0.01
    q0 = rng.uniform(-4.0, 4.0, size=(n, 3))
    q0[:, 2] = 0.0 if ground else rng.uniform(1.0, 3.0, n)
    _, jsp, jcg, _ = _problem()
    return jmake_formation(pts, adj, gains), jsp, jcg, q0


@pytest.mark.parametrize("localization", ["truth", "flooded"])
def test_auction_mode_rollout_parity(localization):
    """The engine's default assignment: global alignment + the auction LAP
    on exact distances; the centralized solver reads ground truth in both
    information models."""
    cfg = dict(AUCTION, localization=localization)
    jf, jm, tf, tm = _roll_both(cfg, problem=_small_problem())
    _assert_parity(jf, jm, tf, tm, ATOL_AUC)
    assert int(tm.auctioned.sum()) == 4 and bool(tm.assign_valid.all())
    assert bool(tm.reassigned[0])


def test_auction_mode_hysteresis_parity():
    jf, jm, tf, tm = _roll_both(dict(AUCTION, assign_eps=0.05,
                                     localization="truth", flood_phases=1),
                                problem=_small_problem(seed=6))
    _assert_parity(jf, jm, tf, tm, ATOL_AUC)


@pytest.mark.parametrize("cbaa_warm", [False, True])
@pytest.mark.parametrize("localization", ["truth", "flooded"])
def test_cbaa_mode_rollout_parity(localization, cbaa_warm):
    """The decentralized pipeline: per-agent alignment on the flooded
    estimates + consensus auction, with and without the warm tables."""
    cfg = dict(CBAA, localization=localization)
    jf, jm, tf, tm = _roll_both(cfg, cbaa_warm=cbaa_warm,
                                problem=_small_problem())
    _assert_parity(jf, jm, tf, tm, ATOL_AUC)
    assert int(tm.auctioned.sum()) == 4
    assert bool(tm.assign_valid.any())
    if cbaa_warm:
        assert bool((tf.cbaa_warm.who >= 0).any())    # tables were carried


def test_cbaa_mode_dense_and_hysteresis_parity():
    cfg = dict(CBAA, cbaa_task_block=None, assign_eps=0.05)
    jf, jm, tf, tm = _roll_both(cfg, cbaa_warm=True,
                                problem=_small_problem(seed=7))
    _assert_parity(jf, jm, tf, tm, ATOL_AUC)


@pytest.mark.parametrize("mode", [AUCTION, CBAA], ids=["auction", "cbaa"])
def test_flight_fsm_gates_the_auction(mode):
    """Ground start with GO at tick 0: auctions are discarded (v2f, the
    warm tables and first_auction untouched) until the whole fleet is
    FLYING."""
    ticks = 90          # spin-up + a 50-tick climb, then three auctions
    cmd = np.zeros(ticks, np.int32)
    cmd[0] = CMD_GO
    inputs = dict(cmd=cmd, joy_vel=np.zeros((ticks, N_AUC, 3)),
                  joy_yawrate=np.zeros((ticks, N_AUC)),
                  joy_active=np.zeros((ticks, N_AUC), bool))
    warm = mode["assignment"] == "cbaa"
    jf, jm, tf, tm = _roll_both(dict(mode, flight_fsm=True), ground=True,
                                inputs=inputs, cbaa_warm=warm, ticks=ticks,
                                problem=_small_problem(ground=True))
    _assert_parity(jf, jm, tf, tm, ATOL_AUC)
    assert not bool(tm.auctioned[0]) and bool(tm.auctioned.any())
    first = int(torch.nonzero(tm.auctioned)[0])
    assert first >= 50 and first % mode["assign_every"] == 0
    assert (tm.v2f[:first] == torch.arange(N_AUC)).all()


def _assign_both(cfg_kw, jform, q, v2f, warm=None, **kw):
    """`sim.engine.assign` through both packages from numpy inputs."""
    from aclswarm_tpu.assignment import cbaa as jcbaa
    from aclswarm_tpu.core.types import SwarmState as JSwarm
    from aclswarm_torch.assignment import cbaa
    from aclswarm_torch.core.types import SwarmState

    f64 = dict(device="cpu", dtype=torch.float64)
    jkw = {k: None if v is None else jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: None if v is None else torch.as_tensor(v)
           for k, v in kw.items()}
    if warm is not None:
        jkw["warm"] = jcbaa.CbaaTables(*map(jnp.asarray, warm))
        tkw["warm"] = cbaa.CbaaTables(
            torch.as_tensor(warm[0]), torch.as_tensor(warm[1]))
    ref = jsim.engine.assign(JSwarm(q=jnp.asarray(q), vel=jnp.zeros_like(q)),
                             jform, jnp.asarray(v2f),
                             jsim.SimConfig(**cfg_kw), **jkw)
    out = sim.assign(SwarmState(q=torch.as_tensor(q),
                                vel=torch.zeros(q.shape, dtype=torch.float64)),
                     convert.formation_from_numpy(_np(jform), **f64),
                     torch.as_tensor(v2f), sim.SimConfig(**cfg_kw), **tkw)
    return out, ref


def test_invalid_cbaa_auction_holds_assignment_and_tables():
    """No links at all: every agent hears only itself, consensus fails,
    and `assign` returns the current v2f and the OLD tables."""
    jform, _, _, q0 = _small_problem()
    jform = jform.replace(adjmat=jnp.zeros_like(jform.adjmat))
    rng = np.random.default_rng(1)
    v2f = rng.permutation(N_AUC).astype(np.int32)
    warm = (rng.random((N_AUC, N_AUC)),
            np.broadcast_to(rng.permutation(N_AUC).astype(np.int32),
                            (N_AUC, N_AUC)).copy())
    out, ref = _assign_both(CBAA, jform, q0, v2f, warm=warm)
    assert not bool(out[1]) and not bool(ref[1])
    np.testing.assert_array_equal(out[0].numpy(), v2f)
    np.testing.assert_array_equal(out[2].who.numpy(), warm[1])
    np.testing.assert_array_equal(out[2].price.numpy(), warm[0])
    np.testing.assert_array_equal(np.asarray(ref[2].who), warm[1])


@pytest.mark.parametrize("mode", ["auction", "sinkhorn", "cbaa"])
@pytest.mark.parametrize("dead", ["none", "some"])
def test_assign_alive_and_link_masks(mode, dead):
    """`alive` reaches every solver (pin/forbid costs, masked bids) and
    `link_mask` the CBAA graph; dead vehicles keep their points. `step`
    has no fault schedule yet, so the masks are exercised here."""
    jform, _, _, q0 = _small_problem(seed=6)
    rng = np.random.default_rng(3)
    v2f = rng.permutation(N_AUC).astype(np.int32)
    alive = np.ones(N_AUC, bool) if dead == "none" else rng.random(N_AUC) > .3
    link = (rng.random((N_AUC, N_AUC)) > 0.1) & alive[:, None] & alive[None]
    cfg = dict(SLICE, assignment=mode, assign_eps=0.02, cbaa_task_block=5)
    out, ref = _assign_both(cfg, jform, q0, v2f, alive=alive, link_mask=link,
                            first=np.asarray(True))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert bool(out[1]) == bool(ref[1])
    if bool(out[1]):
        np.testing.assert_array_equal(out[0].numpy()[~alive], v2f[~alive])
    if dead == "none" and mode != "cbaa":      # all alive == no mask
        plain, _ = _assign_both(cfg, jform, q0, v2f, first=np.asarray(True))
        assert torch.equal(plain[0], out[0])


def test_warm_tables_only_for_cbaa():
    jform, _, _, q0 = _small_problem()
    tables = (np.zeros((N_AUC, N_AUC)), np.full((N_AUC, N_AUC), -1, np.int32))
    with pytest.raises(ValueError, match="cbaa"):
        _assign_both(AUCTION, jform, q0, np.arange(N_AUC, dtype=np.int32),
                     warm=tables)


def test_default_config_on_the_shipped_formation():
    """The flagship: the default `SimConfig()` (assignment='auction',
    tracking dynamics, dense avoidance) on swarm6_3d "Pentagonal Pyramid"
    with its shipped gains — loaded by the reference's harness, carried
    across by `convert` — from the entry script's start, 240 ticks: two
    auctions. Dense avoidance has no pruned sectors, so no seed needs
    avoiding here."""
    from aclswarm_tpu import harness

    jform = harness.load_formation("Pentagonal Pyramid",
                                   group="swarm6_3d").to_device()
    jsp = JSafetyParams(bounds_min=jnp.asarray([-20.0, -20.0, 0.0]),
                        bounds_max=jnp.asarray([20.0, 20.0, 10.0]))
    q0 = np.random.default_rng(0).normal(size=(6, 3)) * 3.0 + [0, 0, 2.0]
    cfg = dict(assignment="auction")
    assert sim.SimConfig() == sim.SimConfig(**cfg)
    jf, jm, tf, tm = _roll_both(cfg, ticks=240,
                                problem=(jform, jsp, JControlGains(), q0))
    _assert_parity(jf, jm, tf, tm, ATOL_AUC)
    assert int(tm.auctioned.sum()) == 2 and bool(tm.assign_valid.all())
    assert sorted(tf.v2f.tolist()) == list(range(6))

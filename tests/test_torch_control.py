"""Port parity: `aclswarm_torch.control` and `sim.vehicle` vs the
reference, float64 on the CPU from the same seeded numpy inputs.
Tolerance atol 1e-10 on velocities and goals (same formulas in f64);
avoidance flags, neighbor picks and flight modes exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch import control
from aclswarm_torch.control import colavoid
from aclswarm_torch.core import types
from aclswarm_torch.sim import vehicle
from aclswarm_tpu import control as jcontrol
from aclswarm_tpu.control import colavoid as jcolavoid
from aclswarm_tpu.core import types as jtypes
from aclswarm_tpu.sim import vehicle as jvehicle

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ATOL = 1e-10
# the reference side jitted: its op-by-op eager dispatch dominates runtime
_j_colavoid = jax.jit(jcontrol.collision_avoidance,
                      static_argnames=("max_neighbors",))
_j_flight_step = jax.jit(jvehicle.flight_step, static_argnames=("dt",))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


def _params(**kw):
    """The same safety parameters on both sides."""
    bmin, bmax = kw.pop("bounds_min", (-5.0, -5.0, 0.0)), \
        kw.pop("bounds_max", (5.0, 5.0, 4.0))
    ref = jtypes.SafetyParams(bounds_min=jnp.asarray(bmin),
                              bounds_max=jnp.asarray(bmax), **kw)
    return types.SafetyParams(bounds_min=bmin, bounds_max=bmax, **kw), ref


def _problem(seed, n=10):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 3
    adj = (rng.random((n, n)) < 0.6).astype(float)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    gains = rng.normal(size=(n, n, 3, 3)) * 0.1
    q = rng.normal(size=(n, 3)) * 3
    vel = rng.normal(size=(n, 3))
    v2f = rng.permutation(n).astype(np.int32)
    rel = rng.normal(size=(n, n, 3)) * 3
    return pts, adj, gains, q, vel, v2f, rel


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_rel", [False, True])
def test_distcntrl_compute(seed, with_rel):
    pts, adj, gains, q, vel, v2f, rel = _problem(seed)
    cg = dict(K1_xy=0.2, e_xy_thr=0.5, kd=0.3)
    ref = jcontrol.compute(
        jtypes.SwarmState(q=jnp.asarray(q), vel=jnp.asarray(vel)),
        jtypes.make_formation(pts, adj, gains), jnp.asarray(v2f),
        jtypes.ControlGains(**cg), rel=jnp.asarray(rel) if with_rel else None)
    out = control.compute(
        types.SwarmState(q=_t(q), vel=_t(vel)),
        types.make_formation(pts, adj, gains, device="cpu",
                             dtype=torch.float64),
        _t(v2f, torch.int32), types.ControlGains(**cg),
        rel=_t(rel) if with_rel else None)
    _close(out, ref)


def test_scale_control():
    rng = np.random.default_rng(3)
    qij = rng.normal(size=(6, 6, 3)) * 2
    dxy, dz = rng.random((6, 6)) * 3, rng.random((6, 6))
    _close(control.scale_control(_t(qij), _t(dxy), _t(dz),
                                 types.ControlGains()),
           jcontrol.scale_control(jnp.asarray(qij), jnp.asarray(dxy),
                                  jnp.asarray(dz), jtypes.ControlGains()))


def test_wrap_to_pi_floor_mod():
    a = np.linspace(-20.0, 20.0, 401)
    _close(control.wrap_to_pi(_t(a)), jcontrol.wrap_to_pi(jnp.asarray(a)))


def test_saturate_and_rate_limit():
    sp, jsp = _params()
    v = np.random.default_rng(4).normal(size=(20, 3))
    _close(control.saturate_velocity(_t(v), sp),
           jcontrol.saturate_velocity(jnp.asarray(v), jsp))
    v0 = np.random.default_rng(5).normal(size=(20, 3))
    _close(control.rate_limit(0.01, -2.0, 3.0, _t(v0), _t(v)),
           jcontrol.rate_limit(0.01, -2.0, 3.0, jnp.asarray(v0),
                               jnp.asarray(v)))


def test_make_safe_traj_bounds_and_rates():
    """Goals outside and at the room's edge: clamped axes zero their
    velocity at the rate limit; out-of-room goals may move back in."""
    sp, jsp = _params()
    rng = np.random.default_rng(6)
    n = 16
    pos = rng.uniform(-6, 6, size=(n, 3))
    gv = rng.normal(size=(n, 3))
    vg = rng.normal(size=(n, 3)) * 3
    yaw, yr = rng.uniform(-3, 3, n), rng.normal(size=n)
    ref = jcontrol.make_safe_traj(
        0.01, jnp.asarray(vg), jnp.asarray(yr),
        jcontrol.TrajGoal(pos=jnp.asarray(pos), vel=jnp.asarray(gv),
                          yaw=jnp.asarray(yaw), dyaw=jnp.zeros(n)), jsp)
    out = control.make_safe_traj(
        0.01, _t(vg), _t(yr),
        control.TrajGoal(pos=_t(pos), vel=_t(gv), yaw=_t(yaw),
                         dyaw=torch.zeros(n, dtype=torch.float64)), sp)
    for k in ("pos", "vel", "yaw", "dyaw"):
        _close(getattr(out, k), getattr(ref, k))


def _colavoid_both(q, vel, k=None, mask=None, **kw):
    sp, jsp = _params(**kw)
    ref_v, ref_ca = _j_colavoid(
        jnp.asarray(q), jnp.asarray(vel), jsp, max_neighbors=k,
        neighbor_mask=None if mask is None else jnp.asarray(mask))
    v, ca = control.collision_avoidance(
        _t(q), _t(vel), sp, max_neighbors=k,
        neighbor_mask=None if mask is None else torch.as_tensor(mask))
    _close(v, ref_v)
    np.testing.assert_array_equal(ca.numpy(), np.asarray(ref_ca))
    return ca


@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_colavoid_random_crowd(k, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-2.5, 2.5, size=(18, 3))
    q[:, 2] = rng.uniform(0, 0.5, 18)
    vel = rng.normal(size=(18, 3))
    ca = _colavoid_both(q, vel, k)
    assert ca.any()          # the crowd is dense enough to trigger


@pytest.mark.parametrize("k", [None, 3])
def test_colavoid_grid_ties(k):
    """A unit grid: many neighbors at exactly equal distance, so the
    k-nearest pick rests on the lowest-index tie rule and symmetric
    head-on headings on the larger-edge rule."""
    g = np.arange(4, dtype=float)
    xx, yy = np.meshgrid(g, g)
    q = np.stack([xx.ravel(), yy.ravel(), np.zeros(16)], 1)
    vel = np.tile([[1.0, 0.0, 0.0]], (16, 1))
    vel[5] = [-1.0, 0.0, 0.0]
    vel[6] = [0.0, 1.0, 0.2]
    _colavoid_both(q, vel, k)


@pytest.mark.parametrize("k", [None, 4])
def test_colavoid_neighbor_mask(k):
    """Vehicles with a False bit cast no sector for anyone."""
    rng = np.random.default_rng(12)
    q = rng.uniform(-2.5, 2.5, size=(18, 3))
    q[:, 2] = 0.0
    vel = rng.normal(size=(18, 3))
    _colavoid_both(q, vel, k, mask=rng.random(18) < 0.6)


def test_smallest_k_indices_ties():
    d = np.array([[3.0, 1.0, 1.0, 0.5, np.inf, 1.0],
                  [np.inf] * 6,
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    np.testing.assert_array_equal(
        colavoid._smallest_k_indices(_t(d), 4).numpy(),
        np.asarray(jcolavoid._smallest_k_indices(jnp.asarray(d), 4)))


@pytest.mark.parametrize("k", [None, 4])
def test_colavoid_dz_ignore(k):
    rng = np.random.default_rng(9)
    q = rng.uniform(-2, 2, size=(14, 3))
    q[:, 2] = rng.uniform(0, 3, 14)
    vel = rng.normal(size=(14, 3))
    _colavoid_both(q, vel, k, colavoid_dz_ignore=0.8)


def test_colavoid_keepout_repulse():
    q = np.array([[0.0, 0.0, 1.0], [0.9, 0.1, 1.0], [-0.5, 0.8, 1.0],
                  [5.0, 5.0, 1.0]])
    vel = np.array([[1.0, 0.0, 0.1], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0],
                    [0.3, 0.3, 0.0]])
    ca = _colavoid_both(q, vel, None, keepout_repulse_vel=0.3)
    assert ca[:3].all() and not ca[3]


def test_colavoid_obstacles():
    """Scenario obstacles are ported (`tests/test_torch_scenarios.py`
    holds them against the reference): an active cylinder ahead turns the
    vehicle, an inactive one changes nothing."""
    sp, _ = _params()
    q = torch.tensor([[0.0, 0.0, 2.0], [9.0, 9.0, 2.0], [-9.0, 9.0, 2.0]],
                     dtype=torch.float64)
    vel = torch.tensor([[0.5, 0.0, 0.0]] * 3, dtype=torch.float64)
    obs = (torch.tensor([[1.4, 0.0, 2.0]], dtype=torch.float64),
           torch.tensor([1.2], dtype=torch.float64), torch.tensor([True]))
    v, ca = control.collision_avoidance(q, vel, sp, obstacles=obs)
    assert ca.tolist() == [True, False, False]
    off = (obs[0], obs[1], torch.tensor([False]))
    v0, ca0 = control.collision_avoidance(q, vel, sp)
    v1, ca1 = control.collision_avoidance(q, vel, sp, obstacles=off)
    assert torch.equal(v0, v1) and torch.equal(ca0, ca1)


def test_hover_at_and_init_flight_dtype_device():
    g = control.TrajGoal.hover_at(np.zeros((4, 3)), device="cpu",
                                  dtype=torch.float64)
    assert g.pos.dtype == torch.float64 and g.yaw.shape == (4,)
    fs = vehicle.init_flight(4, "cpu", torch.float64, flying=False)
    assert fs.mode.dtype == torch.int32
    assert (fs.mode == vehicle.NOT_FLYING).all()


@pytest.mark.parametrize("takeoff_rel", [True, False])
def test_vehicle_fsm_sequence(takeoff_rel):
    """Ground -> GO -> spin-up -> ramp -> FLYING -> LAND -> ramp down ->
    NOT_FLYING, with a KILL on one vehicle's neighbourhood mid-way: the
    FSM and its goals stepped in both packages on the same inputs."""
    sp, jsp = _params(spinup_time=0.05, takeoff_inc=0.05, takeoff_alt=0.6,
                      takeoff_rel=takeoff_rel, landing_fast_dec=0.05,
                      landing_slow_dec=0.02)
    n, dt = 5, 0.01
    rng = np.random.default_rng(10)
    q = rng.uniform(-1, 1, size=(n, 3))
    q[:, 2] = rng.uniform(0.0, 0.05, n)
    fs = vehicle.init_flight(n, "cpu", torch.float64, flying=False)
    jfs = jvehicle.init_flight(n, jnp.float64, flying=False)
    goal = control.TrajGoal.hover_at(q, device="cpu", dtype=torch.float64)
    jgoal = jcontrol.TrajGoal.hover_at(jnp.asarray(q))
    cmds = [vehicle.CMD_GO] + [0] * 40 + [vehicle.CMD_LAND] + [0] * 40 \
        + [vehicle.CMD_KILL, 0, 0]
    for cmd in cmds:
        fs = vehicle.apply_command(fs, torch.tensor(cmd, dtype=torch.int32))
        jfs = jvehicle.apply_command(jfs, jnp.asarray(cmd, jnp.int32))
        safe = control.TrajGoal(pos=goal.pos + 0.001, vel=goal.vel,
                                yaw=goal.yaw, dyaw=goal.dyaw)
        jsafe = jcontrol.TrajGoal(pos=jgoal.pos + 0.001, vel=jgoal.vel,
                                  yaw=jgoal.yaw, dyaw=jgoal.dyaw)
        fs, goal = vehicle.flight_step(fs, goal, safe, _t(q), sp, dt)
        jfs, jgoal = _j_flight_step(jfs, jgoal, jsafe, jnp.asarray(q),
                                    jsp, dt=dt)
        # the vehicle tracks its goal exactly (tracking dynamics)
        q = np.asarray(jgoal.pos)
        np.testing.assert_array_equal(fs.mode.numpy(), np.asarray(jfs.mode))
        np.testing.assert_array_equal(fs.ticks_in_mode.numpy(),
                                      np.asarray(jfs.ticks_in_mode))
        for k in ("pos", "vel", "yaw", "dyaw"):
            _close(getattr(goal, k), getattr(jgoal, k))
        _close(fs.takeoff_alt, jfs.takeoff_alt)
    assert (fs.mode == vehicle.NOT_FLYING).all()


def test_mux_goals():
    rng = np.random.default_rng(11)
    n = 6
    dist = rng.normal(size=(n, 3))
    inp = dict(joy_vel=rng.normal(size=(n, 3)),
               joy_yawrate=rng.normal(size=n),
               joy_active=rng.random(n) < 0.5)
    jv, jy = jvehicle.mux_goals(jnp.asarray(dist), jvehicle.ExternalInputs(
        cmd=jnp.asarray(0, jnp.int32),
        **{k: jnp.asarray(v) for k, v in inp.items()}))
    v, y = vehicle.mux_goals(_t(dist), vehicle.ExternalInputs(
        cmd=torch.tensor(0, dtype=torch.int32), joy_vel=_t(inp["joy_vel"]),
        joy_yawrate=_t(inp["joy_yawrate"]),
        joy_active=torch.as_tensor(inp["joy_active"])))
    _close(v, jv, 0)
    _close(y, jy, 0)


def test_colavoid_duplicate_sector_coin_flip():
    """A known divergence (ROADMAP.md, "Faults in the port"). With
    k-pruning, an agent with fewer than k vehicles in range is padded with
    repeats of column 0; when vehicle 0 is itself in range its sector is
    cast more than once. The own-sector exclusion does not cover the
    copies, so whether an edge of that sector counts as free is decided
    by |wrap((θ+α) − θ)| < α — a coin flip on the last bit of atan2 and
    asin, where the reference's and the port's math libraries differ.
    Here agent 1 (vehicle 0 in range, k=2) flips; the dense form agrees."""
    q = np.array([[0.0, 0.0, 0.0],
                  [-0.5095769431662982, -1.3712754635044868, 0.0],
                  [-1.2913094264175522, 1.422425411774485, 0.0],
                  [1.053540881150978, 0.14653748851438753, 0.0]])
    vel = np.array([[1.1801655972128011, 1.7434452131360432, -0.1768720355],
                    [0.9477546410453541, 0.5356290991845476, 0.2378042679],
                    [0.8112861168240963, 0.3021869291446567, 1.7980520073],
                    [0.7056896051316012, -0.4824733156440579, 0.8190838006]])
    sp, jsp = _params()
    _colavoid_both(q, vel, None)
    ref_v, _ = _j_colavoid(jnp.asarray(q), jnp.asarray(vel), jsp,
                           max_neighbors=2)
    v, _ = control.collision_avoidance(_t(q), _t(vel), sp, max_neighbors=2)
    differs = np.abs(v.numpy() - np.asarray(ref_v)).max(axis=1) > 1e-6
    assert differs.tolist() == [False, True, False, False]


@pytest.mark.parametrize("cover_elems", [1, 2 * 18 * 18 * 5])
def test_colavoid_row_blocks_are_exact(monkeypatch, cover_elems):
    """The dense sector test runs in row blocks past `COVER_ELEMS`
    (one row, then five rows a block here): the same bits as one block,
    and the reference's result."""
    from aclswarm_torch.control import colavoid as tcolavoid

    rng = np.random.default_rng(7)
    q = rng.uniform(-2.5, 2.5, size=(18, 3))
    q[:, 2] = rng.uniform(0, 0.5, 18)
    vel = rng.normal(size=(18, 3))
    sp, _ = _params()
    whole = control.collision_avoidance(_t(q), _t(vel), sp)
    monkeypatch.setattr(tcolavoid, "COVER_ELEMS", cover_elems)
    blocked = control.collision_avoidance(_t(q), _t(vel), sp)
    assert torch.equal(whole[0], blocked[0])
    assert torch.equal(whole[1], blocked[1])
    assert _colavoid_both(q, vel).any()

"""The supervisor's post-hoc oracle (`aclswarm_torch.harness.evaluate` and
its parts) and the resilience helpers `crash.active_plan(s)` and
`checkpoint.zlib_crc`, against the reference's, on the CPU.

- Seeded recordings, one per verdict the oracle reaches: converged;
  gridlock entered and left; gridlock terminated after 90 s; the 600 s
  watchdog; a recording shorter than the 1 s window (NaN rolling means);
  recordings that end inside the IN_FORMATION dwell and inside a gridlock
  episode. The same numpy inputs go through `rolling_mean`,
  `distance_traveled`, `run_fsm`, `evaluate` and `csv_row` of both
  packages, and through the port's `evaluate` as tensors.
- One `swarm6_3d` "Pentagonal Pyramid" rollout (n=6, doubleint, seed 1,
  600 ticks) in float64, the port's and the reference's, each judged by
  its own `evaluate`.
- `active_plan`/`active_plans` as `tests/test_resilience.py` drives the
  reference's, and `zlib_crc` on the same bytes.

Tolerances: booleans, ticks and counts exact; floats within 1e-12.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aclswarm_torch import harness, sim
from aclswarm_torch.core.types import ControlGains, SafetyParams
from aclswarm_torch.harness import formations as tformations
from aclswarm_torch.harness import supervisor as tsup
from aclswarm_torch.resilience import checkpoint as tckpt
from aclswarm_torch.resilience import crash as tcrash
from aclswarm_tpu import harness as jharness
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.harness import supervisor as jsup
from aclswarm_tpu.resilience import checkpoint as jckpt

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ATOL = 1e-12
N = 5


def _recording(case: str):
    """(distcmd_norm (T, n), ca_active (T, n) bool, q (T, n, 3),
    reassigned (T,) bool, assign_valid (T,) bool, dt) of one case, drawn
    from its own seed, and the verdict it is built to reach."""
    seed, dt, T = {"converged": (1, 0.01, 700),
                   "gridlock_entered": (2, 0.01, 1400),
                   "gridlock_terminated": (3, 0.1, 1100),
                   "watchdog": (4, 0.5, 1300),
                   "short": (5, 0.01, 40),
                   "ends_in_dwell": (6, 0.01, 250),
                   "ends_in_gridlock": (7, 0.01, 400)}[case]
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    noise = np.abs(rng.normal(scale=0.05, size=(T, N)))
    ca = rng.random((T, N)) < 0.05
    if case == "converged":
        dn = 2.5 * np.exp(-t / 80.0) + noise
    elif case == "gridlock_entered":
        dn = np.where(t < 700, 2.0, 0.1) + noise
        ca[100:450, 0] = True
    elif case in ("gridlock_terminated", "ends_in_gridlock"):
        dn = 2.0 + noise
        ca[:, 2] = True
    elif case == "watchdog":
        dn = 3.0 + noise
        ca[:] = False
    else:                               # short, ends_in_dwell: calm
        dn = 0.2 + noise
    q = np.cumsum(rng.normal(scale=0.02, size=(T, N, 3)), axis=0) \
        + rng.normal(scale=3.0, size=(1, N, 3))
    reassigned = rng.random(T) < 0.02
    valid = rng.random(T) > 0.03
    return (dn, ca, q, reassigned, valid, dt), case


CASES = ["converged", "gridlock_entered", "gridlock_terminated",
         "watchdog", "short", "ends_in_dwell", "ends_in_gridlock"]
# (converged, entered gridlock, terminated, timed out) each case reaches
VERDICTS = {"converged": (True, False, False, False),
            "gridlock_entered": (True, True, False, False),
            "gridlock_terminated": (False, True, True, False),
            "watchdog": (False, False, False, True),
            "short": (False, False, False, False),
            "ends_in_dwell": (False, False, False, False),
            "ends_in_gridlock": (False, True, False, False)}


def _close(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def _same_result(got, want):
    for k in ("converged", "gridlocked", "gridlock_terminated", "timed_out",
              "n_reassignments", "invalid_auctions"):
        assert getattr(got, k) == getattr(want, k), k
        assert type(getattr(got, k)) is type(getattr(want, k)), k
    for k in ("convergence_time_s", "last_gridlock_episode_s",
              "time_in_avoidance_s", "dist_traveled_m"):
        _close(getattr(got, k), getattr(want, k))


def _same_row(got: list, want: list):
    assert len(got) == len(want)
    assert got[0] == want[0] and got[-1] == want[-1]
    np.testing.assert_allclose(np.asarray(got[1:-1], float),
                               np.asarray(want[1:-1], float), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_rolling_mean_matches_reference(case):
    (dn, ca, *_, dt), _ = _recording(case)
    window = max(1, int(round(tsup.BUFFER_SECONDS / dt)))
    for x in (dn, ca.astype(float)):
        got = tsup.rolling_mean(x, window)
        want = jsup.rolling_mean(x, window)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if case == "short":
        assert np.isnan(got).all()


@pytest.mark.parametrize("case", CASES)
def test_distance_traveled_matches_reference(case):
    (_, _, q, *_), _ = _recording(case)
    for alpha in (tsup.EWMA_ALPHA, 0.5):
        np.testing.assert_allclose(tsup.distance_traveled(q, alpha),
                                   jsup.distance_traveled(q, alpha),
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_run_fsm_matches_reference(case):
    (dn, ca, _, _, _, dt), _ = _recording(case)
    got = tsup.run_fsm(dn, ca, dt)
    want = jsup.run_fsm(dn, ca, dt)
    conv, conv_t, entered, term, timed, last, stop = got
    assert (conv, entered, term, timed) == VERDICTS[case]
    assert (conv, entered, term, timed, stop) \
        == (want[0], want[2], want[3], want[4], want[6])
    _close(conv_t, want[1])
    _close(last, want[5])
    if case in ("converged", "gridlock_terminated", "watchdog"):
        assert stop < len(dn) - 1          # logging stopped before the end
    if case == "ends_in_gridlock":
        assert last > 0.0                  # the open episode was closed


@pytest.mark.parametrize("case", CASES)
def test_evaluate_and_csv_row_match_reference(case):
    (dn, ca, q, re, valid, dt), _ = _recording(case)
    got = harness.evaluate(dn, ca, q, re, valid, dt)
    want = jsup.evaluate(dn, ca, q, re, valid, dt)
    assert isinstance(got, harness.TrialResult)
    _same_result(got, want)
    _same_row(got.csv_row(7), want.csv_row(7))


@pytest.mark.parametrize("case", CASES)
def test_evaluate_takes_tensors(case):
    (dn, ca, q, re, valid, dt), _ = _recording(case)
    as_numpy = tsup.evaluate(dn, ca, q, re, valid, dt)
    as_tensors = tsup.evaluate(*(torch.as_tensor(x)
                                 for x in (dn, ca, q, re, valid)), dt)
    _same_result(as_tensors, as_numpy)


def test_harness_exports_the_references_names():
    for name in ("TrialResult", "TrialFSM", "TrialState", "evaluate"):
        assert name in harness.__all__ and name in jharness.__all__
        assert getattr(harness, name) is getattr(tsup, name)
    for name in ("formations", "formgen", "supervisor"):
        assert name in harness.__all__


def test_swarm6_3d_rollout_oracle_matches_reference():
    """One rollout in each package from the same start, each judged by its
    own oracle: the verdict and every figure equal."""
    rng = np.random.default_rng(1)
    ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    q0 = np.stack([6 * np.cos(ang), 6 * np.sin(ang), np.full(6, 1.5)], 1) \
        + rng.normal(scale=0.3, size=(6, 3)) * [1, 1, 0.1]
    room = dict(max_vel_xy=2.0, max_vel_z=1.0, max_accel_xy=2.0,
                max_accel_z=2.0, d_avoid_thresh=1.2, r_keep_out=0.45)
    ticks, cfg = 600, dict(dynamics="doubleint")

    jspec = jharness.load_formation("Pentagonal Pyramid", group="swarm6_3d")
    _, jm = jsim.rollout(
        jsim.init_state(jnp.asarray(q0)), jspec.to_device(), JControlGains(),
        JSafetyParams(bounds_min=jnp.asarray([-20.0, -20.0, 0.0]),
                      bounds_max=jnp.asarray([20.0, 20.0, 10.0]), **room),
        jsim.SimConfig(**cfg), ticks)
    want = jsup.evaluate(np.asarray(jm.distcmd_norm),
                         np.asarray(jm.ca_active), np.asarray(jm.q),
                         np.asarray(jm.reassigned),
                         np.asarray(jm.assign_valid), 0.01)

    tspec = tformations.load_formation("Pentagonal Pyramid",
                                       group="swarm6_3d")
    f64 = dict(device="cpu", dtype=torch.float64)
    _, m = sim.rollout(
        sim.init_state(q0, **f64), tspec.to_device(**f64), ControlGains(),
        SafetyParams(bounds_min=(-20.0, -20.0, 0.0),
                     bounds_max=(20.0, 20.0, 10.0), **room),
        sim.SimConfig(**cfg), ticks)
    got = harness.evaluate(m.distcmd_norm, m.ca_active, m.q, m.reassigned,
                           m.assign_valid, sim.SimConfig(**cfg).control_dt)
    assert want.converged and want.convergence_time_s < ticks * 0.01
    _same_result(got, want)
    _same_row(got.csv_row(0), want.csv_row(0))


# ----------------------------------------------- crash and checkpoint helpers

@pytest.fixture
def disarmed(monkeypatch):
    monkeypatch.delenv(tcrash.ENV_VAR, raising=False)
    tcrash.arm(None)
    yield
    tcrash.arm(None)


def test_active_plans_track_one_shot_consumption(disarmed):
    plans = tcrash.CrashPlan.decode_many("serve.w0:2:raise,serve.w1:5")
    tcrash.arm_many(plans)
    assert tcrash.active_plans() == plans
    assert tcrash.active_plan() == plans[0]
    with pytest.raises(tcrash.InjectedCrash):
        tcrash.maybe_crash("serve.w0", 2)
    assert tcrash.active_plans() == [plans[1]]
    with pytest.raises(tcrash.InjectedCrash):
        tcrash.maybe_crash("serve.w1", 5)
    assert tcrash.active_plans() == [] and tcrash.active_plan() is None


def test_single_plan_api(disarmed):
    tcrash.arm(tcrash.CrashPlan("t", 1))
    assert tcrash.active_plan() == tcrash.CrashPlan("t", 1)
    assert tcrash.active_plans() == [tcrash.CrashPlan("t", 1)]
    tcrash.arm(None)
    assert tcrash.active_plan() is None


def test_active_plans_read_the_environment(disarmed, monkeypatch):
    monkeypatch.setenv(tcrash.ENV_VAR, "a:1:raise,b:2:kill")
    assert tcrash.active_plans() == [tcrash.CrashPlan("a", 1, "raise"),
                                     tcrash.CrashPlan("b", 2, "kill")]
    assert tcrash.active_plan() == tcrash.CrashPlan("a", 1, "raise")
    # an in-process plan takes precedence over the environment's
    tcrash.arm(tcrash.CrashPlan("c", 3))
    assert tcrash.active_plans() == [tcrash.CrashPlan("c", 3)]
    tcrash.arm(None)
    with pytest.raises(tcrash.InjectedCrash):
        tcrash.maybe_crash("a", 1)
    assert tcrash.active_plans() == [tcrash.CrashPlan("b", 2, "kill")]


@pytest.mark.parametrize("data", [b"", b"aclswarm", bytes(range(256)) * 9,
                                  np.random.default_rng(0).bytes(4097)])
def test_zlib_crc_matches_reference(data):
    got = tckpt.zlib_crc(data)
    assert got == jckpt.zlib_crc(data) == zlib.crc32(data) & 0xFFFFFFFF
    assert 0 <= got < 2 ** 32


def test_frame_header_carries_the_body_crc():
    frame = tckpt.dumps({"x": np.arange(4.0)}, {"kind": "test"})
    *_, crc = tckpt._HDR.unpack_from(frame, 0)
    assert crc == tckpt.zlib_crc(frame[tckpt._HDR.size:])

"""The reference's scale rows (`benchmarks/scale.py` `bench_all`) at a
small size: the reference's `sim.rollout` against the port's, float64 on
the CPU, from one seeded numpy problem in the reference's draw order
(`chip_smoke.scale_arrays`, the copy the card's `scale` phase rolls at
n=2000, held equal to the reference's `build_bench_problem` here).

n=130 is past both of the problem's size switches: k=16 avoidance
(n > 64) and flood blocks of 64 (n > 128). Each engine row of
`chip_smoke.SCALE_ROWS` rolls 6 ticks. Tolerances as
`tests/test_torch_engine.py`'s: assignment, flight modes and ages exact;
positions, velocities, estimates and |distcmd| atol 1e-8. Beside them
`sinkhorn_assign(n_iters=50)` (the row `sinkhorn_throughput` times) on the
reference's instance, assignment exact; and `bench_all`'s two CBAA rows,
`cbaa_from_state` on its chained instances from the identity assignment
with the early exit and with the fixed 2n-round budget, each against the
reference's (assignment, `who`, rounds and validity exact, prices at
1e-12 relative as `tests/test_torch_cbaa.py` holds `cbaa_from_state`),
the two budgets' tables equal bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from aclswarm_torch import convert, sim
from aclswarm_torch.assignment import cbaa, sinkhorn
from aclswarm_tpu import sim as jsim
from aclswarm_tpu.assignment import cbaa as jcbaa
from aclswarm_tpu.assignment import sinkhorn as jsinkhorn
from aclswarm_tpu.core.types import ControlGains as JControlGains
from aclswarm_tpu.core.types import SafetyParams as JSafetyParams
from aclswarm_tpu.core.types import make_formation as jmake_formation
from benchmarks import scale as jscale

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

N, TICKS, ATOL = 130, 6, 1e-8
F64 = dict(device="cpu", dtype=torch.float64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def arrays():
    return chip_smoke.scale_arrays(N, np.random.default_rng(0))


def test_problem_is_the_references(arrays):
    rng = np.random.default_rng(0)
    f, sp, st, k_ca, block = jscale.build_bench_problem(N, rng)
    np.testing.assert_array_equal(arrays["points"], np.asarray(f.points))
    np.testing.assert_array_equal(arrays["adjmat"], np.asarray(f.adjmat))
    np.testing.assert_array_equal(arrays["gains"], np.asarray(f.gains))
    np.testing.assert_array_equal(arrays["q0"], np.asarray(st.swarm.q))
    # `bench_all` draws the flooded rows' start next
    np.testing.assert_array_equal(
        arrays["q_loc"],
        rng.normal(size=(N, 3)).astype(np.float32) * 20 + [0, 0, 2])
    assert (tuple(np.asarray(sp.bounds_min)),
            tuple(np.asarray(sp.bounds_max))) == chip_smoke.SCALE_BOUNDS
    for cfg_kw, *_ in chip_smoke.SCALE_ROWS.values():
        assert cfg_kw["colavoid_neighbors"] == k_ca
        assert cfg_kw.get("flood_block", block) == block
    p, qs = chip_smoke.scale_instances(N, 3)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        p, rng.normal(size=(N, 3)).astype(np.float32) * 20)
    np.testing.assert_array_equal(
        qs, rng.normal(size=(3, N, 3)).astype(np.float32) * 20)


@pytest.mark.parametrize("row", list(chip_smoke.SCALE_ROWS))
def test_scale_row_matches_reference(arrays, row):
    cfg_kw, _, _, _, flooded = chip_smoke.SCALE_ROWS[row]
    q0 = arrays["q_loc"] if flooded else arrays["q0"]
    jform = jmake_formation(*(np.asarray(arrays[k], np.float64)
                              for k in ("points", "adjmat", "gains")))
    jsp = JSafetyParams(bounds_min=jnp.asarray(chip_smoke.SCALE_BOUNDS[0]),
                        bounds_max=jnp.asarray(chip_smoke.SCALE_BOUNDS[1]))
    jst = jsim.init_state(jnp.asarray(q0, jnp.float64), localization=flooded)
    jf, jm = jsim.rollout(jst, jform, JControlGains(), jsp,
                          jsim.SimConfig(**cfg_kw), TICKS)
    tf, tm = sim.rollout(convert.sim_state_from_numpy(_np(jst), **F64),
                         convert.formation_from_numpy(_np(jform), **F64),
                         convert.control_gains_from_numpy(
                             _np(JControlGains())),
                         convert.safety_params_from_numpy(_np(jsp)),
                         sim.SimConfig(**cfg_kw), TICKS)
    out, ref = convert.sim_state_to_numpy(tf), _np(jf)
    for k in ("q", "vel"):
        np.testing.assert_allclose(out["swarm"][k], getattr(ref.swarm, k),
                                   rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(out["v2f"], ref.v2f)
    np.testing.assert_array_equal(out["flight"]["mode"], ref.flight.mode)
    if flooded:
        np.testing.assert_array_equal(out["loc"]["age"], ref.loc.age)
        np.testing.assert_allclose(out["loc"]["est"], ref.loc.est, rtol=0,
                                   atol=ATOL)
    for k in ("v2f", "mode", "ca_active", "auctioned", "assign_valid"):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k in ("q", "distcmd_norm"):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=ATOL, err_msg=k)
    if cfg_kw["assignment"] == "sinkhorn":
        assert int(tm.auctioned.sum()) == TICKS      # every tick


def test_sinkhorn_assign_matches_reference():
    p, qs = chip_smoke.scale_instances(N, 1)
    iters = chip_smoke.SCALE_SINKHORN_ITERS
    ref = jsinkhorn.sinkhorn_assign(jnp.asarray(qs[0], jnp.float64),
                                    jnp.asarray(p, jnp.float64),
                                    n_iters=iters)
    got = sinkhorn.sinkhorn_assign(torch.as_tensor(qs[0], **F64),
                                   torch.as_tensor(p, **F64), n_iters=iters)
    np.testing.assert_array_equal(got.row_to_col.numpy(),
                                  np.asarray(ref.row_to_col))
    np.testing.assert_allclose(got.plan_log.numpy(),
                               np.asarray(ref.plan_log), rtol=0, atol=1e-9)


def test_cbaa_instances_are_the_references(arrays):
    """`bench_all` draws its CBAA rows' instances right after the flooded
    start, Kc = 8 of them (2 under --quick, the same first two)."""
    rng = np.random.default_rng(0)
    jscale.build_bench_problem(N, rng)
    rng.normal(size=(N, 3))                          # the flooded start
    want = rng.normal(size=(8, N, 3)).astype(np.float32) * 20
    assert chip_smoke.SCALE_CBAA_CHAIN == 8
    np.testing.assert_array_equal(arrays["cbaa_q"], want)
    _, _, _, _, block = jscale.build_bench_problem(
        N, np.random.default_rng(0))
    assert chip_smoke.SCALE_CBAA_BLOCK == block


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("instance", [0, 1])
def test_cbaa_row_matches_reference(arrays, instance, early_exit):
    q = arrays["cbaa_q"][instance]
    args = (q, arrays["points"], arrays["adjmat"],
            np.arange(N, dtype=np.int32))
    block = chip_smoke.SCALE_CBAA_BLOCK
    ref = jcbaa.cbaa_from_state(
        *(jnp.asarray(a, jnp.int32 if a.dtype == np.int32 else jnp.float64)
          for a in args), task_block=block, early_exit=early_exit)
    got = cbaa.cbaa_from_state(
        *(torch.as_tensor(a) if a.dtype == np.int32
          else torch.as_tensor(a, **F64) for a in args),
        task_block=block, early_exit=early_exit)
    for k in ("v2f", "f2v", "who", "rounds", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.price.numpy(), np.asarray(ref.price),
                               rtol=1e-12, atol=0)
    assert bool(got.valid)
    if not early_exit:
        assert int(got.rounds) == 2 * N
        fast = cbaa.cbaa_from_state(
            *(torch.as_tensor(a) if a.dtype == np.int32
              else torch.as_tensor(a, **F64) for a in args),
            task_block=block)
        assert int(fast.rounds) < 2 * N
        for k in ("v2f", "f2v", "price", "who"):
            assert torch.equal(getattr(fast, k), getattr(got, k)), k

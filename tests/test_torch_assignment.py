"""Port parity: `aclswarm_torch.assignment.sinkhorn` vs the reference's
XLA path, float64 on the CPU from the same seeded numpy inputs.

Tolerances: log plans atol 1e-10 (200 f64 iterations of the same
recurrence differ by ~1e-14); permutations exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch.assignment import sinkhorn
from aclswarm_tpu.assignment import sinkhorn as jsinkhorn
from aclswarm_tpu.faults import masking

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

ATOL = 1e-10
_j_assign = jax.jit(jsinkhorn.sinkhorn_assign,
                    static_argnames=("rounding", "refine_sweeps", "n_iters"))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-10, 10, size=(n, 3))
    p = rng.uniform(-10, 10, size=(n, 3))
    return q, p


def _cost(n, seed):
    q, p = _points(n, seed)
    c = np.linalg.norm(q[:, None] - p[None], axis=-1)
    return c / c.mean()


@pytest.mark.parametrize("n", [16, 64])
def test_sinkhorn_log(n):
    c = _cost(n, n)
    ref = np.asarray(jax.jit(jsinkhorn.sinkhorn_log)(jnp.asarray(c)))
    out = sinkhorn.sinkhorn_log(_t(c))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_sinkhorn_log_impl_names():
    with pytest.raises(ValueError, match="impl"):
        sinkhorn.sinkhorn_log(torch.zeros(4, 4), impl="xla")


@pytest.mark.parametrize("n", [16, 64])
def test_marginal_errors(n):
    plan = sinkhorn.sinkhorn_log(_t(_cost(n, 1)), n_iters=30)
    r, c = sinkhorn.marginal_errors(plan)
    jr, jc = jsinkhorn.marginal_errors(jnp.asarray(plan.numpy()))
    np.testing.assert_allclose([float(r), float(c)],
                               [float(jr), float(jc)], rtol=0, atol=ATOL)


@pytest.mark.parametrize("rounding", ["dominant", "parallel", "greedy"])
@pytest.mark.parametrize("n", [16, 64])
def test_roundings(rounding, n):
    plan = sinkhorn.sinkhorn_log(_t(_cost(n, 2)), tau=0.1, n_iters=20)
    fn = {"dominant": (sinkhorn.round_dominant, jsinkhorn.round_dominant),
          "parallel": (sinkhorn.round_parallel, jsinkhorn.round_parallel),
          "greedy": (sinkhorn.round_to_permutation,
                     jsinkhorn.round_to_permutation)}[rounding]
    out = fn[0](plan)
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(fn[1](jnp.asarray(plan.numpy()))))
    assert sorted(out.tolist()) == list(range(n))


@pytest.mark.parametrize("sweeps", [1, 12, 40])
def test_two_opt_refine(sweeps):
    """Every sweep runs in the port; the reference stops at the first idle
    one — identical permutations either way."""
    n = 64
    c = _cost(n, 3)
    v2f = np.random.default_rng(3).permutation(n).astype(np.int32)
    ref = np.asarray(jsinkhorn.two_opt_refine(jnp.asarray(c),
                                              jnp.asarray(v2f), sweeps))
    out = sinkhorn.two_opt_refine(_t(c), _t(v2f, torch.int32), sweeps)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [16, 64])
def test_sinkhorn_assign(masked, n):
    q, p = _points(n, 10 + n)
    kw = {}
    if masked:
        rng = np.random.default_rng(n)
        alive = rng.random(n) > 0.25
        v2f = rng.permutation(n).astype(np.int32)
        pin, forbid = masking.pin_forbid(jnp.asarray(alive), jnp.asarray(v2f))
        kw = dict(pin=np.array(pin), forbid=np.array(forbid))
    ref = _j_assign(jnp.asarray(q), jnp.asarray(p),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    out = sinkhorn.sinkhorn_assign(_t(q), _t(p),
                                   **{k: torch.as_tensor(v)
                                      for k, v in kw.items()})
    np.testing.assert_array_equal(out.row_to_col.numpy(),
                                  np.asarray(ref.row_to_col))
    np.testing.assert_allclose(out.plan_log.numpy(), np.asarray(ref.plan_log),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(out.err), float(ref.err), rtol=0,
                               atol=ATOL)
    if masked:
        pinned = kw["pin"].any(1)      # dead vehicles keep their points
        np.testing.assert_array_equal(
            out.row_to_col.numpy()[pinned], kw["pin"].argmax(1)[pinned])


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_assign_staged_matches_reference(masked):
    """``stage_shardings`` on a one-rank mesh (the row-sharded iteration
    and the replicated rounding of `parallel`; two ranks are
    `tests/test_torch_parallel.py`'s): the reference's decisions, its
    plan at ATOL."""
    from aclswarm_torch.parallel import mesh as tmesh
    n = 48
    q, p = _points(n, 21)
    kw = {}
    if masked:
        alive = np.ones(n, bool)
        alive[::5] = False
        pin, forbid = masking.pin_forbid(jnp.asarray(alive),
                                         jnp.arange(n, dtype=jnp.int32))
        kw = dict(pin=np.array(pin), forbid=np.array(forbid))
    ref = _j_assign(jnp.asarray(q), jnp.asarray(p),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    mesh = tmesh.make_mesh(device="cpu")
    out = sinkhorn.sinkhorn_assign(
        _t(q), _t(p), stage_shardings=(tmesh.row_sharding(mesh),
                                       tmesh.replicated(mesh)),
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(out.row_to_col.numpy(),
                                  np.asarray(ref.row_to_col))
    np.testing.assert_allclose(out.plan_log.numpy(), np.asarray(ref.plan_log),
                               rtol=0, atol=ATOL)


def test_sinkhorn_assign_argument_rules():
    q = torch.zeros(4, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="together"):
        sinkhorn.sinkhorn_assign(q, q, pin=torch.zeros(4, 4, dtype=bool))
    with pytest.raises(ValueError, match="stage_shardings"):
        sinkhorn.sinkhorn_assign(q, q, stage_shardings=(None, None))
    with pytest.raises(ValueError, match="rounding"):
        sinkhorn.sinkhorn_assign(q + torch.arange(4.0)[:, None], q,
                                 rounding="nope")

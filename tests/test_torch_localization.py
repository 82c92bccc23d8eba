"""Port parity: `aclswarm_torch.sim.localization` vs the reference on the
CPU, same seeded numpy inputs. Ages and packed values exact; estimates
exact too (the merge moves values, it never computes them)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch.sim import localization as loc
from aclswarm_tpu.sim import localization as jloc

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

_j_flood = jax.jit(jloc.flood, static_argnames=("target_block", "merge_impl",
                                                "stripe"))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    est = rng.normal(size=(n, n, 3)) * 5
    age = rng.integers(0, 40, size=(n, n)).astype(np.int32)
    age[rng.random((n, n)) < 0.05] = 40000          # beyond AGE_CAP
    comm = rng.random((n, n)) < 0.3
    np.fill_diagonal(comm, False)
    comm[1] = False                                  # isolated receiver
    return est, age, comm


def _both(est, age):
    return (jloc.EstimateTable(est=jnp.asarray(est), age=jnp.asarray(age)),
            loc.EstimateTable(est=_t(est), age=_t(age, torch.int32)))


def _same(t, jt):
    np.testing.assert_array_equal(t.age.numpy(), np.asarray(jt.age))
    np.testing.assert_array_equal(t.est.numpy(), np.asarray(jt.est))


def test_init_table_and_observe_self():
    q = np.random.default_rng(0).normal(size=(6, 3))
    jt, t = jloc.init_table(jnp.asarray(q)), \
        loc.init_table(q, device="cpu", dtype=torch.float64)
    _same(t, jt)
    est, age, _ = _table(6, 1)
    jt, t = _both(est, age)
    _same(loc.observe_self(t, _t(q)), jloc.observe_self(jt, jnp.asarray(q)))
    assert (t.age.numpy() == age).all()        # the input is not mutated


@pytest.mark.parametrize("block", [None, 5])
@pytest.mark.parametrize("n", [9, 24])
def test_flood_dense_and_blocked(block, n):
    est, age, comm = _table(n, n)
    jt, t = _both(est, age)
    _same(loc.flood(t, torch.as_tensor(comm), target_block=block),
          _j_flood(jt, jnp.asarray(comm), target_block=block))


@pytest.mark.parametrize("stripe", [(0, 12), (12, 12), (5, 7), (11, 13)])
def test_flood_stripe(stripe):
    est, age, comm = _table(24, 7)
    jt, t = _both(est, age)
    out = loc.flood(t, torch.as_tensor(comm), stripe=stripe)
    _same(out, _j_flood(jt, jnp.asarray(comm), stripe=stripe))
    lo, hi = stripe[0], stripe[0] + stripe[1]
    assert (out.age[:, :lo].numpy() == age[:, :lo]).all()
    assert (out.age[:, hi:].numpy() == age[:, hi:]).all()


def test_flood_merge_impl_names():
    est, age, comm = _table(5, 2)
    _, t = _both(est, age)
    with pytest.raises(ValueError, match="merge impl"):
        loc.flood(t, torch.as_tensor(comm), merge_impl="pallas")


def _formation(n, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.3).astype(float)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    return adj, rng.permutation(n).astype(np.int32)


@pytest.mark.parametrize("phases", [1, 2])
def test_tick_sequence(phases):
    """Twelve ticks of moving vehicles through `tick` / `tick_phased` (the
    host tick decides the flood and the stripe), then the views."""
    n, every = 13, 2
    adj, v2f = _formation(n, 3)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(n, 3)) * 4
    jt = jloc.init_table(jnp.asarray(q))
    t = loc.init_table(q, device="cpu", dtype=torch.float64)
    link = rng.random((n, n)) < 0.8
    for k in range(12):
        q = q + rng.normal(size=(n, 3)) * 0.1
        mask = link if k % 3 == 0 else None
        jmask = None if mask is None else jnp.asarray(mask)
        tmask = None if mask is None else torch.as_tensor(mask)
        if phases == 1:
            jt = jloc.tick(jt, jnp.asarray(q), jnp.asarray(adj),
                           jnp.asarray(v2f), jnp.asarray(k % every == 0),
                           link_mask=jmask)
            t = loc.tick(t, _t(q), _t(adj), _t(v2f, torch.int32),
                         k % every == 0, link_mask=tmask)
        else:
            jt = jloc.tick_phased(jt, jnp.asarray(q), jnp.asarray(adj),
                                  jnp.asarray(v2f), k, every, phases,
                                  link_mask=jmask)
            t = loc.tick_phased(t, _t(q), _t(adj), _t(v2f, torch.int32), k,
                                every, phases, link_mask=tmask)
        _same(t, jt)
    np.testing.assert_array_equal(loc.relative_views(t).numpy(),
                                  np.asarray(jloc.relative_views(jt)))
    np.testing.assert_allclose(
        loc.staleness(t, _t(q)).numpy(),
        np.asarray(jloc.staleness(jt, jnp.asarray(q))), rtol=0, atol=1e-12)


def test_tick_phased_rejects_bad_phases():
    q = np.zeros((4, 3))
    t = loc.init_table(q, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        loc.tick_phased(t, _t(q), torch.ones(4, 4), torch.arange(4), 0, 2, 3)


@pytest.mark.parametrize("on", [False, True])
def test_noised_view(on):
    est, age, _ = _table(5, 5)
    draw = np.random.default_rng(6).normal(size=(5, 5, 3))
    jt, t = _both(est, age)
    _same(loc.noised_view(t, (_t(draw), torch.tensor(on))),
          jloc.noised_view(jt, (jnp.asarray(draw), jnp.asarray(on))))


def test_comm_mask_matches():
    adj, v2f = _formation(10, 8)
    np.testing.assert_array_equal(
        loc.comm_mask(_t(adj), _t(v2f, torch.int32)).numpy(),
        np.asarray(jloc.comm_mask(jnp.asarray(adj), jnp.asarray(v2f))))

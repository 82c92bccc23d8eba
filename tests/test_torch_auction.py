"""Port parity: `aclswarm_torch.assignment.auction` and
`aclswarm_torch.faults.masking` vs the reference, float64 on the CPU from
the same seeded numpy inputs. The reference is called as its own tests call
it (no outer `jit`; its two `lax.while_loop`s compile their bodies).

`row_to_col`, `iters` and `valid` are held bit for bit and `prices` with
``rtol=0, atol=0``: the port does the same IEEE operations in the same
order, down to the reciprocal multiply the reference's compiler makes of
``eps / scale_factor``. Total cost is within n*eps_min of the host
Jonker-Volgenant optimum (`lapjv`)."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from aclswarm_torch.assignment import auction
from aclswarm_torch.faults import masking
from aclswarm_tpu.assignment import auction as jauction
from aclswarm_tpu.assignment.lapjv import lapjv
from aclswarm_tpu.faults import masking as jmasking

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

SIZES = [1, 2, 6, 33, 100]


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _benefit(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        q, p = rng.uniform(-10, 10, (2, n, 3))
        return -np.linalg.norm(q[:, None] - p[None], axis=-1)
    # integer ties: a handful of levels, so many agents bid the same amount
    # for the same object and every argmax is decided by its tie rule
    return rng.integers(0, 4, size=(n, n)).astype(float)


def _assert_same(out, ref):
    np.testing.assert_array_equal(out.row_to_col.numpy(),
                                  np.asarray(ref.row_to_col))
    assert out.row_to_col.dtype == torch.int32
    assert int(out.iters) == int(ref.iters)
    assert bool(out.valid) == bool(ref.valid)
    np.testing.assert_allclose(out.prices.numpy(), np.asarray(ref.prices),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("n", SIZES)
def test_auction_lap(kind, n):
    b = _benefit(kind, n, n)
    ref = jauction.auction_lap(jnp.asarray(b))
    out = auction.auction_lap(_t(b))
    _assert_same(out, ref)
    assert bool(out.valid)
    assert sorted(out.row_to_col.tolist()) == list(range(n))
    # within n * eps_min of the optimum
    rows = np.arange(n)
    got = -b[rows, out.row_to_col.numpy()].sum()
    opt = -b[rows, lapjv(-b)].sum()
    assert got <= opt + n * 1e-4 + 1e-12


@pytest.mark.parametrize("n", [6, 33])
@pytest.mark.parametrize("kw", [dict(eps_start=0.5),
                                dict(eps_start=2.0, eps_min=1e-6),
                                dict(scale_factor=3.0),
                                dict(eps_start=1e-5)],
                         ids=["eps_start", "eps_start_min", "scale",
                              "start_below_min"])
def test_auction_lap_arguments(n, kw):
    b = _benefit("random", n, 7 + n)
    _assert_same(auction.auction_lap(_t(b), **kw),
                 jauction.auction_lap(jnp.asarray(b), **kw))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("max_rounds", [0, 1, 5, 40])
def test_auction_lap_out_of_rounds(kind, max_rounds):
    """A budget that ends the solve early. Mid-phase it ends invalid (some
    agents own nothing); on a phase boundary it keeps that coarse phase's
    permutation. Either way the partial `row_to_col`, `prices`, `iters`
    and `valid` agree."""
    b = _benefit(kind, 33, 3)
    ref = jauction.auction_lap(jnp.asarray(b), max_rounds=max_rounds)
    out = auction.auction_lap(_t(b), max_rounds=max_rounds)
    _assert_same(out, ref)
    assert int(out.iters) == max_rounds
    if max_rounds <= 1:
        assert not bool(out.valid)


@pytest.mark.parametrize("dead", ["none", "some", "all", "all_but_one"])
def test_auction_on_masked_cost(dead):
    """`mask_cost` inputs: dead vehicles come back pinned to their points.
    The all-alive mask passes the cost through bit for bit."""
    n = 12
    rng = np.random.default_rng(5)
    c = -_benefit("random", n, 11)
    v2f = rng.permutation(n).astype(np.int32)
    alive = {"none": np.ones(n, bool), "some": rng.random(n) > 0.4,
             "all": np.zeros(n, bool),
             "all_but_one": np.arange(n) == 3}[dead]
    ref_c = jmasking.mask_cost(jnp.asarray(c), jnp.asarray(alive),
                               jnp.asarray(v2f))
    out_c = masking.mask_cost(_t(c), torch.as_tensor(alive),
                              _t(v2f, torch.int32))
    np.testing.assert_array_equal(out_c.numpy(), np.asarray(ref_c))
    if dead == "none":
        np.testing.assert_array_equal(out_c.numpy(), c)
    ref = jauction.auction_lap(-ref_c)
    out = auction.auction_lap(-out_c)
    _assert_same(out, ref)
    np.testing.assert_array_equal(out.row_to_col.numpy()[~alive],
                                  v2f[~alive])


def test_masking_helpers():
    n = 9
    rng = np.random.default_rng(2)
    alive = rng.random(n) > 0.3
    v2f = rng.permutation(n).astype(np.int32)
    ja, jv = jnp.asarray(alive), jnp.asarray(v2f)
    ta, tv = torch.as_tensor(alive), _t(v2f, torch.int32)
    np.testing.assert_array_equal(masking.alive_points(ta, tv).numpy(),
                                  np.asarray(jmasking.alive_points(ja, jv)))
    for out, ref in zip(masking.pin_forbid(ta, tv),
                        jmasking.pin_forbid(ja, jv)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    c = rng.random((n, n))
    pin, forbid = masking.pin_forbid(ta, tv)
    np.testing.assert_array_equal(
        masking.apply_pin_forbid(_t(c), pin, forbid).numpy(),
        np.asarray(jmasking.apply_pin_forbid(
            jnp.asarray(c), *jmasking.pin_forbid(ja, jv))))


def test_assign_min_dist():
    rng = np.random.default_rng(4)
    q, p = rng.uniform(-5, 5, (2, 10, 3))
    ref = jauction.assign_min_dist(jnp.asarray(q), jnp.asarray(p))
    out = auction.assign_min_dist(_t(q), _t(p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("poll_every", [1, 7, 64])
def test_polled_loop_is_invisible(kind, poll_every):
    """The done flag may be read every K steps: steps past the end are the
    identity and `iters` counts only live rounds."""
    b = _benefit(kind, 33, 9)
    ref = jauction.auction_lap(jnp.asarray(b))
    _assert_same(auction.auction_lap(_t(b), poll_every=poll_every), ref)
    cut = auction.auction_lap(_t(b), max_rounds=37, poll_every=poll_every)
    _assert_same(cut, jauction.auction_lap(jnp.asarray(b), max_rounds=37))


def test_first_hit_argmax_decides_ties():
    """All agents want object 0 at the same bid: the lowest agent id gets
    it (first-hit argmax over bidders), and equal values fall to the
    lowest column (first-hit argmax over objects)."""
    b = np.zeros((5, 5))
    b[:, 0] = 1.0
    out = auction.auction_lap(_t(b), max_rounds=1)
    assert out.row_to_col.tolist()[0] == 0 and not bool(out.valid)
    _assert_same(out, jauction.auction_lap(jnp.asarray(b), max_rounds=1))
    _assert_same(auction.auction_lap(_t(b)),
                 jauction.auction_lap(jnp.asarray(b)))


def test_float32_matches_reference():
    """The main path's dtype: float32 in both packages, same bits."""
    b = _benefit("random", 33, 21).astype(np.float32)
    ref = jauction.auction_lap(jnp.asarray(b))
    out = auction.auction_lap(torch.as_tensor(b))
    assert out.prices.dtype == torch.float32
    _assert_same(out, ref)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 10), seed=st.integers(0, 2**31 - 1),
       levels=st.integers(1, 5), max_rounds=st.sampled_from([3, 10000]))
def test_auction_hypothesis(n, seed, levels, max_rounds):
    """Small tie-heavy matrices, with and without a starving budget."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, levels + 1, size=(n, n)).astype(float)
    _assert_same(auction.auction_lap(_t(b), max_rounds=max_rounds),
                 jauction.auction_lap(jnp.asarray(b), max_rounds=max_rounds))

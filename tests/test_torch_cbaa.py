"""Port parity: `aclswarm_torch.assignment.cbaa` and
`core.geometry.align_formation_local` vs the reference, float64 on the CPU
from the same seeded numpy inputs. The reference is called as its own tests
call it (no outer `jit`).

`v2f`, `f2v`, `valid`, `who` and `rounds` are held bit for bit everywhere.
`price` is held with ``rtol=0, atol=0`` wherever both packages get the same
aligned formation (`cbaa_assign`: the port's distance is
`torch.linalg.vector_norm`, which matched the reference's compiled norm
bit for bit; the separately rounded sum of squares did not). Through
`cbaa_from_state` the reference's batched SVD and the port's closed-form
rotation differ in the last bits of the alignment, so there `price` is
held at rtol 1e-12. The alignment itself is held at atol 1e-9 on R p + t,
never on the factors.

`cbaa_ref.cbaa_oracle` (sequential per-vehicle numpy loops) is the second
oracle at n <= 12."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from aclswarm_torch.assignment import cbaa
from aclswarm_torch.core import geometry
from aclswarm_torch.sim import localization as loclib
from aclswarm_tpu.assignment import cbaa as jcbaa
from aclswarm_tpu.assignment import cbaa_ref
from aclswarm_tpu.core import geometry as jgeometry
from aclswarm_tpu.sim import localization as jloclib

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

F64 = torch.float64
INT_FIELDS = ("v2f", "f2v", "valid", "who", "rounds")


def _t(x, dtype=F64):
    return None if x is None else torch.as_tensor(np.array(x), dtype=dtype)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _graph(kind, n, rng):
    if kind == "complete":
        return np.ones((n, n)) - np.eye(n)
    if kind == "ring":                 # ring + chords, diameter ~2-3
        adj = np.zeros((n, n))
        for i in range(n):
            for dj in (1, 2, 3):
                adj[i, (i + dj) % n] = adj[(i + dj) % n, i] = 1
        return adj
    adj = np.triu(rng.random((n, n)) < 0.35, 1)      # sparse random
    return (adj | adj.T).astype(float)


def _case(n, seed, graph="sparse", spread=0.0):
    """Positions, formation, graph, current assignment. ``spread`` > 0
    puts the swarm near the formation (a settled fleet)."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-10, 10, (n, 3))
    q = p[rng.permutation(n)] + rng.normal(size=(n, 3)) * spread \
        if spread else rng.uniform(-10, 10, (n, 3))
    return q, p, _graph(graph, n, rng), rng.permutation(n).astype(np.int32)


def _both(q, p, adj, v2f, paligned=None, **kw):
    """The same call through both packages: `cbaa_assign` when an aligned
    formation is given, `cbaa_from_state` otherwise. Mask and table
    keywords are numpy on the way in."""
    jkw, tkw = dict(kw), dict(kw)
    for k in ("alive", "comm_extra", "first"):
        if kw.get(k) is not None:
            jkw[k], tkw[k] = jnp.asarray(kw[k]), torch.as_tensor(kw[k])
    if kw.get("est") is not None:
        jkw["est"], tkw["est"] = jnp.asarray(kw["est"]), _t(kw["est"])
    if kw.get("warm") is not None:
        price, who = kw["warm"]
        jkw["warm"] = jcbaa.CbaaTables(jnp.asarray(price), jnp.asarray(who))
        tkw["warm"] = cbaa.CbaaTables(_t(price), _t(who, torch.int32))
    if paligned is None:
        ref = jcbaa.cbaa_from_state(_j(q), _j(p), _j(adj), _j(v2f), **jkw)
        out = cbaa.cbaa_from_state(_t(q), _t(p), _t(adj),
                                   _t(v2f, torch.int32), **tkw)
    else:
        ref = jcbaa.cbaa_assign(_j(q), _j(paligned), _j(adj), _j(v2f), **jkw)
        out = cbaa.cbaa_assign(_t(q), _t(paligned), _t(adj),
                               _t(v2f, torch.int32), **tkw)
    return out, ref


def _assert_same(out, ref, price_rtol=0.0):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    assert out.v2f.dtype == out.who.dtype == torch.int32
    np.testing.assert_allclose(out.price.numpy(), np.asarray(ref.price),
                               rtol=price_rtol, atol=0)


def _aligned(q, p, adj, v2f, est=None):
    return np.asarray(jgeometry.align_formation_local(
        _j(q), _j(p), _j(adj), _j(v2f), est=_j(est)))


# --- local alignment -------------------------------------------------------

@pytest.mark.parametrize("with_est", [False, True])
@pytest.mark.parametrize("n,graph", [(6, "complete"), (12, "ring"),
                                     (40, "sparse")])
def test_align_formation_local(n, graph, with_est):
    q, p, adj, v2f = _case(n, n, graph)
    est = None
    if with_est:
        est = q[None] + np.random.default_rng(n).normal(size=(n, n, 3)) * 0.2
    ref = _aligned(q, p, adj, v2f, est)
    out = geometry.align_formation_local(_t(q), _t(p), _t(adj),
                                         _t(v2f, torch.int32), est=_t(est))
    assert out.shape == (n, n, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)


def test_align_formation_local_reflected_cloud():
    """The swarm is a mirror image of the formation: the determinant fix
    keeps every agent's R a rotation (compare R p + t, not the factors)."""
    n = 10
    q, p, adj, v2f = _case(n, 3, "ring")
    q = p[np.argsort(v2f)] * np.array([-1.0, 1.0, 1.0]) + [3.0, -2.0, 0.5]
    ref = _aligned(q, p, adj, v2f)
    out = geometry.align_formation_local(_t(q), _t(p), _t(adj),
                                         _t(v2f, torch.int32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)
    # a rotation about z preserves the formation's pairwise xy distances
    d_out = np.linalg.norm(out.numpy()[0, :, None, :2]
                           - out.numpy()[0, None, :, :2], axis=-1)
    d_p = np.linalg.norm(p[:, None, :2] - p[None, :, :2], axis=-1)
    np.testing.assert_allclose(d_out, d_p, rtol=0, atol=1e-9)


def test_align_formation_local_isolated_point():
    """A formation point with no neighbor aligns on itself alone: a zero
    cross-covariance, any rotation optimal, the translation pins the point
    onto its vehicle. The rows of the connected agents agree everywhere;
    the isolated agent's row agrees at its own point."""
    n = 9
    q, p, adj, v2f = _case(n, 5, "ring")
    adj[4, :] = adj[:, 4] = 0
    ref = _aligned(q, p, adj, v2f)
    out = geometry.align_formation_local(_t(q), _t(p), _t(adj),
                                         _t(v2f, torch.int32)).numpy()
    lonely = int(np.argsort(v2f)[4])          # the vehicle at point 4
    others = np.arange(n) != lonely
    np.testing.assert_allclose(out[others], ref[others], rtol=0, atol=1e-9)
    np.testing.assert_allclose(out[lonely, 4], ref[lonely, 4], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(out[lonely, 4, :2], q[lonely, :2], rtol=0,
                               atol=1e-9)
    assert np.isfinite(out).all()


def _svd_rotation(sigma):
    """The reference's rule for one (2, 2) cross-covariance: the SVD with
    the determinant correction (`arun`)."""
    U, _, Vt = np.linalg.svd(sigma)
    S = np.diag([1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt)) or 1.0])
    return U @ S @ Vt


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_align_formation_local_batch_equals_lone_solves(dtype):
    """The local alignment's rotations come from `_rotation2` element by
    element: each agent's rotation in a batch of local alignments is its
    lone solve's bit for bit (a batched SVD rounds a batch otherwise), and
    it is the reference's SVD-with-determinant rotation, reflected and
    zero covariances included (a zero covariance gives I)."""
    n = 40
    rng = np.random.default_rng(7)
    sig = rng.normal(size=(n, 2, 2))
    sig[1] = [[-1.0, 0.5], [0.0, 2.0]]           # a reflection (det < 0)
    sig[2] = 0.0                                 # nothing to align on
    sigma = torch.as_tensor(sig, dtype=dtype)
    batch = geometry._rotation2(sigma)
    for v in range(n):
        assert torch.equal(batch[v], geometry._rotation2(sigma[v])), v
    assert torch.equal(batch[2], torch.eye(2, dtype=dtype))
    want = np.stack([_svd_rotation(s) for s in sig])
    want[2] = np.eye(2)
    tol = 1e-6 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(batch.double().numpy(), want, rtol=0,
                               atol=tol)
    np.testing.assert_allclose(np.linalg.det(batch.double().numpy()), 1.0,
                               rtol=0, atol=tol)


# --- the auction -----------------------------------------------------------

@pytest.mark.parametrize("task_block", [None, 7, 64])
@pytest.mark.parametrize("n,graph", [(8, "complete"), (12, "ring"),
                                     (40, "sparse"), (70, "sparse")])
def test_cbaa_assign(n, graph, task_block):
    """From one aligned formation: every field bit for bit, price too."""
    q, p, adj, v2f = _case(n, n, graph)
    out, ref = _both(q, p, adj, v2f, paligned=_aligned(q, p, adj, v2f),
                     task_block=task_block)
    _assert_same(out, ref)


@pytest.mark.parametrize("with_est", [False, True])
@pytest.mark.parametrize("n,graph", [(8, "complete"), (40, "sparse")])
def test_cbaa_from_state(n, graph, with_est):
    """Alignment + auction; ``est`` from a flooded table a few ticks old."""
    q, p, adj, v2f = _case(n, 20 + n, graph)
    est = None
    if with_est:
        rng = np.random.default_rng(n)
        table = jloclib.init_table(_j(q))
        for _ in range(5):
            q = q + rng.normal(size=(n, 3)) * 0.05
            table = jloclib.tick(table, _j(q), _j(adj), _j(v2f), True)
        est = np.asarray(table.est)
        port = loclib.EstimateTable(est=_t(est),
                                    age=_t(table.age, torch.int32))
        assert torch.equal(port.est, _t(est))
    out, ref = _both(q, p, adj, v2f, est=est, task_block=7)
    _assert_same(out, ref, price_rtol=1e-12)


@pytest.mark.parametrize("task_block", [None, 5])
@pytest.mark.parametrize("n", [6, 14, 20])
def test_early_exit_off_runs_the_budget(n, task_block):
    q, p, adj, v2f = _case(n, n + 1, "ring")
    pal = _aligned(q, p, adj, v2f)
    full, ref_full = _both(q, p, adj, v2f, paligned=pal, early_exit=False,
                           task_block=task_block)
    _assert_same(full, ref_full)
    fast, ref_fast = _both(q, p, adj, v2f, paligned=pal,
                           task_block=task_block)
    _assert_same(fast, ref_fast)
    assert int(full.rounds) == 2 * n > int(fast.rounds)
    for k in ("v2f", "f2v", "price", "who"):
        assert torch.equal(getattr(fast, k), getattr(full, k)), k


@pytest.mark.parametrize("n_iters", [0, 1, 3])
def test_n_iters_cuts_the_auction(n_iters):
    q, p, adj, v2f = _case(14, 2, "ring")
    out, ref = _both(q, p, adj, v2f, paligned=_aligned(q, p, adj, v2f),
                     n_iters=n_iters)
    _assert_same(out, ref)
    assert int(out.rounds) == n_iters


@pytest.mark.parametrize("dead", ["none", "some", "all", "first"])
@pytest.mark.parametrize("graph", ["complete", "sparse"])
def test_alive_mask(graph, dead):
    n = 16
    q, p, adj, v2f = _case(n, 8, graph)
    pal = _aligned(q, p, adj, v2f)
    rng = np.random.default_rng(1)
    alive = {"none": np.ones(n, bool), "some": rng.random(n) > 0.3,
             "all": np.zeros(n, bool), "first": np.arange(n) > 2}[dead]
    out, ref = _both(q, p, adj, v2f, paligned=pal, alive=alive,
                     task_block=7)
    _assert_same(out, ref)
    if dead == "none":                 # all alive == no mask, bit for bit
        plain = cbaa.cbaa_assign(_t(q), _t(pal), _t(adj),
                                 _t(v2f, torch.int32), task_block=7)
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    if dead == "all":
        assert not bool(out.valid)
    if bool(out.valid):                # dead vehicles keep their points
        np.testing.assert_array_equal(out.v2f.numpy()[~alive], v2f[~alive])


@pytest.mark.parametrize("drop", [0.0, 0.3, 1.0])
def test_comm_extra(drop):
    """Link loss ANDed onto the consensus graph; self-loops never drop."""
    n = 14
    q, p, adj, v2f = _case(n, 6, "ring")
    link = np.random.default_rng(2).random((n, n)) >= drop
    out, ref = _both(q, p, adj, v2f, paligned=_aligned(q, p, adj, v2f),
                     comm_extra=link)
    _assert_same(out, ref)
    if drop == 1.0:
        assert not bool(out.valid)     # nobody hears anybody


def test_warm_init_tables_is_cold():
    n = 12
    q, p, adj, v2f = _case(n, 13, "complete", spread=0.3)
    pal = _aligned(q, p, adj, v2f)
    cold, ref_cold = _both(q, p, adj, v2f, paligned=pal)
    tables = cbaa.init_tables(n, "cpu", F64)
    warm, ref_warm = _both(q, p, adj, v2f, paligned=pal,
                           warm=(tables.price.numpy(), tables.who.numpy()))
    _assert_same(warm, ref_warm)
    for a, b in zip(cold, warm):
        assert torch.equal(a, b)


@pytest.mark.parametrize("graph", ["complete", "ring"])
@pytest.mark.parametrize("moved", [0.0, 2.0])
def test_warm_carried_tables(graph, moved):
    """A carried fixed point: unchanged geometry re-converges in fewer
    rounds; moved geometry releases stale holders at the seed."""
    n = 12
    q, p, adj, v2f = _case(n, 14, graph, spread=0.3)
    pal = _aligned(q, p, adj, v2f)
    cold, _ = _both(q, p, adj, v2f, paligned=pal)
    carry = (cold.price.numpy(), cold.who.numpy())
    q2 = q + np.random.default_rng(15).normal(size=(n, 3)) * moved
    warm, ref = _both(q2, p, adj, v2f, paligned=pal, warm=carry,
                      task_block=5)
    _assert_same(warm, ref)
    if not moved:
        assert bool(warm.valid) and int(warm.rounds) < int(cold.rounds)
        assert torch.equal(warm.v2f, cold.v2f)


@pytest.mark.parametrize("first", [None, False, True])
@pytest.mark.parametrize("eps", [0.05, 0.9])
def test_assign_eps_veto(eps, first):
    n = 12
    q, p, adj, v2f = _case(n, 16, "complete")
    pal = _aligned(q, p, adj, v2f)
    out, ref = _both(q, p, adj, v2f, paligned=pal, assign_eps=eps,
                     first=None if first is None else np.asarray(first))
    _assert_same(out, ref)
    raw = cbaa.cbaa_assign(_t(q), _t(pal), _t(adj), _t(v2f, torch.int32))
    assert torch.equal(out.f2v, raw.f2v) and torch.equal(out.who, raw.who)
    if eps == 0.9 and not first:       # a 90% margin vetoes the change
        np.testing.assert_array_equal(out.v2f.numpy(), v2f)
    if first:
        assert torch.equal(out.v2f, raw.v2f)


@pytest.mark.parametrize("n,graph", [(5, "complete"), (9, "ring"),
                                     (12, "sparse")])
def test_against_sequential_oracle(n, graph):
    """`cbaa_ref.cbaa_oracle`: per-vehicle loops that share no structure
    with the tensor form. It runs the full 2n budget, which the early exit
    equals."""
    q, p, adj, v2f = _case(n, 30 + n, graph)
    pal = _aligned(q, p, adj, v2f)
    ref = cbaa_ref.cbaa_oracle(q, p, adj, v2f, aligned=pal)
    out = cbaa.cbaa_assign(_t(q), _t(pal), _t(adj), _t(v2f, torch.int32))
    assert bool(out.valid) == ref["valid"]
    np.testing.assert_array_equal(out.who.numpy(), ref["who"])
    np.testing.assert_array_equal(out.f2v.numpy(), ref["f2v"])
    np.testing.assert_array_equal(out.v2f.numpy(), ref["v2f"])
    np.testing.assert_allclose(out.price.numpy(), ref["price"], rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("poll_every", [1, 7, 64])
def test_polled_loop_is_invisible(poll_every):
    """The fixed-point flag may be read every K rounds: rounds past the
    fixed point change nothing and are not counted."""
    q, p, adj, v2f = _case(20, 4, "ring")
    pal = _aligned(q, p, adj, v2f)
    ref = jcbaa.cbaa_assign(_j(q), _j(pal), _j(adj), _j(v2f))
    args = (_t(q), _t(pal), _t(adj), _t(v2f, torch.int32))
    _assert_same(cbaa.cbaa_assign(*args, poll_every=poll_every), ref)
    cut = cbaa.cbaa_assign(*args, poll_every=poll_every, n_iters=3)
    _assert_same(cut, jcbaa.cbaa_assign(_j(q), _j(pal), _j(adj), _j(v2f),
                                        n_iters=3))


def test_tie_rules():
    """Two vehicles at the same distance from the same point bid the same
    price: the lower vehicle id wins the consensus, and a vehicle with two
    equally priced points takes the lower point index."""
    p = np.array([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0], [0.0, 4.0, 0.0]])
    q = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [2.0, 2.0, 0.0]])
    adj = np.ones((3, 3)) - np.eye(3)
    v2f = np.arange(3, dtype=np.int32)
    pal = np.broadcast_to(p, (3, 3, 3)).copy()
    out, ref = _both(q, p, adj, v2f, paligned=pal)
    _assert_same(out, ref)
    assert int(out.f2v[0]) == 0        # vehicles 0 and 1 tie for point 0
    prices = cbaa.bid_prices(_t(q), _t(pal))
    assert prices[0, 0] == prices[1, 0] and prices[2, 1] == prices[2, 2]


def test_bid_prices_bit_for_bit():
    q, p, adj, v2f = _case(40, 12)
    pal = _aligned(q, p, adj, v2f)
    np.testing.assert_array_equal(
        cbaa.bid_prices(_t(q), _t(pal)).numpy(),
        np.asarray(jcbaa.bid_prices(_j(q), _j(pal))))


@pytest.mark.parametrize("n,seed", [(40, 12), (130, 3)])
def test_bid_prices_bit_for_bit_float32(n, seed):
    """In float32 the port writes the reference's norm out (a fused
    multiply-add chain, the correctly rounded root) so that the card
    rounds it as the CPU does: the bits are still the reference's."""
    q, p, adj, v2f = _case(n, seed)
    q = q.astype(np.float32)
    pal = _aligned(q, p, adj, v2f).astype(np.float32)
    np.testing.assert_array_equal(
        cbaa.bid_prices(_t(q, torch.float32), _t(pal, torch.float32))
        .numpy(),
        np.asarray(jcbaa.bid_prices(jnp.asarray(q), jnp.asarray(pal))))


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 10), seed=st.integers(0, 2**31 - 1),
       task_block=st.sampled_from([None, 1, 3]), grid=st.booleans(),
       masked=st.booleans())
def test_cbaa_hypothesis(n, seed, task_block, grid, masked):
    """Small swarms; on a coarse integer grid equal distances, hence equal
    prices, are common and the tie rules decide."""
    rng = np.random.default_rng(seed)
    if grid:
        q = rng.integers(-2, 3, (n, 3)).astype(float)
        p = rng.integers(-2, 3, (n, 3)).astype(float)
    else:
        q, p = rng.uniform(-5, 5, (2, n, 3))
    adj = _graph("sparse", n, rng)
    v2f = rng.permutation(n).astype(np.int32)
    pal = np.broadcast_to(p, (n, n, 3)).copy()
    alive = (rng.random(n) > 0.3) if masked else None
    out, ref = _both(q, p, adj, v2f, paligned=pal, task_block=task_block,
                     alive=alive)
    _assert_same(out, ref)

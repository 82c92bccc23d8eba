"""The control law's gain product, and CBAA's local alignment and bids,
round the same at every place.

`control.distcntrl._gain_product` is elementwise, so a rank's block of rows
(`compute_rows`) equals the whole swarm's law (`compute`) bit for bit, of
one trial or of a batch, in every view and dtype; a batch rolled by 7
places or cut in two halves equals the whole batch; and on the CPU the
product keeps the bits of the batched contraction it replaced. `compute`
against the reference's `control.compute` at `test_torch_control.py`'s
atol 1e-10 (float64, the same formulas), a batch through `jax.vmap`.

The local alignment (`core.geometry.align_formation_local`) sums over the
formation points with the same fold (`core.geometry.row_sum`) and writes
its 2x2 products out, so a block of agents' rows (`_align_rows`) and the
swarm with its vehicles relabelled equal the whole bit for bit; the bids
(`assignment.cbaa.bid_prices`) likewise, and on the CPU the written-out
float32 distance keeps `torch.linalg.vector_norm`'s bits."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aclswarm_torch import control
from aclswarm_torch.assignment import cbaa
from aclswarm_torch.control import distcntrl
from aclswarm_torch.core import geometry
from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core import types
from aclswarm_tpu import control as jcontrol
from aclswarm_tpu.core import types as jtypes

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

N = 16
ATOL = 1e-10
CG = dict(K1_xy=0.2, e_xy_thr=0.5, kd=0.3)
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _problem(seed, B=None):
    """Formation, state, assignment and relative views of one trial or of
    a batch of B (leading axis on every leaf)."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    pts = rng.normal(size=lead + (N, 3)) * 3
    adj = (rng.random(lead + (N, N)) < 0.6).astype(float)
    adj = np.triu(adj, 1) + np.swapaxes(np.triu(adj, 1), -1, -2)
    gains = rng.normal(size=lead + (N, N, 3, 3)) * 0.1
    q = rng.normal(size=lead + (N, 3)) * 3
    vel = rng.normal(size=lead + (N, 3))
    v2f = (rng.permutation(N) if B is None else
           np.stack([rng.permutation(N) for _ in range(B)])).astype(np.int32)
    rel = rng.normal(size=lead + (N, N, 3)) * 3
    return pts, adj, gains, q, vel, v2f, rel


def _formation(pts, adj, gains, dtype):
    if pts.ndim == 2:
        return types.make_formation(pts, adj, gains, device="cpu",
                                    dtype=dtype)
    return types.stack([types.make_formation(p, a, g, device="cpu",
                                             dtype=dtype)
                        for p, a, g in zip(pts, adj, gains)])


def _rows_formation(form, v2f_rows):
    """The formation rows of a block's vehicles (points unused), as
    `parallel.rollout` moves them to the rank."""
    lead = v2f_rows.ndim - 1
    idx = v2f_rows.long()
    return types.Formation(
        points=form.points,
        adjmat=permutil.take(form.adjmat, idx, lead),
        gains=permutil.take(form.gains, idx, lead),
        dstar_xy=permutil.take(form.dstar_xy, idx, lead),
        dstar_z=permutil.take(form.dstar_z, idx, lead))


@pytest.mark.parametrize("r", [1, 7, N // 2, N])
@pytest.mark.parametrize("view", ["truth", "rel"])
@pytest.mark.parametrize("B", [None, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rows_equal_compute_bit_for_bit(dtype, B, view, r):
    dt = DTYPES[dtype]
    pts, adj, gains, q, vel, v2f, rel = _problem(11, B)
    form = _formation(pts, adj, gains, dt)
    q, vel, rel = (torch.as_tensor(x, dtype=dt) for x in (q, vel, rel))
    v2f = torch.as_tensor(v2f)
    cg = types.ControlGains(**CG)
    whole = control.compute(types.SwarmState(q=q, vel=vel), form, v2f, cg,
                            rel=rel if view == "rel" else None)
    for lo in range(0, N, r):
        hi = min(lo + r, N)
        rows = control.compute_rows(
            vel[..., lo:hi, :], _rows_formation(form, v2f[..., lo:hi]),
            v2f, lo, cg, q=q if view == "truth" else None,
            rel=rel[..., lo:hi, :, :] if view == "rel" else None)
        assert rows.shape == whole[..., lo:hi, :].shape
        assert torch.equal(rows, whole[..., lo:hi, :]), (lo, hi)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_product_does_not_depend_on_place(dtype):
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(40, 40, 3, 3, generator=gen, dtype=DTYPES[dtype])
    q = torch.randn(40, 40, 3, generator=gen, dtype=DTYPES[dtype])
    prod = distcntrl._gain_product
    whole = prod(g, q)
    rolled = torch.roll(prod(torch.roll(g, 7, 0), torch.roll(q, 7, 0)), -7,
                        0)
    halves = torch.cat([prod(g[:20], q[:20]), prod(g[20:], q[20:])])
    batch = prod(g.reshape(4, 10, 40, 3, 3), q.reshape(4, 10, 40, 3))
    assert torch.equal(whole, rolled)
    assert torch.equal(whole, halves)
    assert torch.equal(whole, batch.reshape(whole.shape))
    # the CPU's numbers did not move with the change of formulation
    assert torch.equal(whole, torch.einsum("ijab,ijb->ija", g, q))


@pytest.mark.parametrize("with_rel", [False, True])
def test_batched_compute_matches_reference(with_rel):
    pts, adj, gains, q, vel, v2f, rel = _problem(5, 3)
    jform = jax.vmap(jtypes.make_formation)(jnp.asarray(pts),
                                            jnp.asarray(adj),
                                            jnp.asarray(gains))

    def ref_one(f, q, vel, v2f, rel):
        return jcontrol.compute(jtypes.SwarmState(q=q, vel=vel), f, v2f,
                                jtypes.ControlGains(**CG),
                                rel=rel if with_rel else None)

    ref = jax.vmap(ref_one)(jform, jnp.asarray(q), jnp.asarray(vel),
                            jnp.asarray(v2f), jnp.asarray(rel))
    out = control.compute(
        types.SwarmState(q=torch.as_tensor(q), vel=torch.as_tensor(vel)),
        _formation(pts, adj, gains, torch.float64), torch.as_tensor(v2f),
        types.ControlGains(**CG),
        rel=torch.as_tensor(rel) if with_rel else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


def _cbaa_problem(seed, dt):
    """Positions, formation, graph, assignment and flooded-looking
    estimates of one CBAA auction at n=N."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(N, 3)) * 5
    q = rng.normal(size=(N, 3)) * 5
    adj = np.triu(rng.random((N, N)) < 0.4, 1).astype(float)
    est = q[None] + rng.normal(size=(N, N, 3)) * 0.2
    v2f = torch.as_tensor(rng.permutation(N).astype(np.int32))
    q, p, adj, est = (torch.as_tensor(x, dtype=dt)
                      for x in (q, p, adj + adj.T, est))
    return q, p, adj, v2f, est


@pytest.mark.parametrize("r", [1, 5, N // 2, N])
@pytest.mark.parametrize("view", ["truth", "est"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_alignment_rows_equal_the_whole(dtype, view, r):
    """A block of r agents' local alignments equals the whole swarm's
    rows bit for bit: nothing mixes two agents' rows, and every sum over
    the formation points is the same fold at any block size."""
    q, p, adj, v2f, est = _cbaa_problem(21, DTYPES[dtype])
    est = est if view == "est" else None
    whole = geometry.align_formation_local(q, p, adj, v2f, est=est)
    f2v = permutil.invert(v2f).long()
    eye = torch.eye(N, dtype=torch.bool)
    w = ((adj[v2f.long()] > 0) | eye[v2f.long()]).to(q.dtype)
    qs = (q[f2v][None] if est is None else est[:, f2v])[..., :2]
    for lo in range(0, N, r):
        rows = geometry._align_rows(
            w[lo:lo + r], qs if est is None else qs[lo:lo + r], p[:, :2])
        assert torch.equal(rows, whole[lo:lo + r, :, :2]), lo


@pytest.mark.parametrize("view", ["truth", "est"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_alignment_and_bids_under_relabelled_vehicles(dtype, view):
    """The swarm with its vehicles relabelled (positions, assignment and
    estimates permuted alike) is the same batch of agent problems in
    another order: each vehicle's aligned formation and bids equal the
    whole's bit for bit, and so do the bids of a block of rows."""
    q, p, adj, v2f, est = _cbaa_problem(22, DTYPES[dtype])
    est = est if view == "est" else None
    perm = torch.as_tensor(np.random.default_rng(2).permutation(N))
    whole = geometry.align_formation_local(q, p, adj, v2f, est=est)
    bids = cbaa.bid_prices(q, whole)
    q2, v2f2 = torch.empty_like(q), torch.empty_like(v2f)
    q2[perm], v2f2[perm] = q, v2f
    est2 = None
    if est is not None:
        est2 = torch.empty_like(est)
        est2[perm[:, None], perm[None, :]] = est
    moved = geometry.align_formation_local(q2, p, adj, v2f2, est=est2)
    assert torch.equal(moved[perm], whole)
    assert torch.equal(cbaa.bid_prices(q2, moved)[perm], bids)
    for lo, hi in ((0, 1), (3, 10), (N // 2, N)):
        assert torch.equal(cbaa.bid_prices(q[lo:hi], whole[lo:hi]),
                           bids[lo:hi]), (lo, hi)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 20.0, 1e4])
def test_float32_distance_keeps_the_cpus_norm(scale):
    """The written-out chain (`cbaa._fma32`, a float64 root rounded once)
    gives `torch.linalg.vector_norm`'s float32 bits on the CPU: the
    reference's compiled norm, a fused multiply-add chain."""
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(300, 3, generator=gen) * scale
    pal = torch.randn(300, 300, 3, generator=gen) * scale
    assert torch.equal(cbaa._own_distances(q, pal),
                       torch.linalg.vector_norm(q[:, None] - pal, dim=-1))

"""Port parity: `aclswarm_torch.core` vs `aclswarm_tpu.core` (types,
perm, geometry), float64 on the CPU, the same seeded numpy inputs fed to
both. Tolerance atol 1e-10: the same formulas in f64, differing only in
summation order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aclswarm_torch.core import geometry, perm, types
from aclswarm_tpu.core import geometry as jgeometry
from aclswarm_tpu.core import perm as jperm
from aclswarm_tpu.core import types as jtypes

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

F64 = dict(device="cpu", dtype=torch.float64)
ATOL = 1e-10


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("flat", [False, True])
def test_make_formation(flat):
    rng = np.random.default_rng(1)
    n = 7
    pts = rng.normal(size=(n, 3)) * 4
    adj = (rng.random((n, n)) < 0.6).astype(float)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    gains = rng.normal(size=(n, n, 3, 3))
    if flat:
        gains = np.array(jtypes.gains_to_flat(jnp.asarray(gains)))
    ref = jtypes.make_formation(pts, adj, gains)
    out = types.make_formation(pts, adj, gains, **F64)
    for k in ("points", "adjmat", "gains", "dstar_xy", "dstar_z"):
        _close(getattr(out, k), getattr(ref, k))
    assert out.gains.shape == (n, n, 3, 3) and out.n == n


def test_make_formation_default_gains_and_dtype():
    pts = np.random.default_rng(2).normal(size=(5, 3))
    out = types.make_formation(pts, np.ones((5, 5)), device="cpu")
    assert out.points.dtype == torch.float32
    assert torch.count_nonzero(out.gains) == 0


def test_gains_flat_roundtrip():
    g = np.random.default_rng(3).normal(size=(4, 4, 3, 3))
    flat = types.gains_to_flat(_t(g))
    _close(flat, jtypes.gains_to_flat(jnp.asarray(g)), 0)
    _close(types.gains_from_flat(flat), g, 0)


def test_perm_helpers():
    rng = np.random.default_rng(4)
    n = 9
    v2f = rng.permutation(n).astype(np.int32)
    x = rng.normal(size=(n, 3))
    tv = _t(v2f, torch.int32)
    np.testing.assert_array_equal(perm.invert(tv), jperm.invert(v2f))
    _close(perm.veh_to_formation_order(_t(x), tv),
           jperm.veh_to_formation_order(jnp.asarray(x), v2f), 0)
    _close(perm.formation_to_veh_order(_t(x), tv),
           jperm.formation_to_veh_order(jnp.asarray(x), v2f), 0)
    outer = rng.permutation(n).astype(np.int32)
    np.testing.assert_array_equal(perm.compose(_t(outer, torch.int32), tv),
                                  jperm.compose(outer, v2f))
    np.testing.assert_array_equal(perm.identity(n, "cpu"), np.arange(n))


@pytest.mark.parametrize("vec", [[0, 1, 2, 3], [0, 1, 1, 3], [0, 1, 2, 7],
                                 [-1, 1, 2, 3], [3, 2, 0, 1]])
def test_is_valid(vec):
    v = np.asarray(vec, np.int32)
    assert bool(perm.is_valid(_t(v, torch.int32))) == \
        bool(jperm.is_valid(jnp.asarray(v)))


@pytest.mark.parametrize("self_loop", [False, True])
def test_comm_mask(self_loop):
    rng = np.random.default_rng(5)
    n = 11
    adj = (rng.random((n, n)) < 0.4).astype(float)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T
    v2f = rng.permutation(n).astype(np.int32)
    np.testing.assert_array_equal(
        perm.comm_mask(_t(adj), _t(v2f, torch.int32), self_loop=self_loop),
        jperm.comm_mask(jnp.asarray(adj), jnp.asarray(v2f),
                        self_loop=self_loop))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_pdistmat(d):
    x = np.random.default_rng(6).normal(size=(10, d)) * 3
    _close(geometry.pdistmat(_t(x)), jgeometry.pdistmat(jnp.asarray(x)))


def test_cdist_and_fast():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(8, 3)) * 5, rng.normal(size=(6, 3)) * 5
    _close(geometry.cdist(_t(a), _t(b)),
           jgeometry.cdist(jnp.asarray(a), jnp.asarray(b)))
    _close(geometry.cdist_fast(_t(a), _t(b)),
           jgeometry.cdist_fast(jnp.asarray(a), jnp.asarray(b)))


def _cloud(kind, rng, n=12):
    p = rng.normal(size=(n, 3)) * 4
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]])
    q = p @ R.T + np.array([1.5, -2.0, 0.5])
    if kind == "scrambled":
        q = q[rng.permutation(n)]
    elif kind == "reflected":
        q = q * np.array([-1.0, 1.0, 1.0])
    elif kind == "noisy":
        q = q + rng.normal(size=q.shape) * 0.1
    return p, q


@pytest.mark.parametrize("kind", ["rotated", "scrambled", "reflected",
                                  "noisy"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_arun_and_align(kind, d, weighted):
    """Compare R and t (not the SVD factors, whose signs are free)."""
    rng = np.random.default_rng(8)
    p, q = _cloud(kind, rng)
    w = (rng.random(p.shape[0]) < 0.7).astype(float) if weighted else None
    R, t = geometry.arun(_t(p), _t(q), None if w is None else _t(w), d=d)
    jR, jt = jgeometry.arun(jnp.asarray(p), jnp.asarray(q),
                            None if w is None else jnp.asarray(w), d=d)
    _close(R, jR)
    _close(t, jt)
    assert np.linalg.det(R.numpy()) == pytest.approx(1.0, abs=1e-10)
    _close(geometry.align(_t(p), _t(q), None if w is None else _t(w), d=d),
           jgeometry.align(jnp.asarray(p), jnp.asarray(q),
                           None if w is None else jnp.asarray(w), d=d))


def test_default_device_is_the_card(monkeypatch):
    """device=None never silently means the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        types.make_formation(np.zeros((3, 3)), np.ones((3, 3)))
    assert types.resolve_device("cpu") == torch.device("cpu")

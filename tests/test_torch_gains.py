"""The ADMM gain design: the reference's `aclswarm_tpu.gains` against the
port's `aclswarm_torch.gains` on the same seeded numpy inputs, on the CPU.

The cases mirror `tests/test_gains.py` (the 4-agent MATLAB goldens, the
9-agent oracle case, the structural invariants, sparse `simform` graphs in
a padded bucket, a planar formation, Newton against eigh, the warm carry,
the batch, the f32 gate) and add what is the port's own: the kernel basis
Q computed on the host, the polled device loops, the carry and parameter
conversion.

Tolerances:
- float64, eigh PSD step: gains atol 1e-12 against the reference's solve
  (two eigh libraries and another matmul order; measured <= 1e-14),
  1e-9 against the numpy oracle and 1e-8 against the goldens, as
  `test_gains.py` holds the reference; ADMM iteration counts, the warm
  carry's ``iters`` and the final residual's integer-valued decisions
  equal; the residual itself rtol 1e-9;
- float32, Newton PSD step: gains atol 1e-5 (entries are O(1): measured
  ~1e-6) against the reference's float32 solve, zero blocks exact and the
  eigenstructure at `validate_gains(tol=2e-4)`, as `tests/test_f32.py`;
- Q, the cold carry, any poll interval: bit for bit; a batch against
  serial solves at the same tolerances (see `TestBatch`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aclswarm_torch import convert
from aclswarm_torch import gains as tg
from aclswarm_torch.core.types import gains_from_flat
from aclswarm_torch.gains import admm as tadmm
from aclswarm_tpu import gains as jg
from aclswarm_tpu.gains import admm as jadmm
from aclswarm_tpu.gains import reference
from aclswarm_tpu.harness import formgen
from test_gains import (GOLD_FC, GOLD_NC, GOLD_SQUARE_PTS, fc_adj,
                        nine_agent_case)

CPU = dict(device="cpu")
ATOL = 1e-12


def _square(case):
    adj = fc_adj(4)
    if case == "nc":
        adj[0, 2] = adj[2, 0] = 0
        adj[1, 3] = adj[3, 1] = 0
    return GOLD_SQUARE_PTS, adj, GOLD_FC if case == "fc" else GOLD_NC


def _both(pts, adj, params=None, **kw):
    """The reference's and the port's solve with telemetry: (A_ref,
    stats_ref, A_port, stats_port) as numpy arrays and stats."""
    jp = None if params is None else reference.AdmmParams(
        **params.__dict__)
    Aj, sj = jg.solve_gains(jnp.asarray(pts), adj, jp, telemetry=True, **kw)
    At, st = tg.solve_gains(pts, adj, params, telemetry=True, **CPU, **kw)
    return np.asarray(Aj), sj, At.numpy(), st


def _assert_same_stats(sj, st):
    assert st.iters == int(sj.iters)
    np.testing.assert_allclose(st.residual, float(sj.residual), rtol=1e-9)


def _simform(n, seed, scale=8.0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * scale
    adj = formgen.random_adjmat(np.random.default_rng(seed), n, fc=False)
    return pts, adj


@pytest.mark.parametrize("case", ["fc", "nc"])
def test_four_agent_golden(case):
    """`test_admm.cpp:26-75`: the MATLAB goldens to 1e-8."""
    pts, adj, gold = _square(case)
    A = tg.solve_gains(pts, adj, **CPU).numpy()
    assert np.linalg.norm(A - gold) < 1e-8


@pytest.mark.parametrize("case", ["fc", "nc"])
def test_four_agent_against_oracle(case):
    pts, adj, _ = _square(case)
    A = tg.solve_gains(pts, adj, **CPU).numpy()
    np.testing.assert_allclose(A, reference.solve_gains(pts, adj), atol=1e-9)


@pytest.mark.parametrize("case", ["fc", "nc"])
def test_four_agent_against_reference_solve(case):
    pts, adj, _ = _square(case)
    Aj, sj, At, st = _both(pts, adj)
    np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
    _assert_same_stats(sj, st)


def test_nine_agents_against_oracle_and_reference():
    p, adj = nine_agent_case()
    Aj, sj, At, st = _both(p, adj)
    np.testing.assert_allclose(At, reference.solve_gains(p, adj), atol=1e-9)
    np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
    _assert_same_stats(sj, st)


class TestInvariants:
    """`test_gains.py::TestInvariants` on the port's solve."""

    def test_zero_blocks(self):
        p, adj = nine_agent_case()
        A = tg.solve_gains(p, adj, **CPU).numpy()
        for i in range(9):
            for j in range(9):
                if i != j and adj[i, j] == 0:
                    assert np.all(A[3 * i:3 * i + 3, 3 * j:3 * j + 3] == 0)

    def test_block_structure(self):
        p, adj = nine_agent_case()
        blk = gains_from_flat(tg.solve_gains(p, adj, **CPU)).numpy()
        np.testing.assert_allclose(blk[..., 0, 0], blk[..., 1, 1], atol=1e-8)
        np.testing.assert_allclose(blk[..., 1, 0], -blk[..., 0, 1],
                                   atol=1e-8)
        for r, c in [(0, 2), (2, 0), (1, 2), (2, 1)]:
            np.testing.assert_allclose(blk[..., r, c], 0.0, atol=1e-8)

    @pytest.mark.parametrize("sparse", [False, True])
    def test_fixed_trace_n20(self, sparse):
        rng = np.random.default_rng(20 + sparse)
        n = 20
        adj = fc_adj(n)
        if sparse:
            adj[0, 5] = adj[5, 0] = 0
            adj[3, 15] = adj[15, 3] = 0
        p = rng.uniform(-5, 5, size=(n, 3))
        Aj, sj, At, st = _both(p, adj)
        assert abs(np.trace(At) - (-3 * (n - 2))) < 1e-8
        np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
        _assert_same_stats(sj, st)

    def test_eigenstructure(self):
        p, adj = nine_agent_case()
        v = tg.validate_gains(tg.solve_gains(p, adj, **CPU), p)
        assert v["no_positive"] and v["kernel_ok"] \
            and v["strictly_negative_rest"], v["eigenvalues"]

    def test_planar_formation_nullity5(self):
        """A flat formation: the 1D kernel is [qz] alone (nullity 5)."""
        rng = np.random.default_rng(3)
        n = 6
        p = np.column_stack([rng.normal(size=(n, 2)) * 3, np.full(n, 1.5)])
        assert tg.planar_of(p) and jg.planar_of(p)
        Aj, sj, At, st = _both(p, fc_adj(n))
        v = tg.validate_gains(At, p)
        assert v["nullity"] == 5
        assert v["no_positive"] and v["kernel_ok"]
        np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
        _assert_same_stats(sj, st)

    def test_desired_formation_in_kernel(self):
        p, adj = nine_agent_case()
        A = tg.solve_gains(p, adj, **CPU).numpy()
        np.testing.assert_allclose(A @ p.reshape(-1), 0.0, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simform_graph_in_padded_bucket(seed):
    """`simform`-shaped random graphs (K_n minus up to n-4 edges) in the
    trial harness's bucket ``max_nonedges=n-4``: the padded slots change
    nothing against the exact bucket, and both equal the reference's."""
    n = 16
    pts, adj = _simform(n, seed, scale=5.0)
    bucketed = tg.solve_gains(pts, adj, max_nonedges=n - 4, **CPU)
    exact = tg.solve_gains(pts, adj, **CPU)
    np.testing.assert_allclose(bucketed.numpy(), exact.numpy(), rtol=0,
                               atol=ATOL)
    Aj, sj, At, st = _both(pts, adj, max_nonedges=n - 4)
    np.testing.assert_array_equal(At, bucketed.numpy())
    np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
    _assert_same_stats(sj, st)


def test_simform100_graph_invariants():
    """`test_gains.py::test_simform100_graph_invariants` at n=100: exact
    zero blocks at the non-edges, the trace, the eigenstructure, and the
    reference's gains and iterations."""
    n = 100
    rng = np.random.default_rng(3)
    adj = formgen.random_adjmat(np.random.default_rng(17), n, fc=False)
    pts = rng.normal(size=(n, 3)) * 10
    Aj, sj, At, st = _both(pts, adj, max_nonedges=n - 4)
    blocks = At.reshape(n, 3, n, 3)
    off = (adj == 0) & ~np.eye(n, dtype=bool)
    assert np.all(blocks.transpose(0, 2, 1, 3)[off] == 0.0)
    np.testing.assert_allclose(np.trace(At), -3 * (n - 2), atol=1e-6)
    v = tg.validate_gains(At, pts)
    assert v["no_positive"] and v["kernel_ok"] \
        and v["strictly_negative_rest"]
    np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
    _assert_same_stats(sj, st)


@pytest.mark.parametrize("scale", ["spectral", "fro"])
def test_newton_against_eigh_and_reference_f64(scale):
    """`test_gains.py::test_newton_psd_matches_eigh_at_f64`: the Newton
    PSD step within 1e-5 of eigh at float64, and equal to the reference's
    Newton solve with either initial scale."""
    pts, adj = _simform(24, 5)
    Ae = tg.solve_gains(pts, adj, tg.AdmmParams(psd_method="eigh"),
                        **CPU).numpy()
    params = tg.AdmmParams(psd_method="newton", newton_scale=scale)
    Aj, sj, At, st = _both(pts, adj, params)
    assert np.abs(At - Ae).max() < 1e-5
    np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
    _assert_same_stats(sj, st)
    v = tg.validate_gains(At, pts)
    assert v["no_positive"] and v["kernel_ok"] \
        and v["strictly_negative_rest"]


def test_psd_eigh_keeps_all_modes_when_none_is_positive():
    """`solver.cpp:301-308`: with no eigenvalue above eps_eig the
    reference keeps every mode (its index k stays 0), so a negative
    definite W comes back whole; otherwise only the modes above eps_eig."""
    rng = np.random.default_rng(0)
    V = np.linalg.qr(rng.normal(size=(6, 6)))[0]
    params = tg.AdmmParams()
    for lam, kept in (([-3, -2, -1, -0.5, -1e-3, 1e-6], [1] * 6),
                      ([-3, -2, 1e-6, 0.5, 2, 4], [0, 0, 0, 1, 1, 1])):
        W = torch.from_numpy((V * lam) @ V.T)[None]
        want = (V * (np.asarray(lam) * kept)) @ V.T
        np.testing.assert_allclose(tadmm._psd_eigh(W, params)[0].numpy(),
                                   want, rtol=0, atol=1e-12)


def test_newton_fixed_budget_against_reference():
    """``newton_tol=0``: all ``newton_iters`` steps, no stall test."""
    pts, adj = _simform(12, 6)
    params = tg.AdmmParams(psd_method="newton", newton_tol=0.0,
                           newton_iters=25)
    Aj, sj, At, st = _both(pts, adj, params)
    np.testing.assert_allclose(At, Aj, rtol=0, atol=ATOL)
    _assert_same_stats(sj, st)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_poll_interval_gives_the_same_bits(dtype):
    """The Newton stall flag read every 1, 3, 7 or 40 steps: steps past
    a formation's end are the identity, so the gains are the same bits."""
    pts, adj = _simform(14, 8)
    pts = pts.astype(dtype)
    params = tg.AdmmParams(psd_method="newton")
    outs = [tg.solve_gains(pts, adj, params, telemetry=True, poll_every=k,
                           **CPU) for k in (1, 3, 7, 40)]
    for A, st in outs[1:]:
        assert torch.equal(A, outs[0][0])
        assert st == outs[0][1]
    rec = tadmm.new_record()
    prob = tadmm.problem(pts[None], adj[None], False, None, "cpu")
    tadmm.solve(prob, params, poll_every=7, rec=rec)
    live = int(sum(int(s.sum()) for s in rec["newton_live"]))
    assert rec["newton_run"] >= live > 0


def test_f32_against_reference_and_invariants():
    """`test_f32.py::test_gain_design_invariants` on the port: float32,
    the Newton path, a sparse graph in the n-4 bucket: zero blocks exact,
    the trace within float32 error, the eigenstructure at tol 2e-4; and
    the reference's float32 gains within 1e-5."""
    n = 40
    rng = np.random.default_rng(2)
    pts = (rng.normal(size=(n, 3)) * 10).astype(np.float32)
    adj = formgen.random_adjmat(np.random.default_rng(2), n, fc=False)
    A = tg.solve_gains(pts, adj, max_nonedges=n - 4, **CPU)
    assert A.dtype == torch.float32
    A = A.numpy()
    blocks = A.reshape(n, 3, n, 3).transpose(0, 2, 1, 3)
    assert np.all(blocks[(adj == 0) & ~np.eye(n, dtype=bool)] == 0.0)
    np.testing.assert_allclose(np.trace(A.astype(np.float64)), -3 * (n - 2),
                               atol=0.2)
    v = tg.validate_gains(A.astype(np.float64), pts.astype(np.float64),
                          tol=2e-4)
    assert v["no_positive"] and v["kernel_ok"] \
        and v["strictly_negative_rest"], v["eigenvalues"][-8:]
    Aj = np.asarray(jg.solve_gains(jnp.asarray(pts), adj,
                                   max_nonedges=n - 4))
    assert Aj.dtype == np.float32
    np.testing.assert_allclose(A, Aj, rtol=0, atol=1e-5)


class TestKernelBasis:
    """Q is computed on the host with LAPACK's gesdd, never by the
    device's SVD: the gains depend on the basis."""

    @pytest.mark.parametrize("n", [12, 100])
    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_q_is_the_references_bit_for_bit(self, n, dtype):
        pts = (np.random.default_rng(n).normal(size=(n, 3)) * 10).astype(
            dtype)
        q2 = tadmm._kernel_2d(pts[:, :2])
        assert q2.dtype == np.dtype(dtype)
        np.testing.assert_array_equal(
            q2, np.asarray(jadmm._kernel_2d(jnp.asarray(pts[:, :2]))))
        for planar in (False, True):
            np.testing.assert_array_equal(
                tadmm._kernel_1d(pts[:, 2], planar),
                np.asarray(jadmm._kernel_1d(jnp.asarray(pts[:, 2]), planar)))

    def _solve_with(self, q2):
        pts, adj = _simform(12, 4)
        prob = tadmm.problem(pts[None], adj[None], False, None, "cpu")
        if q2 is not None:
            prob = prob._replace(q2=q2(prob.q2))
        return tadmm.solve(prob, tg.AdmmParams())[0][0]

    def test_a_rotation_breaking_j_moves_the_gains(self):
        """Another orthonormal basis of the same kernel complement: a
        random rotation R moves the gains by far more than any tolerance
        (why cuSOLVER's basis is not used), while a rotation commuting
        with the complex structure J leaves them within rounding."""
        base = self._solve_with(None)
        dm = base.shape[0] // 3 * 2 - 4
        rng = np.random.default_rng(0)
        R = torch.from_numpy(np.linalg.qr(rng.normal(size=(dm, dm)))[0])
        moved = self._solve_with(lambda q: q @ R)
        assert (moved - base).abs().max().item() > 1e-2
        # block-diagonal 2 x 2 rotations commute with J
        th = rng.uniform(0, 2 * np.pi, dm // 2)
        Rj = torch.zeros(dm, dm, dtype=torch.float64)
        for k, t in enumerate(th):
            Rj[2 * k:2 * k + 2, 2 * k:2 * k + 2] = torch.tensor(
                [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
        kept = self._solve_with(lambda q: q @ Rj)
        assert (kept - base).abs().max().item() < 1e-10


class TestWarmStart:
    """`test_gains.py::TestWarmStart` on the port, each against the
    reference's carry."""

    def _pair(self, n=12):
        pts_a = np.random.default_rng(11).normal(size=(n, 3)) * 5
        pts_b = pts_a + np.random.default_rng(12).normal(size=(n, 3)) * 0.5
        return pts_a, pts_b, fc_adj(n)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_cold_carry_is_bitwise_cold(self, dtype):
        pts_a, _, adj = self._pair()
        cold = tg.solve_gains(pts_a, adj, **CPU)
        carry0 = tg.init_carry(len(pts_a), tg.planar_of(pts_a), dtype=dtype,
                               **CPU)
        warm, new_carry = tg.solve_gains(pts_a, adj, carry=carry0, **CPU)
        assert torch.equal(warm, cold)
        assert isinstance(new_carry, tg.AdmmCarry)
        assert new_carry.iters.dtype == torch.int32

    def test_warm_resolve_against_reference(self):
        """A carried fixed point re-converges in fewer iterations than
        cold, with the reference's iteration counts and carry."""
        pts_a, pts_b, adj = self._pair()
        jc0 = jg.init_carry(len(pts_a), jg.planar_of(pts_a))
        _, jca = jg.solve_gains(pts_a, adj, carry=jc0)
        jwb, jcb, jst = jg.solve_gains(pts_b, adj, carry=jca, telemetry=True)
        tc0 = tg.init_carry(len(pts_a), tg.planar_of(pts_a),
                            dtype=torch.float64, **CPU)
        _, tca = tg.solve_gains(pts_a, adj, carry=tc0, **CPU)
        assert int(tca.iters) == int(jca.iters)
        twb, tcb, tst = tg.solve_gains(pts_b, adj, carry=tca, telemetry=True,
                                       **CPU)
        cold_b, cold_st = tg.solve_gains(pts_b, adj, telemetry=True, **CPU)
        assert tst.iters < cold_st.iters
        _assert_same_stats(jst, tst)
        assert int(tcb.iters) == int(jcb.iters) == tst.iters
        np.testing.assert_allclose(twb.numpy(), np.asarray(jwb), rtol=0,
                                   atol=ATOL)
        for k in ("x2", "s2", "x1", "s1"):
            np.testing.assert_allclose(getattr(tcb, k).numpy(),
                                       np.asarray(getattr(jcb, k)), rtol=0,
                                       atol=1e-10, err_msg=k)
        np.testing.assert_allclose(twb.numpy(), cold_b.numpy(), atol=5e-3)

    def test_carry_crosses_between_packages(self):
        """A reference carry seeds the port's solve through `convert`, and
        gives what the same solve from the port's own carry gives."""
        pts_a, pts_b, adj = self._pair()
        _, jca = jg.solve_gains(pts_a, adj, carry=jg.init_carry(
            len(pts_a), jg.planar_of(pts_a)))
        tca = convert.admm_carry_from_numpy(
            {k: np.asarray(v) for k, v in jca._asdict().items()},
            dtype=torch.float64, **CPU)
        assert tca.iters.dtype == torch.int32
        back = convert.admm_carry_to_numpy(tca)
        for k, v in jca._asdict().items():
            np.testing.assert_array_equal(back[k], np.asarray(v))
        jwb, _ = jg.solve_gains(pts_b, adj, carry=jca)
        twb, _ = tg.solve_gains(pts_b, adj, carry=tca, **CPU)
        np.testing.assert_allclose(twb.numpy(), np.asarray(jwb), rtol=0,
                                   atol=ATOL)

    def test_carry_of_another_size_raises(self):
        pts_a, _, adj = self._pair()
        with pytest.raises(ValueError, match="same size and planarity"):
            tg.solve_gains(pts_a, adj, carry=tg.init_carry(
                len(pts_a) + 1, **CPU), **CPU)


class TestBatch:
    def _batch(self, n=10, B=3):
        pts = np.random.default_rng(4).normal(size=(B, n, 3)) * 4
        adjs = np.stack([fc_adj(n)] * B)
        adjs[1, 0, 3] = adjs[1, 3, 0] = 0     # distinct graphs, one bucket
        adjs[2, 2, 7] = adjs[2, 7, 2] = 0
        adjs[2, 1, 5] = adjs[2, 5, 1] = 0
        return pts, adjs

    def test_batch_against_serial(self):
        """Each formation of the batch equals its serial solve in the same
        bucket at ATOL. Not bit for bit in general, on the CPU either: a
        formation's products inside the batch may round otherwise than
        its lone products (at this size the eigh path came out equal, the
        Newton path 1-2 ulp apart)."""
        pts, adjs = self._batch()
        batched = tg.solve_gains_batch(pts, adjs, max_nonedges=2, **CPU)
        assert batched.shape == (3, 30, 30)
        for b in range(3):
            serial = tg.solve_gains(pts[b], adjs[b], max_nonedges=2, **CPU)
            np.testing.assert_allclose(batched[b].numpy(), serial.numpy(),
                                       rtol=0, atol=ATOL, err_msg=str(b))

    def test_batch_against_reference_batch(self):
        pts, adjs = self._batch()
        jb = np.asarray(jg.solve_gains_batch(pts, adjs))
        tb = tg.solve_gains_batch(pts, adjs, **CPU).numpy()
        np.testing.assert_allclose(tb, jb, rtol=0, atol=ATOL)

    def test_formations_stop_on_their_own_flags(self):
        """Formations whose Newton loops end at different steps, float32:
        each matches its serial solve at 1e-6 (steps past a formation's
        end are gated off; rounding as in `test_batch_against_serial`)."""
        pts, adjs = self._batch()
        pts = pts.astype(np.float32)
        pts[1] *= 3.0
        params = tg.AdmmParams(psd_method="newton")
        rec = tadmm.new_record()
        prob = tadmm.problem(pts, adjs, False, 2, "cpu")
        flat, _, iters, _ = tadmm.solve(prob, params, poll_every=5, rec=rec)
        lives = torch.stack(rec["newton_live"])
        assert (lives != lives[:, :1]).any() or (iters != iters[0]).any()
        for b in range(3):
            serial = tg.solve_gains(pts[b], adjs[b], params, max_nonedges=2,
                                    **CPU)
            np.testing.assert_allclose(flat[b].numpy(), serial.numpy(),
                                       rtol=0, atol=1e-6, err_msg=str(b))

    def test_batch_refuses_what_the_reference_refuses(self):
        pts, adjs = self._batch()
        with pytest.raises(ValueError, match="stacked"):
            tg.solve_gains_batch(pts[0], adjs[0], **CPU)
        with pytest.raises(ValueError, match="bucket"):
            tg.solve_gains_batch(pts, adjs, max_nonedges=1, **CPU)
        pts[0, :, 2] = 1.5                    # one flat formation
        with pytest.raises(ValueError, match="planarity"):
            tg.solve_gains_batch(pts, adjs, **CPU)


class TestF32Gate:
    def test_gate_keeps_the_f32_solve(self):
        """`test_gains.py::test_f32_gate_validates_or_falls_back`: the
        kept gains pass the float32 check, with the reference's verdict."""
        pts, adj = nine_agent_case()
        g, report = tg.solve_gains_f32(pts, adj, **CPU)
        _, jreport = jg.solve_gains_f32(pts, adj)
        assert report["f32_ok"] == jreport["f32_ok"] is True
        assert g.dtype == torch.float32
        v = tg.validate_gains(g, pts, tol=1e-4)
        assert v["no_positive"] and v["kernel_ok"] \
            and v["strictly_negative_rest"]

    def test_failed_gate_solves_again_in_the_points_dtype(self):
        """A check no float32 solve passes (tol=0): the float64 solve is
        kept, on the same device, with its carry."""
        pts, adj = nine_agent_case()
        carry = tg.init_carry(9, tg.planar_of(pts), dtype=torch.float64,
                              **CPU)
        g, new_carry, report = tg.solve_gains_f32(pts, adj, carry=carry,
                                                  tol=0.0, **CPU)
        assert report["f32_ok"] is False
        assert g.dtype == torch.float64 and g.device.type == "cpu"
        ref, ref_carry = tg.solve_gains(pts, adj, carry=carry, **CPU)
        assert torch.equal(g, ref)
        assert torch.equal(new_carry.x2, ref_carry.x2)


def test_solve_stats_against_reference():
    """`AdmmSolveStats`: both subproblems' iterations and the worse final
    residual, as the reference reports them."""
    pts, adj = _simform(10, 9)
    Aj, sj, At, st = _both(pts, adj)
    assert isinstance(st, tg.AdmmSolveStats)
    _assert_same_stats(sj, st)
    assert st.iters <= 2 * tg.AdmmParams().max_itr


def test_validate_gains_matches_reference():
    p, adj = nine_agent_case()
    A = np.array(jg.solve_gains(p, adj))
    A[0, 0] += 1e-3                          # one perturbed entry
    for tol in (1e-6, 1e-2):
        mine = tg.validate_gains(A, p, tol=tol)
        ref = jg.validate_gains(A, p, tol=tol)
        for k in ("no_positive", "kernel_ok", "strictly_negative_rest",
                  "nullity"):
            assert mine[k] == ref[k], k
        np.testing.assert_array_equal(mine["eigenvalues"], ref["eigenvalues"])


def test_solve_gains_blocks_layout():
    p, adj = nine_agent_case()
    blocks = tg.solve_gains_blocks(p, adj, **CPU)
    assert blocks.shape == (9, 9, 3, 3)
    np.testing.assert_allclose(blocks.numpy(), np.asarray(
        jg.solve_gains_blocks(p, adj)), rtol=0, atol=ATOL)


def test_params_cross_by_field():
    ref = reference.AdmmParams(thresh=3e-4, max_itr=7, psd_method="newton",
                               newton_scale="fro")
    mine = convert.admm_params_from_numpy(ref)
    assert mine == tg.AdmmParams(thresh=3e-4, max_itr=7,
                                 psd_method="newton", newton_scale="fro")
    assert {f for f in tg.AdmmParams.__dataclass_fields__} \
        == {f for f in reference.AdmmParams.__dataclass_fields__}
    assert tg.AdmmParams() == convert.admm_params_from_numpy(
        reference.AdmmParams())


@pytest.mark.parametrize("kw, exc, match", [
    (dict(check_mode="on"), NotImplementedError, "invariants"),
    (dict(check_mode="sometimes"), ValueError, "check_mode"),
    (dict(max_nonedges=1), ValueError, "bucket"),
    (dict(params=tg.AdmmParams(psd_method="newton", newton_scale="x")),
     ValueError, "newton_scale"),
])
def test_refusals(kw, exc, match):
    p, adj = nine_agent_case()
    with pytest.raises(exc, match=match):
        tg.solve_gains(p, adj, **kw, **CPU)


def test_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, adj = nine_agent_case()
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.solve_gains(p, adj)
    A = tg.solve_gains(torch.as_tensor(p), adj)     # a CPU tensor: the CPU
    assert A.device.type == "cpu" and A.dtype == torch.float64

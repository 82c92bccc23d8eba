"""The port's two gain oracles (`aclswarm_torch.gains.reference`, the
sequential NumPy ADMM, and `aclswarm_torch.gains.sdp`, the original-SDP
formulation) against the reference package's on `tests/test_sdp.py`'s
inputs, bit for bit; then that file's cross-validation of the ADMM
design's quality against the SDP optimum with the port's ADMM (float64,
CPU)."""
import numpy as np
import pytest
import torch

from aclswarm_torch.gains import admm as t_admm
from aclswarm_torch.gains import params as t_params
from aclswarm_torch.gains import reference as t_reference
from aclswarm_torch.gains import sdp as t_sdp
from aclswarm_tpu.gains import reference as j_reference
from aclswarm_tpu.gains import sdp as j_sdp

torch.set_num_threads(1)  # tiny tensors: threads only contend across workers

SQUARE = np.array([[0., 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]])
SQUARE3D = np.array([[0., 0, 0], [2, 0, 1], [2, 2, 0], [0, 2, 1]])
FC4 = np.ones((4, 4)) - np.eye(4)
CYCLE4 = np.array([[0, 1, 0, 1], [1, 0, 1, 0],
                   [0, 1, 0, 1], [1, 0, 1, 0]], float)


def hexagon(z=None):
    ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    pts = np.stack([2 * np.cos(ang), 2 * np.sin(ang), np.zeros(6)], 1)
    if z is not None:
        pts[:, 2] = z
    return pts


def seeded(seed, n=5):
    """A seeded non-flat formation on a seeded connected graph."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-4, 4, size=(n, 3))
    adj = (rng.random((n, n)) < 0.7).astype(float)
    adj = np.triu(adj, 1)
    for i in range(n - 1):
        adj[i, i + 1] = 1.0
    return pts, adj + adj.T


CASES = [(SQUARE, FC4), (SQUARE3D, FC4), (SQUARE, CYCLE4),
         (hexagon(), np.ones((6, 6)) - np.eye(6)),
         (hexagon(z=[0, 1, 0, 1, 0, 1]), np.ones((6, 6)) - np.eye(6)),
         seeded(0), seeded(1)]
IDS = ["square-fc", "square3d-fc", "square-cycle", "hexagon-fc",
       "hexagon3d-fc", "seeded0", "seeded1"]


def test_admm_params_is_the_ports_one_class():
    assert t_reference.AdmmParams is t_params.AdmmParams
    assert t_reference.AdmmParams() == t_params.AdmmParams()


@pytest.mark.parametrize("pts,adj", CASES, ids=IDS)
def test_reference_solver_bit_for_bit(pts, adj):
    """The sequential NumPy ADMM: gains, and the 2D and 1D subproblems,
    equal the reference package's to the last bit."""
    np.testing.assert_array_equal(t_reference.solve_gains(pts, adj),
                                  j_reference.solve_gains(pts, adj))
    for tp, jp in ((t_params.AdmmParams(), j_reference.AdmmParams()),
                   (t_params.AdmmParams(max_itr=3, eps_eig=1e-3),
                    j_reference.AdmmParams(max_itr=3, eps_eig=1e-3))):
        np.testing.assert_array_equal(
            t_reference.solve2d(pts[:, :2], adj, tp),
            j_reference.solve2d(pts[:, :2], adj, jp))
        np.testing.assert_array_equal(
            t_reference.solve1d(pts[:, 2], adj, tp),
            j_reference.solve1d(pts[:, 2], adj, jp))


def test_build_constraints_bit_for_bit():
    pts, adj = SQUARE3D, CYCLE4
    q = np.linalg.svd(np.column_stack([pts[:, 2], np.ones(4)]))[0][:, 2:]
    for t, j in zip(t_reference.build_constraints(1, 2, 4, adj, q),
                    j_reference.build_constraints(1, 2, 4, adj, q)):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("pts,adj", CASES, ids=IDS)
def test_sdp_oracle_bit_for_bit(pts, adj):
    """The SDP oracle: kernel basis, projector, solution and spectral gap
    equal the reference package's to the last bit."""
    (tn, tnull), (jn, jnull) = t_sdp.kernel_basis(pts), j_sdp.kernel_basis(
        pts)
    np.testing.assert_array_equal(tn, jn)
    assert tnull == jnull
    rng = np.random.default_rng(7)
    M = rng.standard_normal((3 * len(pts), 3 * len(pts)))
    np.testing.assert_array_equal(
        t_sdp.feasible_projector(pts, adj)(M.copy()),
        j_sdp.feasible_projector(pts, adj)(M.copy()))
    A_t = t_sdp.solve_sdp_gains(pts, adj, iters=120, seed=2)
    A_j = j_sdp.solve_sdp_gains(pts, adj, iters=120, seed=2)
    np.testing.assert_array_equal(A_t, A_j)
    assert t_sdp.spectral_gap(A_t, tnull) == j_sdp.spectral_gap(A_j, jnull)


@pytest.mark.parametrize("pts,adj,nullity", [
    (SQUARE, FC4, 5), (SQUARE3D, FC4, 6), (SQUARE, CYCLE4, 5)])
def test_sdp_feasibility_and_eigenstructure(pts, adj, nullity):
    """`tests/test_sdp.py`'s oracle check, with the port's
    `validate_gains`."""
    A = t_sdp.solve_sdp_gains(pts, adj, iters=600)
    N, nl = t_sdp.kernel_basis(pts)
    assert nl == nullity
    assert np.abs(A @ N).max() < 1e-12
    v = t_admm.validate_gains(A, pts, tol=1e-4)
    assert v["no_positive"] and v["kernel_ok"] \
        and v["strictly_negative_rest"]


@pytest.mark.parametrize("pts,adj", [
    (SQUARE, FC4), (SQUARE3D, FC4), (SQUARE, CYCLE4),
    (hexagon(), np.ones((6, 6)) - np.eye(6))],
    ids=["square-fc", "square3d-fc", "square-cycle", "hexagon-fc"])
def test_port_admm_quality_vs_sdp_optimum(pts, adj):
    """`tests/test_sdp.py::test_admm_quality_vs_sdp_optimum` with the
    port's device ADMM (float64 on the CPU): its spectral gap within
    [0.5, 1.05] of the SDP's."""
    _, nullity = t_sdp.kernel_basis(pts)
    gap_sdp = t_sdp.spectral_gap(
        t_sdp.solve_sdp_gains(pts, adj, iters=800), nullity)
    A = t_admm.solve_gains(np.asarray(pts, np.float64), adj, device="cpu")
    gap_admm = t_sdp.spectral_gap(A.numpy(), nullity)
    assert gap_sdp > 0.1
    ratio = gap_admm / gap_sdp
    assert 0.5 <= ratio <= 1.05, ratio


def test_port_admm_gains_near_feasible_for_sdp():
    """`tests/test_sdp.py::test_admm_gains_near_feasible_for_sdp` with the
    port's ADMM: projecting its gains onto the SDP's constraint subspace
    barely changes them."""
    adj = FC4.copy()
    adj[0, 2] = adj[2, 0] = 0
    A = t_admm.solve_gains(SQUARE3D, adj, device="cpu").numpy()
    P_V = t_sdp.feasible_projector(SQUARE3D, adj)
    assert np.abs(P_V(A.copy()) - A).max() < 1e-8


@pytest.mark.parametrize("pts,adj", CASES, ids=IDS)
def test_port_admm_matches_the_ported_oracle(pts, adj):
    """The port's device ADMM (float64, CPU, the eigh PSD step) against
    its own copy of the sequential oracle."""
    A = t_admm.solve_gains(np.asarray(pts, np.float64), adj, device="cpu")
    np.testing.assert_allclose(A.numpy(), t_reference.solve_gains(pts, adj),
                               atol=1e-9)

"""Second, independent gain-design oracle: the 'original' SDP formulation
(port of `aclswarm_tpu/gains/sdp.py`, a copy of its NumPy code).

The reference validates its ADMM gain solver against an *independent*
formulation — `solve_original_sdp` (`aclswarm/src/aclswarm/control.py:11-104`,
Fathian et al., ICRA'18; MATLAB `SDPGainDesign3D_Original.m`): over the full
(3n, 3n) symmetric gain matrix A,

    maximize    lambda_min(Q^T A Q)
    subject to  A N = 0                      (kernel: formation + rigid modes)
                A_ij block = 0, (i,j) non-edge, i != j   (sparsity)
                edge blocks [[a, b, 0], [-b, a, 0], [0, 0, c]]  (structure)
                ||A|| <= 10                  (scale bound)

with N = [q, rot90(q), q_xy, 1x, 1y, 1z] (nullity 5 when the formation is
flat) and Q = an orthonormal basis of N's complement. The reference hands
this to CVXPY/SCS; that stack isn't available here, and more importantly a
second oracle should not share machinery with the solver under test — so
this implementation is plain NumPy **projected supergradient ascent**:

- every structural constraint is a linear subspace with a closed-form
  orthogonal projector (symmetry; `A -> (I-P_N) A (I-P_N)` for the kernel;
  masked block-structure averaging), and by Halperin's theorem cyclic
  projection onto the subspaces converges to the projection onto their
  intersection V;
- lambda_min(Q^T A Q) is concave with supergradient Q v v^T Q^T (v = unit
  eigenvector of the smallest eigenvalue), so ascent iterates
  A <- renormalize(P_V(A + step * Q v v^T Q^T)) converge to the optimum on
  the norm sphere (the objective is positively homogeneous, so the optimum
  saturates the norm bound; we keep ||A||_F = rho and the reference's
  post-normalization by max|A| makes the bound's flavor irrelevant).

This is *slow* (an eigendecomposition per ascent step) and meant purely as
a cross-validation oracle: the device ADMM (`aclswarm_torch.gains.admm`)
and this solver share no formulation, no code path, and no failure modes.
Post-processing mirrors the reference: negate to NSD, scale by max |entry|,
re-symmetrize (`control.py:96-104`).
"""
from __future__ import annotations

import numpy as np

THR_PLANAR = 1e-2  # same flatness test as the reference (`control.py:57`)


def kernel_basis(points: np.ndarray) -> tuple[np.ndarray, int]:
    """N = [q, rot90(q), q_xy, 1x, 1y, 1z] and its rank (3n - dim of the
    gain row space); drops to 5 independent columns for flat formations
    (`control.py:36-66`)."""
    q = np.asarray(points, float)
    n = q.shape[0]
    R = np.array([[0., -1, 0], [1, 0, 0], [0, 0, 1]])
    qbar = q @ R.T
    qp = q.copy()
    qp[:, 2] = 0
    one = np.zeros((3, 3 * n))
    for a in range(3):
        one[a, a::3] = 1.0
    N = np.column_stack([q.reshape(-1), qbar.reshape(-1), qp.reshape(-1),
                         one[0], one[1], one[2]])
    nullity = 5 if np.std(q[:, 2]) <= THR_PLANAR else 6
    return N, nullity


def _structure_projector(adj: np.ndarray):
    """Closed-form orthogonal projection onto the structure subspace:
    zero non-edge off-diagonal blocks, and edge blocks of the form
    [[a, b, 0], [-b, a, 0], [0, 0, c]] (`control.py:70-88`). Diagonal
    blocks are unconstrained (adj diagonal is zero and S excludes it)."""
    adj = np.asarray(adj) != 0
    n = adj.shape[0]
    offdiag = ~np.eye(n, dtype=bool)
    nonedge = (~adj) & offdiag
    edge = adj & offdiag

    def proj(A):
        B = A.reshape(n, 3, n, 3).transpose(0, 2, 1, 3).copy()  # (n,n,3,3)
        B[nonedge] = 0.0
        blk = B[edge]                      # (m, 3, 3)
        a = (blk[:, 0, 0] + blk[:, 1, 1]) / 2
        b = (blk[:, 0, 1] - blk[:, 1, 0]) / 2
        c = blk[:, 2, 2]
        out = np.zeros_like(blk)
        out[:, 0, 0] = a
        out[:, 1, 1] = a
        out[:, 0, 1] = b
        out[:, 1, 0] = -b
        out[:, 2, 2] = c
        B[edge] = out
        return B.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)

    return proj


def feasible_projector(points: np.ndarray, adj: np.ndarray, cycles: int = 40):
    """P_V: cyclic projection onto {symmetric} ∩ {A N = 0} ∩ {structure}.

    All three are linear subspaces, so cycling their closed-form projectors
    converges to the orthogonal projection onto the intersection
    (Halperin); ``cycles`` is chosen so the residual is far below the
    ascent step sizes."""
    N, nullity = kernel_basis(points)
    # range basis truncated to N's actual rank: for flat formations N has
    # 6 columns but rank 5 (q_xy == q), and the rank-deficient singular
    # vector must NOT be projected out of A's row space
    U = np.linalg.svd(N, full_matrices=False)[0][:, :nullity]
    P_struct = _structure_projector(adj)

    def proj(A):
        for _ in range(cycles):
            A = (A + A.T) / 2
            A = A - U @ (U.T @ A)
            A = A - (A @ U) @ U.T
            A = P_struct(A)
        return A

    return proj


def solve_sdp_gains(points: np.ndarray, adj: np.ndarray, rho: float = 10.0,
                    iters: int = 1500, seed: int = 0,
                    verbose: bool = False) -> np.ndarray:
    """Solve the original-SDP gain design by projected supergradient ascent.

    Returns the (3n, 3n) NSD gain matrix, post-processed exactly like the
    reference (`control.py:96-104`): negated, scaled by max |entry|,
    symmetrized. Deterministic for a given seed.
    """
    points = np.asarray(points, float)
    adj = np.asarray(adj)
    n = points.shape[0]
    N, nullity = kernel_basis(points)
    Usvd = np.linalg.svd(N)[0]
    Q = Usvd[:, nullity:]
    P_V = feasible_projector(points, adj)

    # feasible, nonzero start: project the identity-on-complement
    rng = np.random.default_rng(seed)
    A = P_V(Q @ Q.T + 0.01 * rng.standard_normal((3 * n, 3 * n)))
    A *= rho / max(np.linalg.norm(A), 1e-12)

    best, best_val = A, -np.inf
    for t in range(iters):
        M = Q.T @ A @ Q
        w, V = np.linalg.eigh(M)
        lam, v = w[0], V[:, 0]
        if lam > best_val:
            best, best_val = A, lam
        # supergradient of lambda_min at A, lifted to full space
        g = np.outer(Q @ v, Q @ v)
        step = rho * 2.0 / (t + 10)     # diminishing, scale-matched
        A = P_V(A + step * g)
        nrm = np.linalg.norm(A)
        if nrm > 1e-12:
            A *= rho / nrm
        if verbose and t % 100 == 0:
            print(f"  sdp iter {t}: lambda_min = {lam:.6f}")

    # final polish: the per-step cyclic projection converges only linearly,
    # so drive the constraint residual to machine precision once at the end
    best = feasible_projector(points, adj, cycles=400)(best)
    Ar = -best
    Ar /= np.max(np.abs(Ar))
    return (Ar + Ar.T) / 2


def spectral_gap(A: np.ndarray, nullity: int) -> float:
    """Quality metric: |largest non-kernel eigenvalue| of the NSD gain
    matrix after unit max-|entry| normalization — the formation's
    convergence rate. Larger is better; the SDP maximizes exactly this."""
    A = np.asarray(A, float)
    A = A / np.max(np.abs(A))
    w = np.sort(np.linalg.eigvalsh((A + A.T) / 2))
    return float(-w[len(w) - nullity - 1])

"""Sequential NumPy mirror of the reference ADMM gain solver: the oracle
(port of `aclswarm_tpu/gains/reference.py`, a copy of its NumPy code).

A faithful host-side replication of `aclswarm/lib/admm/src/solver.cpp`
(which itself matches the MATLAB ground truth `ADMMGainDesign3D.m` to 1e-8,
`aclswarm/test/test_admm.cpp`). The port's device solver
(`aclswarm_torch.gains.admm`) can be held against it with no other
package installed.

Algorithm (Fathian et al.; `lib/admm/doc/report.pdf` in the reference):
the 3D gain design splits into an independent 2D (xy, complex-structured
blocks) and 1D (z) subproblem recombined by block interleaving
(`solver.cpp:28-79`). Each subproblem is a sparse SDP

    find X = [[t*I, I], [I, Abar]] >= 0,  A vec(X) = b

where Abar is the gain matrix expressed in the orthogonal complement Q of the
desired-formation kernel, with structure / zero-gain / trace / symmetry
constraints assembled row-by-row (`solver.cpp:351-694`), solved by ~10
iterations of dual-update ADMM with a PSD projection (`solver.cpp:264-347`),
then a final projection with S=0 and recovery Aopt = -Q Abar Q^T.

`AdmmParams` is the port's one class (`gains.params`), re-exported here.
"""
from __future__ import annotations

import numpy as np

from aclswarm_torch.gains.params import AdmmParams

__all__ = ["AdmmParams", "build_constraints", "admm_iterations", "solve2d",
           "solve1d", "solve_gains"]


def _vec(X: np.ndarray) -> np.ndarray:
    """Column-major vectorization (Eigen's storage order, `solver.cpp:229`)."""
    return X.reshape(-1, order="F")


def _unvec(x: np.ndarray, rows: int) -> np.ndarray:
    return x.reshape(rows, -1, order="F")


def _prune(X: np.ndarray, thr: float) -> np.ndarray:
    """Eigen `.pruned(1, thr)` / `.sparseView(1, thr)`: zero |x| <= thr."""
    return np.where(np.abs(X) > thr, X, 0.0)


def build_constraints(d: int, m: int, n: int, adj: np.ndarray,
                      Q: np.ndarray):
    """Assemble C, A, b, X0 — mirror of `Solver::parse` (`solver.cpp:351-694`).

    Returns dense (C, A, b, X0) with A of shape (rows, (2dm)^2) over the
    column-major vec of X.
    """
    dm = d * m
    sz = 2 * dm

    def vecsel(i, j):
        return j * sz + i

    rows_A = []
    rows_b = {}

    def new_row(entries):
        r = np.zeros(sz * sz)
        for c, v in entries:
            r[c] += v
        rows_A.append(r)
        return len(rows_A) - 1

    # X_11: diagonal entries equal the (0, 0) entry (solver.cpp:434-448)
    for i in range(1, dm):
        new_row([(0, 1.0), (vecsel(i, i), -1.0)])
    # X_11: upper-triangular off-diagonals are zero (solver.cpp:450-460)
    for i in range(dm):
        for j in range(i + 1, dm):
            new_row([(vecsel(i, j), 1.0)])

    # X_12 == I (solver.cpp:482-500)
    for i in range(dm):
        for j in range(dm):
            r = new_row([(vecsel(i, dm + j), 1.0)])
            if i == j:
                rows_b[r] = 1.0

    # X_22 structure constraints, d=2 only: blocks [a b; -b a]
    # (solver.cpp:519-561)
    if d == 2:
        for i in range(m):
            for j in range(i, m):
                new_row([(vecsel(dm + 2 * i, dm + 2 * j), 1.0),
                         (vecsel(dm + 2 * i + 1, dm + 2 * j + 1), -1.0)])
                if i == j:
                    # b == 0 on diagonal blocks
                    new_row([(vecsel(dm + 2 * i, dm + 2 * j + 1), 1.0)])
                else:
                    # b + (-b) == 0 across the block anti-diagonal
                    new_row([(vecsel(dm + 2 * i, dm + 2 * j + 1), 1.0),
                             (vecsel(dm + 2 * i + 1, dm + 2 * j), 1.0)])

    # zero-gain constraints for non-edges, projected through Q
    # (solver.cpp:563-607): entry (d*j + s, d*i) of Q Abar Q^T must vanish
    for i in range(n):
        for j in range(i + 1, n):
            if adj[i, j] == 1:
                continue
            for s in range(d if d == 2 else 1):
                ii = d * i + s
                jj = d * j
                # QQ[ki, kj] = Q[jj, ki] * Q[ii, kj]
                QQ = np.outer(Q[jj, :], Q[ii, :])
                entries = [(vecsel(dm + ki, dm + kj), QQ[ki, kj])
                           for ki in range(dm) for kj in range(dm)]
                new_row(entries)

    # trace(Abar) == d*m (solver.cpp:609-623)
    r = new_row([(vecsel(dm + i, dm + i), 1.0) for i in range(dm)])
    rows_b[r] = float(dm)

    # full-X symmetry (solver.cpp:643-654)
    for i in range(sz):
        for j in range(i + 1, sz):
            new_row([(vecsel(i, j), 1.0), (vecsel(j, i), -1.0)])

    A = np.asarray(rows_A)
    b = np.zeros(A.shape[0])
    for r, v in rows_b.items():
        b[r] = v

    C = np.zeros((sz, sz))
    C[:dm, :dm] = np.eye(dm)

    X0 = np.zeros((sz, sz))
    X0[:dm, :dm] = np.eye(dm)
    X0[dm:, :dm] = np.eye(dm)
    X0[:dm, dm:] = np.eye(dm)
    X0[dm:, dm:] = np.eye(dm)
    return C, A, b, X0


def admm_iterations(C, A, b, X, params: AdmmParams):
    """Mirror of `Solver::admm` (`solver.cpp:264-347`)."""
    mu = params.mu
    dm = X.shape[0] // 2
    AAs = A @ A.T
    S = np.zeros_like(X)

    def solve_y(e):
        # any solution works: A^T y is invariant across solutions of the
        # (possibly singular, consistent) normal system
        return np.linalg.lstsq(AAs, e, rcond=None)[0]

    for _ in range(params.max_itr):
        D = C - S - mu * X
        e = A @ _vec(D) + mu * b
        y = solve_y(e)

        dvec = _prune(A.T @ y, params.thr_sparse_zero)
        W = C - _unvec(dvec, X.shape[0]) - mu * X
        W = (W + W.T) / 2.0

        # PSD part: keep modes with eigenvalue > epsEig. NOTE the reference
        # quirk (solver.cpp:301-308): if NO eigenvalue exceeds epsEig, its
        # `k` stays 0 and it keeps *everything*; reproduced faithfully.
        lam, V = np.linalg.eigh(W)
        above = np.nonzero(lam > params.eps_eig)[0]
        k = int(above[0]) if above.size else 0
        Vp = V[:, k:]
        S = _prune(Vp @ (lam[k:][:, None] * Vp.T), params.thr_sparse_zero)

        Xold = X
        X = (S - W) / mu

        if np.sum(np.abs(X - Xold)) < params.thresh:
            break
        tr = np.trace(X[dm:, dm:])
        # signed comparison, as in solver.cpp:328-329
        if (tr - dm) / dm < params.thresh_tr:
            break

    # final projection enforcing the affine constraints exactly (S = 0)
    D = C - mu * X
    y = solve_y(A @ _vec(D) + mu * b)
    dvec = _prune(A.T @ y, params.thr_sparse_zero)
    W = C - _unvec(dvec, X.shape[0]) - mu * X
    W = (W + W.T) / 2.0
    return -W / mu


def _subproblem(d, m, n, adj, Q, params):
    C, A, b, X0 = build_constraints(d, m, n, adj, Q)
    X = admm_iterations(C, A, b, X0, params)
    dm = d * m
    Aopt = -Q @ X[dm:, dm:] @ Q.T
    return _prune(Aopt, params.thr_sparse_zero)


def solve2d(pts_xy: np.ndarray, adj: np.ndarray,
            params: AdmmParams) -> np.ndarray:
    """2D subproblem (`solver.cpp:151-211`): kernel [q, rot90(q), 1x, 1y]."""
    n = adj.shape[0]
    m = n - 2
    q = pts_xy.reshape(-1)                       # [x0, y0, x1, y1, ...]
    qbar = np.stack([-pts_xy[:, 1], pts_xy[:, 0]], 1).reshape(-1)
    ex = np.tile([1.0, 0.0], n)
    ey = np.tile([0.0, 1.0], n)
    N = np.column_stack([q, qbar, ex, ey])
    U = np.linalg.svd(N, full_matrices=True)[0]
    Q = U[:, 4:]
    return _subproblem(2, m, n, adj, Q, params)


def solve1d(pts_z: np.ndarray, adj: np.ndarray,
            params: AdmmParams) -> np.ndarray:
    """1D subproblem (`solver.cpp:85-147`): kernel [qz, 1] (or [qz] if the
    formation is flat per thrPlanar)."""
    n = adj.shape[0]
    qz = np.asarray(pts_z).reshape(-1)
    stdev = np.sqrt(np.sum((qz - qz.mean()) ** 2) / (n - 1))
    if stdev < params.thr_planar:
        N = qz[:, None]
    else:
        N = np.column_stack([qz, np.ones(n)])
    dim_ker = N.shape[1]
    U = np.linalg.svd(N, full_matrices=True)[0]
    Q = U[:, dim_ker:]
    return _subproblem(1, n - dim_ker, n, adj, Q, params)


def solve_gains(points: np.ndarray, adj: np.ndarray,
                params: AdmmParams | None = None) -> np.ndarray:
    """Full 3D gain design (`solver.cpp:28-79`): solve 2D + 1D subproblems,
    interleave into (3n, 3n) blocks [[a b 0], [-b a 0], [0 0 c]].

    Args:
      points: (n, 3) desired formation points.
      adj: (n, n) {0,1} adjacency.
    """
    params = params or AdmmParams()
    points = np.asarray(points, dtype=np.float64)
    adj = np.asarray(adj, dtype=np.float64)
    n = points.shape[0]

    A2d = solve2d(points[:, :2], adj, params)
    A1d = solve1d(points[:, 2], adj, params)

    A = np.zeros((3 * n, 3 * n))
    for bi in range(n):
        for bj in range(n):
            A[3 * bi:3 * bi + 2, 3 * bj:3 * bj + 2] = \
                A2d[2 * bi:2 * bi + 2, 2 * bj:2 * bj + 2]
            A[3 * bi + 2, 3 * bj + 2] = A1d[bi, bj]
    return A

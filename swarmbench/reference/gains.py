"""Plain reference of the formation gain design (aclswarm's
`lib/admm/src/solver.cpp`, Fathian et al.), in float64, for one formation.

The design splits into a planar (xy, 2 x 2 blocks [[a, b], [-b, a]]) and a
vertical subproblem. Each is the semidefinite program

    find X = [[t I, I], [I, Xbar]] >= 0,  <C, X> = dm t minimal,

with Xbar symmetric (and of the block structure in the plane), trace
Xbar = dm, and no gain between formation points the graph does not join;
the gains are -Q Xbar Q^T, Q an orthonormal basis of the complement of the
formation's similarity directions. The solver runs the upstream's dual
ADMM for at most ``MAX_ITR`` steps, each an exact eigendecomposition, and
ends with a projection onto the affine constraints. The projection onto
the constraints is taken in closed form over the structured matrices plus
a correction by the Gram matrix of the zero-gain and trace constraints,
so no constraint matrix is built.

It imports nothing of the program under test.
"""
from __future__ import annotations

import numpy as np
import torch

THR_PLANAR = 1e-2      # z sample std below this: a flat formation
EPS_EIG = 1e-5         # the PSD step keeps eigenvalues above this
MU = 1.0
THRESH = 1e-4          # stop: sum |X_new - X| below this
THRESH_TR = 0.10       # stop: (trace Xbar - dm) / dm below this (signed)
MAX_ITR = 10
THR_ZERO = 1e-8        # final gains: |x| <= this is zero


def _basis(N: np.ndarray) -> np.ndarray:
    """An orthonormal basis of the complement of N's columns: the trailing
    left singular vectors of the full SVD (LAPACK gesdd), as upstream."""
    return np.linalg.svd(N, full_matrices=True)[0][:, N.shape[1]:]


def _J(V: torch.Tensor) -> torch.Tensor:
    """J^T applied to each row of (K, dm) V, J = diag([[0, 1], [-1, 0]])."""
    Vb = V.reshape(V.shape[0], -1, 2)
    return torch.stack([-Vb[..., 1], Vb[..., 0]], -1).reshape(V.shape)


def _struct(B: torch.Tensor, d: int) -> torch.Tensor:
    """Orthogonal projection onto symmetric matrices commuting with J
    (d = 2) or onto symmetric ones (d = 1)."""
    B = 0.5 * (B + B.T)
    if d == 1:
        return B
    m = B.shape[0] // 2
    Bb = B.reshape(m, 2, m, 2)
    a = 0.5 * (Bb[:, 0, :, 0] + Bb[:, 1, :, 1])
    b = 0.5 * (Bb[:, 0, :, 1] - Bb[:, 1, :, 0])
    out = torch.empty_like(Bb)
    out[:, 0, :, 0] = a
    out[:, 1, :, 1] = a
    out[:, 0, :, 1] = b
    out[:, 1, :, 0] = -b
    return out.reshape(B.shape)


def subproblem(Q: torch.Tensor, nonedges: np.ndarray, d: int
               ) -> torch.Tensor:
    """The gains -Q Xbar Q^T of one subproblem; ``nonedges`` (k, 2) pairs
    i < j of points the graph does not join."""
    dm = Q.shape[1]
    i, j = (torch.as_tensor(nonedges[:, c], device=Q.device)
            for c in (0, 1))
    # the zero gain of pair (i, j), entry (d j, d i + s) of Q Xbar Q^T,
    # is u^T Xbar w with u = Q[d j], w = Q[d i + s]
    U = torch.cat([Q[d * j]] * d)
    W = torch.cat([Q[d * i + s] for s in range(d)])
    K = U.shape[0]
    # Gram matrix of the constraints projected onto the structured space,
    # the trace (<H, I> = u.w, <I, I> = dm) last
    G = torch.empty((K + 1, K + 1), dtype=Q.dtype, device=Q.device)
    if d == 2:
        JU, JW = _J(U), _J(W)
        G[:K, :K] = 0.25 * ((U @ U.T) * (W @ W.T) + (W @ U.T) * (U @ W.T)
                            + (JU @ U.T) * (JW @ W.T)
                            + (JW @ U.T) * (JU @ W.T))
    else:
        G[:K, :K] = 0.5 * ((U @ U.T) * (W @ W.T) + (W @ U.T) * (U @ W.T))
    G[:K, K] = G[K, :K] = (U * W).sum(1)
    G[K, K] = dm
    lam, V = torch.linalg.eigh(0.5 * (G + G.T))
    keep = lam.abs() > 1e-12 * lam.abs().max()
    Ginv = (V[:, keep] / lam[keep]) @ V[:, keep].T
    eye = torch.eye(dm, dtype=Q.dtype, device=Q.device)

    def values(B):
        return torch.cat([((U @ B) * W).sum(1), torch.trace(B)[None]])

    def combine(y):
        return _struct(U.T @ (y[:K, None] * W), d) + y[K] * eye

    def onto_v(B):
        """Onto structured matrices with zero constraint values."""
        B = _struct(B, d)
        return B - combine(Ginv @ values(B))

    c = torch.zeros(K + 1, dtype=Q.dtype, device=Q.device)
    c[K] = dm
    xbar_min = combine(Ginv @ c)

    def w_of(D):
        """C - mat(A^T y) - mu X: D's part in the homogeneous constraint
        null space, less mu times the affine set's least-norm point."""
        out = torch.zeros_like(D)
        out[:dm, :dm] = torch.trace(D[:dm, :dm]) / dm * eye
        out[dm:, dm:] = onto_v(D[dm:, dm:]) - MU * xbar_min
        out[:dm, dm:] = out[dm:, :dm] = -MU * eye
        return 0.5 * (out + out.T)

    C = torch.zeros((2 * dm, 2 * dm), dtype=Q.dtype, device=Q.device)
    C[:dm, :dm] = eye
    X = eye.repeat(2, 2)
    S = torch.zeros_like(X)
    for _ in range(MAX_ITR):
        Y = w_of(C - S - MU * X) + S
        lam, V = torch.linalg.eigh(Y)
        above = lam > EPS_EIG
        if not bool(above.any()):
            above = torch.ones_like(above)     # upstream keeps all then
        S = (V[:, above] * lam[above]) @ V[:, above].T
        X_new = (S - Y) / MU
        delta = float((X_new - X).abs().sum())
        X = X_new
        if delta < THRESH or (float(torch.trace(X[dm:, dm:])) - dm) / dm \
                < THRESH_TR:
            break
    xbar = (-w_of(C - MU * X) / MU)[dm:, dm:]
    return -Q @ xbar @ Q.T


def design(points: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """(3n, 3n) gains of a formation (float64, on ``points``' device):
    planar blocks [[a, b, 0], [-b, a, 0], [0, 0, c]] between joined
    points and on the diagonal, zero elsewhere."""
    dev = points.device
    p = points.detach().double().cpu().numpy()
    a = adj.detach().cpu().numpy() != 0
    n = p.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    non = np.stack([iu, ju], 1)[~a[iu, ju]]
    xy = p[:, :2]
    N2 = np.stack([xy.reshape(-1),
                   np.stack([-xy[:, 1], xy[:, 0]], 1).reshape(-1),
                   np.tile([1.0, 0.0], n), np.tile([0.0, 1.0], n)], 1)
    z = p[:, 2]
    flat = np.std(z, ddof=1) < THR_PLANAR
    N1 = z[:, None] if flat else np.stack([z, np.ones(n)], 1)
    Q2 = torch.as_tensor(_basis(N2), device=dev)
    Q1 = torch.as_tensor(_basis(N1), device=dev)
    A2 = subproblem(Q2, non, 2)
    A1 = subproblem(Q1, non, 1)
    out = torch.zeros((n, 3, n, 3), dtype=torch.float64, device=dev)
    out[:, :2, :, :2] = A2.reshape(n, 2, n, 2)
    out[:, 2, :, 2] = A1
    joined = torch.as_tensor(a | np.eye(n, dtype=bool), device=dev)
    out = out * joined[:, None, :, None]
    flat_a = out.reshape(3 * n, 3 * n)
    return torch.where(flat_a.abs() > THR_ZERO, flat_a, 0.0)


def is_flat(points: torch.Tensor) -> bool:
    """The design's planarity rule: z's sample std below ``THR_PLANAR``."""
    return bool(torch.std(points[:, 2].double()) < THR_PLANAR)


def margin(A: torch.Tensor, nullity: int) -> float:
    """The design's objective: the smallest eigenvalue magnitude of the
    symmetric gains off their ``nullity`` kernel directions."""
    w = torch.linalg.eigvalsh(0.5 * (A + A.T))
    return float(-w[w.shape[0] - nullity - 1])

"""Exact linear assignment on the host (Jonker-Volgenant): a copy of
`aclswarm_tpu/assignment/lapjv.py`, numpy only.

The reference's centralized comparison path runs scipy's Hungarian on the
base station (`aclswarm/nodes/operator.py:221-246`,
`aclswarm/src/aclswarm/assignment.py:94-137`: align, cdist, then
`linear_sum_assignment`). This is an O(n^3) Jonker-Volgenant in numpy, so
the oracle carries no hidden dependency; the serving layer's ``assign``
requests with ``solver="lap"`` call `solve_assignment_host`.
"""
from __future__ import annotations

import numpy as np


def lapjv(cost: np.ndarray) -> np.ndarray:
    """Solve min-cost perfect matching on a square cost matrix.

    Returns row_to_col: (n,) with row i assigned to column row_to_col[i].
    Jonker-Volgenant via successive shortest augmenting paths with dual
    potentials (O(n^3)).
    """
    cost = np.asarray(cost, dtype=np.float64)
    n, m = cost.shape
    if n != m:
        raise ValueError("lapjv requires a square cost matrix")

    INF = np.inf
    u = np.zeros(n + 1)          # row potentials (1-indexed, 0 = virtual)
    v = np.zeros(n + 1)          # col potentials
    p = np.zeros(n + 1, dtype=np.int64)   # p[j] = row matched to col j
    way = np.zeros(n + 1, dtype=np.int64)

    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # vectorized relaxation over unused columns
            free = ~used
            free[0] = False
            idx = np.nonzero(free)[0]
            cur = cost[i0 - 1, idx - 1] - u[i0] - v[idx]
            better = cur < minv[idx]
            minv[idx] = np.where(better, cur, minv[idx])
            way[idx[better]] = j0
            k = np.argmin(minv[idx])
            delta = minv[idx][k]
            j1 = idx[k]
            # update potentials
            used_idx = np.nonzero(used)[0]
            u[p[used_idx]] += delta
            v[used_idx] -= delta
            minv[idx] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        # augment along the alternating path
        while True:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
            if j0 == 0:
                break

    row_to_col = np.empty(n, dtype=np.int64)
    for j in range(1, n + 1):
        row_to_col[p[j] - 1] = j - 1
    return row_to_col


def solve_assignment_host(q: np.ndarray, p_aligned: np.ndarray) -> np.ndarray:
    """Centralized assignment: vehicle v -> formation point, minimizing the
    total distance between swarm positions and aligned formation points
    (`assignment.py:94-137` semantics, minus the align step which callers do
    via `aclswarm_torch.core.geometry.align`)."""
    q = np.asarray(q)
    p_aligned = np.asarray(p_aligned)
    cost = np.linalg.norm(q[:, None, :] - p_aligned[None, :, :], axis=-1)
    return lapjv(cost)

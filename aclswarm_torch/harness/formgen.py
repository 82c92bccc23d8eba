"""Random formation generation, numpy only (the port's own copy of
`aclswarm_tpu/harness/formgen.py`'s generator, same draws from the same
seed): formation points are rejection-sampled so their pairwise xy
distance is >= ``min_dist`` in an l x w x h box, and the graph is K_n
minus m ~ U[1, n-4] random edges (n < 5 is fully connected). A group is
emitted in the formation-library dict format (`generate_group`) or as
loaded `FormationSpec`s (`generate_specs`); `is_rigid_2d` checks the
2D rigidity behind the n-4 removal rule.
"""
from __future__ import annotations

import string

import numpy as np

from aclswarm_torch.harness.formations import FormationSpec


def sample_cylinder_points(rng: np.random.Generator, n: int, l: float,
                           w: float, h: float, min_dist: float,
                           max_attempts: int = 100_000) -> np.ndarray:
    """Rejection-sample ``n`` points whose pairwise xy distance is at least
    ``min_dist``; (n, 3). Raises if the box can't fit them within the
    attempt budget."""
    pts = np.empty((0, 3))
    for _ in range(max_attempts):
        pt = np.array([rng.uniform(-l / 2.0, l / 2.0),
                       rng.uniform(-w / 2.0, w / 2.0),
                       rng.uniform(0.0, h)])
        if pts.shape[0] == 0 or np.all(
                np.linalg.norm(pts[:, :2] - pt[:2], axis=1) >= min_dist):
            pts = np.vstack([pts, pt])
            if pts.shape[0] == n:
                return pts
    raise RuntimeError(
        f"could not place {n} non-overlapping cylinders (min_dist="
        f"{min_dist}) in a {l}x{w}x{h} box within {max_attempts} attempts")


def random_adjmat(rng: np.random.Generator, n: int,
                  fc: bool = False) -> np.ndarray:
    """Complete graph, or K_n minus m random edges with m ~ U[1, n-4]
    (self-pairs and duplicate draws waste a removal)."""
    adjmat = np.ones((n, n), dtype=np.int64) - np.eye(n, dtype=np.int64)
    if fc or n < 5:
        return adjmat
    m = rng.integers(1, n - 4 + 1)
    rows = rng.integers(0, n, size=m)
    cols = rng.integers(0, n, size=m)
    for i, j in zip(rows, cols):
        adjmat[i, j] = adjmat[j, i] = 0
    np.fill_diagonal(adjmat, 0)
    return adjmat


def generate_group(n: int, seed: int | None = None, fc: bool = False,
                   l: float = 10.0, w: float = 10.0, h: float = 10.0,
                   min_dist: float = 2.0, k: int = 2) -> dict:
    """A random formation group in the library dict format
    ({agents, adjmat, formations: [{name, points}]})."""
    if n < 3:
        raise ValueError("need at least 3 agents")
    rng = np.random.default_rng(seed)
    adjmat = random_adjmat(rng, n, fc)
    names = list(string.ascii_uppercase)
    formations = [
        {"name": names[i % 26] * (i // 26 + 1),
         "points": sample_cylinder_points(rng, n, l, w, h,
                                          min_dist).tolist()}
        for i in range(k)]
    return {"agents": n, "adjmat": adjmat.tolist(), "formations": formations}


def generate_specs(n: int, seed: int | None = None, **kw
                   ) -> list[FormationSpec]:
    """Same, as loaded `FormationSpec`s (gains left to the caller: trials
    design them on dispatch with `aclswarm_torch.gains.solve_gains`)."""
    group = generate_group(n, seed, **kw)
    adjmat = np.asarray(group["adjmat"], dtype=np.float64)
    return [FormationSpec(name=f["name"],
                          points=np.asarray(f["points"], dtype=np.float64),
                          adjmat=adjmat, gains=None)
            for f in group["formations"]]


def rigidity_rank_2d(points: np.ndarray, adjmat: np.ndarray) -> int:
    """Rank of the 2D rigidity matrix of (xy of points, graph). A
    generically rigid 2D framework on n >= 2 vertices has rank 2n - 3."""
    p = np.asarray(points, dtype=np.float64)[:, :2]
    A = np.asarray(adjmat)
    n = p.shape[0]
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if A[i, j]]
    R = np.zeros((len(edges), 2 * n))
    for row, (i, j) in enumerate(edges):
        d = p[i] - p[j]
        R[row, 2 * i:2 * i + 2] = d
        R[row, 2 * j:2 * j + 2] = -d
    return int(np.linalg.matrix_rank(R))


def is_rigid_2d(points: np.ndarray, adjmat: np.ndarray) -> bool:
    n = np.asarray(points).shape[0]
    return rigidity_rank_2d(points, adjmat) == 2 * n - 3

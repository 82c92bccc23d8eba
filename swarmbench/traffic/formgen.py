"""The benchmark's frozen copy of the simformN sampling (`trials.sh -f
simformN` with `generate_random_formation.py`): rejection-sampled
cylinder points, a random non-complete graph and the start positions.

Kept here, apart from the program, so the benchmark's inputs do not move
when the program's own generator changes. The draws are the program's
generator's, draw for draw: a trial of seed ``s`` takes its graph and its
first formation from ``default_rng(s)`` and its start from a second
``default_rng(s)``, as the batched trial driver does.
"""
from __future__ import annotations

import math

import numpy as np


def sample_cylinder_points(rng: np.random.Generator, n: int, l: float,
                           w: float, h: float, min_dist: float,
                           max_attempts: int = 100_000) -> np.ndarray:
    """``n`` points uniform in an l x w x h box whose pairwise xy distance
    is at least ``min_dist``, by rejection; (n, 3).

    The program's sampler draw for draw: attempt a takes doubles 3a..3a+2
    of ``rng`` as ``uniform`` would, is kept iff its xy distance (the same
    float operations) to every point kept before is at least ``min_dist``,
    and ``rng`` is left as far on as the attempts used. The doubles are
    drawn at once and a grid of ``min_dist`` cells finds the kept points
    near an attempt, which is what makes it fast."""
    state = rng.bit_generator.state
    lo = np.array([-l / 2.0, -w / 2.0, 0.0])
    hi = np.array([l / 2.0, w / 2.0, h])
    cand = (lo + (hi - lo) * rng.random((max_attempts, 3))).tolist()
    md = float(min_dist)
    pts: list = []
    grid: dict = {}
    for a, pt in enumerate(cand):
        x, y = pt[0], pt[1]
        cx, cy = math.floor(x / md), math.floor(y / md)
        if not any(math.sqrt((px - x) * (px - x) + (py - y) * (py - y)) < md
                   for i in (cx - 1, cx, cx + 1) for j in (cy - 1, cy, cy + 1)
                   for px, py in grid.get((i, j), ())):
            pts.append(pt)
            grid.setdefault((cx, cy), []).append((x, y))
            if len(pts) == n:
                rng.bit_generator.state = state
                rng.random(3 * (a + 1))
                return np.array(pts)
    raise RuntimeError(f"could not place {n} points {min_dist} m apart in "
                       f"a {l} x {w} x {h} box in {max_attempts} attempts")


def random_adjmat(rng: np.random.Generator, n: int,
                  fc: bool = False) -> np.ndarray:
    """The complete graph less m ~ U[1, n-4] random edges (self-pairs and
    repeated draws waste a removal); complete for ``fc`` or n < 5."""
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


def draw_trial(cfg: dict, seed: int) -> dict:
    """One trial's inputs from its seed: the graph, the first formation's
    points (the one a trial's first dispatch flies) and the start
    positions on the ground. ``cfg`` is a configuration file's dict."""
    n = int(cfg["n"])
    rng = np.random.default_rng(seed)
    adj = random_adjmat(rng, n, bool(cfg["sim_fc"]))
    points = sample_cylinder_points(rng, n, cfg["sim_l"], cfg["sim_w"],
                                    cfg["sim_h"], cfg["sim_min_dist"])
    start = sample_cylinder_points(np.random.default_rng(seed), n,
                                   cfg["init_area_w"], cfg["init_area_h"],
                                   0.0, 2 * cfg["init_radius"])
    return {"adj": adj.astype(np.float64), "points": points, "start": start}


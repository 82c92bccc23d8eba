"""Sequential CBAA oracle (a copy of `aclswarm_tpu/assignment/cbaa_ref.py`):
per-vehicle NumPy loops, no vectorization.

This is an independent implementation of the auction — the role
`CBAA_aclswarm.m` plays for the aclswarm C++ auctioneer. It follows the
*operational* C++ semantics that the device auction
(`aclswarm_torch.assignment.cbaa`) implements, written
as explicit per-agent loops so the two share no code or structure:

- per-agent neighborhood-restricted 2D Arun alignment
  (`auctioneer.cpp:347-415`);
- greedy select-task with strict `>` against the price table and
  first-index-of-max scan order (`auctioneer.cpp:517-542`), price
  1/(dist + 1e-8) (`auctioneer.cpp:546-549`);
- synchronous bid rounds: every agent max-consensuses its neighbors' tables
  from the *previous* round, ties to the lowest vehicle id (std::map
  iteration order + strict `>`, `auctioneer.cpp:469-513`), and outbid
  agents rebid on their updated table in the same round
  (`auctioneer.cpp:221-224`);
- n * diameter rounds with diameter hardcoded 2 (`auctioneer.cpp:50-51`);
  validity = all agents agree and the `who` row is a permutation
  (`auctioneer.cpp:325-343`).

Known deltas from the MATLAB ground truth (`CBAA_aclswarm.m:44-91`), which
are deltas of the C++ itself: MATLAB bids with `>=` (`:97`) and prices
1/norm without the epsilon (`:74`), and runs n(n-1) rounds (`:77`).
"""
from __future__ import annotations

import numpy as np

PRICE_EPS = 1e-8  # auctioneer.cpp:548
DIAMETER = 2      # auctioneer.cpp:50


def arun_np(p: np.ndarray, q: np.ndarray, d: int = 2):
    """Plain-NumPy Arun: map source points p onto destination q using only
    the first ``d`` coordinates (`matlab/Helpers/arun.m:14-22` with the
    reference's forced d=2 embedding, `auctioneer.cpp:386-410`)."""
    ps, qs = p[:, :d], q[:, :d]
    mu_p, mu_q = ps.mean(axis=0), qs.mean(axis=0)
    sigma = (qs - mu_q).T @ (ps - mu_p) / p.shape[0]
    U, _, Vt = np.linalg.svd(sigma)
    sign = np.sign(np.linalg.det(U) * np.linalg.det(Vt)) or 1.0
    S = np.ones(d)
    S[d - 1] = sign
    Rd = (U * S[None, :]) @ Vt
    td = mu_q - Rd @ mu_p
    R = np.eye(3)
    R[:d, :d] = Rd
    t = np.zeros(3)
    t[:d] = td
    return R, t


def align_local_np(q_veh: np.ndarray, p: np.ndarray, adjmat: np.ndarray,
                   v2f_prev: np.ndarray) -> np.ndarray:
    """Each vehicle aligns the formation over its own graph neighborhood
    (`auctioneer.cpp:347-415`): vehicle v at formation point i = v2f[v]
    pairs formation points {j : adj[i,j] or j==i} with the vehicles
    currently assigned to them. Returns (n, n, 3), agent axis first."""
    n = q_veh.shape[0]
    f2v = np.empty(n, dtype=int)
    f2v[v2f_prev] = np.arange(n)
    q_form = q_veh[f2v]            # q of the vehicle at formation point j
    out = np.empty((n, n, 3))
    for v in range(n):
        i = int(v2f_prev[v])
        nbr = [j for j in range(n) if j == i or adjmat[i, j] > 0]
        R, t = arun_np(p[nbr], q_form[nbr], d=2)
        out[v] = p @ R.T + t
    return out


def _select_task(v, myprice, price, who):
    """Greedy rebid for vehicle v (`auctioneer.cpp:517-542`): first index
    achieving the max among tasks whose price strictly beats the table."""
    n = myprice.shape[0]
    best_j, best_p = -1, 0.0
    for j in range(n):
        if myprice[j] > price[v, j] and myprice[j] > best_p:
            best_j, best_p = j, myprice[j]
    if best_j >= 0:
        price[v, best_j] = best_p
        who[v, best_j] = v


def cbaa_oracle(q_veh: np.ndarray, p: np.ndarray, adjmat: np.ndarray,
                v2f_prev: np.ndarray, n_iters: int | None = None,
                aligned: np.ndarray | None = None):
    """Run the full sequential auction. Returns a dict with v2f, f2v,
    valid, price, who, aligned (same fields the device kernel produces)."""
    q_veh = np.asarray(q_veh, dtype=np.float64)
    p = np.asarray(p, dtype=np.float64)
    adjmat = np.asarray(adjmat)
    v2f_prev = np.asarray(v2f_prev, dtype=int)
    n = q_veh.shape[0]
    if n_iters is None:
        n_iters = n * DIAMETER
    if aligned is None:
        aligned = align_local_np(q_veh, p, adjmat, v2f_prev)

    # communication graph in vehicle space: v hears w iff their formation
    # points are adjacent under the current assignment (`auctioneer.cpp:419-437`)
    nbrs = [[w for w in range(n)
             if w == v or adjmat[v2f_prev[v], v2f_prev[w]] > 0]
            for v in range(n)]

    # bid prices 1/(d + eps) against each agent's own aligned formation
    myprice = np.empty((n, n))
    for v in range(n):
        for j in range(n):
            myprice[v, j] = 1.0 / (
                np.linalg.norm(q_veh[v] - aligned[v, j]) + PRICE_EPS)

    price = np.zeros((n, n))
    who = np.full((n, n), -1, dtype=int)
    for v in range(n):
        _select_task(v, myprice[v], price, who)

    for _ in range(n_iters):
        old_price, old_who = price.copy(), who.copy()
        outbid = np.zeros(n, dtype=bool)
        for v in range(n):
            for j in range(n):
                best_w, best_p = -1, -np.inf
                for w in nbrs[v]:             # ascending id = map order
                    if old_price[w, j] > best_p:   # strict >: lowest id wins
                        best_w, best_p = w, old_price[w, j]
                if old_who[v, j] == v and old_who[best_w, j] != v:
                    outbid[v] = True
                price[v, j] = old_price[best_w, j]
                who[v, j] = old_who[best_w, j]
        for v in range(n):
            if outbid[v]:
                _select_task(v, myprice[v], price, who)

    f2v = who[0].copy()
    agree = bool(np.all(who == who[0][None, :]))
    valid = agree and sorted(f2v.tolist()) == list(range(n))
    if valid:
        v2f = np.empty(n, dtype=int)
        v2f[f2v] = np.arange(n)
    else:
        v2f = np.arange(n)
    return {"v2f": v2f, "f2v": f2v, "valid": valid, "price": price,
            "who": who, "aligned": aligned}

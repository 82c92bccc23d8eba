"""Velocity-obstacle collision avoidance for the whole swarm (port of
`aclswarm_tpu/control/colavoid.py`).

Per agent, every neighbor within ``d_avoid_thresh`` casts a polar no-fly
sector centred on its bearing with half-angle ``asin(r_keep_out / d)``; a
desired heading inside any sector is rotated to the nearest free sector
edge within ±90°, else zeroed. All angle tests are circular, so sectors
straddling ±pi need no special case. The reference vmaps `_one_agent`
over agents; here the agent axis is written out as the leading tensor
dimension. A batch of trials ((B, n, 3) positions) folds into that axis:
every agent's avoidance is a row of its own. Scenario obstacles are
columns appended after the (possibly pruned) vehicle columns, each with
its own keep-out radius.

``rows=(lo, hi)`` computes the agents ``[lo, hi)`` alone against every
vehicle: one rank's block under the agent-axis sharding
(`aclswarm_torch.parallel`). Each agent's avoidance reads its own row of
the pair grid and its own desired velocity only, so the block's rows
equal the whole swarm's.
"""
from __future__ import annotations

import math

import torch

from aclswarm_torch.core.types import SafetyParams

# the largest (rows, 2m, m) sector test built at once (`_agents`)
COVER_ELEMS = 1 << 28


def _smallest_k_indices(d: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row indices of the k smallest entries, lowest index first on
    ties: a k-step masked argmin (`torch.argmin` returns the first
    minimum). Not `torch.topk`, whose order among equal values is not
    specified — the tie rule carries the result."""
    dm = d.clone()
    picks = []
    for _ in range(k):
        j = torch.argmin(dm, dim=-1, keepdim=True)          # (rows, 1)
        dm.scatter_(1, j, math.inf)
        picks.append(j)
    return torch.cat(picks, dim=1)                           # (rows, k)


def wrap_to_pi(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi). Floor-mod (`torch.remainder`, the sign
    of the divisor), as `jnp.mod` — `torch.fmod` would keep the sign of
    the dividend and map negative angles wrong."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def _agents(qij_xy: torch.Tensor, active: torch.Tensor, vel: torch.Tensor,
            params: SafetyParams, r_keep: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Avoidance for every agent at once (the reference's `_one_agent`
    with the agent axis written out).

    Args:
      qij_xy: (n, m, 2) planar relative positions of each agent's columns.
      active: (n, m) bool neighbor-within-threshold mask (self excluded).
      vel: (n, 3) desired velocity goals.
      r_keep: optional (n, m) per-column keep-out radii (scenario obstacles
        carry their own); None = the uniform ``params.r_keep_out``.

    Returns ((n, 3) safe velocities, (n,) modified flags).
    """
    rk = params.r_keep_out if r_keep is None else r_keep
    inf = math.inf
    d = torch.linalg.vector_norm(qij_xy, dim=-1)                     # (n, m)
    theta = torch.atan2(qij_xy[..., 1], qij_xy[..., 0])
    # reciprocal times rk: what `rk / tensor` computes for a Python float,
    # spelled out so a tensor of radii rounds the vehicle columns the same
    ratio = torch.clamp(torch.reciprocal(torch.clamp(d, min=1e-12)) * rk,
                        max=1.0)
    alpha = torch.abs(torch.asin(ratio))
    psi = torch.atan2(vel[:, 1], vel[:, 0])                          # (n,)

    # desired heading strictly inside any active sector (circular test —
    # the reference's intentional divergence at exactly ±pi is kept)
    inside = active & (torch.abs(wrap_to_pi(psi[:, None] - theta)) < alpha)
    unsafe = inside.any(dim=1)

    # candidate escape directions: both edges of every sector; an edge is
    # free iff strictly inside no OTHER active sector (own one excluded)
    m = theta.shape[1]
    edges = torch.cat([theta - alpha, theta + alpha], dim=1)         # (n, 2m)
    edge_active = torch.cat([active, active], dim=1)
    own = torch.eye(m, dtype=torch.bool, device=theta.device).repeat(2, 1)
    # the (n, 2m, m) sector test is the one cubic tensor: at n=m=1000 it
    # is 2e9 elements a trial, which XLA fuses into its `any` and eager
    # torch would materialize (8 GB a float temporary), so it runs in row
    # blocks of at most COVER_ELEMS elements — exact, as a row's `any`
    # reads no other row
    def covered_rows(r: slice) -> torch.Tensor:
        return (~own[None] & active[r, None, :]
                & (torch.abs(wrap_to_pi(edges[r, :, None]
                                        - theta[r, None, :]))
                   < alpha[r, None, :])).any(dim=2)

    rows, block = theta.shape[0], max(1, COVER_ELEMS // (2 * m * m))
    covered = (covered_rows(slice(None)) if rows <= block else torch.cat(
        [covered_rows(slice(i, i + block)) for i in range(0, rows, block)]))
    free = edge_active & ~covered

    # nearest free edge on the LINEARIZED axis (the reference's
    # `utils::closest`); an exact tie resolves to the larger edge
    wedges = wrap_to_pi(edges)
    dist_lin = torch.where(free, torch.abs(wedges - psi[:, None]),
                           torch.full_like(wedges, inf))
    min_dist = dist_lin.min(dim=1).values
    tied = dist_lin == min_dist[:, None]
    best_edge = torch.where(tied, wedges,
                            torch.full_like(wedges, -inf)).max(dim=1).values
    best_dist = torch.where(torch.isfinite(min_dist),
                            torch.abs(wrap_to_pi(best_edge - psi)),
                            torch.full_like(min_dist, inf))

    umag = torch.linalg.vector_norm(vel[:, :2], dim=-1)
    v_edge = torch.stack([umag * torch.cos(best_edge),
                          umag * torch.sin(best_edge), vel[:, 2]], dim=-1)
    escape_ok = torch.isfinite(best_dist) & (best_dist <= math.pi / 2.0)
    v_avoid = torch.where(escape_ok[:, None], v_edge, torch.zeros_like(vel))
    v_out = torch.where(unsafe[:, None], v_avoid, vel)

    # opt-in keep-out escape: inside a violation, separate radially from
    # the deepest violator (clamped to the speed limit, vz preserved)
    viol = active & (d < rk)
    any_viol = viol.any(dim=1) & (params.keepout_repulse_vel > 0.0)
    j = torch.argmin(torch.where(viol, d, torch.full_like(d, inf)), dim=1)
    rows = torch.arange(d.shape[0], dtype=torch.int64, device=d.device)
    away = -qij_xy[rows, j] / torch.clamp(d[rows, j], min=1e-9)[:, None]
    rep_mag = min(params.keepout_repulse_vel, params.max_vel_xy)
    v_rep = torch.cat([rep_mag * away, vel[:, 2:3]], dim=-1)
    v_out = torch.where(any_viol[:, None], v_rep, v_out)
    return v_out, unsafe | any_viol


def collision_avoidance(q: torch.Tensor, vel_des: torch.Tensor,
                        params: SafetyParams,
                        max_neighbors: int | None = None,
                        neighbor_mask: torch.Tensor | None = None,
                        obstacles: tuple | None = None,
                        rows: tuple[int, int] | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched velocity-obstacle shim (vehicle order).

    ``max_neighbors`` = k keeps the k nearest ACTIVE vehicles per agent
    (exact whenever an agent has <= k vehicles in range); None = dense.
    ``neighbor_mask`` (n,) bool: vehicles with a False bit cast no sector.
    ``obstacles`` ``((K, 3) positions, (K,) radii, (K,) active)``
    (scenario cylinders, a leading trial axis with ``q``'s): each active
    obstacle casts a sector with its own radius as the keep-out, inside
    the vehicles' warning shell ``radius + (d_avoid_thresh -
    r_keep_out)``; never pruned. All inactive is bit-identical to None.

    Returns ((n, 3) safe velocities, (n,) bool avoidance-active flags); a
    leading trial axis of ``q``, ``vel_des`` (and ``neighbor_mask``) comes
    back on both. With ``rows=(lo, hi)`` ``vel_des`` holds those agents'
    rows (of every trial) and so do both results.
    """
    n = q.shape[-2]
    lo, hi = (0, n) if rows is None else rows
    own = q if rows is None else q.narrow(-2, lo, hi - lo)
    # (..., i, j, 3): j relative to i
    qij = q[..., None, :, :] - own[..., :, None, :]
    dxy = torch.linalg.vector_norm(qij[..., :2], dim=-1)
    eye = (torch.eye(n, dtype=torch.bool, device=q.device) if rows is None
           else torch.arange(lo, hi, dtype=torch.int64,
                             device=q.device)[:, None]
           == torch.arange(n, dtype=torch.int64, device=q.device))
    active = (dxy <= params.d_avoid_thresh) & ~eye
    if neighbor_mask is not None:
        active = active & neighbor_mask[..., None, :]
    if params.colavoid_dz_ignore > 0.0:
        # opt-in cylinder half-height: vertically clear neighbors cast none
        active = active & (torch.abs(qij[..., 2]) <= params.colavoid_dz_ignore)

    # every agent of every trial is one row
    rows_xy, rows_act = qij[..., :2].reshape(-1, n, 2), active.reshape(-1, n)
    if max_neighbors is not None and max_neighbors < n - 1:
        # rank by the activation mask, not raw planar distance (an
        # inactive vehicle must not take a top-k slot)
        d_masked = torch.where(active, dxy, torch.full_like(dxy, math.inf))
        idx = _smallest_k_indices(d_masked.reshape(-1, n), max_neighbors)
        cols_xy = torch.gather(rows_xy, 1, idx[:, :, None].expand(-1, -1, 2))
        cols_act = torch.gather(rows_act, 1, idx)
    else:
        cols_xy, cols_act = rows_xy, rows_act
    r_keep = None
    if obstacles is not None:
        obs_pos, obs_r, obs_mask = obstacles
        obs_r = obs_r.to(q.dtype)
        k = obs_r.shape[-1]
        # (..., n, K, 2): each obstacle relative to each agent
        oij = obs_pos[..., None, :, :2].to(q.dtype) - own[..., :, None, :2]
        shell = params.d_avoid_thresh - params.r_keep_out
        oact = (torch.linalg.vector_norm(oij, dim=-1)
                <= obs_r[..., None, :] + shell) & obs_mask[..., None, :]
        m = cols_xy.shape[1]
        r_keep = torch.cat(
            [torch.full((cols_xy.shape[0], m), params.r_keep_out,
                        dtype=q.dtype, device=q.device),
             obs_r[..., None, :].expand(oact.shape).reshape(-1, k)], dim=1)
        cols_xy = torch.cat([cols_xy, oij.reshape(-1, k, 2)], dim=1)
        cols_act = torch.cat([cols_act, oact.reshape(-1, k)], dim=1)
    v, flags = _agents(cols_xy, cols_act, vel_des.reshape(-1, 3), params,
                       r_keep)
    return v.reshape(vel_des.shape), flags.reshape(vel_des.shape[:-1])

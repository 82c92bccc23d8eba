"""Distributed formation control law, batched over the whole swarm (port
of `aclswarm_tpu/control/distcntrl.py`).

As in the reference: the damping term scales with the degree of the
vehicle's formation point (``deg * kd * -vel``), the scale term has
per-axis deadbands, and everything is computed in formation space.

The 3x3 gain products (`_gain_product`) are elementwise: each output is
its own three products and two adds in one fixed order, with no
reduction across entries, so an entry rounds the same at every place in
the batch. The sum over a row's neighbours (`core.geometry.row_sum`) is a
fixed pairwise fold of elementwise adds for the same reason. `compute` also
takes a batch of trials (a leading ``(B,)`` axis on the state, the
formation and ``v2f``), and a trial's rows round as they do alone.

`compute_rows` is one rank's block of vehicles under the agent-axis
sharding (`aclswarm_torch.parallel`). It computes each of its vehicles'
formation rows where the vehicle lives, so a flooded vehicle's relative
views never leave its rank; the gain, adjacency and desired-distance
rows of the vehicles' formation points move to it instead, once per
re-assignment (`parallel.rollout`).
"""
from __future__ import annotations

import torch

from aclswarm_torch.core import perm as permutil
from aclswarm_torch.core.geometry import row_sum
from aclswarm_torch.core.types import ControlGains, Formation, SwarmState


def scale_control(qij: torch.Tensor, dstar_xy: torch.Tensor,
                  dstar_z: torch.Tensor, gains: ControlGains) -> torch.Tensor:
    """(n, n, 3) diagonal of the nonlinear scale control F_ij: x and y carry
    the xy-range term past its deadband, z the z-range term past its own."""
    zero = torch.zeros((), dtype=qij.dtype, device=qij.device)
    e_xy = torch.linalg.vector_norm(qij[..., :2], dim=-1) - dstar_xy
    F_xy = gains.K1_xy * torch.atan(gains.K2_xy * e_xy)
    F_xy = torch.where(torch.abs(e_xy) > gains.e_xy_thr, F_xy, zero)
    e_z = torch.abs(qij[..., 2]) - dstar_z
    F_z = gains.K1_z * torch.atan(gains.K2_z * e_z)
    F_z = torch.where(torch.abs(e_z) > gains.e_z_thr, F_z, zero)
    return torch.stack([F_xy, F_xy, F_z], dim=-1)


def compute(state: SwarmState, formation: Formation, v2f: torch.Tensor,
            gains: ControlGains, rel: torch.Tensor | None = None
            ) -> torch.Tensor:
    """All n vehicles' velocity commands (vehicle order), ([B,] n, 3).

    ``rel`` (optional) is the per-agent relative view in vehicle order,
    ``rel[v, w]`` = v's estimate of (w's position − its own); ``None``
    builds every view from the shared true state.
    """
    adj = (formation.adjmat > 0).to(state.q.dtype)
    if rel is None:
        q_form = permutil.veh_to_formation_order(state.q, v2f)
        qij = q_form[..., None, :, :] - q_form[..., :, None, :]
    else:
        qij = permutil.take_pairs(rel, permutil.invert(v2f).long())

    F = scale_control(qij, formation.dstar_xy, formation.dstar_z, gains)
    lin = _gain_product(formation.gains, qij)
    up = row_sum(adj[..., None] * (lin + F * qij))
    deg = torch.sum(adj, dim=-1)
    up_veh = permutil.formation_to_veh_order(up, v2f)
    deg_veh = permutil.formation_to_veh_order(deg, v2f)
    return gains.kp * up_veh - gains.kd * deg_veh[..., None] * state.vel


def compute_rows(vel: torch.Tensor, rows_form: Formation,
                 v2f: torch.Tensor, lo: int, gains: ControlGains,
                 q: torch.Tensor | None = None,
                 rel: torch.Tensor | None = None) -> torch.Tensor:
    """`compute` for the vehicles ``[lo, lo + r)`` alone: ([B,] r, 3).

    ``rows_form`` holds the adjacency, gain and desired-distance rows of
    those vehicles' formation points, ``v2f[..., lo:lo + r]`` in vehicle
    order (``points`` unused); ``vel`` their velocities; ``v2f`` the whole
    assignment. The views come from the whole positions ``q`` (truth) or
    from the vehicles' own relative views ``rel`` (([B,] r, n, 3),
    flooded). Each row contracts in formation order as `compute` does,
    with the same elementwise gain product, so the rows equal `compute`'s
    bit for bit. A leading trial axis on every input takes the trials'
    rows as more rows, as `compute` does."""
    r = vel.shape[-2]
    f2v = permutil.invert(v2f).long()
    lead = f2v.ndim - 1
    if rel is None:
        # vehicle v sits at its own point: q_form[v2f[v]] is q[v]
        qij = permutil.take(q, f2v, lead)[..., None, :, :] \
            - q[..., lo:lo + r, None, :]
    else:
        qij = permutil.take(rel, f2v, lead + 1)
    adj = (rows_form.adjmat > 0).to(vel.dtype)
    F = scale_control(qij, rows_form.dstar_xy, rows_form.dstar_z, gains)
    lin = _gain_product(rows_form.gains, qij)
    up = row_sum(adj[..., None] * (lin + F * qij))
    deg = torch.sum(adj, dim=-1)
    return gains.kp * up - gains.kd * deg[..., None] * vel


def _gain_product(g: torch.Tensor, qij: torch.Tensor) -> torch.Tensor:
    """``lin[..., a] = sum_b g[..., a, b] * qij[..., b]`` for (..., 3, 3)
    gains and (..., 3) views, as three products and two adds over the
    gain's columns, left to right. Eager elementwise operations round
    each product and each add (no contraction into a fused multiply-add),
    so an entry's bits do not depend on its place or on the shape around
    it: a rank's block of rows and a batch equal the whole product. A
    batched matrix product (`einsum` -> `bmm` on the card) rounds an entry
    by its place in the batch."""
    return (g[..., 0] * qij[..., 0:1] + g[..., 1] * qij[..., 1:2]
            + g[..., 2] * qij[..., 2:3])

"""Distributed formation control law, batched over the whole swarm (port
of `aclswarm_tpu/control/distcntrl.py`).

As in the reference: the damping term scales with the degree of the
vehicle's formation point (``deg * kd * -vel``), the scale term has
per-axis deadbands, and everything is computed in formation space.

`compute` also takes a batch of trials (a leading ``(B,)`` axis on the
state, the formation and ``v2f``). The trial axis is folded into the agent
axis for the gain contraction, so each vehicle's 3x3 block products are
the very operation of a single trial.

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
    g = formation.gains
    lin = torch.einsum("ijab,ijb->ija", g.reshape(-1, *g.shape[-3:]),
                       qij.reshape(-1, *qij.shape[-2:])).reshape(qij.shape)
    up = torch.sum(adj[..., None] * (lin + F * qij), dim=-2)
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
    flooded). Each row contracts in formation order as `compute` does, so
    the rows equal `compute`'s. A leading trial axis on every input takes
    the trials' rows as more rows, as `compute` does; its gain products
    run where `compute`'s would (`_rows_product`), so a batch's rows equal
    `compute`'s bit for bit on the card too."""
    r = vel.shape[-2]
    f2v = permutil.invert(v2f).long()
    lead = f2v.ndim - 1
    if rel is None:
        # vehicle v sits at its own point: q_form[v2f[v]] is q[v]
        qij = permutil.take(q, f2v, lead)[..., None, :, :] \
            - q[..., lo:lo + r, None, :]
    elif lead == 0:
        qij = rel[:, f2v, :]
    else:
        qij = permutil.take(rel, f2v, lead + 1)
    adj = (rows_form.adjmat > 0).to(vel.dtype)
    F = scale_control(qij, rows_form.dstar_xy, rows_form.dstar_z, gains)
    g = rows_form.gains
    lin = torch.einsum("ijab,ijb->ija", g, qij) if lead == 0 \
        else _rows_product(g, qij, v2f[..., lo:lo + r].long())
    up = torch.sum(adj[..., None] * (lin + F * qij), dim=-2)
    deg = torch.sum(adj, dim=-1)
    return gains.kp * up - gains.kd * deg[..., None] * vel


def _rows_product(g: torch.Tensor, qij: torch.Tensor,
                  points: torch.Tensor) -> torch.Tensor:
    """The gain products of a batch's block of rows, (B, r, n, 3), each row
    at its formation point's place (``points``, (B, r)) in one batched
    product the size of `compute`'s, the other rows zero. The card's
    batched product rounds an entry by its place in the batch, so a
    product of the block alone would leave `compute`'s bits."""
    B, r, n = qij.shape[:3]
    b = torch.arange(B, dtype=torch.int64, device=qij.device)[:, None]
    g_all = g.new_zeros((B, n, n, 3, 3))
    g_all[b, points] = g
    q_all = qij.new_zeros((B, n, n, 3))
    q_all[b, points] = qij
    lin = torch.einsum("ijab,ijb->ija", g_all.reshape(-1, n, 3, 3),
                       q_all.reshape(-1, n, 3))
    return lin.reshape(B, n, n, 3)[b, points]

"""Distributed formation control law, batched over the whole swarm (port
of `aclswarm_tpu/control/distcntrl.py`).

As in the reference: the damping term scales with the degree of the
vehicle's formation point (``deg * kd * -vel``), the scale term has
per-axis deadbands, and everything is computed in formation space.

`compute` also takes a batch of trials (a leading ``(B,)`` axis on the
state, the formation and ``v2f``). The trial axis is folded into the agent
axis for the gain contraction, so each vehicle's 3x3 block products are
the very operation of a single trial.
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

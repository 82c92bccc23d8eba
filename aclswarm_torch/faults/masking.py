"""Masked-assignment helpers: re-auction the alive sub-fleet only (port of
`aclswarm_tpu/faults/masking.py`).

A dead vehicle keeps owning its formation point (its row is *pinned* to
the current assignment), and alive vehicles compete only over alive-owned
points (*forbidden* elsewhere). Solving the full-shape problem on the
masked cost returns {pinned dead pairs} + {the optimal assignment of the
alive sub-problem}, with fixed shapes.

With an all-alive mask ``pin`` and ``forbid`` are all false, and every
`where` below returns its pass-through operand bit for bit.
"""
from __future__ import annotations

import torch

from aclswarm_torch.core import perm as permutil


def alive_points(alive: torch.Tensor, v2f: torch.Tensor) -> torch.Tensor:
    """(n,) bool over *formation points*: point i is alive-owned iff the
    vehicle assigned to it is alive (``alive[f2v[i]]``)."""
    return alive[permutil.invert(v2f).long()]


def pin_forbid(alive: torch.Tensor, v2f: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(pin, forbid) (n, n) bool masks over (vehicle, formation point).

    ``pin[v, j]``: v is dead and j is its current point. ``forbid[v, j]``:
    the pair is never allowed (a dead vehicle off its point, or an alive
    vehicle onto a dead-owned point)."""
    n = v2f.shape[0]
    pts = torch.arange(n, dtype=v2f.dtype, device=v2f.device)
    own = pts[None, :] == v2f[:, None]
    dead = ~alive
    alive_pt = alive_points(alive, v2f)
    pin = dead[:, None] & own
    forbid = (dead[:, None] & ~own) | (alive[:, None] & ~alive_pt[None, :])
    return pin, forbid


def apply_pin_forbid(c: torch.Tensor, pin: torch.Tensor,
                     forbid: torch.Tensor) -> torch.Tensor:
    """Pinned pairs cost 0, forbidden pairs ``4 * (max(c) + 1)``: large
    enough that any solution holding one is strictly worse than the
    all-pinned alternative, yet on the problem's own scale (the auction's
    epsilon scaling starts from max|benefit|). The one home of the
    magnitude rule: the Sinkhorn path masks its normalized and its raw
    cost through it."""
    big = 4.0 * (torch.max(c) + 1.0)
    return torch.where(pin, torch.zeros((), dtype=c.dtype, device=c.device),
                       torch.where(forbid, big, c))


def mask_cost(c: torch.Tensor, alive: torch.Tensor,
              v2f: torch.Tensor) -> torch.Tensor:
    """Masked min-cost matrix for the centralized solvers."""
    pin, forbid = pin_forbid(alive, v2f)
    return apply_pin_forbid(c, pin, forbid)

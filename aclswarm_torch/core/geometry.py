"""Pairwise distances and rigid point-cloud alignment (port of
`aclswarm_tpu/core/geometry.py`).

Products run in full float32 on the card: the package turns TF32 off at
import (`aclswarm_torch/__init__.py`), the counterpart of the reference's
``precision="highest"``.
"""
from __future__ import annotations

import torch


def pdistmat(x: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance matrix of the rows of ``x`` (n, d), by
    the |x|^2 + |y|^2 - 2xy expansion, with an exact-zero diagonal."""
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    return torch.where(eye, torch.zeros((), dtype=d.dtype, device=d.device),
                       d)


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross distances ||a_i - b_j|| by direct subtraction — exact near
    zero (the assignment hysteresis cost)."""
    return torch.linalg.vector_norm(a[:, None, :] - b[None, :, :], dim=-1)


def cdist_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross distances via the |x|^2 + |y|^2 - 2xy expansion (one matrix
    product; ~sqrt(eps)*scale absolute error near zero, harmless for
    assignment costs)."""
    sa = torch.sum(a * a, dim=-1)
    sb = torch.sum(b * b, dim=-1)
    return torch.sqrt(torch.clamp(sa[:, None] + sb[None, :] - 2.0 * (a @ b.T),
                                  min=0.0))


def arun(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None,
         d: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment: (R, t) minimizing sum w ||q - (R p + t)||^2
    over the first ``d`` coordinates (the other axes get R=I, t=0).
    Returns R (3, 3) and t (3,) with aligned = p @ R.T + t."""
    dtype, dev = p.dtype, p.device
    m = p.shape[0]
    if w is None:
        w = torch.ones((m,), dtype=dtype, device=dev)
    w = w.to(dtype)
    wsum = torch.clamp(torch.sum(w), min=1e-12)

    ps, qs = p[:, :d], q[:, :d]
    mu_p = torch.sum(w[:, None] * ps, dim=0) / wsum
    mu_q = torch.sum(w[:, None] * qs, dim=0) / wsum
    pc, qc = ps - mu_p, qs - mu_q
    sigma = (qc * w[:, None]).T @ pc / wsum          # (d, d) cross-covariance

    U, _, Vt = torch.linalg.svd(sigma)
    # determinant sign correction (reflection guard), as Eigen::umeyama
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    S = torch.ones((d,), dtype=dtype, device=dev)
    S = torch.cat([S[:d - 1], sign.reshape(1)])
    Rd = (U * S[None, :]) @ Vt
    td = mu_q - Rd @ mu_p

    R = torch.eye(3, dtype=dtype, device=dev)
    R[:d, :d] = Rd
    t = torch.zeros((3,), dtype=dtype, device=dev)
    t[:d] = td
    return R, t


def align(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None,
          d: int = 2) -> torch.Tensor:
    """Align formation points ``p`` to swarm positions ``q``; returns (n, 3).
    d=2 (rotation about z only) is the swarm-wide convention."""
    R, t = arun(p, q, w=w, d=d)
    return p @ R.T + t


def align_formation_local(q_veh: torch.Tensor, p: torch.Tensor,
                          adjmat: torch.Tensor, v2f: torch.Tensor,
                          est: torch.Tensor | None = None) -> torch.Tensor:
    """Per-agent neighborhood-restricted 2D alignment, all agents at once.

    For vehicle v with formation point i = v2f[v], the alignment weighs
    only formation points j with adj[i, j] or j == i, paired with the
    vehicles assigned to them. ``est`` ((n, n, 3), agent axis first) makes
    each agent align against its own belief of where the others are; None
    = the shared true state. Returns (n, n, 3): agent v's aligned
    formation in row v.

    The reference maps `align` over agents; here the n weighted `arun`
    problems (d=2) are one batch: weighted centroids, an (n, 2, 2) stack of
    cross-covariances, one batched SVD, the determinant sign fix. The z
    axis passes through (R=I, t=0 there), as `arun` embeds it."""
    from aclswarm_torch.core import perm as permutil

    n = adjmat.shape[0]
    dtype, dev = q_veh.dtype, q_veh.device
    idx = v2f.long()
    f2v = permutil.invert(v2f).long()
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    w = ((adjmat[idx] > 0) | eye[idx]).to(dtype)          # (agent, point)
    # destination clouds in formation order, xy only
    qs = (q_veh[f2v][None] if est is None else est[:, f2v])[..., :2]
    ps = p[:, :2]
    wsum = torch.clamp(torch.sum(w, dim=1), min=1e-12)[:, None]
    mu_p = torch.sum(w[:, :, None] * ps[None], dim=1) / wsum       # (n, 2)
    mu_q = torch.sum(w[:, :, None] * qs, dim=1) / wsum
    pc = ps[None] - mu_p[:, None, :]                                # (n, n, 2)
    qc = qs - mu_q[:, None, :]
    sigma = torch.einsum("vmi,vmj->vij", qc * w[:, :, None], pc) \
        / wsum[:, :, None]

    U, _, Vt = torch.linalg.svd(sigma)
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    S = torch.stack([torch.ones_like(sign), sign], dim=-1)          # (n, 2)
    Rd = (U * S[:, None, :]) @ Vt
    td = mu_q - (Rd @ mu_p[:, :, None])[:, :, 0]
    xy = torch.einsum("md,vkd->vmk", ps, Rd) + td[:, None, :]
    return torch.cat([xy, p[None, :, 2:3].expand(n, n, 1)], dim=-1)

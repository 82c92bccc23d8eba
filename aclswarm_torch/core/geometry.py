"""Pairwise distances and rigid point-cloud alignment (port of
`aclswarm_tpu/core/geometry.py`).

Products run in full float32 on the card: the package turns TF32 off at
import (`aclswarm_torch/__init__.py`), the counterpart of the reference's
``precision="highest"``.

`cdist`, `cdist_fast`, `arun` and `align` also take a batch of trials, the
clouds ``(B, n, 3)``. Their matrix products and the alignment's sums over
the n rows are taken trial by trial (`_mm`, `_moments`), and a 2-D
rotation comes in closed form, element by element (`_rotation2`): a batch
equals its serial runs bit for bit on the card as on the CPU. The local
alignment (`align_formation_local`) goes further: it rounds in one fixed
order on both devices (`row_sum`), so the card's equals the CPU's.
"""
from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``, trial by trial over leading trial axes of ``a`` (a
    matrix per trial; ``b`` a matrix or a vector per trial): the CPU's
    BLAS rounds a batched product otherwise than lone ones, and a batch
    must equal its serial runs bit for bit."""
    if a.ndim == 2:
        return a @ b
    return torch.stack([_mm(x, y) for x, y in zip(a, b)])


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
    return torch.linalg.vector_norm(a[..., :, None, :] - b[..., None, :, :],
                                    dim=-1)


def cdist_fast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross distances via the |x|^2 + |y|^2 - 2xy expansion (one matrix
    product per trial; ~sqrt(eps)*scale absolute error near zero, harmless
    for assignment costs)."""
    sa = torch.sum(a * a, dim=-1)
    sb = torch.sum(b * b, dim=-1)
    return torch.sqrt(torch.clamp(sa[..., :, None] + sb[..., None, :]
                                  - 2.0 * _mm(a, b.mT), min=0.0))


def _moments(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None,
             d: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One trial's weighted means of ``p`` and ``q`` over the first ``d``
    coordinates and their (d, d) cross-covariance."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    w = w.to(p.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)[..., None]
    ps, qs = p[..., :d], q[..., :d]
    mu_p = torch.sum(w[..., None] * ps, dim=-2) / wsum
    mu_q = torch.sum(w[..., None] * qs, dim=-2) / wsum
    pc, qc = ps - mu_p[..., None, :], qs - mu_q[..., None, :]
    sigma = _mm((qc * w[..., None]).mT, pc) / wsum[..., None]
    return sigma, mu_p, mu_q


def _rotation2(sigma: torch.Tensor) -> torch.Tensor:
    """The proper rotation R maximizing tr(R^T sigma) for ([...,] 2, 2)
    cross-covariances: the angle atan2(s10 - s01, s00 + s11), its cosine
    and sine taken as quotients by the norm. It is the rotation an SVD
    with the determinant correction returns, computed element by element:
    no batch rounds otherwise than its members, and nothing is read back
    from the card. A zero covariance gives I. The norm's root is taken in
    float64 and rounded once: the correctly rounded root on the card and
    the CPU alike (the card's float32 `torch.sqrt` is not correctly
    rounded)."""
    a = sigma[..., 0, 0] + sigma[..., 1, 1]
    b = sigma[..., 1, 0] - sigma[..., 0, 1]
    r = torch.sqrt((a * a + b * b).double()).to(a.dtype)
    some = r > 0
    r = torch.where(some, r, torch.ones_like(r))
    c = torch.where(some, a / r, torch.ones_like(r))
    s = torch.where(some, b / r, torch.zeros_like(r))
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def _rotation_svd(sigma: torch.Tensor) -> torch.Tensor:
    """The proper rotation maximizing tr(R^T sigma) for ([...,] d, d)
    cross-covariances, from their SVD with the determinant sign
    correction (reflection guard), as Eigen::umeyama."""
    U, _, Vt = torch.linalg.svd(sigma)
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    S = torch.cat([torch.ones_like(U[..., 0, 1:]), sign[..., None]], dim=-1)
    return _mm(U * S[..., None, :], Vt)


def arun(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None,
         d: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted rigid alignment: (R, t) minimizing sum w ||q - (R p + t)||^2
    over the first ``d`` coordinates (the other axes get R=I, t=0).
    Returns R ([B,] 3, 3) and t ([B,] 3) with aligned = p @ R.T + t; a
    leading axis of ``p``, ``q`` (and ``w``) is a batch of trials."""
    dtype, dev = p.dtype, p.device
    lead = p.shape[:-2]
    if p.ndim > 2:
        # the sums over the n rows trial by trial: on the card a batch's
        # reduction rounds otherwise than a lone trial's, and the
        # auction's near-ties turn those last bits into another
        # assignment; a batch must equal its serial runs
        sigma, mu_p, mu_q = (torch.stack(x) for x in zip(*(
            _moments(p[b], q[b], None if w is None else w[b], d)
            for b in range(p.shape[0]))))
    else:
        sigma, mu_p, mu_q = _moments(p, q, w, d)

    Rd = _rotation2(sigma) if d == 2 else _rotation_svd(sigma)
    td = mu_q - _mm(Rd, mu_p)

    R = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3)).clone()
    R[..., :d, :d] = Rd
    t = torch.zeros(lead + (3,), dtype=dtype, device=dev)
    t[..., :d] = td
    return R, t


def align(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None,
          d: int = 2) -> torch.Tensor:
    """Align formation points ``p`` to swarm positions ``q``; returns
    ([B,] n, 3). d=2 (rotation about z only) is the swarm-wide
    convention."""
    R, t = arun(p, q, w=w, d=d)
    return _mm(p, R.mT) + t[..., None, :]


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(dim=-2)`` as a pairwise fold of elementwise adds (the first
    half plus the second, an odd row left over added into the first),
    so each output's order of additions depends on the length of the
    summed axis alone. The card's reduction picks another order when it
    has few outputs (a block of a few rows splits each sum over more
    threads), and another than the CPU's: a fold rounds the same on both
    devices and at every place."""
    while x.shape[-2] > 1:
        m = x.shape[-2]
        h = m // 2
        y = x[..., :h, :] + x[..., h:2 * h, :]
        if m % 2:
            y[..., :1, :] += x[..., 2 * h:, :]
        x = y
    return x[..., 0, :]


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
    problems (d=2) are one batch (`_align_rows`), and each agent's row is
    computed in a fixed order that does not depend on the device or on
    the agent's place: elementwise products, sums over the n formation
    points as a pairwise fold (`row_sum`), the 2x2 products written out
    term by term, and each rotation in closed form (`_rotation2`, as `arun`
    takes it). So an agent's row equals its lone solve bit for bit, the
    card's rows equal the CPU's, and a batch of trials, which calls it
    trial by trial (CBAA runs so in `sim.engine`), equals its serial runs.
    The z axis passes through (R=I, t=0 there), as `arun` embeds it."""
    from aclswarm_torch.core import perm as permutil

    n = adjmat.shape[0]
    idx = v2f.long()
    f2v = permutil.invert(v2f).long()
    eye = torch.eye(n, dtype=torch.bool, device=q_veh.device)
    w = ((adjmat[idx] > 0) | eye[idx]).to(q_veh.dtype)     # (agent, point)
    # destination clouds in formation order, xy only
    qs = (q_veh[f2v][None] if est is None else est[:, f2v])[..., :2]
    xy = _align_rows(w, qs, p[:, :2])
    return torch.cat([xy, p[None, :, 2:3].expand(n, n, 1)], dim=-1)


def _align_rows(w: torch.Tensor, qs: torch.Tensor,
                ps: torch.Tensor) -> torch.Tensor:
    """The local alignments of a block of r agents: weights ``w`` (r, n)
    over the formation points, destination clouds ``qs`` ((r or 1), n, 2)
    and the formation's xy ``ps`` (n, 2); returns each agent's aligned
    xy, (r, n, 2). Nothing mixes two agents' rows."""
    w = w[:, :, None]
    ps = ps[None]
    wsum = torch.clamp(row_sum(w), min=1e-12)                    # (r, 1)
    mu_p = row_sum(w * ps) / wsum                                 # (r, 2)
    mu_q = row_sum(w * qs) / wsum
    pc = ps - mu_p[:, None, :]                                    # (r, n, 2)
    qc = (qs - mu_q[:, None, :]) * w
    # sigma[v, i, j] = sum_m qc[v, m, i] pc[v, m, j] / wsum[v]
    sigma = row_sum((qc[..., :, None] * pc[..., None, :]).flatten(-2)) \
        .unflatten(-1, (2, 2)) / wsum[:, :, None]
    Rd = _rotation2(sigma)                                        # (r, 2, 2)
    td = mu_q - (Rd[..., 0] * mu_p[:, None, 0]
                 + Rd[..., 1] * mu_p[:, None, 1])
    return (ps[..., None, 0] * Rd[:, None, :, 0]
            + ps[..., None, 1] * Rd[:, None, :, 1]) + td[:, None, :]

"""Formation gain design by ADMM (port of `aclswarm_tpu/gains/admm.py`).

The reference's projection form, as PyTorch tensor code: the constraint
system of `solver.cpp:351-694` never becomes a matrix. Each ADMM step
projects onto the constraint null space with closed forms (the trace
block, the complex structure of the 2D subproblem) and a rank-K
correction for the zero-gain and trace constraints, whose K x K Gram
system is solved once per subproblem. The K constraint tensors are never
materialised: evaluating, combining and the Gram matrix reduce to (K, dm)
row-matrix products (`_constraint_system`).

The PSD step is an eigendecomposition at float64 (with the reference's
keep-all quirk, `solver.cpp:301-308`) and a Newton-Schulz matrix-sign
iteration at float32 (matmuls only), as in the reference.

Three things the port does its own way:

- **The kernel basis Q is computed on the host.** `_kernel_2d` takes the
  last 2n-4 left singular vectors of an (2n, 4) matrix: an orthonormal
  basis of a space whose singular values are all zero, so any rotation of
  it is as valid, and the library picks one. The 2D subproblem's
  structure projection is equivariant only under rotations that commute
  with the complex structure J, so another basis designs other gains (a
  random rotation of Q moves them by ~0.2 at n=12). LAPACK's ``gesdd``
  through scipy returns the reference's Q bit for bit on the CPU; cuSOLVER
  is another library and nothing makes it pick the same basis. So Q comes
  from `scipy.linalg.svd(..., lapack_driver="gesdd")` in the points'
  dtype and is then moved to the device: one (2n, 4) and one (n, 2) SVD
  per solve, at dispatch time.
- **The Gram system** is inverted with a Hermitian pseudo-inverse (an
  eigendecomposition) of the symmetrised Gram matrix, with the
  reference's cut-off (``rtol=1e-12`` of the largest magnitude). The
  reference's SVD-based `pinv` has the same semantics on a symmetric
  matrix; on the card the SVD of a ~2000-wide matrix is the slow one.
- **The data-dependent loops keep their state and stop flags on the
  device.** Each step is applied through ``torch.where(done, old, new)``,
  so a step past a formation's end is the identity and the counters
  count live steps only. The host reads the ADMM stop flag after every
  ADMM step (at most ``max_itr`` = 10) and the Newton stall flag every
  ``poll_every`` steps (`POLL_EVERY` on a CUDA device, every step on the
  CPU); any ``poll_every`` gives the same bits. A batch of formations
  gates each formation's update with its own flag, as the reference's
  vmapped ``while_loop`` does.

Every entry point runs on the card unless it is given CPU tensors or
``device="cpu"``; the dtype follows the points.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import scipy.linalg
import torch

from aclswarm_torch.analysis import invariants as invlib
from aclswarm_torch.core.types import gains_from_flat, resolve_device
from aclswarm_torch.gains.params import AdmmParams
from aclswarm_torch.utils.host import to_host

# Newton steps between host reads of the stall flag on a CUDA device
POLL_EVERY = 4


@dataclasses.dataclass(frozen=True)
class AdmmSolveStats:
    """One gain solve: ADMM iterations of the 2D and 1D subproblems
    together, and the worse of their final residuals (the last step's
    sum |X_new - X|)."""

    iters: int
    residual: float


class AdmmCarry(NamedTuple):
    """Solver state carried from one dispatch to the next: the final
    (X, S) iterates of both subproblems and the iteration count of the
    solve that produced them. ``x2``/``s2`` are (2 dm2, 2 dm2) with
    dm2 = 2n - 4, ``x1``/``s1`` (2 dm1, 2 dm1) with dm1 = n - 1 (flat
    formations) or n - 2; a carry re-seeds only solves of the same n and
    planarity."""

    x2: torch.Tensor
    s2: torch.Tensor
    x1: torch.Tensor
    s1: torch.Tensor
    iters: torch.Tensor   # () int32


def init_carry(n: int, planar: bool = False, dtype=torch.float32,
               device=None) -> AdmmCarry:
    """The cold start as a carry: X = tile(eye), S = 0 for both
    subproblems (`solver.cpp:270-272`). A solve seeded with it equals the
    carry-free solve bit for bit."""
    dev = resolve_device(device)
    dm2 = 2 * n - 4
    dm1 = (n - 1) if planar else (n - 2)
    x2 = torch.eye(dm2, dtype=dtype, device=dev).repeat(2, 2)
    x1 = torch.eye(dm1, dtype=dtype, device=dev).repeat(2, 2)
    return AdmmCarry(x2=x2, s2=torch.zeros_like(x2), x1=x1,
                     s1=torch.zeros_like(x1),
                     iters=torch.zeros((), dtype=torch.int32, device=dev))


def _host_float(x) -> np.ndarray:
    """Host copy in the input's float dtype (other inputs: float64)."""
    a = to_host(x)
    return a if a.dtype in (np.float32, np.float64) else a.astype(np.float64)


def planar_of(points, params: AdmmParams | None = None) -> bool:
    """The solver's planarity rule: the z coordinates' sample standard
    deviation (ddof=1) below ``params.thr_planar``."""
    params = params or AdmmParams()
    return bool(np.std(to_host(points)[:, 2], ddof=1) < params.thr_planar)


def _mT(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _trace(x: torch.Tensor) -> torch.Tensor:
    return x.diagonal(dim1=-2, dim2=-1).sum(-1)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product, taken formation by formation: the CPU's BLAS rounds
    a (B, m, k) @ (B, k, p) product otherwise than B lone (1, m, k)
    products, so a batch of formations would not equal its serial solves
    bit for bit."""
    if a.shape[0] == 1:
        return a @ b
    return torch.cat([a[i:i + 1] @ b[i:i + 1] for i in range(a.shape[0])])


def _proj_struct(B: torch.Tensor, d: int) -> torch.Tensor:
    """Project (..., dm, dm) onto symmetric (d=1) or complex-structured
    symmetric (d=2) matrices: 2 x 2 blocks [[a, b], [-b, a]]."""
    B = (B + _mT(B)) / 2.0
    if d == 1:
        return B
    *lead, dm, _ = B.shape
    m = dm // 2
    Bb = B.reshape(*lead, m, 2, m, 2)
    a = (Bb[..., :, 0, :, 0] + Bb[..., :, 1, :, 1]) / 2.0
    b = (Bb[..., :, 0, :, 1] - Bb[..., :, 1, :, 0]) / 2.0
    out = torch.stack([torch.stack([a, b], dim=-1),
                       torch.stack([-b, a], dim=-1)], dim=-2)
    return out.transpose(-3, -2).reshape(*lead, dm, dm)


def _rot_rows(V: torch.Tensor) -> torch.Tensor:
    """Apply the block-diagonal rotation J = diag([[0, 1], [-1, 0]]) to
    each row of (..., K, dm) V (rows in the interleaved-xy space)."""
    *lead, K, dm = V.shape
    Vb = V.reshape(*lead, K, dm // 2, 2)
    return torch.stack([Vb[..., 1], -Vb[..., 0]], dim=-1).reshape(*lead, K,
                                                                  dm)


def _rows(Q, i_idx, j_idx, valid, d):
    """The constraint row matrices U = Q[a], W = Q[b] (B, K, dm) of a
    batch, padded slots zeroed, and the (B, K) float mask of real slots:
    for each non-edge (i, j), rows a = d*j and columns b = d*i + s for
    s < d (`solver.cpp:563-607`)."""
    if d == 2:
        a_idx = torch.cat([2 * j_idx, 2 * j_idx], dim=-1)
        b_idx = torch.cat([2 * i_idx, 2 * i_idx + 1], dim=-1)
        vmask = torch.cat([valid, valid], dim=-1).to(Q.dtype)
    else:
        a_idx, b_idx = j_idx, i_idx
        vmask = valid.to(Q.dtype)
    rows = torch.arange(Q.shape[0], dtype=torch.int64, device=Q.device)[:, None]
    return (Q[rows, a_idx] * vmask[..., None],
            Q[rows, b_idx] * vmask[..., None], vmask)


def _gram(U, W, vmask, d):
    """The symmetrised (B, K+1, K+1) Gram matrix <H_k, H_l> of the
    constraints, the trace row <H_k, I> = u_k . w_k last, and a unit
    diagonal on padded slots so the system stays well-posed."""
    nb, K, dm = U.shape
    if d == 2:
        JU, JW = _rot_rows(U), _rot_rows(W)
        G = 0.25 * (_mm(U, _mT(U)) * _mm(W, _mT(W))
                    + _mm(U, _mT(W)) * _mm(W, _mT(U))
                    + _mm(U, _mT(JU)) * _mm(W, _mT(JW))
                    + _mm(U, _mT(JW)) * _mm(W, _mT(JU)))
    else:
        G = 0.5 * (_mm(U, _mT(U)) * _mm(W, _mT(W))
                   + _mm(U, _mT(W)) * _mm(W, _mT(U)))
    g = (U * W).sum(-1)
    Gf = torch.zeros((nb, K + 1, K + 1), dtype=U.dtype, device=U.device)
    Gf[:, :K, :K] = G
    Gf[:, :K, K] = g
    Gf[:, K, :K] = g
    Gf[:, K, K] = dm
    pad = torch.cat([1.0 - vmask, torch.zeros_like(vmask[:, :1])], dim=-1)
    Gf.diagonal(dim1=-2, dim2=-1).add_(pad)
    return (Gf + _mT(Gf)) / 2.0


def _constraint_system(Q, i_idx, j_idx, valid, d):
    """Matrix-free zero-gain and trace constraints (`solver.cpp:563-623`)
    over a batch: Q (B, r, dm), indices and ``valid`` (B, K0).

    Constraint k is H_k = P_S(outer(u_k, w_k)) with the rows of `_rows`:

    - evaluation  <H_k, B> = u_k^T B w_k        (B structured),
    - combination sum_k y_k H_k = P_S(U^T diag(y) W),
    - Gram        <H_k, H_l> from four products of U, W and their
      J-rotations (`_gram`).

    Returns (C, Ct, Ginv_apply): C(B) -> (B, K+1) constraint values (trace
    last), Ct(y) -> the structured matrix, Ginv_apply(r) -> G^+ r.
    """
    U, W, vmask = _rows(Q, i_idx, j_idx, valid, d)
    K, dm = U.shape[1], U.shape[2]
    Ginv = torch.linalg.pinv(_gram(U, W, vmask, d), rtol=1e-12,
                             hermitian=True)
    eye = torch.eye(dm, dtype=Q.dtype, device=Q.device)

    def C(B):
        """(B, K+1) constraint values of a structured (B, dm, dm)."""
        return torch.cat([(_mm(U, B) * W).sum(-1), _trace(B)[:, None]], dim=-1)

    def Ct(y):
        """sum_k y_k H_k as a dense structured (B, dm, dm)."""
        M = _mm(_mT(U), y[:, :K, None] * W)
        return _proj_struct(M, d) + y[:, K, None, None] * eye

    return C, Ct, (lambda r: _mm(Ginv, r[..., None])[..., 0])


def _psd_eigh(W, params):
    """Keep modes with eigenvalue > eps_eig; if none, keep all
    (`solver.cpp:299-313`, the k=0 quirk)."""
    lam, V = torch.linalg.eigh(W)
    keep = lam > params.eps_eig
    keep = torch.where(keep.any(-1, keepdim=True), keep,
                       torch.ones_like(keep))
    lam_kept = torch.where(keep, lam, torch.zeros_like(lam))
    return _mm(V * lam_kept[..., None, :], _mT(V))


def _psd_newton(W, params, poll_every: int, rec):
    """PSD part (W + sign(W) W) / 2, sign(W) by the Newton-Schulz
    iteration Z <- 1.5 Z - 0.5 Z^3 from Z = W / scale, stopped per
    formation once ||Z_new - Z||_F / ||Z||_F < newton_tol."""
    dtype, dev = W.dtype, W.device
    nb, m, _ = W.shape
    # constants by fills: a tensor built from host data syncs the stream
    tiny = torch.full((), 1e-30, dtype=dtype, device=dev)
    if params.newton_scale == "spectral":
        # sigma_max from a 12-step power iteration, floored by a certified
        # bound over sqrt(3) with a 2% margin: the cubic iteration needs
        # a spectral norm strictly below sqrt(3)
        v = torch.full((nb, m), 1.0, dtype=dtype, device=dev) \
            / torch.full((), m, dtype=dtype, device=dev).sqrt()
        for _ in range(12):
            v = _mm(W, v[..., None])[..., 0]
            v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                     + tiny)
        sigma = torch.linalg.vector_norm(_mm(W, v[..., None])[..., 0], dim=-1)
        ub = torch.minimum(torch.linalg.vector_norm(W, dim=(-2, -1)),
                           W.abs().sum(-1).amax(-1))
        scale = torch.maximum(
            sigma * 1.15,
            1.02 * ub / torch.full((), 3.0, dtype=dtype, device=dev).sqrt()) \
            + tiny
    elif params.newton_scale == "fro":
        scale = torch.linalg.vector_norm(W, dim=(-2, -1)) + tiny
    else:
        raise ValueError(f"unknown newton_scale {params.newton_scale!r} "
                         "(expected 'spectral' or 'fro')")
    Z = W / scale[:, None, None]
    if params.newton_tol > 0.0:
        done = torch.zeros(nb, dtype=torch.bool, device=dev)
        steps = torch.zeros(nb, dtype=torch.int32, device=dev)
        for k in range(params.newton_iters):
            Znew = 1.5 * Z - 0.5 * _mm(_mm(Z, Z), Z)
            num = torch.sqrt(((Znew - Z) ** 2).sum((-2, -1)))
            den = torch.sqrt((Z ** 2).sum((-2, -1))) + tiny
            live = ~done
            Z = torch.where(live[:, None, None], Znew, Z)
            steps = steps + live.to(torch.int32)
            done = done | (num / den < params.newton_tol)
            rec["newton_run"] += 1
            if (k + 1) % poll_every == 0 and k + 1 < params.newton_iters:
                rec["host_reads"] += 1
                if bool(done.all()):  # torchcheck: disable=JC001 poll: one read per 4 Newton steps
                    break
        rec["newton_live"].append(steps)
    else:
        for _ in range(params.newton_iters):
            Z = 1.5 * Z - 0.5 * _mm(_mm(Z, Z), Z)
        rec["newton_run"] += params.newton_iters
    return (W + _mm(Z, W)) / 2.0


def _subproblem(Q, i_idx, j_idx, valid, d, params, warm, poll_every, rec,
                check: bool = False):
    """One (2D or 1D) gain subproblem over a batch of formations. Returns
    the full-space gains -Q Abar Q^T (`solver.cpp:143,207`), the final
    (X, S), the live ADMM steps and the last step's sum |X_new - X|, each
    per formation. ``check`` appends to ``rec["violated"]`` each
    formation's `admm_residual` predicate ((B,) bool on the device) and
    sets ``rec["ran_out"]`` when the loop spent its budget."""
    dtype, dev = Q.dtype, Q.device
    nb, _, dm = Q.shape
    mu = params.mu
    Cfun, Ct, Ginv_apply = _constraint_system(Q, i_idx, j_idx, valid, d)
    c = torch.zeros((nb, d * i_idx.shape[-1] + 1), dtype=dtype, device=dev)
    c[:, -1] = dm
    eye = torch.eye(dm, dtype=dtype, device=dev)

    def P_V(B):
        """Onto {structured symmetric} with <H_k, .> = 0 for every k."""
        B = _proj_struct(B, d)
        return B - Ct(Ginv_apply(Cfun(B)))

    def P_N(M):
        """Onto the homogeneous constraint null space."""
        out = torch.zeros_like(M)
        t = _trace(M[:, :dm, :dm]) / dm
        out[:, :dm, :dm] = t[:, None, None] * eye
        out[:, dm:, dm:] = P_V(M[:, dm:, dm:])
        return out

    # the min-norm affine point: X12 = X21 = I, X22 meets the constraints
    Xmin = torch.zeros((nb, 2 * dm, 2 * dm), dtype=dtype, device=dev)
    Xmin[:, :dm, dm:] = eye
    Xmin[:, dm:, :dm] = eye
    Xmin[:, dm:, dm:] = Ct(Ginv_apply(c))
    C = torch.zeros((2 * dm, 2 * dm), dtype=dtype, device=dev)
    C[:dm, :dm] = eye

    def W_of(D):
        """C - mat(A^T y) - mu X in projection form (`solver.cpp:283-297`)."""
        W = P_N(D) - mu * Xmin
        return (W + _mT(W)) / 2.0

    method = params.psd_method
    if method == "auto":
        method = "newton" if dtype == torch.float32 else "eigh"
    if method == "eigh":
        def psd(W):
            return _psd_eigh(W, params)
    else:
        def psd(W):
            return _psd_newton(W, params, poll_every, rec)

    if warm is None:
        X = torch.eye(dm, dtype=dtype, device=dev).repeat(nb, 2, 2)
        S = torch.zeros_like(X)
    else:
        # the cast bridges float32 carries into float64 solves and back
        X = warm[0].to(device=dev, dtype=dtype)
        S = warm[1].to(device=dev, dtype=dtype)
    stop = torch.zeros(nb, dtype=torch.bool, device=dev)
    steps = torch.zeros(nb, dtype=torch.int32, device=dev)
    diff = torch.zeros(nb, dtype=dtype, device=dev)
    first = None
    early = False
    for k in range(params.max_itr):
        W = W_of(C - S - mu * X) + S
        Snew = psd(W)
        Xnew = (Snew - W) / mu
        diffX = (Xnew - X).abs().sum((-2, -1))
        if check and k == 0:
            first = diffX
        tr = _trace(Xnew[:, dm:, dm:])
        now = (diffX < params.thresh) \
            | ((tr - dm) / dm < params.thresh_tr)   # signed, solver.cpp:328
        live = ~stop
        X = torch.where(live[:, None, None], Xnew, X)
        S = torch.where(live[:, None, None], Snew, S)
        diff = torch.where(live, diffX, diff)
        steps = steps + live.to(torch.int32)
        stop = stop | now
        if k + 1 < params.max_itr:
            rec["host_reads"] += 1
            if bool(stop.all()):  # torchcheck: disable=JC001 poll: one read per ADMM step
                early = True
                break
    rec["admm"].append(steps)
    if check:
        rec.setdefault("violated", []).append(
            invlib.admm_residual_violated(first, diff, stop))
        rec["ran_out"] = rec.get("ran_out", False) or not early

    # the final projection with S = 0 (`solver.cpp:333-346`)
    X22 = (-W_of(C - mu * X) / mu)[:, dm:, dm:]
    return -_mm(_mm(Q, X22), _mT(Q)), X, S, steps, diff


def _kernel_2d(pts_xy: np.ndarray) -> np.ndarray:
    """Q = orthogonal complement of [q, rot90(q), 1x, 1y]
    (`solver.cpp:160-188`), on the host with LAPACK's gesdd (see the
    module docstring for why not on the device)."""
    n = pts_xy.shape[0]
    q = pts_xy.reshape(-1)
    qbar = np.stack([-pts_xy[:, 1], pts_xy[:, 0]], 1).reshape(-1)
    ex = np.tile(np.asarray([1.0, 0.0], q.dtype), n)
    ey = np.tile(np.asarray([0.0, 1.0], q.dtype), n)
    N = np.column_stack([q, qbar, ex, ey])
    return scipy.linalg.svd(N, full_matrices=True,
                            lapack_driver="gesdd")[0][:, 4:]


def _kernel_1d(pts_z: np.ndarray, planar: bool) -> np.ndarray:
    """Q = orthogonal complement of [qz, 1] ([qz] if flat)
    (`solver.cpp:94-124`), on the host like `_kernel_2d`."""
    qz = pts_z.reshape(-1)
    N = qz[:, None] if planar else np.column_stack(
        [qz, np.ones(qz.shape[0], qz.dtype)])
    return scipy.linalg.svd(N, full_matrices=True,
                            lapack_driver="gesdd")[0][:, N.shape[1]:]


class Problem(NamedTuple):
    """A batch of gain-design problems on the device: the kernel bases,
    the padded non-edge slots and the adjacency masks."""

    q2: torch.Tensor        # (B, 2n, 2n-4)
    q1: torch.Tensor        # (B, n, n-1 or n-2)
    i_idx: torch.Tensor     # (B, K) int64, padded slots 0
    j_idx: torch.Tensor     # (B, K) int64
    valid: torch.Tensor     # (B, K) bool
    adjmask: torch.Tensor   # (B, n, n) bool, adjacency or diagonal


def _nonedges(adj: np.ndarray):
    iu, ju = np.triu_indices(adj.shape[0], k=1)
    off = adj[iu, ju] == 0
    return iu[off], ju[off]


def problem(points: np.ndarray, adjs: np.ndarray, planar: bool,
            max_nonedges: int | None, device) -> Problem:
    """Host preparation of (B, n, 3) points and (B, n, n) graphs: the
    non-edges padded to one bucket (default: the largest count), Q of
    each formation in the points' dtype (the 1D kernel by ``planar``),
    all moved to ``device``."""
    packs = [_nonedges(a) for a in adjs]
    ne_max = max(p[0].shape[0] for p in packs)
    K = ne_max if max_nonedges is None else max_nonedges
    if ne_max > K:
        raise ValueError(f"graph has {ne_max} non-edges > bucket {K}")
    K = max(K, 1)  # at least one (possibly padded) slot
    nb, n = points.shape[:2]
    i_b = np.zeros((nb, K), np.int64)
    j_b = np.zeros((nb, K), np.int64)
    v_b = np.zeros((nb, K), bool)
    for b, (ii, jj) in enumerate(packs):
        ne = ii.shape[0]
        i_b[b, :ne], j_b[b, :ne], v_b[b, :ne] = ii, jj, True
    adjmask = (adjs != 0) | np.eye(n, dtype=bool)[None]
    q2 = np.stack([_kernel_2d(p[:, :2]) for p in points])
    q1 = np.stack([_kernel_1d(p[:, 2], planar) for p in points])
    dev = torch.device(device)
    return Problem(q2=torch.from_numpy(q2).to(dev),
                   q1=torch.from_numpy(q1).to(dev),
                   i_idx=torch.from_numpy(i_b).to(dev),
                   j_idx=torch.from_numpy(j_b).to(dev),
                   valid=torch.from_numpy(v_b).to(dev),
                   adjmask=torch.from_numpy(adjmask).to(dev))


def new_record() -> dict:
    """What one solve counted: ADMM steps and live Newton steps (device
    tensors per call), Newton steps run (live or gated off) and host reads
    of a stop flag."""
    return {"admm": [], "newton_live": [], "newton_run": 0, "host_reads": 0}


def solve(prob: Problem, params: AdmmParams, warm=None,
          poll_every: int | None = None, rec: dict | None = None,
          check: bool = False):
    """The device solve of a `Problem` batch: (B, 3n, 3n) gains, the new
    (X2, S2, X1, S1) iterates, (B,) int32 ADMM iterations of both
    subproblems together and (B,) worse final residual. ``warm`` is a
    (B, ...)-batched (X2, S2, X1, S1) or None (cold). ``check``: each
    subproblem's `admm_residual` predicate lands in ``rec``
    (`_subproblem`)."""
    if poll_every is None:
        poll_every = POLL_EVERY if prob.q2.device.type == "cuda" else 1
    rec = new_record() if rec is None else rec
    A2d, X2, S2, it2, r2 = _subproblem(
        prob.q2, prob.i_idx, prob.j_idx, prob.valid, 2, params,
        None if warm is None else warm[:2], poll_every, rec, check)
    A1d, X1, S1, it1, r1 = _subproblem(
        prob.q1, prob.i_idx, prob.j_idx, prob.valid, 1, params,
        None if warm is None else warm[2:], poll_every, rec, check)
    nb, n = prob.adjmask.shape[:2]
    out = torch.zeros((nb, n, 3, n, 3), dtype=A2d.dtype, device=A2d.device)
    out[:, :, :2, :, :2] = A2d.reshape(nb, n, 2, n, 2)
    out[:, :, 2, :, 2] = A1d
    # non-edge blocks are structurally zero: masked exactly, so no float32
    # projection residue leaks communication outside the graph
    out = torch.where(prob.adjmask[:, :, None, :, None], out,
                      torch.zeros_like(out))
    flat = out.reshape(nb, 3 * n, 3 * n)
    # kill numerically-zero entries (`solver.cpp:144,208`)
    flat = torch.where(flat.abs() > params.thr_sparse_zero, flat,
                       torch.zeros_like(flat))
    return flat, (X2, S2, X1, S1), it2 + it1, torch.maximum(r2, r1)


def _device_of(points, device) -> torch.device:
    if isinstance(points, torch.Tensor):
        return points.device
    return resolve_device(device)


def solve_gains(points, adj,  # torchcheck: device-path
                params: AdmmParams | None = None,
                max_nonedges: int | None = None, check_mode: str = "off",
                telemetry: bool = False, carry: AdmmCarry | None = None,
                device=None, poll_every: int | None = None):
    """Design (3n, 3n) formation gains.

    ``max_nonedges`` pins the padded constraint bucket (e.g. n-4 for
    `simformN` graphs); the default is the exact non-edge count, and any
    bucket gives the same numbers. ``telemetry=True`` also returns an
    `AdmmSolveStats`. ``carry`` (an `AdmmCarry`, e.g. `init_carry` or a
    previous solve's) warm-starts both subproblems and makes the return
    ``(gains, new_carry)`` (``(gains, new_carry, stats)`` with
    telemetry). ``check_mode='on'`` checks the `admm_residual` contract on
    both subproblems and raises `InvariantViolation` (tick -1) when either
    ended neither converged nor below its first residual; a subproblem that
    stopped on its flags cannot violate it, so the code is read back only
    when one spent its whole budget. ``poll_every``: Newton steps between host reads of the
    stall flag (None = `POLL_EVERY` on a CUDA device, 1 on the CPU); any
    value gives the same result.

    Runs on the points' device when they are a tensor, else on
    ``device`` (None = the card), in the points' dtype.
    """
    params = params or AdmmParams()
    if check_mode not in ("off", "on"):
        raise ValueError(f"unknown check_mode {check_mode!r}")
    check = check_mode == "on"
    dev = _device_of(points, device)
    pts = _host_float(points)
    adj_np = to_host(adj)
    n = adj_np.shape[0]
    planar = planar_of(pts, params)
    if carry is not None:
        dm2, dm1 = 2 * n - 4, (n - 1) if planar else (n - 2)
        want = {"x2": (2 * dm2, 2 * dm2), "s2": (2 * dm2, 2 * dm2),
                "x1": (2 * dm1, 2 * dm1), "s1": (2 * dm1, 2 * dm1)}
        for field, shape in want.items():
            got = tuple(getattr(carry, field).shape)
            if got != shape:
                raise ValueError(
                    f"AdmmCarry.{field} has shape {got}, expected {shape} "
                    f"for n={n} planar={planar} — a carry only re-seeds "
                    "solves of the same size and planarity")
    prob = problem(pts[None], adj_np[None], planar, max_nonedges, dev)
    warm = None if carry is None else tuple(
        t[None] for t in (carry.x2, carry.s2, carry.x1, carry.s1))
    rec = new_record()
    flat, fin, iters, residual = solve(prob, params, warm, poll_every, rec,
                                       check)
    if check and rec["ran_out"] and bool(torch.any(  # torchcheck: disable=JC001 check_mode='on' only
            rec["violated"][0] | rec["violated"][1])):
        raise invlib.InvariantViolation(
            invlib.contract_of(invlib.CODES["admm_residual"]), tick=-1)
    gains = flat[0]
    out = (gains,)
    if carry is not None:
        out += (AdmmCarry(x2=fin[0][0], s2=fin[1][0], x1=fin[2][0],
                          s1=fin[3][0], iters=iters[0]),)
    if telemetry:
        out += (AdmmSolveStats(iters=int(iters[0]),  # torchcheck: disable=JC001 telemetry=True only
                               residual=float(residual[0])),)  # torchcheck: disable=JC001 telemetry=True only
    return out if len(out) > 1 else gains


def solve_gains_blocks(points, adj, params: AdmmParams | None = None,
                       device=None) -> torch.Tensor:
    """Same, in the (n, n, 3, 3) block layout."""
    return gains_from_flat(solve_gains(points, adj, params, device=device))


def solve_gains_f32(points, adj, params: AdmmParams | None = None,
                    max_nonedges: int | None = None,
                    carry: AdmmCarry | None = None, tol: float = 1e-4,
                    device=None):
    """A float32 solve gated by `validate_gains` at ``tol``: kept if the
    eigenstructure check passes, else the solve is repeated in the
    points' own dtype on the same device (the reference's semantics; no
    device or kernel fallback). Returns ``(gains, report)``, the report
    being `validate_gains`'s dict plus ``f32_ok`` (True = the float32
    solve was kept); with ``carry``, ``(gains, new_carry, report)`` with
    the carry of whichever solve was kept."""
    if isinstance(points, torch.Tensor):
        pts32 = points.to(torch.float32)
    else:
        pts32 = np.asarray(to_host(points), np.float32)
    out = solve_gains(pts32, adj, params=params, max_nonedges=max_nonedges,
                      carry=carry, device=device)
    gains, new_carry = out if carry is not None else (out, None)
    report = validate_gains(gains, points, tol=tol)
    ok = bool(report["no_positive"] and report["kernel_ok"]
              and report["strictly_negative_rest"])
    report = dict(report, f32_ok=ok)
    if not ok:
        out = solve_gains(points, adj, params=params,
                          max_nonedges=max_nonedges, carry=carry,
                          device=gains.device)
        gains, new_carry = out if carry is not None else (out, None)
    if carry is not None:
        return gains, new_carry, report
    return gains, report


def solve_gains_batch(points, adjs,  # torchcheck: device-path
                      params: AdmmParams | None = None,
                      max_nonedges: int | None = None, device=None,
                      poll_every: int | None = None) -> torch.Tensor:
    """Gains for a batch of formations in one program: (B, n, 3) points
    and (B, n, n) graphs -> (B, 3n, 3n). One padded bucket for all
    (``max_nonedges``, default the batch's largest count); the
    formations must agree on planarity. Each formation stops on its own
    flags, as in the serial `solve_gains`."""
    params = params or AdmmParams()
    dev = _device_of(points, device)
    pts = _host_float(points)
    adjs_np = to_host(adjs)
    if pts.ndim != 3 or adjs_np.ndim != 3:
        raise ValueError("solve_gains_batch wants stacked (B, n, 3) points "
                         f"and (B, n, n) adjacencies, got {pts.shape} / "
                         f"{adjs_np.shape}")
    flats = np.std(pts[:, :, 2], axis=1, ddof=1) < params.thr_planar
    if flats.any() and not flats.all():
        raise ValueError("batch mixes flat and non-flat formations — "
                         "planarity is compile-time; split the batch")
    prob = problem(pts, adjs_np, bool(flats.all()), max_nonedges, dev)  # torchcheck: disable=JC001 numpy flags
    return solve(prob, params, None, poll_every)[0]


def validate_gains(A, points, thr_planar: float = 1e-2,
                   tol: float = 1e-6) -> dict:
    """Eigenstructure self-check on the host (`aclswarm/src/aclswarm/
    control.py:221-261`): no positive eigenvalue, nullity 6 (5 for flat
    formations, population std <= ``thr_planar``), the rest strictly
    negative. ``tol`` bounds the kernel eigenvalues: 1e-6 is the
    reference's float64 check; float32 solves leave ~3e-5 there and are
    checked at 1e-4 or 2e-4. Returns booleans and the sorted eigenvalues."""
    A = to_host(A)
    points = to_host(points)
    flat = np.std(points[:, 2]) <= thr_planar
    nullity = 5 if flat else 6
    w = np.sort(np.real(np.linalg.eigvals(A)))
    return {
        "no_positive": bool(np.all(w < tol)),
        "kernel_ok": bool(np.linalg.norm(w[len(w) - nullity:]) <= tol),
        "strictly_negative_rest": bool(
            np.all(np.real(w[:len(w) - nullity]) < -1e-10)),
        "nullity": nullity,
        "eigenvalues": w,
    }


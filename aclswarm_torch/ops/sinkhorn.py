"""K1: log-domain Sinkhorn iterations (port of
`aclswarm_tpu/ops/sinkhorn_pallas.py`; kernel source `csrc/sinkhorn.cu`).

`sinkhorn_log` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (float32, contiguous, square) or raises.
Both take one cost ``(n, n)`` or a batch ``(B, n, n)`` with a leading trial
axis.
"""
from __future__ import annotations

import ctypes
import math

import torch

from aclswarm_torch.ops import _build


def sinkhorn_log_plain(cost: torch.Tensor, tau: float = 0.03,
                       n_iters: int = 200) -> torch.Tensor:
    """The reference's XLA formulation (`assignment/sinkhorn.py`
    `sinkhorn_log`): uniform marginals, f then g each iteration, returns
    the ([B,] n, n) log plan ``logK + f + g``. Any dtype, any device;
    leading axes are trials."""
    n = cost.shape[-1]
    logK = -cost / tau
    log_mu = torch.full((n,), -math.log(n), dtype=cost.dtype,
                        device=cost.device)
    f = torch.zeros(cost.shape[:-1], dtype=cost.dtype, device=cost.device)
    g = torch.zeros_like(f)
    for _ in range(n_iters):
        f = log_mu - torch.logsumexp(logK + g[..., None, :], dim=-1)
        g = log_mu - torch.logsumexp(logK + f[..., :, None], dim=-2)
    return logK + f[..., :, None] + g[..., None, :]


def sinkhorn_log(cost: torch.Tensor, tau: float = 0.03,
                 n_iters: int = 200) -> torch.Tensor:
    """([B,] n, n) costs -> ([B,] n, n) log transport plans. Where logK's
    row and column stripes fit in shared memory (n up to 1,849 on an
    H100) the kernel's entry point makes one cooperative launch per
    residency wave of solves (one wave for a single solve; at n = 1,000
    three solves share a wave), else 2 * n_iters + 2 launches per solve,
    and reports how many it made."""
    if cost.device.type == "cpu":
        return sinkhorn_log_plain(cost, tau, n_iters)
    *lead, n = cost.shape[:-1]
    if len(lead) > 1:
        raise ValueError("sinkhorn_log: at most one leading trial axis, got "
                         f"shape {tuple(cost.shape)}")
    _build.check(cost, "sinkhorn_log cost", torch.float32, (*lead, n, n))
    batch = lead[0] if lead else 1
    out = torch.empty_like(cost)
    # n zeroed 8-byte words per solve: the persistent design's tagged
    # entries
    f = torch.zeros((*lead, n), dtype=torch.int64, device=cost.device)
    g = torch.zeros_like(f)
    launched = ctypes.c_int(0)
    if batch:
        _build.launch("sinkhorn_log_batched_launch", cost.device,
                      cost.data_ptr(), out.data_ptr(), f.data_ptr(),
                      g.data_ptr(), batch, n, float(tau), int(n_iters),
                      -math.log(n), ctypes.byref(launched))
    _build.count_launch("sinkhorn_log", launched.value)
    return out

"""Assignment-permutation conventions (port of `aclswarm_tpu/core/perm.py`).

A permutation is a plain ``(n,)`` index tensor ``v2f``: ``v2f[v]`` is the
formation point assigned to vehicle ``v``; ``invert(v2f)[i]`` is the vehicle
assigned to point ``i``. All port code goes through these helpers so the
convention lives in one place.

Every helper also takes a batch of trials: ``v2f`` of shape ``(B, n)``
with the data ``(B, n, ...)``. A batch is gathered trial by trial on the
agent axis (`take`); an unbatched call indexes as it always has.
"""
from __future__ import annotations

import torch


def identity(n: int, device=None) -> torch.Tensor:
    """The identity assignment (vehicle v -> formation point v)."""
    from aclswarm_torch.core.types import resolve_device
    return torch.arange(n, dtype=torch.int32, device=resolve_device(device))


def invert(perm: torch.Tensor) -> torch.Tensor:
    """Invert a permutation index tensor: out[perm[k]] = k. A stable sort,
    as `jnp.argsort`, so even an invalid input inverts the same way."""
    return torch.argsort(perm, stable=True).to(perm.dtype)


def take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` indexed along axis ``dim`` by the last axis of ``idx``, whose
    leading axes are trial axes shared with ``x`` (``dim`` counts them).
    Unbatched ``idx``: plain indexing; batched: one gather."""
    lead = idx.ndim - 1
    if lead == 0:
        return x.index_select(dim, idx) if dim else x[idx]
    view = (idx.shape[:lead] + (1,) * (dim - lead) + idx.shape[lead:]
            + (1,) * (x.ndim - dim - 1))
    shape = x.shape[:dim] + idx.shape[lead:] + x.shape[dim + 1:]
    return torch.gather(x, dim, idx.reshape(view).expand(shape))


def veh_to_formation_order(x_veh: torch.Tensor,
                           v2f: torch.Tensor) -> torch.Tensor:
    """Permute vehicle-ordered rows into formation order:
    ``out[v2f[v]] = x_veh[v]``."""
    return take(x_veh, invert(v2f).long(), v2f.ndim - 1)


def formation_to_veh_order(x_form: torch.Tensor,
                           v2f: torch.Tensor) -> torch.Tensor:
    """Permute formation-ordered rows back to vehicle order."""
    return take(x_form, v2f.long(), v2f.ndim - 1)


def is_valid(perm: torch.Tensor) -> torch.Tensor:
    """([B,]) bool tensor: every index of 0..n-1 appears exactly once.
    Entries out of range count for nothing (no scatter ever sees them)."""
    n = perm.shape[-1]
    inrange = (perm >= 0) & (perm < n)
    counts = torch.zeros(perm.shape, dtype=torch.int32, device=perm.device)
    counts.scatter_add_(-1, perm.clamp(0, n - 1).long(),
                        inrange.to(torch.int32))
    return torch.all(counts == 1, dim=-1)


def comm_mask(adjmat: torch.Tensor, v2f: torch.Tensor,
              self_loop: bool = False,
              rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Vehicle-space communication graph: v hears w iff their formation
    points are adjacent under the current assignment,
    ``comm[v, w] = adjmat[v2f[v], v2f[w]] > 0``.

    The reference computes this as the one-hot conjugation P A P^T because
    a pointwise (n, n) gather serializes on its chip; on the GPU the
    double gather is one cheap kernel and the two n^3 products are not, so
    the port gathers. Boolean-identical results. ``self_loop=True`` adds
    the diagonal. ``rows=(lo, hi)`` gives receivers ``[lo, hi)`` only:
    the rows of the whole graph, bit for bit."""
    idx = v2f.long()
    if rows is not None:
        lo, hi = rows
        if idx.ndim == 1:
            comm = adjmat[idx[lo:hi]][:, idx] > 0
        else:
            lead = idx.ndim - 1
            comm = take(take(adjmat, idx[..., lo:hi], lead), idx,
                        lead + 1) > 0
        if self_loop:
            d = torch.arange(hi - lo, dtype=torch.int64, device=v2f.device)
            comm[..., d, d + lo] = True
        return comm
    if idx.ndim == 1:
        comm = adjmat[idx][:, idx] > 0
    else:
        lead = idx.ndim - 1
        comm = take(take(adjmat, idx, lead), idx, lead + 1) > 0
    if self_loop:
        comm = comm | torch.eye(v2f.shape[-1], dtype=torch.bool,
                                device=v2f.device)
    return comm


def take_pairs(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx][:, idx]`` of an agent-by-agent tensor ``x`` ([B,] n, n,
    ...), trial by trial for a batched ``idx``."""
    if idx.ndim == 1:
        return x[idx][:, idx]
    lead = idx.ndim - 1
    return take(take(x, idx, lead), idx, lead + 1)


def compose(outer: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """``compose(outer, inner)[v] = outer[inner[v]]``: apply ``inner``
    (vehicle -> formation point) first, then the formation-space
    relabeling ``outer``."""
    return take(outer, inner.long(), inner.ndim - 1)

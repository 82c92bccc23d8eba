"""Every collective of the agent-axis layout, one explicit call each.

The sharded step (`parallel.rollout`), the staged Sinkhorn
(`assignment.sinkhorn`) and the state placement (`parallel.mesh`) move
data between ranks only through the functions below, so the bytes and the
time of each kind can be counted in one place (`STATS`):

- ``gather``: `torch.distributed.all_gather` of each rank's row block,
  concatenated along the agent axis (axis 0, or 1 behind a trial axis).
  Its bytes are the gathered output's.
- ``reduce``: `torch.distributed.all_reduce` (MAX) of a small flag or
  counter vector. Its bytes are the vector's.
- ``broadcast``: `torch.distributed.broadcast` of one rank's block (the
  formation rows of a re-assignment). Its bytes are the block's.
- ``spill``: `torch.distributed.broadcast` of the replicated outputs,
  leaf by leaf on the device, from the mesh's first rank to the ranks
  outside it (an uneven world), after one small tensor of the leaves'
  shapes. Its bytes are the leaves' and the shapes'.

Every call takes a leaf whole, so a trial batch (a leading (B,) axis)
moves B times the bytes in the same number of calls. A mesh without a
process group (one process, no distributed runtime) makes every call the
identity and counts nothing. Bool tensors cross as uint8:
gloo reduces and gathers no bool.

``STATS[kind]`` holds ``calls``, ``bytes`` and ``seconds``. The seconds
are host wall time around each call, and with `timing(True)` each call is
bracketed by device synchronizations, so they are the collective's own
time (the chip phase turns it on for one measured run only: the
synchronizations cost the overlap an unmeasured run keeps).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

KINDS = ("gather", "reduce", "broadcast", "spill")
STATS = {k: {"calls": 0, "bytes": 0, "seconds": 0.0} for k in KINDS}
_LOCK = threading.Lock()
_TIMING = [False]


def reset_stats() -> None:
    with _LOCK:
        for k in KINDS:
            STATS[k].update(calls=0, bytes=0, seconds=0.0)


def stats() -> dict:
    """A copy of `STATS`."""
    with _LOCK:
        return {k: dict(v) for k, v in STATS.items()}


@contextlib.contextmanager
def timing(on: bool = True):
    """Bracket every collective with device synchronizations while the
    context is open, so `STATS` seconds are the collectives' own."""
    prev, _TIMING[0] = _TIMING[0], on
    try:
        yield
    finally:
        _TIMING[0] = prev


def _sync(t: torch.Tensor) -> None:
    if _TIMING[0] and t.is_cuda:
        torch.cuda.synchronize(t.device)  # torchcheck: disable=JC001 the opt-in timing bracket


@contextlib.contextmanager
def _counted(kind: str, nbytes: int, like: torch.Tensor):
    _sync(like)
    t0 = time.perf_counter()  # torchcheck: disable=JC004 a statistic, never a value of the step
    yield
    _sync(like)
    with _LOCK:
        s = STATS[kind]
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["seconds"] += time.perf_counter() - t0  # torchcheck: disable=JC004 a statistic, never a value of the step


def _wire(x: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def gather(x: torch.Tensor, mesh, axis: int = 0) -> torch.Tensor:
    """Every mesh rank's ``x`` (the same shape on each: a row block) in
    rank order, concatenated along the agent axis ``axis`` (1 for a leaf
    with a leading trial axis: one call moves the whole batch)."""
    if mesh.group is None:
        return x
    import torch.distributed as dist

    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    with _counted("gather", w.numel() * w.element_size() * mesh.size, w):
        dist.all_gather(parts, w, group=mesh.group)
    out = torch.cat(parts, dim=axis)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise max of ``x`` over the mesh ranks (bools: any)."""
    if mesh.group is None:
        return x
    import torch.distributed as dist

    w = _wire(x).clone()
    if w.dtype == torch.uint8:
        w = w.to(torch.int32)
    with _counted("reduce", w.numel() * w.element_size(), w):
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=mesh.group)
    return w.to(x.dtype)


def broadcast(x: torch.Tensor | None, src: int, like: torch.Tensor,
              mesh) -> torch.Tensor:
    """Mesh rank ``src``'s ``x`` on every mesh rank; the others pass None
    and ``like`` (a tensor of the block's shape and dtype)."""
    if mesh.group is None:
        return x
    import torch.distributed as dist

    buf = _wire(x) if mesh.index == src else torch.empty_like(_wire(like))
    with _counted("broadcast", buf.numel() * buf.element_size(), buf):
        dist.broadcast(buf, src=mesh.ranks[src], group=mesh.group)
    return buf.to(torch.bool) if like.dtype == torch.bool else buf


def map_tree(fn, tree, *rest):
    """``fn`` over the tensors of a container tree (dataclasses, named
    tuples, tuples, lists, dicts, None) and the same-shaped ``rest``,
    whose matching leaves may be anything (placements); other leaves come
    from ``tree`` unchanged. A dataclass keeps the attributes it carries
    beside its fields (a `Scenario`'s host copy of its onsets)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        out = type(tree)(**{k: map_tree(fn, getattr(tree, k),
                                        *(getattr(r, k) for r in rest))
                            for k in names})
        for k, v in vars(tree).items():
            if k not in names:
                setattr(out, k, v)
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return tree


_MAX_DIMS = 8


def _leaves(tree) -> list:
    out = []
    map_tree(lambda x: out.append(x) or x, tree)
    return out


def spill(obj, mesh):
    """The mesh's first rank's ``obj`` (a container tree) on the ranks
    outside the mesh, where ``obj`` is a tree of the same structure whose
    tensors give each leaf's dtype (any shape: the shapes cross first, as
    one int64 tensor); the mesh ranks get their own ``obj`` back. No-op
    when every rank is in the mesh. Every leaf crosses on the device."""
    if mesh.spill_group is None or (mesh.index is not None
                                    and mesh.index != 0):
        return obj
    import torch.distributed as dist

    src, group = mesh.ranks[0], mesh.spill_group
    leaves = _leaves(obj)
    if mesh.index == 0:
        if any(x.dim() > _MAX_DIMS for x in leaves):
            raise ValueError(f"spill carries at most {_MAX_DIMS} dims")
        head = torch.tensor([[x.dim(), *x.shape]
                             + [0] * (_MAX_DIMS - x.dim()) for x in leaves],
                            dtype=torch.int64).to(mesh.device)
    else:
        head = torch.empty((len(leaves), 1 + _MAX_DIMS), dtype=torch.int64,
                           device=mesh.device)
    with _counted("spill", head.numel() * head.element_size(), head):
        dist.broadcast(head, src=src, group=group)
    if mesh.index == 0:
        sent = [_wire(x) for x in leaves]
    else:
        shapes = head.tolist()  # torchcheck: disable=JC001 a receiver allocates its buffers
        sent = [torch.empty(s[1:1 + s[0]], dtype=_wire(x).dtype,
                            device=mesh.device)
                for s, x in zip(shapes, leaves)]
    for buf in sent:
        with _counted("spill", buf.numel() * buf.element_size(), buf):
            dist.broadcast(buf, src=src, group=group)
    if mesh.index == 0:
        return obj
    got = iter(buf.to(torch.bool) if x.dtype == torch.bool else buf
               for buf, x in zip(sent, leaves))
    return map_tree(lambda x: next(got), obj)

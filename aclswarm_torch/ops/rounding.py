"""K2: dominant-pair rounding (port of `aclswarm_tpu/ops/rounding_pallas.py`;
kernel source `csrc/rounding.cu`).

`round_dominant` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (float32, contiguous, square) or raises.
Both return the permutation and the number of rounds the loop ran. Both
take one plan ``(n, n)`` or a batch ``(B, n, n)`` with a leading trial
axis; on the card one launch serves up to one problem per SM.
"""
from __future__ import annotations

import ctypes
import math

import torch

from aclswarm_torch.ops import _build


def round_dominant_plain(plan_log: torch.Tensor,
                         max_rounds: int | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's XLA formulation (`assignment/sinkhorn.py`
    `round_dominant`): each round commits every (i, j) that is both its
    row's and its column's first-hit argmax, then strikes those rows and
    columns. The data-dependent loop runs on the host; a batch loops until
    its last plan is done, and a plan that is done (or out of rounds) no
    longer changes or counts rounds. Returns ([B,] n) int32 permutations
    and ([B,]) int32 rounds."""
    n = plan_log.shape[-1]
    lead = plan_log.shape[:-2]
    dev = plan_log.device
    idx = torch.arange(n, device=dev)
    if max_rounds is None:
        max_rounds = n
    scores = plan_log
    assign = torch.full((*lead, n), -1, dtype=torch.int32, device=dev)
    rounds = torch.zeros(lead, dtype=torch.int32, device=dev)
    while True:
        active = (assign < 0).any(dim=-1) & (rounds < max_rounds)
        if not bool(active.any()):
            break
        row_best = torch.argmax(scores, dim=-1)
        col_best = torch.argmax(scores, dim=-2)
        best = torch.gather(scores, -1, row_best[..., None])[..., 0]
        ok = (assign < 0) & (torch.gather(col_best, -1, row_best) == idx) \
            & (best > -math.inf) & active[..., None]
        assign = torch.where(ok, row_best.to(torch.int32), assign)
        # the reference scatters with a dropped sentinel index; torch has
        # no dropped scatter, so the uncommitted rows write a spare slot n
        # of their own plan, which is cut off
        col_struck = torch.zeros((*lead, n + 1), dtype=torch.bool,
                                 device=dev)
        col_struck.scatter_(-1, torch.where(ok, row_best, n), True)
        col_struck = col_struck[..., :n]
        scores = torch.where(ok[..., :, None] | col_struck[..., None, :],
                             torch.full_like(scores, -math.inf), scores)
        rounds = rounds + active.to(torch.int32)
    return assign, rounds


def scratch_words(n: int) -> int:
    """8-byte words of one problem's zeroed scratch (`carve` in
    `csrc/rounding.cu`): column keys, two buffers each of published row
    and column words, the blocks' beats, an entry count and four 4-byte
    counters."""
    return 6 * n + 3


def rescans(scratch: torch.Tensor, n: int) -> dict:
    """What a call's rounds after the first rescanned, read back from one
    problem's scratch (a host sync): rows, columns, and the entries they
    read."""
    ctr = scratch[6 * n + 1:].view(torch.int32).tolist()
    return {"rows": ctr[1], "cols": ctr[2], "entries": int(scratch[6 * n])}


def launch(plan_log: torch.Tensor, max_rounds: int | None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Run the kernel on a checked CUDA plan ``(n, n)`` or batch ``(B, n,
    n)``: (permutations, rounds, scratch ``([B,] 6n + 3)``, launches
    made)."""
    *lead, n = plan_log.shape[:-1]
    if len(lead) > 1:
        raise ValueError("round_dominant: at most one leading trial axis, "
                         f"got shape {tuple(plan_log.shape)}")
    _build.check(plan_log, "round_dominant plan", torch.float32,
                 (*lead, n, n))
    batch = lead[0] if lead else 1
    dev = plan_log.device
    out = torch.empty((*lead, n), dtype=torch.int32, device=dev)
    rounds = torch.empty(tuple(lead), dtype=torch.int32, device=dev)
    scratch = torch.zeros((*lead, scratch_words(n)), dtype=torch.int64,
                          device=dev)
    launched = ctypes.c_int(0)
    if batch:
        _build.launch("round_dominant_batched_launch", dev,
                      plan_log.data_ptr(), out.data_ptr(), rounds.data_ptr(),
                      scratch.data_ptr(), batch, n,
                      n if max_rounds is None else int(max_rounds),
                      ctypes.byref(launched))
    return out, rounds, scratch, launched.value


def round_dominant(plan_log: torch.Tensor, max_rounds: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """([B,] n, n) log plans -> (([B,] n) int32 permutations, ([B,]) int32
    rounds). On the card: one cooperative launch per call for up to one
    plan per SM, any n that fits the card."""
    if plan_log.device.type == "cpu":
        return round_dominant_plain(plan_log, max_rounds)
    out, rounds, _, launched = launch(plan_log, max_rounds)
    _build.count_launch("round_dominant", launched)
    return out, rounds

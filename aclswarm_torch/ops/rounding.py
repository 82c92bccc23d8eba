"""K2: dominant-pair rounding (port of `aclswarm_tpu/ops/rounding_pallas.py`;
kernel source `csrc/rounding.cu`).

`round_dominant` is the wrapper: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel (float32, contiguous, square) or raises.
Both return the permutation and the number of rounds the loop ran.
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
    columns. The data-dependent loop runs on the host. Returns ((n,) int32
    permutation, () int32 rounds)."""
    n = plan_log.shape[0]
    dev = plan_log.device
    idx = torch.arange(n, device=dev)
    if max_rounds is None:
        max_rounds = n
    scores = plan_log
    assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rounds = 0
    while rounds < max_rounds and bool((assign < 0).any()):
        row_best = torch.argmax(scores, dim=1)
        col_best = torch.argmax(scores, dim=0)
        ok = (assign < 0) & (col_best[row_best] == idx) \
            & (scores[idx, row_best] > -math.inf)
        assign = torch.where(ok, row_best.to(torch.int32), assign)
        # the reference scatters with a dropped sentinel index; torch has
        # no dropped scatter, so only committed columns are written
        col_struck = torch.zeros((n,), dtype=torch.bool, device=dev)
        col_struck[row_best[ok]] = True
        scores = torch.where(ok[:, None] | col_struck[None, :],
                             torch.full_like(scores, -math.inf), scores)
        rounds += 1
    return assign, torch.tensor(rounds, dtype=torch.int32, device=dev)


def scratch_words(n: int) -> int:
    """8-byte words of the kernel's zeroed scratch (`carve` in
    `csrc/rounding.cu`): column keys, two buffers each of published row
    and column words, the blocks' beats, an entry count and four 4-byte
    counters."""
    return 6 * n + 3


def rescans(scratch: torch.Tensor, n: int) -> dict:
    """What a call's rounds after the first rescanned, read back from its
    scratch (a host sync): rows, columns, and the entries they read."""
    ctr = scratch[6 * n + 1:].view(torch.int32).tolist()
    return {"rows": ctr[1], "cols": ctr[2], "entries": int(scratch[6 * n])}


def launch(plan_log: torch.Tensor, max_rounds: int | None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Run the kernel on a checked CUDA plan: (permutation, rounds,
    scratch, launches made)."""
    n = plan_log.shape[0]
    _build.check(plan_log, "round_dominant plan", torch.float32, (n, n))
    dev = plan_log.device
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    rounds = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.zeros((scratch_words(n),), dtype=torch.int64, device=dev)
    launched = ctypes.c_int(0)
    _build.launch("round_dominant_launch", dev, plan_log.data_ptr(),
                  out.data_ptr(), rounds.data_ptr(), scratch.data_ptr(), n,
                  n if max_rounds is None else int(max_rounds),
                  ctypes.byref(launched))
    return out, rounds, scratch, launched.value


def round_dominant(plan_log: torch.Tensor, max_rounds: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, n) log plan -> ((n,) int32 permutation, () int32 rounds). On the
    card: one cooperative launch per call, any n that fits the card."""
    if plan_log.device.type == "cpu":
        return round_dominant_plain(plan_log, max_rounds)
    out, rounds, _, launched = launch(plan_log, max_rounds)
    _build.LAUNCHES["round_dominant"] += launched
    return out, rounds

"""K3: the flood merge's masked min over senders (port of
`aclswarm_tpu/ops/flood_pallas.py`; kernel source `csrc/flood.cu`).

`flood_merge` is the wrapper: CPU tensors take the plain version, CUDA
tensors launch the kernel (int32 packed, bool comm, both contiguous) or
raise. Both take one problem, ``(n, w)`` and ``(n, n)``, or a batch of
them with a leading trial axis, ``(B, n, w)`` and ``(B, n, n)``: one launch
serves the whole batch.
"""
from __future__ import annotations

import torch

from aclswarm_torch.ops import _build

SENTINEL = 2**31 - 1


def _masked_min(packed: torch.Tensor, comm: torch.Tensor) -> torch.Tensor:
    cand = torch.where(comm[..., :, :, None], packed[..., None, :, :],
                       SENTINEL)
    return cand.amin(dim=-2)


def flood_merge_plain(packed: torch.Tensor, comm: torch.Tensor,
                      block: int | None = None) -> torch.Tensor:
    """The reference's dense `block_merge` (`sim/localization.py`):
    ``out[..., v, j] = min_{s: comm[..., v, s]} packed[..., s, j]``,
    SENTINEL where v has no sender. ``block`` = B walks the target axis in
    blocks of B (peak memory O(n^2 B), bit-identical: the merge is
    independent per target). Leading axes are trials."""
    w = packed.shape[-1]
    if block is None or block >= w:
        return _masked_min(packed, comm)
    return torch.cat([_masked_min(packed[..., b:b + block], comm)
                      for b in range(0, w, block)], dim=-1)


def flood_merge(packed: torch.Tensor, comm: torch.Tensor,
                block: int | None = None) -> torch.Tensor:
    """([B,] n, w) packed (senders x targets) + ([B,] n, n) comm -> ([B,] n,
    w) best packed per (receiver, target). ``block`` applies to the plain
    version only (the kernel bounds its memory by tiling, as the
    reference's Pallas merge takes precedence over its target blocking)."""
    if packed.device.type == "cpu":
        return flood_merge_plain(packed, comm, block)
    *lead, n, w = packed.shape
    if len(lead) > 1:
        raise ValueError("flood_merge: at most one leading trial axis, got "
                         f"shape {tuple(packed.shape)}")
    batch = lead[0] if lead else 1
    _build.check(packed, "flood_merge packed", torch.int32, (*lead, n, w))
    _build.check(comm, "flood_merge comm", torch.bool, (*lead, n, n))
    out = torch.empty_like(packed)
    if out.numel() == 0:
        return out
    # bool is one byte {0, 1}: the kernel reads the mask as uint8
    _build.launch("flood_merge_launch", packed.device, packed.data_ptr(),
                  comm.data_ptr(), out.data_ptr(), batch, n, w)
    _build.LAUNCHES["flood_merge"] += 1
    return out

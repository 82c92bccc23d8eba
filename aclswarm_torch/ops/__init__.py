"""Hand-written CUDA kernels for Hopper (port of `aclswarm_tpu.ops`).

Each module holds a kernel's wrapper and its plain PyTorch version:

- `sinkhorn` — K1, log-domain Sinkhorn iterations (`csrc/sinkhorn.cu`);
- `rounding` — K2, dominant-pair rounding (`csrc/rounding.cu`);
- `flood`    — K3, the flood merge's masked min (`csrc/flood.cu`).

A wrapper takes the plain version only for CPU tensors; a CUDA tensor
launches the kernel or raises. `_build` compiles the sources at first
use (one ``nvcc`` per source in parallel, one link) and counts launches
(`_build.LAUNCHES`).
"""
from aclswarm_torch.ops._build import LAUNCHES, build, reset_launches
from aclswarm_torch.ops.flood import flood_merge, flood_merge_plain
from aclswarm_torch.ops.rounding import round_dominant, round_dominant_plain
from aclswarm_torch.ops.sinkhorn import sinkhorn_log, sinkhorn_log_plain

__all__ = ["LAUNCHES", "build", "reset_launches",
           "sinkhorn_log", "sinkhorn_log_plain",
           "round_dominant", "round_dominant_plain",
           "flood_merge", "flood_merge_plain"]

"""Operations and bytes of the port's three kernels, and the peaks of one
NVIDIA H100 they are held against.

A kernel's roofline share is the least time the card could take for the
work, the larger of operations over the peak rate and bytes over the peak
bandwidth, over the kernel's measured device time. The counts follow the
inputs: each input byte read once, each output byte written once, the work
these inputs need.

- K1, log-domain Sinkhorn (`csrc/sinkhorn.cu`): per problem of n x n and
  ``iters`` iterations, 10 n^2 operations an iteration (a row and a column
  logsumexp over the plan: add, max, subtract, exp, sum) and 2 n^2 to
  scale the cost and form the plan; bytes: the cost read and the plan
  written, 8 n^2.
- K2, dominant-pair rounding (`csrc/rounding.cu`): the plan read once and
  the permutation written, 4 n^2 + 4 n bytes a problem; memory-bound.
- K3, the flood merge (`csrc/flood.cu`): an add-min for every receiver,
  sender it hears and target of the stripe, 2 nnz(comm) w operations a
  trial; bytes: the packed (n, w) table read, the (n, n) mask read as
  bytes, the (n, w) result written.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12     # HBM3

# the kernels' names in a device trace
KERNELS = {
    "K1": ("sinkhorn_persistent_kernel", "neg_scale_kernel",
           "row_lse_kernel", "col_lse_kernel", "add_potentials_kernel"),
    "K2": ("round_dominant_kernel", "round_persistent_kernel"),
    "K3": ("flood_merge_kernel", "flood_merge_bytemask_kernel"),
}


def k1_counts(n: int, iters: int, problems: int = 1) -> tuple[float, float]:
    return (problems * (10.0 * n * n * iters + 2.0 * n * n),
            problems * 8.0 * n * n)


def k2_counts(n: int, problems: int = 1) -> tuple[float, float]:
    return 0.0, problems * (4.0 * n * n + 4.0 * n)


def k3_counts(n: int, w: int, nnz: list) -> tuple[float, float]:
    """``nnz``: the mask's entries set, one per trial of the call."""
    return (sum(2.0 * z * w for z in nnz),
            len(nnz) * (4.0 * n * w + 1.0 * n * n + 4.0 * n * w))


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work on one H100, and what bounds it."""
    t_ops, t_mem = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def kernel_time(kernel_s: dict, which: str) -> float:
    names = KERNELS[which]
    return sum(v for k, v in kernel_s.items()
               if any(k.startswith(nm) or nm + "(" in k for nm in names))


def share(reading, which: str):
    """A kernel's roofline share (%) over the device-only traced chunk, or
    None if it did not run there."""
    t = kernel_time(reading.kernel_s, which)
    calls = [c for k, c in reading.kernel_calls if k == which]
    if t <= 0.0 or not calls:
        return None
    need = 0.0
    for c in calls:
        shape = c["shape"]
        problems = 1 if len(shape) == 2 else shape[0]
        if which == "K1":
            ops, nb = k1_counts(shape[-1], c["iters"], problems)
        elif which == "K2":
            ops, nb = k2_counts(shape[-1], problems)
        else:
            nnz = (reading.adjacency_nnz if len(shape) == 3
                   else reading.adjacency_nnz[:1])
            ops, nb = k3_counts(shape[-2], shape[-1], nnz)
        need += bound_s(ops, nb)[0]
    return 100.0 * need / t

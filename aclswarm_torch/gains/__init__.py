"""Formation gain design (port of `aclswarm_tpu/gains/`).

- ``admm``   — the projection-form ADMM solver, PyTorch tensor code on the
               device (the reference computes it in XLA; it has no Pallas
               kernel).
- ``params`` — `AdmmParams`, the port's copy of the reference's.
- ``reference`` — the sequential NumPy mirror of the C++ solver, the
               oracle (a copy of the reference's; imported on its own).
- ``sdp``    — the independent original-SDP oracle, projected
               supergradient ascent in NumPy (a copy of the reference's;
               imported on its own).
"""
from aclswarm_torch.gains.admm import (AdmmCarry, AdmmSolveStats, init_carry,
                                       planar_of, solve_gains,
                                       solve_gains_batch, solve_gains_blocks,
                                       solve_gains_f32, validate_gains)
from aclswarm_torch.gains.params import AdmmParams

__all__ = ["AdmmCarry", "AdmmSolveStats", "init_carry", "planar_of",
           "solve_gains", "solve_gains_batch", "solve_gains_blocks",
           "solve_gains_f32", "validate_gains", "AdmmParams"]

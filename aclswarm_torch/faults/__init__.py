"""Fault masks (port of `aclswarm_tpu.faults`): the masked-assignment
helpers. The fault schedule (scripted dropout and lossy links) is not
ported yet; its masks reach the solvers through `sim.engine.assign`."""
from aclswarm_torch.faults.masking import (alive_points, apply_pin_forbid,
                                           mask_cost, pin_forbid)

__all__ = ["alive_points", "pin_forbid", "mask_cost", "apply_pin_forbid"]

"""Formation control + safety shim (port of `aclswarm_tpu.control`)."""
from aclswarm_torch.control.colavoid import collision_avoidance, wrap_to_pi
from aclswarm_torch.control.distcntrl import (compute, compute_rows,
                                              scale_control)
from aclswarm_torch.control.safety import (TrajGoal, make_safe_traj,
                                           rate_limit, saturate_velocity)

__all__ = [
    "compute", "compute_rows", "scale_control",
    "collision_avoidance", "wrap_to_pi",
    "TrajGoal", "make_safe_traj", "rate_limit", "saturate_velocity",
]

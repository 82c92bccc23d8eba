"""Trial harness (port of `aclswarm_tpu.harness`): the formation library
loader, the random formation generator, the supervisor FSM and its
post-hoc oracle (`evaluate`), and the serial trial driver
(`aclswarm_torch.harness.trials`, imported on its own so that ``python -m
aclswarm_torch.harness.trials`` runs it)."""
from aclswarm_torch.harness import formations, formgen, supervisor
from aclswarm_torch.harness.supervisor import (TrialFSM, TrialResult,
                                               TrialState, evaluate)

__all__ = ["formations", "formgen", "supervisor", "TrialResult",
           "TrialFSM", "TrialState", "evaluate"]

"""The agent axis over `torch.distributed` (port of
`aclswarm_tpu.parallel`): the mesh and its placements, the sharded step
and rollout, the multi-process handshake, and the launch program."""
from aclswarm_torch.parallel.mesh import (AGENT_AXIS, formation_sharding,
                                          make_mesh, replicated,
                                          row_sharding, shard_problem,
                                          sim_state_sharding)
from aclswarm_torch.parallel import multihost
from aclswarm_torch.parallel.rollout import (batched_formation_sharding,
                                             batched_rollout_fn,
                                             batched_sim_state_sharding,
                                             sharded_rollout_fn,
                                             sharded_step_fn)

__all__ = ["AGENT_AXIS", "make_mesh", "row_sharding", "replicated",
           "sim_state_sharding", "formation_sharding", "shard_problem",
           "sharded_step_fn", "sharded_rollout_fn", "batched_rollout_fn",
           "batched_sim_state_sharding", "batched_formation_sharding",
           "multihost"]

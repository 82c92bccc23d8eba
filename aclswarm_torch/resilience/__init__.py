"""Checkpoint, resume and retry (port of `aclswarm_tpu.resilience`): the
framed checkpoint codec with its validated manifest and its append-only
frame log (`checkpoint`), scripted preemption (`crash`), and the chunk
executor that retries transient device failures (`executor`).

The reference's executor re-runs a chunk on the CPU once its retries are
spent; the port's records the failure and raises instead."""
from aclswarm_torch.resilience.checkpoint import (CheckpointCorrupt,
                                                  CheckpointError,
                                                  CheckpointMismatch,
                                                  clear_checkpoints,
                                                  config_hash,
                                                  dtype_fingerprint,
                                                  expected_manifest,
                                                  latest_checkpoint,
                                                  load_checkpoint,
                                                  make_manifest,
                                                  restore_state,
                                                  write_checkpoint)
from aclswarm_torch.resilience.crash import (CrashPlan, InjectedCrash,
                                             active_plan, active_plans, arm,
                                             arm_many, maybe_crash)
from aclswarm_torch.resilience.executor import (ChunkExecutor,
                                                is_transient_device_error)

__all__ = [
    "CheckpointCorrupt", "CheckpointError", "CheckpointMismatch",
    "clear_checkpoints", "config_hash", "dtype_fingerprint",
    "expected_manifest", "latest_checkpoint", "load_checkpoint",
    "make_manifest", "restore_state", "write_checkpoint",
    "CrashPlan", "InjectedCrash", "active_plan", "active_plans", "arm",
    "arm_many", "maybe_crash",
    "ChunkExecutor", "is_transient_device_error",
]

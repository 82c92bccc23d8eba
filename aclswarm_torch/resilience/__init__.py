"""Checkpoint and resume for the trial driver (port of
`aclswarm_tpu.resilience`): the framed checkpoint codec with its
validated manifest (`checkpoint`) and scripted preemption (`crash`).

The reference's `ChunkExecutor`, which re-runs a failed chunk on the CPU,
has no counterpart: a failing chunk on the card raises."""
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
from aclswarm_torch.resilience.crash import (CrashPlan, InjectedCrash, arm,
                                             maybe_crash)

__all__ = [
    "CheckpointCorrupt", "CheckpointError", "CheckpointMismatch",
    "clear_checkpoints", "config_hash", "dtype_fingerprint",
    "expected_manifest", "latest_checkpoint", "load_checkpoint",
    "make_manifest", "restore_state", "write_checkpoint",
    "CrashPlan", "InjectedCrash", "arm", "maybe_crash",
]

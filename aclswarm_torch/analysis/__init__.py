"""Runtime analysis (port of `aclswarm_tpu.analysis`): the invariant
sanitizer, `analysis.invariants`."""

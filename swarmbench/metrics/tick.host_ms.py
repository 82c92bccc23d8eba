"""Host milliseconds inside `sim.engine.step` per batched tick, over the
traced run's chunks that no profiler slowed (host syncs inside the tick
count here too)."""


def read(r):
    return r.host_step_ms

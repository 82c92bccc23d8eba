"""Device-busy milliseconds per batched tick, in the device-only traced
chunk: the steady statistic beside `sim_s_per_s`, which the host's speed
moves from run to run while this does not."""


def read(r):
    return 1e3 * r.busy_s / r.ticks if r.ticks else None

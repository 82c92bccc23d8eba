"""Device milliseconds of the kernels launched inside the localization
tick (`sim.localization.tick_phased`, or `tick`) per batched tick."""

SPANS = ("localization.tick_phased", "localization.tick")


def read(r):
    s = sum(r.span_device_s.get(k, 0.0) for k in SPANS)
    if not any(r.span_calls.get(k) for k in SPANS):
        return None
    return 1e3 * s / r.ticks

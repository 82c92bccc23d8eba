"""Device milliseconds of the kernels launched inside the control law
(`control.compute`) per batched tick."""


def read(r):
    if not r.span_calls.get("control.compute"):
        return None
    return 1e3 * r.span_device_s["control.compute"] / r.ticks

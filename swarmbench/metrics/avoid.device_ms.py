"""Device milliseconds of the kernels launched inside the avoidance shim
(`control.collision_avoidance`) per batched tick."""


def read(r):
    if not r.span_calls.get("control.collision_avoidance"):
        return None
    return 1e3 * r.span_device_s["control.collision_avoidance"] \
        / r.ticks

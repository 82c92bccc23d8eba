"""Device milliseconds of the kernels launched inside `sim.engine.assign`
(its outermost calls) per auction tick, in the spans chunk."""


def read(r):
    calls = r.span_calls.get("engine.assign", 0)
    if not calls:
        return None
    return 1e3 * r.span_device_s["engine.assign"] / calls

"""Share of the device-only traced chunk in which no kernel ran (%)."""


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s else None

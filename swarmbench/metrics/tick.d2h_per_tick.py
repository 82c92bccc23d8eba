"""Device-to-host copies per batched tick, in the device-only traced
chunk (each is a host read of a device value)."""


def read(r):
    return r.d2h / r.ticks if r.ticks else None

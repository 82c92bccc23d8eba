"""Peak device memory allocated over the window (GB)."""


def read(r):
    return r.peak_bytes / 1e9 if r.peak_bytes else None

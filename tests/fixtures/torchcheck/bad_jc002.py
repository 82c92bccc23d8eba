"""JC002 fixture: Python control flow on tensor values."""
import torch


def branch_on_arg(x, threshold: float = 0.5):  # torchcheck: device-path
    if x > threshold:                           # JC002 (x a tensor)
        return x * 2
    return x


def while_on_arg(x):  # torchcheck: device-path
    while x < 10.0:                             # JC002 (x a tensor)
        x = x + 1.0
    return x


def ifexp_on_arg(q):  # torchcheck: device-path
    return q * 2 if q.sum() else q              # JC002 (q a tensor)


def allowed_patterns(x, mask=None, n_iters: int = 5,  # torchcheck: device-path
                     mode: str = "fast"):
    if mask is None:                            # ok: is-None dispatch
        mask = torch.ones_like(x)
    if mode == "fast":                          # ok: string mode switch
        x = x * 2
    if n_iters > 3:                             # ok: static annotation
        x = x + 1
    if x.ndim == 2:                             # ok: shape introspection
        x = x[0]
    return x * mask

"""JC003 fixture: dtype-less tensor constructors."""
import dataclasses

import torch


def weak_scalar(x):  # torchcheck: device-path
    return x + torch.tensor(1.0)                # JC003 (Python scalar)


def caller_dtype(q0):  # torchcheck: device-path
    return torch.as_tensor(q0) * 2              # JC003 (inherits caller)


def default_dtype(x):  # torchcheck: device-path
    return x + torch.zeros(3)                   # JC003 (global default)


@dataclasses.dataclass
class Carry:
    flag: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(True))    # ok: bool
    level: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.full((), 0.0))   # JC003 (factory)


def explicit_ok(x):  # torchcheck: device-path
    a = torch.tensor(1.0, dtype=torch.float32)  # ok: explicit dtype
    b = torch.zeros(3, dtype=x.dtype)           # ok: dtype kwarg
    c = torch.as_tensor(x.sum() * 2)            # ok: a tensor expression
    d = torch.zeros_like(x)                     # ok: x's dtype
    return a + b + c + d

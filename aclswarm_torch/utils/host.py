"""A leaf on the host: the one helper the host-side tools read device or
numpy data through."""
from __future__ import annotations

import numpy as np


def to_host(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor (on any device) crosses once,
    anything else passes through `np.asarray`."""
    if hasattr(x, "detach"):             # a torch tensor, on any device
        return x.detach().cpu().numpy()  # torchcheck: disable=JC001 the caller's host input
    return np.asarray(x)  # torchcheck: disable=JC001 the caller's host input

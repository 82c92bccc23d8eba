"""JC004 fixture: host nondeterminism on the device path."""
import random
import time

import numpy as np
import torch


def stamped(x):  # torchcheck: device-path
    return x + time.time()                      # JC004 (time.time)


def np_randomness(x):  # torchcheck: device-path
    return x + np.random.normal()               # JC004 (np.random)


def global_generator(x):  # torchcheck: device-path
    noise = torch.randn(x.shape, dtype=x.dtype)  # JC004 (global generator)
    gen = torch.Generator().manual_seed(0)
    seeded = torch.rand(x.shape, generator=gen)  # ok: its own generator
    return x + noise + seeded + helper(x)


def helper(x):
    return x * random.random()                  # JC004 (stdlib random)


def host_only_timing():
    # NOT reachable from the device path: benchmarks time on the host
    t0 = time.perf_counter()
    return time.perf_counter() - t0

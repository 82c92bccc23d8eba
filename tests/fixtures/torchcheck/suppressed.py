"""Escape-hatch fixture: every violation here is explicitly disabled."""
import numpy as np
import torch


def intentional_sync(x):  # torchcheck: device-path
    return np.asarray(x)          # torchcheck: disable=JC001 a reason


def intentional_branch(x):  # torchcheck: device-path
    if x > 0:                     # torchcheck: disable
        return x
    return -x


def multi_rule(x):  # torchcheck: device-path
    return torch.zeros(int(x))    # torchcheck: disable=JC001,JC003 why

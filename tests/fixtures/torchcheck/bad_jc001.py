"""JC001 fixture: host syncs reachable from the device path (every one
must fire)."""
import numpy as np
import torch


def direct_item(x):  # torchcheck: device-path
    return x.sum().item()                       # JC001 (.item)


def direct_float(x):  # torchcheck: device-path
    return float(x[0]) * 2.0                    # JC001 (float)


def np_pull(x):  # torchcheck: device-path
    return np.asarray(x) + 1                    # JC001 (np.asarray)


def helper(x):
    # not itself marked — reachable from the marked `via_helper` below
    return x.cpu()                              # JC001 (.cpu)


def via_helper(x):  # torchcheck: device-path
    return helper(x * 2)


def poll(done):  # torchcheck: device-path
    stop = bool(done.any())                     # JC001 (bool)
    torch.cuda.synchronize()                    # JC001 (synchronize)
    return stop, int(done.shape[0])             # ok: a shape is host data


def host_only(x):
    # NOT reachable from any device-path root: must NOT fire
    return float(np.asarray(x).sum())

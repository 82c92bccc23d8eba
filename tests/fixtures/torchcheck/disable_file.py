"""File-level escape hatch fixture: every rule below would fire, but the
file-wide pragma silences the named ones for the whole file.

# torchcheck: disable-file=JC001,JC004
"""
import random
import time

import numpy as np


def would_trip_jc001(x):  # torchcheck: device-path
    y = np.asarray(x)           # JC001, file-disabled
    return y.item()             # JC001, file-disabled


def would_trip_jc004(x):  # torchcheck: device-path
    return x * time.time() + random.random()    # JC004 x2, file-disabled

"""K2's share of its roofline on one H100 (%): the least time its calls
in the device-only chunk need, by `swarmbench.roofline`, over its device
time there; nothing when it did not run."""
from swarmbench import roofline


def read(r):
    return roofline.share(r, "K2")

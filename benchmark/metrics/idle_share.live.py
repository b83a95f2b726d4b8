"""%: the traced window's idle share of the device."""
from benchmark.counts import shares


def read(run):
    return shares.idle_share(run)

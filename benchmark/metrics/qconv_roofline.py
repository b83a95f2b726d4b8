"""%: qconv's share of its roofline in the traced window."""
from benchmark.counts import shares


def read(run):
    return shares.qconv_roofline(run)

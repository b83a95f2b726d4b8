"""%: the model's share of the tensor-core peak at the window's frames/s
(`counts.shares.step_mfu`)."""
from benchmark.counts import shares


def read(run):
    return shares.step_mfu(run)

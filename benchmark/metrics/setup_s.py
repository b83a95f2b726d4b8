"""s: from the process's start to the window: imports, weights and frames
from the seed, kernel builds (a first run), int8 calibration, the step's
preparation and the warm calls."""


def read(run):
    return run.setup_s

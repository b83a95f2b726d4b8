"""ms: the 95th percentile, over every call of the window, of the time
from the call to its px counts on the host."""
import numpy as np


def read(run):
    lat = [(c.done - c.issued) * 1e3 for c in run.window.calls]
    return float(np.percentile(lat, 95)) if lat else None

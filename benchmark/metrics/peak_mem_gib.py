"""GiB: the peak of `torch.cuda.max_memory_allocated` over the measured
window (reset after set-up and the warm calls)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None

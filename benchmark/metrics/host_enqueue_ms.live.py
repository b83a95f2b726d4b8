"""ms: the mean, over the window's calls, of the host's time from the
call until `step` returns (its work enqueued, before the sync)."""


def read(run):
    calls = run.window.calls
    return sum(c.returned - c.issued for c in calls) / len(calls) * 1e3 if calls else None

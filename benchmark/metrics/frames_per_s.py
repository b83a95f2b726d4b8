"""frames/s: every frame whose px counts reached the host in the window,
over the window's time (first issue to last completion)."""


def read(run):
    return run.window.frames / run.window.seconds

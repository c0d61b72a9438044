"""Time steps of every transient completed in the window, over the
window's host-clock time (the transient running at the deadline is
finished and counted, and ends the window)."""


def read(run):
    return sum(u["steps"] for u in run.units) / run.window_s

"""Configurations whose whole transient completed in the window, over the
window's host-clock time (the sweep running at the deadline is finished
and counted, and ends the window)."""


def read(run):
    return sum(u["configs"] for u in run.units) / run.window_s

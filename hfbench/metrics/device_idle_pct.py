"""The share of the traced window in which no device operation ran:
1 - (device events merged) / (the window's host-clock length)."""


def read(run):
    if not run.profile or not run.profile["timeline"]:
        return None
    return 100.0 * (1.0 - run.profile["busy_us"] / 1e6 / run.window_s)

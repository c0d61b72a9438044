"""Device idle time between K1's solves (from one solve's k_finish to the
next one's k_init: the step's own work around the solve), a transient,
over the traced window (the frozen ``idle_split``)."""

from hfbench.reference.chipmath import idle_split


def read(run):
    if not run.profile:
        return None
    split = idle_split(run.profile["timeline"], "k_init", "k_finish")
    if split["solves"] == 0:
        return None
    return split["idle_between_solves_us"] / len(run.units) / 1e3

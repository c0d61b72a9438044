"""The host's reads of the running-lane count a time step of the traced
sweeps: the program's ``k2.check`` spans (K2's compaction and its one
host read, every ``CHECK_EVERY`` iterations of each batched solve, the
recording's projection solves too) over the sweeps' time steps. Nothing
without those spans or a device timeline."""


def read(run):
    if not run.profile or not run.profile["timeline"] or not run.units:
        return None
    reads = sum(1 for _, _, name in run.profile["host"] if name == "k2.check")
    steps = sum(u["steps"] / u["configs"] for u in run.units)
    return reads / steps if reads and steps else None

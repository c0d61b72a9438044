"""The device's idle time a sweep at K2's host reads: the stretches with
no device event running (between the window's first and last event) that
begin inside one of the program's ``k2.check`` spans, each counted whole,
over the traced sweeps. Nothing without those spans or a device
timeline."""

import bisect

from hfbench.reference import chipmath


def read(run):
    if not run.profile or not run.profile["timeline"] or not run.units:
        return None
    checks = [(h0, h1) for h0, h1, name in run.profile["host"]
              if name == "k2.check"]
    if not checks:
        return None
    starts = [h0 for h0, _ in checks]
    idle = 0.0
    for g0, g1 in chipmath.idle_gaps(run.profile["timeline"]):
        k = bisect.bisect_right(starts, g0) - 1
        if k >= 0 and g0 <= checks[k][1]:
            idle += g1 - g0
    return idle / len(run.units) / 1e3

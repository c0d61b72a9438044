"""The device's idle time a transient inside its graph: the stretches with
no device event running between the graph's first and last device event,
over the traced transients. A transient's graph events are those that
start after its ``transient.launch`` span begins and before the
device-to-host copy that its ``transient.wait`` span issues (the first
such copy to start after the span begins). Nothing without those spans, a
device timeline, or that copy after each wait."""

import bisect

from hfbench.reference import chipmath


def read(run):
    if not run.profile or not run.profile["timeline"] or not run.units:
        return None
    host, timeline = run.profile["host"], run.profile["timeline"]
    launches = [h0 for h0, _, name in host if name == "transient.launch"]
    waits = [h0 for h0, _, name in host if name == "transient.wait"]
    if not launches or len(launches) != len(waits):
        return None
    starts = [s0 for s0, _, _ in timeline]
    idle = 0.0
    for l0, w0 in zip(launches, waits):
        first = bisect.bisect_left(starts, l0)
        copy = next((k for k in range(bisect.bisect_left(starts, w0),
                                      len(timeline))
                     if "DtoH" in timeline[k][2]), None)
        if copy is None:
            return None
        idle += sum(g1 - g0 for g0, g1 in
                    chipmath.idle_gaps(timeline[first:copy]))
    return idle / len(run.units) / 1e3

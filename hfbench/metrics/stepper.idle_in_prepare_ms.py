"""The device's idle time a transient while the host is in the per-run
set-up: the stretches with no device event running (between the window's
first and last event) where they overlap the program's
``transient.operands`` and ``transient.load`` spans, over the traced
transients. Nothing without those spans or a device timeline."""

from hfbench.reference import chipmath

SPANS = ("transient.operands", "transient.load")


def merged(spans) -> list[list[float]]:
    """Sorted, disjoint [start, end] covering the (start, end) spans."""
    out: list[list[float]] = []
    for s0, s1 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s1)
        else:
            out.append([s0, s1])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    if not run.profile or not run.profile["timeline"] or not run.units:
        return None
    spans = merged((h0, h1) for h0, h1, name in run.profile["host"]
                   if name in SPANS)
    if not spans:
        return None
    gaps = chipmath.idle_gaps(run.profile["timeline"])
    return overlap(gaps, spans) / len(run.units) / 1e3

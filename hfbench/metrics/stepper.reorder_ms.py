"""The host's time a transient in the program's ``transient.reorder``
spans (the gathers between the mesh's node order and the overlay
lattice's at the edges of a call), merged, over the traced transients.
Nothing without those spans (a program that has none) or without a
device timeline."""

from hfbench.reference import chipmath

SPANS = ("transient.reorder",)


def read(run):
    if not run.profile or not run.profile["timeline"] or not run.units:
        return None
    spans = [(h0, h1) for h0, h1, name in run.profile["host"]
             if name in SPANS]
    if not spans:
        return None
    return chipmath.merged_busy(spans) / len(run.units) / 1e3

"""K1's share of its roofline over the traced transients on a
triangulation's grid-overlay lattice: ``k1_roofline``'s reading (K1's
device time, the forms' iterations from the device's counts) with the
work counted for a 9-plane operator over the lattice's points. An
iteration reads the operator's 9 planes and the scaling, x, r and p once
each (frozen ``chipmath``'s carried planes) and each line direction's two
Thomas factor planes; its stencil adds two more points to ``chipmath``'s
7-point count, a multiply and an add each. A form without counts, or no
overlay lattice, leaves the metric out."""

import math
import os

from hfbench import harness
from hfbench.reference import chipmath

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_k1 = harness.load_module("metrics", "k1_roofline", ROOT)
STENCIL_PLANES = 9
F32_BYTES = 4


def iter_bytes(plane_bytes: int, rline: bool, zline: bool) -> int:
    """One K1 iteration's bytes on the 9-plane lattice operator."""
    extra = STENCIL_PLANES - chipmath.STENCIL_PLANES
    return chipmath.k1_iter_bytes(plane_bytes, rline, zline) \
        + extra * plane_bytes


def iter_ops(rline: bool, zline: bool) -> int:
    """One K1 iteration a lattice point: ``chipmath``'s count with the
    two more stencil points."""
    return chipmath.k1_iter_ops(rline, zline) \
        + 2 * (STENCIL_PLANES - chipmath.STENCIL_PLANES)


def read(run):
    if not run.profile or not run.units:
        return None
    overlay = getattr(run.problem.mesh, "grid_overlay", None)
    if overlay is None:
        return None
    k1_us = sum(us for name, (us, _) in run.profile["kernels"].items()
                if _k1.is_k1(name))
    if k1_us <= 0:
        return None
    points = math.prod(int(n) for n in overlay["shape"])
    plane = points * F32_BYTES
    nbytes = ops = 0.0
    for u in run.units:
        forms = _k1.form_iterations(u)
        if forms is None:
            return None
        for (rline, zline), n in forms.items():
            nbytes += n * iter_bytes(plane, rline, zline)
            ops += n * points * iter_ops(rline, zline)
    return 100.0 * chipmath.bound(nbytes, ops)["bound_ms"] / (k1_us / 1e3)

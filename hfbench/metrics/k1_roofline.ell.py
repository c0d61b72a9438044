"""K1's share of its roofline over the traced transients on a mesh without
overlay (the ELL form): the least time of the iterations the run
performed, the larger of their bytes at the HBM rate and their float32
operations at the peak, over K1's device time (``k1_roofline``'s: every
device event that file's list does not place elsewhere).

The work of one iteration, counted here on the problem's ELL arrays (N
rows of K slots, padded slots included). Bytes: the arrays as stored, N K
(4 + 4) (float32 values, int32 column ids), the scaling once (4 N), and x,
r and p read and written once (frozen ``chipmath.CARRIED_PLANES`` planes
of 4 N). Operations a row: 2 K for the gather (a multiply and an add a
slot), 4 for the scaling of p and of the product and the <p, Ap> term,
and the identity form's update, <r, r> and direction (``chipmath``'s
identity iteration less its 17-operation 7-point stencil and dot: 8).

The iterations are the run's own ``cg_iters`` total (the launched ones
past a solve's stop return at once and do no work). A unit whose
``forms`` (the port's counters) name another form than 'ell', or a
problem with a grid overlay or no ELL arrays, leaves the metric out."""

import os

from hfbench import harness
from hfbench.reference import chipmath

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_k1 = harness.load_module("metrics", "k1_roofline", ROOT)
FORM = "ell"
F32_BYTES = I32_BYTES = 4
# chipmath's identity iteration a point, less its stencil and <p, Ap>
UPDATE_OPS = chipmath.k1_iter_ops(False, False) - 17


def iter_bytes(n: int, k: int) -> int:
    """One iteration's bytes on N rows of K slots."""
    return n * k * (F32_BYTES + I32_BYTES) \
        + (1 + chipmath.CARRIED_PLANES) * n * F32_BYTES


def iter_ops(k: int) -> int:
    """One iteration's float32 operations a row of K slots."""
    return 2 * k + 4 + UPDATE_OPS


def read(run):
    if not run.profile or not run.units:
        return None
    problem = run.problem
    ell = getattr(problem, "ell", None)
    if ell is None or getattr(problem.mesh, "grid_overlay", None) is not None:
        return None
    k1_us = sum(us for name, (us, _) in run.profile["kernels"].items()
                if _k1.is_k1(name))
    if k1_us <= 0:
        return None
    n, k = (int(v) for v in ell.cols.shape)
    its = 0.0
    for u in run.units:
        forms = u.get("forms") or {}
        if list(forms) != [FORM]:
            return None
        its += float(u["iters"].sum())
    return 100.0 * chipmath.bound(its * iter_bytes(n, k),
                                  its * n * iter_ops(k))["bound_ms"] \
        / (k1_us / 1e3)

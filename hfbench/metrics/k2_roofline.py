"""K2's share of its roofline over the traced sweeps: the least time of
the lane-iterations the run performed, the larger of their bytes at the
HBM rate and their float32 operations at the peak (frozen ``chipmath``:
the shared operator once an iteration of the batch, each running lane's
planes once a lane-iteration; a line solve counted as Thomas' algorithm),
over K2's device time (every device event this file's list does not place
elsewhere). The Kv-free projection of a recording sweep runs on K2's
kernels: its lane-iterations are counted in its own form."""

from hfbench.reference import chipmath

NOT_K2_PREFIXES = ("k_",)
NOT_K2_PARTS = ("at::", "at_cuda_detail", "Memcpy", "Memset", "cub::",
                "thrust::")
F32_BYTES = 4
FORMS = {"jacobi": (False, False), "rline": (True, False),
         "adi": (True, True)}


def is_k2(name: str) -> bool:
    short = chipmath.short_name(name)
    return not (short.startswith(NOT_K2_PREFIXES)
                or any(p in name for p in NOT_K2_PARTS))


def read(run):
    if not run.profile:
        return None
    form = FORMS.get(run.params["recipe"].get("precondition", "jacobi"))
    k2_us = sum(us for name, (us, _) in run.profile["kernels"].items()
                if is_k2(name))
    if form is None or k2_us <= 0:
        return None
    nz, nr = run.problem.mesh.shape
    plane, points = nz * nr * F32_BYTES, nz * nr
    nbytes = ops = 0.0
    for u in run.units:
        for its in u["iters"]:
            nbytes += chipmath.k2_solve_bytes(its, plane)
            ops += float(its.sum()) * points * chipmath.k2_iter_ops(*form)
        for its in u.get("proj_iters", ()):
            nbytes += chipmath.k2_solve_bytes(its, plane, kv=False,
                                              lane_scaling=False)
            ops += float(its.sum()) * points * chipmath.k2_iter_ops(kv=False)
    return 100.0 * chipmath.bound(nbytes, ops)["bound_ms"] / (k2_us / 1e3)

"""K1's share of its roofline over the traced transients: the least time
of the iterations the run performed, the larger of their bytes at the HBM
rate and their float32 operations at the peak (frozen ``chipmath``:
operands read once, x, r and p read and written once; a line solve counted
as Thomas' algorithm, whatever the kernel runs), over K1's device time.

K1's device time is every device event of the window that this file's
list does not place elsewhere: a kernel it cannot place counts toward the
solve, so a renamed solve kernel does not drop out. The iterations of each
solve form are the device's own counts (each unit's ``forms``: solves and
iterations launched, from the port's counters); the launched iterations
past a solve's stop, which return at once, are the launched total less
the run's own ``cg_iters`` total, shared among the forms by their solves.
A form this file has no counts for leaves the metric out.
"""

from hfbench.reference import chipmath

# the transient's other kernels (csrc/step.cu, the batched K2) and the
# host library's own (PyTorch's kernels, copies and fills)
NOT_K1_KERNELS = ("k_step_prologue", "k_step_epilogue", "k_refine_residual",
                  "k_refine_scale")
NOT_K1_PREFIXES = ("ks_",)
NOT_K1_PARTS = ("at::", "at_cuda_detail", "Memcpy", "Memset", "cub::",
                "thrust::")
# (r-line, z-line) of each solve form's preconditioner
FORMS = {"identity": (False, False), "rline": (True, False),
         "adi": (True, True)}
F32_BYTES = 4


def is_k1(name: str) -> bool:
    short = chipmath.short_name(name)
    return not (short in NOT_K1_KERNELS or short.startswith(NOT_K1_PREFIXES)
                or any(p in name for p in NOT_K1_PARTS))


def form_iterations(unit: dict) -> dict | None:
    """{(r-line, z-line): iterations performed} of one unit, or None where
    it ran a form without counts here (or no counted graph)."""
    forms = unit.get("forms") or {}
    if not forms or any(f.removesuffix("_merged") not in FORMS
                        for f in forms):
        return None
    solves = sum(n for n, _ in forms.values())
    empty = sum(its for _, its in forms.values()) - float(unit["iters"].sum())
    out: dict = {}
    for f, (n, its) in forms.items():
        key = FORMS[f.removesuffix("_merged")]
        out[key] = out.get(key, 0.0) + its - empty * n / max(solves, 1)
    return out


def read(run):
    if not run.profile:
        return None
    k1_us = sum(us for name, (us, _) in run.profile["kernels"].items()
                if is_k1(name))
    if k1_us <= 0 or not run.units:
        return None
    nz, nr = run.problem.mesh.shape
    plane = nz * nr * F32_BYTES
    nbytes = ops = 0.0
    for u in run.units:
        forms = form_iterations(u)
        if forms is None:
            return None
        for (rline, zline), n in forms.items():
            nbytes += n * chipmath.k1_iter_bytes(plane, rline, zline)
            ops += n * nz * nr * chipmath.k1_iter_ops(rline, zline)
    return 100.0 * chipmath.bound(nbytes, ops)["bound_ms"] / (k1_us / 1e3)

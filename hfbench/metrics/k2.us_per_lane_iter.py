"""K2's device time a lane-iteration over the traced sweeps: the batched
solves' kernels (and the Kv-free projection's, which runs on them) over
the lanes' iterations the run reported (``iters_out``, and
``proj_iters_out`` where the sweep records). A kernel this file's list
cannot place counts toward K2."""

NOT_K2_PREFIXES = ("k_",)
NOT_K2_PARTS = ("at::", "at_cuda_detail", "Memcpy", "Memset", "cub::",
                "thrust::")


def is_k2(name: str) -> bool:
    from hfbench.reference import chipmath
    short = chipmath.short_name(name)
    return not (short.startswith(NOT_K2_PREFIXES)
                or any(p in name for p in NOT_K2_PARTS))


def lane_iterations(run) -> int:
    return int(sum(u["iters"].sum() for u in run.units)
               + sum(u["proj_iters"].sum() for u in run.units
                     if "proj_iters" in u))


def read(run):
    if not run.profile:
        return None
    k2_us = sum(us for name, (us, _) in run.profile["kernels"].items()
                if is_k2(name))
    n = lane_iterations(run)
    return k2_us / n if k2_us > 0 and n > 0 else None

"""Frozen copies of ``chip_smoke.py``'s metric arithmetic, the benchmark's
yardstick: the card's peaks, the reduction of a profiled timeline to busy
and idle time (``kernel_profile``, ``idle_split``), and the least time of a
solve's iterations (``bound``, ``k1_iter_bound``, ``k2_iter_bound``,
``k1_iter_ops``, ``k2_iter_ops``). Plain Python on numbers and lists: a
timeline is a sorted list of (start_us, end_us, name) device events.

The byte counts follow what each iteration's algorithm needs, read once:
the operator and scaling, x, r and p read and written once, and for a line
preconditioner the two factor planes a Thomas solve keeps per line
direction (its multiplier and inverse pivot; the couplings come from the
operator). A kernel that keeps more operands, such as the PCR stacks, is
charged only for these.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 peak outside the
# tensor cores, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations a grid point of a lane costs, counted for what each
# function computes: a tridiagonal line solve by Thomas' algorithm is 8 a
# point (elimination 5, back substitution 3); K2 first forms each line's
# couplings from A0 + dk Kv and the scaling: 8 more
LINE_SOLVE_OPS = 8
K2_COUPLING_OPS = 8
# planes a K1 iteration reads or writes besides its operands: x, r, p
# read and written once
CARRIED_PLANES = 6
STENCIL_PLANES = 7
THOMAS_FACTOR_PLANES = 2


def merged_busy(spans) -> float:
    """The union's length of (start, end) intervals (sorted or not)."""
    spans = sorted(spans)
    if not spans:
        return 0.0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    return busy + cur_e - cur_s


def idle_gaps(timeline) -> list[tuple[float, float]]:
    """(start, end) of each stretch with no device event running, between
    the first event's start and the last one's end."""
    gaps, prev_end = [], None
    for s0, s1, _ in timeline:
        if prev_end is not None and s0 > prev_end:
            gaps.append((prev_end, s0))
        prev_end = s1 if prev_end is None else max(prev_end, s1)
    return gaps


def short_name(name: str) -> str:
    """A kernel's name without its parameter list: the port's kernels with
    their template arguments (``ks_apply<true, 1, 7>``), a library kernel
    as its name and its functor (``at::native::elementwise_kernel
    [MulFunctor<float>]``)."""
    m = re.search(r"\b(ks?_[a-z_0-9]+(?:<[^>(]*>)?)\(", name)
    if m:
        return m.group(1)
    base = name.replace("void ", "").split("<")[0].split("(")[0].strip()
    f = re.search(r"(\w*Functor\w*(?:<[\w, ]*>)?)", name)
    return (f"{base}[{f.group(1)}]" if f else base)[:120]


def is_k2_start(k: str) -> bool:
    """K2's first kernel of a solve: the operator pass in its first-residual
    mode (ks_apply<HAS_KV, 1, NPTS>)."""
    return (k.startswith("ks_apply<")
            and k[len("ks_apply<"):-1].split(",")[1].strip() == "1")


def idle_split(timeline, first: str = "k_init", last: str = "k_finish"
               ) -> dict:
    """The device's idle time of a profiled stretch, in us: inside the
    solves (from a solve's first kernel, K1's k_init or with ``first="k2"``
    K2's first-residual pass, to its ``last`` kernel), split into the gaps
    that follow a device-to-host copy and the rest, and between the solves
    (the caller's own work), with the solves' span and kernel time and the
    count of copies to the host inside and between them."""
    inside = after_read = between = solve_span = solve_busy = 0.0
    start, prev_end, prev_name, solves, reads = None, None, "", 0, 0
    reads_between = pending = 0
    before_first = None
    starts = is_k2_start if first == "k2" else (lambda k: k == first)
    for s0, s1, name in timeline:
        m = re.search(r"\b(ks?_[a-z_]+(?:<[^>(]*>)?)", name)
        k = m.group(1) if m else ""
        gap = 0.0 if prev_end is None else max(0.0, s0 - prev_end)
        if starts(k) and start is None:
            start = s0
            between += gap
            if before_first is None:
                before_first = between
            reads_between += pending if solves else 0
            pending = 0
        elif start is not None:
            if "DtoH" in prev_name:
                after_read += gap
            else:
                inside += gap
            solve_busy += s1 - s0
            reads += "DtoH" in name
        else:
            between += gap
            pending += "DtoH" in name
        if starts(k):
            solve_busy += s1 - s0
        if k == last and start is not None:
            solve_span += s1 - start
            solves += 1
            start = None
        if prev_end is None or s1 >= prev_end:
            prev_end, prev_name = s1, name
    return dict(solves=solves, solve_span_us=solve_span,
                solve_busy_us=solve_busy, idle_in_solves_us=inside,
                idle_after_host_reads_us=after_read, host_reads=reads,
                idle_between_solves_us=between,
                idle_before_first_solve_us=before_first or 0.0,
                host_reads_between_solves=reads_between)


def bound(nbytes: float, ops: float) -> dict:
    """The least time (ms) the card could take for some work: the larger
    of its bytes at the memory rate and its float32 operations at the
    peak rate, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def k1_iter_ops(rline: bool, zline: bool) -> int:
    """One K1 iteration a grid point: stencil and <p, Ap> (17), update and
    <r, r> (6), the r-line solve with its mask and <r, z> (+4), the z-line
    solve with the ADI combine (+4), p update (2)."""
    pre = LINE_SOLVE_OPS + 4 if rline else 0
    pre += LINE_SOLVE_OPS + 4 if zline else 0
    return 17 + 6 + pre + 2


def k1_iter_bytes(plane_bytes: int, rline: bool, zline: bool) -> int:
    """One K1 iteration's bytes: the operator (7 planes) and the scaling
    (1), each line direction's Thomas factors, x, r and p."""
    planes = STENCIL_PLANES + 1 + CARRIED_PLANES
    planes += THOMAS_FACTOR_PLANES * (int(rline) + int(zline))
    return planes * plane_bytes


def k2_line_ops() -> int:
    """One K2 line solve, a point: the couplings, the tridiagonal solve,
    and its mask and scaling (3)."""
    return K2_COUPLING_OPS + LINE_SOLVE_OPS + 3


def k2_iter_ops(rline: bool = False, zline: bool = False,
                kv: bool = True) -> int:
    """One K2 iteration of a lane a grid point: the combined stencil and
    <p, Ap> (31; 17 without Kv), update and <r, r> (6), the line solves,
    p update (2)."""
    pre = k2_line_ops() + 2 if rline else 0
    pre += k2_line_ops() + 2 if zline else 0
    return (31 if kv else 17) + 6 + pre + 2


def k2_solve_bytes(lane_iters, plane_bytes: int, kv: bool = True,
                   lane_scaling: bool = True) -> float:
    """A batched K2 solve's bytes (``lane_iters``: each lane's iterations
    of the solve): the shared operator (A0 and, with ``kv``, Kv; a shared
    scaling plane unless ``lane_scaling``) once an iteration of the batch,
    each running lane's carried x, r, p (and its own scaling plane) once a
    lane-iteration."""
    its = [int(v) for v in lane_iters]
    shared = STENCIL_PLANES * (2 if kv else 1) + (0 if lane_scaling else 1)
    lane = CARRIED_PLANES + (1 if lane_scaling else 0)
    return float(max(its, default=0) * shared + sum(its) * lane) * plane_bytes

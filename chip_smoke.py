#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Phases (each raises on failure; nothing is caught):

1. require a CUDA device; print the card's name and power limit and the
   TF32 settings (both switched off: every product here is float32 or
   float64 elementwise work, never a TF32 matrix product);
2. build the CUDA kernels from ``heatflow_tpu_torch/csrc`` through their
   normal first use and print the build time;
3. at the flagship shape (``cfgs/geballe_with_diamond.yaml``, 251 x 1107
   nodes) compare each phase kernel of ``cg_tol`` with its plain PyTorch
   version on numpy-seeded inputs, then one full solve of the first step's
   refinement system in the identity, r-line and ADI forms, timing kernel
   and plain version with CUDA events;
4. run the flagship transient (100 backward-Euler steps, the float32
   adaptive r-line/ADI recipe with one float64 refinement pass) through
   ``make_simulate_fn``: one warm-up run, then one timed run with the
   launch counters reset just before it; check the traces against the
   float64 truth in ``benchmarks/.flagship_truth_f64.npz``;
5. at the sweep shape (``cfgs/geballe_no_diamond.yaml``, 243 x 1001
   nodes), on the 10th step's system of 8 numpy-seeded lanes spanning
   kappa in [1, 100] (one lane NaN, one at rtol 2), compare each of the
   eight phase kernels of the batched solve (K2/K3) alone with its plain
   version, then full solves in the identity and r-line forms and 120
   fixed iterations (K3), timing kernel and plain version with CUDA
   events;
6. run the coefficient sweep (B = 1024, kappa = logspace(0, 2), the
   config's FWHM, 40 steps chunked 20 + 20, float32, Jacobi, rtol 1e-4 wrt
   ||b||) through ``run_sweep_time_chunked``: one warm-up run, one timed
   run with the counters reset just before it; hold four lanes to the
   same lanes run as a B = 4 sweep (bitwise), to the plain eager float32
   sweep's iteration total, and to its traces within 2x its distance from
   the plain float64 sweep of the same recipe, + 0.1 K;
7. run the other sweep forms at B = 64: ``fixed_iters=120`` (K3) and
   ``precondition='rline'`` through ``make_sweep_fn``, and an
   'extrapolate' sweep at B = 8 chunked 20 + 20 against unchunked
   (bitwise);
8. at the sweep shape, on the 10th step's gradient-projection system of 8
   lanes (b = s_mp·Gr·u of the step's fields, x0 the extrapolated seed; one
   lane NaN, one at rtol 2), compare the Kv-free forms of ``init`` and
   ``stencil_dot`` with their plain versions, then the full projection
   solve (rtol 1e-11 wrt ||b||, at most 400 iterations): equal per-lane
   counts, rel-L2 <= 1e-5; timing kernel and plain version with CUDA
   events;
9. run the gradient-recording sweep (``make_sweep_fn_recording``,
   solver='vmem': float32, r-line, 'extrapolate', rtol 1e-5 wrt ||b||,
   projection rtol 1e-11) at B = 8 to warm up, then B = 256 timed with the
   counters reset just before it; hold four lanes to themselves run as a
   B = 4 kernel sweep (bitwise, all three families), to the plain float32
   recording's iteration totals, and to its distance from the plain
   float64 recording;
10. run the entry points: the sweep CLI with ``--record-gradient`` on its
   default 5 x 5 x 3 grid (75 runs over 3 widths) and the 2D CLI on the
   flagship config, its ``watcher_points.csv`` held bitwise to
   ``run_transient`` run in-process with the options the driver resolved;
11. at the sweep shape, on the 10th step's system of 8 lanes (one NaN, one
   at rtol 2), compare K2's z-line phase (``ks_pcr_z``) alone with its plain
   version, then the ADI and adaptive solves (rtol 1e-6 wrt ||r0||):
   per-lane counts within max(3, 2 %) of the plain float32 version's, the
   NaN lane poisoned, and every adaptive lane bitwise the static ADI
   (flag 1) or r-line (flag 0) solve's lane;
12. run two B = 256 sweeps of ``geballe_no_diamond`` (40 steps, float32):
   (a) 'adi', rtol 1e-5 wrt ||r0||, 'extrapolate'; (b) 'adaptive' with one
   float64 refinement pass; configs/s, finite lanes, the share of flagged
   lane-steps, four lanes again at B = 4 (bitwise);
13. (a) the differentiable ``cg_vmem_solve`` on the flagship's first-step
   system: value, backward (gradients to A, sm, b) and forward-mode
   tangent against its plain version on the card; (b) ``one_config`` on the
   fit config (``cfgs/geballe_no_diamond_read_flux.yaml``): the float32
   kernel objective and its gradient in (log k, log fwhm) against the
   plain float64 path; (c) the fit CLI at full width (the default coarse
   8 x 6 grid, 3 starts, Gauss-Newton; 5 Adam steps), with K1's launches
   per direction; (d) the same with ``--precondition adi`` and 2 Adam
   steps, so that K2's ADI form runs the coarse batch.

The line before the last is a JSON object with one entry per kernel, each
with its time, the plain version's, and its bound: the larger of the bytes
it must move (each input read once, each output written once) at the
card's memory rate and the float32 operations this run's data needs at its
peak; no single PyTorch call computes a preconditioned CG solve or a PCR
line solve, so ``library_ms`` is null. The last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cfgs", "geballe_with_diamond.yaml")
SWEEP_CFG = os.path.join(ROOT, "cfgs", "geballe_no_diamond.yaml")
CSV = os.path.join(ROOT, "experimental_data", "geballe_heat_data.csv")
TRUTH = os.path.join(ROOT, "benchmarks", ".flagship_truth_f64.npz")
SOURCE = "heatflow_tpu_torch/csrc/cg_tol.cu"
REPLACES = "heatflow_tpu/ops/pallas_cg.py:308"
SWEEP_SOURCE = "heatflow_tpu_torch/csrc/sweep_cg.cu"
K2_REPLACES = "heatflow_tpu/ops/pallas_cg.py:802"
K3_REPLACES = "heatflow_tpu/ops/pallas_cg.py:729"
RECIPE = dict(rtol=1e-4, maxiter=8000, record_gradient=False,
              record_fields=False, rtol_wrt="r0", solver="auto",
              precondition="adaptive", warm_start="extrapolate",
              f64_refine=1)
TRACE_TOL_K = 1.0
SWEEP_B = 1024
SWEEP_RECIPE = dict(step_chunk=25, solver="vmem", rtol=1e-4,
                    precondition="jacobi")
# the sweep driver's default float32 recording recipe
REC_RECIPE = dict(solver="vmem", precondition="rline",
                  warm_start="extrapolate", rtol=1e-5, proj_rtol=1e-11,
                  proj_maxiter=400)
REC_B = 256
PROJ_REL_L2 = 1e-5        # Kv-free projection solve, kernel vs plain
# phase 9: a family's margin over 2x the plain float32 recording's distance
# from the plain float64 one, as a fraction of the f64 family's largest
# value (watch: in K); the gradient families amplify float32 rounding ~1/h,
# so their margins follow the ladder of tests/test_recording_precondition.py
REC_MARGIN = dict(watch=0.1, band=1e-2, axis=5e-2)
FIT_CFG = os.path.join(ROOT, "cfgs", "geballe_no_diamond_read_flux.yaml")
ADI_B = 256
ADI_RECIPES = {
    "adi": dict(precondition="adi", rtol=1e-5, rtol_wrt="r0",
                warm_start="extrapolate"),
    "adaptive": dict(precondition="adaptive", f64_refine=1, rtol=1e-5,
                     warm_start="extrapolate")}
# phase 13a: each output of the differentiable solve (x, the gradients to
# A, sm and b, the tangent), kernel against plain float32, within this
# rel-L2 or 2x the plain float32 version's own distance from float64
VMEM_SOLVE_REL = 1e-3
# phase 13b: the float32 kernel objective within this of the float64 one
# (tests/test_fit.py:167), each gradient component within this relative
# distance of the float64 one and of its sign: sound runs read 6.2e-4 and
# 1.2e-3 in (log k, log fwhm) on an H100, an adjoint that drops a term of
# ~10 % of the gradient reads ~1e-1
FIT_RMSE_ABS = 1e-3
FIT_GRAD_REL = 1e-2
# the bound of a kernel: H100 SXM HBM3 rate and float32 peak outside the
# tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for a function: the larger of its
    bytes (each input read once, each output written once) at the memory
    rate and its float32 operations at the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# float32 operations a grid point of a lane costs, counted for what each
# function computes, not for the algorithm its kernel runs. A line
# preconditioner solves a tridiagonal system along each line: 8 a point by
# Thomas' algorithm (elimination 5, back substitution 3), with no log
# factor, where the kernels' PCR spends 4 (stored stack) or 14 (factored on
# the fly) a level. K2 first forms each line's couplings from A0 + dk Kv
# and sm: 8 more.
LINE_SOLVE_OPS = 8
K2_COUPLING_OPS = 8


def k1_iter_ops(rline: bool, zline: bool) -> int:
    """One K1 iteration: stencil and <p, Ap> (17), update and <r, r> (6),
    the r-line solve with its mask and <r, z> (+4), the z-line solve with
    the ADI combine (+4), p update (2)."""
    pre = LINE_SOLVE_OPS + 4 if rline else 0
    pre += LINE_SOLVE_OPS + 4 if zline else 0
    return 17 + 6 + pre + 2


def k2_line_ops() -> int:
    """One K2 line solve, a point: the couplings, the tridiagonal solve,
    and its mask and scaling (3)."""
    return K2_COUPLING_OPS + LINE_SOLVE_OPS + 3


def k2_iter_ops(rline: bool = False, zline: bool = False,
                kv: bool = True) -> int:
    """One K2 iteration of a lane: the combined stencil and <p, Ap> (31; 17
    without Kv), update and <r, r> (6), the line solves, p update (2)."""
    pre = k2_line_ops() + 2 if rline else 0
    pre += k2_line_ops() + 2 if zline else 0
    return (31 if kv else 17) + 6 + pre + 2


def require(ok: bool, what) -> None:
    """A check of this script: raises (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_max(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def build_flagship(path: str = CFG):
    """The problem of a config (by default the flagship) through the port's
    entry points, with the flagship heating curve."""
    from heatflow_tpu_torch import (build_layout, build_structured_mesh,
                                    load_config)
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem
    cfg = load_config(path)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    heating = HeatingCurve.from_csv(CSV)
    return build_problem(mesh, heating, cfg,
                         watcher_points=coupler_watcher_points(cfg))


def first_step_system(problem, device):
    """The scaled operator and the first step's refinement system, as the
    stepper builds them: (A32, sm32, s32, free32, b32) with b32 the unit-norm
    float64 residual of the first step at its warm-start seed."""
    import math
    import torch
    from heatflow_tpu_torch.ops.stencil import apply_stencil, combine_operator
    from heatflow_tpu_torch.sim.stepper import interp
    d = problem.device_arrays(torch.float64, device)
    dt = torch.tensor(problem.dt, dtype=torch.float64, device=device)
    A, M_op = combine_operator(d["K"], d["M"], d["kappas"], d["rho_cvs"], dt)
    free, dirich = d["free"], d["dirichlet"]
    s = torch.rsqrt(torch.where(A[0] > 0, A[0], torch.ones_like(A[0]))) \
        * free + dirich
    ic = problem.ic_temp
    coeff = -4.0 * math.log(2.0) / problem.fwhm ** 2
    profile = torch.exp(coeff * d["r_sq"]) * d["heat_profile_base"]
    g0, g1 = ic * (dirich - profile), profile
    amp = interp(dt, d["heat_t"], d["heat_T"]) - (d["heat_T"][0] - ic)
    u0 = torch.full_like(free, ic)
    b_lift = (apply_stencil(M_op, u0)
              - (apply_stencil(A, g0) + amp * apply_stencil(A, g1))) * s
    y0 = (u0 / torch.where(s > 0, s, torch.ones_like(s))) * free
    r64 = b_lift * free - free * (s * apply_stencil(A, s * y0))
    b32 = (r64 / torch.sqrt(torch.sum(r64 * r64))).float()
    f32 = lambda t: t.float().contiguous()
    return f32(A), f32(s * free), f32(s), f32(free), b32


def phase_checks(problem, device, out: dict) -> list[dict]:
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.ops.stencil import apply_stencil

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    pcr = cuda_cg.pcr_pack(A32, s32, free32).contiguous()
    pcr_z = cuda_cg.pcr_pack(A32, s32, free32, axis=-2).contiguous()
    nz, nr = b32.shape
    print(f"flagship grid {nz} x {nr}; r-stack {pcr.shape[0]} planes, "
          f"z-stack {pcr_z.shape[0]} planes")
    rng = np.random.default_rng(0)
    p = (torch.tensor(rng.standard_normal((nz, nr)), dtype=torch.float32,
                      device=device) * free32).contiguous()
    rows = []
    n = nz * nr

    # stencil and <p, Ap>
    Ap_k, pap_k = cuda_cg.stencil_dot(A32, sm32, p)
    Ap_p, pap_p = cuda_cg.stencil_dot_reference(A32, sm32, p)
    err = float((Ap_k - Ap_p).abs().max())
    rel = rel_max(Ap_k, Ap_p)
    dot_rel = abs(float(pap_k - pap_p)) / abs(float(pap_p))
    require(rel <= 1e-5 and dot_rel <= 1e-5, ("stencil_dot", rel, dot_rel))
    rows.append(dict(name="cg_tol.stencil_dot", phase="stencil_dot",
                     **bound(nbytes(A32, sm32, p, p) + 8, 17 * n),
                     max_abs_err=err, rel=rel, dot_rel=dot_rel,
                     ms=cuda_ms(lambda: cuda_cg.stencil_dot(A32, sm32, p),
                                50),
                     plain_ms=cuda_ms(
                         lambda: cuda_cg.stencil_dot_reference(A32, sm32, p),
                         50)))

    # r-line PCR, then z-line PCR with the ADI combine
    for name, phase, zst in (("cg_tol.pcr_r", "pcr_r", None),
                             ("cg_tol.pcr_z_adi", "pcr_z", pcr_z)):
        z_k, rz_k = cuda_cg.precond(sm32, p, pcr, zst)
        z_p, rz_p = cuda_cg.precond_reference(sm32, p, pcr, zst)
        err = float((z_k - z_p).abs().max())
        rel = rel_max(z_k, z_p)
        dot_rel = abs(float(rz_k - rz_p)) / abs(float(rz_p))
        require(rel <= 1e-4 and dot_rel <= 1e-5, (name, rel, dot_rel))
        rows.append(dict(
            name=name, phase=phase, max_abs_err=err, rel=rel,
            dot_rel=dot_rel,
            **bound(nbytes(sm32, p, pcr, zst, p) + 8,
                    n * (LINE_SOLVE_OPS + 4) * (1 if zst is None else 2)),
            ms=cuda_ms(lambda: cuda_cg.precond(sm32, p, pcr, zst), 50),
            plain_ms=cuda_ms(
                lambda: cuda_cg.precond_reference(sm32, p, pcr, zst), 20)))

    for row in rows:
        print(f"phase {row['name']}: max|err| {row['max_abs_err']:.3e} "
              f"(rel {row['rel']:.3e}, dot rel {row['dot_rel']:.3e}), "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")

    # full solves of the first step's refinement system. Its solution is
    # ~4e3 ||b||, so a float32 solve carries a rounding floor: its true
    # residual stalls near 1e-3 ||b|| and its distance to the float64
    # solution near 5e-4 (r-line/ADI forms), whatever the implementation.
    # The bounds are the stated ones (1e-4 agreement, 1.2 rtol ||b||
    # residual) where float32 reaches them, else the plain version's floor
    # on the same input, measured against the float64 solution.
    rtol = 1e-6
    x0 = torch.zeros_like(b32)
    op64 = lambda y: (sm32.double()
                      * apply_stencil(A32.double(), sm32.double() * y))
    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    ref = norm(b32)
    solves = {}
    for form, stacks in (("identity", {}), ("rline", {"pcr": pcr}),
                         ("adi", {"pcr": pcr, "pcr_z": pcr_z})):
        kw = dict(maxiter=20000, rtol_wrt="b", **stacks)
        x_k, it_k = cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw)
        x_p, it_p = cuda_cg.cg_tol_reference(A32, sm32, b32, x0, rtol, **kw)
        x64, _ = cuda_cg.cg_tol_reference(
            A32.double(), sm32.double(), b32.double(), x0.double(), rtol,
            maxiter=20000, rtol_wrt="b",
            **{k: v.double() for k, v in stacks.items()})
        it_k, it_p = int(it_k), int(it_p)
        rel_l2 = norm(x_k - x_p) / norm(x_p)
        err_k, err_p = norm(x_k - x64) / norm(x64), norm(x_p - x64) / norm(x64)
        res, res_p = norm(b32 - op64(x_k.double())), \
            norm(b32 - op64(x_p.double()))
        print(f"solve {form}: iters kernel {it_k} plain {it_p}; kernel vs "
              f"plain rel-L2 {rel_l2:.3e}; vs float64 solution kernel "
              f"{err_k:.3e} plain {err_p:.3e}; true residual kernel "
              f"{res / ref:.3e} plain {res_p / ref:.3e} x ||b||")
        require(abs(it_k - it_p) <= max(3, int(0.05 * it_p)),
                (form, it_k, it_p))
        require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, rel_l2, err_p))
        require(err_k <= max(1e-4, 1.5 * err_p), (form, err_k, err_p))
        require(res <= 1.2 * max(rtol * ref, res_p), (form, res, res_p))
        ms = cuda_ms(lambda: cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw),
                     3)
        plain_ms = cuda_ms(
            lambda: cuda_cg.cg_tol_reference(A32, sm32, b32, x0, rtol, **kw),
            1)
        solves[form] = dict(**bound(nbytes(A32, sm32, b32, x0, b32,
                                           *stacks.values()),
                                    it_k * n * k1_iter_ops(
                                        bool(stacks), "pcr_z" in stacks)),
                            iters=it_k, plain_iters=it_p, rel_l2=rel_l2,
                            err_vs_f64=err_k, plain_err_vs_f64=err_p,
                            true_res_over_ref=res / ref,
                            plain_true_res_over_ref=res_p / ref,
                            max_abs_err=float((x_k - x_p).abs().max()),
                            ms=ms, plain_ms=plain_ms)
        print(f"solve {form}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    out["solves"] = solves
    out["phases"] = rows
    return rows


def run_slice(problem, device, out: dict):
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn

    fn = make_simulate_fn(problem, dtype=torch.float32, device=device,
                          **RECIPE)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cuda_cg.reset_counters()
    t0 = time.perf_counter()
    ys = fn()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = cuda_cg.phase_launches()
    solves = dict(total=cuda_cg.cg_tol.launches,
                  rline=cuda_cg.cg_tol.launches_rline,
                  adi=cuda_cg.cg_tol.launches_adi,
                  identity=cuda_cg.cg_tol.launches_identity)
    watch = ys["watch"].cpu().numpy()
    iters = ys["cg_iters"].cpu().numpy()
    require(np.isfinite(watch).all()
            and np.isfinite(ys["final_u"].cpu().numpy()).all(),
            "non-finite traces")
    require(solves["rline"] > 0 and solves["adi"] >= 1, solves)
    truth = np.load(TRUTH)["watch"]
    require(watch.shape == truth.shape, (watch.shape, truth.shape))
    peak = np.abs(watch - truth).max(axis=0)
    names = list(problem.watcher_names)
    steps_per_s = problem.num_steps / run_s
    print(f"slice: {problem.num_steps} steps in {run_s:.4f} s = "
          f"{steps_per_s:.2f} steps/s (warm-up run {warm_s:.2f} s); "
          f"cg_iters mean {iters.mean():.2f} max {int(iters.max())}; "
          f"ADI steps {solves['adi']}, r-line steps {solves['rline']}")
    print("slice peak |error| vs f64 truth [K]: "
          + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, peak)))
    print(f"slice phase launches: {counts}")
    out["slice"] = dict(steps=problem.num_steps, run_s=run_s,
                        warm_run_s=warm_s, steps_per_s=steps_per_s,
                        cg_iters=iters.tolist(), solves=solves,
                        phase_launches=counts,
                        peak_err_K=dict(zip(names, peak.tolist())))
    require((peak <= TRACE_TOL_K).all(), f"trace error {peak} K > 1.0 K")
    return fn


def profile_run(fn, path: str, out: dict, key: str = "profile") -> None:
    """One more run of ``fn`` under torch.profiler: device time by kernel,
    and the device's busy and idle share of the run (kernel intervals
    merged, over the span from the first kernel's start to the last one's
    end). Writes the kernel table to ``path``, the summary to out[key]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    require(spans, "the profiler saw no device time")
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == cuda:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.end - e.time_range.start
            acc[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(path, "w") as f:
        f.write(f"profiled run: wall {wall_s * 1e3:.3f} ms (profiler on), "
                f"device span {span / 1e3:.3f} ms, device busy "
                f"{busy / 1e3:.3f} ms ({100 * busy / span:.2f}% of span)\n")
        f.write("device_ms  calls  mean_us  kernel\n")
        for name, (us, n) in rows:
            f.write(f"{us / 1e3:9.3f} {n:6d} {us / n:8.2f}  {name}\n")
    print(f"profile: wall {wall_s * 1e3:.1f} ms with the profiler on; "
          f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms span "
          f"(idle {100 * (1 - busy / span):.2f}%); "
          f"{sum(n for _, (_, n) in rows)} kernels; table in {path}")
    for name, (us, n) in rows[:8]:
        print(f"profile: {us / 1e3:8.3f} ms {n:6d} x  {name[:90]}")
    out[key] = dict(wall_s=wall_s, device_span_ms=span / 1e3,
                          device_busy_ms=busy / 1e3,
                          kernels={k: v for k, v in rows})


def sweep_system(problem, ks, fs, device, step: int = 10):
    """The batched system of the sweep's ``step``-th step (the heating
    pulse rises from step ~8; the first steps' fields are ~uniform and their
    systems nearly solved by the seed), exactly as the sweep builds it:
    (A0, Kv, dks, sm, b, x0) in float32, read off the kernel wrapper's
    arguments during a ``step``-step sweep, the kernel solving each step."""
    import functools
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn
    seen = {}
    kernel = cuda_sweep.cg_batched_tol

    @functools.wraps(kernel)     # with its own copy of the launch counters
    def capture(*args, **kw):
        seen["args"] = args[:6]
        return kernel(*args, **kw)

    fn = make_sweep_fn(problem, dtype=torch.float32, solver="vmem",
                       rtol=1e-4, num_steps=step, device=device)
    cuda_sweep.cg_batched_tol = capture
    try:
        fn(ks, fs)
    finally:
        cuda_sweep.cg_batched_tol = kernel
    return seen["args"]


def sweep_phase_cases(A0, Kv, dks, sm, b, x0, rng) -> dict:
    """name -> (kernel wrapper, plain version, arguments, bound on the
    relative error) for each phase kernel of K2/K3. Field phases run on the
    given lanes with numpy-seeded fields; finalize, compact and finish on
    per-lane states of 1024 lanes (finish: of the given lanes, one of them
    with a NaN residual)."""
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    B, nz, nr = b.shape
    dev = b.device
    free = (sm != 0).to(torch.float32)
    field = lambda: (torch.tensor(rng.standard_normal((B, nz, nr)),
                                  dtype=torch.float32, device=dev)
                     * free).contiguous()
    lane = lambda lo, hi, n=B: torch.tensor(rng.uniform(lo, hi, n),
                                            dtype=torch.float64, device=dev)
    x, r, p, Ap = field(), field(), field(), field()
    nb = 1024
    parts = torch.tensor(rng.uniform(0.5, 1.5, (4, nb, nz)),
                         dtype=torch.float64, device=dev)
    parts[1, 7] = float("nan")              # a lane with a NaN residual
    rtol = torch.tensor(rng.uniform(1e-6, 1e-1, nb), dtype=torch.float32,
                        device=dev)
    rtol[5] = 2.0
    state = cs.pack_state(nb, dev, rz=lane(0.5, 2.0, nb),
                          rr=lane(0.5, 2.0, nb), stop2=lane(0.0, 2.0, nb),
                          alpha=lane(0.1, 1.0, nb), beta=lane(0.1, 1.0, nb),
                          k=torch.tensor(rng.integers(0, 50, nb)),
                          done=torch.tensor(rng.random(nb) < 0.3))
    rr_b = lane(0.5, 2.0)
    rr_b[B // 2] = float("nan")
    fin_state = cs.pack_state(B, dev, rr=rr_b,
                              k=torch.tensor(rng.integers(0, 500, B)))
    fin = lambda mode, rline: (
        lambda st, pt: cs.finalize(st, pt, mode, rtol, rline=rline,
                                   maxiter=40, rtol_wrt="b"),
        lambda st, pt: cs.finalize_reference(st, pt, mode, rtol,
                                             rline=rline, maxiter=40,
                                             rtol_wrt="b"))
    cases = {
        "init": (cs.init, cs.init_reference, (A0, Kv, dks, sm, b, x0), 1e-5),
        "stencil_dot": (cs.stencil_dot, cs.stencil_dot_reference,
                        (A0, Kv, dks, sm, p), 1e-5),
        "update": (cs.update, cs.update_reference, (x, r, p, Ap,
                                                    lane(0.1, 1.0)), 1e-5),
        "pcr_r": (cs.pcr_r, cs.pcr_r_reference, (A0, Kv, dks, sm, r), 1e-4),
        "p_update": (cs.p_update, cs.p_update_reference,
                     (p, r, lane(0.1, 1.0)), 1e-5),
        "compact": (cs.compact, cs.compact_reference, (state,), 0.0),
        "finish": (cs.finish, cs.finish_reference, (x, fin_state), 0.0)}
    for mode, rline in (("init", True), ("alpha", False), ("beta", True)):
        cases[f"finalize[{mode}]"] = (*fin(mode, rline), (state, parts),
                                      1e-12)
    return cases


def k2_phase_bound(name: str, args, outs) -> dict:
    """The bound of one K2 phase kernel on its arguments: the operands it
    reads (the two coupling slots of A0 and Kv for a line solve) and the
    outputs it writes, once each; its operations per grid point and lane,
    or per partial sum / lane for the scalar phases."""
    import torch
    outs = outs if isinstance(outs, tuple) else (outs,)
    ins = [a for a in args if torch.is_tensor(a)]
    base = name.split("[")[0]
    if base in ("pcr_r", "pcr_z"):
        slots = slice(3, 5) if base == "pcr_r" else slice(1, 3)
        ins[0] = ins[0][slots]
        if args[1] is not None:
            ins[1] = ins[1][slots]
    moved = nbytes(*ins, *outs)
    if base in ("finalize", "compact"):
        return bound(moved, ins[-1].numel() if base == "finalize" else
                     ins[0].shape[0])
    fields = next(t for t in reversed(ins) if t.dtype == torch.float32)
    nz, nr = fields.shape[-2:]
    kv = args[1] is not None if base in ("init", "stencil_dot") else True
    per_point = {"init": 35 if kv else 21, "stencil_dot": 31 if kv else 17,
                 "update": 6, "p_update": 2, "finish": 1,
                 "pcr_r": k2_line_ops() + 2,
                 "pcr_z": k2_line_ops() + 5}[base]
    return bound(moved, per_point * fields.numel())


def k2_solve_bound(A0, Kv, dks, sm, b, x0, its, ops_per_iter) -> dict:
    """The bound of one K2 solve: operands and x once; ``its`` (B,) each
    lane's iterations at ``ops_per_iter`` (a number, or (B,) per lane) per
    grid point."""
    import numpy as np
    n = b.shape[-2] * b.shape[-1]
    its = np.nan_to_num(np.asarray(its, float))
    ops = float((its * np.asarray(ops_per_iter, float)).sum()) * n
    return bound(nbytes(A0, Kv, dks, sm, b, x0, b), ops)


def compare_outputs(out_k, out_p) -> tuple[float, float]:
    """(max |error|, max relative error) of a phase kernel's outputs against
    its plain version's: fields and per-lane sums relative to their largest
    magnitude, a per-lane state field by field; integers, the positions of
    non-finite values and a lane list must agree exactly."""
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    pairs = []
    for a, b in zip(as_tuple(out_k), as_tuple(out_p), strict=True):
        if b.dtype == torch.float64 and b.ndim == 2:      # a lane state
            sa, sb = cs.unpack_state(a), cs.unpack_state(b)
            pairs += [(sa[k], sb[k]) for k in sb]
        else:
            pairs.append((a, b))
    err = rel = 0.0
    for a, b in pairs:
        require(a.shape == b.shape, ("shape", a.shape, b.shape))
        if not b.dtype.is_floating_point:
            require(torch.equal(a.cpu(), b.cpu()), "integers differ")
            continue
        fin = torch.isfinite(b)
        require(torch.equal(torch.isfinite(a), fin), "non-finite positions")
        if not bool(fin.any()):
            continue
        d = float((a.double() - b.double())[fin].abs().max())
        scale = float(b.double()[fin].abs().max())
        err = max(err, d)
        rel = max(rel, d / scale if scale > 0 else (0.0 if d == 0 else 1.0))
    return err, rel


def sweep_kernel_checks(problem, device, out: dict) -> dict:
    """Phase 5: the phase kernels of K2/K3 and their full solves against
    their plain versions at the sweep shape."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs

    rng = np.random.default_rng(5)
    B, nan_lane, easy_lane = 8, 3, 5
    ks = np.sort(10.0 ** rng.uniform(0.0, 2.0, B))
    ks[0], ks[-1], ks[nan_lane] = 1.0, 100.0, np.nan
    fs = problem.fwhm * rng.uniform(0.8, 1.2, B)
    A0, Kv, dks, sm, b, x0 = sweep_system(problem, ks, fs, device)
    nz, nr = b.shape[1:]
    live = [i for i in range(B) if i != nan_lane]
    sel = torch.tensor(live, device=device)
    print(f"sweep grid {nz} x {nr}, {A0.shape[0]}-point stencils, the "
          f"10th step's system; lanes "
          f"kappa {np.round(ks, 3).tolist()}, lane {nan_lane} NaN, lane "
          f"{easy_lane} at rtol 2")
    rows = {}

    # every phase kernel alone against its plain version, on the plain
    # version's inputs: the system's finite lanes with random fields, and
    # for the scalar phases random states at the main path's B = 1024
    for name, (fn, ref, args, tol) in sweep_phase_cases(
            A0, Kv, dks[sel].contiguous(), sm[sel].contiguous(),
            b[sel].contiguous(), x0[sel].contiguous(), rng).items():
        out_k, out_p = fn(*args), ref(*args)
        err, rel = compare_outputs(out_k, out_p)
        require(rel <= tol, (name, rel, tol))
        r = rows[f"cg_batched_tol.{name}"] = dict(
            name=f"cg_batched_tol.{name}", phase=name.split("[")[0],
            max_abs_err=err, rel=rel, ms=cuda_ms(lambda: fn(*args), 20),
            plain_ms=cuda_ms(lambda: ref(*args), 5),
            **k2_phase_bound(name, args, out_p))
        print(f"sweep phase {name}: max|err| {err:.3e} (rel {rel:.3e}, "
              f"bound {tol:.0e}), kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    d64 = lambda *ts: tuple(t.double() for t in ts)

    def hold(form, x_k, x_p, x64, it_k=None, it_p=None):
        """Per finite lane: the kernel within 1e-4 rel-L2 of the plain
        version, or within 2x the plain float32 version's own distance from
        float64 where float32 cannot reach 1e-4; counts within
        max(3, 5 %)."""
        worst = dict(rel_l2=0.0, err_k=0.0, err_p=0.0, dit=0)
        for i in live:
            if it_k is not None and i == easy_lane:
                continue
            rel_l2 = norm(x_k[i] - x_p[i]) / norm(x_p[i])
            err_k = norm(x_k[i] - x64[i]) / norm(x64[i])
            err_p = norm(x_p[i] - x64[i]) / norm(x64[i])
            require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, i, rel_l2, err_p))
            require(err_k <= max(1e-4, 1.5 * err_p), (form, i, err_k, err_p))
            if it_k is not None:
                ik, ip = int(it_k[i]), int(it_p[i])
                require(abs(ik - ip) <= max(3, int(0.05 * ip)), (form, i, ik,
                                                                 ip))
                worst["dit"] = max(worst["dit"], abs(ik - ip))
            for key, v in (("rel_l2", rel_l2), ("err_k", err_k),
                           ("err_p", err_p)):
                worst[key] = max(worst[key], v)
        return worst

    # full solves; rtol 1e-6 wrt ||b|| per lane, lane easy_lane at 2
    rtol = torch.full((B,), 1e-6, dtype=torch.float32, device=device)
    rtol[easy_lane] = 2.0
    args = (A0, Kv, dks, sm, b, x0)
    for form, rline in (("identity", False), ("rline", True)):
        kw = dict(maxiter=20000, rtol_wrt="b", rline=rline)
        x_k, it_k = cs.cg_batched_tol(*args, rtol, **kw)
        x_p, it_p = cs.cg_batched_tol_reference(*args, rtol, **kw)
        x64, _ = cs.cg_batched_tol_reference(*d64(*args, rtol), **kw)
        require(bool(torch.isnan(x_k[nan_lane]).all())
                and int(it_k[nan_lane]) == 0, (form, "NaN lane"))
        require(int(it_k[easy_lane]) == 0
                and torch.equal(x_k[easy_lane], x0[easy_lane]),
                (form, "rtol-2 lane"))
        sub = (A0, Kv) + tuple(t[sel].contiguous() for t in args[2:])
        x_7, it_7 = cs.cg_batched_tol(*sub, rtol[sel].contiguous(), **kw)
        require(torch.equal(x_7, x_k[sel]) and torch.equal(it_7, it_k[sel]),
                (form, "lanes changed by the NaN lane"))
        w = hold(form, x_k, x_p, x64, it_k, it_p)
        ms = cuda_ms(lambda: cs.cg_batched_tol(*args, rtol, **kw), 2)
        plain_ms = cuda_ms(lambda: cs.cg_batched_tol_reference(*args, rtol,
                                                               **kw), 1)
        its = [int(i) for i in it_k.tolist()]
        print(f"sweep solve {form}: iters kernel {its} plain "
              f"{[int(i) for i in it_p.tolist()]}; worst lane: kernel vs "
              f"plain rel-L2 {w['rel_l2']:.3e}, vs float64 kernel "
              f"{w['err_k']:.3e} plain {w['err_p']:.3e}; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms")
        rows[f"cg_batched_tol[{form}]"] = dict(
            iters=its, plain_iters=[int(i) for i in it_p.tolist()], **w,
            max_abs_err=float((x_k[sel] - x_p[sel]).abs().max()), ms=ms,
            plain_ms=plain_ms,
            **k2_solve_bound(*args, its, k2_iter_ops(rline)))

    # K3: 120 iterations, every lane
    x_k = cs.cg_batched(*args, iters=120)
    x_p = cs.cg_batched_reference(*args, iters=120)
    x64 = cs.cg_batched_reference(*d64(*args), iters=120)
    require(bool(torch.isnan(x_k[nan_lane]).all()), "K3 NaN lane")
    w = hold("fixed", x_k, x_p, x64)
    ms = cuda_ms(lambda: cs.cg_batched(*args, iters=120), 3)
    plain_ms = cuda_ms(lambda: cs.cg_batched_reference(*args, iters=120), 1)
    print(f"sweep fixed 120 iterations: worst lane kernel vs plain rel-L2 "
          f"{w['rel_l2']:.3e}, vs float64 kernel {w['err_k']:.3e} plain "
          f"{w['err_p']:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows["cg_batched[fixed]"] = dict(
        **w, max_abs_err=float((x_k[sel] - x_p[sel]).abs().max()), ms=ms,
        plain_ms=plain_ms,
        **k2_solve_bound(*args, [120] * B, k2_iter_ops()))
    out["sweep_checks"] = rows
    return rows


def _sweep_counts():
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    return dict(phases=cs.phase_launches(),
                identity=cs.cg_batched_tol.launches_identity,
                rline=cs.cg_batched_tol.launches_rline,
                adi=cs.cg_batched_tol.launches_adi,
                adaptive=cs.cg_batched_tol.launches_adaptive,
                no_kv=cs.cg_batched_tol.launches_no_kv,
                fixed=cs.cg_batched.launches)


def run_sweep(problem, device, out: dict) -> dict:
    """Phase 6: the B = 1024 coefficient sweep, and four of its lanes
    against the same lanes at B = 4 and the plain eager sweeps."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import run_sweep_time_chunked

    ks = np.logspace(0.0, 2.0, SWEEP_B)
    fs = np.full(SWEEP_B, problem.fwhm)
    kw = dict(SWEEP_RECIPE, dtype=torch.float32, device=device)
    sweep = lambda **more: run_sweep_time_chunked(problem, ks, fs, **kw,
                                                  **more)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cuda_sweep.reset_counters()
    its = []
    t0 = time.perf_counter()
    tr = sweep(iters_out=its)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _sweep_counts()
    iters = torch.stack(its).cpu().numpy()          # (steps, B)
    finite = float(np.isfinite(tr).all(axis=(1, 2)).mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cps = SWEEP_B / run_s
    lane_mean = iters.mean(axis=0)
    print(f"sweep: B = {SWEEP_B}, {problem.num_steps} steps in {run_s:.4f} s "
          f"= {cps:.4f} configs/s (warm-up run {warm_s:.2f} s); iterations a "
          f"step: mean {iters.mean():.2f}, per-lane mean "
          f"{lane_mean.min():.2f}..{lane_mean.max():.2f}, max "
          f"{int(iters.max())}; finite lanes {finite}; peak device memory "
          f"{peak_gb:.2f} GB")
    print(f"sweep launches: {counts}")
    require(tr.shape == (SWEEP_B, problem.num_steps, len(problem.watcher_names))
            and finite == 1.0, ("sweep output", tr.shape, finite))
    require(counts["identity"] > 0, counts)

    # four lanes, held three ways. (1) Run again as a B = 4 sweep through
    # the kernels: a lane's arithmetic depends neither on the batch nor on
    # the lane list, so its traces and per-step counts equal those of the
    # B = 1024 run bitwise. (2) Its iterations over the 40 steps within
    # max(3, 2 %) of the plain eager float32 sweep's: per step they cannot
    # be compared, since from the 20th step on a lane's counts alternate
    # between ~20 and ~50 with the side of the stop its previous step
    # landed on, and two correct roundings land on different sides. (3)
    # Traces within 2x the plain float32 sweep's own distance from the
    # plain float64 sweep of the same recipe (rtol 1e-4 wrt ||b||, Jacobi),
    # + 0.1 K.
    idx = [0, SWEEP_B // 3, 2 * SWEEP_B // 3, SWEEP_B - 1]
    runs = {}
    for name, extra in (("kernel, B = 4", {}),
                        ("plain f32", dict(solver="xla")),
                        ("plain f64", dict(solver="xla",
                                           dtype=torch.float64))):
        its4 = []
        t0 = time.perf_counter()
        tr4 = run_sweep_time_chunked(problem, ks[idx], fs[idx], iters_out=its4,
                                     **dict(kw, **extra))
        torch.cuda.synchronize()
        runs[name] = (tr4, torch.stack(its4).cpu().numpy().astype(int))
        print(f"{name} sweep, 4 lanes: {time.perf_counter() - t0:.2f} s")
    tr4, it4 = runs["kernel, B = 4"]
    require(np.array_equal(tr4, tr[idx]) and np.array_equal(it4, iters[:, idx]),
            "the B = 4 sweep differs from its lanes in the B = 1024 sweep")
    print("sweep: the four lanes run as a B = 4 sweep equal their B = 1024 "
          "traces and per-step counts bitwise")
    (p32, it32), (p64, it64) = runs["plain f32"], runs["plain f64"]
    lanes, failed = [], []
    for j, i in enumerate(idx):
        d_k = float(np.abs(tr[i] - p32[j]).max())
        d_p = float(np.abs(p32[j] - p64[j]).max())
        d_t = float(np.abs(tr[i] - p64[j]).max())
        n_k, n_p, n_64 = int(iters[:, i].sum()), int(it32[:, j].sum()), \
            int(it64[:, j].sum())
        step_diff = int(np.abs(iters[:, i] - it32[:, j]).max())
        lanes.append(dict(kappa=float(ks[i]), kernel_vs_plain_K=d_k,
                          plain_vs_f64_K=d_p, kernel_vs_f64_K=d_t,
                          iters=n_k, plain_iters=n_p, f64_iters=n_64,
                          max_step_iters_diff=step_diff))
        print(f"sweep lane kappa {ks[i]:.4f}: kernel vs plain f32 {d_k:.4f} K "
              f"(bound {2 * d_p + 0.1:.4f} K); vs plain f64 of the recipe: "
              f"plain f32 {d_p:.4f} K, kernel {d_t:.4f} K; iterations in "
              f"{problem.num_steps} steps kernel {n_k}, plain f32 {n_p}, "
              f"plain f64 {n_64} (largest per-step difference {step_diff})")
        if abs(n_k - n_p) > max(3, int(0.02 * n_p)):
            failed.append(("sweep lane iterations", ks[i], n_k, n_p))
        if d_k > 2.0 * d_p + 0.1:
            failed.append(("sweep lane traces", ks[i], d_k, d_p))
    require(not failed, failed)
    out["sweep"] = dict(B=SWEEP_B, steps=problem.num_steps, run_s=run_s,
                        warm_run_s=warm_s, configs_per_s=cps,
                        iters_mean=float(iters.mean()),
                        iters_max=int(iters.max()),
                        lane_iters_mean=lane_mean.tolist(),
                        finite_share=finite, peak_mem_gb=peak_gb,
                        launches=counts, checked_lanes=lanes)
    return counts, sweep


def run_sweep_forms(problem, device, out: dict) -> list[dict]:
    """Phase 7: K3 and K2's r-line form through the sweep entry points at
    B = 64, and a chunked 'extrapolate' sweep against the unchunked one."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                    run_sweep_time_chunked)
    runs = []

    def timed(name, call):
        cuda_sweep.reset_counters()
        t0 = time.perf_counter()
        tr = call()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        tr = tr.cpu().numpy() if torch.is_tensor(tr) else tr
        counts = _sweep_counts()
        require(np.isfinite(tr).all(), (name, "non-finite traces"))
        print(f"sweep form {name}: B = {tr.shape[0]}, {tr.shape[1]} steps in "
              f"{run_s:.4f} s = {tr.shape[0] / run_s:.4f} configs/s; "
              f"launches {counts}")
        runs.append(dict(name=name, B=tr.shape[0], run_s=run_s,
                         launches=counts))
        return tr

    ks = np.logspace(0.0, 2.0, 64)
    fs = np.full(64, problem.fwhm)
    f32 = dict(dtype=torch.float32, device=device, rtol=1e-4)
    timed("fixed_iters=120", lambda: make_sweep_fn(
        problem, solver="vmem", fixed_iters=120, **f32)(ks, fs))
    timed("rline", lambda: make_sweep_fn(
        problem, solver="vmem", precondition="rline", **f32)(ks, fs))
    ks8, fs8 = np.logspace(0.0, 2.0, 8), np.full(8, problem.fwhm)
    chunked = timed("extrapolate, chunked 20 + 20",
                    lambda: run_sweep_time_chunked(
                        problem, ks8, fs8, step_chunk=25, solver="vmem",
                        warm_start="extrapolate", **f32))
    whole = timed("extrapolate, unchunked", lambda: make_sweep_fn(
        problem, solver="vmem", warm_start="extrapolate", **f32)(ks8, fs8))
    require(np.array_equal(chunked, whole), "chunked != unchunked")
    print("sweep extrapolate: chunked 20 + 20 equals unchunked bitwise")
    out["sweep_forms"] = runs
    return runs


def projection_system(problem, ks, fs, device, step: int = 10):
    """The gradient-projection system of the recording sweep's ``step``-th
    step, read off the Kv-free kernel call's arguments during a recording
    run of the driver's recipe: (Mp, s_mp, b, x0) with b = s_mp·Gr·u of the
    step's fields and x0 the extrapolated seed, float32."""
    import functools
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn_recording
    seen = {"n": 0}
    kernel = cuda_sweep.cg_batched_tol

    @functools.wraps(kernel)
    def capture(*args, **kw):
        if args[1] is None:
            seen["n"] += 1
            if seen["n"] == step:
                seen["args"] = tuple(a.clone() for a in
                                     (args[0], args[3], args[4], args[5]))
        return kernel(*args, **kw)

    fn = make_sweep_fn_recording(problem, dtype=torch.float32, device=device,
                                 **REC_RECIPE)
    cuda_sweep.cg_batched_tol = capture
    try:
        fn(ks, fs)
    finally:
        cuda_sweep.cg_batched_tol = kernel
    return seen["args"]


def projection_checks(problem, device, out: dict) -> dict:
    """Phase 8: K2's Kv-free form (the mass projection) against its plain
    version at the sweep shape."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs

    rng = np.random.default_rng(8)
    B, nan_lane, easy_lane = 8, 3, 5
    ks = np.sort(10.0 ** rng.uniform(0.0, 2.0, B))
    ks[0], ks[-1], ks[nan_lane] = 1.0, 100.0, np.nan
    fs = problem.fwhm * rng.uniform(0.8, 1.2, B)
    Mp, s_mp, b, x0 = projection_system(problem, ks, fs, device)
    nz, nr = s_mp.shape
    live = [i for i in range(B) if i != nan_lane]
    sel = torch.tensor(live, device=device)
    require(bool(torch.isnan(b[nan_lane]).any())
            and bool(torch.isfinite(b[sel]).all()), "projection system")
    print(f"projection grid {nz} x {nr}, {Mp.shape[0]}-point mass stencil, "
          f"one shared s_mp plane; the 10th step's system of {B} lanes, "
          f"lane {nan_lane} NaN, lane {easy_lane} at rtol 2")
    rows = {}
    bs, x0s = b[sel].contiguous(), x0[sel].contiguous()
    p = (torch.tensor(rng.standard_normal((len(live), nz, nr)),
                      dtype=torch.float32, device=device)).contiguous()
    for name, fn, ref, args in (
            ("init", cs.init, cs.init_reference,
             (Mp, None, None, s_mp, bs, x0s)),
            ("stencil_dot", cs.stencil_dot, cs.stencil_dot_reference,
             (Mp, None, None, s_mp, p))):
        out_p = ref(*args)
        err, rel = compare_outputs(fn(*args), out_p)
        require(rel <= 1e-5, (name, "no_kv", rel))
        r = rows[f"cg_batched_tol.{name}[no_kv]"] = dict(
            name=f"cg_batched_tol.{name}[no_kv]", phase=f"{name}_no_kv",
            max_abs_err=err, rel=rel, ms=cuda_ms(lambda: fn(*args), 20),
            plain_ms=cuda_ms(lambda: ref(*args), 5),
            **k2_phase_bound(name, args, out_p))
        print(f"projection phase {name}: max|err| {err:.3e} (rel {rel:.3e}, "
              f"bound 1e-05), kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms")

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rtol = torch.full((B,), 1e-11, dtype=torch.float32, device=device)
    rtol[easy_lane] = 2.0
    args = (Mp, None, None, s_mp, b, x0, rtol)
    kw = dict(maxiter=400, rtol_wrt="b")
    x_k, it_k = cs.cg_batched_tol(*args, **kw)
    x_p, it_p = cs.cg_batched_tol_reference(*args, **kw)
    x64, it64 = cs.cg_batched_tol_reference(
        Mp.double(), None, None, s_mp.double(), b.double(), x0.double(),
        rtol.double(), **kw)
    its_k, its_p = it_k.tolist(), it_p.tolist()
    require(bool(torch.isnan(x_k[nan_lane]).all()) and its_k[nan_lane] == 0,
            "projection NaN lane")
    require(its_k[easy_lane] == 0 and torch.equal(x_k[easy_lane],
                                                  x0[easy_lane]),
            "projection rtol-2 lane")
    require(its_k == its_p, ("projection counts", its_k, its_p))
    worst = dict(rel_l2=0.0, err_k=0.0, err_p=0.0)
    for i in live:
        rel_l2 = norm(x_k[i] - x_p[i]) / norm(x_p[i])
        require(rel_l2 <= PROJ_REL_L2, ("projection rel-L2", i, rel_l2))
        for key, v in (("rel_l2", rel_l2),
                       ("err_k", norm(x_k[i] - x64[i]) / norm(x64[i])),
                       ("err_p", norm(x_p[i] - x64[i]) / norm(x64[i]))):
            worst[key] = max(worst[key], v)
    ms = cuda_ms(lambda: cs.cg_batched_tol(*args, **kw), 5)
    plain_ms = cuda_ms(lambda: cs.cg_batched_tol_reference(*args, **kw), 2)
    print(f"projection solve: iters kernel {its_k} plain {its_p} float64 "
          f"{it64.tolist()}; worst lane: kernel vs plain rel-L2 "
          f"{worst['rel_l2']:.3e} (bound {PROJ_REL_L2:.0e}), vs float64 "
          f"kernel {worst['err_k']:.3e} plain {worst['err_p']:.3e}; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    rows["cg_batched_tol[no_kv]"] = dict(
        iters=its_k, plain_iters=its_p, f64_iters=it64.tolist(), **worst,
        max_abs_err=float((x_k[sel] - x_p[sel]).abs().max()), ms=ms,
        plain_ms=plain_ms,
        **k2_solve_bound(Mp, None, None, s_mp, b, x0, its_k,
                         k2_iter_ops(kv=False)))
    out["projection_checks"] = rows
    return rows


def run_recording(problem, device, out: dict) -> dict:
    """Phase 9: the B = 256 recording sweep, and four of its lanes against
    themselves at B = 4 and the plain float32 / float64 recordings."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn_recording

    fams = ("watch", "band", "axis")
    make = lambda **kw: make_sweep_fn_recording(
        problem, device=device, **{**REC_RECIPE, "dtype": torch.float32,
                                   **kw})
    fn = make()
    ks = np.logspace(0.0, 2.0, REC_B)
    fs = np.full(REC_B, problem.fwhm)
    warm = np.linspace(0, REC_B - 1, 8).astype(int)
    t0 = time.perf_counter()
    fn(ks[warm], fs[warm])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.reset_counters()
    its, pits = [], []
    t0 = time.perf_counter()
    ys = fn(ks, fs, iters_out=its, proj_iters_out=pits)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _sweep_counts()
    ys = {k: ys[k].cpu().numpy() for k in fams}
    its = torch.stack(its).cpu().numpy()          # (steps, B)
    pits = torch.stack(pits).cpu().numpy()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = {k: float(np.isfinite(v).all(axis=(1, 2)).mean())
              for k, v in ys.items()}
    cps = REC_B / run_s
    per_proj = (counts["phases"]["stencil_dot_no_kv"]
                / max(1, counts["no_kv"]))
    print(f"recording: B = {REC_B}, {problem.num_steps} steps in "
          f"{run_s:.4f} s = {cps:.4f} configs/s (warm-up B = 8 run "
          f"{warm_s:.2f} s); finite lanes {finite}; solve iterations a "
          f"lane-step mean {its.mean():.2f} max {int(its.max())}; projection "
          f"mean {pits.mean():.2f} max {int(pits.max())}; projection "
          f"stencil launches a projection {per_proj:.2f}; peak device "
          f"memory {peak_gb:.2f} GB")
    print(f"recording launches: {counts}")
    require(all(v == 1.0 for v in finite.values()), finite)
    require(counts["rline"] > 0 and counts["no_kv"] > 0, counts)

    # four lanes, held three ways (as in phase 6): (1) run as a B = 4
    # kernel sweep they equal themselves bitwise in every family; (2) their
    # solve and projection iterations over the 40 steps within max(3, 2 %)
    # of the plain float32 recording's (solver='xla', on the card); (3)
    # each family within 2x the plain float32 recording's distance from the
    # plain float64 recording of the same recipe, + the family's margin
    idx = [0, REC_B // 3, 2 * REC_B // 3, REC_B - 1]
    runs = {}
    for name, kw in (("kernel, B = 4", {}), ("plain f32", dict(solver="xla")),
                     ("plain f64", dict(solver="xla", dtype=torch.float64))):
        i4, p4 = [], []
        t0 = time.perf_counter()
        y4 = make(**kw)(ks[idx], fs[idx], iters_out=i4, proj_iters_out=p4)
        torch.cuda.synchronize()
        runs[name] = ({k: y4[k].cpu().numpy() for k in fams},
                      torch.stack(i4).cpu().numpy().astype(int),
                      torch.stack(p4).cpu().numpy().astype(int))
        print(f"recording {name}, 4 lanes: {time.perf_counter() - t0:.2f} s")
    y4, i4, p4 = runs["kernel, B = 4"]
    same = {k: np.array_equal(y4[k], ys[k][idx]) for k in fams}
    same.update(solve_iters=np.array_equal(i4, its[:, idx]),
                proj_iters=np.array_equal(p4, pits[:, idx]))
    require(all(same.values()),
            ("the B = 4 recording differs from its lanes at B = 256", same))
    print("recording: the four lanes run as a B = 4 sweep equal their "
          "B = 256 watch, band and axis rows and counts bitwise")
    (y32, i32, p32), (y64, _, _) = runs["plain f32"], runs["plain f64"]
    lanes, failed = [], []
    for j, i in enumerate(idx):
        lane = dict(kappa=float(ks[i]))
        for what, nk, n32 in (("solve", its[:, i].sum(), i32[:, j].sum()),
                              ("projection", pits[:, i].sum(),
                               p32[:, j].sum())):
            lane[f"{what}_iters"], lane[f"plain_{what}_iters"] = \
                int(nk), int(n32)
            if abs(int(nk) - int(n32)) > max(3, int(0.02 * n32)):
                failed.append((what, "iterations", ks[i], int(nk), int(n32)))
        for k in fams:
            scale = float(np.abs(y64[k][j]).max()) if k != "watch" else 1.0
            d_k = float(np.abs(ys[k][i] - y32[k][j]).max())
            d_p = float(np.abs(y32[k][j] - y64[k][j]).max())
            d_t = float(np.abs(ys[k][i] - y64[k][j]).max())
            bound = 2.0 * d_p + REC_MARGIN[k] * scale
            lane[k] = dict(kernel_vs_plain=d_k, plain_vs_f64=d_p,
                           kernel_vs_f64=d_t, bound=bound, scale=scale)
            if d_k > bound:
                failed.append((k, ks[i], d_k, bound))
        lanes.append(lane)
        print(f"recording lane kappa {ks[i]:.4f}: iterations in "
              f"{problem.num_steps} steps solve {lane['solve_iters']} "
              f"(plain f32 {lane['plain_solve_iters']}), projection "
              f"{lane['projection_iters']} (plain f32 "
              f"{lane['plain_projection_iters']}); "
              + "; ".join(f"{k} kernel vs plain f32 "
                          f"{lane[k]['kernel_vs_plain']:.4g} (bound "
                          f"{lane[k]['bound']:.4g}), vs plain f64: plain "
                          f"{lane[k]['plain_vs_f64']:.4g} kernel "
                          f"{lane[k]['kernel_vs_f64']:.4g}" for k in fams))
    require(not failed, failed)
    out["recording"] = dict(
        B=REC_B, steps=problem.num_steps, run_s=run_s, warm_run_s=warm_s,
        configs_per_s=cps, finite_share=finite,
        solve_iters_mean=float(its.mean()), solve_iters_max=int(its.max()),
        proj_iters_mean=float(pits.mean()), proj_iters_max=int(pits.max()),
        proj_stencil_launches_per_projection=per_proj, peak_mem_gb=peak_gb,
        launches=counts, checked_lanes=lanes)
    return counts, lambda: fn(ks, fs)


def run_drivers(device, out: dict) -> dict:
    """Phase 10: the sweep CLI (recording, default grid) and the 2D CLI on
    the flagship config."""
    import csv
    import numpy as np
    import torch
    from heatflow_tpu_torch.config import load_config, save_config
    from heatflow_tpu_torch.drivers import run2d, sweep
    from heatflow_tpu_torch.io.csvio import (read_gradient_csv,
                                             read_watcher_csv)
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.stepper import run_transient

    work = os.path.join(ROOT, "build", "chip_smoke")
    cfgs = {}
    for name, path in (("sweep", SWEEP_CFG), ("run2d", CFG)):
        cfg = load_config(path)       # the heating file, from anywhere
        cfg["heating"]["file"] = CSV
        cfgs[name] = os.path.join(work, f"{name}.yaml")
        save_config(cfg, cfgs[name])
    sweep_out = os.path.join(work, "sweep_out")
    cuda_sweep.reset_counters()
    timings = {}
    t0 = time.perf_counter()
    sweep.main(["--config", cfgs["sweep"], "--output-dir", sweep_out,
                "--mesh-folder", os.path.join(work, "sweep_meshes"),
                "--record-gradient", "--device", str(device), "--verbose"],
               timings=timings)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = _sweep_counts()
    with open(os.path.join(sweep_out, "successful_runs.csv")) as f:
        ok_runs = list(csv.DictReader(f))
    meta = json.load(open(os.path.join(sweep_out, "sweep_metadata.json")))
    require(len(ok_runs) == 75 and not os.path.exists(
        os.path.join(sweep_out, "failed_runs.csv")), ("sweep runs",
                                                      len(ok_runs)))
    for rec in ok_runs:
        have = set(os.listdir(os.path.join(sweep_out, rec["run_name"])))
        require({"watcher_points.csv", "radial_gradient.csv",
                 "radial_gradient_raw.csv", "used_config.yaml"} <= have,
                (rec["run_name"], have))
    require(len(meta["solver_resolved"]) == 3
            and set(meta["solver_resolved"].values()) == {"vmem"}
            and meta["precondition"] == "rline", meta)
    print(f"sweep CLI: 75 runs over 3 widths, wall {wall_s:.2f} s (mesh "
          f"builds included), compute {timings['compute_s']:.2f} s, "
          f"artifact writes {timings['write_s']:.2f} s of CPU (background "
          f"thread), "
          f"{75 / wall_s:.3f} configs/s of wall time, "
          f"{75 / timings['compute_s']:.3f} of compute; solver_resolved "
          f"{meta['solver_resolved']}; launches {counts}")

    run_out = os.path.join(work, "run2d_out")
    t0 = time.perf_counter()
    run2d.main(["--config", cfgs["run2d"], "--mesh-folder",
                os.path.join(work, "run2d_mesh"), "--rebuild-mesh",
                "--output-folder", run_out, "--watcher-points", "auto",
                "--device", str(device), "--suppress-print"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    cols = read_watcher_csv(os.path.join(run_out, "watcher_points.csv"))
    names = list(cols)[1:]
    got = np.column_stack(list(cols.values()))
    # the options the driver resolves on a card: float32, 'extrapolate',
    # rtol 1e-4 wrt r0, precondition 'adi', the kernel path
    problem = build_flagship()
    res = run_transient(problem, dtype=torch.float32, device=device,
                        rtol=1e-4, maxiter=20000, record_gradient=True,
                        record_fields=False, solver="auto",
                        warm_start="extrapolate", precondition="adi")
    require(names == list(problem.watcher_names)
            and np.array_equal(got[:, 0].astype(np.float32),
                               res.times.astype(np.float32))
            and np.array_equal(got[:, 1:].astype(np.float32), res.watcher),
            "run2d watcher_points.csv differs from run_transient")
    for grad in ("radial_gradient.csv", "radial_gradient_raw.csv"):
        vals = read_gradient_csv(os.path.join(run_out, grad))[2]
        require(vals.size and np.isfinite(vals).all(), (grad, "finite"))
    require(os.path.isfile(os.path.join(run_out, "checkpoint.npz")),
            "run2d checkpoint")
    truth = np.load(TRUTH)["watch"]
    peak = np.abs(got[:, 1:] - truth).max(axis=0)
    print(f"run2d CLI: {run_s:.2f} s (mesh build and .msh write included); "
          f"watcher_points.csv equals run_transient bitwise; gradient CSVs "
          f"finite; checkpoint written; peak |error| vs f64 truth: "
          + ", ".join(f"{n} {e:.4f} K" for n, e in zip(names, peak)))
    out["drivers"] = dict(sweep_cli_s=wall_s, sweep_launches=counts,
                          **{f"sweep_{k}": v for k, v in timings.items()},
                          run2d_cli_s=run_s,
                          run2d_peak_err_K=dict(zip(names, peak.tolist())))
    return counts

def adi_checks(problem, device, out: dict) -> dict:
    """Phase 11: K2's z-line phase and its ADI and adaptive solves against
    their plain versions at the sweep shape, and the adaptive lanes against
    the static solves' lanes (bitwise)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs

    rng = np.random.default_rng(11)
    B, nan_lane, easy_lane = 8, 3, 5
    ks = np.sort(10.0 ** rng.uniform(0.0, 2.0, B))
    ks[0], ks[-1], ks[nan_lane] = 1.0, 100.0, np.nan
    fs = problem.fwhm * rng.uniform(0.8, 1.2, B)
    A0, Kv, dks, sm, b, x0 = sweep_system(problem, ks, fs, device)
    nz, nr = b.shape[1:]
    live = [i for i in range(B) if i != nan_lane]
    sel = torch.tensor(live, device=device)
    flags = torch.tensor([1, 0, 1, 1, 0, 1, 0, 1], dtype=torch.int32,
                         device=device)
    print(f"ADI checks: sweep grid {nz} x {nr}, the 10th step's system; "
          f"lanes kappa {np.round(ks, 3).tolist()}, lane {nan_lane} NaN, "
          f"lane {easy_lane} at rtol 2, adaptive flags {flags.tolist()}")
    rows = {}

    # the z-line phase alone: r random on the finite lanes, R r from the
    # r-line phase kernel, z = R r + Z r - r against the plain version
    dk7, sm7 = dks[sel].contiguous(), sm[sel].contiguous()
    r = (torch.tensor(rng.standard_normal((len(live), nz, nr)),
                      dtype=torch.float32, device=device)
         * (sm7 != 0)).contiguous()
    z_r, _ = cs.pcr_r(A0, Kv, dk7, sm7, r)
    args = (A0, Kv, dk7, sm7, r, z_r)
    out_p = cs.pcr_z_reference(*args)
    err, rel = compare_outputs(cs.pcr_z(*args), out_p)
    require(rel <= 1e-4, ("pcr_z", rel))
    row = rows["cg_batched_tol.pcr_z"] = dict(
        name="cg_batched_tol.pcr_z", phase="pcr_z", max_abs_err=err, rel=rel,
        ms=cuda_ms(lambda: cs.pcr_z(*args), 20),
        plain_ms=cuda_ms(lambda: cs.pcr_z_reference(*args), 5),
        **k2_phase_bound("pcr_z", args, out_p))
    print(f"ADI phase pcr_z: max|err| {err:.3e} (rel {rel:.3e}, bound 1e-04), "
          f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rtol = torch.full((B,), 1e-6, dtype=torch.float32, device=device)
    rtol[easy_lane] = 2.0
    kw = dict(maxiter=20000, rtol_wrt="r0")
    args = (A0, Kv, dks, sm, b, x0)
    d64 = tuple(t.double() for t in args)
    got = {}
    for form, fkw in (("adi", dict(adi=True)),
                      ("adaptive", dict(adi_flags=flags))):
        x_k, it_k = cs.cg_batched_tol(*args, rtol, **kw, **fkw)
        x_p, it_p = cs.cg_batched_tol_reference(*args, rtol, **kw, **fkw)
        x64, _ = cs.cg_batched_tol_reference(*d64, rtol.double(), **kw,
                                             **fkw)
        got[form] = (x_k, it_k)
        require(bool(torch.isnan(x_k[nan_lane]).all())
                and int(it_k[nan_lane]) == 0, (form, "NaN lane"))
        require(int(it_k[easy_lane]) == 0
                and torch.equal(x_k[easy_lane], x0[easy_lane]),
                (form, "rtol-2 lane"))
        worst = dict(rel_l2=0.0, err_k=0.0, err_p=0.0, dit=0)
        for i in live:
            if i == easy_lane:
                continue
            ik, ip = int(it_k[i]), int(it_p[i])
            require(abs(ik - ip) <= max(3, int(0.02 * ip)), (form, i, ik, ip))
            rel_l2 = norm(x_k[i] - x_p[i]) / norm(x_p[i])
            err_k = norm(x_k[i] - x64[i]) / norm(x64[i])
            err_p = norm(x_p[i] - x64[i]) / norm(x64[i])
            require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, i, rel_l2, err_p))
            require(err_k <= max(1e-4, 1.5 * err_p), (form, i, err_k, err_p))
            for key, v in (("rel_l2", rel_l2), ("err_k", err_k),
                           ("err_p", err_p), ("dit", abs(ik - ip))):
                worst[key] = max(worst[key], v)
        ms = cuda_ms(lambda: cs.cg_batched_tol(*args, rtol, **kw, **fkw), 2)
        plain_ms = cuda_ms(
            lambda: cs.cg_batched_tol_reference(*args, rtol, **kw, **fkw), 1)
        its = [int(i) for i in it_k.tolist()]
        adi_ops, rline_ops = k2_iter_ops(True, True), k2_iter_ops(True)
        per_lane = ([adi_ops] * B if form == "adi" else
                    [adi_ops if f else rline_ops for f in flags.tolist()])
        rows[f"cg_batched_tol[{form}]"] = dict(
            iters=its, plain_iters=[int(i) for i in it_p.tolist()], **worst,
            max_abs_err=float((x_k[sel] - x_p[sel]).abs().max()), ms=ms,
            plain_ms=plain_ms, **k2_solve_bound(*args, its, per_lane))
        print(f"ADI solve {form}: iters kernel {its} plain "
              f"{[int(i) for i in it_p.tolist()]}; worst lane: kernel vs "
              f"plain rel-L2 {worst['rel_l2']:.3e}, vs float64 kernel "
              f"{worst['err_k']:.3e} plain {worst['err_p']:.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms")

    # every adaptive lane is the static solve's lane of its flag, bitwise
    x_r, it_r = cs.cg_batched_tol(*args, rtol, rline=True, **kw)
    (x_a, it_a), (x_d, it_d) = got["adaptive"], got["adi"]
    for i, f in enumerate(flags.tolist()):
        x_s, it_s = (x_d, it_d) if f else (x_r, it_r)
        same = (torch.equal(x_a[i], x_s[i]) if i != nan_lane else
                bool(torch.isnan(x_a[i]).all() and torch.isnan(x_s[i]).all()))
        require(same and int(it_a[i]) == int(it_s[i]),
                ("adaptive lane differs from the static lane", i, f))
    print("ADI: every adaptive lane equals the static ADI (flag 1) or "
          "r-line (flag 0) solve's lane bitwise, iterates and counts")
    out["adi_checks"] = rows
    return rows


def run_adi_sweeps(problem, device, out: dict):
    """Phase 12: the B = 256 sweeps with K2's ADI and adaptive forms, and
    four lanes of each against the same lanes at B = 4 (bitwise). Returns
    each run's launch counts and a callable that runs the ADI sweep
    again."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import run_sweep_time_chunked

    ks = np.logspace(0.0, 2.0, ADI_B)
    fs = np.full(ADI_B, problem.fwhm)
    idx = [0, ADI_B // 3, 2 * ADI_B // 3, ADI_B - 1]
    counts_all, runs = [], []
    for name, recipe in ADI_RECIPES.items():
        kw = dict(recipe, solver="vmem", dtype=torch.float32, device=device,
                  step_chunk=problem.num_steps)
        warm = np.linspace(0, ADI_B - 1, 8).astype(int)
        run_sweep_time_chunked(problem, ks[warm], fs[warm], **kw)
        torch.cuda.synchronize()
        cuda_sweep.reset_counters()
        its = []
        t0 = time.perf_counter()
        tr = run_sweep_time_chunked(problem, ks, fs, iters_out=its, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _sweep_counts()
        counts_all.append(counts)
        iters = torch.stack(its).cpu().numpy()              # (steps, B)
        finite = float(np.isfinite(tr).all(axis=(1, 2)).mean())
        # the flags of step n are iters[n - 1] > 100; every lane at step 0
        flagged = (float(np.concatenate([np.ones(ADI_B), (
            iters[:-1] > 100).ravel()]).mean())
            if name == "adaptive" else None)
        its4 = []
        tr4 = run_sweep_time_chunked(problem, ks[idx], fs[idx],
                                     iters_out=its4, **kw)
        it4 = torch.stack(its4).cpu().numpy()
        bitwise = (np.array_equal(tr4, tr[idx])
                   and np.array_equal(it4, iters[:, idx]))
        cps = ADI_B / run_s
        print(f"{name} sweep: B = {ADI_B}, {problem.num_steps} steps in "
              f"{run_s:.4f} s = {cps:.4f} configs/s; iterations a lane-step "
              f"mean {iters.mean():.2f} max {int(iters.max())}; finite lanes "
              f"{finite}; flagged lane-steps {flagged}; B = 4 lanes bitwise "
              f"{bitwise}; launches {counts}")
        require(finite == 1.0, (name, "finite lanes", finite))
        require(bitwise, (name, "the B = 4 sweep differs from its lanes"))
        require(counts[name] > 0 and counts["phases"]["pcr_z"] > 0, counts)
        runs.append(dict(name=name, recipe=recipe, B=ADI_B, run_s=run_s,
                         configs_per_s=cps, finite_share=finite,
                         flagged_share=flagged,
                         iters_mean=float(iters.mean()),
                         iters_max=int(iters.max()), launches=counts))
    out["adi_sweeps"] = runs
    kw = dict(ADI_RECIPES["adi"], solver="vmem", dtype=torch.float32,
              device=device, step_chunk=problem.num_steps)
    return counts_all, lambda: run_sweep_time_chunked(problem, ks, fs, **kw)


def vmem_solve_checks(problem, device, out: dict) -> dict:
    """Phase 13a: the differentiable cg_vmem_solve on the flagship's first
    step system (r-line stack): value, backward and tangent, kernel against
    the plain version on the card (float32, and float64 for the floor)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    pcr = cuda_cg.pcr_pack(A32, s32, free32).contiguous()
    nz, nr = b32.shape
    rng = np.random.default_rng(13)
    dev = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    g = dev(rng.standard_normal((nz, nr))) * free32
    tangents = (dev(rng.uniform(-1e-3, 1e-3, A32.shape)) * A32,
                dev(rng.uniform(-1e-3, 1e-3, (nz, nr))) * sm32,
                dev(rng.standard_normal((nz, nr))) * free32 * 1e-2)
    x0 = torch.zeros_like(b32)
    kw = dict(maxiter=20000, rtol_wrt="r0")
    rtol = 1e-5
    import functools
    seen = []
    kernel = cuda_cg.cg_tol

    @functools.wraps(kernel)     # with its own copy of the launch counters
    def counting(*args, **k):
        x, it = kernel(*args, **k)
        seen.append(int(it))
        return x, it

    def run(solve, dtype):
        cast = lambda t: t.to(dtype)
        A, sm, b = (cast(t).requires_grad_() for t in (A32, sm32, b32))
        st = cast(pcr)
        f = lambda A, sm, b: solve(A, sm, b, cast(x0), rtol, pcr=st, **kw)
        x = f(A, sm, b)
        grads = torch.autograd.grad(x, (A, sm, b), cast(g))
        _, tx = torch.func.jvp(f, (cast(A32), cast(sm32), cast(b32)),
                               tuple(cast(t) for t in tangents))
        return (x.detach(), *grads, tx)

    cuda_cg.reset_counters()
    cuda_cg.cg_tol = counting
    try:
        got = run(cuda_cg.cg_vmem_solve, torch.float32)
    finally:
        cuda_cg.cg_tol = kernel
    launches = dict(forward=cuda_cg.cg_vmem_solve.launches_forward,
                    backward=cuda_cg.cg_vmem_solve.launches_backward,
                    jvp=cuda_cg.cg_vmem_solve.launches_jvp)
    # the forward pass, the backward pass, and the jvp's primal and tangent
    require(launches == dict(forward=2, backward=1, jvp=1), launches)
    iters = dict(forward=seen[0], backward=seen[1], jvp=seen[3])
    plain = run(cuda_cg.cg_vmem_solve_reference, torch.float32)
    f64 = run(cuda_cg.cg_vmem_solve_reference, torch.float64)
    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    names = ("x", "grad_A", "grad_sm", "grad_b", "tangent")
    agree = {}
    for name, k, p, d in zip(names, got, plain, f64):
        rel, floor = norm(k - p) / norm(p), norm(p - d) / norm(d)
        agree[name] = dict(rel_l2=rel, plain_vs_f64=floor,
                           kernel_vs_f64=norm(k - d) / norm(d))
        print(f"cg_vmem_solve {name}: kernel vs plain rel-L2 {rel:.3e} "
              f"(bound {max(VMEM_SOLVE_REL, 2 * floor):.3e}); plain float32 "
              f"vs float64 {floor:.3e}")
        require(rel <= max(VMEM_SOLVE_REL, 2 * floor), (name, rel, floor))

    A, sm, b = (t.clone().requires_grad_() for t in (A32, sm32, b32))
    times = {}
    for label, solve in (("ms", cuda_cg.cg_vmem_solve),
                         ("plain_ms", cuda_cg.cg_vmem_solve_reference)):
        f = lambda A, sm, b: solve(A, sm, b, x0, rtol, pcr=pcr, **kw)
        x = f(A, sm, b)
        times[("forward", label)] = cuda_ms(lambda: f(A, sm, b), 3)
        times[("backward", label)] = cuda_ms(lambda: torch.autograd.grad(
            x, (A, sm, b), g, retain_graph=True), 3)
        times[("jvp", label)] = cuda_ms(lambda: torch.func.jvp(
            f, (A32, sm32, b32), tangents), 3)
    n = nz * nr
    moved = nbytes(A32, sm32, b32, x0, pcr, b32)
    rows = {}
    for direction, k, p in (("forward", got[0], plain[0]),
                            ("backward", got[3], plain[3]),
                            ("jvp", got[4], plain[4])):
        # the jvp call solves the primal and the tangent system
        solves = iters[direction] + (iters["forward"] if direction == "jvp"
                                     else 0)
        rows[f"cg_vmem_solve.{direction}"] = dict(
            iters=iters[direction], max_abs_err=float((k - p).abs().max()),
            ms=times[(direction, "ms")],
            plain_ms=times[(direction, "plain_ms")],
            **bound(moved, solves * n * k1_iter_ops(True, False)))
        print(f"cg_vmem_solve.{direction}: {iters[direction]} iterations; "
              f"kernel {times[(direction, 'ms')]:.3f} ms, plain "
              f"{times[(direction, 'plain_ms')]:.3f} ms")
    out["vmem_solve_checks"] = dict(agree=agree, iters=iters, rows=rows)
    return rows


def fit_gradient_check(device, out: dict):
    """Phase 13b: one_config on the fit config, float32 through the cg_tol
    kernel against the plain float64 path (eager pcg_solve, r-line): the
    objective within FIT_RMSE_ABS, its gradient in (log k, log fwhm) within
    FIT_GRAD_REL and of the same sign. Returns a callable that evaluates
    the float32 objective and its gradient again (one start's Adam step)."""
    import math
    import torch
    from heatflow_tpu_torch.drivers.fit import experimental_objective

    problem = build_flagship(FIT_CFG)
    k0, f0 = 2.0 * float(problem.kappas[list(problem.mesh.material_tags)
                                        .index("p_sample")]), problem.fwhm
    res, objs = {}, {}
    for name, kw in (("kernel f32", dict(dtype=torch.float32)),
                     ("plain f64", dict(dtype=torch.float64, solver="xla",
                                        precondition="rline"))):
        obj = objs[name] = experimental_objective(problem, device=device,
                                                  **kw)
        p = torch.tensor([math.log(k0), math.log(f0)], dtype=kw["dtype"],
                         device=device, requires_grad=True)
        t0 = time.perf_counter()
        v = obj(torch.exp(p[0]), torch.exp(p[1]))
        v.backward()
        torch.cuda.synchronize()
        res[name] = (float(v.detach()), p.grad.double().cpu().numpy(),
                     time.perf_counter() - t0, obj.solver, obj.precondition)
        print(f"fit objective ({name}, {obj.solver}/{obj.precondition}): "
              f"RMSE {res[name][0]:.6f}, gradient in (log k, log fwhm) "
              f"{res[name][1].tolist()}, value and gradient in "
              f"{res[name][2]:.2f} s")
    (v32, g32, *_), (v64, g64, *_) = res["kernel f32"], res["plain f64"]
    rel = abs(g32 - g64) / abs(g64)
    print(f"fit objective: |dRMSE| {abs(v32 - v64):.3e} (bound "
          f"{FIT_RMSE_ABS}); gradient rel. difference {rel.tolist()} (bound "
          f"{FIT_GRAD_REL}, same sign)")
    require(abs(v32 - v64) < FIT_RMSE_ABS, ("fit RMSE", v32, v64))
    require((rel <= FIT_GRAD_REL).all() and (g32 * g64 > 0).all(),
            ("fit gradient", g32.tolist(), g64.tolist()))
    out["fit_gradient"] = {k: dict(rmse=v[0], grad=v[1].tolist(), s=v[2],
                                   solver=v[3], precondition=v[4])
                           for k, v in res.items()}

    def step():
        p = torch.tensor([math.log(k0), math.log(f0)], dtype=torch.float32,
                         device=device, requires_grad=True)
        objs["kernel f32"](torch.exp(p[0]), torch.exp(p[1])).backward()
    return step


def run_fit_cli(device, out: dict) -> list[dict]:
    """Phases 13c and 13d: the fit CLI at full width (default coarse grid,
    starts and Gauss-Newton), 5 Adam steps with the defaults and 2 with
    --precondition adi; the launch counts of each run read just after it."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.config import load_config, save_config
    from heatflow_tpu_torch.drivers import fit
    from heatflow_tpu_torch.ops import cuda_cg, cuda_sweep

    work = os.path.join(ROOT, "build", "chip_smoke")
    cfg = load_config(FIT_CFG)          # the heating file, from anywhere
    cfg["heating"]["file"] = CSV
    cfg_path = os.path.join(work, "fit.yaml")
    save_config(cfg, cfg_path)
    runs = []
    for name, extra in (("default", ["--adam-steps", "5"]),
                        ("adi", ["--precondition", "adi", "--adam-steps",
                                 "2"])):
        cuda_cg.reset_counters()
        cuda_sweep.reset_counters()
        t0 = time.perf_counter()
        res = fit.main(["--config", cfg_path, "--mesh-folder",
                        os.path.join(work, "fit_mesh"), "--rebuild-mesh",
                        "--device", str(device), *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = dict(forward=cuda_cg.cg_vmem_solve.launches_forward,
                  backward=cuda_cg.cg_vmem_solve.launches_backward,
                  jvp=cuda_cg.cg_vmem_solve.launches_jvp,
                  rline=cuda_cg.cg_tol.launches_rline,
                  adi=cuda_cg.cg_tol.launches_adi)
        k2 = _sweep_counts()
        vals = [res.k, res.fwhm, res.rmse, res.k_stderr, res.fwhm_stderr,
                res.corr]
        print(f"fit CLI ({name}): wall {wall:.2f} s = coarse "
              f"{res.timings['coarse_s']:.2f} s + Adam "
              f"{res.timings['adam_s']:.2f} s + Gauss-Newton "
              f"{res.timings['gauss_newton_s']:.2f} s + set-up; K1 launches "
              f"{k1}; K2 launches {k2}")
        require(np.isfinite(vals).all(), (name, "fit result", vals))
        require(k1["forward"] > 0 and k1["backward"] > 0 and k1["jvp"] > 0,
                (name, k1))
        require(k2["adi" if name == "adi" else "rline"] > 0, (name, k2))
        runs.append(dict(name=name, wall_s=wall, **res.timings, k=res.k,
                         fwhm=res.fwhm, rmse=res.rmse, k_stderr=res.k_stderr,
                         fwhm_stderr=res.fwhm_stderr, corr=res.corr,
                         k1_launches=k1, k2_launches=k2))
    out["fit_cli"] = runs
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this "
                                  "JSON file")
    ap.add_argument("--profile", help="profile one more run of the slice "
                                      "(and one of the B = 1024 sweep, of "
                                      "the B = 256 recording and ADI "
                                      "sweeps, and of one fit objective "
                                      "and gradient, tables in FILE_sweep, "
                                      "FILE_recording, FILE_adi and "
                                      "FILE_fit) and write its kernel "
                                      "table here")
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, ROOT)
    from heatflow_tpu_torch.ops import _build, cuda_cg

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    out = {"card": smi[0], "torch": torch.__version__}

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"kernel build + load: {build_s:.2f} s (nvcc "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    out["build_s"] = build_s

    t0 = time.perf_counter()
    problem = build_flagship()
    print(f"flagship setup (host): {time.perf_counter() - t0:.2f} s")
    rows = phase_checks(problem, device, out)
    fn = run_slice(problem, device, out)
    if args.profile:
        profile_run(fn, args.profile, out)

    t0 = time.perf_counter()
    sweep_problem = build_flagship(SWEEP_CFG)
    print(f"sweep setup (host): {time.perf_counter() - t0:.2f} s")
    sweep_rows = sweep_kernel_checks(sweep_problem, device, out)
    counts6, sweep = run_sweep(sweep_problem, device, out)
    if args.profile:
        base, ext = os.path.splitext(args.profile)
        profile_run(sweep, f"{base}_sweep{ext}", out, "sweep_profile")
    sweep_counts = [counts6] + [
        r["launches"] for r in run_sweep_forms(sweep_problem, device, out)]
    proj_rows = projection_checks(sweep_problem, device, out)
    counts9, recording = run_recording(sweep_problem, device, out)
    if args.profile:
        base, ext = os.path.splitext(args.profile)
        profile_run(recording, f"{base}_recording{ext}", out,
                    "recording_profile")
    rec_counts = [counts9, run_drivers(device, out)]

    adi_rows = adi_checks(sweep_problem, device, out)
    adi_counts, adi_sweep = run_adi_sweeps(sweep_problem, device, out)
    if args.profile:
        base, ext = os.path.splitext(args.profile)
        profile_run(adi_sweep, f"{base}_adi{ext}", out, "adi_profile")
    vmem_rows = vmem_solve_checks(problem, device, out)
    fit_step = fit_gradient_check(device, out)
    if args.profile:
        base, ext = os.path.splitext(args.profile)
        profile_run(fit_step, f"{base}_fit{ext}", out, "fit_profile")
    fit_runs = run_fit_cli(device, out)

    counts = out["slice"]["phase_launches"]
    solves = out["slice"]["solves"]
    kernel = lambda name, source, replaces, launches, r: dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None)
    kernels = [kernel(r["name"], SOURCE, REPLACES, counts[r["phase"]], r)
               for r in rows]
    for form in ("rline", "adi"):
        kernels.append(kernel(f"cg_tol[{form}]", SOURCE, REPLACES,
                              solves[form], out["solves"][form]))
    # K2 and K3: launches summed over phases 6 and 7 (K2's Kv-free form:
    # over phases 9 and 10; its ADI and adaptive forms and z-line phase:
    # over phases 12 and 13), each path's counts read just after it ran; a
    # phase row counts its phase kernel, a solve row its form's solves
    solve_key = {"cg_batched_tol[identity]": "identity",
                 "cg_batched_tol[rline]": "rline",
                 "cg_batched[fixed]": "fixed",
                 "cg_batched_tol[no_kv]": "no_kv",
                 "cg_batched_tol[adi]": "adi",
                 "cg_batched_tol[adaptive]": "adaptive"}
    adi_runs = adi_counts + [f["k2_launches"] for f in fit_runs]
    for name, r in (list(sweep_rows.items()) + list(proj_rows.items())
                    + list(adi_rows.items())):
        runs = (rec_counts if name.endswith("[no_kv]") else
                adi_runs if name in adi_rows else sweep_counts)
        n = sum(c["phases"][r["phase"]] if "phase" in r
                else c[solve_key[name]] for c in runs)
        kernels.append(kernel(
            name, SWEEP_SOURCE,
            K3_REPLACES if name == "cg_batched[fixed]" else K2_REPLACES, n,
            r))
    # K1's differentiable wrapper: its launches per direction over the two
    # fit CLI runs (phase 13c, d)
    for name, r in vmem_rows.items():
        direction = name.split(".")[1]
        kernels.append(kernel(name, SOURCE, REPLACES,
                              sum(f["k1_launches"][direction]
                                  for f in fit_runs), r))
    require(all(k["launches"] > 0 for k in kernels), kernels)
    out["wall_s"] = time.perf_counter() - t_script
    print(f"chip_smoke wall time: {out['wall_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(out, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
   nodes) compare the line factor kernels (``rline_pack``, ``zline_pack``)
   and each phase kernel of ``cg_tol`` with its plain PyTorch version, the
   phases on numpy-seeded inputs (the stencil with its alpha tail, the
   line-solve phases, the fused update-and-line-solve phases with their
   beta tail), then one full solve of the first step's refinement system
   in the identity, r-line and ADI forms, timing kernel and plain version
   with CUDA events, and one more of each under the profiler: each
   kernel's time in the solve, launches and us an iteration;
4. run the flagship transient (100 backward-Euler steps, the float32
   adaptive r-line/ADI recipe with one float64 refinement pass) through
   ``make_simulate_fn``, on the card one CUDA graph launch (the steps under
   a conditional WHILE node, the step kernels of ``csrc/step.cu`` around
   K1's recorded solve, the r-line/ADI switch set on the device): one
   warm-up run, then one timed run with the launch counters reset just
   before it (one r-line and one z-line factorization a run); check the
   traces against the float64 truth in
   ``benchmarks/.flagship_truth_f64.npz``; report the launches an
   iteration (at most 3 r-line, 4 ADI); run the eager loop
   (``forward_eager``) in the same process: the graph's outputs bitwise
   the eager loop's when its two refinement sums are taken in the step
   kernels' order (``cuda_step.kernel_order_sum``), and within the inner
   solves' rtol (traces), 2 % (iteration totals) and the same forms of the
   eager loop's own (torch.sum); hold each step kernel (prologue, float64
   residual with its tail, inner scale, epilogue) against its plain
   version on flagship planes (float64 with one and two carried passes,
   float32 with a source and recorded fields: planes bitwise, the tails'
   sums bitwise in the kernels' order and within 1e-12 of torch.sum's),
   with its device time in the graph; from one more run of each path
   under the profiler, the device's busy share, its idle time inside,
   between (0 host reads for the graph) and before the solves; and the
   host time of one eager step by part beside the graph path's;
5. at the sweep shape (``cfgs/geballe_no_diamond.yaml``, 243 x 1001
   nodes), on the 10th step's system of 8 numpy-seeded lanes spanning
   kappa in [1, 100] (one lane NaN, one at rtol 2), compare each phase
   kernel of the batched solve (K2/K3) alone with its plain version: the
   operator pass, update, r-line PCR, p update, compaction and finish
   kernels, and the kernels with their per-lane tails (the first
   residual with the first scalars, the stencil with alpha, the update
   with beta, the fused update and r-line PCR with beta, alone and with the
   z-line phase) on a state with done lanes; the tail kernels again at the
   batch sizes of the paths that run them (B = 1024, 256, 64; fields from a
   seeded generator on the card); then full solves in the identity and
   r-line forms and 120 fixed iterations (K3), timing kernel and plain
   version with CUDA events;
6. run the coefficient sweep (B = 1024, kappa = logspace(0, 2), the
   config's FWHM, 40 steps chunked 20 + 20, float32, Jacobi, rtol 1e-4 wrt
   ||b||) through ``run_sweep_time_chunked``: one warm-up run, one timed
   run with the counters reset just before it; hold four lanes to the
   same lanes run as a B = 4 sweep (bitwise), to the plain eager float32
   sweep's iteration total, and to its traces within 2x its distance from
   the plain float64 sweep of the same recipe, + 0.1 K; one more run under
   the profiler: the device's busy share, its idle time inside and between
   K2's solves (``idle_split``), and each K2 kernel's device time per
   lane-iteration. Wherever K2's counters are read after a path
   (``_sweep_counts``), each form's iteration must have taken its launches
   (3 identity, r-line, Kv-free and fixed; 4 ADI and adaptive; the same
   under the merged recurrence);
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
12. run two B = 64 sweeps of ``geballe_no_diamond`` (40 steps, float32):
   (a) 'adi', rtol 1e-5 wrt ||r0||, 'extrapolate'; (b) 'adaptive' with one
   float64 refinement pass; configs/s, finite lanes, the share of flagged
   lane-steps, four lanes again at B = 4 (bitwise); and the ADI sweep once
   more under the profiler, split as in phase 6;
13. (a) the differentiable ``cg_vmem_solve`` on the flagship's first-step
   system: value, backward (gradients to A, sm, b) and forward-mode
   tangent against its plain version on the card; (b) ``one_config`` on the
   fit config (``cfgs/geballe_no_diamond_read_flux.yaml``): the float32
   kernel objective and its gradient in (log k, log fwhm) against the
   plain float64 path; (c) the fit CLI at full width (the default coarse
   8 x 6 grid, 3 starts, Gauss-Newton; 5 Adam steps), with K1's launches
   per direction; (d) the same with ``--precondition adi`` and 2 Adam
   steps, so that K2's ADI form runs the coarse batch;
14. the transient's other solver forms. At the flagship shape, on the first
   step's system: each new phase kernel of ``cg_tol`` alone against its
   plain version (the merged-dot pass, its scalars and its p/q update; the
   Chebyshev polynomial in degrees 1, 3 and 4; the mgz cycle's fused
   passes: the pre-smoothing row with the CG update, the coarse row with
   the fine residual and its restriction on the even rows (the odd rows 0),
   a later coarse sweep with the coarse residual, the prolongation with the
   second residual, the post-smoothing row with the beta tail; and the
   whole V-cycle with 1 and 2 coarse sweeps, held to the plain version's
   own distance from float64); the V-cycle's symmetry; full solves in the
   Chebyshev (degree 3), merged (identity, r-line, ADI, Chebyshev) and mgz
   (1 and 2 sweeps) forms against their plain versions (counts, rel-L2, a
   NaN right-hand side poisoned) and against the standard r-line solve, the
   mgz solves with at most 5 / 6 launches an iteration read from the
   counters (``MGZ_LAUNCHES``). At the sweep shape, 8
   lanes (one NaN, one at rtol 2): K2's merged phase kernels and its merged
   solves (identity, r-line, ADI, adaptive) against their plain versions
   and the standard solves, adaptive lanes bitwise the static merged lanes;
15. this slice's path at full width: the flagship transient, 100 steps,
   through ``make_simulate_fn`` with (a) ``precondition='mgz'``, one
   float64 refinement pass, 'extrapolate', rtol 1e-4, for 1 and 2 coarse
   sweeps; (b) ``vmem_cheb_degree=3`` in float32 at rtol 1e-5 wrt r0, with
   the standard and the merged recurrence, beside the unrefined r-line run
   whose distance from the truth is their yardstick; (c) the adaptive
   recipe of phase 4 with ``MERGED_DEFAULT`` set to true around the run
   (standard, merged, merged, standard; a merged step that runs to
   ``maxiter`` is solved again by the standard kernel, the merged kernel
   and the plain merged version); each with steps/s, iterations a step,
   launches by form and the peak error against the float64 truth (<= 1.0 K
   for the refined runs). Then K2 with the merged recurrence: an adaptive
   refined sweep (B = 64) against the standard one and a recording sweep
   (B = 8, the Kv-free projection) against a tighter recording. Then the 2D
   CLI with ``--precondition mgz``, its ``watcher_points.csv`` bitwise
   equal to ``run_transient`` in-process;
16. ``precondition='mg'`` on the card through the eager path (flagship,
   float32, 1 step: an eager V-cycle of 7 levels takes ~12 s a step);
   ``solve_steady`` on the flagship problem with the heating line held at
   2000 K ('adi', float64) and its field as ``u0`` of a 10-step transient;
   the steady CLI (float32) against that solve;
17. the last two kernels and the 9-plane branch of the first two. On the
   flagship's multigrid hierarchy (4 levels: 251 x 1107, 127 x 555, 65 x 279,
   33 x 141): (a) ``cg_tol`` (identity, r-line, ADI) and ``cg_batched_tol``
   (8 lanes) on the 9-plane level-1 operator against their plain versions;
   (b) each phase kernel of the multigrid cycle alone on the flagship plane
   and on level 1 (the smoothing step; the CG update fused into level 0's
   first step; the residual fused into the restriction; the prolongation
   fused into the first post-smoothing step; a level's first two steps
   from zero in one pass), the coarsest level's right-hand side and
   smoothing in one launch, the whole V-cycle (both held to the plain
   float32 version's distance from the float64 cycle) and its symmetry;
   (c) ``mgcg_vmem_tol``
   on the first step's system at rtol 1e-3, 1e-5 and 1e-6 wrt r0 against
   the float64 solution (the plain r-line solve at rtol 1e-10) and, at
   1e-3 and 1e-5, its plain version (the 1e-6 solve, which has no plain
   run and no row in the kernels line, at least as many iterations as the
   1e-5 one and as close to float64 as its plain version), with
   iterations, ms a solve, us an iteration and launches an iteration read
   from the counters (at most 14, ``MG_LAUNCHES``); (d) ``cg_vmem`` (64
   iterations) on the baked
   flagship operator against its plain version, and the baked operator
   against the on-the-fly form;
18. the paths that run those kernels at full width: the first 10 steps of
   the flagship transient with every step's system (right-hand side, seed
   and float64 residual from the stepper) solved by ``mgcg_vmem_tol`` at
   rtol 1e-5 in float32, the traces within 1.0 K of the float64 truth,
   beside the r-line kernel on the same steps; 8 steps with every system
   solved by ``cg_vmem`` (1500 iterations on the baked operator) against
   the same steps through its plain version;
19. the 2D -> 1D pipeline through the CLIs: ``run2d`` on
   ``cfgs/geballe_no_diamond_read_flux.yaml`` with the gradient recorded,
   then ``run1d`` on ``cfgs/geballe_1d.yaml`` reading that run's
   ``radial_gradient.csv``, correction on and off, on the card and with
   ``--device cpu`` (float64, equal within 1e-8 rel-L2);
20. the unstructured path (ROADMAP P9) at full width, on the perturbed
   triangulations of ``benchmarks/bench_frontier.py:41-90``
   (``perturb_structured_mesh(..., jitter=0.25, seed=3)``; host set-up
   timed: generation, ``assemble_ell``, ``ell_to_stencils``): (a) the
   flagship's 277,857 nodes on their 9-plane lattice, 100 steps through
   ``make_simulate_fn_unstructured`` (float32 r-line, 'extrapolate', one
   float64 pass, rtol 1e-4 wrt r0, ``solver='auto'``, which must take the
   kernel path, one CUDA graph a transient): steps/s, iterations a step,
   K1's solves, launches and loop-body runs as the device counted them,
   the launches an iteration equal to the structured
   r-line form's, the traces within 1.0 K of
   ``benchmarks/.flagship_truth_unstructured.npz``; (b) the ADI form for 10
   steps against them; (c) the ELL eager path on the same mesh without its
   overlay, float64, Jacobi, rtol 1e-11, as many steps as fit in ~30 s,
   within 0.05 K of the truth's first rows; (d) on the sweep config's
   triangulation (243 x 1001): ``make_sweep_fn_unstructured(solver=
   'vmem')`` at B = 256 (Jacobi, rtol 1e-4 wrt ||b||; configs/s), four
   lanes bitwise at B = 4 and, solved to rtol 1e-5 wrt r0, against the
   single transient on the kernel path (K1 identity); the r-line recording
   at B = 64 (K2's r-line and Kv-free forms); ``fixed_iters`` at B = 8 (K3);
   (e) the CLIs on the card: ``run2d --mesh-style unstructured
   --rebuild-mesh``, ``run2d`` on that folder without its sidecar (the ELL
   path, 10 steps) and ``sweep --num-points 2 2 1`` over an unstructured
   width folder; (f) K1 (identity, r-line, ADI) on the flagship's
   first-step inner system (read off the eager step loop) and K2 (identity, r-line, Kv-free) and K3 on 8
   lanes of the sweep's 10th step, all 9-plane, against their plain
   versions and float64;
21. the analysis pipeline (ROADMAP P10) and the native set-up (P12) on
   phase 19's 2D run: (a) ``analyze_split_normal_fits`` ('rmse' and
   'maxerr') on the card against the same call on the CPU (the bounds of
   ``tests/test_torch_analysis_splitnormal.py``, ``fits_agree``), timed on
   each; (b) the full and amplitude-only fitted curves written as gradient
   CSVs and ``run1d`` on the card with each as ``--radial-gradient-path``
   (finite traces, their distance from phase 19's raw-gradient run);
   (c) the split-normal CLI (and, where matplotlib is installed, the
   radial CLI and a mesh plot) with every save flag, every file written;
   (d) ``assemble_stencils`` at the flagship and sweep shapes, 'native'
   (g++, host) against 'numpy', every plane within 1e-13 of its max abs;
22. multi-device execution (ROADMAP P11) over ``torch.distributed``, on the
   sweep config (243 x 1001, 40 steps), the CUDA library built before any
   rank starts: (a) ``run_sweep_multihost`` over 2 processes joined over
   tcp:// on localhost, gloo ranks sharing cuda:0: the B = 64 float32
   kernel sweep (drivers/sweep.py's recipe: K2 Jacobi, rtol 1e-4 wrt
   ||b||) and the B = 16 recording (K2 r-line with the Kv-free
   projection), the gathered results bitwise the single-process runs of
   the same B, each rank's K2 counters read just after its run; configs/s
   at 2 ranks beside one process (ranks sharing one card: sharing, not
   scaling); (b) ``make_simulate_fn(mesh=)`` over 3 gloo ranks on cuda:0
   (Nz = 243 = 3 x 81), float64, eager 'rline' (5 steps) and 'jacobi' (2
   steps) with the gradient recorded: watch and final_u within 1e-9 /
   1e-11 of the unsharded eager run on the card, band and axis (the
   projection's rows) within that or 2x the unsharded run's own distance
   when its CG dots are summed in another order (rows first); (c)
   ``run_sweep_multihost`` over NCCL in a world of one rank, bitwise the
   single-process sweep.
Phase 10 also holds its recording run (watch, band, axis), and the same
rows from a run with two float64 refinement passes, to
``benchmarks/.flagship_truth_recording.npz``.

The line before the last is a JSON object with one entry per kernel of the
paths (the step kernels' rows give their device time a launch inside
phase 4's graph run and its launches there, as does the r-line factor
kernel's row), each
with its time, the plain version's, and its bound: the larger of the bytes
it must move (each input read once, each output written once) at the
card's memory rate and the float32 operations this run's data needs at its
peak (the step kernels': float64, at 34 TFLOP/s); no single PyTorch call computes a preconditioned CG solve or a PCR
line solve, so ``library_ms`` is null. Each solve row of the ``--out``
file also carries ``iter_bound_ms``, the bound of its iterations: each
iteration's inputs (operator, scaling, stacks) read once and its carried
vectors read and written once, times the iterations. The last line is
``{"ok": true, "device": {...}}``.
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
FACTOR_REPLACES = "heatflow_tpu/ops/pallas_cg.py:668"   # its pcr_pack
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
ADI_B = 64
MERGED_B = 64      # phase 15's adaptive refined sweep, merged recurrence
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
# the bound of a kernel: H100 SXM HBM3 rate and float32 and float64 peaks
# outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
# the step kernels (csrc/step.cu), the counterparts of the XLA fusions of
# the JAX stepper's scan body (the lines they compute)
STEP_SOURCE = "heatflow_tpu_torch/csrc/step.cu"
STEP_REPLACES = {"step_prologue": "heatflow_tpu/sim/stepper.py:538",
                 "refine_residual": "heatflow_tpu/sim/stepper.py:475",
                 "refine_scale": "heatflow_tpu/sim/stepper.py:480",
                 "step_epilogue": "heatflow_tpu/sim/stepper.py:590"}
STEP_SCALAR_REL = 1e-12   # the tails' sums against torch.sum (order only)


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


def k1_iter_bound(its, operand_bytes: int, plane_bytes: int) -> float:
    """The bound of a K1 solve's iterations (ms): each iteration's inputs
    (the operator, the scaling, the PCR stacks or levels) read once and the
    three vectors it carries (x, r, p) read and written once, times the
    iterations, at the memory rate."""
    return float(its) * (operand_bytes + 6 * plane_bytes) \
        / HBM_BYTES_PER_S * 1e3


def k2_iter_bound(its, A0, Kv, sm, b) -> float:
    """The same for a batched K2 / K3 solve: the shared operator (A0, Kv;
    a shared scaling plane) read once an iteration of the batch, each
    running lane's scaling plane and carried x, r, p once a lane-iteration
    (``its``: each lane's iterations)."""
    import numpy as np
    its = np.nan_to_num(np.asarray(its, float))
    plane = b[0].numel() * b.element_size()
    shared = nbytes(A0, Kv) + (nbytes(sm) if sm.ndim == 2 else 0)
    lane = 6 * plane + (plane if sm.ndim == 3 else 0)
    return float(its.max() * shared + its.sum() * lane) \
        / HBM_BYTES_PER_S * 1e3


# phase 14: K5's launches an iteration, at most, by coarse sweeps
MGZ_LAUNCHES = {1: 5, 2: 6}
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


def line_factor_check(A32, s32, free32, out: dict, line: str) -> dict:
    """A line factor kernel (``k_rline_factor`` for ``line='r'``,
    ``k_zline_factor`` for 'z'; one launch an operand set) on the
    flagship's float32 operator against its plain version on the same
    inputs: each of its three planes within 1e-6 of the plane's largest
    value (the same float32 couplings and float64 sweep, each product and
    difference rounded alone). Its bound: the 7 planes it moves (A's two
    couplings along the line, s and the mask read, three factor planes
    written), and 5 float32 and 5 float64 operations a point."""
    from heatflow_tpu_torch.ops import cuda_cg
    name = f"{line}line_factor"
    pack = getattr(cuda_cg, f"{line}line_pack")
    reference = getattr(cuda_cg, f"{line}line_pack_reference")
    F_k, F_p = pack(A32, s32, free32), reference(A32, s32, free32)
    require(F_k.shape == F_p.shape == (3,) + tuple(s32.shape),
            (name, F_k.shape, F_p.shape))
    rels = [rel_max(a, b) for a, b in zip(F_k, F_p)]
    require(max(rels) <= 1e-6, (name, rels))
    n = s32.numel()
    t_b = 7 * nbytes(s32) / HBM_BYTES_PER_S * 1e3
    t_o = (5 * n / F32_OPS_PER_S + 5 * n / F64_OPS_PER_S) * 1e3
    row = dict(name=f"cg_tol.{name}", rel=max(rels), plane_rel=rels,
               max_abs_err=float((F_k - F_p).abs().max()),
               bound_ms=max(t_b, t_o),
               bound_by="bytes" if t_b >= t_o else "operations",
               ms=cuda_ms(lambda: pack(A32, s32, free32), 20),
               plain_ms=cuda_ms(lambda: reference(A32, s32, free32), 3))
    print(f"phase cg_tol.{name}: planes (m, 1/den, cp) rel "
          + ", ".join(f"{r:.3e}" for r in rels)
          + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms by {row['bound_by']}")
    out[name] = row
    return row


def phase_checks(problem, device, out: dict) -> list[dict]:
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.ops.stencil import apply_stencil

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    pcr = cuda_cg.rline_pack(A32, s32, free32)
    pcr_z = cuda_cg.zline_pack(A32, s32, free32)
    nz, nr = b32.shape
    print(f"flagship grid {nz} x {nr}; r-line factors {pcr.shape[0]} "
          f"planes, z-line factors {pcr_z.shape[0]} planes")
    for line in "rz":
        line_factor_check(A32, s32, free32, out, line)
    rng = np.random.default_rng(0)
    p = (torch.tensor(rng.standard_normal((nz, nr)), dtype=torch.float32,
                      device=device) * free32).contiguous()
    rows = []
    n = nz * nr

    # the direction p = z + beta p formed in the stencil pass, Ap and
    # <p, Ap>, with the alpha tail on a state record
    z = (torch.tensor(rng.standard_normal((nz, nr)), dtype=torch.float32,
                      device=device) * free32).contiguous()
    st0 = dict(rz=0.731, rr=0.5, stop2=1e-12, alpha=0.0, beta=0.37, k=3,
               done=0)
    pn_k, Ap_k, pap_k, st_k = cuda_cg.stencil_dot_p(A32, sm32, z, p, st0)
    pn_p, Ap_p, pap_p = cuda_cg.stencil_dot_p_reference(A32, sm32, z, p,
                                                        0.37, False)
    st_p = cuda_cg.finalize_reference(st0, "alpha", pap=pap_p)
    err = float((Ap_k - Ap_p).abs().max())
    rel = max(rel_max(Ap_k, Ap_p), rel_max(pn_k, pn_p))
    dot_rel = abs(float(pap_k - pap_p)) / abs(float(pap_p))
    alpha_rel = abs(st_k["alpha"] - st_p["alpha"]) / abs(st_p["alpha"])
    require(rel <= 1e-5 and dot_rel <= 1e-5 and alpha_rel <= 1e-5
            and st_k["k"] == st_p["k"] and st_k["rz"] == st_p["rz"],
            ("stencil_dot", rel, dot_rel, st_k, st_p))
    rows.append(dict(name="cg_tol.stencil_dot", phase="stencil_dot",
                     **bound(nbytes(A32, sm32, z, p, p, p) + 8, 19 * n),
                     max_abs_err=err, rel=rel, dot_rel=dot_rel,
                     alpha_rel=alpha_rel,
                     ms=cuda_ms(lambda: cuda_cg.stencil_dot(A32, sm32, p),
                                50),
                     plain_ms=cuda_ms(
                         lambda: cuda_cg.stencil_dot_reference(A32, sm32, p),
                         50)))

    # the r-line solve, then the z-line solve with the ADI combine
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

    # the fused iteration phases: x += alpha p, r -= alpha Ap, z = M^-1 r
    # with the partials and the beta tail (the r-line row kernel; for ADI
    # the row kernel and the z-line kernel), as a solve launches them
    x = (torch.tensor(rng.standard_normal((nz, nr)), dtype=torch.float32,
                      device=device) * free32).contiguous()
    Ap = cuda_cg.stencil_dot_reference(A32, sm32, p)[0].contiguous()
    st1 = dict(rz=0.731, rr=0.5, stop2=1e-12, alpha=0.0137, beta=0.0, k=3,
               done=0)
    for name, phase, zst in (("cg_tol.update_pcr_r", "update_pcr_r", None),
                             ("cg_tol.update_pcr_adi", "pcr_z", pcr_z)):
        args = (x, b32, p, Ap, sm32, pcr, zst)

        def plain():
            out = cuda_cg.update_precond_reference(*args[:4], st1["alpha"],
                                                   *args[4:])
            return out + (cuda_cg.finalize_reference(
                st1, "beta", rr=out[3], rz=out[4]),)
        out_k = cuda_cg.update_precond(*args, state=st1)
        out_p = plain()
        fields = [rel_max(a, b) for a, b in zip(out_k[:3], out_p[:3])]
        sums = [abs(float(a) - float(b)) / abs(float(b))
                for a, b in zip(out_k[3:5], out_p[3:5])]
        st_k, st_p = out_k[5], out_p[5]
        beta_rel = abs(st_k["beta"] - st_p["beta"]) / abs(st_p["beta"])
        rel = max(fields)
        require(rel <= 1e-4 and max(sums) <= 1e-5 and beta_rel <= 1e-5
                and st_k["k"] == st_p["k"] == 4 and st_k["done"] == 0,
                (name, fields, sums, st_k, st_p))
        rows.append(dict(
            name=name, phase=phase, rel=rel, dot_rel=max(sums),
            beta_rel=beta_rel,
            max_abs_err=max(float((a - b).abs().max())
                            for a, b in zip(out_k[:3], out_p[:3])),
            **bound(nbytes(x, b32, p, Ap, sm32, pcr, zst, x, b32, b32) + 16,
                    n * (6 + (LINE_SOLVE_OPS + 4)
                         * (1 if zst is None else 2))),
            ms=cuda_ms(lambda: cuda_cg.update_precond(*args, state=st1),
                       50),
            plain_ms=cuda_ms(plain, 20)))

    for row in rows:
        print(f"phase {row['name']}: max|err| {row['max_abs_err']:.3e} "
              f"(rel {row['rel']:.3e}, dot rel {row['dot_rel']:.3e}), "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")
    large_shape_checks(device, out)

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
                            ms=ms, plain_ms=plain_ms,
                            iter_bound_ms=k1_iter_bound(
                                it_k, nbytes(A32, sm32, *stacks.values()),
                                nbytes(b32)))
        print(f"solve {form}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        # in-solve: one more solve under the profiler, by kernel. The loop
        # body launches k_stencil_dot once an iteration: a profile holding
        # fewer missed the graph's body (the profiler does, now and then)
        # and is taken again, at most twice; past that the in-solve times
        # are not measured (None), and no check reads them
        for attempt in range(1, 4):
            prof = kernel_profile(
                lambda: cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw))
            k1 = k1_kernels(prof)
            seen = k1.get("k_stencil_dot", (0.0, 0))[1]
            if seen >= it_k:
                break
            print(f"solve {form} in-solve: the profile holds {seen} of "
                  f"{it_k} k_stencil_dot launches (attempt {attempt} of 3)")
        launched = sum(c for name, (_, c) in k1.items()
                       if name not in ("k_init", "k_finish"))
        traced = seen >= it_k
        solves[form].update(
            in_solve_us={name: us / c for name, (us, c) in k1.items()}
            if traced else None,
            in_solve_calls={name: c for name, (_, c) in k1.items()},
            us_per_iter=prof["span_us"] / it_k,
            launches_per_iter=launched / it_k,
            busy_pct=100 * prof["busy_us"] / prof["span_us"])
        if not traced:
            print(f"solve {form} in-solve: not measured (the profiler saw "
                  f"no full loop body)")
            continue
        print(f"solve {form} in-solve: {prof['span_us'] / it_k:.2f} us an "
              f"iteration, {launched / it_k:.3f} launches an iteration "
              f"(with the no-op tail of the last block), device busy "
              f"{solves[form]['busy_pct']:.2f}% of the solve; "
              + ", ".join(f"{name} {us / c:.2f} us x {c}"
                          for name, (us, c) in sorted(k1.items())))
    # the phase rows' in-solve times: their kernels in the r-line and ADI
    # solves (the ADI row: its row kernel and its z-line kernel)
    in_solve = {"cg_tol.stencil_dot": ("rline", "k_stencil_dot"),
                "cg_tol.pcr_r": ("rline", "k_row_plain"),
                "cg_tol.pcr_z_adi": ("adi", "k_zline"),
                "cg_tol.update_pcr_r": ("rline", "k_row_update"),
                "cg_tol.update_pcr_adi": ("adi", "k_row_update", "k_zline")}
    for row in rows:
        form, *names = in_solve[row["name"]]
        us = solves[form]["in_solve_us"]
        row["in_solve_ms"] = (None if us is None
                              else sum(us[n] for n in names) / 1e3)
        print(f"phase {row['name']}: in-solve "
              + ("not measured" if us is None
                 else f"{row['in_solve_ms']:.4f} ms")
              + f" (bound {row['bound_ms']:.4f} ms)")
    stats = cuda_cg.graph_stats()
    print("graphs: " + ", ".join(
        f"{form} {v['launches_per_iteration']:.3f} launches an iteration, "
        f"capture + instantiation {v['capture_s'] * 1e3:.3f} ms"
        for form, v in sorted(stats.items())))
    out["graph_stats"] = stats
    out["solves"] = solves
    out["phases"] = rows
    return rows


def large_shape_checks(device, out: dict, nz: int = 300, nr: int = 12288):
    """The line kernels' paths for shapes past the flagship's: a row whose
    Thomas factors do not fit shared memory (read from device memory) and
    z-lines taller than the flagship's (300 rows: 11 a lane of ``k_zline``,
    in two pieces), on a numpy-seeded anisotropic 5-point operator: the PCR phases, the
    fused phase with its beta tail and an ADI solve against their plain
    versions."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    rng = np.random.default_rng(3)
    az = torch.tensor(rng.uniform(0.5, 1.5, (nz - 1, nr)))
    ar = torch.tensor(rng.uniform(0.5, 1.5, (nz, nr - 1))) * 20.0
    A = torch.zeros((7, nz, nr), dtype=torch.float64)
    A[1, :-1], A[2, 1:] = -az, -az
    A[3, :, :-1], A[4, :, 1:] = -ar, -ar
    A[0] = -A[1:5].sum(dim=0) + 0.1
    free = torch.ones((nz, nr), dtype=torch.float64)
    free[0] = 0.0
    s = torch.rsqrt(A[0]) * free + (1.0 - free)
    f32 = lambda t: t.float().to(device).contiguous()
    A32, sm32, s32, free32 = f32(A), f32(s * free), f32(s), f32(free)
    pcr = cuda_cg.rline_pack(A32, s32, free32)
    pcr_z = cuda_cg.zline_pack(A32, s32, free32)
    field = lambda: f32(torch.tensor(rng.standard_normal((nz, nr))) * free)
    r, x, p = field(), field(), field()
    z_k, rz_k = cuda_cg.precond(sm32, r, pcr, pcr_z)
    z_p, rz_p = cuda_cg.precond_reference(sm32, r, pcr, pcr_z)
    res = dict(precond_rel=rel_max(z_k, z_p),
               precond_dot_rel=abs(float(rz_k - rz_p)) / abs(float(rz_p)))
    Ap = cuda_cg.stencil_dot_reference(A32, sm32, p)[0].contiguous()
    st = dict(rz=1.0, rr=1.0, stop2=1e-12, alpha=0.021, beta=0.0, k=0,
              done=0)
    out_k = cuda_cg.update_precond(x, r, p, Ap, sm32, pcr, pcr_z, state=st)
    out_p = cuda_cg.update_precond_reference(x, r, p, Ap, st["alpha"], sm32,
                                             pcr, pcr_z)
    st_p = cuda_cg.finalize_reference(st, "beta", rr=out_p[3], rz=out_p[4])
    res.update(fused_rel=max(rel_max(a, b) for a, b in zip(out_k[:3],
                                                           out_p[:3])),
               beta_rel=abs(out_k[5]["beta"] - st_p["beta"])
               / abs(st_p["beta"]))
    b32 = field()
    x0 = torch.zeros_like(b32)
    kw = dict(maxiter=2000, rtol_wrt="b", pcr=pcr, pcr_z=pcr_z)
    x_k, it_k = cuda_cg.cg_tol(A32, sm32, b32, x0, 1e-5, **kw)
    x_p, it_p = cuda_cg.cg_tol_reference(A32, sm32, b32, x0, 1e-5, **kw)
    it_k, it_p = int(it_k), int(it_p)
    res.update(adi_iters=it_k, adi_plain_iters=it_p,
               adi_rel_l2=float(torch.linalg.vector_norm((x_k - x_p).double())
                                / torch.linalg.vector_norm(x_p.double())))
    print(f"large shape {nz} x {nr} (row factors read from device memory, "
          f"z-lines of {nz} rows): {res}")
    require(res["precond_rel"] <= 1e-4 and res["precond_dot_rel"] <= 1e-5
            and res["fused_rel"] <= 1e-4 and res["beta_rel"] <= 1e-5
            and out_k[5]["k"] == 1, ("large shape", res))
    require(abs(it_k - it_p) <= max(3, int(0.05 * it_p))
            and res["adi_rel_l2"] <= 1e-3, ("large shape ADI", res))
    out["large_shape"] = res


def adaptive_forms(iters, thresh: int, maxiter: int) -> list[int]:
    """The form each step of an adaptive run took (1: ADI), from its
    iteration counts: ADI after a step deeper than the threshold, the
    first step counting as ``maxiter``."""
    prev = [maxiter] + [int(i) for i in iters[:-1]]
    return [int(p > thresh) for p in prev]


def eager_step_host_times(fn, steps: int = 20) -> dict:
    """Host microseconds of one eager step of the phase-4 recipe, by part,
    over the first ``steps`` steps of the flagship: the prologue (the step's
    right-hand side, seed, float64 residual and scale: eager launches), the
    K1 wrapper (its checks, copies in and out and the graph launch), the
    epilogue (the field update and the watcher gather) and the read of the
    iteration count (it waits for the solve to end)."""
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.ops.cuda_step import (refine_residual_reference,
                                                  refine_scale_reference,
                                                  step_epilogue_reference,
                                                  step_prologue_reference)
    from heatflow_tpu_torch.ops.stencil import apply_stencil
    o = fn.opts
    d, kp, rc, fw, ic, u0, t0, _ = fn._inputs(None, None, None, None, 0.0,
                                              None)
    A, M_op, s, g0, g1, Ag0, Ag1, b_src, _, amps = fn._operands(
        d, kp, rc, fw, ic, t0, None)
    free = d["free"]
    As, sm, pcr, pcr_z = fn._solve_operands(A, s, free)
    parts = dict(prologue=0.0, wrapper=0.0, epilogue=0.0, read=0.0)
    u_prev = u_pp = u_ppp = u0
    it_prev = o["maxiter"]
    torch.cuda.synchronize()
    for n in range(steps):
        t_a = time.perf_counter()
        b_lift, y0 = step_prologue_reference(
            apply_stencil, M_op, u_prev, u_pp, u_ppp, b_src, Ag0, Ag1,
            amps[n], s, free, o["warm_start"])
        bt = b_lift * free
        floor2 = 1e-30 * torch.sum(bt * bt)
        y, r64, rnorm, rtol_eff = refine_residual_reference(
            apply_stencil, A, s, free, bt, y0, floor2, o["rtol"],
            torch.float32)
        r32, seed = refine_scale_reference(r64, rnorm, rtol_eff,
                                           torch.float32)
        t_b = time.perf_counter()
        dy, its = cuda_cg.cg_tol(
            As, sm, r32, seed, rtol_eff, rtol_wrt="b", pcr=pcr,
            pcr_z=pcr_z if it_prev > o["adaptive_thresh"] else None,
            maxiter=o["maxiter"])
        t_c = time.perf_counter()
        u = step_epilogue_reference(y, s, free, g0, g1, amps[n], dy, rnorm)
        u.reshape(-1)[d["watch_flat"]]
        t_d = time.perf_counter()
        it_prev = int(its)
        t_e = time.perf_counter()
        u_ppp, u_pp, u_prev = u_pp, u_prev, u
        for k, dt_ in (("prologue", t_b - t_a), ("wrapper", t_c - t_b),
                       ("epilogue", t_d - t_c), ("read", t_e - t_d)):
            parts[k] += dt_
    return {k: 1e6 * v / steps for k, v in parts.items()}


def step_workspace(fn, source=None):
    """The graph path's step workspace of ``fn`` with the default call's
    operands loaded (nothing run)."""
    ws, _ = fn._step_workspace(*fn._inputs(None, None, None, None, 0.0,
                                           source))
    return ws


def step_case(ws, n: int, timed: bool = False) -> dict:
    """Each step kernel once on the workspace ``ws`` at step ``n`` against
    its plain version on the same inputs: the planes bitwise, the tails'
    scalars (rnorm, the <bt, bt> and <r64, r64> sums) bitwise when the
    plain version sums in the kernels' order and within
    ``STEP_SCALAR_REL`` of torch.sum's. With ``timed``: each wrapper's and
    plain version's
    time by CUDA events and its bound. Returns rows by kernel name."""
    import torch
    from heatflow_tpu_torch.ops import cuda_step as cs
    from heatflow_tpu_torch.ops.stencil import apply_stencil
    f32 = torch.float32
    ints = ws.state.view(torch.int32)
    ints[0], ints[1] = n, 80
    torch.cuda.synchronize()
    N = ws.nz * ws.nr
    nb = (N + 255) // 256
    rows: dict = {}

    def row(name, err, kernel_fn, plain_fn, reads, writes, ops_pt):
        r = dict(name=name, max_abs_err=float(err))
        if timed:
            r["wrapper_ms"] = cuda_ms(kernel_fn, 50)
            r["plain_ms"] = cuda_ms(plain_fn, 20)
            by = nbytes(*reads) + nbytes(*writes)
            t_b, t_o = by / HBM_BYTES_PER_S * 1e3, \
                ops_pt * N / F64_OPS_PER_S * 1e3
            r.update(bound_ms=max(t_b, t_o),
                     bound_by="bytes" if t_b >= t_o else "operations",
                     bytes=by)
        rows[name] = r

    ring = [ws.ring[(n + k) % 3] for k in (2, 1, 0)]
    order = cs.WARM_ORDER[ws.warm_start]
    src = 0.0 if ws.src is None else ws.src
    plain_pro = lambda: cs.step_prologue_reference(
        apply_stencil, ws.Mop, *ring, src, ws.Ag0, ws.Ag1, ws.amps[n], ws.s,
        ws.free, ws.warm_start)
    cs.step_prologue(ws)
    b_lift, y0 = plain_pro()
    bt = b_lift * ws.free
    torch.cuda.synchronize()
    require(torch.equal(ws.bt, bt.to(ws.bt.dtype))
            and torch.equal(ws.y[0], y0.to(ws.y.dtype)),
            ("step_prologue planes", n))
    err = 0.0
    if ws.refine:
        want = torch.sum(bt * bt)
        err = rel_max(ws.part_bt[:nb].sum(), want)
        require(err <= STEP_SCALAR_REL, ("step_prologue <bt, bt>", err))
    row("step_prologue", err, lambda: cs.step_prologue(ws), plain_pro,
        [ws.Mop, *ring[:1 + min(order, 2)], ws.Ag0, ws.Ag1, ws.s, ws.free,
         None if ws.src is None else ws.src], [ws.bt, ws.y[0]],
        2 * ws.npts + 14)
    for p in range(ws.passes if ws.refine else 0):
        floor2 = 1e-30 * torch.sum(ws.bt * ws.bt)
        dy = ws.dx[p - 1] if p else None
        rn = ws.state[3 + p - 1].clone() if p else None
        y_in = ws.y[0].clone()
        plain_res = lambda: cs.refine_residual_reference(
            apply_stencil, ws.A, ws.s, ws.free, ws.bt, y_in, floor2, ws.rtol,
            f32, dy, rn)
        cs.refine_residual(ws, p)
        y, r64, rnorm, rtol_eff = plain_res()
        torch.cuda.synchronize()
        require(torch.equal(ws.r64, r64)
                and (p == 0 or torch.equal(ws.y[p], y))
                and torch.equal(ws.rtol32, rtol_eff),
                ("refine_residual planes", n, p))
        err = rel_max(ws.state[3 + p], rnorm)
        require(err <= STEP_SCALAR_REL, ("refine_residual rnorm", p, err))
        # in the kernels' own summation order: bitwise
        k_floor2 = 1e-30 * cs.kernel_order_sum(ws.bt * ws.bt)
        _, _, k_rnorm, k_rtol = cs.refine_residual_reference(
            apply_stencil, ws.A, ws.s, ws.free, ws.bt, y_in, k_floor2,
            ws.rtol, f32, dy, rn, cs.kernel_order_sum)
        require(torch.equal(ws.state[3 + p], k_rnorm)
                and torch.equal(ws.state[2], k_floor2)
                and torch.equal(ws.rtol32, k_rtol),
                ("refine_residual tail against the kernels' order", p))
        if p == 0:
            row("refine_residual", err, lambda: cs.refine_residual(ws, 0),
                plain_res, [ws.A, ws.s, ws.free, ws.bt, ws.y[0]], [ws.r64],
                3 * ws.npts + 6)
        rn_p = ws.state[3 + p].clone()
        carried = ws.dx[p].clone() if ws.carry else None
        plain_sc = lambda: cs.refine_scale_reference(
            ws.r64, rn_p, ws.rtol32, f32, carried)
        cs.refine_scale(ws, p)
        r32, seed = plain_sc()
        torch.cuda.synchronize()
        require(torch.equal(ws.b32, r32) and torch.equal(ws.x0, seed),
                ("refine_scale planes", n, p))
        if p == 0:
            row("refine_scale", 0.0, lambda: cs.refine_scale(ws, 0),
                plain_sc, [ws.r64, carried], [ws.b32, ws.x0], 2)
    last = ws.passes - 1
    x = (ws.y[last] if ws.refine else ws.dx[0]).clone()
    dy = ws.dx[last] if ws.refine else None
    rn = ws.state[3 + last].clone() if ws.refine else None
    plain_epi = lambda: cs.step_epilogue_reference(
        x, ws.s, ws.free, ws.g0, ws.g1, ws.amps[n], dy, rn)
    ws.iters.copy_(torch.arange(40, 40 + ws.passes, dtype=torch.int32))
    cs.step_epilogue(ws)
    u = plain_epi()
    torch.cuda.synchronize()
    require(torch.equal(ws.ring[n % 3], u)
            and (ws.watch is None or torch.equal(
                ws.watch[n], u.reshape(-1)[ws.watch_flat]))
            and (ws.fields is None or torch.equal(ws.fields[n], u))
            and int(ws.cg_iters[n]) == int(ws.iters.sum())
            and int(ints[0]) == n + 1 and int(ints[1]) == int(ws.iters.sum()),
            ("step_epilogue", n))
    # timed from step 10: each launch advances the step (51 launches)
    ints[0] = 10
    row("step_epilogue", 0.0, lambda: cs.step_epilogue(ws), plain_epi,
        [x, dy, ws.s, ws.free, ws.g0, ws.g1],
        [ws.ring[0], None if ws.fields is None else ws.fields[0]], 11)
    return rows


def step_kernel_checks(problem, fn, device, out: dict) -> dict:
    """Phase 4a: the step kernels (csrc/step.cu) against their plain
    versions on flagship planes: the phase-4 recipe's workspace (float64
    planes, one refinement pass, 'extrapolate') at step 50 of a finished run
    (its ring and corrections), timed; two carried refinement passes with
    'extrapolate2'; the float32 r-line form with a volumetric source and
    recorded fields."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    ws = fn._workspaces[next(iter(fn._workspaces))]
    rows = step_case(ws, 50, timed=True)
    two = make_simulate_fn(problem, dtype=torch.float32, device=device,
                           **dict(RECIPE, f64_refine=2, inner_seed="carry",
                                  warm_start="extrapolate2"))
    ws2 = step_workspace(two)
    ws2.ring.copy_(ws.ring)
    ws2.dx.copy_(torch.stack([ws.dx[0], 0.5 * ws.dx[0]]))
    step_case(ws2, 50)
    one = make_simulate_fn(problem, dtype=torch.float32, device=device,
                           **dict(RECIPE, precondition="rline",
                                  f64_refine=0, warm_start="previous",
                                  record_fields=True))
    rng = np.random.default_rng(4)
    ws3 = step_workspace(one, source=rng.uniform(0, 1e12,
                                                 problem.mesh.shape))
    ws3.ring.copy_(ws.ring)
    ws3.dx[0].copy_(ws.dx[0])
    step_case(ws3, 50)
    out["step_kernels"] = rows
    return rows


def run_slice(problem, device, out: dict):
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_step
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn

    t_phase = time.perf_counter()
    fn = make_simulate_fn(problem, dtype=torch.float32, device=device,
                          **RECIPE)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cuda_cg.reset_counters()
    cuda_step.reset_counters()
    t0 = time.perf_counter()
    ys = fn()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = cuda_cg.phase_launches()
    factor_launches = cuda_cg.rline_pack.launches
    zfactor_launches = cuda_cg.zline_pack.launches
    solves = dict(total=cuda_cg.cg_tol.launches,
                  rline=cuda_cg.cg_tol.launches_rline,
                  adi=cuda_cg.cg_tol.launches_adi,
                  identity=cuda_cg.cg_tol.launches_identity)
    step_launches = {f.__name__: f.launches for f in (
        cuda_step.step_prologue, cuda_step.refine_residual,
        cuda_step.refine_scale, cuda_step.step_epilogue)}
    watch = ys["watch"].cpu().numpy()
    iters = ys["cg_iters"].cpu().numpy()
    require(np.isfinite(watch).all()
            and np.isfinite(ys["final_u"].cpu().numpy()).all(),
            "non-finite traces")
    require(solves["rline"] > 0 and solves["adi"] >= 1, solves)
    # the line factors: one factorization each a transient
    require(factor_launches == 1, ("rline_pack launches", factor_launches))
    require(zfactor_launches == 1, ("zline_pack launches", zfactor_launches))
    thresh, maxiter = fn.opts["adaptive_thresh"], RECIPE["maxiter"]
    forms = adaptive_forms(iters, thresh, maxiter)
    require(solves["adi"] == sum(forms)
            and solves["rline"] == len(forms) - sum(forms),
            ("device-counted forms against the counts", solves, forms))
    truth = np.load(TRUTH)["watch"]
    require(watch.shape == truth.shape, (watch.shape, truth.shape))
    peak = np.abs(watch - truth).max(axis=0)
    names = list(problem.watcher_names)
    steps_per_s = problem.num_steps / run_s
    print(f"slice: {problem.num_steps} steps as one CUDA graph launch in "
          f"{run_s:.4f} s = {steps_per_s:.2f} steps/s (warm-up run with the "
          f"capture {warm_s:.2f} s); cg_iters mean {iters.mean():.2f} max "
          f"{int(iters.max())}; ADI steps {solves['adi']}, r-line steps "
          f"{solves['rline']}; step kernels {step_launches}")
    print("slice peak |error| vs f64 truth [K]: "
          + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, peak)))
    print(f"slice phase launches: {counts}")
    # launches an iteration: as the graphs' loop bodies hold them, and all
    # K1 launches of the run (starts, finishes and the no-op tail of each
    # solve's last block of CHECK_EVERY included) over its iterations
    stats = cuda_cg.graph_stats()
    per_iter = {f: stats[f]["launches_per_iteration"]
                for f in ("rline", "adi") if f in stats}
    launched = sum(counts.values())
    print(f"slice: launches an iteration {per_iter} (graph bodies); "
          f"{launched} K1 launches over {int(iters.sum())} iterations = "
          f"{launched / iters.sum():.3f} an iteration")

    # the eager loop (the graph's plain version, K1 through its wrapper, the
    # host reading each step's count) in the same process; once more with
    # the refinement's two sums in the step kernels' order, which must give
    # the graph's outputs bitwise
    fn.forward_eager()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ye = fn.forward_eager()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    yk = fn.forward_eager(inner_sum=cuda_step.kernel_order_sum)
    same = {k: torch.equal(ys[k], yk[k]) for k in ys if k != "times"}
    we, ie = ye["watch"].cpu().numpy(), ye["cg_iters"].cpu().numpy()
    trace_rel = float(np.abs(watch - we).max() / np.abs(we).max())
    dit = np.abs(iters.astype(int) - ie.astype(int))
    total_rel = abs(int(iters.sum()) - int(ie.sum())) / int(ie.sum())
    forms_e = adaptive_forms(ie, thresh, maxiter)
    prev_g = np.array([maxiter] + list(iters[:-1]))
    prev_e = np.array([maxiter] + list(ie[:-1]))
    near = (np.abs(prev_g - thresh) <= 2) | (np.abs(prev_e - thresh) <= 2)
    form_diff = [i for i, (a, b) in enumerate(zip(forms, forms_e))
                 if a != b]
    print(f"slice eager loop: {problem.num_steps} steps in {eager_s:.4f} s "
          f"= {problem.num_steps / eager_s:.2f} steps/s; graph against the "
          f"eager loop with its sums in the kernels' order: {same} "
          f"(bitwise); against the eager loop (torch.sum): traces rel "
          f"{trace_rel:.3e}, iterations differ by at most {int(dit.max())} "
          f"a step (steps {np.nonzero(dit)[0].tolist()}), totals "
          f"{int(iters.sum())} / {int(ie.sum())}, forms differ at steps "
          f"{form_diff} (near the threshold: "
          f"{[i for i in form_diff if near[i]]})", flush=True)
    step_rows = step_kernel_checks(problem, fn, device, out)

    # one more run of each under the profiler: the device's busy share and
    # where the idle time lies
    prof = kernel_profile(fn)
    split = idle_split(prof)
    busy_pct = 100 * prof["busy_us"] / prof["span_us"]
    prof_e = kernel_profile(fn.forward_eager)
    split_e = idle_split(prof_e)
    busy_e = 100 * prof_e["busy_us"] / prof_e["span_us"]
    # the step kernels' time: in the graph, device time a launch
    k1 = k1_kernels(prof)
    for name, r in step_rows.items():
        us, calls = [sum(v[i] for k, v in k1.items()
                         if k.split("<")[0] == "k_" + name) for i in (0, 1)]
        require(calls > 0, ("no in-graph launch of", name))
        r["ms"] = us / calls / 1e3
        print(f"4a {name}: planes bitwise the plain version's in float64 "
              f"(1 and 2 passes) and float32, the tails' sums bitwise in "
              f"the kernels' order (rel {r['max_abs_err']:.3e} from "
              f"torch.sum); in the graph {r['ms'] * 1e3:.2f} us a launch "
              f"({calls} launches seen by the profiler, "
              f"{step_launches[name]} counted by the device in the timed "
              f"run; the wrapper alone "
              f"{r['wrapper_ms'] * 1e3:.2f} us), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}",
              flush=True)
    for label, pr, sp, bp in (("graph", prof, split, busy_pct),
                              ("eager", prof_e, split_e, busy_e)):
        print(f"slice profiled run ({label}): device busy {bp:.2f}% of a "
              f"{pr['span_us'] / 1e3:.3f} ms span; {sp['solves']} solves "
              f"span {sp['solve_span_us'] / 1e3:.3f} ms "
              f"({sp['solve_busy_us'] / 1e3:.3f} ms of kernels, idle "
              f"{sp['idle_in_solves_us'] / 1e3:.3f} ms between launches and "
              f"{sp['idle_after_host_reads_us'] / 1e3:.3f} ms after "
              f"{sp['host_reads']} host reads); idle between solves "
              f"{sp['idle_between_solves_us'] / 1e3:.3f} ms (before the "
              f"first {sp['idle_before_first_solve_us'] / 1e3:.3f} ms), "
              f"{sp['host_reads_between_solves']} host reads between "
              f"solves", flush=True)
    host = eager_step_host_times(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ws = step_workspace(fn)
    t1 = time.perf_counter()
    g = cuda_step.launch(ws)
    t2 = time.perf_counter()
    cuda_step.count_launches(ws, g)
    t3 = time.perf_counter()
    graph_host = dict(load_us=1e6 * (t1 - t0), launch_us=1e6 * (t2 - t1),
                      wait_us=1e6 * (t3 - t2),
                      per_step_us=1e6 * (t2 - t0) / problem.num_steps)
    print(f"slice host time of one eager step (us, mean of the first 20): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + f"; graph path: the run's operands in (eager, once a run) "
          f"{graph_host['load_us']:.1f}, the launch "
          f"{graph_host['launch_us']:.1f} ({graph_host['per_step_us']:.2f} "
          f"a step for both), then the host waits "
          f"{graph_host['wait_us'] / 1e3:.3f} ms for the run", flush=True)
    out["slice"] = dict(steps=problem.num_steps, run_s=run_s,
                        warm_run_s=warm_s, steps_per_s=steps_per_s,
                        cg_iters=iters.tolist(), solves=solves,
                        phase_launches=counts, step_launches=step_launches,
                        rline_factor_launches=factor_launches,
                        zline_factor_launches=zfactor_launches,
                        launches_per_iteration=per_iter,
                        launches_per_run_iteration=launched / iters.sum(),
                        device_busy_pct=busy_pct, idle_split=split,
                        span_ms=prof["span_us"] / 1e3,
                        peak_err_K=dict(zip(names, peak.tolist())),
                        eager=dict(run_s=eager_s,
                                   steps_per_s=problem.num_steps / eager_s,
                                   cg_iters=ie.tolist(),
                                   device_busy_pct=busy_e,
                                   span_ms=prof_e["span_us"] / 1e3,
                                   idle_split=split_e, host_us=host),
                        graph_host=graph_host, trace_rel=trace_rel,
                        iters_max_diff=int(dit.max()),
                        iters_total_rel=total_rel,
                        bitwise_kernel_order=same,
                        forms_differ_at=form_diff)
    require((peak <= TRACE_TOL_K).all(), f"trace error {peak} K > 1.0 K")
    require(all(v <= {"rline": 2, "adi": 3}[f] for f, v in per_iter.items())
            and per_iter, ("launches an iteration", per_iter))
    require(split["host_reads"] == 0, ("host reads inside solves", split))
    require(split["host_reads_between_solves"] == 0,
            ("host reads between the graph path's solves", split))
    require(all(same.values()),
            ("graph against the eager loop in the kernels' order", same))
    # against torch.sum's order: the last bits of rnorm move each inner
    # solve's stop within its tolerance (rtol 1e-4 wrt its rhs)
    require(trace_rel <= RECIPE["rtol"],
            ("graph against eager traces", trace_rel))
    require(total_rel <= 0.02, ("graph against eager iterations", iters,
                                ie))
    require(all(near[i] for i in form_diff),
            ("graph against eager forms", form_diff))
    # the device's counts: every step ran its prologue and epilogue, every
    # refinement pass its residual and scale
    passes = RECIPE["f64_refine"]
    require(step_launches == dict(
        step_prologue=problem.num_steps,
        refine_residual=problem.num_steps * passes,
        refine_scale=problem.num_steps * passes,
        step_epilogue=problem.num_steps), step_launches)
    out["slice"]["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 4: {out['slice']['phase_s']:.1f} s", flush=True)
    return fn, step_rows


def kernel_profile(fn) -> dict:
    """One run of ``fn`` under torch.profiler: wall seconds (profiler on),
    the device span from the first kernel's start to the last one's end,
    the busy time in it (kernel intervals merged), and device time and
    calls by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    require(spans, "the profiler saw no device time")
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    by_name: dict[str, list] = {}
    for e in events:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    timeline = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in events)
    return dict(wall_s=wall_s, span_us=spans[-1][1] - spans[0][0],
                busy_us=busy, kernels=by_name, timeline=timeline)


def is_k2_start(k: str) -> bool:
    """K2's first kernel of a solve: the operator pass in its first-residual
    mode (ks_apply<HAS_KV, 1, NPTS>)."""
    return (k.startswith("ks_apply<")
            and k[len("ks_apply<"):-1].split(",")[1].strip() == "1")


def idle_split(prof: dict, first: str = "k_init",
               last: str = "k_finish") -> dict:
    """The device's idle time of a profiled run, in us: inside the solves
    (from a solve's first kernel, K1's k_init or with ``first="k2"`` K2's
    first-residual pass, to its ``last`` kernel), split into the gaps that
    follow a device-to-host copy (the host reading the solve's stop flag or
    running-lane count) and the rest, and between the solves (the caller's
    own work), with the solves' span and kernel time, the count of copies
    to the host inside them and of those between two solves (the host
    reading a step's result before it queues the next step's solve)."""
    import re
    inside = after_read = between = solve_span = solve_busy = 0.0
    start, prev_end, prev_name, solves, reads = None, None, "", 0, 0
    reads_between = pending = 0
    before_first = None
    starts = is_k2_start if first == "k2" else (lambda k: k == first)
    for s0, s1, name in prof["timeline"]:
        m = re.search(r"\b(ks?_[a-z_]+(?:<[^>(]*>)?)", name)
        k = m.group(1) if m else ""
        gap = 0.0 if prev_end is None else max(0.0, s0 - prev_end)
        if starts(k) and start is None:
            start = s0
            between += gap
            if before_first is None:
                before_first = between
            # copies to the host after a solve that another solve follows
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


def k2_kernels(prof: dict) -> dict:
    """A profile's K2 / K3 kernels (``ks_*`` of csrc/sweep_cg.cu) by short
    name (template arguments kept): [device us, calls]."""
    import re
    out: dict[str, list] = {}
    for name, (us, n) in prof["kernels"].items():
        m = re.search(r"\b(ks_[a-z_]+(?:<[^>(]*>)?)\(", name)
        if m:
            acc = out.setdefault(m.group(1), [0.0, 0])
            acc[0] += us
            acc[1] += n
    return out


def sweep_profile(run, label: str, out: dict, key: str) -> dict:
    """One more run of a sweep (``run(iters_out=list)``) under the
    profiler: the device's busy share, its idle time inside K2's solves
    (between launches, and after the host's reads of the running-lane
    count) and between them, and each K2 kernel's device time per
    lane-iteration (the iterations of every lane and step)."""
    import torch
    its = []
    prof = kernel_profile(lambda: run(iters_out=its))
    lane_iters = int(torch.stack(its).sum())
    split = idle_split(prof, first="k2", last="ks_finish")
    require(split["solves"] > 0, (label, "no K2 solve found in the profile"))
    k2 = k2_kernels(prof)
    busy_pct = 100 * prof["busy_us"] / prof["span_us"]
    res = dict(busy_pct=busy_pct, span_ms=prof["span_us"] / 1e3,
               lane_iterations=lane_iters,
               us_per_lane_iteration=prof["busy_us"] / lane_iters,
               split=split,
               kernels={k: dict(us_per_lane_iteration=us / lane_iters,
                                us_per_call=us / c, calls=c)
                        for k, (us, c) in k2.items()})
    print(f"{label} profiled: busy {busy_pct:.2f}% of "
          f"{prof['span_us'] / 1e3:.3f} ms; {lane_iters} lane-iterations, "
          f"{res['us_per_lane_iteration']:.3f} us of device time each; "
          f"{split['solves']} solves, idle in solves "
          f"{split['idle_in_solves_us'] / 1e3:.3f} ms between launches and "
          f"{split['idle_after_host_reads_us'] / 1e3:.3f} ms after "
          f"{split['host_reads']} host reads, between solves "
          f"{split['idle_between_solves_us'] / 1e3:.3f} ms", flush=True)
    for k, v in sorted(res["kernels"].items(),
                       key=lambda kv: -kv[1]["us_per_lane_iteration"]):
        print(f"{label} profiled: {k} {v['us_per_lane_iteration']:.4f} us "
              f"a lane-iteration ({v['calls']} calls, "
              f"{v['us_per_call']:.2f} us each)", flush=True)
    out[key] = res
    return res


def k1_kernels(prof: dict) -> dict:
    """A profile's K1 kernels (``k_*`` of csrc/cg_tol.cu) by short name
    (template arguments kept): [device us, calls]."""
    import re
    out: dict[str, list] = {}
    for name, (us, n) in prof["kernels"].items():
        m = re.search(r"\b(k_[a-z_]+(?:<\w+>)?)\(", name)
        if m:
            acc = out.setdefault(m.group(1), [0.0, 0])
            acc[0] += us
            acc[1] += n
    return out


def profile_run(fn, path: str, out: dict, key: str = "profile") -> None:
    """One more run of ``fn`` under torch.profiler: device time by kernel,
    and the device's busy and idle share of the run (kernel intervals
    merged, over the span from the first kernel's start to the last one's
    end). Writes the kernel table to ``path``, the summary to out[key]."""
    prof = kernel_profile(fn)
    wall_s, span, busy = prof["wall_s"], prof["span_us"], prof["busy_us"]
    rows = sorted(prof["kernels"].items(), key=lambda kv: -kv[1][0])
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
                    device_busy_pct=100 * busy / span,
                    kernels={k: v for k, v in rows})


def sweep_system(problem, ks, fs, device, step: int = 10):
    """The batched system of the sweep's ``step``-th step (the heating
    pulse rises from step ~8; the first steps' fields are ~uniform and their
    systems nearly solved by the seed), exactly as the sweep builds it:
    (A0, Kv, dks, sm, b, x0) in float32, read off the kernel wrapper's
    arguments during a ``step``-step sweep, the kernel solving each step."""
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn
    fn = make_sweep_fn(problem, dtype=torch.float32, solver="vmem",
                       rtol=1e-4, num_steps=step, device=device)
    return _capture(cuda_sweep, "cg_batched_tol",
                    lambda: fn(ks, fs))[-1][0][:6]


def _capture(module, name: str, run) -> list:
    """Every call's positional and keyword arguments to ``module.name``
    while ``run()`` runs (the wrapper itself runs, with its own copy of
    the launch counters)."""
    import functools
    kernel = getattr(module, name)
    seen = []

    @functools.wraps(kernel)
    def capture(*args, **kw):
        seen.append((args, kw))
        return kernel(*args, **kw)

    setattr(module, name, capture)
    try:
        run()
    finally:
        setattr(module, name, kernel)
    return seen


def sweep_phase_cases(A0, Kv, dks, sm, b, x0, rng) -> dict:
    """name -> (kernel wrapper, plain version, arguments, bound on the
    relative error) for each phase kernel of K2/K3. Field phases run on the
    given lanes with numpy-seeded fields; compact on a per-lane state of
    1024 lanes, finish on one of the given lanes (one of them with a NaN
    residual)."""
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
    state = cs.pack_state(nb, dev, rz=lane(0.5, 2.0, nb),
                          rr=lane(0.5, 2.0, nb), stop2=lane(0.0, 2.0, nb),
                          alpha=lane(0.1, 1.0, nb), beta=lane(0.1, 1.0, nb),
                          k=torch.tensor(rng.integers(0, 50, nb)),
                          done=torch.tensor(rng.random(nb) < 0.3))
    rr_b = lane(0.5, 2.0)
    rr_b[B // 2] = float("nan")
    fin_state = cs.pack_state(B, dev, rr=rr_b,
                              k=torch.tensor(rng.integers(0, 500, B)))
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
    # the redesigned phases with their per-lane tails, on a state of the
    # given lanes with one lane done (the merged-dot pass's: phase 14b)
    tails = tail_cases(A0, Kv, dks, sm, b, x0, x, r, p, Ap, rng)
    cases.update((k, v) for k, v in tails.items()
                 if not k.startswith("merged_w"))
    return cases


def tail_state(B: int, rng, device):
    """A per-lane state of B lanes for the tail checks: random scalars and
    counts, about one lane in eight done."""
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    lane = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, B),
                                       dtype=torch.float64, device=device)
    done = rng.random(B) < 0.125
    done[0] = False
    done[-1] = B > 1
    return cs.pack_state(B, device, rz=lane(0.5, 2.0), rr=lane(0.5, 2.0),
                         stop2=lane(0.0, 1e-3), alpha=lane(0.1, 1.0),
                         beta=lane(0.1, 1.0),
                         k=torch.tensor(rng.integers(0, 50, B)),
                         done=torch.tensor(done))


def tail_cases(A0, Kv, dks, sm, b, x0, x, r, p, Ap, rng,
               which=None) -> dict:
    """name -> (kernel, plain, arguments, bound) of the phase kernels that
    carry a per-lane tail, on the given lanes' fields (``which``: a subset
    of the names): the first residual with the identity form's first
    scalars, the r-line PCR with the r-line form's, the stencil with alpha,
    the merged-dot pass with its recurrence's scalars, the update with
    beta, the fused update and r-line PCR with beta (alone, and with the
    z-line phase after it taking beta)."""
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    B = b.shape[0]
    state = tail_state(B, rng, b.device)
    rtol = torch.full((B,), 1e-5, dtype=torch.float32, device=b.device)
    op = (A0, Kv, dks, sm)
    # <r, r> and <b, b> a lane for the r-line start: about half the lanes
    # meet rtol at once
    lane = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, B),
                                       dtype=torch.float64, device=b.device)
    rr0, bb0 = lane(0.5, 2.0), lane(0.5e10, 2.0e10)
    cases = {
        "init[tail]": (
            lambda *a: cs.init(*a, maxiter=40),
            lambda *a: cs.init_reference(*a, maxiter=40),
            (*op, b, x0, state, rtol), 1e-5),
        "pcr_r[init]": (
            lambda *a: cs.pcr_r(*a, maxiter=40),
            lambda *a: cs.pcr_r_reference(*a, maxiter=40),
            (*op, r, state, rr0, bb0, rtol), 1e-4),
        "stencil_dot[alpha]": (cs.stencil_dot, cs.stencil_dot_reference,
                               (*op, p, state), 1e-5),
        "merged_w[tail]": (
            lambda *a: cs.merged_w(*a, maxiter=40),
            lambda *a: cs.merged_w_reference(*a, maxiter=40),
            (*op, p, r, state), 1e-5),
        "update[beta]": (
            lambda *a: cs.update_beta(*a, maxiter=40),
            lambda *a: cs.update_beta_reference(*a, maxiter=40),
            (x, r, p, Ap, state), 1e-5),
        "pcr_r_update": (
            lambda *a: cs.pcr_r_update(*a, maxiter=40),
            lambda *a: cs.pcr_r_update_state_reference(*a, maxiter=40),
            (*op, x, r, p, Ap, state), 1e-4),
        "pcr_r_update[adi]": (
            lambda *a: cs.pcr_r_update(*a, adi=True, maxiter=40),
            lambda *a: cs.pcr_r_update_state_reference(*a, adi=True,
                                                       maxiter=40),
            (*op, x, r, p, Ap, state), 1e-4)}
    return {k: v for k, v in cases.items() if which is None or k in which}


def k2_phase_bound(name: str, args, outs) -> dict:
    """The bound of one K2 phase kernel on its arguments: the operands it
    reads (the two coupling slots of A0 and Kv for a line solve) and the
    outputs it writes, once each; its operations per grid point and lane,
    or per lane for the compaction."""
    import torch
    outs = outs if isinstance(outs, tuple) else (outs,)
    ins = [a for a in args if torch.is_tensor(a)]
    base = name.split("[")[0]
    adi = name.endswith("[adi]")
    if base in ("pcr_r", "pcr_z", "pcr_r_update"):
        slots = (slice(1, 5) if adi else slice(3, 5) if base != "pcr_z"
                 else slice(1, 3))
        ins[0] = ins[0][slots]
        if args[1] is not None:
            ins[1] = ins[1][slots]
    moved = nbytes(*ins, *outs)
    if base == "compact":
        return bound(moved, ins[0].shape[0])
    fields = next(t for t in reversed(ins)
                  if t.dtype == torch.float32 and t.ndim == 3)
    nz, nr = fields.shape[-2:]
    kv = (args[1] is not None if base in ("init", "stencil_dot", "merged_w")
          else True)
    per_point = {"init": 35 if kv else 21, "stencil_dot": 31 if kv else 17,
                 "merged_w": 35 if kv else 21,
                 "update": 6, "p_update": 2, "finish": 1,
                 "pcr_r": k2_line_ops() + 2,
                 "pcr_z": k2_line_ops() + 5,
                 "pcr_r_update": 6 + k2_line_ops() + 2
                 + (k2_line_ops() + 5 if adi else 0)}[base]
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

    path_b_checks(A0, Kv, dks[sel].contiguous(), sm[sel].contiguous(), rows)

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
            iter_bound_ms=k2_iter_bound(its, A0, Kv, sm, b),
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
        iter_bound_ms=k2_iter_bound([120] * B, A0, Kv, sm, b),
        **k2_solve_bound(*args, [120] * B, k2_iter_ops()))
    out["sweep_checks"] = rows
    return rows


# phase 5: the batch sizes of the main paths at which each tail kernel runs
# there is held to its plain version: the B = 1024 Jacobi sweep (the first
# residual with the first scalars, stencil with alpha, update with beta),
# the B = 256 recording sweep (the r-line start, the fused update and
# r-line PCR), the B = 64 ADI sweep (the same with the z-line phase)
PATH_B = {"init[tail]": SWEEP_B, "stencil_dot[alpha]": SWEEP_B,
          "update[beta]": SWEEP_B, "pcr_r[init]": REC_B,
          "pcr_r_update": REC_B, "pcr_r_update[adi]": ADI_B}
# phase 14b: the merged-dot pass with its tail at phase 15's batch size
MERGED_PATH_B = {"merged_w[tail]": MERGED_B}


def path_b_checks(A0, Kv, dks, sm, rows: dict, path_b=PATH_B) -> None:
    """Phases 5 and 14b, at the paths' batch sizes (``path_b``, tail case
    -> B): each tail kernel against its plain version on lanes cycled from
    the given ones, fields from a seeded generator on the card;
    rows[f"...[B=n]"] with the wrapper's time."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    rng = np.random.default_rng(55)
    gen = torch.Generator(device=A0.device)
    gen.manual_seed(55)
    for name, B in path_b.items():
        reps = -(-B // len(dks))
        smb = sm.repeat(reps, 1, 1)[:B].contiguous()
        dkb = dks.repeat(reps)[:B].contiguous()
        free = (smb != 0).to(torch.float32)
        field = lambda: (torch.randn(smb.shape, generator=gen,
                                     device=A0.device) * free).contiguous()
        x, r, p, b, x0 = field(), field(), field(), field(), field()
        Ap = cs.stencil_dot_reference(A0, Kv, dkb, smb, p)[0].contiguous()
        (fn, ref, args, tol), = tail_cases(A0, Kv, dkb, smb, b, x0, x, r, p,
                                           Ap, rng, (name,)).values()
        out_p = ref(*args)
        err, rel = compare_outputs(fn(*args), out_p)
        require(rel <= tol, (name, B, rel, tol))
        key = f"cg_batched_tol.{name}[B={B}]"
        rows[key] = dict(name=key, phase=name.split("[")[0], B=B,
                         max_abs_err=err, rel=rel,
                         ms=cuda_ms(lambda: fn(*args), 3),
                         plain_ms=cuda_ms(lambda: ref(*args), 1),
                         **k2_phase_bound(name, args, out_p))
        print(f"sweep phase {name} at B = {B}: max|err| {err:.3e} (rel "
              f"{rel:.3e}, bound {tol:.0e}), wrapper {rows[key]['ms']:.3f} "
              f"ms (with its copies), plain {rows[key]['plain_ms']:.3f} ms",
              flush=True)
        del x, r, p, b, x0, Ap, smb, args, out_p
        torch.cuda.empty_cache()


# K2 / K3 phase-kernel launches an enqueued iteration, by solve form (the
# merged-dot recurrence's the same): the operator pass with the alpha tail,
# the update (identity) or the fused update and r-line PCR with the beta
# tail, the p update; ADI and adaptive + the z-line phase
K2_LAUNCHES = dict(identity=3, rline=3, adi=4, adaptive=4, no_kv=3, fixed=3)


def _sweep_counts():
    """K2 / K3 launches since the counters were set to 0: by phase kernel,
    solves by form, and launches an iteration by form; checks that each
    form's iteration took its K2_LAUNCHES."""
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    phases = cs.phase_launches()
    per_iter = cs.launches_per_iteration()
    want = {f: K2_LAUNCHES[f.removesuffix("_merged")] for f in per_iter}
    require(per_iter == want, ("K2 launches an iteration", per_iter, want))
    return dict(phases=phases, per_iteration=per_iter,
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
    sweep_profile(sweep, f"sweep B = {SWEEP_B}", out, "sweep_split")
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
        iter_bound_ms=k2_iter_bound(its_k, Mp, None, s_mp, b),
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
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn, run_transient

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
    # the recording path of that run against the float64 recording truth
    rec_truth = np.load(TRUTH_RECORDING)
    rec_err = {}
    for key, got_rows in (("watch", res.watcher), ("band", res.band_rows),
                          ("axis", res.axis_rows)):
        want = rec_truth[key]
        require(got_rows.shape == want.shape, (key, got_rows.shape))
        rec_err[key] = float(np.abs(got_rows - want).max()
                             / np.abs(want).max())
    print("recording run (float32, adi, rtol 1e-4) vs the float64 recording "
          "truth, max |error| / max |truth|: "
          + ", ".join(f"{k} {v:.3e} (limit {RECORDING_TOL[k]:.0e})"
                      for k, v in rec_err.items()))
    require(all(v <= RECORDING_TOL[k] for k, v in rec_err.items()), rec_err)
    # the same rows from a run with two float64 refinement passes: with the
    # solve's float32 error out of the way, the recording itself is held
    fine = make_simulate_fn(problem, dtype=torch.float32, device=device,
                            rtol=1e-4, rtol_wrt="r0", maxiter=20000,
                            record_gradient=True, record_fields=False,
                            solver="auto", precondition="rline",
                            warm_start="previous", f64_refine=2)()
    fine_err = {k: float(np.abs(fine[k].cpu().numpy() - rec_truth[k]).max()
                         / np.abs(rec_truth[k]).max())
                for k in RECORDING_TOL}
    print("recording run (r-line, two float64 passes) vs the truth: "
          + ", ".join(f"{k} {v:.3e} (limit {REFINED_RECORDING_TOL[k]:.0e})"
                      for k, v in fine_err.items()))
    require(all(v <= REFINED_RECORDING_TOL[k] for k, v in fine_err.items()),
            fine_err)
    truth = np.load(TRUTH)["watch"]
    peak = np.abs(got[:, 1:] - truth).max(axis=0)
    print(f"run2d CLI: {run_s:.2f} s (mesh build and .msh write included); "
          f"watcher_points.csv equals run_transient bitwise; gradient CSVs "
          f"finite; checkpoint written; peak |error| vs f64 truth: "
          + ", ".join(f"{n} {e:.4f} K" for n, e in zip(names, peak)))
    out["drivers"] = dict(sweep_cli_s=wall_s, sweep_launches=counts,
                          **{f"sweep_{k}": v for k, v in timings.items()},
                          run2d_cli_s=run_s, recording_vs_truth=rec_err,
                          refined_recording_vs_truth=fine_err,
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
            plain_ms=plain_ms,
            iter_bound_ms=k2_iter_bound(its, args[0], args[1], args[3],
                                        args[4]),
            **k2_solve_bound(*args, its, per_lane))
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
    adi_sweep = lambda **more: run_sweep_time_chunked(problem, ks, fs, **kw,
                                                      **more)
    sweep_profile(adi_sweep, f"adi sweep B = {ADI_B}", out, "adi_split")
    return counts_all, adi_sweep


def vmem_solve_checks(problem, device, out: dict) -> dict:
    """Phase 13a: the differentiable cg_vmem_solve on the flagship's first
    step system (r-line stack): value, backward and tangent, kernel against
    the plain version on the card (float32, and float64 for the floor)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    pcr = cuda_cg.rline_pack(A32, s32, free32)
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
            iter_bound_ms=k1_iter_bound(solves, nbytes(A32, sm32, pcr),
                                        nbytes(b32)),
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


def forms_checks(problem, device, out: dict) -> dict:
    """Phase 14a: at the flagship shape, on the first step's system, each
    new phase kernel of ``cg_tol`` alone and the full solves of the
    Chebyshev, merged-dot and mgz forms against their plain versions and
    against the standard r-line solve; the V-cycle's symmetry."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.stepper import mgz_operands

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    pcr = cuda_cg.rline_pack(A32, s32, free32)
    pcr_z = cuda_cg.zline_pack(A32, s32, free32)
    mgz = mgz_operands(problem, torch.float32, device)
    nz, nr = b32.shape
    n = nz * nr
    rng = np.random.default_rng(14)
    field = lambda: (torch.tensor(rng.standard_normal((nz, nr)),
                                  dtype=torch.float32, device=device)
                     * free32).contiguous()
    u, r, p, q = field(), field(), field(), field()
    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rows = {}

    def distance(got, want):
        err = rel = 0.0
        for a, b_ in zip(got, want, strict=True):
            if a is None and b_ is None:
                continue
            d = float((a.double() - b_.double()).abs().max())
            scale = float(b_.double().abs().max())
            err, rel = max(err, d), max(rel, d / scale)
        return err, rel

    def phase(name, kernel, plain, moved, ops, tol=1e-5, reps=50,
              truth=None):
        """Compare the tensors and sums a phase returns, then time it. With
        ``truth`` (the plain version in float64) the bound is the larger of
        ``tol`` and twice the plain float32 version's own distance from it:
        a composition of passes amplifies float32 rounding by the
        cancellation in its residuals, whatever the implementation."""
        got, want = kernel(), plain()
        err, rel = distance(got, want)
        if truth is not None:
            t64 = truth()
            floor = distance(want, t64)[1]
            rel64 = distance(got, t64)[1]
            print(f"form phase {name}: vs float64 kernel {rel64:.3e}, plain "
                  f"{floor:.3e}")
            require(rel64 <= max(tol, 1.5 * floor), (name, rel64, floor))
            tol = max(tol, 2.0 * floor)
        require(rel <= tol, (name, rel))
        # the phase kernel whose launches on the main path this row reads
        # (a Chebyshev row its step kernel, a V-cycle row the prolongation:
        # one launch a cycle)
        base = name.split("[")[0]
        counter = {"cheb": "cheb_init" if name == "cheb[1]" else "cheb_step",
                   "mgz_vcycle": "mgz_prolong_res"}.get(base, base)
        rows[f"cg_tol.{name}"] = dict(
            name=f"cg_tol.{name}", phase=counter, max_abs_err=err, rel=rel,
            ms=cuda_ms(kernel, reps), plain_ms=cuda_ms(plain, 10),
            **bound(moved, ops))
        row = rows[f"cg_tol.{name}"]
        print(f"form phase {name}: max|err| {err:.3e} (rel {rel:.3e}, bound "
              f"{tol:.0e}), kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms")

    plane = b32.numel() * 4
    phase("merged_w", lambda: cuda_cg.merged_w(A32, sm32, u, r),
          lambda: cuda_cg.merged_w_reference(A32, sm32, u, r),
          nbytes(A32, sm32, u, r, u) + 24, 21 * n)
    phase("pq_update", lambda: cuda_cg.pq_update(p, q, u, r, 0.37),
          lambda: cuda_cg.pq_update_reference(p, q, u, r, 0.37),
          6 * plane, 4 * n)
    # the mgz cycle's passes on the first step's system: a state record for
    # the fused update and the beta tail; the coarse passes on the
    # pre-smoothed iterate, the coarse iterate and the restricted residual
    # of the plain versions
    aux, pcrc = mgz["aux"], mgz["pcrc"]
    st = dict(rz=0.7, rr=1.3, stop2=1e-30, alpha=0.37, beta=0.1, k=3, done=0)
    upd = dict(x=p, p=q, Ap=u)
    phase("mgz_pre[update]",
          lambda: cuda_cg.mgz_pre(r, pcr, 0.8, **upd, state=st),
          lambda: cuda_cg.mgz_pre_reference(r, pcr, 0.8, **upd,
                                            alpha=st["alpha"]),
          nbytes(p, r, q, u, pcr, p, r, r) + 8,
          (LINE_SOLVE_OPS + 7) * n, tol=1e-4)
    # the passes with a residual in them (the smoothed iterate cancels most
    # of r) are held to the plain float32 version's distance from float64
    d64 = lambda *ts: [t.double() for t in ts]
    z_pre = cuda_cg.mgz_pre_reference(r, pcr, 0.8)[2].contiguous()
    co_in = (A32, sm32, r, z_pre, aux, pcrc)
    phase("mgz_coarse",
          lambda: cuda_cg.mgz_coarse(*co_in, 0.8),
          lambda: cuda_cg.mgz_coarse_reference(*co_in, 0.8),
          nbytes(A32, sm32, r, z_pre, aux, r, r) + nbytes(pcrc) // 2,
          23 * n + (LINE_SOLVE_OPS + 1) * n // 2, tol=1e-4,
          truth=lambda: cuda_cg.mgz_coarse_reference(*d64(*co_in), 0.8))
    yc, rcs = (t.contiguous() for t in cuda_cg.mgz_coarse_reference(
        *co_in, 0.8))
    cr_in = (mgz["Ac9"], rcs, yc, pcrc)
    phase("mgz_coarse_res",
          lambda: (cuda_cg.mgz_coarse_res(*cr_in, 0.8),),
          lambda: (cuda_cg.mgz_coarse_res_reference(*cr_in, 0.8),),
          (nbytes(mgz["Ac9"], pcrc) + 2 * plane) // 2 + plane,
          (18 + LINE_SOLVE_OPS + 2) * n // 2, tol=1e-4,
          truth=lambda: (cuda_cg.mgz_coarse_res_reference(*d64(*cr_in),
                                                          0.8),))
    pr_in = (A32, sm32, r, z_pre, yc, aux)
    phase("mgz_prolong_res",
          lambda: cuda_cg.mgz_prolong_res(*pr_in),
          lambda: cuda_cg.mgz_prolong_res_reference(*pr_in),
          nbytes(A32, sm32, r, z_pre, yc, aux, r, r), 26 * n,
          truth=lambda: cuda_cg.mgz_prolong_res_reference(*d64(*pr_in)))
    zp, r1 = (t.contiguous() for t in cuda_cg.mgz_prolong_res_reference(
        *pr_in))
    rr = float((r.double() * r.double()).sum())
    post_kw = dict(state=st, rr=rr, maxiter=9)
    po_in = (r1, zp, pcr)
    phase("mgz_post[tail]",
          lambda: cuda_cg.mgz_post(*po_in, 0.8, sm32, r, **post_kw)[:2],
          lambda: cuda_cg.mgz_post_reference(*po_in, 0.8, sm32, r),
          nbytes(r1, zp, pcr, sm32, r, r) + 8, (LINE_SOLVE_OPS + 5) * n,
          tol=1e-4, truth=lambda: cuda_cg.mgz_post_reference(
              *d64(*po_in), 0.8, sm32.double(), r.double()))
    _, rz_k, got = cuda_cg.mgz_post(r1, zp, pcr, 0.8, sm32, r, **post_kw)
    want = cuda_cg.finalize_reference(st, "beta", rr=rr, rz=float(rz_k),
                                      maxiter=9)
    for key, v in want.items():
        require(abs(got[key] - v) <= 1e-12 * max(1.0, abs(v)),
                ("mgz_post beta tail", key, got[key], v))
    # the odd rows of the coarse iterate are 0 and finite in the kernel too
    yc_k, rcs_k = cuda_cg.mgz_coarse(A32, sm32, r, z_pre, aux, pcrc, 0.8)
    require(bool(torch.isfinite(yc_k).all())
            and float(yc_k[1::2].abs().max()) == 0.0
            and float(rcs_k[1::2].abs().max()) == 0.0,
            "mgz_coarse: odd rows not 0")
    for deg in (1, 3, 4):
        phase(f"cheb[{deg}]",
              lambda: cuda_cg.precond_apply(A32, sm32, r, cheb_degree=deg),
              lambda: cuda_cg.precond_apply_reference(A32, sm32, r,
                                                      cheb_degree=deg),
              nbytes(A32, sm32, r, r) + 8, (1 + 21 * (deg - 1)) * n,
              tol=1e-4)
    for sw in (1, 2):
        kw = dict(pcr=pcr, mgz=mgz, mgz_sweeps=sw)
        phase(f"mgz_vcycle[{sw}]",
              lambda: cuda_cg.precond_apply(A32, sm32, r, **kw),
              lambda: cuda_cg.precond_apply_reference(A32, sm32, r, **kw),
              nbytes(A32, sm32, r, pcr, mgz["pcrc"], mgz["aux"], r)
              + (nbytes(mgz["Ac9"]) if sw > 1 else 0) + 8,
              (2 * 17 + (2 + sw) * (LINE_SOLVE_OPS + 3) + 17
               + (sw - 1) * 18) * n, tol=1e-4, reps=20,
              truth=lambda: cuda_cg.precond_apply_reference(
                  A32.double(), sm32.double(), r.double(), pcr=pcr.double(),
                  mgz={k: v.double() for k, v in mgz.items()},
                  mgz_sweeps=sw))

    # the scalar phase of the merged recurrence, first and later calls
    st0 = dict(rz=0.7, rr=1.3, stop2=1e-3, alpha=0.4, beta=0.1, k=3, done=0)
    for first in (True, False):
        kw = dict(first=first, preconditioned=True, rtol=1e-2, maxiter=9,
                  rtol_wrt="b")
        got = cuda_cg.finalize_merged(st0, 0.9, 1.1, 0.6, 2.0, **kw,
                                      device=device)
        want = cuda_cg.finalize_merged_reference(st0, 0.9, 1.1, 0.6, 2.0,
                                                 **kw)
        worst = 0.0
        for key, v in want.items():
            worst = max(worst, abs(got[key] - v))
            require(abs(got[key] - v) <= 1e-12 * max(1.0, abs(v)),
                    ("finalize_merged", first, key, got[key], v))
        tag = "first" if first else "next"
        rows[f"cg_tol.finalize_merged[{tag}]"] = dict(
            name=f"cg_tol.finalize_merged[{tag}]", phase="finalize_merged",
            max_abs_err=worst, rel=worst,
            ms=cuda_ms(lambda: cuda_cg.finalize_merged(
                st0, 0.9, 1.1, 0.6, 2.0, **kw, device=device), 20),
            plain_ms=cuda_ms(lambda: cuda_cg.finalize_merged_reference(
                st0, 0.9, 1.1, 0.6, 2.0, **kw), 20),
            **bound(64 + 64 + 4 * 8, 12))
    print("form phase finalize_merged: first and later calls equal the "
          "plain scalars to 1e-12")

    # the V-cycle is symmetric: <v, M^-1 u> = <u, M^-1 v> to float32 rounding
    for sw in (1, 2):
        kw = dict(pcr=pcr, mgz=mgz, mgz_sweeps=sw)
        Mu, _ = cuda_cg.precond_apply(A32, sm32, u, **kw)
        Mr, _ = cuda_cg.precond_apply(A32, sm32, r, **kw)
        a = float((r.double() * Mu.double()).sum())
        b_ = float((u.double() * Mr.double()).sum())
        asym = abs(a - b_) / (norm(r) * norm(Mu))
        print(f"mgz V-cycle symmetry ({sw} sweep(s)): <v, Mu> {a:.6e}, "
              f"<u, Mv> {b_:.6e}, |difference| / (|v| |Mu|) {asym:.3e}")
        require(asym <= 1e-5, ("V-cycle asymmetry", sw, asym))
        rows[f"cg_tol.mgz_vcycle[{sw}]"]["asymmetry"] = asym

    # full solves against the plain versions, the float64 solution and the
    # standard r-line solve (the bounds of phase 3: a float32 solve of this
    # system carries a rounding floor, measured on the plain version)
    rtol = 1e-6
    x0 = torch.zeros_like(b32)
    f64 = lambda v: {k: t.double() for k, t in v.items()} \
        if isinstance(v, dict) else (v.double() if torch.is_tensor(v) else v)
    forms = {
        "cheb3": dict(cheb_degree=3),
        "merged_identity": dict(merged=True),
        "merged_rline": dict(merged=True, pcr=pcr),
        "merged_adi": dict(merged=True, pcr=pcr, pcr_z=pcr_z),
        "merged_cheb3": dict(merged=True, cheb_degree=3),
        "mgz1": dict(pcr=pcr, mgz=mgz, mgz_sweeps=1),
        "mgz2": dict(pcr=pcr, mgz=mgz, mgz_sweeps=2)}
    x_std, it_std = cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, maxiter=20000,
                                   rtol_wrt="b", pcr=pcr)
    nan_b = b32.clone()
    nan_b[nz // 2, nr // 2] = float("nan")
    solves = {}
    for form, fkw in forms.items():
        kw = dict(maxiter=20000, rtol_wrt="b", **fkw)
        cuda_cg.reset_counters()
        x_k, it_k = cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw)
        per_iter = cuda_cg.launches_per_iteration()
        x_p, it_p = cuda_cg.cg_tol_reference(A32, sm32, b32, x0, rtol, **kw)
        x64, _ = cuda_cg.cg_tol_reference(
            A32.double(), sm32.double(), b32.double(), x0.double(), rtol,
            maxiter=20000, rtol_wrt="b", **{k: f64(v) for k, v in fkw.items()})
        it_k, it_p = int(it_k), int(it_p)
        rel_l2 = norm(x_k - x_p) / norm(x_p)
        err_k, err_p = norm(x_k - x64) / norm(x64), \
            norm(x_p - x64) / norm(x64)
        vs_std = norm(x_k - x_std) / norm(x_std)
        x_n, it_n = cuda_cg.cg_tol(A32, sm32, nan_b, x0, rtol, **kw)
        require(bool(torch.isnan(x_n).all()) and int(it_n) == 0,
                (form, "NaN rhs not poisoned"))
        print(f"solve {form}: iters kernel {it_k} plain {it_p} (standard "
              f"r-line {int(it_std)}); kernel vs plain rel-L2 {rel_l2:.3e}; "
              f"vs float64 kernel {err_k:.3e} plain {err_p:.3e}; vs the "
              f"standard r-line solve {vs_std:.3e}")
        # counts within 5 % of the plain version's; 10 % in the
        # unpreconditioned merged form, ~4000 float32 iterations whose
        # coupled alpha carries every earlier rounding forward
        slack = 0.10 if form == "merged_identity" else 0.05
        require(abs(it_k - it_p) <= max(3, int(slack * it_p)),
                (form, it_k, it_p))
        require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, rel_l2, err_p))
        require(err_k <= max(1e-4, 1.5 * err_p), (form, err_k, err_p))
        require(vs_std <= max(1e-3, 4.0 * err_p), (form, vs_std, err_p))
        if form.startswith("mgz"):
            require(it_k < 0.5 * int(it_std), (form, it_k, int(it_std)))
            # the fused cycle: 6 launches an iteration with one coarse sweep,
            # one more a further sweep
            want = MGZ_LAUNCHES[fkw["mgz_sweeps"]]
            print(f"solve {form}: {per_iter['mgz']:.2f} launches an "
                  f"iteration (at most {want})")
            require(per_iter["mgz"] <= want, (form, per_iter))
        ms = cuda_ms(lambda: cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw),
                     3)
        plain_ms = cuda_ms(
            lambda: cuda_cg.cg_tol_reference(A32, sm32, b32, x0, rtol, **kw),
            1)
        stacks = [v for v in fkw.values() if torch.is_tensor(v)]
        if "mgz" in fkw:
            stacks += [mgz["pcrc"], mgz["aux"]] + (
                [mgz["Ac9"]] if fkw["mgz_sweeps"] > 1 else [])
        # the bound of the iterations: each iteration's inputs (operator,
        # stacks, the vectors it carries) read once and its outputs written
        # once, times the iterations
        carried = 4 if fkw.get("merged") else 3
        iter_ms = it_k * (nbytes(A32, sm32, *stacks) + 2 * carried * plane) \
            / HBM_BYTES_PER_S * 1e3
        solves[form] = dict(
            iters=it_k, plain_iters=it_p, rline_iters=int(it_std),
            launches_per_iter=sum(per_iter.values()),
            rel_l2=rel_l2, err_vs_f64=err_k, plain_err_vs_f64=err_p,
            vs_standard_rline=vs_std,
            max_abs_err=float((x_k - x_p).abs().max()), ms=ms,
            plain_ms=plain_ms, iter_bound_ms=iter_ms,
            **bound(nbytes(A32, sm32, b32, x0, b32, *stacks),
                    it_k * n * k1_form_ops(fkw)))
        print(f"solve {form}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
              f"{1e3 * ms / max(it_k, 1):.2f} us an iteration; bound of the "
              f"iterations {iter_ms:.4f} ms (inputs once each)")
    out["form_phases"] = rows
    out["form_solves"] = solves
    return dict(phases=rows, solves=solves)


def k1_form_ops(fkw: dict) -> int:
    """Float32 operations a grid point of one iteration of a K1 form costs,
    counted for what it computes: the preconditioner (a line solve 8 + 4,
    a Chebyshev step 21, the V-cycle two residuals, 2 + sweeps line solves,
    transfers and coarse applies), and the standard recurrence (17 + 6 + 2)
    or the merged one (w with three sums 21, x and r 4, p and q 4)."""
    pre = 0
    if "mgz" in fkw:
        sw = fkw.get("mgz_sweeps", 1)
        pre = 2 * 17 + (2 + sw) * (LINE_SOLVE_OPS + 3) + 17 + (sw - 1) * 18
    elif "pcr" in fkw:
        pre = (LINE_SOLVE_OPS + 4) * (2 if "pcr_z" in fkw else 1)
    elif fkw.get("cheb_degree"):
        pre = 1 + 21 * (fkw["cheb_degree"] - 1)
    return pre + (21 + 4 + 4 if fkw.get("merged") else 17 + 6 + 2)


def merged_sweep_checks(problem, device, out: dict) -> dict:
    """Phase 14b: at the sweep shape, on the 10th step's system of 8 lanes
    (one NaN, one at rtol 2), K2's merged-dot phase kernels alone and its
    merged solves (identity, r-line, ADI, adaptive) against their plain
    versions and against the standard solves; the adaptive lanes against
    the static merged lanes (bitwise)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_sweep as cs

    rng = np.random.default_rng(14)
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
    print(f"merged sweep checks: grid {nz} x {nr}, lanes kappa "
          f"{np.round(ks, 3).tolist()}, lane {nan_lane} NaN, lane "
          f"{easy_lane} at rtol 2, adaptive flags {flags.tolist()}")
    rows = {}
    dk7, sm7 = dks[sel].contiguous(), sm[sel].contiguous()
    field = lambda: (torch.tensor(rng.standard_normal((len(live), nz, nr)),
                                  dtype=torch.float32, device=device)
                     * (sm7 != 0)).contiguous()
    u, r, p, q = field(), field(), field(), field()
    beta = torch.tensor(rng.uniform(0.1, 1.0, len(live)),
                        dtype=torch.float64, device=device)
    st7 = tail_state(len(live), rng, device)
    n_pts = len(live) * nz * nr
    cases = {
        "merged_w": (lambda: cs.merged_w(A0, Kv, dk7, sm7, u, r),
                     lambda: cs.merged_w_reference(A0, Kv, dk7, sm7, u, r),
                     nbytes(A0, Kv, dk7, sm7, u, r, u), 35 * n_pts, 1e-5),
        "merged_w[no_kv]": (
            lambda: cs.merged_w(A0, None, None, sm7, u, r),
            lambda: cs.merged_w_reference(A0, None, None, sm7, u, r),
            nbytes(A0, sm7, u, r, u), 21 * n_pts, 1e-5),
        "merged_w[tail]": (
            lambda: cs.merged_w(A0, Kv, dk7, sm7, u, r, st7, maxiter=40),
            lambda: cs.merged_w_reference(A0, Kv, dk7, sm7, u, r, st7,
                                          maxiter=40),
            nbytes(A0, Kv, dk7, sm7, u, r, u, st7, st7), 35 * n_pts, 1e-5),
        "pq_update": (lambda: cs.pq_update(p, q, u, r, beta),
                      lambda: cs.pq_update_reference(p, q, u, r, beta),
                      nbytes(p, q, u, r, p, q), 4 * n_pts, 1e-5)}
    for name, (kernel, plain, moved, ops, tol) in cases.items():
        out_p = plain()
        err, rel = compare_outputs(kernel(), out_p)
        require(rel <= tol, (name, rel))
        row = rows[f"cg_batched_tol.{name}"] = dict(
            name=f"cg_batched_tol.{name}", phase=name.split("[")[0],
            max_abs_err=err, rel=rel, ms=cuda_ms(kernel, 20),
            plain_ms=cuda_ms(plain, 5), **bound(moved, ops))
        print(f"merged sweep phase {name}: max|err| {err:.3e} (rel {rel:.3e}"
              f", bound {tol:.0e}), kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms")
    path_b_checks(A0, Kv, dk7, sm7, rows, MERGED_PATH_B)

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rtol = torch.full((B,), 1e-6, dtype=torch.float32, device=device)
    rtol[easy_lane] = 2.0
    kw = dict(maxiter=20000, rtol_wrt="r0")
    args = (A0, Kv, dks, sm, b, x0)
    d64 = tuple(t.double() for t in args)
    got = {}
    for form, fkw in (("identity", {}), ("rline", dict(rline=True)),
                      ("adi", dict(adi=True)),
                      ("adaptive", dict(adi_flags=flags))):
        x_k, it_k = cs.cg_batched_tol(*args, rtol, merged=True, **kw, **fkw)
        x_p, it_p = cs.cg_batched_tol_reference(*args, rtol, merged=True,
                                                **kw, **fkw)
        x_s, it_s = cs.cg_batched_tol(*args, rtol, merged=False, **kw, **fkw)
        x64, _ = cs.cg_batched_tol_reference(*d64, rtol.double(),
                                             merged=True, **kw, **fkw)
        got[form] = (x_k, it_k)
        require(bool(torch.isnan(x_k[nan_lane]).all())
                and int(it_k[nan_lane]) == 0, (form, "NaN lane"))
        require(int(it_k[easy_lane]) == 0
                and torch.equal(x_k[easy_lane], x0[easy_lane]),
                (form, "rtol-2 lane"))
        worst = dict(rel_l2=0.0, err_k=0.0, err_p=0.0, dit=0, vs_std=0.0)
        for i in live:
            if i == easy_lane:
                continue
            ik, ip = int(it_k[i]), int(it_p[i])
            require(abs(ik - ip) <= max(3, int(0.05 * ip)), (form, i, ik, ip))
            rel_l2 = norm(x_k[i] - x_p[i]) / norm(x_p[i])
            err_k = norm(x_k[i] - x64[i]) / norm(x64[i])
            err_p = norm(x_p[i] - x64[i]) / norm(x64[i])
            vs_std = norm(x_k[i] - x_s[i]) / norm(x_s[i])
            require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, i, rel_l2, err_p))
            require(err_k <= max(1e-4, 1.5 * err_p), (form, i, err_k, err_p))
            require(vs_std <= max(1e-3, 4.0 * err_p), (form, i, vs_std))
            for key, v in (("rel_l2", rel_l2), ("err_k", err_k),
                           ("err_p", err_p), ("dit", abs(ik - ip)),
                           ("vs_std", vs_std)):
                worst[key] = max(worst[key], v)
        ms = cuda_ms(lambda: cs.cg_batched_tol(*args, rtol, merged=True, **kw,
                                               **fkw), 2)
        plain_ms = cuda_ms(lambda: cs.cg_batched_tol_reference(
            *args, rtol, merged=True, **kw, **fkw), 1)
        its = [int(i) for i in it_k.tolist()]
        pre = {"identity": 0, "rline": k2_line_ops() + 2,
               "adi": 2 * (k2_line_ops() + 2)}
        per_lane = ([pre[form] + 35 + 8] * B if form != "adaptive" else
                    [pre["adi" if f else "rline"] + 35 + 8
                     for f in flags.tolist()])
        rows[f"cg_batched_tol[merged_{form}]"] = dict(
            iters=its, plain_iters=[int(i) for i in it_p.tolist()],
            standard_iters=[int(i) for i in it_s.tolist()], **worst,
            max_abs_err=float((x_k[sel] - x_p[sel]).abs().max()), ms=ms,
            plain_ms=plain_ms,
            iter_bound_ms=k2_iter_bound(its, args[0], args[1], args[3],
                                        args[4]),
            **k2_solve_bound(*args, its, per_lane))
        print(f"merged sweep solve {form}: iters kernel {its} plain "
              f"{[int(i) for i in it_p.tolist()]} standard "
              f"{[int(i) for i in it_s.tolist()]}; worst lane: kernel vs "
              f"plain rel-L2 {worst['rel_l2']:.3e}, vs the standard solve "
              f"{worst['vs_std']:.3e}, vs float64 kernel "
              f"{worst['err_k']:.3e} plain {worst['err_p']:.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    (x_a, it_a) = got["adaptive"]
    for i, f in enumerate(flags.tolist()):
        x_s, it_s = got["adi" if f else "rline"]
        same = (torch.equal(x_a[i], x_s[i]) if i != nan_lane else
                bool(torch.isnan(x_a[i]).all() and torch.isnan(x_s[i]).all()))
        require(same and int(it_a[i]) == int(it_s[i]),
                ("adaptive merged lane differs from the static lane", i, f))
    print("merged sweep: every adaptive lane equals the static merged ADI "
          "(flag 1) or r-line (flag 0) solve's lane bitwise")
    out["merged_sweep_checks"] = rows
    return rows


def _timed_transient(problem, device, label: str, **kw):
    """One warm-up run and one timed run of the flagship transient through
    ``make_simulate_fn`` with the K1 counters set to 0 just before the timed
    run: (ys, summary dict with steps/s, mean iterations, K1's launches by
    form and by phase kernel, the peak trace error against the float64
    truth)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn

    fn = make_simulate_fn(problem, dtype=torch.float32, device=device, **kw)
    fn()
    torch.cuda.synchronize()
    cuda_cg.reset_counters()
    t0 = time.perf_counter()
    ys = fn()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    forms = {name[len("launches_"):]: getattr(cuda_cg.cg_tol, name)
             for name in cuda_cg._FORM_COUNTERS if name != "launches"}
    phases = cuda_cg.phase_launches()
    watch = ys["watch"].cpu().numpy()
    iters = ys["cg_iters"].cpu().numpy()
    require(np.isfinite(watch).all()
            and np.isfinite(ys["final_u"].cpu().numpy()).all(),
            (label, "non-finite traces"))
    truth = np.load(TRUTH)["watch"]
    require(watch.shape == truth.shape, (label, watch.shape, truth.shape))
    peak = np.abs(watch - truth).max(axis=0)
    names = list(problem.watcher_names)
    res = dict(label=label, steps=problem.num_steps, run_s=run_s,
               steps_per_s=problem.num_steps / run_s,
               iters_mean=float(iters.mean()), iters_max=int(iters.max()),
               iters_argmax=int(iters.argmax()), iters=iters.tolist(),
               forms=forms, phase_launches=phases,
               peak_err_K=dict(zip(names, peak.tolist())))
    print(f"{label}: {problem.num_steps} steps in {run_s:.4f} s = "
          f"{res['steps_per_s']:.2f} steps/s; cg_iters mean "
          f"{res['iters_mean']:.2f} max {res['iters_max']} (step "
          f"{res['iters_argmax'] + 1}); solves by form "
          f"{ {k: v for k, v in forms.items() if v} }; peak |error| vs f64 "
          f"truth [K]: " + ", ".join(f"{n} {e:.4f}"
                                     for n, e in zip(names, peak)))
    return ys, res


def _merged_stall(problem, device, res: dict):
    """Where a step of the merged adaptive run ran to ``maxiter``: that
    step's system, read off ``cg_tol``'s arguments in one more run (the
    eager loop, which calls the wrapper), solved
    again by the standard kernel, the merged kernel and the plain merged
    version (capped at 2000 iterations), to tell a fault of the kernel from
    a property of the recurrence in float32. Returns the counts, or None
    when no step stalled."""
    import functools
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    if res["iters_max"] < RECIPE["maxiter"]:
        return None
    calls = []
    kernel = cuda_cg.cg_tol

    @functools.wraps(kernel)
    def capture(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    cuda_cg.cg_tol, cuda_cg.MERGED_DEFAULT = capture, True
    try:
        make_simulate_fn(problem, dtype=torch.float32, device=device,
                         **RECIPE).forward_eager()
    finally:
        cuda_cg.cg_tol, cuda_cg.MERGED_DEFAULT = kernel, False
    args, kw = calls[res["iters_argmax"]]
    kw = dict(kw, maxiter=2000)
    form = "adi" if kw.get("pcr_z") is not None else "rline"
    it_std = int(kernel(*args, **kw, merged=False)[1])
    it_mk = int(kernel(*args, **kw, merged=True)[1])
    it_mp = int(cuda_cg.cg_tol_reference(*args, **kw, merged=True)[1])
    print(f"merged-dot stall at step {res['iters_argmax'] + 1} ({form} "
          f"form, its refinement system, capped at 2000 iterations): "
          f"standard kernel {it_std}, merged kernel {it_mk}, merged plain "
          f"version {it_mp} iterations")
    return dict(step=res["iters_argmax"] + 1, form=form, standard=it_std,
                merged_kernel=it_mk, merged_plain=it_mp)


def run_forms_slice(problem, sweep_problem, device, out: dict) -> dict:
    """Phase 15: the flagship transient (100 steps, full width) in the mgz,
    Chebyshev and merged-dot forms; two small sweeps with the merged
    recurrence switched on (K2); the 2D CLI with ``--precondition mgz``."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.config import load_config, save_config
    from heatflow_tpu_torch.drivers import run2d
    from heatflow_tpu_torch.io.csvio import read_watcher_csv
    from heatflow_tpu_torch.ops import cuda_cg, cuda_sweep
    from heatflow_tpu_torch.sim.stepper import run_transient
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn_recording,
                                                    run_sweep_time_chunked)

    base = dict(maxiter=8000, record_gradient=False, record_fields=False,
                rtol_wrt="r0", solver="auto")
    runs = []
    # (a) mgz with one float64 refinement pass
    for sw in (1, 2):
        _, res = _timed_transient(
            problem, device, f"mgz ({sw} coarse sweep(s)), f64_refine=1",
            precondition="mgz", mgz_sweeps=sw, f64_refine=1,
            warm_start="extrapolate", rtol=1e-4, **base)
        require(res["forms"]["mgz"] == problem.num_steps, res["forms"])
        require(max(res["peak_err_K"].values()) <= TRACE_TOL_K, res)
        runs.append(res)
    # (b) Chebyshev degree 3, plain float32, beside the unrefined r-line run
    # of the same tolerance, whose distance from the truth is the yardstick
    _, rl = _timed_transient(problem, device, "r-line, float32, rtol 1e-5",
                             precondition="rline", rtol=1e-5,
                             warm_start="extrapolate", **base)
    _, ch = _timed_transient(problem, device,
                             "Chebyshev degree 3, float32, rtol 1e-5",
                             vmem_cheb_degree=3, rtol=1e-5,
                             warm_start="extrapolate", **base)
    require(ch["forms"]["cheb"] == problem.num_steps, ch["forms"])
    floor = max(rl["peak_err_K"].values())
    require(max(ch["peak_err_K"].values()) <= 2.0 * floor + 0.1,
            ("Chebyshev trace error", ch["peak_err_K"], floor))
    cuda_cg.MERGED_DEFAULT = True
    try:
        _, chm = _timed_transient(
            problem, device, "Chebyshev degree 3, merged recurrence",
            vmem_cheb_degree=3, rtol=1e-5, warm_start="extrapolate", **base)
    finally:
        cuda_cg.MERGED_DEFAULT = False
    require(chm["forms"]["cheb"] == chm["forms"]["merged"]
            == problem.num_steps, chm["forms"])
    require(max(chm["peak_err_K"].values()) <= 2.0 * floor + 0.1,
            ("merged Chebyshev trace error", chm["peak_err_K"], floor))
    runs += [rl, ch, chm]
    # (c) the adaptive recipe, standard and merged, in turns
    pair = []
    for merged in (False, True, True, False):
        cuda_cg.MERGED_DEFAULT = merged
        try:
            _, res = _timed_transient(
                problem, device,
                f"adaptive recipe, {'merged' if merged else 'standard'} "
                f"recurrence", **RECIPE)
        finally:
            cuda_cg.MERGED_DEFAULT = False
        require(bool(res["forms"]["merged"]) == merged, res["forms"])
        require(max(res["peak_err_K"].values()) <= TRACE_TOL_K, res)
        pair.append(dict(res, merged=merged))
    runs += pair
    stall = _merged_stall(problem, device, pair[1])
    best = lambda m: max(r["steps_per_s"] for r in pair if r["merged"] == m)
    print(f"merged-dot on the adaptive recipe: best of two, standard "
          f"{best(False):.2f} steps/s, merged {best(True):.2f} steps/s "
          f"({100 * (best(True) / best(False) - 1):+.2f} %)")
    # K1's launches on this slice's paths, summed over the runs above, and
    # by the solve rows of phase 14
    k1_forms = {k: sum(r["forms"][k] for r in runs) for k in runs[0]["forms"]}
    merged_runs = [r for r in pair if r["merged"]]
    k1_rows = {"cheb3": ch["forms"]["cheb"],
               "merged_cheb3": chm["forms"]["merged"],
               "merged_rline": sum(r["forms"]["rline"] for r in merged_runs),
               "merged_adi": sum(r["forms"]["adi"] for r in merged_runs),
               "mgz1": runs[0]["forms"]["mgz"],
               "mgz2": runs[1]["forms"]["mgz"]}
    k1_phases = {k: sum(r["phase_launches"][k] for r in runs)
                 for k in runs[0]["phase_launches"]}

    # K2 with the merged recurrence: an adaptive refined sweep (B = 64) and
    # a recording sweep (B = 8: the Kv-free projection), each held to the
    # standard recurrence's traces at the solves' tolerance
    ks = np.logspace(0.0, 2.0, MERGED_B)
    fs = np.full(MERGED_B, sweep_problem.fwhm)
    kw = dict(ADI_RECIPES["adaptive"], solver="vmem", dtype=torch.float32,
              device=device, step_chunk=sweep_problem.num_steps)
    tr_std = run_sweep_time_chunked(sweep_problem, ks, fs, **kw)
    rec = make_sweep_fn_recording(sweep_problem, dtype=torch.float32,
                                  device=device, **REC_RECIPE)
    rec_std = rec(ks[::8], fs[::8])
    # the recording recipe stops at 1e-5 ||b||, where a trace sits some
    # tenths of a K to a few K from a tighter solve: that distance is the
    # yardstick for the merged recurrence, which stops elsewhere
    rec_tight = make_sweep_fn_recording(
        sweep_problem, dtype=torch.float32, device=device,
        **dict(REC_RECIPE, rtol=1e-7))(ks[::8], fs[::8])
    torch.cuda.synchronize()
    cuda_sweep.reset_counters()
    cuda_cg.MERGED_DEFAULT = True
    try:
        t0 = time.perf_counter()
        tr_m = run_sweep_time_chunked(sweep_problem, ks, fs, **kw)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        rec_m = rec(ks[::8], fs[::8])
        torch.cuda.synchronize()
    finally:
        cuda_cg.MERGED_DEFAULT = False
    k2 = _sweep_counts()
    k2["merged"] = cuda_sweep.cg_batched_tol.launches_merged
    d_sweep = float(np.abs(tr_m - tr_std).max())
    d_rec = float((rec_m["watch"] - rec_tight["watch"]).abs().max())
    d_rec_std = float((rec_std["watch"] - rec_tight["watch"]).abs().max())
    print(f"merged K2: adaptive refined sweep B = {MERGED_B} in "
          f"{sweep_s:.2f} s = {MERGED_B / sweep_s:.3f} configs/s, max |trace difference| from the "
          f"standard recurrence {d_sweep:.3e} K; recording B = 8: "
          f"merged {d_rec:.3e} K, standard {d_rec_std:.3e} K from the same "
          f"recording at rtol 1e-7; launches {k2}")
    require(np.isfinite(tr_m).all() and d_sweep <= 0.05
            and d_rec <= 2.0 * d_rec_std + 0.1,
            ("merged sweep traces", d_sweep, d_rec, d_rec_std))
    require(k2["merged"] > 0 and k2["phases"]["merged_w"] > 0
            and k2["phases"]["merged_w_no_kv"] > 0, k2)

    # the 2D CLI with --precondition mgz, against run_transient in-process
    work = os.path.join(ROOT, "build", "chip_smoke")
    cfg = load_config(CFG)
    cfg["heating"]["file"] = CSV
    cfg_path = os.path.join(work, "run2d_mgz.yaml")
    save_config(cfg, cfg_path)
    run_out = os.path.join(work, "run2d_mgz_out")
    t0 = time.perf_counter()
    run2d.main(["--config", cfg_path, "--mesh-folder",
                os.path.join(work, "run2d_mgz_mesh"), "--rebuild-mesh",
                "--output-folder", run_out, "--watcher-points", "auto",
                "--precondition", "mgz", "--device", str(device),
                "--suppress-print"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    cols = read_watcher_csv(os.path.join(run_out, "watcher_points.csv"))
    got = np.column_stack(list(cols.values()))
    res = run_transient(build_flagship(), dtype=torch.float32, device=device,
                        rtol=1e-4, maxiter=20000, record_gradient=True,
                        record_fields=False, solver="auto",
                        warm_start="extrapolate", precondition="mgz")
    require(np.array_equal(got[:, 1:].astype(np.float32), res.watcher),
            "run2d --precondition mgz: watcher_points.csv differs from "
            "run_transient")
    print(f"run2d CLI --precondition mgz: {cli_s:.2f} s; watcher_points.csv "
          f"equals run_transient bitwise; cg_iters mean "
          f"{res.cg_iters.mean():.2f}")
    out["forms_slice"] = dict(runs=runs, merged_stall=stall,
                              k1_forms=k1_forms,
                              k1_rows=k1_rows,
                              k1_phases=k1_phases, k2_launches=k2,
                              merged_sweep_s=sweep_s,
                              merged_sweep_diff_K=d_sweep,
                              merged_recording_diff_K=d_rec,
                              standard_recording_diff_K=d_rec_std,
                              run2d_mgz_cli_s=cli_s)
    return dict(k1_rows=k1_rows, k1_phases=k1_phases, k2=k2)


def run_mg_and_steady(problem, device, out: dict) -> None:
    """Phase 16: ``precondition='mg'`` on the card through the eager path,
    the steady solve and its field as the start of a transient, and the
    steady CLI."""
    import copy
    import numpy as np
    import torch
    from heatflow_tpu_torch.config import load_config, save_config
    from heatflow_tpu_torch.drivers import steady as steady_cli
    from heatflow_tpu_torch.sim.steady import (solve_steady,
                                               steady_heating_values)
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn

    mg_steps = 1     # ~12 s a step on an H100: the eager V-cycle of 7 levels
    short = copy.copy(problem)
    short.num_steps = mg_steps
    short.extras = {}
    fn = make_simulate_fn(short, dtype=torch.float32, device=device,
                          precondition="mg", rtol=1e-5, maxiter=2000,
                          record_gradient=False, solver="auto",
                          warm_start="extrapolate")
    require(not fn.use_vmem, "'mg' must resolve 'auto' to the eager path")
    t0 = time.perf_counter()
    ys = fn()
    torch.cuda.synchronize()
    mg_s = time.perf_counter() - t0
    iters = ys["cg_iters"].cpu().numpy()
    watch = ys["watch"].cpu().numpy()
    require(np.isfinite(watch).all() and int(iters.max()) < 2000,
            ("mg traces", iters))
    truth = np.load(TRUTH)["watch"][:mg_steps]
    peak = np.abs(watch - truth).max(axis=0)
    mg_levels = len(fn.mg)
    print(f"precondition='mg' (eager, float32, {mg_levels} levels): "
          f"{mg_steps} steps in {mg_s:.2f} s = {mg_steps / mg_s:.3f} "
          f"steps/s; cg_iters mean "
          f"{iters.mean():.2f} max {int(iters.max())}; peak |error| vs f64 "
          f"truth over these steps [K]: {np.round(peak, 4).tolist()}")

    amplitude = 2000.0      # the laser held at 2000 K on the heating line
    g = steady_heating_values(problem, amplitude=amplitude)
    t0 = time.perf_counter()
    u, info = solve_steady(problem, g, device=device)
    steady_s = time.perf_counter() - t0
    require(info["converged"] and np.isfinite(u).all(), info)
    dirich = problem.dirichlet_mask
    require(np.array_equal(u[dirich], g[dirich]), "steady Dirichlet values")
    require(u.min() >= g[dirich].min() - 1e-6
            and u.max() <= g[dirich].max() + 1e-6,
            ("steady maximum principle", u.min(), u.max()))
    print(f"solve_steady (adi, float64, rtol 1e-11): {info['iters']} "
          f"iterations, residual {info['residual']:.3e}, {steady_s:.2f} s; "
          f"T in [{u.min():.2f}, {u.max():.2f}] K")
    ten = copy.copy(problem)
    ten.num_steps = 10
    ten.extras = {}
    fn = make_simulate_fn(ten, dtype=torch.float32, device=device, **RECIPE)
    ys = fn(u0=u)
    torch.cuda.synchronize()
    w = ys["watch"].cpu().numpy()
    require(np.isfinite(w).all(), "transient from the steady field")
    print(f"transient from the steady field, 10 steps: watcher range "
          f"[{w.min():.2f}, {w.max():.2f}] K, cg_iters mean "
          f"{ys['cg_iters'].float().mean().item():.2f}")

    work = os.path.join(ROOT, "build", "chip_smoke")
    cfg = load_config(CFG)
    cfg["heating"]["file"] = CSV
    cfg_path = os.path.join(work, "steady.yaml")
    save_config(cfg, cfg_path)
    steady_out = os.path.join(work, "steady_out")
    t0 = time.perf_counter()
    steady_cli.main(["--config", cfg_path, "--mesh-folder",
                     os.path.join(work, "steady_mesh"), "--rebuild-mesh",
                     "--output-folder", steady_out, "--amplitude",
                     str(amplitude), "--no-xdmf", "--device", str(device)])
    cli_s = time.perf_counter() - t0
    field = np.load(os.path.join(steady_out, "steady_field.npy"))
    require(field.shape == u.shape and np.isfinite(field).all()
            and os.path.isfile(os.path.join(steady_out, "used_config.yaml")),
            "steady CLI artifacts")
    # the CLI runs float32 on a card, and a cold float32 solve of this
    # operator stalls ~1e-2 of the solution's size from the float64 one
    # (a constant 300 K field comes back within 3.8 K): held to 5 %
    d = float(np.abs(field - u).max())
    print(f"steady CLI (float32): {cli_s:.2f} s; steady_field.npy within "
          f"{d:.3e} K of the float64 solve (T up to {u.max():.1f} K)")
    require(d <= 0.05 * float(np.abs(u).max()), ("steady CLI field", d))
    out["mg_steady"] = dict(mg_steps=mg_steps,
                            mg_steps_per_s=mg_steps / mg_s,
                            mg_iters_mean=float(iters.mean()),
                            mg_levels=mg_levels,
                            steady_iters=info["iters"],
                            steady_residual=info["residual"],
                            steady_s=steady_s, steady_cli_s=cli_s,
                            steady_cli_diff_K=d)


K6_REPLACES = "heatflow_tpu/ops/pallas_mg.py:291"
K7_REPLACES = "heatflow_tpu/ops/pallas_cg.py:99"
TRUTH_RECORDING = os.path.join(ROOT, "benchmarks",
                               ".flagship_truth_recording.npz")
# phase 10: the recording run against the float64 recording truth, each
# family as a fraction of the truth's largest value. The raw axis rows are
# (u[:, 1] - u[:, 0]) / h_r at the finest cells, so they carry the solve's
# error times 1 / h_r: the float32 ADI run that the CLI makes reads 0.25
# there (watch 7.6e-4), and its bound only separates that floor from a wrong
# row, sign or scale, which reads 1 or more; watch and band follow the
# ladder of tests/test_recording_precondition.py. The run with two float64
# refinement passes takes the solve's error out and holds the rows
# themselves (it reads watch 4.9e-8, band 3.2e-4, axis 4.2e-2 on an NVIDIA
# H100 80GB HBM3 at 700 W).
RECORDING_TOL = dict(watch=1e-3, band=1e-2, axis=0.5)
REFINED_RECORDING_TOL = dict(watch=1e-6, band=1e-3, axis=0.1)
MG_LEVELS = 4
MG_STEPS = 10          # phase 18: steps of the flagship solved by K6
MG_LAUNCHES = 14       # phase 17: K6's launches an iteration, at most
K7_STEPS, K7_ITERS = 8, 1500   # the pulse reaches the watchers by step 5
ONE_D_CFG = os.path.join(ROOT, "cfgs", "geballe_1d.yaml")


def flagship_operator(problem):
    """The flagship's unscaled backward-Euler operator (7, Nz, Nr) and its
    free mask on the host, in float64."""
    import numpy as np
    st = problem.stencils
    A7 = (np.einsum("m,mkij->kij", problem.rho_cvs, st.M)
          + float(problem.dt) * np.einsum("m,mkij->kij", problem.kappas,
                                          st.K))
    return A7, np.asarray(problem.free_mask, np.float64)


def mg_cycle_ops(setup, nu: int, nu_coarse: int) -> float:
    """Float32 operations of one V-cycle, counted for what it computes: a
    stencil apply is 2 npts - 1 a point; a smoothing step from zero 3, with
    an iterate 2 npts + 6; a residual 2 npts; a restriction ~20 a coarse
    point and a prolongation ~10 a fine point."""
    shapes = setup["meta"]["shapes"]
    total = 0.0
    for l, (lv, (nz, nr)) in enumerate(zip(setup["levels"], shapes)):
        n, npts = nz * nr, lv["C"].shape[0]
        step = 2 * npts + 6
        if l == len(shapes) - 1:
            total += n * (3 + (nu_coarse - 1) * step)
            continue
        total += n * (3 + (2 * nu - 1) * step + 2 * npts + 10)
        total += 20 * shapes[l + 1][0] * shapes[l + 1][1]
    return total


def nine_plane_checks(problem, setup, device, out: dict) -> dict:
    """Phase 17a: K1 (identity, r-line, ADI) and K2 (8 lanes) on a 9-plane
    operator, the flagship hierarchy's level 1 (a Galerkin product: both
    anti-diagonal planes filled). The solves are driven once with the counts
    set to 0 just before (no ported entry point reaches a 9-plane operator
    before the unstructured path exists, so these driven solves are their
    path), then held against the plain versions."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_mg
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    from heatflow_tpu_torch.ops.stencil import apply_stencil

    A9 = setup["levels"][1]["C"]
    nz, nr = A9.shape[1:]
    n = nz * nr
    A7, free7 = flagship_operator(problem)
    # a second 9-plane operator for K2's lanes: the same level of the
    # hierarchy at four times the time step, minus the first, so that
    # A0 + dk Kv, dk in [0, 1], is a convex combination of the two
    st = problem.stencils
    A7b = A7 + 3.0 * float(problem.dt) * np.einsum(
        "m,mkij->kij", problem.kappas, st.K)
    other = cuda_mg.build_mg_setup(A7b, free7, problem.mesh.z,
                                   problem.mesh.r, n_levels=2, device=device)
    Kv = (other["levels"][1]["C"] - A9).contiguous()
    require(A9.shape[0] == 9 and Kv.shape == A9.shape
            and float(A9[7:].abs().max()) > 1e-3 * float(A9.abs().max()),
            "level 1 is not a filled 9-plane operator")
    rng = np.random.default_rng(17)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,
                                 device=device).contiguous()
    free = torch.ones((nz, nr), dtype=torch.float32, device=device)
    s = torch.rsqrt(torch.where(A9[0] > 0, A9[0], free))
    sm = (s * free).contiguous()
    x_true = f32(rng.standard_normal((nz, nr)))
    b = (sm * apply_stencil(A9, sm * x_true)).contiguous()
    b = (b / torch.linalg.vector_norm(b)).contiguous()
    x0 = torch.zeros_like(b)
    pcr = cuda_cg.rline_pack(A9, s, free)
    pcr_z = cuda_cg.zline_pack(A9, s, free)
    B = 8
    dks = f32(np.linspace(0.0, 1.0, B))
    diag = A9[0][None] + dks[:, None, None] * Kv[0][None]
    smb = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag))) \
        .contiguous()
    xb = f32(rng.standard_normal((B, nz, nr)))
    bb = torch.stack([smb[i] * apply_stencil(A9 + dks[i] * Kv, smb[i] * xb[i])
                      for i in range(B)]).contiguous()
    xb0 = torch.zeros_like(bb)
    rtol = 1e-6
    k1_forms = (("identity", {}), ("rline", {"pcr": pcr}),
                ("adi", {"pcr": pcr, "pcr_z": pcr_z}))
    k2_forms = (("identity", {}), ("rline", {"rline": True}),
                ("adi", {"adi": True}))
    k1 = lambda fn, kw: fn(A9, sm, b, x0, rtol, maxiter=20000, rtol_wrt="b",
                           **kw)
    k2 = lambda fn, kw, cast=lambda t: t: fn(
        *(cast(t) for t in (A9, Kv, dks, smb, bb, xb0)), rtol, maxiter=20000,
        rtol_wrt="b", **kw)

    # the driven solves, counted
    cuda_cg.reset_counters()
    cs.reset_counters()
    got1 = {form: k1(cuda_cg.cg_tol, kw) for form, kw in k1_forms}
    got2 = {form: k2(cs.cg_batched_tol, kw) for form, kw in k2_forms}
    torch.cuda.synchronize()
    counts = dict(k1={f: getattr(cuda_cg.cg_tol, f"launches_{f}")
                      for f, _ in k1_forms}, k2=_sweep_counts())
    require(all(v == 1 for v in counts["k1"].values())
            and all(counts["k2"][f] == 1 for f, _ in k2_forms), counts)

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rows = {}
    for form, kw in k1_forms:
        x_k, it_k = got1[form]
        x_p, it_p = k1(cuda_cg.cg_tol_reference, kw)
        x64, _ = cuda_cg.cg_tol_reference(
            A9.double(), sm.double(), b.double(), x0.double(), rtol,
            maxiter=20000, rtol_wrt="b",
            **{k: v.double() for k, v in kw.items()})
        it_k, it_p = int(it_k), int(it_p)
        rel_l2 = norm(x_k - x_p) / norm(x_p)
        err_k, err_p = norm(x_k - x64) / norm(x64), \
            norm(x_p - x64) / norm(x64)
        print(f"9-plane K1 {form} ({nz} x {nr}): iters kernel {it_k} plain "
              f"{it_p}; kernel vs plain rel-L2 {rel_l2:.3e}; vs float64 "
              f"kernel {err_k:.3e} plain {err_p:.3e}")
        require(abs(it_k - it_p) <= max(3, int(0.05 * it_p)),
                (form, it_k, it_p))
        require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, rel_l2, err_p))
        require(err_k <= max(1e-4, 1.5 * err_p), (form, err_k, err_p))
        rows[f"cg_tol[{form},9-plane]"] = dict(
            iters=it_k, plain_iters=it_p, rel_l2=rel_l2, err_vs_f64=err_k,
            plain_err_vs_f64=err_p, launches=counts["k1"][form],
            max_abs_err=float((x_k - x_p).abs().max()),
            ms=cuda_ms(lambda: k1(cuda_cg.cg_tol, kw), 3),
            plain_ms=cuda_ms(lambda: k1(cuda_cg.cg_tol_reference, kw), 1),
            iter_bound_ms=k1_iter_bound(it_k, nbytes(A9, sm, *kw.values()),
                                        nbytes(b)),
            **bound(nbytes(A9, sm, b, x0, b, *kw.values()),
                    it_k * n * (k1_iter_ops(bool(kw), "pcr_z" in kw) + 4)))
    d64 = lambda t: t.double()
    for form, kw in k2_forms:
        x_k, it_k = got2[form]
        x_p, it_p = k2(cs.cg_batched_tol_reference, kw)
        x64, _ = k2(cs.cg_batched_tol_reference, kw, d64)
        worst = dict(rel_l2=0.0, err_k=0.0, err_p=0.0)
        for i in range(B):
            rel_l2 = norm(x_k[i] - x_p[i]) / norm(x_p[i])
            err_k = norm(x_k[i] - x64[i]) / norm(x64[i])
            err_p = norm(x_p[i] - x64[i]) / norm(x64[i])
            ik, ip = int(it_k[i]), int(it_p[i])
            require(abs(ik - ip) <= max(3, int(0.05 * ip)), (form, i, ik, ip))
            require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, i, rel_l2,
                                                       err_p))
            require(err_k <= max(1e-4, 1.5 * err_p), (form, i, err_k, err_p))
            for key, v in (("rel_l2", rel_l2), ("err_k", err_k),
                           ("err_p", err_p)):
                worst[key] = max(worst[key], v)
        its = [int(i) for i in it_k.tolist()]
        print(f"9-plane K2 {form}, {B} lanes: iters kernel {its} plain "
              f"{[int(i) for i in it_p.tolist()]}; worst lane: kernel vs "
              f"plain rel-L2 {worst['rel_l2']:.3e}, vs float64 kernel "
              f"{worst['err_k']:.3e} plain {worst['err_p']:.3e}")
        rows[f"cg_batched_tol[{form},9-plane]"] = dict(
            iters=its, **worst, launches=counts["k2"][form],
            max_abs_err=float((x_k - x_p).abs().max()),
            ms=cuda_ms(lambda: k2(cs.cg_batched_tol, kw), 2),
            plain_ms=cuda_ms(lambda: k2(cs.cg_batched_tol_reference, kw), 1),
            iter_bound_ms=k2_iter_bound(its, A9, Kv, smb, bb),
            **k2_solve_bound(A9, Kv, dks, smb, bb, xb0, its,
                             k2_iter_ops("rline" in kw or "adi" in kw,
                                         "adi" in kw) + 8))
    out["nine_plane"] = rows
    return rows


def mg_checks(problem, setup, device, out: dict) -> dict:
    """Phase 17b-d: each phase kernel of the multigrid cycle alone against
    its plain version on the flagship plane and on level 1, the whole cycle
    and its symmetry, ``mgcg_vmem_tol`` on the first step's system at three
    tolerances, and ``cg_vmem`` on the baked flagship operator."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_mg
    from heatflow_tpu_torch.ops.stencil import apply_stencil

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    nz, nr = b32.shape
    pz, pr = setup["meta"]["padded"]
    require((pz, pr) == (nz, nr), "the flagship grid has odd sides")
    shapes = setup["meta"]["shapes"]
    print(f"multigrid levels {shapes}, Gershgorin bounds "
          f"{[round(v, 4) for v in setup['meta']['lmaxs']]}")
    rng = np.random.default_rng(171)
    field = lambda shape: torch.tensor(rng.standard_normal(tuple(shape)),
                                       dtype=torch.float32,
                                       device=device).contiguous()
    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rows = {}

    def distance(got, want):
        err = rel = 0.0
        for a, b_ in zip(got, want, strict=True):
            if b_ is None:
                continue
            d = float((a.double() - b_.double()).abs().max())
            err, rel = max(err, d), max(rel, d / float(b_.double().abs().max()))
        return err, rel

    def phase(name, counter, kernel, plain, moved, ops, tol=1e-5, reps=50):
        err, rel = distance(kernel(), plain())
        require(rel <= tol, (name, rel, tol))
        rows[name] = dict(name=name, phase=counter, max_abs_err=err, rel=rel,
                          ms=cuda_ms(kernel, reps),
                          plain_ms=cuda_ms(plain, 10), **bound(moved, ops))
        print(f"mg phase {name}: max|err| {err:.3e} (rel {rel:.3e}, bound "
              f"{tol:.0e}), kernel {rows[name]['ms']:.4f} ms, plain "
              f"{rows[name]['plain_ms']:.4f} ms")

    as_t = lambda v: v if isinstance(v, tuple) else (v,)
    for l in (0, 1):
        lv = setup["levels"][l]
        C, wz, wr = lv["C"], lv["wz"], lv["wr"]
        npts, shape = C.shape[0], shapes[l]
        n = shape[0] * shape[1]
        b, x, d = field(shape), field(shape), field(shape)
        mask = (field(shape) > -1.0).float().contiguous()
        theta, coefs = cuda_mg.cheb_coefficients(
            setup["meta"]["lmaxs"][l], 3, torch.float32)
        cases = (("first", (C, b, None, None, theta), {}, 3),
                 ("next", (C, b, x, d, theta, *coefs[1]),
                  dict(mask=mask, dot=b), 2 * npts + 9))
        for tag, args, kw, per in cases:
            ins = [t for t in (*args, *kw.values()) if torch.is_tensor(t)]
            phase(f"mgcg.cheb_step[{tag},L{l}]", "mg_cheb",
                  lambda: cuda_mg.mg_cheb_step(*args, **kw),
                  lambda: cuda_mg.mg_cheb_step_reference(*args, **kw),
                  nbytes(*ins, b, b) + 8, per * n)
        cshape = shapes[l + 1]
        xc = field(cshape)
        phase(f"mgcg.restrict_res[L{l}]", "mg_restrict_res",
              lambda: as_t(cuda_mg.mg_restrict_res(C, b, x, wz, wr, cshape)),
              lambda: as_t(cuda_mg.mg_restrict_res_reference(C, b, x, wz, wr,
                                                             cshape)),
              nbytes(C, b, x, wz, wr, xc), (2 * npts + 5) * n)
        pkw = dict(mask=mask, dot=b)
        phase(f"mgcg.prolong_cheb[L{l}]", "mg_prolong_cheb",
              lambda: cuda_mg.mg_prolong_cheb(C, b, x, xc, wz, wr, theta,
                                              **pkw),
              lambda: cuda_mg.mg_prolong_cheb_reference(C, b, x, xc, wz, wr,
                                                        theta, **pkw),
              nbytes(C, b, x, xc, wz, wr, mask, b, b, b) + 8,
              (2 * npts + 19) * n)
        if l == 0:
            p_, Ap_ = field(shape), field(shape)
            st = dict(alpha=0.37)
            phase("mgcg.cheb_update", "mg_cheb_update",
                  lambda: cuda_mg.mg_cheb_update(C, b, x, p_, Ap_, theta,
                                                 state=st),
                  lambda: cuda_mg.mg_cheb_update_reference(
                      C, b, x, p_, Ap_, st["alpha"], theta),
                  nbytes(C[0], b, x, p_, Ap_, x, b, b, b) + 8, 9 * n)

    # a level's first two smoothing steps in one pass (level 1, 2, 3: the
    # levels that start from zero without the CG update)
    lv1 = setup["levels"][1]
    theta, coefs = cuda_mg.cheb_coefficients(setup["meta"]["lmaxs"][1], 2,
                                             torch.float32)
    b1 = field(shapes[1])
    phase("mgcg.cheb_pre[L1]", "mg_cheb_pre",
          lambda: cuda_mg.mg_cheb_pre(lv1["C"], b1, theta, *coefs[0]),
          lambda: cuda_mg.mg_cheb_pre_reference(lv1["C"], b1, theta,
                                                *coefs[0]),
          nbytes(lv1["C"], b1, b1, b1) + nbytes(lv1["C"][0]),
          (2 * lv1["C"].shape[0] + 12) * b1.numel())
    # the coarsest level in one launch: its right-hand side from the level
    # above and its smoothing steps, each block a tile with a halo in shared
    # memory
    setup64 = {"A": setup["A"].double(), "sm": setup["sm"].double(),
               "levels": [{k: v.double() for k, v in lv.items()}
                          for lv in setup["levels"]], "meta": setup["meta"]}
    q = len(shapes) - 1
    bp, xp = field(shapes[q - 1]), field(shapes[q - 1])
    x_k = cuda_mg.mg_last(setup, bp, xp)
    x_p = cuda_mg.mg_last_reference(setup, bp, xp)
    x64 = cuda_mg.mg_last_reference(setup64, bp.double(), xp.double())
    err, rel = distance((x_k,), (x_p,))
    floor, rel64 = distance((x_p,), (x64,))[1], distance((x_k,), (x64,))[1]
    print(f"mg coarsest level {shapes[q]} in one launch: kernel vs plain "
          f"rel {rel:.3e}; vs float64 kernel {rel64:.3e}, plain {floor:.3e}")
    require(rel <= max(1e-5, 2.0 * floor) and rel64 <= max(1e-5, 1.5 * floor),
            ("mg coarsest level", rel, rel64, floor))
    sub = {"levels": setup["levels"][q:],
           "meta": dict(shapes=shapes[q:], lmaxs=setup["meta"]["lmaxs"][q:])}
    P = setup["levels"][q - 1]
    rows["mgcg.last"] = dict(
        name="mgcg.last", phase="mg_last", max_abs_err=err, rel=rel,
        ms=cuda_ms(lambda: cuda_mg.mg_last(setup, bp, xp), 20),
        plain_ms=cuda_ms(lambda: cuda_mg.mg_last_reference(setup, bp, xp),
                         3),
        **bound(nbytes(P["C"], P["wz"], P["wr"], bp, xp,
                       *sub["levels"][0].values(), x_k),
                mg_cycle_ops(sub, 2, 10)
                + (2 * P["C"].shape[0] + 5) * bp.numel()))
    print(f"mg coarsest level: kernel {rows['mgcg.last']['ms']:.4f} ms, "
          f"plain {rows['mgcg.last']['plain_ms']:.4f} ms")

    fmask = (setup["sm"] > 0).float()
    u, r = (field((pz, pr)) * fmask).contiguous(), \
        (field((pz, pr)) * fmask).contiguous()
    z_k, rz_k = cuda_mg.mg_vcycle(setup, r)
    z_p, rz_p = cuda_mg.mg_vcycle_reference(setup, r)
    z64, _ = cuda_mg.mg_vcycle_reference(setup64, r.double())
    err, rel = distance((z_k,), (z_p,))
    floor, rel64 = distance((z_p,), (z64,))[1], distance((z_k,), (z64,))[1]
    dot_rel = abs(float(rz_k - rz_p)) / abs(float(rz_p))
    print(f"mg V-cycle ({len(shapes)} levels, nu 2, nu_coarse 10): kernel "
          f"vs plain rel {rel:.3e}; vs float64 kernel {rel64:.3e}, plain "
          f"{floor:.3e}; <r, z> rel {dot_rel:.3e}")
    require(rel <= max(1e-4, 2.0 * floor) and rel64 <= max(1e-4, 1.5 * floor)
            and dot_rel <= max(1e-4, 2.0 * floor),
            ("V-cycle", rel, rel64, floor, dot_rel))
    Mu, _ = cuda_mg.mg_vcycle(setup, u)
    a = float((r.double() * Mu.double()).sum())
    b_ = float((u.double() * z_k.double()).sum())
    asym = abs(a - b_) / (norm(r) * norm(Mu))
    print(f"mg V-cycle symmetry: <v, Mu> {a:.6e}, <u, Mv> {b_:.6e}, "
          f"|difference| / (|v| |Mu|) {asym:.3e}")
    require(asym <= 1e-5, ("V-cycle asymmetry", asym))
    cycle_ops = mg_cycle_ops(setup, 2, 10)
    cycle_bytes = nbytes(*[lv[k] for lv in setup["levels"]
                           for k in ("C", "wz", "wr")], setup["sm"], r, r) + 8
    rows["mgcg.vcycle"] = dict(
        name="mgcg.vcycle", phase="mg_last", max_abs_err=err, rel=rel,
        asymmetry=asym, ms=cuda_ms(lambda: cuda_mg.mg_vcycle(setup, r), 20),
        plain_ms=cuda_ms(lambda: cuda_mg.mg_vcycle_reference(setup, r), 3),
        **bound(cycle_bytes, cycle_ops))
    print(f"mg V-cycle: kernel {rows['mgcg.vcycle']['ms']:.4f} ms, plain "
          f"{rows['mgcg.vcycle']['plain_ms']:.4f} ms")

    # the solve on the first step's system at three tolerances wrt r0,
    # against the float64 solution of the same system (the plain r-line
    # solve in float64 at rtol 1e-10 wrt ||b||); the plain float32 version
    # runs at 1e-3 and 1e-5, and the solve at 1e-6 (no plain run, no row of
    # the kernels line) is held between them
    x0 = torch.zeros_like(b32)
    t0 = time.perf_counter()
    pcr64 = cuda_cg.rline_pack_reference(A32.double(), s32.double(),
                                         free32.double())
    x64, it64 = cuda_cg.cg_tol_reference(
        A32.double(), sm32.double(), b32.double(), x0.double(), 1e-10,
        maxiter=20000, rtol_wrt="b", pcr=pcr64)
    torch.cuda.synchronize()
    print(f"float64 plain r-line solve at rtol 1e-10: {int(it64)} "
          f"iterations in {time.perf_counter() - t0:.2f} s")
    op64 = lambda y: (sm32.double()
                      * apply_stencil(A32.double(), sm32.double() * y))
    res64 = norm(b32.double() - op64(x64)) / norm(b32)
    require(int(it64) < 20000 and res64 <= 1e-8, ("float64 solve",
                                                  int(it64), res64))
    solves = {}
    n = nz * nr
    for rtol in (1e-3, 1e-5, 1e-6):
        cuda_cg.reset_counters()
        x_k, it_k = cuda_mg.mgcg_vmem_tol(setup, b32, x0, rtol)
        torch.cuda.synchronize()
        launches = cuda_cg.launches_per_iteration()["mg"]
        it_k = int(it_k)
        print(f"mgcg_vmem_tol rtol {rtol:g}: {launches:.2f} launches an "
              f"iteration (at most {MG_LAUNCHES})")
        require(launches <= MG_LAUNCHES, ("mgcg launches", rtol, launches))
        err_k = norm(x_k - x64) / norm(x64)
        res = norm(b32.double() - op64(x_k.double())) / norm(b32)
        ms = cuda_ms(lambda: cuda_mg.mgcg_vmem_tol(setup, b32, x0, rtol), 2)
        require(it_k < 2000, ("mgcg ran to maxiter", rtol))
        if rtol == 1e-6:
            # at least the 1e-5 solve's count, and no farther from float64
            # than the plain version at 1e-5
            at = solves["mgcg_vmem_tol[1e-05]"]
            print(f"mgcg_vmem_tol rtol 1e-06 wrt r0 (no plain run): iters "
                  f"kernel {it_k}; vs float64 kernel {err_k:.3e}, the plain "
                  f"version at 1e-5 {at['plain_err_vs_f64']:.3e}; true "
                  f"residual {res:.3e} x ||b||; kernel {ms:.3f} ms a solve, "
                  f"{1e3 * ms / it_k:.1f} us an iteration")
            require(it_k >= at["iters"]
                    and err_k <= max(1e-5, 1.5 * at["plain_err_vs_f64"]),
                    ("mgcg 1e-6", it_k, err_k, at["plain_err_vs_f64"]))
            out["mgcg_vmem_tol_1e-06"] = dict(
                iters=it_k, err_vs_f64=err_k, true_res_over_ref=res,
                launches_per_iter=launches, ms=ms)
            continue
        t0 = time.perf_counter()
        x_p, it_p = cuda_mg.mgcg_tol_reference(setup, b32, x0, rtol)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        it_p = int(it_p)
        rel_l2 = norm(x_k - x_p) / norm(x_p)
        err_p = norm(x_p - x64) / norm(x64)
        print(f"mgcg_vmem_tol rtol {rtol:g} wrt r0: iters kernel {it_k} "
              f"plain {it_p}; kernel vs plain rel-L2 {rel_l2:.3e}; vs "
              f"float64 kernel {err_k:.3e} plain {err_p:.3e}; true residual "
              f"{res:.3e} x ||b||; kernel {ms:.3f} ms a solve, "
              f"{1e3 * ms / max(it_k, 1):.1f} us an iteration; plain "
              f"{plain_ms:.1f} ms")
        require(abs(it_k - it_p) <= max(3, int(0.02 * it_p)),
                ("mgcg", rtol, it_k, it_p))
        require(rel_l2 <= max(1e-4, 2.0 * err_p) or rtol > 1e-5,
                ("mgcg", rtol, rel_l2, err_p))
        require(err_k <= max(rtol * 10, 1.5 * err_p), ("mgcg", rtol, err_k,
                                                       err_p))
        # each iteration's inputs (the operator and the levels' setup) read
        # once and x, r, p read and written once, times the iterations
        iter_ms = it_k * (nbytes(*cuda_mg.setup_tensors(setup))
                          + 6 * nbytes(b32)) / HBM_BYTES_PER_S * 1e3
        print(f"mgcg_vmem_tol rtol {rtol:g}: bound of the iterations "
              f"{iter_ms:.4f} ms (inputs once each)")
        solves[f"mgcg_vmem_tol[{rtol:g}]"] = dict(
            iters=it_k, plain_iters=it_p, rel_l2=rel_l2, err_vs_f64=err_k,
            plain_err_vs_f64=err_p, true_res_over_ref=res,
            launches_per_iter=launches, iter_bound_ms=iter_ms,
            max_abs_err=float((x_k - x_p).abs().max()), ms=ms,
            plain_ms=plain_ms,
            **bound(nbytes(*cuda_mg.setup_tensors(setup), b32, x0, b32),
                    (it_k + 1) * (cycle_ops + n * (17 + 6 + 2 + 3))))
    solves["float64"] = dict(iters=int(it64), true_res_over_ref=res64)

    # K7: 64 fixed iterations on the baked operator; the baked operator
    # against the on-the-fly form
    C, s_b = cuda_cg.masked_scaled_operator(A32, free32)
    C = C.contiguous()
    p = (field((nz, nr)) * free32).contiguous()
    baked = apply_stencil(C, p)
    onfly = sm32 * apply_stencil(A32, sm32 * p)
    d_op = float((baked - onfly).abs().max() / onfly.abs().max())
    d_s = float((s_b - s32).abs().max() / s32.abs().max())
    print(f"baked operator against sm A sm on a random free field: rel "
          f"{d_op:.3e}; its scaling against the stepper's: rel {d_s:.3e}")
    require(d_op <= 1e-5 and d_s <= 1e-6, ("baked operator", d_op, d_s))
    x_k = cuda_cg.cg_vmem(C, b32, x0, iters=64)
    x_p = cuda_cg.cg_vmem_reference(C, b32, x0, iters=64)
    x64_ = cuda_cg.cg_vmem_reference(C.double(), b32.double(), x0.double(),
                                     iters=64)
    rel_l2 = norm(x_k - x_p) / norm(x_p)
    err_k, err_p = norm(x_k - x64_) / norm(x64_), norm(x_p - x64_) / norm(x64_)
    print(f"cg_vmem 64 iterations: kernel vs plain rel-L2 {rel_l2:.3e}; vs "
          f"float64 kernel {err_k:.3e} plain {err_p:.3e}")
    require(rel_l2 <= max(1e-4, 2.0 * err_p)
            and err_k <= max(1e-4, 1.5 * err_p), ("cg_vmem", rel_l2, err_k,
                                                  err_p))
    solves["cg_vmem[64]"] = dict(
        iters=64, rel_l2=rel_l2, err_vs_f64=err_k, plain_err_vs_f64=err_p,
        max_abs_err=float((x_k - x_p).abs().max()),
        ms=cuda_ms(lambda: cuda_cg.cg_vmem(C, b32, x0, iters=64), 5),
        plain_ms=cuda_ms(lambda: cuda_cg.cg_vmem_reference(C, b32, x0,
                                                           iters=64), 2),
        iter_bound_ms=k1_iter_bound(64, nbytes(C), nbytes(b32)),
        **bound(nbytes(C, b32, x0, b32), 64 * n * (13 + 2 + 6 + 2)))
    print(f"cg_vmem 64 iterations: kernel {solves['cg_vmem[64]']['ms']:.3f} "
          f"ms, plain {solves['cg_vmem[64]']['plain_ms']:.3f} ms")
    out["mg_phases"] = rows
    out["mg_solves"] = solves
    return dict(phases=rows, solves=solves)


def _patched_transient(problem, device, steps: int, solver, **kw):
    """``steps`` steps of the flagship transient through
    ``make_simulate_fn``'s refined recipe through its eager loop (the
    stepper forms each step's right-hand side, seed and float64 residual),
    every inner float32 system handed to ``solver(A32, sm32, r32, seed,
    rtol)`` in place of ``cg_tol``:
    (watch (steps, W), iterations a step, seconds)."""
    import copy
    import functools
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    short = copy.copy(problem)
    short.num_steps = steps
    short.extras = {}
    kernel = cuda_cg.cg_tol

    @functools.wraps(kernel)
    def stand_in(A, sm, b, x0, rtol, **_kw):
        return solver(A, sm, b, x0, rtol)

    fn = make_simulate_fn(short, dtype=torch.float32, device=device,
                          record_gradient=False, record_fields=False,
                          solver="vmem", precondition="rline", f64_refine=1,
                          warm_start="previous", rtol_wrt="r0", maxiter=8000,
                          **kw)
    if solver is not None:
        cuda_cg.cg_tol = stand_in
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ys = fn.forward_eager()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        cuda_cg.cg_tol = kernel
    return ys["watch"].cpu().numpy(), ys["cg_iters"].cpu().numpy(), run_s


def run_mg_transient(problem, setup, device, out: dict) -> dict:
    """Phase 18: the paths that run K6 and K7 at full width. (a) The first
    steps of the flagship transient, every step's system solved by
    ``mgcg_vmem_tol`` at rtol 1e-5 in float32 inside one float64 residual
    pass, the traces held to the float64 truth, beside the r-line kernel on
    the same steps. (b) A few steps with every system solved by ``cg_vmem``
    on the baked operator (a fixed count, no stop test), against the same
    steps through its plain version."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_mg

    truth = np.load(TRUTH)["watch"]
    names = list(problem.watcher_names)
    mg_solver = lambda A, sm, b, x0, rtol: cuda_mg.mgcg_vmem_tol(
        setup, b, x0, rtol, maxiter=2000, rtol_wrt="r0")
    _patched_transient(problem, device, 2, mg_solver, rtol=1e-5)   # warm-up
    cuda_mg.reset_counters()
    watch, iters, run_s = _patched_transient(problem, device, MG_STEPS,
                                             mg_solver, rtol=1e-5)
    phases = cuda_cg.phase_launches()
    solves = cuda_mg.mgcg_vmem_tol.launches
    require(solves == MG_STEPS and cuda_cg.cg_tol.launches == 0,
            (solves, cuda_cg.cg_tol.launches))
    peak = np.abs(watch - truth[:MG_STEPS]).max(axis=0)
    _, it_rl, rl_s = _patched_transient(problem, device, MG_STEPS, None,
                                        rtol=1e-5)
    print(f"K6 path: {MG_STEPS} flagship steps by mgcg_vmem_tol "
          f"({len(setup['levels'])} levels, rtol 1e-5, one float64 pass) in "
          f"{run_s:.3f} s = {MG_STEPS / run_s:.2f} steps/s; iterations a "
          f"step {iters.tolist()} (mean {iters.mean():.1f}); the r-line "
          f"kernel on the same steps {it_rl.tolist()} (mean "
          f"{it_rl.mean():.1f}) in {rl_s:.3f} s; peak |error| vs f64 truth "
          f"[K]: " + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, peak)))
    require(np.isfinite(watch).all() and int(iters.max()) < 2000,
            ("K6 path", iters))
    require((peak <= TRACE_TOL_K).all(), f"K6 path trace error {peak} K")

    # (b) K7: the fixed-count solve on the baked operator
    baked = {}

    def k7(solve):
        def solver(A, sm, b, x0, rtol):
            if "C" not in baked:
                free = (sm != 0).to(A.dtype)
                baked["C"] = cuda_cg.masked_scaled_operator(A, free)[0] \
                    .contiguous()
            x = solve(baked["C"], b.contiguous(), x0, iters=K7_ITERS)
            return x, torch.tensor(K7_ITERS, dtype=torch.int32,
                                   device=b.device)
        return solver

    cuda_mg.reset_counters()
    w_k, _, k7_s = _patched_transient(problem, device, K7_STEPS,
                                      k7(cuda_cg.cg_vmem), rtol=1e-5)
    k7_phases = cuda_cg.phase_launches()
    k7_solves = cuda_cg.cg_vmem.launches
    require(k7_solves == K7_STEPS, k7_solves)
    w_p, _, k7_plain_s = _patched_transient(
        problem, device, K7_STEPS, k7(cuda_cg.cg_vmem_reference), rtol=1e-5)
    d_kp = float(np.abs(w_k - w_p).max())
    d_truth = np.abs(w_k - truth[:K7_STEPS]).max(axis=0)
    print(f"K7 path: {K7_STEPS} flagship steps by cg_vmem ({K7_ITERS} "
          f"iterations a step on the baked operator, one float64 pass) in "
          f"{k7_s:.3f} s (plain version {k7_plain_s:.2f} s); traces within "
          f"{d_kp:.3e} K of the plain version's, {np.round(d_truth, 4).tolist()}"
          f" K of the f64 truth")
    # 1500 unpreconditioned iterations do not converge a pulse step (the
    # identity form needs ~4000): the kernel is held to its plain version,
    # the distance from the truth only to a sane size
    require(np.isfinite(w_k).all() and d_kp <= 0.5
            and (d_truth <= 50.0).all(), ("K7 path", d_kp, d_truth))
    out["mg_transient"] = dict(
        steps=MG_STEPS, run_s=run_s, iters=iters.tolist(),
        rline_iters=it_rl.tolist(), rline_run_s=rl_s,
        peak_err_K=dict(zip(names, peak.tolist())), phase_launches=phases,
        solves=solves, k7_steps=K7_STEPS, k7_iters=K7_ITERS, k7_run_s=k7_s,
        k7_plain_run_s=k7_plain_s, k7_vs_plain_K=d_kp,
        k7_vs_truth_K=d_truth.tolist(), k7_solves=k7_solves)
    # a phase row reads its kernel's launches on the K6 path; K7's phases
    # are K1's own rows
    return dict(phases=phases, solves=solves, k7_solves=k7_solves,
                k7_phases=k7_phases)


def run_pipeline_1d(device, out: dict) -> None:
    """Phase 19: the 2D -> 1D pipeline at full width through the CLIs: the
    2D recording run, then the 1D reduced model on that run's gradient CSV
    with the correction on and off, on the card and on the CPU."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.config import load_config, save_config
    from heatflow_tpu_torch.drivers import run1d, run2d
    from heatflow_tpu_torch.io.csvio import read_gradient_csv, read_watcher_csv

    work = os.path.join(ROOT, "build", "chip_smoke", "pipeline")
    os.makedirs(work, exist_ok=True)
    paths = {}
    for tag, src in (("2d", FIT_CFG), ("1d", ONE_D_CFG)):
        cfg = load_config(src)
        cfg["heating"]["file"] = CSV
        paths[tag] = os.path.join(work, f"{tag}.yaml")
        save_config(cfg, paths[tag])
    mesh, out2d = os.path.join(work, "mesh"), os.path.join(work, "out2d")
    t0 = time.perf_counter()
    run2d.main(["--config", paths["2d"], "--mesh-folder", mesh,
                "--rebuild-mesh", "--output-folder", out2d,
                "--watcher-points", "auto", "--device", str(device),
                "--suppress-print"])
    torch.cuda.synchronize()
    run2d_s = time.perf_counter() - t0
    grad = os.path.join(out2d, "radial_gradient.csv")
    gt, gz, gv = read_gradient_csv(grad)
    require(gv.size and np.isfinite(gv).all() and np.abs(gv).max() > 0,
            "the 2D run's radial_gradient.csv")
    runs = {}
    for tag, dev in (("card", str(device)), ("cpu", "cpu")):
        for corr in (True, False):
            o = os.path.join(work, f"out1d_{tag}_{int(corr)}")
            t0 = time.perf_counter()
            run1d.main(["--config", paths["1d"], "--mesh-folder-2d", mesh,
                        "--output-folder", o, "--radial-gradient-path", grad,
                        "--device", dev, "--suppress-print"]
                       + ([] if corr else ["--no-radial-correction"]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            cols = read_watcher_csv(os.path.join(o, "watcher_points.csv"))
            require(list(cols) == ["time", "pside", "oside"], list(cols))
            runs[tag, corr] = (
                np.column_stack([cols["pside"], cols["oside"]]), secs)
    rel = {}
    for corr in (True, False):
        a, b = runs["card", corr][0], runs["cpu", corr][0]
        require(a.shape == b.shape and np.isfinite(a).all(), "1D traces")
        rel[corr] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        require(rel[corr] <= 1e-8, ("1D card vs CPU", corr, rel[corr]))
    d_corr = float(np.abs(runs["card", True][0]
                          - runs["card", False][0]).max())
    require(d_corr > 1e-6, "the radial correction changes nothing")
    w = runs["card", True][0]
    print(f"2D -> 1D pipeline: run2d CLI ({os.path.basename(FIT_CFG)}, "
          f"gradient recorded, {len(gt)} steps x {len(gz)} z-bins) "
          f"{run2d_s:.2f} s; run1d CLI ({os.path.basename(ONE_D_CFG)}, "
          f"float64) on the card {runs['card', True][1]:.2f} s corrected, "
          f"{runs['card', False][1]:.2f} s uncorrected; on the CPU "
          f"{runs['cpu', True][1]:.2f} s, {runs['cpu', False][1]:.2f} s; "
          f"card vs CPU rel-L2 {rel[True]:.3e} (corrected), {rel[False]:.3e} "
          f"(uncorrected); the correction moves the traces by up to "
          f"{d_corr:.3f} K; watcher range [{w.min():.2f}, {w.max():.2f}] K")
    out["pipeline_1d"] = dict(
        run2d_s=run2d_s, card_vs_cpu_rel_l2={str(k): v for k, v in rel.items()},
        correction_K=d_corr,
        run1d_s={f"{dev}_{'on' if c else 'off'}": secs
                 for (dev, c), (_, secs) in runs.items()})


# ----------------------------------------------------------------------
# Phase 20: the unstructured path (ROADMAP P9) at full width
# ----------------------------------------------------------------------

UTRUTH = os.path.join(ROOT, "benchmarks", ".flagship_truth_unstructured.npz")
U_SEED = 3             # benchmarks/bench_frontier.py's perturbation
U_RECIPE = dict(rtol=1e-4, maxiter=8000, record_gradient=False,
                record_fields=False, rtol_wrt="r0", solver="auto",
                precondition="rline", warm_start="extrapolate",
                f64_refine=1)
U_ADI_STEPS = 10
U_ELL_BUDGET_S = 30.0  # (c): full-width steps of the ELL path in ~30 s
# (c): the float64 ELL traces against the truth's first rows (the truth is
# the refine-2 f32 overlay run at 1e-4, within ~1e-5 K of float64)
U_ELL_TOL_K = 0.05
U_SWEEP_B, U_REC_B, U_FIXED_B, U_LANES = 256, 64, 8, 4
U_SWEEP_RECIPE = dict(solver="vmem", precondition="jacobi", rtol=1e-4,
                      rtol_wrt="b")
U_FIXED_ITERS = 120
# 20d: four lanes against single transients, both solved to this
U_CLOSE = dict(solver="vmem", precondition="jacobi", rtol=1e-5,
               rtol_wrt="r0", warm_start="extrapolate")
# 20f, 20g: the mesh without its overlay (an imported mesh) on the kernel
# path, the recipe of hfbench's msh_flagship.transient
U_ELL_RECIPE = dict(rtol=1e-4, maxiter=8000, record_gradient=False,
                    record_fields=False, rtol_wrt="r0", solver="vmem",
                    precondition="jacobi", warm_start="extrapolate",
                    f64_refine=1)


def build_unstructured(path: str = CFG):
    """The perturbed triangulation of a config's stack
    (``perturb_structured_mesh(build_structured_mesh(...), jitter=0.25,
    seed=3)``, as ``benchmarks/bench_frontier.py:41-90`` builds it) and its
    problem through the port's entry points; the host seconds of the
    generation, of ``build_problem_unstructured`` (``assemble_ell`` and the
    masks) and of ``ell_to_stencils``."""
    from heatflow_tpu_torch import (build_layout, build_structured_mesh,
                                    load_config)
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.mesh.unstructured_gen import \
        perturb_structured_mesh
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.unstructured import (
        _overlay_prep, build_problem_unstructured)
    t0 = time.perf_counter()
    cfg = load_config(path)
    domain, mats = build_layout(cfg)
    umesh = perturb_structured_mesh(build_structured_mesh(domain, mats),
                                    jitter=0.25, seed=U_SEED)
    t1 = time.perf_counter()
    problem = build_problem_unstructured(
        umesh, HeatingCurve.from_csv(CSV), cfg,
        watcher_points=coupler_watcher_points(cfg))
    t2 = time.perf_counter()
    _overlay_prep(problem)              # ell_to_stencils, cached
    t3 = time.perf_counter()
    return problem, dict(generate_s=t1 - t0, assemble_s=t2 - t1,
                         stencils_s=t3 - t2)


def _cut(problem, **kw):
    """The problem with fields replaced (``num_steps``, ``mesh``), its
    cached lattice stencils and locality order kept unless the mesh
    changes."""
    import dataclasses
    keep = {} if "mesh" in kw else {
        k: v for k, v in problem.extras.items()
        if k in ("_overlay_stencils", "_ell_order")}
    return dataclasses.replace(problem, extras=keep, **kw)


def _bare(problem):
    """The problem on its mesh with the grid overlay dropped: what the port
    sees of an imported mesh (the same nodes, cells and ELL operators)."""
    from heatflow_tpu_torch.mesh.msh_io import UnstructuredMesh
    m = problem.mesh
    return _cut(problem, mesh=UnstructuredMesh(
        nodes=m.nodes, cells=m.cells, cell_tags=m.cell_tags,
        material_tags=dict(m.material_tags)))


def _k1_solves() -> dict:
    from heatflow_tpu_torch.ops import cuda_cg
    # the solves' own graphs, and the solves recorded into transients'
    # graphs (their loop bodies as CHECK_EVERY iterations each)
    runs = sum(int(g.runs.item()) for ws in cuda_cg._workspaces.values()
               for g in ws.graphs.values()) + sum(
        its for _, its in cuda_cg._recorded_runs.values()) \
        // cuda_cg.CHECK_EVERY
    return dict(solves=cuda_cg.cg_tol.launches,
                rline=cuda_cg.cg_tol.launches_rline,
                adi=cuda_cg.cg_tol.launches_adi,
                identity=cuda_cg.cg_tol.launches_identity,
                ell=cuda_cg.cg_tol.launches_ell,
                graph_body_runs=runs,
                phases=cuda_cg.phase_launches(),
                per_iteration=cuda_cg.launches_per_iteration())


def run_unstructured_flagship(problem, device, out: dict) -> dict:
    """Phase 20a-c: the unstructured flagship through
    ``make_simulate_fn_unstructured`` on the overlay kernel path (r-line,
    100 steps; ADI, 10 steps) and on the ELL eager path (float64)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.unstructured import \
        make_simulate_fn_unstructured

    truth = np.load(UTRUTH)["watch"]
    names = list(problem.watcher_names)
    res = {}
    # (a) the flagship recipe: a warm-up run (graph captures), then the run
    fn = make_simulate_fn_unstructured(problem, dtype=torch.float32,
                                       device=device, **U_RECIPE)
    require(fn.use_vmem and fn.overlay, "the overlay kernel path")
    fn()
    torch.cuda.synchronize()
    cuda_cg.reset_counters()
    t0 = time.perf_counter()
    ys = fn()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k1 = _k1_solves()
    watch = ys["watch"].cpu().numpy()
    iters = ys["cg_iters"].cpu().numpy()
    require(watch.shape == truth.shape and np.isfinite(watch).all(),
            ("unstructured traces", watch.shape))
    peak = np.abs(watch - truth).max(axis=0)
    # the structured r-line's launches an iteration (phase 4), else its
    # count since p is formed in the stencil pass
    want = out.get("slice", {}).get("launches_per_iteration", {}).get(
        "rline", 2.0)
    print(f"20a unstructured flagship ({len(problem.mesh.nodes)} nodes, "
          f"{len(problem.mesh.cells)} triangles, 9-plane lattice "
          f"{problem.mesh.grid_overlay['shape']}): {problem.num_steps} steps "
          f"in {run_s:.4f} s = {problem.num_steps / run_s:.2f} steps/s; "
          f"iterations a step mean {iters.mean():.2f} max {int(iters.max())};"
          f" K1 solves {k1['solves']} (graph launches; r-line "
          f"{k1['rline']}), {sum(k1['phases'].values())} kernel launches, "
          f"{k1['graph_body_runs']} loop-body runs, launches an iteration "
          f"{k1['per_iteration']} (structured r-line {want})")
    print("20a peak |error| vs .flagship_truth_unstructured.npz [K]: "
          + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, peak)))
    require((peak <= TRACE_TOL_K).all(), ("unstructured error", peak))
    require(k1["rline"] == problem.num_steps and k1["identity"] == 0, k1)
    require(k1["per_iteration"].get("rline") == want,
            ("r-line launches an iteration", k1["per_iteration"], want))
    res["flagship"] = dict(run_s=run_s,
                           steps_per_s=problem.num_steps / run_s,
                           cg_iters_mean=float(iters.mean()),
                           peak_err_K=dict(zip(names, peak.tolist())),
                           k1=k1)

    # (b) the ADI form, the first steps
    p_adi = _cut(problem, num_steps=U_ADI_STEPS)
    fa = make_simulate_fn_unstructured(p_adi, dtype=torch.float32,
                                       device=device,
                                       **dict(U_RECIPE, precondition="adi"))
    cuda_cg.reset_counters()
    t0 = time.perf_counter()
    ya = fa()
    torch.cuda.synchronize()
    adi_s = time.perf_counter() - t0
    k1a = _k1_solves()
    wa = ya["watch"].cpu().numpy()
    d_adi = float(np.abs(wa - watch[:U_ADI_STEPS]).max())
    e_adi = float(np.abs(wa - truth[:U_ADI_STEPS]).max())
    print(f"20b ADI form, {U_ADI_STEPS} steps: {adi_s:.3f} s (graph "
          f"captures included), iterations a step "
          f"{ya['cg_iters'].cpu().numpy().tolist()}, K1 ADI solves "
          f"{k1a['adi']}; max |ADI - r-line| {d_adi:.3e} K, vs truth "
          f"{e_adi:.3e} K")
    require(k1a["adi"] == U_ADI_STEPS and d_adi <= TRACE_TOL_K
            and e_adi <= TRACE_TOL_K, ("ADI form", d_adi, e_adi, k1a))
    res["adi"] = dict(run_s=adi_s, max_vs_rline_K=d_adi,
                      max_vs_truth_K=e_adi, k1=k1a)

    # (c) the ELL eager path on the same mesh, the overlay dropped: as many
    # full-width float64 steps as fit in the budget, each step a call from
    # the previous step's field
    fe = make_simulate_fn_unstructured(
        _cut(_bare(problem), num_steps=1), dtype=torch.float64,
        device=device, rtol=1e-11, maxiter=20000, record_gradient=False,
        precondition="jacobi", solver="auto")
    require(not fe.use_vmem and not fe.overlay, "the ELL eager path")
    u, rows, its = None, [], []
    t0 = time.perf_counter()
    while (time.perf_counter() - t0 < U_ELL_BUDGET_S
           and len(rows) < problem.num_steps):
        ye = fe(u0=u, t0=len(rows) * problem.dt)
        u = ye["final_u"]
        rows.append(ye["watch"][0].cpu().numpy())
        its.append(int(ye["cg_iters"][0]))
    ell_s = time.perf_counter() - t0
    we = np.asarray(rows)
    n_ell = len(rows)
    e_truth = np.abs(we - truth[:n_ell]).max(axis=0)
    e_ov = np.abs(we - watch[:n_ell]).max(axis=0)
    print(f"20c ELL eager path (float64, Jacobi, rtol 1e-11): {n_ell} steps "
          f"in {ell_s:.2f} s, iterations {its}; max |ELL - truth| "
          f"{e_truth.tolist()} K, |ELL - overlay run| {e_ov.tolist()} K")
    require(n_ell >= 2 and np.isfinite(we).all(), ("ELL steps", n_ell))
    require((e_truth <= U_ELL_TOL_K).all(), ("ELL vs truth", e_truth))
    require((e_ov <= TRACE_TOL_K).all(), ("ELL vs overlay", e_ov))
    res["ell"] = dict(steps=n_ell, run_s=ell_s, iters=its,
                      max_vs_truth_K=e_truth.tolist(),
                      max_vs_overlay_K=e_ov.tolist())
    out["unstructured"] = res
    return res


def run_unstructured_ell(problem, device, out: dict) -> dict:
    """Phase 20g: the unstructured flagship with its overlay dropped (what
    the port sees of an imported mesh) through
    ``make_simulate_fn_unstructured`` on the kernel path, the recipe of
    hfbench's msh_flagship.transient: a transient is one graph launch, its
    solves one a step and 2 K1 launches an iteration by the device's counts
    (counters reset just before the timed run; a ``cg_tol`` call beside the
    graph would count more solves), its traces against the truth."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_step
    from heatflow_tpu_torch.sim.unstructured import \
        make_simulate_fn_unstructured

    truth = np.load(UTRUTH)["watch"]
    names = list(problem.watcher_names)
    fn = make_simulate_fn_unstructured(_bare(problem), dtype=torch.float32,
                                       device=device, **U_ELL_RECIPE)
    require(fn.use_vmem and not fn.overlay and fn.reordered,
            "the ELL kernel path")
    fn()                                # the graph's capture
    torch.cuda.synchronize()
    cuda_cg.reset_counters()
    cuda_step.reset_counters()
    ys = {}
    t0 = time.perf_counter()
    graphs = _capture(cuda_step, "launch", lambda: ys.update(fn()))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    k1 = _k1_solves()
    steps = problem.num_steps
    watch = ys["watch"].cpu().numpy()
    iters = ys["cg_iters"].cpu().numpy()
    peak = np.abs(watch - truth).max(axis=0)
    passes = k1["phases"]["stencil_dot"]
    print(f"20g ELL kernel path ({len(problem.mesh.nodes)} nodes, "
          f"{tuple(fn.form.cols.shape)} ELL rows, reverse Cuthill-McKee "
          f"order): {steps} steps in {run_s:.4f} s = {steps / run_s:.2f} "
          f"steps/s, {len(graphs)} graph launch; iterations a step mean "
          f"{iters.mean():.2f} max {int(iters.max())}; K1 ELL solves "
          f"{k1['ell']}, "
          f"{sum(k1['phases'].values())} kernel launches ({passes} "
          f"k_ell_dot), launches an iteration {k1['per_iteration']}; step "
          f"prologues {cuda_step.step_prologue.launches}")
    print("20g peak |error| vs .flagship_truth_unstructured.npz [K]: "
          + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, peak)))
    require(len(graphs) == 1, ("one graph launch", len(graphs)))
    require(k1["ell"] == k1["solves"] == steps
            and cuda_step.step_prologue.launches == steps, k1)
    require(k1["per_iteration"] == {"ell": 2.0}
            and cuda_cg.graph_stats()["ell"]["launches_per_iteration"]
            == 2.0, ("ELL launches an iteration", k1["per_iteration"]))
    require(watch.shape == truth.shape and (peak <= TRACE_TOL_K).all(),
            ("ELL traces vs truth", peak))
    res = dict(run_s=run_s, steps_per_s=steps / run_s,
               cg_iters_mean=float(iters.mean()),
               peak_err_K=dict(zip(names, peak.tolist())), k1=k1,
               ell_dot_launches=passes, graph_launches=len(graphs))
    out.setdefault("unstructured", {})["ell_graph"] = res
    return res


def run_unstructured_sweeps(problem, device, out: dict) -> dict:
    """Phase 20d: sweeps on the unstructured sweep mesh through
    ``make_sweep_fn_unstructured(solver='vmem')``: K2's identity form (B =
    256) with four lanes again at B = 4 (bitwise) and against the single
    transient on the kernel path (K1); the r-line recording (B = 64, K2's
    r-line and Kv-free forms); K3 (``fixed_iters``, B = 8)."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_sweep as cs
    from heatflow_tpu_torch.sim.unstructured import (
        make_simulate_fn_unstructured, make_sweep_fn_unstructured)

    res = {}
    ks = np.logspace(0.0, 2.0, U_SWEEP_B)
    fs = np.full(U_SWEEP_B, problem.fwhm)
    fn = make_sweep_fn_unstructured(problem, dtype=torch.float32,
                                    device=device, **U_SWEEP_RECIPE)
    cs.reset_counters()
    t0 = time.perf_counter()
    tr = fn(ks, fs)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    counts = _sweep_counts()
    tr = tr.cpu().numpy()
    require(np.isfinite(tr).all(), "non-finite sweep lanes")
    lanes = np.linspace(0, U_SWEEP_B - 1, U_LANES).astype(int)
    small = fn(ks[lanes], fs[lanes]).cpu().numpy()
    bitwise = bool(np.array_equal(small, tr[lanes]))
    # the same lanes as single transients on the kernel path (K1, identity)
    # against a B = 4 sweep, both to U_CLOSE: at the sweep's own rtol 1e-4
    # wrt ||b|| two float32 solvers stop ~10 K apart (11.4 K on an H100)
    close = make_sweep_fn_unstructured(problem, dtype=torch.float32,
                                       device=device, **U_CLOSE)
    pair = close(ks[lanes], fs[lanes]).cpu().numpy()
    single = make_simulate_fn_unstructured(
        problem, dtype=torch.float32, device=device, record_gradient=False,
        maxiter=8000, **U_CLOSE)
    m_idx = [nm for nm, _ in sorted(problem.mesh.material_tags.items(),
                                    key=lambda kv: kv[1])].index("p_sample")
    cuda_cg.reset_counters()
    d_single = 0.0
    for j, i in enumerate(lanes):
        kp = np.array(problem.kappas, float)
        kp[m_idx] = ks[i]
        one = single(kappas=kp, fwhm=fs[i])["watch"].cpu().numpy()
        d_single = max(d_single, float(np.abs(one - pair[j]).max()))
    k1 = _k1_solves()
    cfg_s = U_SWEEP_B / sweep_s
    print(f"20d unstructured sweep ({problem.mesh.grid_overlay['shape']} "
          f"lattice, {problem.num_steps} steps, B = {U_SWEEP_B}, Jacobi, "
          f"rtol 1e-4 wrt b): {sweep_s:.3f} s = {cfg_s:.2f} configs/s; "
          f"lanes {lanes.tolist()} at B = {U_LANES} bitwise: {bitwise}; at "
          f"rtol 1e-5 wrt r0, max |lane - single transient (K1 identity, "
          f"{k1['identity']} solves)| {d_single:.3e} K; K2 {counts}")
    require(bitwise, "B = 4 lanes differ from the B = 256 lanes")
    require(d_single <= TRACE_TOL_K, ("sweep lane vs single", d_single))
    require(k1["identity"] == U_LANES * problem.num_steps, k1)
    res["sweep"] = dict(run_s=sweep_s, configs_per_s=cfg_s,
                        bitwise_b4=bitwise, max_vs_single_K=d_single,
                        k2=counts, k1_identity=k1)

    # the recording sweep, r-line (K2 r-line + the Kv-free projection)
    rec = make_sweep_fn_unstructured(
        problem, dtype=torch.float32, device=device, solver="vmem",
        precondition="rline", rtol=1e-5, warm_start="extrapolate",
        record_gradient=True)
    rk, rf = ks[:: U_SWEEP_B // U_REC_B], fs[:U_REC_B]
    cs.reset_counters()
    t0 = time.perf_counter()
    ry = rec(rk, rf)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    rcounts = _sweep_counts()
    finite = all(bool(torch.isfinite(ry[k]).all())
                 for k in ("watch", "band", "axis"))
    print(f"20d recording sweep (B = {U_REC_B}, r-line, rtol 1e-5): "
          f"{rec_s:.3f} s = {U_REC_B / rec_s:.2f} configs/s; finite "
          f"{finite}; K2 r-line solves {rcounts['rline']}, Kv-free "
          f"{rcounts['no_kv']}")
    require(finite and rcounts["rline"] > 0 and rcounts["no_kv"] > 0,
            ("recording sweep", finite, rcounts))
    res["recording"] = dict(run_s=rec_s, configs_per_s=U_REC_B / rec_s,
                            k2=rcounts)

    # K3: a fixed iteration count
    fx = make_sweep_fn_unstructured(
        problem, dtype=torch.float32, device=device, solver="vmem",
        fixed_iters=U_FIXED_ITERS)
    cs.reset_counters()
    t0 = time.perf_counter()
    fy = fx(ks[:: U_SWEEP_B // U_FIXED_B], fs[:U_FIXED_B]).cpu().numpy()
    torch.cuda.synchronize()
    fixed_s = time.perf_counter() - t0
    fcounts = _sweep_counts()
    print(f"20d fixed_iters={U_FIXED_ITERS} sweep (B = {U_FIXED_B}): "
          f"{fixed_s:.3f} s, finite {bool(np.isfinite(fy).all())}, K3 "
          f"solves {fcounts['fixed']}")
    require(np.isfinite(fy).all() and fcounts["fixed"] == problem.num_steps,
            ("fixed sweep", fcounts))
    res["fixed"] = dict(run_s=fixed_s, k3=fcounts)
    out.setdefault("unstructured", {}).update(res)
    return res


def run_unstructured_clis(device, out: dict) -> dict:
    """Phase 20e: the CLIs on the card: ``run2d --mesh-style unstructured
    --rebuild-mesh`` (the overlay kernel path), ``run2d`` on the same folder
    without its sidecar (an imported mesh: the ELL path, the step count cut
    to 10 at the same dt), and ``sweep`` over an unstructured mesh folder
    (``--num-points 2 2 1``)."""
    import csv
    import shutil
    import numpy as np
    import torch
    from heatflow_tpu_torch.config import (load_config, save_config,
                                           with_parameters)
    from heatflow_tpu_torch.drivers import run2d, sweep
    from heatflow_tpu_torch.drivers.sweep import mesh_folder_for_width
    from heatflow_tpu_torch.io.csvio import read_watcher_csv

    work = os.path.join(ROOT, "build", "chip_smoke", "unstructured")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = load_config(CFG)
    cfg["heating"]["file"] = CSV
    paths = {"run2d": os.path.join(work, "run2d.yaml"),
             "ell": os.path.join(work, "ell.yaml"),
             "sweep": os.path.join(work, "sweep.yaml")}
    save_config(cfg, paths["run2d"])
    short = load_config(paths["run2d"])
    dt = float(short["timing"]["t_final"]) / int(short["timing"]["num_steps"])
    short["timing"]["num_steps"] = 10
    short["timing"]["t_final"] = 10 * dt
    save_config(short, paths["ell"])
    res = {}

    def run(tag, argv):
        t0 = time.perf_counter()
        run2d.main(argv + ["--device", str(device), "--suppress-print",
                           "--watcher-points", "auto"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        o = argv[argv.index("--output-folder") + 1]
        w = read_watcher_csv(os.path.join(o, "watcher_points.csv"))
        v = np.column_stack([w["pside"], w["oside"]])
        require(np.isfinite(v).all() and os.path.isfile(
            os.path.join(o, "radial_gradient.csv")), (tag, "CSVs"))
        res[tag] = dict(wall_s=secs, steps=len(v),
                        oside_max_K=float(v[:, 1].max()))
        return v

    mesh = os.path.join(work, "mesh")
    v_ov = run("run2d_overlay", ["--config", paths["run2d"], "--mesh-folder",
                                 mesh, "--rebuild-mesh", "--mesh-style",
                                 "unstructured", "--output-folder",
                                 os.path.join(work, "out_overlay")])
    require(os.path.isfile(os.path.join(mesh, "mesh_overlay.npz")),
            "the overlay sidecar")
    os.remove(os.path.join(mesh, "mesh_overlay.npz"))
    v_ell = run("run2d_ell", ["--config", paths["ell"], "--mesh-folder",
                              mesh, "--output-folder",
                              os.path.join(work, "out_ell")])
    d = float(np.abs(v_ell - v_ov[:10]).max())
    require(d <= TRACE_TOL_K, ("ELL CLI vs overlay CLI", d))
    res["run2d_ell"]["max_vs_overlay_K"] = d

    # the sweep over an unstructured width folder (the config's own width)
    scfg = load_config(SWEEP_CFG)
    scfg["heating"]["file"] = CSV
    save_config(scfg, paths["sweep"])
    width = float(scfg["mats"]["p_sample"]["z"])
    base = os.path.join(work, "sweep_meshes")
    run2d._prepare_mesh(with_parameters(scfg, sample_z=width),
                        mesh_folder_for_width(base, width), True, "auto",
                        "unstructured")
    sweep_out = os.path.join(work, "sweep_out")
    t0 = time.perf_counter()
    sweep.main(["--config", paths["sweep"], "--output-dir", sweep_out,
                "--mesh-folder", base, "--num-points", "2", "2", "1",
                "--width-range", str(width), str(width),
                "--device", str(device)])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    with open(os.path.join(sweep_out, "successful_runs.csv")) as f:
        ok_runs = list(csv.DictReader(f))
    meta = json.load(open(os.path.join(sweep_out, "sweep_metadata.json")))
    require(len(ok_runs) == 4 and set(meta["solver_resolved"].values())
            == {"vmem"}, ("unstructured sweep CLI", len(ok_runs), meta))
    for rec in ok_runs:
        require(os.path.isfile(os.path.join(sweep_out, rec["run_name"],
                                            "watcher_points.csv")),
                rec["run_name"])
    res["sweep_cli"] = dict(wall_s=sweep_s, runs=len(ok_runs))
    print("20e CLIs: " + "; ".join(
        f"{k} {v['wall_s']:.2f} s" for k, v in res.items())
        + f"; ELL CLI vs overlay CLI (10 steps) max {d:.3e} K")
    out.setdefault("unstructured", {})["clis"] = res
    return res


def unstructured_kernel_checks(problem, sweep_problem, device,
                               out: dict) -> dict:
    """Phase 20f: K1 (identity, r-line, ADI), K2 (identity, r-line,
    Kv-free) and K3 on the 9-plane lattice operators of this path, at its
    shapes, against their plain versions: K1 on the unstructured flagship's
    first-step refinement system (read off the kernel's arguments), K2 and
    K3 on 8 lanes of the unstructured sweep's 10th step (and of its
    recording's 10th projection); K1's ELL form, its pass and the step
    kernels' ELL products on the flagship mesh without its overlay."""
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg, cuda_step, cuda_sweep as cs
    from heatflow_tpu_torch.sim.unstructured import (
        make_simulate_fn_unstructured, make_sweep_fn_unstructured)

    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    rows = {}
    rtol = 1e-6

    def once(fn):
        """(fn(), its milliseconds by CUDA events): one run of a plain
        version, which takes seconds at these shapes."""
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn()
        stop.record()
        torch.cuda.synchronize()
        return got, start.elapsed_time(stop)

    def hold(name, x_k, x_p, x64, it_k=None, it_p=None):
        """Kernel within 1e-4 rel-L2 of plain (or 2x plain float32's own
        distance from float64), counts within max(3, 5 %)."""
        rel_l2 = norm(x_k - x_p) / norm(x_p)
        err_k, err_p = norm(x_k - x64) / norm(x64), norm(x_p - x64) / norm(x64)
        require(rel_l2 <= max(1e-4, 2.0 * err_p), (name, rel_l2, err_p))
        require(err_k <= max(1e-4, 1.5 * err_p), (name, err_k, err_p))
        if it_k is not None:
            for ik, ip in zip(np.atleast_1d(it_k.cpu().numpy()),
                              np.atleast_1d(it_p.cpu().numpy())):
                require(abs(int(ik) - int(ip)) <= max(3, int(0.05 * ip)),
                        (name, int(ik), int(ip)))
        return dict(rel_l2=rel_l2, err_vs_f64=err_k, plain_err_vs_f64=err_p,
                    max_abs_err=float((x_k - x_p).abs().max()))

    # K1: the first step's inner system of the flagship recipe
    fn1 = make_simulate_fn_unstructured(
        _cut(problem, num_steps=1), dtype=torch.float32, device=device,
        **dict(U_RECIPE, precondition="adi"))
    # read off the eager step loop, which calls cg_tol a solve (the call's
    # own path, the transient's graph, records K1 and calls no wrapper)
    fn1._run = fn1._run_eager
    args, kw = _capture(cuda_cg, "cg_tol", fn1)[0]
    A9, sm, b, x0 = (t.contiguous() for t in args[:4])
    pcr, pcr_z = kw["pcr"], kw["pcr_z"]
    nz, nr = b.shape
    n = nz * nr
    require(A9.shape[0] == 9, "the unstructured operator has 9 planes")
    # the identity form at the tolerance its path (20d's single transients)
    # solves to: its plain version at 1e-6 takes thousands of iterations
    for form, fkw, tol in (("identity", {}, 1e-4),
                           ("rline", {"pcr": pcr}, rtol),
                           ("adi", {"pcr": pcr, "pcr_z": pcr_z}, rtol)):
        k1 = lambda f, cast=lambda t: t: f(
            cast(A9), cast(sm), cast(b), cast(x0), tol, maxiter=20000,
            rtol_wrt="b", **{k: cast(v) for k, v in fkw.items()})
        x_k, it_k = k1(cuda_cg.cg_tol)
        (x_p, it_p), plain_ms = once(lambda: k1(cuda_cg.cg_tol_reference))
        x64, _ = k1(cuda_cg.cg_tol_reference, lambda t: t.double())
        r = hold(f"K1 {form}", x_k, x_p, x64, it_k, it_p)
        its = int(it_k)
        rows[f"cg_tol[{form},unstructured]"] = dict(
            iters=its, plain_iters=int(it_p), rtol=tol, **r,
            ms=cuda_ms(lambda: k1(cuda_cg.cg_tol), 3), plain_ms=plain_ms,
            iter_bound_ms=k1_iter_bound(its, nbytes(A9, sm, *fkw.values()),
                                        nbytes(b)),
            **bound(nbytes(A9, sm, b, x0, b, *fkw.values()),
                    its * n * (k1_iter_ops(bool(fkw), "pcr_z" in fkw) + 4)))
        print(f"20f K1 {form} (9-plane {nz} x {nr}, first-step system): "
              f"iters kernel {its} plain {int(it_p)}; rel-L2 "
              f"{r['rel_l2']:.3e}, vs float64 kernel {r['err_vs_f64']:.3e} "
              f"plain {r['plain_err_vs_f64']:.3e}")

    # K1's ELL form on the same mesh without its overlay (an imported
    # mesh), in the kernel path's row order: the first step's inner system
    # of msh_flagship.transient's recipe, at the tolerance its path solves
    # to; the pass alone (k_ell_dot: p = z + beta p, Ap, <p, Ap> and the
    # alpha tail) on a solve's first and a later iteration, bitwise the
    # plain pass (the same products and sums, rounded alike) but for
    # <p, Ap> (each term rounded to float32 before the float64 sum, as
    # k_stencil_dot does); the step kernels' ELL products, bitwise
    fe1 = make_simulate_fn_unstructured(
        _cut(_bare(problem), num_steps=1), dtype=torch.float32,
        device=device, **U_ELL_RECIPE)
    require(fe1.use_vmem and not fe1.overlay and fe1.reordered,
            "the ELL kernel path")
    fe1._run = fe1._run_eager
    args, kw = _capture(cuda_cg, "cg_tol", fe1)[0]
    Ae, sme, be, xe0 = (t.contiguous() for t in args[:4])
    cols = kw["cols"]
    ne, ke = (int(v) for v in cols.shape)
    require(Ae.shape == (ne, ke) and be.shape == (1, ne),
            ("the ELL operands", tuple(Ae.shape), tuple(be.shape)))
    # a row: its gather (2 K), the scaling and <p, Ap> (4), the update,
    # <r, r> and p (8)
    ell_ops = 2 * ke + 4 + 8
    k1e = lambda f, cast=lambda t: t: f(
        cast(Ae), cast(sme), cast(be), cast(xe0), 1e-4, maxiter=20000,
        rtol_wrt="b", cols=cols)
    x_k, it_k = k1e(cuda_cg.cg_tol)
    (x_p, it_p), plain_ms = once(lambda: k1e(cuda_cg.cg_tol_reference))
    x64, _ = k1e(cuda_cg.cg_tol_reference, lambda t: t.double())
    r = hold("K1 ell", x_k, x_p, x64, it_k, it_p)
    its = int(it_k)
    rows["cg_tol[ell,unstructured]"] = dict(
        iters=its, plain_iters=int(it_p), rtol=1e-4, **r,
        ms=cuda_ms(lambda: k1e(cuda_cg.cg_tol), 3), plain_ms=plain_ms,
        iter_bound_ms=k1_iter_bound(its, nbytes(Ae, cols, sme), nbytes(be)),
        **bound(nbytes(Ae, cols, sme, be, xe0, be), its * ne * ell_ops))
    print(f"20f K1 ell ({ne} rows of {ke}, first-step system): iters "
          f"kernel {its} plain {int(it_p)}; rel-L2 {r['rel_l2']:.3e}, vs "
          f"float64 kernel {r['err_vs_f64']:.3e} plain "
          f"{r['plain_err_vs_f64']:.3e}")
    g = torch.Generator(device="cpu").manual_seed(23)
    live = (sme != 0).float()
    z, pv = (torch.randn(sme.shape, generator=g).to(device) * live
             for _ in range(2))
    state = dict(k=1, beta=0.37, rz=2.5)
    for it, st in (("first", None), ("later", state)):
        p_n, Ap, pap, got = cuda_cg.ell_dot(Ae, cols, sme, z, pv, st)
        beta = 0.0 if st is None else st["beta"]
        (w_p, w_ap, w_pap), pass_ms = once(
            lambda: cuda_cg.stencil_dot_p_reference(
                Ae, sme, z, pv, beta, st is None, cols))
        d_pap = abs(float(pap) - float(w_pap)) / abs(float(w_pap))
        require(torch.equal(p_n, w_p) and torch.equal(Ap, w_ap)
                and d_pap <= 1e-6, ("the ELL pass", it, d_pap))
        if st is not None:
            d_alpha = abs(got["alpha"] * float(w_pap) / st["rz"] - 1.0)
            require(d_alpha <= 1e-6, ("the ELL pass's alpha", d_alpha))
    rows["cg_tol[ell_dot,unstructured]"] = dict(
        max_abs_err=0.0, pap_rel_err=d_pap, alpha_rel_err=d_alpha,
        ms=cuda_ms(lambda: cuda_cg.ell_dot(Ae, cols, sme, z, pv, state), 5),
        plain_ms=pass_ms,
        **bound(nbytes(Ae, cols, sme, z, pv, z, z), ne * (2 * ke + 4)))
    ws, _ = fe1._step_workspace(*fe1._inputs(None, None, None, None, 0.0,
                                             None))
    # the warm-start ring: three fields apart, so that M u and the seed
    # read every slot
    for k in range(ws.ring.shape[0]):
        ws.ring[k].add_(10.0 * torch.randn(ws.ring[k].shape, generator=g)
                        .to(device) * ws.free)
    ring = ws.ring.clone()
    b_lift, y0 = cuda_step.step_prologue_reference(
        ws.apply, ws.Mop, ring[2], ring[1], ring[0], 0.0, ws.Ag0, ws.Ag1,
        ws.amps[0], ws.s, ws.free, ws.warm_start)
    cuda_step.step_prologue(ws)
    require(torch.equal(ws.bt, b_lift * ws.free)
            and torch.equal(ws.y[0], y0), "the ELL step prologue")
    floor2 = 1e-30 * cuda_step.kernel_order_sum(ws.bt * ws.bt)
    _, r64, rnorm, _ = cuda_step.refine_residual_reference(
        ws.apply, ws.A, ws.s, ws.free, ws.bt, ws.y[0], floor2, ws.rtol,
        torch.float32, total=cuda_step.kernel_order_sum)
    cuda_step.refine_residual(ws, 0)
    d_rnorm = abs(float(ws.state[cuda_step._RNORM]) / float(rnorm) - 1.0)
    require(torch.equal(ws.r64, r64) and d_rnorm <= 1e-14,
            ("the ELL refinement residual", d_rnorm))
    print(f"20f K1 ell pass ({ne} rows): p and Ap bitwise the plain pass "
          f"on a first and a later iteration, <p, Ap> within {d_pap:.1e}, "
          f"alpha {d_alpha:.1e}; the step prologue's planes and the "
          f"refinement residual bitwise their plain versions (rnorm "
          f"{d_rnorm:.1e})")

    # K2 / K3: 8 lanes of the sweep's 10th step
    B = 8
    ks = np.logspace(0.0, 2.0, B)
    fs = np.full(B, sweep_problem.fwhm)
    A0, Kv, dks, smb, bb, xb0 = sweep_system(sweep_problem, ks, fs, device)
    require(A0.shape[0] == 9, "the unstructured sweep operator")
    d64 = lambda ts: tuple(t.double() for t in ts)
    sargs = (A0, Kv, dks, smb, bb, xb0)
    for form, fkw in (("identity", {}), ("rline", {"rline": True})):
        kw2 = dict(maxiter=20000, rtol_wrt="b", **fkw)
        x_k, it_k = cs.cg_batched_tol(*sargs, rtol, **kw2)
        (x_p, it_p), plain_ms = once(lambda: cs.cg_batched_tol_reference(
            *sargs, rtol, **kw2))
        x64, _ = cs.cg_batched_tol_reference(*d64(sargs), rtol, **kw2)
        r = hold(f"K2 {form}", x_k, x_p, x64, it_k, it_p)
        its = [int(i) for i in it_k.tolist()]
        rows[f"cg_batched_tol[{form},unstructured]"] = dict(
            iters=its, **r,
            ms=cuda_ms(lambda: cs.cg_batched_tol(*sargs, rtol, **kw2), 2),
            plain_ms=plain_ms,
            iter_bound_ms=k2_iter_bound(its, A0, Kv, smb, bb),
            **k2_solve_bound(*sargs, its, k2_iter_ops(bool(fkw))))
        print(f"20f K2 {form} ({B} lanes, 9-plane {tuple(bb.shape[1:])}): "
              f"iters kernel {its} plain {it_p.tolist()}; rel-L2 "
              f"{r['rel_l2']:.3e}, vs float64 kernel {r['err_vs_f64']:.3e} "
              f"plain {r['plain_err_vs_f64']:.3e}")
    x_k = cs.cg_batched(*sargs, iters=U_FIXED_ITERS)
    x_p, plain_ms = once(lambda: cs.cg_batched_reference(
        *sargs, iters=U_FIXED_ITERS))
    x64 = cs.cg_batched_reference(*d64(sargs), iters=U_FIXED_ITERS)
    r = hold("K3", x_k, x_p, x64)
    rows["cg_batched[fixed,unstructured]"] = dict(
        **r, ms=cuda_ms(lambda: cs.cg_batched(*sargs, iters=U_FIXED_ITERS),
                        3), plain_ms=plain_ms,
        iter_bound_ms=k2_iter_bound([U_FIXED_ITERS] * B, A0, Kv, smb, bb),
        **k2_solve_bound(*sargs, [U_FIXED_ITERS] * B, k2_iter_ops()))
    print(f"20f K3 ({B} lanes, {U_FIXED_ITERS} iterations): rel-L2 "
          f"{r['rel_l2']:.3e}, vs float64 kernel {r['err_vs_f64']:.3e} plain "
          f"{r['plain_err_vs_f64']:.3e}")

    # K2's Kv-free form: the recording's projection at its 10th step
    rec = make_sweep_fn_unstructured(
        _cut(sweep_problem, num_steps=10), dtype=torch.float32,
        device=device, solver="vmem", precondition="rline", rtol=1e-5,
        warm_start="extrapolate", record_gradient=True)
    calls = [c for c in _capture(cs, "cg_batched_tol",
                                 lambda: rec(ks, fs)) if c[0][1] is None]
    pargs, pkw = calls[-1]
    Mp, _, _, s_mp, br, seed = pargs[:6]
    p_rtol = pargs[6]
    pkw = dict(pkw)
    x_k, it_k = cs.cg_batched_tol(Mp, None, None, s_mp, br, seed, p_rtol,
                                  **pkw)
    (x_p, it_p), plain_ms = once(lambda: cs.cg_batched_tol_reference(
        Mp, None, None, s_mp, br, seed, p_rtol, **pkw))
    x64, _ = cs.cg_batched_tol_reference(
        *d64((Mp,)), None, None, *d64((s_mp, br, seed)), p_rtol, **pkw)
    r = hold("K2 no_kv", x_k, x_p, x64, it_k, it_p)
    its = [int(i) for i in it_k.tolist()]
    rows["cg_batched_tol[no_kv,unstructured]"] = dict(
        iters=its, **r,
        ms=cuda_ms(lambda: cs.cg_batched_tol(Mp, None, None, s_mp, br, seed,
                                             p_rtol, **pkw), 3),
        plain_ms=plain_ms,
        iter_bound_ms=k2_iter_bound(its, Mp, None, s_mp, br),
        **k2_solve_bound(Mp, None, None, s_mp, br, seed, its,
                         k2_iter_ops(kv=False)))
    print(f"20f K2 Kv-free (the projection, {B} lanes): iters kernel {its} "
          f"plain {it_p.tolist()}; rel-L2 {r['rel_l2']:.3e}")
    out.setdefault("unstructured", {})["kernel_rows"] = rows
    return rows


def run_unstructured(device, out: dict) -> dict:
    """Phase 20: set-up, (a)-(c) the flagship, (d) the sweeps, (e) the
    CLIs, (f) the kernels against their plain versions, (g) the flagship
    mesh without its overlay on the kernel path; returns the kernel rows
    with the launches of (a)-(e) and, for K1's ELL form, of (g)."""
    t0 = time.perf_counter()
    problem, setup = build_unstructured(CFG)
    sweep_problem, sweep_setup = build_unstructured(SWEEP_CFG)
    print(f"20 set-up (host): flagship {setup}, sweep {sweep_setup}")
    res = run_unstructured_flagship(problem, device, out)
    sw = run_unstructured_sweeps(sweep_problem, device, out)
    run_unstructured_clis(device, out)
    rows = unstructured_kernel_checks(problem, sweep_problem, device, out)
    ell = run_unstructured_ell(problem, device, out)
    k1 = {f: res["flagship"]["k1"][f] + res["adi"]["k1"][f]
          + sw["sweep"]["k1_identity"][f] for f in ("identity", "rline",
                                                    "adi")}
    k1.update(ell=ell["k1"]["ell"], ell_dot=ell["ell_dot_launches"])
    k2 = {f: sw["sweep"]["k2"][f] + sw["recording"]["k2"][f]
          + sw["fixed"]["k3"][f] for f in ("identity", "rline", "no_kv",
                                           "fixed")}
    for name, r in rows.items():
        form = name[name.index("[") + 1:name.index(",")]
        r["launches"] = (k1 if name.startswith("cg_tol") else k2)[form]
    out.setdefault("unstructured", {}).update(
        setup=setup, sweep_setup=sweep_setup,
        phase_s=time.perf_counter() - t0)
    print(f"phase 20: {out['unstructured']['phase_s']:.1f} s")
    return rows


# ----------------------------------------------------------------------
# Phase 21: the analysis pipeline (P10) and the native set-up (P12)
# ----------------------------------------------------------------------

# the bounds of tests/test_torch_analysis_splitnormal.py: a row whose fit
# explains the data (R² >= FIT_R2_MIN on the CPU) holds its parameters
# within FIT_PARAM_RTOL (amplitude of itself, offset of |amplitude| +
# |offset|, center and sigmas of the radial span) and its RMSE within
# FIT_ERR_RTOL; the minimax polish's max error within FIT_MAXERR_RTOL (its
# coordinate search takes other probes on last-bit differences); a noise-like
# row (R² below FIT_R2_MIN) its error within FIT_NOISE_RTOL, each device's
# error that of its own parameters
FIT_PARAM_RTOL = 1e-6
FIT_ERR_RTOL = 1e-8
FIT_MAXERR_RTOL = 1e-4
FIT_NOISE_RTOL = 1e-2
FIT_R2_MIN = 0.5
NATIVE_TOL = 1e-13     # each plane, of its max abs (tests/test_native.py)
FIT_KEYS = ("amplitudes", "centers", "sigma_lefts", "sigma_rights",
            "offsets")


def fits_agree(got: dict, want: dict, r, grid, method: str) -> dict:
    """Hold the card's fits (``got``) to the CPU's (``want``) row by row
    with the bounds above; returns the largest differences by row class."""
    import numpy as np
    from heatflow_tpu_torch.analysis.splitnormal import split_normal_function
    span = float(np.ptp(r))
    worst = dict(param=0.0, err=0.0, noise_err=0.0, determined=0, noise=0)
    for i, row in enumerate(grid):
        pg = np.array([got[k][i] for k in FIT_KEYS])
        pw = np.array([want[k][i] for k in FIT_KEYS])
        eg, ew = float(got["rmse_values"][i]), float(want["rmse_values"][i])
        resid = np.abs(row - split_normal_function(r, *pg))
        own = resid.max() if method == "maxerr" else np.sqrt(
            np.mean(resid ** 2))
        require(abs(eg - own) <= 1e-12 * max(own, 1e-300),
                ("fit error is not its parameters'", method, i, eg, own))
        derr = abs(eg - ew) / max(abs(ew), 1e-300)
        if want["r_squared_values"][i] < FIT_R2_MIN:
            worst["noise"] += 1
            worst["noise_err"] = max(worst["noise_err"], derr)
            require(derr <= FIT_NOISE_RTOL, ("noise row", method, i, eg, ew))
            continue
        worst["determined"] += 1
        scale = np.array([abs(pw[0]), span, span, span,
                          abs(pw[0]) + abs(pw[4])])
        dp = float((np.abs(pg - pw) / np.maximum(scale, 1e-300)).max())
        worst["param"] = max(worst["param"], dp)
        worst["err"] = max(worst["err"], derr)
        if method == "maxerr":
            require(derr <= FIT_MAXERR_RTOL, ("maxerr", i, eg, ew))
        else:
            require(dp <= FIT_PARAM_RTOL and derr <= FIT_ERR_RTOL,
                    ("rmse fit", i, dp, derr))
    return worst


def run_analysis(device, out: dict) -> None:
    """Phase 21: (a) the split-normal fits of phase 19's 2D run on the card
    against the CPU, (b) the fitted curves as the 1D model's gradient CSV,
    (c) the two analysis CLIs, (d) the native stencil assembly against
    numpy at the flagship and sweep shapes."""
    import importlib.util
    import numpy as np
    import torch
    from heatflow_tpu_torch.analysis import radial, splitnormal as sn
    from heatflow_tpu_torch.config import load_config
    from heatflow_tpu_torch.drivers import run1d
    from heatflow_tpu_torch.geometry import build_layout
    from heatflow_tpu_torch.io.csvio import read_gradient_csv, read_watcher_csv
    from heatflow_tpu_torch.mesh.structured import build_structured_mesh
    from heatflow_tpu_torch.ops import _build
    from heatflow_tpu_torch.ops.stencil import assemble_stencils

    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke", "pipeline")
    grad = os.path.join(work, "out2d", "radial_gradient.csv")
    plotter = radial.RadialGradientPlotter(grad)
    r, grid = plotter.radial_positions, plotter.grid
    res = {}
    secs = {}
    for method in ("rmse", "maxerr"):
        for tag, dev in (("card", device), ("cpu", torch.device("cpu"))):
            times = []
            for _ in range(2):      # the first call on a device warms it
                t0 = time.perf_counter()
                res[method, tag] = sn.analyze_split_normal_fits(
                    plotter, fit_method=method, device=dev)
                times.append(time.perf_counter() - t0)
            secs[method, tag] = times
        got, want = res[method, "card"], res[method, "cpu"]
        worst = fits_agree(got, want, r, grid, method)
        print(f"21a split-normal fits ({method}) of {grid.shape[0]} rows x "
              f"2 guesses ({grid.shape[1]} points a row, one batch): card "
              f"{secs[method, 'card'][1]:.3f} s (first "
              f"{secs[method, 'card'][0]:.3f}), "
              f"CPU {secs[method, 'cpu'][1]:.3f} s (first "
              f"{secs[method, 'cpu'][0]:.3f}); mean error "
              f"{np.mean(got['rmse_values']):.6e} K/m (CPU "
              f"{np.mean(want['rmse_values']):.6e}), mean R² "
              f"{np.mean(got['r_squared_values']):.6f}; {worst['determined']} "
              f"rows with R² >= {FIT_R2_MIN}: parameters within "
              f"{worst['param']:.2e}, errors within {worst['err']:.2e}; "
              f"{worst['noise']} noise-like rows: errors within "
              f"{worst['noise_err']:.2e}")
        out.setdefault("analysis", {})[method] = dict(
            card_s=secs[method, "card"], cpu_s=secs[method, "cpu"],
            mean_err=float(np.mean(got["rmse_values"])),
            mean_r2=float(np.mean(got["r_squared_values"])), **worst)

    # (b) the fitted curves as run1d's gradient CSV (the reference's
    # 2D -> fit -> 1D route), against phase 19's raw-gradient run
    full = res["rmse", "card"]
    amp = sn.analyze_split_normal_fits_amplitude_only(
        plotter, *[float(np.mean(full[k])) for k in FIT_KEYS[1:]])
    raw = read_watcher_csv(os.path.join(work, "out1d_card_1",
                                        "watcher_points.csv"))
    raw = np.column_stack([raw["pside"], raw["oside"]])
    one_d = os.path.join(work, "1d.yaml")
    for tag, fit in (("full", full), ("amp", amp)):
        csv = os.path.join(work, f"fitted_{tag}.csv")
        sn.save_fitted_curves_csv(fit, r, csv)
        gt, gz, gv = read_gradient_csv(csv)
        require(gv.shape == grid.shape and np.isfinite(gv).all(), csv)
        o = os.path.join(work, f"out1d_fit_{tag}")
        t0 = time.perf_counter()
        run1d.main(["--config", one_d, "--mesh-folder-2d",
                    os.path.join(work, "mesh"), "--output-folder", o,
                    "--radial-gradient-path", csv, "--device", str(device),
                    "--suppress-print"])
        torch.cuda.synchronize()
        s1d = time.perf_counter() - t0
        cols = read_watcher_csv(os.path.join(o, "watcher_points.csv"))
        w = np.column_stack([cols["pside"], cols["oside"]])
        require(w.shape == raw.shape and np.isfinite(w).all(), (tag, w.shape))
        d = float(np.abs(w - raw).max())
        print(f"21b run1d on the card with the {tag} fitted curves as "
              f"--radial-gradient-path: {s1d:.2f} s, finite, max |Δ| "
              f"{d:.4f} K from phase 19's raw-gradient run "
              f"(watcher range [{w.min():.2f}, {w.max():.2f}] K)")
        out["analysis"][f"run1d_{tag}"] = dict(seconds=s1d, max_dK=d)

    # (c) the CLIs through their main(...)
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    arts = os.path.join(work, "analysis_cli")
    os.makedirs(arts, exist_ok=True)
    files = {k: os.path.join(arts, f"{k}.csv")
             for k in ("results", "full", "amp")}
    flags = ["--save-results", files["results"],
             "--save-fitted-csv-full", files["full"],
             "--save-fitted-csv-amp", files["amp"]]
    if have_mpl:
        for k in ("analysis", "comparison", "compare"):
            files[k] = os.path.join(arts, f"{k}.png")
        flags += ["--save-analysis-plot", files["analysis"],
                  "--save-comparison-plot", files["comparison"],
                  "--save-compare-plot", files["compare"]]
    else:
        print("matplotlib: absent (21c: the split-normal CLI's CSV flags "
              "only; no radial CLI, no mesh plot)")
    for f in files.values():
        if os.path.exists(f):
            os.remove(f)
    t0 = time.perf_counter()
    sn.main([grad, "--no-show", "--device", str(device), *flags])
    if have_mpl:
        from heatflow_tpu_torch.mesh.viz import plot_mesh
        ev, hm = (os.path.join(arts, f"{k}.png")
                  for k in ("evolution", "heatmap"))
        radial.main([grad, "--plot-type", "both", "--save-evolution", ev,
                     "--save-heatmap", hm, "--no-show"])
        png = os.path.join(arts, "mesh.png")
        plot_mesh(build_structured_mesh(*build_layout(load_config(
            FIT_CFG))), png)
        files.update(evolution=ev, heatmap=hm, mesh=png)
    cli_s = time.perf_counter() - t0
    missing = [f for f in files.values() if not os.path.exists(f)]
    require(not missing, ("CLI files missing", missing))
    print(f"21c heatflow-torch-splitnormal"
          f"{' and heatflow-torch-radial' if have_mpl else ''} on the card: "
          f"{len(files)} files written, {cli_s:.2f} s")
    out["analysis"].update(matplotlib=have_mpl, cli_s=cli_s,
                           cli_files=len(files))

    # (d) the native stencil assembly against numpy, flagship and sweep
    t0 = time.perf_counter()
    _build.build_native()
    build_s = time.perf_counter() - t0
    for name, path in (("flagship", CFG), ("sweep", SWEEP_CFG)):
        mesh = build_structured_mesh(*build_layout(load_config(path)))
        packs, tt = {}, {}
        for backend in ("native", "numpy"):
            t0 = time.perf_counter()
            packs[backend] = assemble_stencils(mesh, backend=backend)
            tt[backend] = time.perf_counter() - t0
        worst = 0.0
        for plane in ("K", "M", "K_flat", "M_flat", "G_r", "G_z", "M_proj"):
            a = getattr(packs["native"], plane)
            b = getattr(packs["numpy"], plane)
            err = float(np.abs(a - b).max() / np.abs(b).max())
            require(a.shape == b.shape and err <= NATIVE_TOL,
                    ("native assembly", name, plane, err))
            worst = max(worst, err)
        print(f"21d assemble_stencils at the {name} shape "
              f"({mesh.shape[0]} x {mesh.shape[1]}, {len(mesh.material_tags)}"
              f" materials): native {tt['native']:.3f} s, numpy "
              f"{tt['numpy']:.3f} s; every plane within {worst:.2e} of its "
              f"max abs")
        out["analysis"][f"assembly_{name}"] = dict(
            native_s=tt["native"], numpy_s=tt["numpy"], max_rel=worst)
    out["analysis"].update(native_build_s=build_s,
                           phase_s=time.perf_counter() - t_phase)
    print(f"g++ build of the mesh kernels: {build_s:.2f} s (0 when cached)")
    print(f"phase 21: {out['analysis']['phase_s']:.1f} s")


# ----------------------------------------------------------------------
# Phase 22: multi-device execution (P11) over torch.distributed
# ----------------------------------------------------------------------

SHARD_B = 64          # 22a: the config-sharded sweep, 32 lanes a rank
SHARD_REC_B = 16      # 22a: the config-sharded recording
# drivers/sweep.py's float32 kernel recipe ('jacobi',
# rtol 1e-4 wrt ||b||) and its recording recipe (REC_RECIPE)
SHARD_RECIPE = dict(solver="vmem", precondition="jacobi", rtol=1e-4)
SHARD_REC_RECIPE = dict(solver="vmem", precondition="rline",
                        warm_start="extrapolate", rtol=1e-5,
                        record_gradient=True)
# 22b: the z-sharded stepper against the unsharded eager run, each family's
# max abs difference over max(1, its max abs): watch and final_u within the
# bounds of tests/test_sharding.py (rline 1e-9, jacobi 1e-11); band and axis,
# the gradient projection's rows, within the bound or 2x the unsharded run's
# own distance under another valid summation order (its CG dots summed rows
# first), whichever is larger: on this problem that order alone moves them
# by ~2e-10 / ~4e-8 of their max, as the ranks' partial sums do
Z_SHARDS = 3          # geballe_no_diamond: Nz = 243 = 3 * 81
Z_CASES = (("rline", 5, 1e-9), ("jacobi", 2, 1e-11))
Z_FAMILIES = ("watch", "band", "axis", "final_u")
Z_EXACT = ("watch", "final_u")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _np_rel(a, b) -> dict:
    """Where two batches of lanes differ: the lanes that do and the max
    relative difference."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b).reshape(len(a), -1).max(axis=1)
    return dict(lanes=np.nonzero(d)[0].tolist(),
                rel=float(d.max() / np.abs(b).max()))


def _shard_inputs(problem, B: int):
    import numpy as np
    return np.logspace(0.0, 2.0, B), np.full(B, problem.fwhm)


def _multihost_rank(port: int, n: int, backend: str, cases: dict) -> dict:
    """One process of a multi-process sweep (22a, 22c): joins the group
    over tcp:// on localhost, builds the sweep problem and runs each case
    (B, recipe, warm: run it once before the timed run) through
    ``run_sweep_multihost`` on cuda:0, with K2's counters set to 0 just
    before each timed run; returns the full results, seconds and counts."""
    import torch
    from heatflow_tpu_torch.ops import _build
    from heatflow_tpu_torch.ops import cuda_sweep as cs
    from heatflow_tpu_torch.parallel import multihost
    rank = int(os.environ["RANK"])
    multihost.initialize(f"localhost:{port}", n, rank, backend=backend)
    _build.load_library()
    problem = build_flagship(SWEEP_CFG)
    out = {}
    for name, (B, kw, warm) in cases.items():
        ks, fs = _shard_inputs(problem, B)
        run = lambda: multihost.run_sweep_multihost(
            problem, ks, fs, device="cuda", dtype=torch.float32, **kw)
        if warm:
            run()
        torch.cuda.synchronize()
        cs.reset_counters()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        out[name] = dict(result=res, seconds=time.perf_counter() - t0,
                         counts=_sweep_counts())
    return out


def _rows_first_dots(*pairs) -> tuple:
    """The CG dots summed along r, then along z: another order of the same
    sums (22b's yardstick)."""
    return tuple((a * b).sum(dim=-1).sum(dim=-1) for a, b in pairs)


def _z_rank(cases) -> dict:
    """One rank of the z-sharded stepper (22b): its rows of the sweep
    problem's 243 x 1001 field on cuda:0 (gloo ranks); each case's full
    outputs and seconds."""
    import dataclasses
    import torch
    from heatflow_tpu_torch.parallel.sharding import config_mesh
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    mesh = config_mesh(z_shards=Z_SHARDS, device="cuda")
    problem = build_flagship(SWEEP_CFG)
    out = {}
    for prec, steps, _tol in cases:
        p = dataclasses.replace(problem, num_steps=steps, extras={})
        t0 = time.perf_counter()
        ys = make_simulate_fn(p, dtype=torch.float64, precondition=prec,
                              solver="xla", record_gradient=True, mesh=mesh,
                              device=mesh.device)()
        torch.cuda.synchronize()
        out[prec] = dict(seconds=time.perf_counter() - t0,
                         **{k: ys[k].cpu().numpy()
                            for k in Z_FAMILIES + ("cg_iters",)})
    return out


def run_sharded(problem, device, out: dict, repeats: int = 1) -> dict:
    """Phase 22: (a) ``run_sweep_multihost`` over 2 gloo ranks sharing
    cuda:0 (tcp:// on localhost): the B = 64 float32 kernel sweep and the
    B = 16 recording, bitwise the single-process runs of the same B; (b)
    ``make_simulate_fn(mesh=)`` over 3 gloo ranks on cuda:0, float64,
    eager r-line (5 steps) and Jacobi (2 steps) with the gradient recorded,
    against the unsharded eager run; (c) ``run_sweep_multihost`` over NCCL
    in a world of one rank, bitwise the single-process sweep. Every
    sub-check fatal; the seconds of each beside the card. (a) runs
    ``repeats`` times, each run held bitwise and recorded."""
    import dataclasses
    import numpy as np
    import torch
    from heatflow_tpu_torch.parallel.sharding import spawn
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                    make_sweep_fn_recording)
    t_phase = time.perf_counter()
    card = out["card"]
    res = out.setdefault("sharded", {})
    rec_kw = {k: v for k, v in SHARD_REC_RECIPE.items()
              if k != "record_gradient"}

    # (a) the config axis: 2 gloo ranks on the one card, ``repeats`` times
    # (each run held bitwise; ROADMAP §3's fault was one such run)
    for run in range(repeats):
        t_a = time.perf_counter()
        t0 = time.perf_counter()
        cases = {"sweep": (SHARD_B, SHARD_RECIPE, True),
                 "recording": (SHARD_REC_B, SHARD_REC_RECIPE, False)}
        ranks = spawn(_multihost_rank, 2, init=False, device="cuda",
                      timeout=300.0, args=(_free_port(), 2, "gloo", cases))
        spawn_s = time.perf_counter() - t0
        ks, fs = _shard_inputs(problem, SHARD_B)
        one = make_sweep_fn(problem, dtype=torch.float32, device=device,
                            **SHARD_RECIPE)
        one(ks, fs)                  # warm, as the ranks' timed runs are
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = one(ks, fs).cpu().numpy()
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        ks_r, fs_r = _shard_inputs(problem, SHARD_REC_B)
        want_rec = make_sweep_fn_recording(
            problem, dtype=torch.float32, device=device, **rec_kw)(ks_r, fs_r)
        for r, got in enumerate(ranks):
            require(np.isfinite(got["sweep"]["result"]).all(), "22a finite")
            require(np.array_equal(got["sweep"]["result"], want),
                    ("22a sweep not bitwise", r,
                     _np_rel(got["sweep"]["result"], want)))
            for k in ("watch", "band", "axis"):
                w = want_rec[k].cpu().numpy()
                require(np.array_equal(got["recording"]["result"][k], w),
                        ("22a recording not bitwise", r, k,
                         _np_rel(got["recording"]["result"][k], w)))
            require(got["sweep"]["counts"]["identity"] > 0
                    and got["recording"]["counts"]["no_kv"] > 0,
                    ("22a: a rank ran no K2 solve", r,
                     got["sweep"]["counts"]))
        sweep_s = max(g["sweep"]["seconds"] for g in ranks)
        res.setdefault("a_runs", []).append(dict(
            seconds=time.perf_counter() - t_a, spawn_s=spawn_s,
            sweep_s=[g["sweep"]["seconds"] for g in ranks],
            recording_s=[g["recording"]["seconds"] for g in ranks],
            configs_per_s_2_ranks=SHARD_B / sweep_s,
            configs_per_s_1_process=SHARD_B / one_s,
            k2_identity_solves=[g["sweep"]["counts"]["identity"]
                                for g in ranks],
            k2_no_kv_solves=[g["recording"]["counts"]["no_kv"]
                             for g in ranks], bitwise=True))
        res["a"] = res["a_runs"][0]
        a = res["a_runs"][-1]
        print(f"22a (run {run + 1} of {repeats}) config axis, 2 gloo ranks "
              f"on cuda:0 ({card}): B = {SHARD_B} sweep bitwise, "
              f"{SHARD_B / sweep_s:.2f} configs/s at 2 ranks against "
              f"{SHARD_B / one_s:.2f} in one process (ranks share the card: "
              f"sharing, not scaling); B = {SHARD_REC_B} recording bitwise; "
              f"K2 solves a rank {a['k2_identity_solves']} / "
              f"{a['k2_no_kv_solves']} (Kv-free); {a['seconds']:.1f} s")

    # (b) the z axis: 3 gloo ranks on the one card, float64 eager
    from heatflow_tpu_torch.ops import cg
    t0 = time.perf_counter()
    zr = spawn(_z_rank, Z_SHARDS, backend="gloo", device="cuda",
               timeout=300.0, args=(Z_CASES,))
    res["b"] = dict(spawn_s=time.perf_counter() - t0)
    rel = lambda a, b: float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
    for prec, steps, tol in Z_CASES:
        p = dataclasses.replace(problem, num_steps=steps, extras={})
        runs = {}
        for order, dots in (("default", cg._dots),
                            ("rows_first", _rows_first_dots)):
            plain, cg._dots = cg._dots, dots
            try:
                t1 = time.perf_counter()
                ys = make_simulate_fn(p, dtype=torch.float64,
                                      precondition=prec, solver="xla",
                                      record_gradient=True, device=device)()
                torch.cuda.synchronize()
            finally:
                cg._dots = plain
            runs[order] = {k: v.cpu().numpy() for k, v in ys.items()}
            runs[order]["seconds"] = time.perf_counter() - t1
        ref = runs["default"]
        yard = {k: rel(runs["rows_first"][k], ref[k]) for k in Z_FAMILIES}
        errs = {}
        for r, got in enumerate(zr):
            for k in Z_FAMILIES:
                a = got[prec][k]
                require(a.shape == ref[k].shape and np.isfinite(a).all(),
                        ("22b", prec, k, a.shape, ref[k].shape))
                errs[k] = max(errs.get(k, 0.0), rel(a, ref[k]))
        bound = {k: tol if k in Z_EXACT else max(tol, 2.0 * yard[k])
                 for k in Z_FAMILIES}
        require(all(errs[k] <= bound[k] for k in Z_FAMILIES),
                ("22b", prec, errs, bound))
        res["b"][prec] = dict(
            steps=steps, tol=tol, errs=errs, rows_first=yard, bound=bound,
            sharded_s=[g[prec]["seconds"] for g in zr],
            unsharded_s=ref["seconds"],
            iters=ref["cg_iters"].tolist(),
            iters_sharded=zr[0][prec]["cg_iters"].tolist())
        print(f"22b z axis, {Z_SHARDS} gloo ranks on cuda:0 ({card}): "
              f"'{prec}' {steps} steps, float64, sharded / rows-first "
              "dots against the unsharded run: "
              + ", ".join(f"{k} {errs[k]:.2e} / {yard[k]:.2e}"
                          for k in Z_FAMILIES)
              + f" (bound {tol:g}; band, axis 2x rows-first); "
              f"{max(res['b'][prec]['sharded_s']):.1f} s sharded against "
              f"{ref['seconds']:.1f} s unsharded; iterations "
              f"{res['b'][prec]['iters_sharded']} / {res['b'][prec]['iters']}")
    res["b"]["seconds"] = time.perf_counter() - t0

    # (c) NCCL in a world of one rank
    t0 = time.perf_counter()
    nc = spawn(_multihost_rank, 1, init=False, device="cuda", timeout=300.0,
               args=(_free_port(), 1, "nccl",
                     {"sweep": (SHARD_B, SHARD_RECIPE, False)}))[0]
    require(np.array_equal(nc["sweep"]["result"], want),
            ("22c not bitwise", _np_rel(nc["sweep"]["result"], want)))
    require(nc["sweep"]["counts"]["identity"] > 0, "22c: no K2 solve")
    res["c"] = dict(seconds=time.perf_counter() - t0,
                    sweep_s=nc["sweep"]["seconds"],
                    configs_per_s_1_rank=SHARD_B / nc["sweep"]["seconds"])
    print(f"22c NCCL, a world of one rank ({card}): B = {SHARD_B} sweep "
          f"bitwise ({res['c']['configs_per_s_1_rank']:.2f} configs/s, the "
          f"process's first sweep); {res['c']['seconds']:.1f} s")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 22: {res['phase_s']:.1f} s ({card})")
    return res


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
    ap.add_argument("--shard-repeats", type=int, default=1,
                    help="run phase 22a (the 2-rank config-sharded sweep "
                         "and recording, each held bitwise) this many times")
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
    print(f"K1 loop: each solve one CUDA graph launch, blocks of "
          f"{cuda_cg.CHECK_EVERY} iterations under a conditional WHILE node "
          f"(the device tests the stop flag; no host read before the end)")

    # a graph's loop body is traced in full only by profiler sessions that
    # began before the graph was captured: open the process's first one now,
    # and keep CUPTI set up between sessions (torch's own setting for CUDA
    # graphs: a teardown and re-init loses the graphs' kernel nodes)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    kernel_profile(lambda: torch.ones(1, device=device) + 1)
    t0 = time.perf_counter()
    problem = build_flagship()
    print(f"flagship setup (host): {time.perf_counter() - t0:.2f} s")
    rows = phase_checks(problem, device, out)
    fn, step_rows = run_slice(problem, device, out)
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

    form_rows = forms_checks(problem, device, out)
    merged_rows = merged_sweep_checks(sweep_problem, device, out)
    form_counts = run_forms_slice(problem, sweep_problem, device, out)
    run_mg_and_steady(problem, device, out)

    from heatflow_tpu_torch.ops import cuda_mg
    t0 = time.perf_counter()
    setup = cuda_mg.build_mg_setup(*flagship_operator(problem),
                                   problem.mesh.z, problem.mesh.r,
                                   n_levels=MG_LEVELS, device=device)
    print(f"multigrid setup (host, scipy Galerkin products, {MG_LEVELS} "
          f"levels): {time.perf_counter() - t0:.2f} s")
    nine_rows = nine_plane_checks(problem, setup, device, out)
    mg_rows = mg_checks(problem, setup, device, out)
    mg_counts = run_mg_transient(problem, setup, device, out)
    run_pipeline_1d(device, out)
    out["phases_17_19_s"] = time.perf_counter() - t0
    print(f"phases 17-19: {out['phases_17_19_s']:.1f} s")
    unstructured_rows = run_unstructured(device, out)
    run_analysis(device, out)
    run_sharded(sweep_problem, device, out, args.shard_repeats)

    counts = out["slice"]["phase_launches"]
    solves = out["slice"]["solves"]
    kernel = lambda name, source, replaces, launches, r: dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None)
    kernels = [kernel(r["name"], SOURCE, REPLACES, counts[r["phase"]], r)
               for r in rows]
    for line in "rz":
        kernels.append(kernel(f"cg_tol.{line}line_factor", SOURCE,
                              FACTOR_REPLACES,
                              out["slice"][f"{line}line_factor_launches"],
                              out[f"{line}line_factor"]))
    for form in ("rline", "adi"):
        kernels.append(kernel(f"cg_tol[{form}]", SOURCE, REPLACES,
                              solves[form], out["solves"][form]))
    # the step kernels: their launches in phase 4's graph run
    for name, r in step_rows.items():
        kernels.append(kernel(name, STEP_SOURCE, STEP_REPLACES[name],
                              out["slice"]["step_launches"][name], r))
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
    # this slice's forms: a phase row reads its phase kernel's launches over
    # the runs of phase 15, a solve row its form's solves there
    for r in form_rows["phases"].values():
        kernels.append(kernel(r["name"], SOURCE, REPLACES,
                              form_counts["k1_phases"][r["phase"]], r))
    for form, n in form_counts["k1_rows"].items():
        kernels.append(kernel(f"cg_tol[{form}]", SOURCE, REPLACES, n,
                              form_rows["solves"][form]))
    k2 = form_counts["k2"]
    for name, r in merged_rows.items():
        phase = ("merged_w_no_kv" if name.endswith("merged_w[no_kv]")
                 else r.get("phase"))
        kernels.append(kernel(name, SWEEP_SOURCE, K2_REPLACES,
                              k2["phases"][phase] if phase else k2["merged"],
                              r))
    # the 9-plane runs of K1 and K2: their driven solves of phase 17; the
    # multigrid cycle's phase kernels and the multigrid solve: their launches
    # on the K6 path of phase 18; the fixed-count solve: on the K7 path
    for name, r in nine_rows.items():
        k2_row = name.startswith("cg_batched")
        kernels.append(kernel(name, SWEEP_SOURCE if k2_row else SOURCE,
                              K2_REPLACES if k2_row else REPLACES,
                              r["launches"], r))
    for r in mg_rows["phases"].values():
        kernels.append(kernel(r["name"], SOURCE, K6_REPLACES,
                              mg_counts["phases"][r["phase"]], r))
    for name, r in mg_rows["solves"].items():
        if name.startswith("mgcg_vmem_tol["):
            kernels.append(kernel(name, SOURCE, K6_REPLACES,
                                  mg_counts["solves"], r))
        elif name.startswith("cg_vmem["):
            kernels.append(kernel(name, SOURCE, K7_REPLACES,
                                  mg_counts["k7_solves"], r))
    # the unstructured path's 9-plane K1, K2 and K3: launches over phase
    # 20's runs (a)-(d), each read just after its run
    for name, r in unstructured_rows.items():
        k1_row = name.startswith("cg_tol")
        kernels.append(kernel(
            name, SOURCE if k1_row else SWEEP_SOURCE,
            REPLACES if k1_row else K3_REPLACES if name.startswith(
                "cg_batched[") else K2_REPLACES, r["launches"], r))
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

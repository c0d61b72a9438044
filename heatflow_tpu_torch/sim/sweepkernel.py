"""Batched coefficient sweeps: B transient runs of one problem at once.

A sweep config differs from the base problem only in the sample
conductivity κ and the laser FWHM (ref modify_config_for_parameters,
parameter_sweep.py:238-266), so lane b's backward-Euler operator is

    A_b = A_base + dt·Δκ_b·K_sample

and the stencils are shared by the whole batch: per lane there are only the
solution fields. The time loop runs every lane together, step by step, with
one batched CG solve a step. Lanes whose parameters are not finite come out
as NaN traces, without stopping or perturbing the others (ref :447-509's
failure records).

Two solvers: ``'vmem'`` runs each step's solve through the batched CUDA
kernels of :mod:`heatflow_tpu_torch.ops.cuda_sweep` (their plain versions
for CPU tensors), ``'xla'`` through the eager batched :func:`pcg` /
:func:`pcg_fixed` with the per-lane freeze. One config alone
(``make_sweep_fn(...).one_config``) runs a differentiable solve a step, the
gradient-based fit's engine: the ``cg_tol`` kernel through
:func:`cg_vmem_solve` (``'vmem'``), or :func:`pcg_solve` (``'xla'``).

Recording sweeps (:func:`make_sweep_fn_recording`) also write the radial
gradient of every lane each step: the r-weighted mass projection, solved for
all lanes through the Kv-free form of the same batched kernel (``'vmem'``),
or the eager stepper run once per lane (``'xla'``).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from heatflow_tpu_torch.ops.cg import (_lane, pcg, pcg_fixed, pcg_solve,
                                       refine_inner_scale)
from heatflow_tpu_torch.ops.stencil import (apply_combined, apply_stencil,
                                            combine_operator)
from heatflow_tpu_torch.sim.problem import Problem2D, band_average
from heatflow_tpu_torch.sim.stepper import interp, make_simulate_fn
from heatflow_tpu_torch.utils import resolve_device, span


# the sweep ops that hold (..., Nz, Nr) planes: a z-sharded rank's rows
_Z_SHARDED = ("A0", "K_var", "M_op", "free", "dirich", "base", "r_sq")


def _mesh_device(mesh, device) -> torch.device:
    """A maker's device: the mesh's under ``mesh=`` (a
    ``parallel.sharding.DeviceMesh``, checked), else ``device``."""
    if mesh is None:
        return resolve_device(device)
    from heatflow_tpu_torch.parallel.sharding import check_mesh
    return check_mesh(mesh).device


def _config_axis_only(mesh) -> None:
    """The kernel engines keep whole problems on one device: under a mesh
    they shard the configs only."""
    if mesh is not None and mesh.shape["z"] > 1:
        raise ValueError("solver='vmem' shards the config axis only "
                         "(whole problems stay on one device); use "
                         "z_shards=1")


def material_index(mesh, name: str) -> int:
    """The stencil slot of material ``name``: slots are ordered by tag
    value. (A mesh reloaded from its folder lists its tags in the YAML's
    sorted-key order, so their dict order is not the slot order.)"""
    order = sorted(mesh.material_tags, key=mesh.material_tags.get)
    return order.index(name)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last two dims of each lane, in a fixed pairwise order: a
    lane's sum does not depend on the batch it runs in (a CUDA reduction's
    order follows the tensor's shape)."""
    v = x.reshape(*x.shape[:-2], -1)
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        head = v[..., :h] + v[..., h:2 * h]
        v = torch.cat([head, v[..., 2 * h:]], dim=-1) if v.shape[-1] % 2 \
            else head
    return v[..., 0]


def _sweep_scan(ops, ks, fs, u0, u_pp, step0, *, cdt, ic, dt, num_steps,
                base_k, extrapolate, make_solve, iters_out=None,
                project=None, inplace=True, halo=None):
    """The batched backward-Euler loop shared by both solvers and by the
    differentiable one-config run.

    ``make_solve(dks, s, sm)`` is called once per scan and returns
    ``solve(Bv, Y0) -> (X, iters)``, which solves the scaled system
    sm·A_b·sm X = Bv of every lane from Y0. Returns (traces (B, S, W),
    u_fin, u_penultimate); the last two re-enter the next time chunk, so a
    chunked 'extrapolate' run is the unchunked trajectory. ``iters_out``, a
    list, receives each step's (B,) iteration counts; ``project(U)``, when
    given, is called with each step's new fields. ``inplace=False`` forms
    the right-hand side and the new fields out of place, with the same
    bits, for autograd and ``torch.func`` (a batch of tangents cannot be
    written into a tensor that carries none). ``halo``: the fields are
    z-sharded slabs (``parallel.sharding.ZAxis.halo``; the watcher ids
    ``ops['watch']`` are then the slab's)."""
    device = ops["A0"].device
    free, dirich = ops["free"], ops["dirich"]
    A0, Kv = ops["A0"], ops["K_var"]
    dks = (torch.as_tensor(ks, dtype=cdt, device=device) - base_k) * dt
    diag = A0[0] + _lane(dks) * Kv[0]
    s = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag))) \
        * free + dirich
    del diag
    sm = s * free
    amp_offset = ops["heat_T"][0] - ic
    fs = torch.as_tensor(fs, dtype=cdt, device=device)
    coeff = torch.tensor(-4.0 * math.log(2.0), dtype=cdt,
                         device=device) / (fs * fs)
    g1 = torch.exp(_lane(coeff) * ops["r_sq"]) * ops["base"]
    # the Dirichlet lift is affine in the interpolated amplitude,
    # g(t) = g0 + amp(t)·g1, so A g is applied once per scan, not per step
    g0 = ic * (dirich - g1)
    Ag0 = apply_combined(A0, Kv, dks, g0, halo=halo)
    Ag1 = apply_combined(A0, Kv, dks, g1, halo=halo)
    solve = make_solve(dks, s, sm)

    # times as (step0 + i)·dt in ONE rounding, so a chunked run's absolute
    # times are bitwise those of the unchunked run
    ts = (torch.arange(1, num_steps + 1, dtype=cdt, device=device)
          + float(step0)) * dt
    U = torch.as_tensor(u0, dtype=cdt, device=device)
    U_pp = torch.as_tensor(u_pp, dtype=cdt, device=device)
    B = U.shape[0]
    watch = ops["watch"]
    traces = []
    for n in range(num_steps):
        amp = interp(ts[n], ops["heat_t"], ops["heat_T"]) - amp_offset
        Bv = apply_stencil(ops["M_op"], U, halo=halo)
        if inplace:
            Bv -= Ag0 + amp * Ag1      # in place: one plane fewer a step
            Bv *= sm
        else:
            Bv = (Bv - (Ag0 + amp * Ag1)) * sm
        seed = 2.0 * U - U_pp if extrapolate else U
        Y0 = seed / s * free
        X, iters = solve(Bv, Y0)
        del Bv, Y0, seed
        Un = X * sm
        if inplace:
            Un += g0 + amp * g1
        else:
            Un = Un + (g0 + amp * g1)
        traces.append(Un.reshape(B, -1)[:, watch])
        if iters_out is not None:
            iters_out.append(iters)
        if project is not None:
            project(Un)
        U_pp, U = U, Un
    return torch.stack(traces, dim=1), U, U_pp


def vmem_sweep_scan(ops, ks, fs, u0, u_pp, step0, *, dtype, ic, dt,
                    num_steps, base_k, fixed_iters, rtol, maxiter,
                    extrapolate, rline=False, adi=False, rtol_wrt="b",
                    f64_refine=0, record=None, proj_rtol=1e-11,
                    proj_maxiter=400, adaptive=False, adaptive_thresh=100,
                    iters_out=None, proj_iters_out=None):
    """Whole-batch backward-Euler loop with the batched kernels
    (:func:`cg_batched_tol`, or :func:`cg_batched` for ``fixed_iters``).
    ``ops`` holds the stencils A0/K_var/M_op, the masks free/dirich, r_sq,
    the heating line ``base``, the heating curve heat_t/heat_T and the flat
    watcher ids ``watch``, all on one device. ``u_pp`` is the u_{n-1}
    history entering the segment (u0 for a fresh start), ``step0`` the
    integer step offset of the segment. Returns (traces (B, S, W), u_fin,
    u_penultimate).

    ``f64_refine=N``: ``ops`` hold float64 tensors; each step runs N passes
    of float64 residual around a float32 batched correction solve from a
    zero seed with a unit-norm right-hand side, the fields carried in
    float64 (the per-lane guard ``refine_inner_scale`` stops a lane whose
    residual is at float64 roundoff).

    ``rline``: the r-line preconditioner; ``adi``: the split-additive ADI
    one (r-line and z-line). ``adaptive``: per lane and step, the ADI form
    for a lane whose previous step took more than ``adaptive_thresh``
    iterations (under ``f64_refine``, its last inner pass), the r-line form
    otherwise; the flags are formed on the device from the previous counts,
    with no host read, and every lane starts at ``maxiter`` (the first step
    of a scan, so of every time chunk, runs ADI).

    ``record``: a dict with the projection stencils ``Mp``/``Gr``, the
    scaling plane ``s_mp``, the band's ``band_slots``/``band_fill``/
    ``bin_counts`` (see :func:`band_average`) and the flat
    ``axis_nodes``. Each step then also solves every
    lane's r-weighted mass projection s_mp·Mp·s_mp y = s_mp·(Gr u) in
    ``dtype``, through the Kv-free form of :func:`cg_batched_tol` (stop at
    ``proj_rtol``·‖b‖, at most ``proj_maxiter`` iterations), seeded from
    the previous step's gradient (or 2·GR − GR_prev under ``extrapolate``;
    both start at 0), and the first return value is the dict {watch (B, S,
    W), band (B, S, n_bins), axis (B, S, Nz)}. ``proj_iters_out``, a list,
    receives each step's (B,) projection counts."""
    from heatflow_tpu_torch.ops.cuda_sweep import cg_batched, cg_batched_tol
    if adaptive and (rline or adi):
        raise ValueError("adaptive replaces the static rline/adi flags")
    if adaptive and fixed_iters is not None:
        raise ValueError("the adaptive switch is tolerance-based (iteration "
                         "counts drive it); drop fixed_iters")
    cdt = torch.float64 if f64_refine else dtype
    A0, Kv = ops["A0"], ops["K_var"]
    c32 = lambda t: t.to(dtype).contiguous()

    def make_solve(dks, s, sm):
        # adaptive: the previous step's per-lane counts, cold start maxiter
        its_prev = torch.full(dks.shape, maxiter, dtype=torch.int32,
                              device=dks.device)

        def form():
            if not adaptive:
                return dict(rline=rline, adi=adi)
            return dict(adi_flags=(its_prev > adaptive_thresh)
                        .to(torch.int32))

        def adapt(solve):
            def run(Bv, Y0):
                nonlocal its_prev
                X, its = solve(Bv, Y0)
                its_prev = its
                return X, its
            return run if adaptive else solve

        if f64_refine:
            # float32 casts of the scaled system for the correction solves;
            # the float64 operator computes only the residuals
            k32 = (c32(A0), c32(Kv), c32(dks), c32(sm))

            def solve(Bv, Y0):
                # a residual at f64 roundoff of the step's rhs has nothing
                # left to correct: rtol_eff = 2 stops that lane at once.
                # Per-lane sums in a fixed order: a lane's bits do not
                # depend on the batch
                floor2 = 1e-30 * lane_sum(Bv * Bv)
                Y = Y0
                Z0 = torch.zeros(Bv.shape, dtype=dtype, device=Bv.device)
                kw = form()      # one switch a step, for every pass
                for _ in range(f64_refine):
                    R = Bv - sm * apply_combined(A0, Kv, dks, sm * Y)
                    rnorm, rtol_eff = refine_inner_scale(
                        lane_sum(R * R), floor2, rtol, dtype)
                    dY, its = cg_batched_tol(
                        *k32, c32(R / _lane(rnorm)), Z0, rtol_eff,
                        maxiter=maxiter, rtol_wrt="b", **kw)
                    Y = Y + dY.to(cdt) * _lane(rnorm)
                return Y, its
        elif fixed_iters is not None:
            def solve(Bv, Y0):
                X = cg_batched(A0, Kv, dks, sm, Bv, Y0, iters=fixed_iters)
                return X, torch.full((X.shape[0],), fixed_iters,
                                     dtype=torch.int32, device=X.device)
        else:
            def solve(Bv, Y0):
                return cg_batched_tol(A0, Kv, dks, sm, Bv, Y0, rtol,
                                      maxiter=maxiter, rtol_wrt=rtol_wrt,
                                      **form())
        return adapt(solve)

    project, rows = None, {}
    if record is not None:
        # the projection runs in the kernel dtype, float32 under refine too
        Mp = c32(record["Mp"])
        Gr = record["Gr"].to(dtype)
        s_mp = c32(record["s_mp"])
        bin_counts = record["bin_counts"].to(dtype)
        rows.update(band=[], axis=[], GR=None, GR_pp=None)

        def project(U):
            with span("sweep.project"):
                if rows["GR"] is None:
                    rows["GR"] = rows["GR_pp"] = torch.zeros(
                        U.shape, dtype=dtype, device=U.device)
                br = s_mp * apply_stencil(Gr, U.to(dtype))
                seed = (2.0 * rows["GR"] - rows["GR_pp"] if extrapolate
                        else rows["GR"])
                Xp, its = cg_batched_tol(
                    Mp, None, None, s_mp, br.contiguous(),
                    (seed / s_mp).contiguous(), proj_rtol,
                    maxiter=proj_maxiter, rtol_wrt="b")
                gr = Xp * s_mp
                flat = gr.reshape(gr.shape[0], -1)
                rows["band"].append(band_average(
                    flat, record["band_slots"], record["band_fill"],
                    bin_counts))
                rows["axis"].append(flat[:, record["axis_nodes"]])
                rows["GR_pp"], rows["GR"] = rows["GR"], gr
                if proj_iters_out is not None:
                    proj_iters_out.append(its)

    with span("sweep.chunk"):
        traces, u_fin, u_pen = _sweep_scan(
            ops, ks, fs, u0, u_pp, step0, cdt=cdt, ic=ic, dt=dt,
            num_steps=num_steps, base_k=base_k, extrapolate=extrapolate,
            make_solve=make_solve, iters_out=iters_out, project=project)
    if record is None:
        return traces, u_fin, u_pen
    return ({"watch": traces, "band": torch.stack(rows["band"], dim=1),
             "axis": torch.stack(rows["axis"], dim=1)}, u_fin, u_pen)


def _mg_preconditioner(mg, dks, s):
    """The geometric multigrid V-cycle of every lane's operator, conjugated
    into the scaled system: pre(r̃) = S⁻¹ vcycle(S⁻¹ r̃). ``mg``: the
    hierarchy's device levels with the base operator 'A0' and the varied
    material's stiffness 'K_var' on each (RAP is linear in the coefficients,
    so lane b's level operator is A0 + dk_b·K_var there too)."""
    from heatflow_tpu_torch.ops.multigrid import make_vcycle
    dk = dks.reshape(-1, 1, 1, 1)
    level_ops = [{**lv, "A": lv["A0"] + dk * lv["K_var"]} for lv in mg]
    vcycle = make_vcycle(level_ops, nu_pre=1, nu_post=1)
    inv_s = 1.0 / torch.where(s > 0, s, torch.ones_like(s))
    return lambda r: inv_s * vcycle(inv_s * r)


def _preconditioner(ops, precondition, dks, s):
    """The eager batch's preconditioner of the scaled system, or None: a
    per-lane line preconditioner factored once per scan from A0 + dk_b·Kv
    (two coupling planes combined per lane), the ADI composition, or the
    multigrid V-cycle of each lane's operator."""
    from heatflow_tpu_torch.ops.linesolve import (adi_preconditioner,
                                                  line_preconditioner)
    A0, Kv, free = ops["A0"], ops["K_var"], ops["free"]
    if precondition == "mg":
        return _mg_preconditioner(ops["mg"], dks, s)
    if precondition == "adi":
        return adi_preconditioner(A0, s, free, Kv=Kv, dk=dks)
    if precondition in ("rline", "zline"):
        return line_preconditioner(
            A0, s, free, axis=-1 if precondition == "rline" else -2,
            Kv=Kv, dk=dks)
    return None


def _xla_solver(ops, *, precondition, fixed_iters, rtol, maxiter, rtol_wrt,
                zax=None, full_ops=None):
    """The eager batched solve: pcg (per-lane freeze) or pcg_fixed on
    sm·A_b·sm with :func:`_preconditioner`. ``zax``: ``ops`` hold z-sharded
    slabs (``parallel.sharding.ZAxis``): the stencil applies exchange
    halos, the dots add the ranks' partial sums, 'jacobi' and 'rline' run
    on the slab (row-local), and 'zline', 'adi' and 'mg', which couple
    rows, run replicated on the full field (``full_ops``) through
    ``ZAxis.full``."""
    A0, Kv, free = ops["A0"], ops["K_var"], ops["free"]
    halo = None if zax is None else zax.halo
    dot = None if zax is None else zax.dots

    def make_solve(dks, s, sm):
        apply_op = lambda y: sm * apply_combined(A0, Kv, dks, sm * y,
                                                 halo=halo)
        if zax is not None and precondition in ("zline", "adi", "mg"):
            pre = zax.full(_preconditioner(full_ops, precondition, dks,
                                           zax.gather(s)))
        else:
            pre = _preconditioner(ops, precondition, dks, s)

        def solve(Bv, Y0):
            if fixed_iters is not None:
                sol = pcg_fixed(apply_op, Bv, Y0, precond=pre, mask=free,
                                iters=fixed_iters, dot=dot)
            else:
                sol = pcg(apply_op, Bv, Y0, precond=pre, mask=free,
                          rtol=rtol, maxiter=maxiter, rtol_wrt=rtol_wrt,
                          dot=dot)
            return sol.x, sol.iters

        return solve

    return make_solve


def _sweep_ops(problem: Problem2D, vary_material: str, wdt, device):
    """(ops, base_k, dt, ic, dev): the stencils, masks, heating and watcher
    tensors a batched scan reads (see :func:`vmem_sweep_scan`), in ``wdt``
    on ``device``, with the problem's device arrays."""
    dev = problem.device_arrays(wdt, device)
    if "watch_flat" not in dev:
        raise ValueError("sweeps need watcher points on the problem")
    dt = torch.tensor(problem.dt, dtype=wdt, device=device)
    ic = torch.tensor(problem.ic_temp, dtype=wdt, device=device)
    m_idx = material_index(problem.mesh, vary_material)
    base_k = float(problem.kappas[m_idx])
    A0, M_op = combine_operator(dev["K"], dev["M"], dev["kappas"],
                                dev["rho_cvs"], dt)
    ops = {"A0": A0.contiguous(), "M_op": M_op,
           "K_var": dev["K"][m_idx].contiguous(),
           "free": dev["free"], "dirich": dev["dirichlet"],
           "base": dev["heat_profile_base"], "r_sq": dev["r_sq"],
           "heat_t": dev["heat_t"], "heat_T": dev["heat_T"],
           "watch": dev["watch_flat"]}
    return ops, base_k, dt, ic, dev


def make_sweep_fn(problem: Problem2D, *, vary_material: str = "p_sample",
                  dtype: torch.dtype = torch.float32, rtol: float = 1e-6,
                  maxiter: int = 4000, fixed_iters: int | None = None,
                  precondition: str = "jacobi",
                  num_steps: int | None = None, mesh=None,
                  solver: str = "xla", warm_start: str = "previous",
                  rtol_wrt: str = "b", f64_refine: int = 0, device="cuda"):
    """Build ``simulate_batch(sample_k (B,), fwhm (B,)) -> traces (B, S, W)``
    (a tensor on ``device``: the card unless the caller passes
    ``device='cpu'``; a missing card raises).

    ``simulate_batch.segment(ks, fs, u0, step0, u_pp=None, iters_out=None)``
    also returns the final and penultimate fields, for time-chunked runs
    with exact warm-start history across chunks (set ``num_steps`` to the
    chunk length); ``iters_out``, a list, receives each step's (B,) CG
    iteration counts. ``simulate_batch.one_config(k, f)`` runs one config
    and is differentiable in ``k`` and ``f`` (reverse and forward mode):
    each step is one implicitly differentiated solve, through the
    ``cg_tol`` kernel (:func:`cg_vmem_solve`) with ``solver='vmem'`` (float32
    on a card, any dtype on the CPU; 'rline' and 'adaptive' run the r-line
    stack, 'adi' both stacks, packed per call), else through
    :func:`pcg_solve`. The batch path runs without autograd.

    ``solver='vmem'``: the batched CUDA kernels (K2 tolerance form, K3 for
    ``fixed_iters``), which the plain versions stand in for on CPU
    tensors; ``precondition`` 'jacobi' (scaled identity), 'rline', 'adi'
    (r-line + z-line) or 'adaptive' (the per-lane, per-step r-line/ADI
    switch). ``solver='xla'``: the eager batched PCG; 'jacobi', 'rline',
    'zline', 'adi' or 'mg' (the geometric multigrid V-cycle, its hierarchy
    built once here).

    ``rtol_wrt``: 'b' stops each solve at ‖r‖ ≤ rtol·‖b‖, 'r0' at
    rtol·‖r0‖. ``warm_start='extrapolate'`` seeds each step with
    2·u_n − u_{n−1}. ``f64_refine=N`` (solver='vmem', float32): N float64
    refinement passes around the float32 kernel solve, fields in float64.

    Memoized on ``problem.extras`` keyed by every argument; mutating the
    problem afterwards does not invalidate the cache. An unstructured
    problem goes to ``sim.unstructured.make_sweep_fn_unstructured``
    ('jacobi', 'rline' or 'adi' on 'vmem', 'jacobi' on 'xla'; no
    ``one_config``).
    """
    if not isinstance(problem, Problem2D):
        from heatflow_tpu_torch.sim.unstructured import \
            make_sweep_fn_unstructured
        return make_sweep_fn_unstructured(
            problem, vary_material=vary_material, dtype=dtype, rtol=rtol,
            maxiter=maxiter, fixed_iters=fixed_iters, warm_start=warm_start,
            solver=solver, num_steps=num_steps, mesh=mesh,
            rtol_wrt=rtol_wrt, precondition=precondition,
            f64_refine=f64_refine, device=device)
    if f64_refine:
        rtol_wrt = "b"   # the refined inner solves stop wrt their own rhs
    device = _mesh_device(mesh, device)
    n_steps = int(problem.num_steps if num_steps is None else num_steps)
    cache_key = ("sweep_fn", vary_material, str(dtype), rtol, maxiter,
                 fixed_iters, precondition, n_steps, mesh, solver,
                 warm_start, rtol_wrt, f64_refine, str(device))
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if warm_start not in ("previous", "extrapolate"):
        raise ValueError(f"unknown warm_start {warm_start!r} for sweep "
                         "engines (use 'previous' or 'extrapolate')")
    if precondition not in ("jacobi", "mg", "rline", "zline", "adi",
                            "adaptive"):
        raise ValueError(f"unknown precondition {precondition!r}")
    if rtol_wrt not in ("r0", "b"):
        raise ValueError(f"unknown rtol_wrt {rtol_wrt!r}")
    if solver not in ("xla", "vmem"):
        raise ValueError(f"unknown solver {solver!r}")
    if precondition == "adaptive" and solver != "vmem":
        raise ValueError("precondition='adaptive' requires solver='vmem' "
                         "for sweeps (the per-lane switch lives in the "
                         "batched kernel)")
    if f64_refine:
        if dtype != torch.float32:
            raise ValueError("f64_refine is the mixed-precision mode: "
                             "dtype must be float32")
        if solver != "vmem":
            raise ValueError("f64_refine sweeps run through solver='vmem' "
                             "(the batched correction kernel)")
        if fixed_iters is not None:
            raise ValueError("f64_refine composes with the tolerance-based "
                             "solve (drop fixed_iters)")
        if precondition == "adi":
            # the refined inner solves stop wrt 'b', the loose regime where
            # ADI's loosely stopped iterates carry ~20x the solution error of
            # jacobi/rline at the same ||r|| (the JAX package's
            # cg_vmem_batched_tol), and the last pass is never re-checked
            warnings.warn(
                "precondition='adi' with f64_refine: the last refinement "
                "pass's adi correction error is unchecked (inner solves "
                "stop wrt 'b', the regime where adi carries ~20x the "
                "equal-rtol solution error); prefer precondition='rline' "
                "for refined sweeps", stacklevel=2)
    if solver == "vmem":
        _config_axis_only(mesh)
        if precondition in ("zline", "mg"):
            raise ValueError("solver='vmem' supports precondition='jacobi' "
                             "(scaled identity), 'rline' (r-line PCR), 'adi' "
                             "(r-line + z-line) or 'adaptive' (per-lane "
                             "per-step rline/adi switch)")
        if precondition in ("rline", "adi", "adaptive") \
                and fixed_iters is not None:
            raise ValueError(f"{precondition}-preconditioned vmem sweeps are "
                             "tolerance-based (drop fixed_iters)")

    wdt = torch.float64 if f64_refine else dtype
    ops, base_k, dt, ic, dev = _sweep_ops(problem, vary_material, wdt, device)
    nz, nr = problem.mesh.shape
    extrapolate = warm_start == "extrapolate"
    if precondition == "mg":
        from heatflow_tpu_torch.ops.multigrid import (build_hierarchy,
                                                      device_levels)
        m_idx = material_index(problem.mesh, vary_material)
        ops["mg"] = []
        for lv in device_levels(build_hierarchy(
                problem.mesh, problem.dirichlet_mask,
                stencils=problem.stencils), dtype, device):
            A_l, _ = combine_operator(lv["K"], lv["M"], dev["kappas"],
                                      dev["rho_cvs"], dt)
            ops["mg"].append({**lv, "A0": A_l, "K_var": lv["K"][m_idx]})

    # z-sharding (the eager path): this rank's rows of the stencils, masks
    # and fields; the watchers are read on the ranks that own their rows
    zax, lops = None, ops
    if mesh is not None and mesh.shape["z"] > 1 and nz % mesh.shape["z"] == 0:
        from heatflow_tpu_torch.parallel.sharding import ZAxis
        zax = ZAxis(mesh, nz, nr)
        lops = {k: zax.rows(v) if k in _Z_SHARDED else v
                for k, v in ops.items() if k != "mg"}
        lops["watch"], w_owner = zax.local_ids(ops["watch"])
    nz_l = nz if zax is None else zax.n_rows

    def core(ks, fs, u0, u_pp, step0, iters_out=None):
        kw = dict(ic=ic, dt=dt, num_steps=n_steps, base_k=base_k,
                  extrapolate=extrapolate, iters_out=iters_out)
        with torch.no_grad():
            if solver == "vmem":
                return vmem_sweep_scan(
                    ops, ks, fs, u0, u_pp, step0, dtype=dtype,
                    fixed_iters=fixed_iters, rtol=rtol, maxiter=maxiter,
                    rline=precondition == "rline",
                    adi=precondition == "adi",
                    adaptive=precondition == "adaptive", rtol_wrt=rtol_wrt,
                    f64_refine=f64_refine, **kw)
            make_solve = _xla_solver(lops, precondition=precondition,
                                     fixed_iters=fixed_iters, rtol=rtol,
                                     maxiter=maxiter, rtol_wrt=rtol_wrt,
                                     zax=zax, full_ops=ops)
            tr, u_fin, u_pen = _sweep_scan(
                lops, ks, fs, u0, u_pp, step0, cdt=wdt,
                make_solve=make_solve,
                halo=None if zax is None else zax.halo, **kw)
            if zax is not None:
                tr = zax.owned(tr, w_owner)
            return tr, u_fin, u_pen

    def simulate_batch(sample_k, fwhm, iters_out=None):
        B = len(np.atleast_1d(np.asarray(sample_k)))
        u0 = torch.full((B, nz_l, nr), float(problem.ic_temp), dtype=wdt,
                        device=device)
        return core(sample_k, fwhm, u0, u0, 0, iters_out)[0]

    def segment(sample_k, fwhm, u0, step0, u_pp=None, iters_out=None):
        """(traces (B, S, W), u_fin, u_penultimate) for one time chunk
        starting after integer step offset ``step0`` (times are formed as
        (step0+i)·dt, so chunked runs hit the unchunked times bitwise).
        Pass the previous chunk's u_penultimate as ``u_pp`` so
        warm_start='extrapolate' seeds the chunk's first step from real
        history (omitted: seeds from u0, a fresh start). Under a mesh it
        works on this rank's shard: its lanes and its rows
        (``local_shape``)."""
        u0 = torch.as_tensor(u0, dtype=wdt, device=device)
        u_pp = u0 if u_pp is None else u_pp
        return core(sample_k, fwhm, u0, u_pp, int(step0), iters_out)

    # one config rides the cg_tol kernel when the batch rides K2 (float32 on
    # a card; the plain version on the CPU); f64_refine keeps its plain
    # float64 solve, a fixed budget the pcg_fixed trajectory
    vmem_one = (solver == "vmem" and fixed_iters is None and not f64_refine
                and (device.type == "cpu" or dtype == torch.float32))

    def one_config(sample_k, fwhm):
        """Traces (S, W) of one config, differentiable in ``sample_k`` and
        ``fwhm`` (0-d tensors that require grad or carry tangents): the
        batch loop for one lane, out of place, with each step's solve
        implicitly differentiated."""
        from heatflow_tpu_torch.ops.cuda_cg import (cg_vmem_solve,
                                                    rline_pack, zline_pack)
        from heatflow_tpu_torch.ops.linesolve import (adi_preconditioner,
                                                      line_preconditioner)
        A0, Kv, free = ops["A0"], ops["K_var"], ops["free"]

        def make_solve(dks, s, sm):
            # the preconditioner only steers the solve: never differentiated
            s_d, dks_d = s.detach(), dks.detach()
            if vmem_one:
                A_full = A0 + dks[0] * Kv
                stacks = {}
                if precondition in ("rline", "adi", "adaptive"):
                    # 'adaptive' has no per-step switch here (one solve a
                    # call): it runs the static r-line factors
                    stacks["pcr"] = rline_pack(A_full.detach(), s_d[0], free)
                if precondition == "adi":
                    stacks["pcr_z"] = zline_pack(A_full.detach(), s_d[0],
                                                 free)

                def solve(Bv, Y0):
                    return cg_vmem_solve(A_full, sm[0], Bv[0], Y0[0], rtol,
                                         maxiter=maxiter, rtol_wrt=rtol_wrt,
                                         **stacks)[None], None
                return solve

            pre = None
            if precondition == "mg":
                pre = _mg_preconditioner(ops["mg"], dks_d, s_d)
            elif precondition == "adi":
                pre = adi_preconditioner(A0, s_d, free, Kv=Kv, dk=dks_d)
            elif precondition in ("rline", "zline"):
                pre = line_preconditioner(
                    A0, s_d, free, axis=-1 if precondition == "rline" else -2,
                    Kv=Kv, dk=dks_d)
            op = lambda y, sm, dks: sm * apply_combined(A0, Kv, dks, sm * y)

            def solve(Bv, Y0):
                if fixed_iters is not None:
                    return pcg_fixed(lambda y: op(y, sm, dks), Bv, Y0,
                                     precond=pre, mask=free,
                                     iters=fixed_iters).x, None
                return pcg_solve(op, Bv, Y0, op_args=(sm, dks), precond=pre,
                                 mask=free, rtol=rtol, maxiter=maxiter,
                                 rtol_wrt=rtol_wrt), None
            return solve

        lane = lambda v: torch.as_tensor(v, dtype=wdt,
                                         device=device).reshape(1)
        u0 = torch.full((1, nz, nr), float(problem.ic_temp), dtype=wdt,
                        device=device)
        traces, _, _ = _sweep_scan(
            ops, lane(sample_k), lane(fwhm), u0, u0, 0, cdt=wdt, ic=ic, dt=dt,
            num_steps=n_steps, base_k=base_k, extrapolate=extrapolate,
            make_solve=make_solve, inplace=False)
        return traces[0]

    simulate_batch.segment = segment
    simulate_batch.one_config = one_config
    simulate_batch.shape = (nz, nr)
    simulate_batch.local_shape = (nz_l, nr)
    simulate_batch.ic_temp = float(problem.ic_temp)
    simulate_batch.dt = float(problem.dt)
    simulate_batch.times = np.arange(1, n_steps + 1) * problem.dt
    simulate_batch.device = device
    if mesh is not None:
        from heatflow_tpu_torch.parallel.sharding import shard_configs
        simulate_batch = shard_configs(mesh, simulate_batch)
    cache[cache_key] = simulate_batch
    return simulate_batch


def _recording_vmem(problem: Problem2D, *, vary_material, dtype, rtol,
                    maxiter, fixed_iters, warm_start, rtol_wrt, f64_refine,
                    precondition, proj_rtol, proj_maxiter, device):
    """Recording sweeps through the batched kernels: each step's solve and
    its gradient projection run for every lane together
    (:func:`vmem_sweep_scan` with ``record``)."""
    if warm_start not in ("previous", "extrapolate"):
        raise ValueError(f"unknown warm_start {warm_start!r} for sweep "
                         "engines (use 'previous' or 'extrapolate')")
    if f64_refine:
        if dtype != torch.float32:
            raise ValueError("f64_refine is the mixed-precision mode: "
                             "dtype must be float32")
        if fixed_iters is not None:
            raise ValueError("f64_refine composes with the tolerance-based "
                             "solve (drop fixed_iters)")
    if precondition not in ("jacobi", "rline", "adi", "adaptive"):
        raise ValueError("solver='vmem' supports precondition='jacobi', "
                         "'rline', 'adi' or 'adaptive'")
    if precondition in ("rline", "adi", "adaptive") \
            and fixed_iters is not None:
        raise ValueError(f"{precondition}-preconditioned vmem sweeps are "
                         "tolerance-based (drop fixed_iters)")
    nz, nr = problem.mesh.shape
    wdt = torch.float64 if f64_refine else dtype
    ops, base_k, dt, ic, dev = _sweep_ops(problem, vary_material, wdt,
                                          device)
    M_proj = dev["M_proj"]
    s_mp = torch.rsqrt(torch.where(M_proj[0] > 0, M_proj[0],
                                   torch.ones_like(M_proj[0])))
    record = {"Mp": M_proj, "Gr": dev["G_r"], "s_mp": s_mp,
              "band_slots": dev["band_slots"], "band_fill": dev["band_fill"],
              "bin_counts": dev["bin_counts"],
              # structured axis rows are lattice column r = 0
              "axis_nodes": torch.arange(nz, device=device) * nr}

    def simulate_batch(sample_k, fwhm, iters_out=None, proj_iters_out=None):
        B = len(np.atleast_1d(np.asarray(sample_k)))
        u0 = torch.full((B, nz, nr), float(problem.ic_temp), dtype=wdt,
                        device=device)
        with torch.no_grad(), span("sweep"):
            ys = vmem_sweep_scan(
                ops, sample_k, fwhm, u0, u0, 0, dtype=dtype, ic=ic, dt=dt,
                num_steps=int(problem.num_steps), base_k=base_k,
                fixed_iters=fixed_iters, rtol=rtol, maxiter=maxiter,
                extrapolate=warm_start == "extrapolate",
                rline=precondition == "rline", adi=precondition == "adi",
                adaptive=precondition == "adaptive", rtol_wrt=rtol_wrt,
                f64_refine=f64_refine, record=record, proj_rtol=proj_rtol,
                proj_maxiter=proj_maxiter, iters_out=iters_out,
                proj_iters_out=proj_iters_out)[0]
        ys["times"] = simulate_batch.times
        return ys

    return simulate_batch


def _recording_xla(problem: Problem2D, *, vary_material, dtype, rtol,
                   maxiter, fixed_iters, warm_start, rtol_wrt, f64_refine,
                   precondition, proj_rtol, proj_maxiter, device):
    """Recording sweeps through the eager stepper (``make_simulate_fn`` with
    ``record_gradient=True``, ``solver='xla'``), run once per lane with the
    lane's conductivities and FWHM."""
    fn = make_simulate_fn(problem, dtype=dtype, device=device, rtol=rtol,
                          maxiter=maxiter, fixed_iters=fixed_iters,
                          record_gradient=True, warm_start=warm_start,
                          rtol_wrt=rtol_wrt, f64_refine=f64_refine,
                          precondition=precondition, proj_rtol=proj_rtol,
                          proj_maxiter=proj_maxiter, solver="xla")
    m_idx = material_index(problem.mesh, vary_material)
    base_kp = np.asarray(problem.kappas, float)

    def simulate_batch(sample_k, fwhm, iters_out=None, proj_iters_out=None):
        ks = np.atleast_1d(np.asarray(sample_k, float))
        fs = np.atleast_1d(np.asarray(fwhm, float))
        runs = []
        for k, f in zip(ks, fs):
            kp = base_kp.copy()
            kp[m_idx] = k
            runs.append(fn(kappas=kp, fwhm=f))
        stack = lambda key, dim: torch.stack([r[key] for r in runs], dim=dim)
        if iters_out is not None:
            iters_out.extend(stack("cg_iters", 1))
        if proj_iters_out is not None:
            proj_iters_out.extend(stack("proj_iters", 1))
        return {"watch": stack("watch", 0), "band": stack("band", 0),
                "axis": stack("axis", 0), "times": simulate_batch.times}

    return simulate_batch


def make_sweep_fn_recording(problem: Problem2D, *,
                            vary_material: str = "p_sample",
                            dtype: torch.dtype = torch.float32,
                            rtol: float = 1e-6, maxiter: int = 4000,
                            fixed_iters: int | None = None,
                            warm_start: str = "previous", mesh=None,
                            rtol_wrt: str = "b", f64_refine: int = 0,
                            solver: str = "xla",
                            precondition: str = "jacobi",
                            proj_rtol: float = 1e-11,
                            proj_maxiter: int = 400, device="cuda"):
    """Full-surface sweep: every lane also records the reference's radial
    gradient rows each step (ref parameter_sweep.py:157-166 →
    run_no_diamond.py:602-617), the per-step r-weighted projection of the
    2D stepper. Returns ``simulate_batch(ks, fs, iters_out=None,
    proj_iters_out=None)`` -> dict with ``watch`` (B, S, W), ``band`` (B, S,
    n_bins), ``axis`` (B, S, Nz) tensors on ``device`` (the card unless the
    caller passes ``device='cpu'``) and the host ``times``; ``iters_out`` /
    ``proj_iters_out``, lists, receive each step's (B,) solve / projection
    iteration counts.

    ``solver='vmem'``: solve and projection through the batched kernels
    (their plain versions on the CPU); ``'jacobi'``, ``'rline'``, ``'adi'``
    or ``'adaptive'``. ``solver='xla'``: the eager stepper once per lane.

    Memoized on ``problem.extras`` keyed by every argument. An
    unstructured problem goes to the recording form of
    ``sim.unstructured.make_sweep_fn_unstructured``, whose projection
    stops at the defaults.
    """
    if f64_refine:
        rtol_wrt = "b"   # no effect on the refined inner solves
    device = _mesh_device(mesh, device)
    cache_key = ("sweep_fn_rec", vary_material, str(dtype), rtol, maxiter,
                 fixed_iters, warm_start, mesh, rtol_wrt, f64_refine, solver,
                 precondition, proj_rtol, proj_maxiter, str(device))
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if not isinstance(problem, Problem2D):
        # the unstructured maker's projection: 1e-11 ('xla': ``rtol``), 400
        if (proj_rtol, proj_maxiter) != (1e-11, 400):
            raise ValueError("unstructured recording sweeps take the "
                             "default projection tolerance")
        from heatflow_tpu_torch.sim.unstructured import \
            make_sweep_fn_unstructured
        simulate_batch = make_sweep_fn_unstructured(
            problem, vary_material=vary_material, dtype=dtype, rtol=rtol,
            maxiter=maxiter, fixed_iters=fixed_iters, warm_start=warm_start,
            solver=solver, record_gradient=True, mesh=mesh,
            rtol_wrt=rtol_wrt, precondition=precondition,
            f64_refine=f64_refine, device=device)
        cache[cache_key] = simulate_batch
        return simulate_batch
    if problem.radial is None:
        raise ValueError("gradient-recording sweeps need radial sampling "
                         "on the problem")
    if solver not in ("xla", "vmem"):
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "vmem":
        _config_axis_only(mesh)
    make = _recording_vmem if solver == "vmem" else _recording_xla
    simulate_batch = make(
        problem, vary_material=vary_material, dtype=dtype, rtol=rtol,
        maxiter=maxiter, fixed_iters=fixed_iters, warm_start=warm_start,
        rtol_wrt=rtol_wrt, f64_refine=f64_refine, precondition=precondition,
        proj_rtol=proj_rtol, proj_maxiter=proj_maxiter, device=device)
    simulate_batch.times = np.arange(1, problem.num_steps + 1) * problem.dt
    simulate_batch.band_centers = problem.radial.bin_centers
    simulate_batch.axis_z = problem.radial.axis_z
    simulate_batch.watcher_names = list(problem.watcher_names)
    simulate_batch.device = device
    if mesh is not None:
        # the configs over the mesh; a 'z' axis replicates (each rank of a
        # z group runs its config shard whole, as the JAX package's maker)
        from heatflow_tpu_torch.parallel.sharding import shard_configs
        simulate_batch = shard_configs(mesh, simulate_batch)
    cache[cache_key] = simulate_batch
    return simulate_batch


def balanced_chunk_len(total: int, step_chunk: int) -> int:
    """Balance chunk lengths over ceil(total/step_chunk) chunks: a ragged
    final chunk re-runs the full segment and discards the surplus steps.
    Ceil-balancing (40 → 20+20) never exceeds step_chunk and cuts the
    discarded surplus to < n_chunks steps in all."""
    total = int(total)
    n_chunks = max(1, -(-total // max(1, int(step_chunk))))
    return min(-(-total // n_chunks), total)


def run_sweep_time_chunked(problem: Problem2D, sample_k, fwhm, *,
                           step_chunk: int = 10,
                           dtype: torch.dtype = torch.float32,
                           fixed_iters: int | None = None,
                           rtol: float = 1e-5, maxiter: int = 4000,
                           precondition: str = "jacobi",
                           verbose: bool = False, mesh=None,
                           solver: str = "xla",
                           warm_start: str = "previous",
                           rtol_wrt: str = "b", f64_refine: int = 0,
                           device="cuda", iters_out=None) -> np.ndarray:
    """The full transient of a (possibly very large) batch, integrated in
    time chunks of at most ``step_chunk`` steps (ceil-balanced), the whole
    batch resident on ``device`` (the card unless the caller passes
    ``device='cpu'``). Returns traces (B, num_steps, W) as numpy.

    ``warm_start='extrapolate'`` is exact across chunk boundaries: each
    chunk's penultimate field enters the next, so the chunked trajectory
    equals the unchunked one bitwise. ``iters_out``, a list, receives each
    step's (B,) CG iteration counts. An unstructured problem chunks through
    its overlay's lattice on the batched kernels (``solver='vmem'``).

    ``mesh`` (a ``parallel.sharding.DeviceMesh``; every rank calls with the
    same full batch): the batch is padded to a multiple of the 'config'
    size, each rank integrates its lanes chunk by chunk (and, on the eager
    path, its rows of the 'z' axis), and the traces are gathered once at
    the end and cut back to B on every rank."""
    total = int(problem.num_steps)
    chunk_len = balanced_chunk_len(total, step_chunk)
    if not isinstance(problem, Problem2D) and solver != "vmem":
        # overlay meshes chunk through the shared kernel scan
        raise ValueError("time-chunked unstructured sweeps run through "
                         "solver='vmem' (grid-overlay meshes)")
    fn = make_sweep_fn(problem, dtype=dtype, fixed_iters=fixed_iters,
                       rtol=rtol, maxiter=maxiter, precondition=precondition,
                       num_steps=chunk_len, mesh=mesh, solver=solver,
                       warm_start=warm_start, rtol_wrt=rtol_wrt,
                       f64_refine=f64_refine, device=device)

    def run(ks, fs, iters_out=None):
        u = torch.full((len(ks),) + getattr(fn, "local_shape", fn.shape),
                       fn.ic_temp, dtype=dtype, device=fn.device)
        u_pp = u
        pieces = []
        done = 0
        while done < total:
            n = min(chunk_len, total - done)
            # a ragged final chunk runs the full-length segment and keeps
            # its first n steps (past t_final the heating interpolation
            # clamps)
            its = []
            tr, u, u_pp = fn.segment(ks, fs, u, done, u_pp, iters_out=its)
            pieces.append(tr[:, :n])
            if iters_out is not None:
                iters_out.extend(its[:n])
            done += n
            if verbose:
                print(f"  time chunk done: {done}/{total} steps")
        return torch.cat(pieces, dim=1)

    if mesh is not None:
        from heatflow_tpu_torch.parallel.sharding import shard_configs
        run = shard_configs(mesh, run)
    with span("sweep"):
        return run(np.atleast_1d(np.asarray(sample_k)),
                   np.atleast_1d(np.asarray(fwhm)),
                   iters_out=iters_out).cpu().numpy()


def normalized_oside_residuals(times, traces, exp_time, exp_oside_normed,
                               pside_col: int = 0, oside_col: int = 1):
    """Per-experimental-point residuals of the reference's fit metric
    (normalized o-side trace minus experiment, ref no_diamond.py:65-99):
    traces (..., S, W) -> residuals (..., N_exp), as a tensor. A flat p-side
    trace has no normalization scale and gives +inf residuals."""
    traces = torch.as_tensor(traces)
    as_t = lambda v: torch.tensor(np.asarray(v), dtype=traces.dtype,
                                     device=traces.device)
    pside = traces[..., pside_col]
    oside = traces[..., oside_col]
    span = pside.amax(dim=-1) - pside.amin(dim=-1)
    degenerate = span <= 0
    denom = torch.where(degenerate, torch.ones_like(span), span)
    normed = (oside - oside[..., :1]) / denom[..., None]
    sim_at_exp = interp(as_t(exp_time), as_t(times), normed)
    res = sim_at_exp - as_t(exp_oside_normed)
    return torch.where(degenerate[..., None],
                       torch.full_like(res, float("inf")), res)


def normalized_oside_rmse(times, traces, exp_time, exp_oside_normed,
                          pside_col: int = 0, oside_col: int = 1):
    """The reference's fit metric: normalized o-side RMSE against the
    experimental trace (ref no_diamond.py:65-99, analysis_utils.py:66-93);
    traces (..., S, W) -> (...)."""
    err = normalized_oside_residuals(times, traces, exp_time,
                                     exp_oside_normed, pside_col, oside_col)
    return torch.sqrt(torch.mean(err * err, dim=-1))

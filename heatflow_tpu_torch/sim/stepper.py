"""Backward-Euler transient stepper: one CUDA graph on the kernel path, a
Python loop of device steps elsewhere.

The reference's hot loop (run_no_diamond.py:529-589) does, per step: update
the heating BC, re-assemble the RHS, a MUMPS back-substitution, a second
solve for the r-weighted L2 gradient projection, then sampling of watcher
points and radial bands. Here each step is:

  * BC values: one interpolation of the heating curve and a precomputed
    Gaussian profile; the Dirichlet lift A g is affine in the amplitude, so
    A g0 and A g1 are applied once per run;
  * RHS: one stencil application (M_op @ u_n);
  * solve: PCG on the symmetrically Jacobi-scaled operator, eager
    (``solver='xla'``; preconditioned by nothing, a line solve, the ADI
    composition or the geometric multigrid V-cycle) or through the CUDA
    kernel (``solver='vmem'``,
    :func:`heatflow_tpu_torch.ops.cuda_cg.cg_tol`, in its r-line, ADI,
    adaptive, Chebyshev or mgz form), optionally inside f64 residual
    refinement passes;
  * gradient projection: stencil rhs (G_r @ u) and a mass-matrix PCG;
  * watcher traces, band averages and axis profiles gathered on the device
    and stacked at the end.

On the card the kernel path (``solver='vmem'``, or 'auto' in float32)
without the gradient projection runs the whole transient as one CUDA graph
(``ops/cuda_step``: the step's elementwise work as four kernels around
``cg_tol``'s recorded solve, the adaptive r-line/ADI switch set on the
device), as the JAX package runs it as one XLA program; the host reads
nothing between steps. The eager loop (:meth:`Simulator.forward_eager`) is
its plain version and runs everything else; there it reads the previous
step's iteration count under ``precondition='adaptive'``.

The step is written once, in :class:`GraphPath`, which also runs the
unstructured meshes' transient (``sim/unstructured``): the operator format
sits behind a form object (:class:`StencilForm` here, with the z-sharded
halo; the ELL gather's there), and each simulator supplies its inputs, its
eager solve and its output gather.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from heatflow_tpu_torch.ops.cg import pcg, pcg_fixed
from heatflow_tpu_torch.ops.cuda_step import (refine_residual_reference,
                                              refine_scale_reference,
                                              step_epilogue_reference,
                                              step_prologue_reference,
                                              warm_seed)
from heatflow_tpu_torch.ops.stencil import apply_stencil, combine_operator
from heatflow_tpu_torch.sim.problem import (Problem2D, band_reduce,
                                            band_values)
from heatflow_tpu_torch.utils import resolve_device, span


@dataclass
class TransientResult:
    times: np.ndarray                 # (S,)
    watcher: np.ndarray | None        # (S, W)
    watcher_names: list[str]
    band_rows: np.ndarray | None      # (S, n_bins) z-binned band-avg ∂T/∂r
    band_centers: np.ndarray | None   # (n_bins,)
    axis_rows: np.ndarray | None      # (S, Nz) raw ∂T/∂r at r=0 nodes
    axis_z: np.ndarray | None         # (Nz,)
    fields: np.ndarray | None         # (S, Nz, Nr) if recorded
    final_u: np.ndarray               # (Nz, Nr)
    cg_iters: np.ndarray              # (S,)
    proj_iters: np.ndarray | None     # (S,)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """numpy.interp on the device: linear between knots, clamped outside.
    ``x`` of any shape; ``fp`` (..., len(xp)) interpolates each of its rows,
    giving (..., *x.shape)."""
    i = torch.clamp(torch.searchsorted(xp, x.reshape(-1), right=True), 1,
                    len(xp) - 1).reshape(x.shape)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(
        np.float32 if xp.dtype == torch.float32 else np.float64).eps))
    dx0 = torch.abs(dx) <= eps
    step = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, fp[..., i - 1], fp[..., i - 1] + step * df)
    ends = fp.shape[:-1] + (1,) * x.ndim
    f = torch.where(x < xp[0], fp[..., 0].reshape(ends), f)
    return torch.where(x > xp[-1], fp[..., -1].reshape(ends), f)


def make_step_fn(problem: Problem2D, *, dtype: torch.dtype = torch.float32,
                 fixed_iters: int = 100, device="cuda"):
    """A single backward-Euler step ``step(u, t) -> u_next`` on the problem's
    operator (fixed-iteration CG, so the control flow is static), on
    ``device`` (the card unless the caller passes ``device='cpu'``). For
    external integrators."""
    device = resolve_device(device)
    dev = problem.device_arrays(dtype, device)
    as_t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    dt, ic = as_t(problem.dt), as_t(problem.ic_temp)
    A, M_op = combine_operator(dev["K"], dev["M"], dev["kappas"],
                               dev["rho_cvs"], dt)
    free, dirich = dev["free"], dev["dirichlet"]
    s = torch.rsqrt(torch.where(A[0] > 0, A[0], torch.ones_like(A[0]))) \
        * free + dirich
    coeff = as_t(-4.0 * math.log(2.0) / problem.fwhm ** 2)
    profile = torch.exp(coeff * dev["r_sq"]) * dev["heat_profile_base"]
    amp_offset = dev["heat_T"][0] - ic
    apply_A_s = lambda y: s * apply_stencil(A, s * y)

    def step(u_prev, t):
        with torch.no_grad():
            u_prev, t = as_t(u_prev), as_t(t)
            amp = interp(t, dev["heat_t"], dev["heat_T"]) - amp_offset
            g = ic * dirich + (amp - ic) * profile
            b_lift = (apply_stencil(M_op, u_prev) - apply_stencil(A, g)) * s
            y0 = (u_prev / torch.where(s > 0, s, torch.ones_like(s))) * free
            sol = pcg_fixed(apply_A_s, b_lift, y0, mask=free,
                            iters=fixed_iters)
            return sol.x * s * free + g

    return step


def mgz_operands(problem: Problem2D, dtype: torch.dtype, device) -> dict:
    """The mgz V-cycle's coarse and transfer operands (``ops.mgz.mgz_pack``)
    for the problem's DEFAULT coefficients, as ``dtype`` tensors on
    ``device``: scipy RAP on the host, once."""
    from heatflow_tpu_torch.ops.mgz import mgz_pack
    st = problem.stencils
    A7 = (np.einsum("m,mkij->kij", problem.rho_cvs, st.M)
          + float(problem.dt) * np.einsum("m,mkij->kij", problem.kappas,
                                          st.K))
    free = np.asarray(problem.free_mask, np.float64)
    s = np.where(free > 0, 1.0 / np.sqrt(np.where(A7[0] > 0, A7[0], 1.0)),
                 1.0)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return {k: torch.as_tensor(v, device=device).contiguous()
            for k, v in mgz_pack(A7, s, free, np_dtype).items()}


def _resolve_solver(solver: str, precondition: str, device: torch.device,
                    dtype: torch.dtype, z_sharded: bool = False) -> bool:
    """True when the step solves go through ``cg_tol`` (the 'vmem' path).
    A z-sharded problem takes the eager path ('auto' resolves to it)."""
    if solver not in ("xla", "vmem", "auto"):
        raise ValueError(f"unknown solver {solver!r}")
    if z_sharded and solver == "vmem":
        raise ValueError("z-sharding a single problem runs the XLA (eager) "
                         "solver path (the cg_tol kernel keeps whole "
                         "problems on one device); use solver='xla'")
    use_vmem = not z_sharded and (solver == "vmem" or (
        solver == "auto" and device.type == "cuda"
        and dtype == torch.float32))
    if use_vmem and precondition in ("zline", "mg"):
        # the kernel has no z-line-only form and no geometric multigrid
        if solver == "vmem":
            raise ValueError(f"precondition={precondition!r} is not "
                             "available in the cg_tol kernel (only 'rline' "
                             "has an in-kernel PCR); use solver='xla'")
        use_vmem = False
    if precondition == "adaptive" and not use_vmem:
        raise ValueError("precondition='adaptive' (per-step rline/adi "
                         "switch) requires the cg_tol solver path "
                         "(solver='vmem', or 'auto' on a CUDA device in "
                         "float32)")
    if precondition == "mgz" and not use_vmem:
        raise ValueError("precondition='mgz' (in-kernel z-semicoarsened MG "
                         "over the rline smoother) requires the cg_tol "
                         "solver path (solver='vmem', or 'auto' on a CUDA "
                         "device in float32)")
    return use_vmem


class StencilForm:
    """The operator format of a lattice: 7- or 9-plane stencils
    (..., npts, Nz, Nr) on (..., Nz, Nr) fields. On a z-sharded slab
    (``zax``, a ``parallel.sharding.ZAxis``) a product reads one halo row
    of each neighbour and the CG's ``dot`` adds the ranks' partial sums.
    The kernels read the planes as they are (no ELL column ids)."""

    combine = staticmethod(combine_operator)
    cols = None

    def __init__(self, zax=None):
        self.halo = None if zax is None else zax.halo
        self.dot = None if zax is None else zax.dots

    def apply(self, C, v):
        return apply_stencil(C, v, halo=self.halo)

    @staticmethod
    def diag(C):
        return C[..., 0, :, :]

    @staticmethod
    def npts(C) -> int:
        """The operator's points a row, as the kernels take them."""
        return C.shape[-3]


def _flat(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(*v.shape[:-2], -1)


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """One sum a lane: over the last two dims."""
    return v.sum(dim=(-2, -1))


class GraphPath:
    """The transient's step loop, shared by :class:`Simulator` (the
    structured grid) and ``sim/unstructured.SimulatorUnstructured`` (the
    grid overlay's 9-point lattice, or the ELL gather): the call's
    operands, the eager loop (:meth:`_run_eager`) and, on a lattice, the
    kernel path as one device program (:meth:`_run_graph` over
    ``ops/cuda_step``), whose plain version the eager loop is.

    The operator format is the module's ``form`` (``apply``, ``diag``,
    ``combine``, the CG's ``dot``, and for the kernels ``npts`` and
    ``cols``, the ELL column ids or None: :class:`StencilForm`, or the ELL
    gather's). A subclass supplies the rest: ``_inputs`` (a call's
    arguments as (d, kp, rc, fw, ic, u0, t0, source), fields in the form's
    layout with leading lane dims), ``_eager_solver`` (the solve off the
    kernel path) and ``_gather`` (its outputs). Reads ``problem.dt`` and
    ``problem.num_steps``, ``opts``, ``dtype``, ``cdt``, ``use_vmem``,
    ``mg`` and ``_workspaces`` of the module, and ``d``'s planes under the
    names of ``Problem2D.device_arrays`` (``K``, ``M``, ``G_r``,
    ``M_proj``, ``free``, ``dirichlet``, ``r_sq``, ``heat_profile_base``,
    ``heat_t``, ``heat_T``; ``watch_flat``, the watchers' flat positions;
    the gradient rows' ``band_slots``, ``band_fill``, ``bin_counts`` and
    ``axis_nodes``)."""

    def _register(self, dev: dict[str, torch.Tensor]) -> None:
        for name, t in dev.items():
            self.register_buffer(name, t, persistent=False)
        self._names = tuple(dev)

    @property
    def dev(self) -> dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in self._names}

    def _records_gradient(self) -> bool:
        return self.opts["record_gradient"] and "band_slots" in self._names

    def _operands(self, d, kp, rc, fw, ic, t0, source):
        """The run's operators and affine boundary terms: (A, M_op, s, g0,
        g1, Ag0, Ag1, b_src, ts, amps), each lane with its own coefficients
        and ``fw`` (shape (...)). ``amps[n]`` is the heating amplitude of
        step n, elementwise the per-step interpolation."""
        with span("transient.operands"):
            F, problem = self.form, self.problem
            dt = torch.tensor(problem.dt, dtype=self.cdt, device=ic.device)
            free, dirich = d["free"], d["dirichlet"]
            A, M_op = F.combine(d["K"], d["M"], kp, rc, dt)
            diag_a = F.diag(A)
            # symmetric Jacobi scaling (≡ Jacobi preconditioning in exact
            # arithmetic, numerically far better at low precision)
            s = torch.rsqrt(torch.where(diag_a > 0, diag_a,
                                        torch.ones_like(diag_a))) \
                * free + dirich
            coeff = torch.tensor(-4.0 * math.log(2.0), dtype=self.cdt,
                                 device=ic.device) / (fw * fw)
            profile = torch.exp(coeff[..., None, None] * d["r_sq"]) \
                * d["heat_profile_base"]
            # BC value g(t) = g0 + amp(t)·g1: (amp - ic) Gaussian + ic on the
            # heating line, ic on fixed edges (ref run_no_diamond.py:303-309)
            g0 = ic * (dirich - profile)
            g1 = profile
            Ag0 = F.apply(A, g0)
            Ag1 = F.apply(A, g1)
            # volumetric source: rhs += dt ∫ f φ r dx = dt (M_proj @ f)
            b_src = 0.0 if source is None else \
                dt * F.apply(d["M_proj"], source)
            ts = torch.arange(1, int(problem.num_steps) + 1, dtype=self.cdt,
                              device=ic.device) * dt + t0
            amp_offset = d["heat_T"][0] - ic   # ref run_no_diamond.py:299-301
            amps = interp(ts, d["heat_t"], d["heat_T"]) - amp_offset
            return A, M_op, s, g0, g1, Ag0, Ag1, b_src, ts, amps

    def _solve_operands(self, A, s, free):
        """The kernel path's inner-solve operands: (A, sm, pcr, pcr_z) in
        float32 (the casts of the float64 operator when refining): the
        r-line and the z-line Thomas factors."""
        with span("transient.operands"):
            from heatflow_tpu_torch.ops.cuda_cg import rline_pack, zline_pack
            prec = self.opts["precondition"]
            if self.opts["f64_refine"]:
                A, s, free = A.to(self.dtype), s.to(self.dtype), \
                    free.to(self.dtype)
            pcr = rline_pack(A, s, free) if prec in (
                "rline", "adi", "adaptive", "mgz") else None
            pcr_z = zline_pack(A, s, free) if prec in ("adi", "adaptive") \
                else None
            return A, s * free, pcr, pcr_z

    def _solver(self, kp, rc, A, s, free):
        """``solve(b, y0, rtol, use_adi) -> (x, iters)``: a step's solve of
        the scaled system, or under ``f64_refine`` a pass's correction
        solve (on the float32 casts of the operands). The kernel path's
        ``cg_tol`` (its plain version for CPU tensors; the ADI form unless
        ``use_adi`` is False); else the subclass's eager solve."""
        if not self.use_vmem:
            return self._eager_solver(kp, rc, *(v.to(self.dtype)
                                                for v in (A, s, free)))
        from heatflow_tpu_torch.ops.cuda_cg import cg_tol
        o = self.opts
        As, sm, pcr, pcr_z = self._solve_operands(A, s, free)
        prec = o["precondition"]
        kw = dict(maxiter=o["maxiter"], rtol_wrt=o["rtol_wrt"], pcr=pcr,
                  cheb_degree=0 if prec == "adaptive"
                  else o["vmem_cheb_degree"],
                  mgz=self.mg if prec == "mgz" else None,
                  mgz_sweeps=o["mgz_sweeps"])
        return lambda b, y0, rtol, use_adi: cg_tol(
            As, sm, b, y0, rtol, pcr_z=None if use_adi is False else pcr_z,
            cols=self.form.cols, **kw)

    def _pcg_solver(self, A, s, free, pre=None):
        """The eager PCG (``pcg_fixed`` under ``fixed_iters``) on the scaled
        system, preconditioned by ``pre``."""
        o, F = self.opts, self.form
        op = lambda y: s * F.apply(A, s * y)

        def solve(b, y0, rtol, use_adi):
            if o["fixed_iters"] is not None:
                sol = pcg_fixed(op, b, y0, precond=pre, mask=free,
                                iters=o["fixed_iters"], dot=F.dot)
            else:
                sol = pcg(op, b, y0, precond=pre, mask=free, rtol=rtol,
                          maxiter=o["maxiter"], rtol_wrt=o["rtol_wrt"],
                          dot=F.dot)
            return sol.x, sol.iters
        return solve

    def _projection(self, d):
        """``project(u, seed) -> (gr, iters)``: the gradient projection,
        G_r u solved against the mass matrix M_proj by a symmetrically
        scaled PCG in ``dtype`` (operator entries span ~15 decades; the
        unit diagonal is float32-safe)."""
        o, F, dtype = self.opts, self.form, self.dtype
        diag = F.diag(d["M_proj"])
        s_mp = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag))
                           ).to(dtype)
        Mp, G = d["M_proj"].to(dtype), d["G_r"].to(dtype)
        op = lambda y: s_mp * F.apply(Mp, s_mp * y)

        def project(u, seed):
            br = s_mp * F.apply(G, u.to(dtype))
            sol = pcg(op, br, seed / s_mp, rtol=o["proj_rtol"],
                      maxiter=o["proj_maxiter"], dot=F.dot)
            return sol.x * s_mp, sol.iters
        return project

    def _run_eager(self, d, kp, rc, fw, ic, u0, t0, source,
                   inner_sum=_lane_sum):
        """The transient as a loop of eager steps on any device, the plain
        versions of the step kernels (``ops/cuda_step``) around each solve:
        ``f64_refine`` passes of float64 residual and float32 correction,
        each inner solve from zero or (inner_seed='carry') from the previous
        step's correction of the same pass; then the watcher row, the
        gradient rows and the field. Under 'adaptive' the host reads each
        step's iteration count. ``inner_sum`` takes the refinement's inner
        products, one a lane (``ops.cuda_step.kernel_order_sum``: in the
        step kernels' order)."""
        o, F, dtype = self.opts, self.form, self.dtype
        passes, warm_start = o["f64_refine"], o["warm_start"]
        carry = o["inner_seed"] == "carry"
        adaptive = o["precondition"] == "adaptive"
        A, M_op, s, g0, g1, Ag0, Ag1, b_src, ts, amps = self._operands(
            d, kp, rc, fw, ic, t0, source)
        free = d["free"]
        solve = self._solver(kp, rc, A, s, free)
        project = self._projection(d) if self._records_gradient() else None
        zero = lambda: torch.zeros(u0.shape, dtype=dtype, device=u0.device)
        dys = [zero() for _ in range(passes)]

        def refined(bt, y, use_adi):
            """The step's refinement passes: (y before the last pass's
            correction, iters, that correction, its rnorm)."""
            # inner stop floor: a residual at f64 roundoff relative to the
            # step's rhs has nothing left to correct
            floor2 = 1e-30 * inner_sum(bt * bt)
            iters = torch.zeros((), dtype=torch.int32, device=u0.device)
            dy = rn = None
            for i in range(passes):
                y, r64, rn, rtol_eff = refine_residual_reference(
                    F.apply, A, s, free, bt, y, floor2, o["rtol"], dtype, dy,
                    rn, inner_sum)
                r32, seed = refine_scale_reference(
                    r64, rn, rtol_eff, dtype, dys[i] if carry else None)
                dy, its = solve(r32, seed, rtol_eff, use_adi)
                dys[i] = dy
                iters = iters + its
            return y, iters, dy, rn

        # the first (cold) step is the deepest solve: start on the ADI form
        it_prev = o["maxiter"]
        u_prev = u_pp = u_ppp = u0
        gr_prev = gr_pp = gr_ppp = zero()
        outs: dict[str, list] = {}
        for n in range(int(self.problem.num_steps)):
            with span("transient.step"):
                use_adi = it_prev > o["adaptive_thresh"] if adaptive \
                    else None
                amp = amps[n]
                b_lift, y0 = step_prologue_reference(
                    F.apply, M_op, u_prev, u_pp, u_ppp, b_src, Ag0, Ag1, amp,
                    s, free, warm_start)
                bt = b_lift * free
                dy = rn = None
                with span("k1.solve"):
                    if passes:
                        x, iters, dy, rn = refined(bt, y0, use_adi)
                    else:
                        x, iters = solve(bt, y0, o["rtol"], use_adi)
                u = step_epilogue_reference(x, s, free, g0, g1, amp, dy, rn)
                if iters is not None:
                    outs.setdefault("cg_iters", []).append(iters)
                if "watch_flat" in d:
                    outs.setdefault("watch", []).append(
                        _flat(u)[..., d["watch_flat"]])
                if project is not None:
                    with span("step.project"):
                        # the projection seed rides the same warm-start knob
                        gr, its = project(u, warm_seed(gr_prev, gr_pp, gr_ppp,
                                                       warm_start))
                        flat = _flat(gr)
                        outs.setdefault("band", []).append(band_values(
                            flat, d["band_slots"], d["band_fill"]))
                        outs.setdefault("axis", []).append(
                            flat[..., d["axis_nodes"]])
                        outs.setdefault("proj_iters", []).append(its)
                    gr_ppp, gr_pp, gr_prev = gr_pp, gr_prev, gr
                if o["record_fields"]:
                    outs.setdefault("field", []).append(u)
                u_ppp, u_pp, u_prev = u_pp, u_prev, u
                if adaptive:
                    it_prev = int(iters)   # the one host read of a step
        ys = {k: torch.stack(v, dim=u0.ndim - 2) for k, v in outs.items()}
        ys["final_u"] = u_prev
        ys = self._gather(ys, d)
        if "band" in ys:
            ys["band"] = band_reduce(ys["band"], d["bin_counts"])
        ys["times"] = ts
        return ys

    def _run_graph(self, d, kp, rc, fw, ic, u0, t0, source):
        """The kernel path as one device program (``ops/cuda_step``): the
        call's operands copied into this module's workspace, the captured
        transient launched once, the outputs copied out."""
        from heatflow_tpu_torch.ops import cuda_step
        ws, ts = self._step_workspace(d, kp, rc, fw, ic, u0, t0, source)
        cuda_step.run(ws)
        with span("transient.outputs"):
            ys = {"cg_iters": ws.cg_iters.clone()}
            if ws.watch is not None:
                ys["watch"] = ws.watch.clone()
            if ws.fields is not None:
                ys["field"] = ws.fields.clone()
            ys["final_u"] = ws.ring[(ws.num_steps - 1) % 3].clone()
        ys = self._gather(ys, d)
        ys["times"] = ts
        return ys

    def _step_workspace(self, d, kp, rc, fw, ic, u0, t0, source):
        """(workspace, times): this module's step workspace for the call's
        options, made at its first use, with the call's operands loaded.
        The inner solve's form and operands pass ``cg_tol``'s checks first
        (its operands float32: ``dtype=torch.float32``)."""
        from heatflow_tpu_torch.ops import cuda_cg, cuda_step
        o, problem, F = self.opts, self.problem, self.form
        A, M_op, s, g0, g1, Ag0, Ag1, b_src, ts, amps = self._operands(
            d, kp, rc, fw, ic, t0, source)
        free = d["free"]
        As, sm, pcr, pcr_z = self._solve_operands(A, s, free)
        adaptive = o["precondition"] == "adaptive"
        # the ELL form has the standard recurrence only
        merged = bool(cuda_cg.MERGED_DEFAULT) and F.cols is None
        solve = dict(pcr=pcr is not None, pcr_z=pcr_z is not None,
                     cheb=0 if adaptive or o["f64_refine"]
                     else o["vmem_cheb_degree"],
                     mgz=self.mg if o["precondition"] == "mgz" else None,
                     mgz_sweeps=o["mgz_sweeps"], merged=merged,
                     maxiter=o["maxiter"],
                     rtol_wrt="b" if o["f64_refine"] else o["rtol_wrt"])
        cuda_cg._check_solve(As, sm, pcr=pcr, pcr_z=pcr_z,
                             cheb_degree=solve["cheb"], merged=merged,
                             mgz=solve["mgz"],
                             mgz_sweeps=solve["mgz_sweeps"],
                             rtol_wrt=solve["rtol_wrt"], cols=F.cols)
        key = (merged, source is not None, u0.device.type)
        ws = self._workspaces.get(key)
        if ws is None:
            nz, nr = u0.shape
            ws = self._workspaces[key] = cuda_step.StepWorkspace(
                device=u0.device, nz=nz, nr=nr, npts=F.npts(A),
                cdt=self.cdt, num_steps=int(problem.num_steps),
                f64_refine=o["f64_refine"],
                carry=o["inner_seed"] == "carry",
                warm_start=o["warm_start"], adaptive=adaptive,
                thresh=o["adaptive_thresh"], rtol=o["rtol"],
                n_watch=len(d["watch_flat"]) if "watch_flat" in d else 0,
                record_fields=o["record_fields"],
                has_src=source is not None, solve=solve, cols=F.cols)
        ws.load(Mop=M_op, s=s, free=free, g0=g0, g1=g1, Ag0=Ag0, Ag1=Ag1,
                src=None if source is None else b_src, amps=amps,
                A=A if o["f64_refine"] else None, As=As, sm=sm, pcr=pcr,
                pcr_z=pcr_z, u0=u0, watch_flat=d.get("watch_flat"))
        return ws, ts


class Simulator(GraphPath, nn.Module):
    """``simulate(kappas, rho_cvs, fwhm, u0, t0, source) -> dict`` of
    per-step traces; the buffers are the problem's device tensors (under
    z-sharding, this rank's slabs)."""

    def __init__(self, problem: Problem2D, dev: dict[str, torch.Tensor], *,
                 dtype: torch.dtype, cdt: torch.dtype, use_vmem: bool,
                 opts: dict, mg=None, zax=None):
        super().__init__()
        if problem.radial is not None:
            # the gradient's axis rows: the r = 0 column
            nz, nr = problem.mesh.shape
            dev = dict(dev, axis_nodes=torch.arange(
                nz, device=dev["free"].device) * nr)
        if zax is not None:
            dev = _z_slabs(dev, zax)
        self._register(dev)
        self.problem = problem
        self.dtype = dtype
        self.cdt = cdt
        self.use_vmem = use_vmem
        self.opts = opts
        # 'mg': the hierarchy's device levels; 'mgz': the V-cycle operands
        self.mg = mg
        # z-sharding: this rank's rows (``parallel.sharding.ZAxis``)
        self.zax = zax
        self.form = StencilForm(zax)
        # the kernel path's step workspaces (``ops.cuda_step``), by key
        self._workspaces: dict = {}

    def _inputs(self, kappas, rho_cvs, fwhm, u0, t0, source) -> tuple:
        if self.opts["precondition"] == "mgz" and (kappas is not None
                                                   or rho_cvs is not None):
            raise ValueError(
                "precondition='mgz' bakes the coarse operator from the "
                "problem's default coefficients at maker time; per-call "
                "kappa/rho_cv overrides would silently mismatch it — use "
                "'rline'/'adi'/'adaptive' for coefficient sweeps")
        with span("transient.operands"):
            d = self.dev
            cdt, device = self.cdt, d["free"].device
            as_c = lambda v: torch.as_tensor(v, dtype=cdt, device=device)
            kp = d["kappas"] if kappas is None else as_c(kappas)
            rc = d["rho_cvs"] if rho_cvs is None else as_c(rho_cvs)
            fw = as_c(self.problem.fwhm if fwhm is None else fwhm)
            nz, nr = self.problem.mesh.shape
            ic = as_c(self.problem.ic_temp)
            u0 = torch.full((nz, nr), float(self.problem.ic_temp), dtype=cdt,
                            device=device) if u0 is None else as_c(u0)
            src = None if source is None else as_c(source)
            if self.zax is not None:
                u0 = self.zax.rows(u0)
                src = None if src is None else self.zax.rows(src)
            return d, kp, rc, fw, ic, u0, as_c(t0), src

    def forward(self, kappas=None, rho_cvs=None, fwhm=None, u0=None,
                t0=0.0, source=None) -> dict[str, torch.Tensor]:
        with torch.no_grad(), span("transient"):
            return self._run(*self._inputs(kappas, rho_cvs, fwhm, u0, t0,
                                           source))

    def forward_eager(self, kappas=None, rho_cvs=None, fwhm=None, u0=None,
                      t0=0.0, source=None, inner_sum=torch.sum
                      ) -> dict[str, torch.Tensor]:
        """:meth:`forward` through the eager step loop on any device (the
        plain version of the kernel path's graph). ``inner_sum`` takes the
        refinement's two inner products (``ops.cuda_step.kernel_order_sum``:
        in the step kernels' order)."""
        with torch.no_grad(), span("transient"):
            return self._run_eager(*self._inputs(kappas, rho_cvs, fwhm, u0,
                                                 t0, source), inner_sum)

    def _run(self, d, kp, rc, fw, ic, u0, t0, source):
        """The kernel path on the card runs as one CUDA graph
        (:meth:`_run_graph`); the CPU, the recording path (its projection
        reads the host each iteration), the z-sharded stepper and the eager
        solvers run the eager loop."""
        if (u0.device.type == "cuda" and self.use_vmem and self.zax is None
                and not self._records_gradient()):
            return self._run_graph(d, kp, rc, fw, ic, u0, t0, source)
        return self._run_eager(d, kp, rc, fw, ic, u0, t0, source)

    def _eager_solver(self, kp, rc, A, s, free):
        """The eager PCG preconditioned by a line solve, the ADI
        composition or the multigrid V-cycle; the preconditioners that
        couple z rows run replicated on the full field of a z-sharded
        slab."""
        from heatflow_tpu_torch.ops.linesolve import (adi_preconditioner,
                                                      line_preconditioner)
        prec, zax = self.opts["precondition"], self.zax
        full = (lambda f: f) if zax is None else zax.full
        pre = None
        if prec == "mg":
            from heatflow_tpu_torch.ops.multigrid import make_vcycle
            dt = torch.tensor(self.problem.dt, dtype=self.cdt,
                              device=s.device)
            vcycle = make_vcycle([{**lv, "A": combine_operator(
                lv["K"], lv["M"], kp, rc, dt)[0]} for lv in self.mg])
            s_f = s if zax is None else zax.gather(s)
            inv_s = 1.0 / torch.where(s_f > 0, s_f, torch.ones_like(s_f))
            # the V-cycle approximates A⁻¹; conjugate it into the scaled
            # system: precond(r̃) = S⁻¹ vcycle(S⁻¹ r̃)
            pre = full(lambda r: inv_s * vcycle(inv_s * r))
        elif prec == "rline":
            pre = line_preconditioner(A, s, free, axis=-1)
        elif prec in ("zline", "adi"):
            if zax is not None:
                A, s, free = zax.gather(A), zax.gather(s), zax.gather(free)
            pre = full(adi_preconditioner(A, s, free) if prec == "adi"
                       else line_preconditioner(A, s, free, axis=-2))
        return self._pcg_solver(A, s, free, pre)

    def _gather(self, ys: dict, d: dict) -> dict:
        """Under z-sharding, the full outputs on every rank: watchers read
        on their owners, the band slots summed over the ranks (each slot is
        one rank's value and the others' exact zeros), axis rows, fields
        and the final field gathered along z."""
        zax = self.zax
        if zax is None:
            return ys
        if "watch" in ys:
            ys["watch"] = zax.owned(ys["watch"], d["watch_owner"])
        if "band" in ys:
            ys["band"] = zax.sum(ys["band"])
        if "axis" in ys:
            ys["axis"] = zax.gather(ys["axis"], dim=-1)
        for k in ("field", "final_u"):
            if k in ys:
                ys[k] = zax.gather(ys[k])
        return ys


def _z_slabs(dev: dict, zax) -> dict:
    """This rank's rows of the problem's (..., Nz, Nr) planes, its slab ids
    of the watchers (with their owners), of the band slots (filled where it
    owns the node) and of its axis rows."""
    out = {k: zax.rows(v) if v.dtype.is_floating_point and v.ndim >= 2
           and tuple(v.shape[-2:]) == (zax.nz, zax.nr) else v
           for k, v in dev.items()}
    if "watch_flat" in dev:
        out["watch_flat"], out["watch_owner"] = zax.local_ids(
            dev["watch_flat"])
    if "band_slots" in dev:
        out["band_slots"], owner = zax.local_ids(dev["band_slots"])
        out["band_fill"] = dev["band_fill"] & (owner == zax.mesh.coords["z"])
    if "axis_nodes" in dev:
        out["axis_nodes"] = dev["axis_nodes"][zax.lo:zax.hi] - zax.lo * zax.nr
    return out


def make_simulate_fn(problem: Problem2D,
                     *,
                     dtype: torch.dtype = torch.float64,
                     device="cuda",
                     rtol: float = 1e-11,
                     maxiter: int = 20000,
                     fixed_iters: int | None = None,
                     proj_rtol: float = 1e-11,
                     proj_maxiter: int = 400,
                     record_gradient: bool = True,
                     record_fields: bool = False,
                     precondition: str = "jacobi",
                     rtol_wrt: str = "r0",
                     solver: str = "xla",
                     vmem_cheb_degree: int = 0,
                     mgz_sweeps: int = 1,
                     warm_start: str = "previous",
                     mesh=None,
                     f64_refine: int = 0,
                     inner_seed: str = "zero",
                     adaptive_thresh: int = 100) -> Simulator:
    """Build ``simulate(kappas, rho_cvs, fwhm, u0, t0, source)`` for
    ``problem`` on ``device`` (the card unless the caller passes
    ``device='cpu'``; a missing card raises).

    ``f64_refine``: mixed-precision iterative refinement (``dtype`` must be
    float32). Each step's solve becomes N passes of: the residual against
    the float64 operator, an f32 correction solve to ``rtol`` with the
    configured engine, and the update accumulated in float64; the state is
    carried in float64.

    ``warm_start``: 'previous' seeds each step's CG with u_n, 'extrapolate'
    with 2·u_n − u_{n−1}, 'extrapolate2' with the quadratic
    3·u_n − 3·u_{n−1} + u_{n−2}; the projection seed rides the same knob.

    ``inner_seed`` (refined path only): 'zero' starts each pass's correction
    CG from 0; 'carry' seeds it with the previous step's correction of the
    same pass (zeroed on a degenerate pass).

    ``fixed_iters``: the eager path runs ``pcg_fixed`` with that count
    instead of the tolerance stop.

    ``precondition='mg'`` (eager path): the geometric multigrid V-cycle
    (``ops.multigrid``), its hierarchy built once here. ``'mgz'`` (cg_tol
    path only): the z-semicoarsened two-level V-cycle over the r-line
    smoother inside the kernel, ``mgz_sweeps`` coarse sweeps; its coarse
    operator is built here from the problem's DEFAULT coefficients, so
    ``simulate()`` then refuses ``kappas``/``rho_cvs`` overrides.
    ``vmem_cheb_degree`` (cg_tol path, static preconditioners without
    r-line stack): the kernel's Chebyshev polynomial preconditioner.

    ``precondition='adaptive'`` (cg_tol path only): each step runs the r-line
    form unless the previous step's iteration count exceeded
    ``adaptive_thresh``, in which case it runs the ADI form; the r-line
    factors and the z-line PCR stack are packed once per run.

    ``solver``: 'xla' is the eager torch PCG, 'vmem' the ``cg_tol`` kernel
    path (its plain version for CPU tensors), 'auto' the kernel on a CUDA
    device in float32 and eager otherwise. On a CUDA device the kernel path
    runs the whole transient as one CUDA graph launch (unless the gradient
    is recorded: the projection runs the eager loop); a capture or launch
    that fails raises.

    ``mesh`` (a ``parallel.sharding.DeviceMesh``; every rank of the mesh
    builds and calls the function with the same arguments): shard THIS
    problem's stencils, masks and fields along z over the 'z' axis, on the
    mesh's device, for problems too big for one device. The eager path
    only ('auto' resolves to it, 'vmem', 'adaptive' and 'mgz' raise); Nz
    must divide by the axis size. Each rank holds Nz/zs rows; the stencil
    applies exchange one halo row with each neighbour, the CG dots add the
    ranks' partial sums in rank order, and every rank returns the full
    outputs. 'jacobi' and 'rline' run on the slab; 'zline', 'adi' and 'mg'
    run replicated on the full field (``ZAxis.full``).

    Memoized per problem (``problem.extras``) keyed by every argument.
    """
    if f64_refine:
        # the refined inner solves stop wrt their own unit-norm rhs
        rtol_wrt = "b"
    if inner_seed not in ("zero", "carry"):
        raise ValueError(f"unknown inner_seed {inner_seed!r}")
    if not f64_refine:
        inner_seed = "zero"   # only meaningful for the refined inner solves
    if warm_start not in ("previous", "extrapolate", "extrapolate2"):
        raise ValueError(f"unknown warm_start {warm_start!r}")
    if precondition not in ("jacobi", "mg", "rline", "zline", "adi",
                            "adaptive", "mgz"):
        raise ValueError(f"unknown precondition {precondition!r}")
    if rtol_wrt not in ("r0", "b"):
        raise ValueError(f"unknown rtol_wrt {rtol_wrt!r}")
    from heatflow_tpu_torch.sim.sweepkernel import _mesh_device
    device = _mesh_device(mesh, device)
    if f64_refine:
        if dtype != torch.float32:
            raise ValueError("f64_refine is the mixed-precision mode: dtype "
                             "must be float32 (the all-f64 path needs no "
                             "refinement)")
        if fixed_iters is not None or vmem_cheb_degree \
                or precondition == "mg" or mesh is not None:
            raise ValueError("f64_refine composes with the tolerance-based "
                             "jacobi/line (rline/zline/adi) solvers on one "
                             "chip (no fixed_iters / cheb / mg / mesh)")
    use_vmem = _resolve_solver(solver, precondition, device, dtype,
                               z_sharded=mesh is not None)
    zax = None
    if mesh is not None:
        from heatflow_tpu_torch.parallel.sharding import ZAxis
        zax = ZAxis(mesh, *problem.mesh.shape)
    if precondition == "adaptive" and vmem_cheb_degree:
        # the per-step rline/adi branches run the plain kernel forms
        raise ValueError("vmem_cheb_degree is not available with "
                         "precondition='adaptive' (the per-step rline/adi "
                         "branches run the plain kernels); use a static "
                         "precondition with cheb, or drop the degree")
    if precondition == "mgz" and vmem_cheb_degree:
        raise ValueError("vmem_cheb_degree does not compose with "
                         "precondition='mgz'")

    opts = dict(fixed_iters=fixed_iters, inner_seed=inner_seed,
                vmem_cheb_degree=int(vmem_cheb_degree),
                mgz_sweeps=int(mgz_sweeps) if precondition == "mgz" else 1,
                rtol=rtol, maxiter=maxiter, proj_rtol=proj_rtol,
                proj_maxiter=proj_maxiter, record_gradient=record_gradient,
                record_fields=record_fields, precondition=precondition,
                rtol_wrt=rtol_wrt, warm_start=warm_start,
                f64_refine=int(f64_refine),
                adaptive_thresh=adaptive_thresh)
    if precondition != "adaptive":
        opts["adaptive_thresh"] = None
    cache_key = ("simulate_fn", str(dtype), str(device), use_vmem, mesh,
                 tuple(sorted(opts.items(), key=lambda kv: kv[0])))
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    cdt = torch.float64 if f64_refine else dtype
    mg = None
    if precondition == "mg":
        from heatflow_tpu_torch.ops.multigrid import (build_hierarchy,
                                                      device_levels)
        mg = device_levels(build_hierarchy(problem.mesh,
                                           problem.dirichlet_mask,
                                           stencils=problem.stencils),
                           dtype, device)
    elif precondition == "mgz":
        mg = mgz_operands(problem, dtype, device)
    fn = Simulator(problem, problem.device_arrays(cdt, device), dtype=dtype,
                   cdt=cdt, use_vmem=use_vmem, opts=opts, mg=mg, zax=zax)
    cache[cache_key] = fn
    return fn


def run_transient(problem: Problem2D, *, dtype: torch.dtype = torch.float64,
                  device="cuda",
                  rtol: float = 1e-11, maxiter: int = 20000,
                  fixed_iters: int | None = None,
                  record_gradient: bool = True,
                  record_fields: bool = False,
                  precondition: str = "jacobi", solver: str = "xla",
                  warm_start: str = "previous", mesh=None, f64_refine: int = 0,
                  inner_seed: str = "zero",
                  kappas=None, rho_cvs=None, fwhm=None,
                  u0=None, t0: float = 0.0, source=None) -> TransientResult:
    """Build, run, and bring the results back to the host as numpy; on the
    card unless ``device='cpu'``."""
    fn = make_simulate_fn(
        problem, dtype=dtype, device=device, rtol=rtol, maxiter=maxiter,
        fixed_iters=fixed_iters, record_gradient=record_gradient,
        record_fields=record_fields, precondition=precondition,
        solver=solver, warm_start=warm_start, mesh=mesh,
        f64_refine=f64_refine, inner_seed=inner_seed)
    ys = {k: v.cpu().numpy() for k, v in
          fn(kappas, rho_cvs, fwhm, u0, t0, source).items()}
    rad = problem.radial if record_gradient else None
    return TransientResult(
        times=ys["times"],
        watcher=ys.get("watch"),
        watcher_names=list(problem.watcher_names),
        band_rows=ys.get("band"),
        band_centers=None if rad is None else rad.bin_centers,
        axis_rows=ys.get("axis"),
        axis_z=None if rad is None else rad.axis_z,
        fields=ys.get("field"),
        final_u=ys["final_u"],
        cg_iters=ys["cg_iters"],
        proj_iters=ys.get("proj_iters"),
    )

"""Transient, sweeps and steady solve on unstructured meshes.

Runs the backward-Euler / Gaussian-laser / watcher / radial-gradient
pipeline of the structured stepper on an arbitrary P1 triangle mesh — a
gmsh ``.msh`` of the reference toolchain or a generated non-grid
triangulation (SURVEY.md §7 'Unstructured-mesh parity'). Two operator
forms:

  * a mesh with a grid overlay (``ops/overlay.py``) runs on its lattice:
    the operators are permuted 9-point stencils, so its solves go through
    the CUDA kernels (``cuda_cg.cg_tol`` for a transient, the batched
    ``cuda_sweep`` kernels for a sweep) or the eager stencil PCG; vectors
    are in node order at the API boundary and in lattice order inside;
  * any other mesh (an imported gmsh ``.msh``) runs through the ELL gather
    (``ops/ell.py``): its fields are (..., 1, N), so the PCG's per-lane sums
    run over the last two dims, as for a lattice. Its kernel path
    (``solver='vmem'``, Jacobi only: there are no lines) takes the nodes in
    reverse Cuthill–McKee order (``ell.locality_order``) and solves through
    ``cg_tol``'s ELL form; else the eager PCG, in node order.

The transient is the structured stepper's own step loop
(``sim/stepper.GraphPath``) on the form of the mesh's layout
(``stepper.StencilForm`` or :class:`EllForm`).

Node and cell semantics follow the reference everywhere:

  * watcher points → nearest mesh node (ref run_no_diamond.py:397-401);
  * raw gradient CSV → nodes with |r| <= 1e-12 sorted by z (ref :457-465);
  * band CSV → 0.2 µm z-bins of band nodes 0 < r <= 0.25 µm (ref :494-513).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
from torch import nn

from heatflow_tpu_torch.mesh.msh_io import UnstructuredMesh
from heatflow_tpu_torch.ops.cg import pcg, pcg_solve
from heatflow_tpu_torch.ops.ell import (EllOps, assemble_ell, ell_apply,
                                        ell_apply_rows, ell_combine, ell_diag,
                                        locality_order)
from heatflow_tpu_torch.ops.stencil import combine_operator, material_combine
from heatflow_tpu_torch.sim.bc import HeatingCurve, node_row_mask
from heatflow_tpu_torch.sim.problem import (BAND_RMAX, BIN_DZ, RadialSampling,
                                            band_slots)
from heatflow_tpu_torch.sim.stepper import GraphPath, StencilForm, _flat
from heatflow_tpu_torch.utils import resolve_device, span

AXIS_TOL = 1e-12        # r = 0 node rule of the raw gradient CSV


@dataclass
class ProblemUnstructured:
    mesh: UnstructuredMesh
    ell: EllOps
    heating: HeatingCurve
    dt: float
    num_steps: int
    ic_temp: float
    fwhm: float
    kappas: np.ndarray
    rho_cvs: np.ndarray
    dirichlet: np.ndarray            # (N,) bool
    heat_mask: np.ndarray            # (N,) bool
    watcher_names: list[str] = field(default_factory=list)
    watcher_nodes: np.ndarray | None = None
    band_nodes: np.ndarray | None = None
    band_bins: np.ndarray | None = None
    bin_counts: np.ndarray | None = None
    bin_centers: np.ndarray | None = None
    axis_nodes: np.ndarray | None = None
    axis_z: np.ndarray | None = None
    extras: dict[str, Any] = field(default_factory=dict)


def _material_order(mesh: UnstructuredMesh) -> list[str]:
    return [nm for nm, _ in sorted(mesh.material_tags.items(),
                                   key=lambda kv: kv[1])]


def build_problem_unstructured(mesh: UnstructuredMesh, heating: HeatingCurve,
                               cfg: dict, *, watcher_points=None,
                               heat_coord: float | None = None,
                               heat_length: float | None = None
                               ) -> ProblemUnstructured:
    """Assemble the ELL problem. heat_coord/heat_length default to the
    config-derived p-side coupler line (requires reference-schema mats)."""
    from heatflow_tpu_torch.config import mat_float
    nodes = mesh.nodes
    n_mats = len(mesh.material_tags) or int(mesh.cell_tags.max())
    names = _material_order(mesh)
    if not names:
        raise ValueError("mesh lacks material name → tag mapping")
    kappas = np.array([mat_float(cfg, nm, "k") for nm in names])
    rho_cvs = np.array([mat_float(cfg, nm, "rho") * mat_float(cfg, nm, "cv")
                        for nm in names])

    if heat_coord is None or heat_length is None:
        from heatflow_tpu_torch.geometry import heating_line
        cfg_coord, cfg_length = heating_line(cfg)
        heat_coord = cfg_coord if heat_coord is None else heat_coord
        heat_length = cfg_length if heat_length is None else heat_length

    edge = (node_row_mask(nodes, "left") | node_row_mask(nodes, "right")
            | node_row_mask(nodes, "top"))
    heat = node_row_mask(nodes, "x", coord=heat_coord, center=0.0,
                         length=heat_length)
    dirichlet = edge | heat

    wnames, widx = [], None
    if watcher_points:
        wnames = list(watcher_points.keys())
        pts = np.asarray(list(watcher_points.values()), float)
        d2 = ((nodes[None, :, :] - pts[:, None, :]) ** 2).sum(-1)
        widx = d2.argmin(axis=1)

    # radial sampling (reference node rules)
    r = nodes[:, 1]
    z = nodes[:, 0]
    axis_nodes = np.where(np.abs(r) <= AXIS_TOL)[0]
    axis_nodes = axis_nodes[np.argsort(z[axis_nodes])]
    band_sel = np.where((r > 0.0) & (r <= BAND_RMAX))[0]
    edges = np.arange(z.min(), z.max() + BIN_DZ, BIN_DZ)
    raw_bin = np.searchsorted(edges, z[band_sel]) - 1
    valid = (raw_bin >= 0) & (raw_bin < len(edges) - 1)
    band_sel, raw_bin = band_sel[valid], raw_bin[valid]
    used = np.unique(raw_bin)
    remap = -np.ones(len(edges) - 1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    bins = remap[raw_bin]
    counts = np.bincount(bins, minlength=len(used)).astype(float)
    centers = 0.5 * (edges[used] + edges[used + 1])

    t_final = float(cfg["timing"]["t_final"])
    num_steps = int(cfg["timing"]["num_steps"])
    return ProblemUnstructured(
        mesh=mesh,
        ell=assemble_ell(mesh.nodes, mesh.cells, mesh.cell_tags, n_mats),
        heating=heating, dt=t_final / num_steps, num_steps=num_steps,
        ic_temp=float(cfg["heating"]["ic_temp"]),
        fwhm=float(cfg["heating"]["fwhm"]), kappas=kappas, rho_cvs=rho_cvs,
        dirichlet=dirichlet, heat_mask=heat, watcher_names=wnames,
        watcher_nodes=widx, band_nodes=band_sel, band_bins=bins,
        bin_counts=counts, bin_centers=centers, axis_nodes=axis_nodes,
        axis_z=z[axis_nodes])


def _overlay_prep(problem: ProblemUnstructured):
    """(idx, inv, shape, stencils) of the mesh's lattice embedding, or None
    when the mesh has no grid overlay. idx maps node id → flat lattice
    position, inv the reverse. The stencil conversion is cached on the
    problem (shared by the simulate and sweep paths)."""
    from heatflow_tpu_torch.ops.overlay import (ell_to_stencils,
                                                validate_overlay)
    overlay = getattr(problem.mesh, "grid_overlay", None)
    if overlay is None:
        return None
    idx_np, oshape = validate_overlay(len(problem.mesh.nodes), overlay)
    stn = problem.extras.get("_overlay_stencils")
    if stn is None:
        stn = problem.extras["_overlay_stencils"] = ell_to_stencils(
            problem.ell, overlay)
    return idx_np, np.argsort(idx_np), oshape, stn


def auto_selects_vmem(mesh, dtype: torch.dtype, device="cuda") -> bool:
    """Would ``solver='auto'`` pick the kernel path for a transient on this
    mesh? The rule of ``stepper._resolve_solver``: a CUDA device and
    float32, on the overlay's lattice or, for a mesh without overlay, on
    the ELL gather (where only 'jacobi' runs: there are no lines). The CUDA
    kernels hold no operand in on-chip memory across a solve, so unlike the
    JAX package's TPU kernels they have no size limit to check, whatever
    the preconditioner. Every mesh has a kernel path: ``mesh`` is taken as
    the JAX package's function takes it, and the drivers pass it."""
    return torch.device(device).type == "cuda" and dtype == torch.float32


def sweep_auto_selects_vmem(mesh, dtype: torch.dtype, device="cuda") -> bool:
    """Would ``solver='auto'`` pick the overlay kernel path (the batched
    K2/K3 kernels) for a SWEEP on this mesh? A CUDA device, float32 and a
    grid overlay: the batched kernels are stencil-form only (no size limit
    either)."""
    return (getattr(mesh, "grid_overlay", None) is not None
            and auto_selects_vmem(mesh, dtype, device))


def _ell_order(problem: ProblemUnstructured):
    """(order, position, ell) of the kernel path on a mesh without overlay:
    the reverse Cuthill–McKee order (core row k is node ``order[k]``), its
    inverse (node → core row) and the ELL operators in that order, built
    once a problem (cached on it)."""
    cached = problem.extras.get("_ell_order")
    if cached is None:
        order = locality_order(problem.ell.cols)
        cached = problem.extras["_ell_order"] = (
            order, np.argsort(order), problem.ell.permuted(order))
    return cached


class EllForm:
    """The operator format of a mesh on the ELL gather: (..., 1, N) node
    fields, so that the PCG's per-lane sums run over the last two dims as
    on a lattice. ``index`` gathers on the eager path (int64); ``cols``,
    the same ids in int32, is what the kernels read (None off the kernel
    path)."""

    combine = staticmethod(ell_combine)
    dot = None

    def __init__(self, index: torch.Tensor, kernels: bool):
        self.index = index
        self.cols = index.to(torch.int32).contiguous() if kernels else None

    def apply(self, C, v):
        return ell_apply_rows(self.index, C, v)

    def diag(self, C):
        return ell_diag(self.index, C)[..., None, :]

    @staticmethod
    def npts(C) -> int:
        return C.shape[-1]


class SimulatorUnstructured(GraphPath, nn.Module):
    """``simulate(kappas, rho_cvs, fwhm, u0, t0, source) -> dict`` of
    per-step traces on an unstructured problem; the buffers are the
    problem's device tensors in the core layout (the overlay's lattice, or
    (1, N) nodes, on the kernel path in reverse Cuthill–McKee order).
    ``kappas`` (..., n_mats) and ``fwhm`` (...) with leading batch dims run
    that many lanes together (``u0`` then (..., N)); traces come back as
    (..., S, ·), fields in node order.

    The structured stepper's code runs it (:class:`stepper.GraphPath`, on
    the form of its core layout): on a CUDA device the kernel path runs a
    one-lane transient without gradient recording as one CUDA graph launch
    (``ops/cuda_step``, with the overlay's 9 planes or the ELL gather, the
    watchers at their core positions); everything else runs the eager step
    loop."""

    def __init__(self, problem: ProblemUnstructured,
                 dev: dict[str, torch.Tensor], *, dtype: torch.dtype,
                 cdt: torch.dtype, use_vmem: bool, overlay: bool,
                 shape: tuple, opts: dict):
        super().__init__()
        self._register(dev)
        self.problem = problem
        self.dtype, self.cdt = dtype, cdt
        self.use_vmem = use_vmem
        self.overlay = overlay
        # core order is not node order: gathers at the edges of a call
        self.reordered = "to_core" in dev
        self.shape = shape
        self.opts = opts
        self.form = StencilForm() if overlay else EllForm(self.cols,
                                                           use_vmem)
        # the graph path's state (``stepper.GraphPath``): no mgz operands,
        # the step workspaces by key
        self.mg = None
        self._workspaces: dict = {}

    def _inputs(self, kappas, rho_cvs, fwhm, u0, t0, source) -> tuple:
        """A call's arguments on the device: the coefficients (parameter
        overrides default to the problem's values), u0 and the source in
        core order and layout."""
        cdt, device = self.cdt, self.free.device
        as_c = lambda v, default=None: torch.as_tensor(
            default if v is None else v, dtype=cdt, device=device)
        p = self.problem
        kp, rc = as_c(kappas, p.kappas), as_c(rho_cvs, p.rho_cvs)
        fw = as_c(fwhm, p.fwhm)
        u0 = (torch.full(fw.shape + (len(p.mesh.nodes),), float(p.ic_temp),
                         dtype=cdt, device=device)
              if u0 is None else as_c(u0))
        src = None if source is None else as_c(source)
        if self.reordered:
            with span("transient.reorder"):
                u0 = u0[..., self.to_core]
                src = None if src is None else src[..., self.to_core]
        core = lambda v: v.reshape(*v.shape[:-1], *self.shape)
        return (self.dev, kp, rc, fw, as_c(p.ic_temp), core(u0), as_c(t0),
                None if src is None else core(src))

    def forward(self, kappas=None, rho_cvs=None, fwhm=None, u0=None,
                t0=0.0, source=None) -> dict[str, torch.Tensor]:
        with span("transient"):
            args = self._inputs(kappas, rho_cvs, fwhm, u0, t0, source)
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and self.opts["differentiable"]):
                ys = self._run(*args)
            if self.reordered:
                with span("transient.reorder"):
                    ys["final_u"] = ys["final_u"][..., self.to_node]
                    if "field" in ys:
                        ys["field"] = ys["field"][..., self.to_node]
            return ys

    def _run(self, d, kp, rc, fw, ic, u0, t0, source):
        """One CUDA graph (:meth:`_run_lattice`, on the overlay's lattice or
        the ELL gather) for a one-lane call of the kernel path on a CUDA
        device without gradient recording; the eager step loop
        otherwise."""
        o = self.opts
        if (self.use_vmem and u0.device.type == "cuda" and u0.ndim == 2
                and kp.ndim == 1 and rc.ndim == 1 and fw.ndim == 0
                and not o["record_gradient"] and not o["differentiable"]):
            return self._run_lattice(d, kp, rc, fw, ic, u0, t0, source)
        if o["precondition"] == "adaptive":
            raise ValueError(
                "precondition='adaptive' on an unstructured problem runs "
                "only as the overlay's one CUDA graph (one lane a call on "
                "a CUDA device): the eager step loop has no per-step "
                "r-line/ADI switch; use 'rline' or 'adi' here")
        return self._run_eager(d, kp, rc, fw, ic, u0, t0, source)

    # the kernel path's transient as one device program
    _run_lattice = GraphPath._run_graph

    def _eager_solver(self, kp, rc, A, s, free):
        """The eager PCG; under ``differentiable``, ``pcg_solve`` (implicit
        differentiation: one adjoint solve a step under backward), which
        counts no iterations."""
        o = self.opts
        if not o["differentiable"]:
            return self._pcg_solver(A, s, free)
        op = lambda y, s_, A_: s_ * self.form.apply(A_, s_ * y)
        return lambda b, y0, rtol, use_adi: (pcg_solve(
            op, b, y0, op_args=(s, A), mask=free, rtol=rtol,
            maxiter=o["maxiter"], rtol_wrt=o["rtol_wrt"]), None)

    def _gather(self, ys: dict, d: dict) -> dict:
        """The fields flat, in core order."""
        for k in ("field", "final_u"):
            if k in ys:
                ys[k] = _flat(ys[k])
        return ys


def make_simulate_fn_unstructured(problem: ProblemUnstructured, *,
                                  dtype: torch.dtype = torch.float64,
                                  device="cuda", rtol=1e-11,
                                  maxiter=20000, fixed_iters=None,
                                  proj_rtol=None, proj_maxiter=400,
                                  record_gradient=True,
                                  record_fields=False, rtol_wrt="b",
                                  differentiable=False, solver="xla",
                                  warm_start="previous",
                                  precondition="jacobi", f64_refine=0,
                                  adaptive_thresh=100
                                  ) -> SimulatorUnstructured:
    """Build ``simulate(kappas, rho_cvs, fwhm, u0, t0, source)`` on an
    unstructured problem, on ``device`` (the card unless the caller passes
    ``device='cpu'``; a missing card raises): the surface of
    ``stepper.make_simulate_fn`` (parameter overrides default to the
    problem's values; leading batch dims of the coefficients run lanes).

    ``solver='vmem'``: each step's solve through the ``cg_tol`` kernel (its
    plain version for CPU tensors; float32 on a card): on a grid overlay's
    9-plane lattice operator, 'jacobi' the scaled identity, 'rline' and
    'adi' the line factors packed once per transient; on a mesh without
    overlay, the ELL form with 'jacobi' (there are no lines), the nodes in
    reverse Cuthill–McKee order. 'auto': that path in float32 on a CUDA
    device (:func:`auto_selects_vmem`), else 'xla': the eager PCG on the
    overlay's stencils, or on the ELL gather in node order. On a CUDA
    device the kernel path runs a one-lane transient without gradient
    recording as one CUDA graph launch (the structured stepper's
    ``ops/cuda_step`` graph), the host reading nothing between steps.

    ``precondition='adaptive'`` (that graph path only, ``record_gradient``
    off): each step runs the r-line form unless the previous step's
    iteration count exceeded ``adaptive_thresh``, then the ADI form, the
    switch set on the device as in ``stepper.make_simulate_fn``. The eager
    loop and the ELL gather refuse it.

    ``differentiable=True`` solves each step with ``pcg_solve`` (implicit
    differentiation: one adjoint solve a step under backward) and drops the
    cg_iters trace. ``warm_start='extrapolate'`` seeds each step with
    2·u_n − u_{n−1}. ``f64_refine=N``: N passes of float64 residual around a
    float32 correction solve (``dtype`` float32), the state in float64.

    Memoized on ``problem.extras`` keyed by every argument.
    """
    if f64_refine:
        # refined inner solves stop wrt their own per-pass residual
        rtol_wrt = "b"
    device = resolve_device(device)
    cache_key = ("sim_fn", str(dtype), str(device), rtol, maxiter,
                 fixed_iters, proj_rtol, proj_maxiter, record_gradient,
                 record_fields, rtol_wrt, differentiable, solver, warm_start,
                 precondition, f64_refine,
                 adaptive_thresh if precondition == "adaptive" else None)
    if precondition not in ("jacobi", "rline", "adi", "adaptive"):
        raise ValueError(f"unknown precondition {precondition!r}")
    if precondition in ("rline", "adi", "adaptive") \
            and solver not in ("vmem", "auto"):
        raise ValueError(f"{precondition} preconditioning on unstructured "
                         "problems runs the grid-overlay kernel path "
                         "(solver='vmem')")
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if warm_start not in ("previous", "extrapolate"):
        raise ValueError(f"unknown warm_start {warm_start!r} (use "
                         "'previous' or 'extrapolate')")
    if rtol_wrt not in ("r0", "b"):
        raise ValueError(f"unknown rtol_wrt {rtol_wrt!r}")
    if solver not in ("xla", "vmem", "auto"):
        raise ValueError(f"unknown solver {solver!r}")
    if f64_refine:
        if dtype != torch.float32:
            raise ValueError("f64_refine is the mixed-precision mode: "
                             "dtype must be float32")
        if differentiable or fixed_iters is not None:
            raise ValueError("f64_refine composes with the tolerance-based "
                             "non-differentiable solvers")
    overlay = getattr(problem.mesh, "grid_overlay", None)
    use_vmem = False
    if solver == "vmem":
        if device.type == "cuda" and dtype != torch.float32:
            raise ValueError("the cg_tol kernel is float32-only on a card")
        use_vmem = True
    elif solver == "auto":
        use_vmem = auto_selects_vmem(problem.mesh, dtype, device)
    if precondition in ("rline", "adi", "adaptive") and use_vmem \
            and overlay is None:
        raise ValueError(
            f"{precondition} preconditioning solves along the lines of a "
            "grid-overlay lattice; a mesh without overlay runs the kernel "
            "path on the ELL gather with precondition='jacobi'")
    if precondition in ("rline", "adi", "adaptive") and not use_vmem:
        # the only unstructured line-preconditioned engine is the overlay
        # kernel path; running the eager path here would silently drop the
        # preconditioner
        raise ValueError(
            f"{precondition} preconditioning on unstructured problems runs "
            "the grid-overlay kernel path, which was not selected here (no "
            "overlay, or not float32 on a CUDA device under solver='auto'); "
            "use precondition='jacobi' or solver='vmem'")
    if use_vmem and (differentiable or fixed_iters is not None):
        # the JAX package runs pcg_solve past a selected kernel path, and
        # ignores fixed_iters there: here neither hides the kernel
        raise ValueError("the grid-overlay kernel path is tolerance-based "
                         "and not differentiable (drop fixed_iters / "
                         "differentiable, or use solver='xla')")
    if precondition == "adaptive" and record_gradient:
        raise ValueError("precondition='adaptive' on unstructured problems "
                         "runs only as the overlay's one CUDA graph, which "
                         "records no gradient rows (record_gradient=False)")

    cdt = torch.float64 if f64_refine else dtype
    nodes = problem.mesh.nodes
    f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=cdt,
                               device=device)
    ix = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)
    if overlay is not None:
        idx_np, inv_np, oshape, stn = _overlay_prep(problem)
        remap = lambda v: np.asarray(v)[inv_np].reshape(oshape)
        node_ids = lambda ids: idx_np[np.asarray(ids)]
        ops = {k: f(stn[k]) for k in ("K", "M", "G", "Mp")}
        dev = dict(to_node=ix(idx_np), to_core=ix(inv_np))
        shape = oshape
    elif use_vmem:
        # the kernel path's rows in their locality order
        inv_np, idx_np, ell = _ell_order(problem)
        n = len(nodes)
        remap = lambda v: np.asarray(v)[inv_np].reshape(1, n)
        node_ids = lambda ids: idx_np[np.asarray(ids)]
        ops = ell.to(device, cdt)
        dev = dict(cols=ops["cols"], to_node=ix(idx_np), to_core=ix(inv_np))
        shape = (1, n)
    else:
        n = len(nodes)
        remap = lambda v: np.asarray(v).reshape(1, n)
        node_ids = lambda ids: np.asarray(ids)
        ops = problem.ell.to(device, cdt)
        dev = dict(cols=ops["cols"])
        shape = (1, n)
    # the names of Problem2D.device_arrays, which the step loop reads
    dev.update(K=ops["K"], M=ops["M"], G_r=ops["G"], M_proj=ops["Mp"],
               free=f(remap(~problem.dirichlet)),
               dirichlet=f(remap(problem.dirichlet)),
               heat_t=f(problem.heating.time), heat_T=f(problem.heating.temp),
               r_sq=f(remap(nodes[:, 1] ** 2)),
               heat_profile_base=f(remap(problem.heat_mask)))
    if problem.watcher_nodes is not None:
        dev["watch_flat"] = ix(node_ids(problem.watcher_nodes))
    if record_gradient:
        slots, fill = band_slots(RadialSampling(
            band_nodes=node_ids(problem.band_nodes),
            band_bin_ids=problem.band_bins, bin_counts=problem.bin_counts,
            bin_centers=problem.bin_centers, axis_z=problem.axis_z))
        dev.update(band_slots=ix(slots),
                   band_fill=torch.as_tensor(fill, device=device),
                   bin_counts=torch.tensor(problem.bin_counts, dtype=dtype,
                                           device=device),
                   axis_nodes=ix(node_ids(problem.axis_nodes)))
    opts = dict(rtol=rtol, maxiter=maxiter, fixed_iters=fixed_iters,
                proj_rtol=rtol if proj_rtol is None else proj_rtol,
                proj_maxiter=proj_maxiter, record_gradient=record_gradient,
                record_fields=record_fields, rtol_wrt=rtol_wrt,
                differentiable=differentiable, warm_start=warm_start,
                precondition=precondition, f64_refine=int(f64_refine),
                # the step loop's options beside those (stepper.GraphPath)
                inner_seed="zero", vmem_cheb_degree=0, mgz_sweeps=1,
                adaptive_thresh=adaptive_thresh
                if precondition == "adaptive" else None)
    fn = SimulatorUnstructured(problem, dev, dtype=dtype, cdt=cdt,
                               use_vmem=use_vmem,
                               overlay=overlay is not None, shape=shape,
                               opts=opts)
    cache[cache_key] = fn
    return fn


def _sweep_vmem_unstructured(problem: ProblemUnstructured, m_idx: int, *,
                             dtype, rtol, maxiter, fixed_iters, warm_start,
                             device, num_steps=None, rtol_wrt="b",
                             precondition="jacobi", f64_refine=0,
                             record_gradient=False, proj_rtol=1e-11,
                             proj_maxiter=400):
    """The kernel sweep path for grid-overlay meshes: the lattice ops for
    the shared ``sweepkernel.vmem_sweep_scan`` (K2 in its identity, r-line
    and ADI forms, K3 for ``fixed_iters``, K2's Kv-free form for the
    recording projection). ``num_steps`` overrides the problem's step
    count (time-chunked runs through ``.segment``)."""
    from heatflow_tpu_torch.ops.overlay import node_to_lattice
    from heatflow_tpu_torch.sim.sweepkernel import vmem_sweep_scan

    prep = _overlay_prep(problem)
    if prep is None:
        raise ValueError("solver='vmem' needs a grid-overlay mesh (the "
                         "batched kernels are stencil-form only)")
    idx_np, _inv_np, oshape, stn = prep
    nz, nr = oshape
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError("the batched kernels are float32-only on a card")
    if precondition not in ("jacobi", "rline", "adi"):
        raise ValueError("solver='vmem' supports precondition='jacobi', "
                         "'rline' or 'adi'")
    if precondition in ("rline", "adi") and fixed_iters is not None:
        raise ValueError(f"{precondition}-preconditioned vmem sweeps are "
                         "tolerance-based (drop fixed_iters)")

    # f64_refine carries fields and residuals in float64 (ops assembled in
    # float64, the kernel operands cast inside the shared scan)
    wdt = torch.float64 if f64_refine else dtype
    f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=wdt,
                               device=device)
    ix = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)
    dt = torch.tensor(problem.dt, dtype=wdt, device=device)
    ic = torch.tensor(problem.ic_temp, dtype=wdt, device=device)
    K, M = f(stn["K"]), f(stn["M"])            # (n_mats, 9, Nz, Nr)
    A0, M_op = combine_operator(K, M, f(problem.kappas),
                                f(problem.rho_cvs), dt)
    remap = lambda v: node_to_lattice(np.asarray(v), idx_np, oshape)
    nodes = problem.mesh.nodes
    ops = {"A0": A0.contiguous(), "K_var": K[m_idx].contiguous(),
           "M_op": M_op, "free": f(remap(~problem.dirichlet)),
           "dirich": f(remap(problem.dirichlet)),
           "r_sq": f(remap(nodes[:, 1] ** 2)),
           "base": f(remap(problem.heat_mask)),
           "heat_t": f(problem.heating.time),
           "heat_T": f(problem.heating.temp),
           "watch": ix(idx_np[np.asarray(problem.watcher_nodes)])}
    base_k = float(problem.kappas[m_idx])
    num_steps = int(problem.num_steps if num_steps is None else num_steps)
    extrapolate = warm_start == "extrapolate"

    rec = None
    if record_gradient:
        if problem.band_nodes is None:
            raise ValueError("gradient-recording sweeps need radial "
                             "sampling on the problem")
        # the projection on the same lattice: the overlay embedding is a
        # node permutation, so the lattice Mp/G products equal the ELL ones
        Mp = f(stn["Mp"])
        slots, fill = band_slots(RadialSampling(
            band_nodes=idx_np[np.asarray(problem.band_nodes)],
            band_bin_ids=problem.band_bins, bin_counts=problem.bin_counts,
            bin_centers=problem.bin_centers, axis_z=problem.axis_z))
        rec = {"Mp": Mp, "Gr": f(stn["G"]),
               "s_mp": torch.rsqrt(torch.where(Mp[0] > 0, Mp[0],
                                               torch.ones_like(Mp[0]))),
               "band_slots": ix(slots),
               "band_fill": torch.as_tensor(fill, device=device),
               "bin_counts": torch.tensor(problem.bin_counts, dtype=dtype,
                                          device=device),
               "axis_nodes": ix(idx_np[np.asarray(problem.axis_nodes)])}

    def core(ks, fs, u0, u_pp, step0, iters_out=None, proj_iters_out=None):
        with torch.no_grad():
            return vmem_sweep_scan(
                ops, ks, fs, u0, u_pp, step0, dtype=dtype, ic=ic, dt=dt,
                num_steps=num_steps, base_k=base_k, fixed_iters=fixed_iters,
                rtol=rtol, maxiter=maxiter, extrapolate=extrapolate,
                rline=precondition == "rline", adi=precondition == "adi",
                rtol_wrt=rtol_wrt, f64_refine=f64_refine, record=rec,
                proj_rtol=proj_rtol, proj_maxiter=proj_maxiter,
                iters_out=iters_out, proj_iters_out=proj_iters_out)

    def simulate_batch(sample_k, fwhm, iters_out=None, proj_iters_out=None):
        B = len(np.atleast_1d(np.asarray(sample_k)))
        u0 = torch.full((B, nz, nr), float(problem.ic_temp), dtype=wdt,
                        device=device)
        out = core(sample_k, fwhm, u0, u0, 0, iters_out, proj_iters_out)[0]
        if rec is not None:
            out = dict(out, times=simulate_batch.times)
        return out

    def segment(sample_k, fwhm, u0, step0, u_pp=None, iters_out=None):
        """(traces, u_fin, u_penultimate) for one time chunk — the contract
        of the structured ``make_sweep_fn(...).segment`` (fields live on
        the overlay lattice)."""
        u0 = torch.as_tensor(u0, dtype=wdt, device=device)
        u_pp = u0 if u_pp is None else torch.as_tensor(u_pp, dtype=wdt,
                                                       device=device)
        return core(sample_k, fwhm, u0, u_pp, int(step0), iters_out)

    simulate_batch.segment = segment
    simulate_batch.shape = (nz, nr)
    simulate_batch.ic_temp = float(problem.ic_temp)
    simulate_batch.dt = float(problem.dt)
    simulate_batch.times = np.arange(1, num_steps + 1) * problem.dt
    if record_gradient:
        simulate_batch.band_centers = problem.bin_centers
        simulate_batch.axis_z = problem.axis_z
    return simulate_batch


def make_sweep_fn_unstructured(problem: ProblemUnstructured, *,
                               vary_material: str = "p_sample",
                               dtype: torch.dtype = torch.float32,
                               rtol: float = 1e-6, maxiter: int = 4000,
                               fixed_iters: int | None = None,
                               warm_start: str = "previous",
                               solver: str = "xla",
                               record_gradient: bool = False,
                               num_steps: int | None = None,
                               mesh=None, rtol_wrt: str = "b",
                               precondition: str = "jacobi",
                               f64_refine: int = 0, device="cuda"):
    """Batched sweep on an unstructured mesh: ``simulate_batch(sample_k
    (B,), fwhm (B,))`` -> watcher traces (B, S, W), a tensor on ``device``
    (the card unless the caller passes ``device='cpu'``; a missing card
    raises) — the unstructured mirror of ``sweepkernel.make_sweep_fn``.

    ``solver='vmem'`` (grid-overlay meshes only): the 9-plane lattice
    operator through the batched kernels of the structured sweeps (K2 to
    ``rtol``, K3 with ``fixed_iters``; their plain versions for CPU
    tensors), with ``.segment`` for time-chunked runs. ``solver='xla'``:
    the lanes as a leading batch dimension of
    :func:`make_simulate_fn_unstructured`'s module (the eager PCG per lane,
    a converged lane frozen while the others iterate).

    ``record_gradient=True``: each config also records band/axis
    radial-gradient rows (ref run_no_diamond.py:602-617); ``simulate_batch``
    then returns the dict {watch, band, axis, times}. With 'vmem' the
    projection runs through K2's Kv-free form on the lattice.

    ``rtol_wrt``, ``precondition`` ('jacobi' / 'rline' / 'adi' on 'vmem')
    and ``f64_refine`` mirror the structured maker. ``mesh`` (a
    ``parallel.sharding.DeviceMesh``): every rank calls with the same full
    batch, runs its shard of the configs on its device and returns the
    whole gathered batch (``parallel.sharding.shard_configs``); a 'z' axis
    replicates (the lanes of a z group run whole on each of its ranks, as
    in the JAX package). Memoized on ``problem.extras``."""
    from heatflow_tpu_torch.sim.sweepkernel import _mesh_device
    if f64_refine:
        rtol_wrt = "b"   # the refined inner solves stop wrt their own rhs
    device = _mesh_device(mesh, device)
    cache_key = ("sweep_fn", vary_material, str(dtype), rtol, maxiter,
                 fixed_iters, warm_start, solver, record_gradient,
                 num_steps, mesh, rtol_wrt, precondition, f64_refine,
                 str(device))
    cache = problem.extras.setdefault("_fn_cache", {})
    if cache_key in cache:
        return cache[cache_key]
    if warm_start not in ("previous", "extrapolate"):
        raise ValueError(f"unknown warm_start {warm_start!r} for sweep "
                         "engines (use 'previous' or 'extrapolate')")
    m_idx = _material_order(problem.mesh).index(vary_material)
    if problem.watcher_nodes is None:
        raise ValueError("sweeps need watcher points on the problem")

    if solver == "vmem":
        if record_gradient and num_steps is not None:
            raise ValueError("recording sweeps run unsegmented (no "
                             "num_steps)")
        if f64_refine:
            if dtype != torch.float32:
                raise ValueError("f64_refine is the mixed-precision mode: "
                                 "dtype must be float32")
            if fixed_iters is not None:
                raise ValueError("f64_refine composes with the "
                                 "tolerance-based solve (drop fixed_iters)")
        simulate_batch = _sweep_vmem_unstructured(
            problem, m_idx, dtype=dtype, rtol=rtol, maxiter=maxiter,
            fixed_iters=fixed_iters, warm_start=warm_start, device=device,
            num_steps=num_steps, rtol_wrt=rtol_wrt,
            precondition=precondition, f64_refine=f64_refine,
            record_gradient=record_gradient)
        simulate_batch.watcher_names = list(problem.watcher_names)
        simulate_batch.device = device
        cache[cache_key] = _sharded(mesh, simulate_batch)
        return cache[cache_key]
    if solver != "xla":
        raise ValueError(f"unknown solver {solver!r}")
    if num_steps is not None:
        raise ValueError("segmented (num_steps=...) unstructured sweeps "
                         "run through solver='vmem' (overlay meshes)")
    if f64_refine and not record_gradient:
        raise ValueError("f64_refine sweeps run through solver='vmem' (the "
                         "batched correction kernel); the eager path "
                         "refines only with record_gradient (the batched "
                         "stepper)")

    fn = make_simulate_fn_unstructured(
        problem, dtype=dtype, device=device, rtol=rtol, maxiter=maxiter,
        fixed_iters=fixed_iters, record_gradient=record_gradient,
        differentiable=fixed_iters is None and not record_gradient,
        warm_start=warm_start, rtol_wrt=rtol_wrt, precondition=precondition,
        f64_refine=f64_refine)
    wdt = torch.float64 if f64_refine else dtype
    n = len(problem.mesh.nodes)

    def simulate_batch(sample_k, fwhm):
        ks = torch.as_tensor(np.atleast_1d(np.asarray(sample_k, float)),
                             dtype=wdt, device=device)
        fs = torch.as_tensor(np.atleast_1d(np.asarray(fwhm, float)),
                             dtype=wdt, device=device)
        B = len(ks)
        kp = torch.as_tensor(problem.kappas, dtype=wdt,
                             device=device).repeat(B, 1)
        kp[:, m_idx] = ks
        u0 = torch.full((B, n), float(problem.ic_temp), dtype=wdt,
                        device=device)
        with torch.no_grad():
            ys = fn(kp, None, fs, u0, 0.0, None)
        if record_gradient:
            return {"watch": ys["watch"], "band": ys["band"],
                    "axis": ys["axis"], "times": simulate_batch.times}
        return ys["watch"]

    simulate_batch.times = np.arange(1, problem.num_steps + 1) * problem.dt
    simulate_batch.watcher_names = list(problem.watcher_names)
    simulate_batch.device = device
    if record_gradient:
        simulate_batch.band_centers = problem.bin_centers
        simulate_batch.axis_z = problem.axis_z
    cache[cache_key] = _sharded(mesh, simulate_batch)
    return cache[cache_key]


def _sharded(mesh, simulate_batch):
    """``simulate_batch`` itself, or under ``mesh`` its config-sharded form
    (``parallel.sharding.shard_configs``)."""
    if mesh is None:
        return simulate_batch
    from heatflow_tpu_torch.parallel.sharding import shard_configs
    return shard_configs(mesh, simulate_batch)


def solve_steady_unstructured(problem: ProblemUnstructured,
                              bc_values: np.ndarray, *, f=None,
                              weighted: bool = False,
                              dtype: torch.dtype = torch.float64,
                              rtol: float = 1e-11, maxiter: int = 50000,
                              device="cuda"):
    """Steady conduction Σ_m κ_m K_m u = f on the ELL operators with
    Dirichlet lifting — the unstructured mirror of ``steady.solve_steady``
    (ref space_and_forms.py:119-149), on ``device`` (the card unless the
    caller passes ``device='cpu'``). Returns (u (N,) numpy, info)."""
    device = resolve_device(device)
    ell = problem.ell
    Ksrc = ell.K_vals if weighted else ell.Kf_vals
    if Ksrc is None:
        raise ValueError("ELL ops lack unweighted stiffness; re-assemble")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    cols = torch.as_tensor(ell.cols, dtype=torch.int64, device=device)
    # (1, N) fields: the PCG's sums run over the last two dims
    row = lambda v: v[None, :]
    K = material_combine(t(problem.kappas), t(Ksrc))
    free, dirich = row(t(~problem.dirichlet)), row(t(problem.dirichlet))
    g = row(t(bc_values)) * dirich
    apply_K = lambda v: ell_apply(cols, K, v[0])[None, :]

    diag = row(ell_diag(cols, K))
    s = torch.rsqrt(torch.where(diag > 0, diag, torch.ones_like(diag))) \
        * free + dirich
    if f is None:
        b = torch.zeros_like(g)
    else:
        Msrc = ell.M_vals if weighted else ell.Mf_vals
        b = row(ell_apply(cols, t(Msrc).sum(0), t(f)))
    b_lift = (b - apply_K(g)) * s * free
    with torch.no_grad():
        sol = pcg(lambda y: s * apply_K(s * y), b_lift, torch.zeros_like(g),
                  mask=free, rtol=rtol, maxiter=maxiter)
    u = sol.x * s * free + g
    return u[0].cpu().numpy(), {"iters": int(sol.iters),
                                "residual": float(sol.residual),
                                "converged": bool(sol.converged)}

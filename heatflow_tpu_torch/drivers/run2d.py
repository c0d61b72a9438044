"""2D axisymmetric transient driver, the flagship entry point.

    python -m heatflow_tpu_torch.drivers.run2d --config cfgs/X.yaml \
        --mesh-folder meshes/X --rebuild-mesh --output-folder out/X

Parameter surface, on-disk artifacts and console reporting mirror the
reference's ``run_simulation`` (ref run_no_diamond.py:29-653,
run_with_diamond.py:27-551); the material layout is detected from the config,
so one driver covers the 5- and the 9-material DAC stacks. Outputs per run:

  * ``used_config.yaml``          — copy of the config actually used
  * ``watcher_points.csv``        — time column + one column per watcher
  * ``radial_gradient.csv``       — z-binned band-averaged ∂T/∂r (time index)
  * ``radial_gradient_raw.csv``   — raw ∂T/∂r at r=0 nodes (time index)
  * ``output.xdmf`` / ``.h5``     — full temperature time series (optional)
  * ``checkpoint.npz``            — final field and time, for ``--resume``
  * mesh folder: ``mesh.msh`` + ``mesh_cfg.yaml`` (with material_tags)

Structured meshes only: unstructured meshes (ROADMAP P9), z-sharding (P11)
and mesh plots (P10) are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time

import numpy as np
import torch

from heatflow_tpu_torch.config import (dump_yaml, load_config, save_config,
                                       validate_config)
from heatflow_tpu_torch.geometry import build_layout, coupler_watcher_points
from heatflow_tpu_torch.io.csvio import write_gradient_csv, write_watcher_csv
from heatflow_tpu_torch.mesh.msh_io import write_msh
from heatflow_tpu_torch.mesh.structured import (build_structured_mesh,
                                                mesh_from_meta)
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
from heatflow_tpu_torch.sim.stepper import _not_ported, run_transient
from heatflow_tpu_torch.utils import resolve_device


@contextlib.contextmanager
def suppress_output(enabled: bool):
    """Silence stdout/stderr (sweep workers), ref run_no_diamond.py:20-27."""
    if not enabled:
        yield
    else:
        with open(os.devnull, "w") as fnull:
            with contextlib.redirect_stdout(fnull), \
                 contextlib.redirect_stderr(fnull):
                yield


def default_dtype(device) -> torch.dtype:
    """float32 on a CUDA device, float64 on the CPU (the JAX package's x64
    CPU parity convention)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def _prepare_mesh(cfg, mesh_folder, rebuild_mesh, layout,
                  mesh_style="structured"):
    """Build-or-load the structured mesh, persisting/consuming mesh.msh +
    mesh_cfg.yaml as the reference does (ref run_no_diamond.py:140-180)."""
    if mesh_style == "unstructured":
        raise _not_ported("mesh_style='unstructured'", "P9")
    if mesh_style != "structured":
        raise ValueError(f"unknown mesh_style {mesh_style!r}")
    mesh_cfg_path = os.path.join(mesh_folder, "mesh_cfg.yaml")
    mesh_file_path = os.path.join(mesh_folder, "mesh.msh")
    domain, mats = build_layout(cfg, layout)

    if rebuild_mesh:
        os.makedirs(mesh_folder, exist_ok=True)
        mesh = build_structured_mesh(domain, mats)
        mesh_cfg = copy.deepcopy(cfg)
        mesh_cfg["material_tags"] = dict(mesh.material_tags)
        mesh_cfg["structured_grid"] = mesh.to_meta()
        with open(mesh_cfg_path, "w") as f:
            f.write(dump_yaml(mesh_cfg))
        tris, tri_tags = mesh.triangles()
        write_msh(mesh_file_path, mesh.node_coords(), tris, tri_tags,
                  mesh.material_tags)
        return mesh
    missing = [n for n, p in (("mesh.msh", mesh_file_path),
                              ("mesh_cfg.yaml", mesh_cfg_path))
               if not os.path.isfile(p)]
    if missing:
        raise FileNotFoundError(
            f"Missing required file(s) in {mesh_folder}: {', '.join(missing)}")
    mesh_cfg = load_config(mesh_cfg_path)
    if "structured_grid" not in mesh_cfg:
        raise _not_ported(f"the imported non-grid mesh in {mesh_folder} "
                          "(the unstructured path)", "P9")
    return mesh_from_meta(mesh_cfg["structured_grid"], materials=mats)


def run_simulation(cfg, mesh_folder, rebuild_mesh=False, visualize_mesh=False,
                   output_folder=None, watcher_points=None, write_xdmf=True,
                   suppress_print=False, *, layout="auto", dtype=None,
                   rtol=None, maxiter=20000, record_gradient=True,
                   solver="auto", profile_dir=None, resume_from=None,
                   write_checkpoint=True, mesh_style="structured",
                   warm_start=None, precondition=None,
                   z_shards=1, f64_refine=0, device="cuda"):
    """Run the 2D transient simulation on ``device``; see the module
    docstring for the outputs. Returns the :class:`TransientResult`.

    watcher_points: dict name -> (z, r), or list of {'name','coords'} dicts
    (same accepted forms as the reference, ref run_no_diamond.py:385-393).
    """
    with suppress_output(suppress_print):
        t_start = time.time()
        device = resolve_device(device)
        validate_config(cfg, require_heating_file=True)
        if visualize_mesh:
            raise _not_ported("mesh visualization (--visualize-mesh)", "P10")
        if z_shards > 1:
            raise _not_ported("z-sharding (--z-shards > 1)", "P11")
        if f64_refine and dtype is None:
            dtype = torch.float32   # refinement is the mixed-precision mode
        dtype = dtype or default_dtype(device)
        f32 = dtype == torch.float32
        if warm_start is None:
            # the linearly extrapolated seed at float32, 'previous' at
            # float64 (converged either way)
            warm_start = "extrapolate" if f32 else "previous"
        if rtol is None:
            # increment-relative stopping (rtol_wrt='r0'); with refinement
            # the inner correction tolerance
            rtol = 1e-11 if dtype == torch.float64 else 1e-4

        mesh = _prepare_mesh(cfg, mesh_folder, rebuild_mesh, layout,
                             mesh_style)
        if precondition is None:
            from heatflow_tpu_torch.utils import \
                resolve_recording_precondition
            # will the stepper take its kernel path (the 'vmem' solver)?
            vmem_single = solver == "vmem" or (
                solver == "auto" and device.type == "cuda" and f32)
            precondition = resolve_recording_precondition(
                record_gradient, dtype, f64_refine=f64_refine,
                vmem_single=vmem_single, rtol_wrt="r0")
        print(f"Mesh ready: {mesh.shape[0]} x {mesh.shape[1]} grid = "
              f"{mesh.num_nodes} nodes, {2 * mesh.num_cells} triangles")

        heating = HeatingCurve.from_csv(cfg["heating"]["file"])

        if isinstance(watcher_points, list):
            watcher_points = {pt["name"]: tuple(pt["coords"])
                              for pt in watcher_points}
        elif watcher_points is not None and not isinstance(watcher_points,
                                                           dict):
            raise ValueError("watcher_points must be a dict or list of dicts")

        print("Assigning material properties...")
        problem = build_problem(mesh, heating, cfg,
                                watcher_points=watcher_points)
        print("Material properties assigned.")
        if record_gradient:
            from heatflow_tpu_torch.sim.problem import radial_band_analysis
            band = radial_band_analysis(mesh)
            print(f"--- Radial Band Analysis ---\n"
                  f"  Nodes in band: {band['n_band_nodes']}, "
                  f"β = {band.get('beta', float('nan')):.4f} "
                  f"({band['verdict']})\n"
                  f"----------------------------")

        # output folder layout (ref run_no_diamond.py:348-362)
        if output_folder is not None:
            save_folder = output_folder
        else:
            save_folder = os.path.join(os.getcwd(), "sim_outputs",
                                       "heatflow_tpu_run")
        os.makedirs(save_folder, exist_ok=True)
        save_config(cfg, os.path.join(save_folder, "used_config.yaml"))

        u0, t0 = None, 0.0
        if resume_from is not None:
            from heatflow_tpu_torch.io.checkpoint import load_checkpoint
            u0, t0, step0, _ = load_checkpoint(resume_from)
            print(f"Resuming from checkpoint at t={t0:.4e} s"
                  + (f" (step {step0})" if step0 is not None else ""))

        print("Beginning loop...")
        t_loop = time.time()
        from heatflow_tpu_torch.utils import profile_trace
        with profile_trace(profile_dir):
            result = run_transient(problem, dtype=dtype, device=device,
                                   rtol=rtol, maxiter=maxiter,
                                   record_gradient=record_gradient,
                                   record_fields=write_xdmf, solver=solver,
                                   warm_start=warm_start,
                                   precondition=precondition,
                                   f64_refine=f64_refine, u0=u0, t0=t0)
        t_end = time.time()

        # ---------------- outputs ----------------
        if watcher_points:
            write_watcher_csv(
                os.path.join(save_folder, "watcher_points.csv"),
                result.times,
                {n: result.watcher[:, k]
                 for k, n in enumerate(result.watcher_names)})
        if record_gradient and result.band_rows is not None:
            write_gradient_csv(
                os.path.join(save_folder, "radial_gradient.csv"),
                result.times, result.band_centers, result.band_rows)
            write_gradient_csv(
                os.path.join(save_folder, "radial_gradient_raw.csv"),
                result.times, result.axis_z, result.axis_rows)
        if write_xdmf:
            from heatflow_tpu_torch.io.xdmfio import XDMFTimeSeriesWriter
            tris, _ = mesh.triangles()
            w = XDMFTimeSeriesWriter(
                os.path.join(save_folder, "output.xdmf"),
                mesh.node_coords(), tris)
            w.write(np.full(mesh.num_nodes, problem.ic_temp), 0.0)
            for s, t in enumerate(result.times):
                w.write(result.fields[s].ravel(), float(t))
            w.close()

        if write_checkpoint:
            from heatflow_tpu_torch.io.checkpoint import save_checkpoint
            save_checkpoint(save_folder, result.final_u,
                            float(result.times[-1]),
                            step=problem.num_steps)

        # ---------------- timing summary (ref :619-630) ----------------
        total = t_end - t_start
        loop = t_end - t_loop
        per_step = loop / max(1, problem.num_steps)
        print("\n--- Timing Summary ---")
        print(f"Total time: {total:.2f} s")
        print(f"Startup time: {t_loop - t_start:.2f} s")
        print(f"Loop time: {loop:.2f} s (includes the kernels' first build)")
        print(f"Average time per step: {per_step:.4f} s")
        print(f"CG iterations/step: min {result.cg_iters.min()} "
              f"max {result.cg_iters.max()} mean {result.cg_iters.mean():.1f}")
        print("----------------------\n")
        return result


def _parse_watchers(text: str) -> dict:
    """A mapping name -> [z, r] given as YAML (when PyYAML is installed) or
    JSON."""
    try:
        import yaml
    except ImportError:
        parsed = json.loads(text)
    else:
        parsed = yaml.safe_load(text)
    return {k: tuple(v) for k, v in parsed.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="heatflow_tpu_torch 2D transient solver")
    p.add_argument("--config", type=str, default="simulation_template.yaml")
    p.add_argument("--mesh-folder", type=str, default="meshes")
    p.add_argument("--rebuild-mesh", action="store_true")
    p.add_argument("--visualize-mesh", action="store_true",
                   help="not ported yet (ROADMAP P10)")
    p.add_argument("--output-folder", type=str, default=None)
    p.add_argument("--watcher-points", type=str, default=None,
                   help="YAML/JSON mapping name -> [z, r]; 'auto' places "
                        "points at the coupler centers")
    p.add_argument("--write-xdmf", action="store_true")
    p.add_argument("--suppress-print", action="store_true")
    p.add_argument("--layout", choices=["auto", "no_diamond", "with_diamond",
                                        "custom"],
                   default="auto",
                   help="'custom': every material carries explicit bounds "
                        "[zmin,zmax,rmin,rmax]")
    p.add_argument("--mesh-style", choices=["structured", "unstructured"],
                   default="structured",
                   help="'unstructured' is not ported yet (ROADMAP P9)")
    p.add_argument("--solver", choices=["xla", "vmem", "auto"],
                   default="auto",
                   help="'vmem': the hand-written CUDA PCG kernel; 'xla': "
                        "the eager PyTorch PCG; 'auto' (default): the "
                        "kernel on a CUDA device in float32, eager "
                        "otherwise")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; fails when "
                        "there is no card; 'cpu' runs the plain versions)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="record a torch.profiler trace into this directory")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint.npz (or its folder) to resume from")
    p.add_argument("--warm-start", choices=["previous", "extrapolate"],
                   default=None,
                   help="CG seed per step: previous solution, or its linear "
                        "time extrapolation. Default: extrapolate at f32, "
                        "previous at f64")
    p.add_argument("--precondition",
                   choices=["jacobi", "rline", "zline", "adi", "mg",
                            "adaptive", "mgz"],
                   default=None,
                   help="CG preconditioner: 'rline' r-line block-"
                        "tridiagonal (PCR), 'adi' r-line + z-line, "
                        "'adaptive' the per-step rline/adi switch (kernel "
                        "path), 'mg' the geometric multigrid V-cycle "
                        "(eager path), 'mgz' the z-semicoarsened two-level "
                        "V-cycle inside the kernel (kernel path). Default: "
                        "the per-regime choice (f32 'adi', refined "
                        "'adaptive' on the kernel path, f64 'jacobi')")
    p.add_argument("--f64-refine", type=int, default=0,
                   help="mixed-precision iterative refinement: N passes of "
                        "f64-residual / f32-correction per step")
    p.add_argument("--z-shards", type=int, default=1,
                   help="not ported yet beyond 1 (ROADMAP P11)")
    p.add_argument("--rtol", type=float, default=None,
                   help="CG stopping tolerance (increment-relative, "
                        "rtol_wrt='r0'; with --f64-refine the inner "
                        "correction solves' tolerance). Default: 1e-11 at "
                        "f64, 1e-4 at f32")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    if args.watcher_points == "auto":
        wp = coupler_watcher_points(cfg)
    elif args.watcher_points:
        wp = _parse_watchers(args.watcher_points)
    else:
        wp = None
    run_simulation(cfg, args.mesh_folder, args.rebuild_mesh,
                   args.visualize_mesh, args.output_folder, wp,
                   args.write_xdmf, args.suppress_print, layout=args.layout,
                   solver=args.solver, profile_dir=args.profile_dir,
                   resume_from=args.resume, mesh_style=args.mesh_style,
                   warm_start=args.warm_start,
                   precondition=args.precondition, z_shards=args.z_shards,
                   f64_refine=args.f64_refine, rtol=args.rtol,
                   device=args.device)


if __name__ == "__main__":
    main()

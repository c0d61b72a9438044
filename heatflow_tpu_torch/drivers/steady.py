"""Steady-state driver: solve κ∇²u = 0 with the heating boundary held at a
fixed level, optionally followed by a transient run seeded from the steady
field — the with_ir_steady / with_gasket notebook workflow as a CLI.

    python -m heatflow_tpu_torch.drivers.steady --config C --mesh-folder M \\
        [--rebuild-mesh] [--output-folder O] [--amplitude K] [--weighted] \\
        [--then-transient] [--no-xdmf] [--device cuda|cpu]

Writes ``used_config.yaml``, ``steady_field.npy`` and ``steady.xdmf`` (and,
with ``--then-transient`` and watcher points, ``watcher_points.csv``) into the
output folder. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from heatflow_tpu_torch.config import load_config, save_config
from heatflow_tpu_torch.drivers.run2d import _prepare_mesh, default_dtype
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.io.csvio import write_watcher_csv
from heatflow_tpu_torch.io.xdmfio import XDMFTimeSeriesWriter
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
from heatflow_tpu_torch.sim.steady import solve_steady, steady_heating_values
from heatflow_tpu_torch.sim.stepper import run_transient
from heatflow_tpu_torch.utils import resolve_device


def run_steady(cfg, mesh_folder, *, rebuild_mesh=False, output_folder=None,
               amplitude=None, weighted=False, then_transient=False,
               watcher_points=None, write_xdmf=True, dtype=None,
               device="cuda"):
    """Solve the steady problem on ``device``; optionally continue with the
    transient run seeded by the steady field. Returns (u_steady, info[,
    transient])."""
    device = resolve_device(device)
    dtype = dtype or default_dtype(device)
    mesh = _prepare_mesh(cfg, mesh_folder, rebuild_mesh, "auto")
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    problem = build_problem(mesh, heating, cfg,
                            watcher_points=watcher_points)
    g = steady_heating_values(problem, amplitude=amplitude)
    u, info = solve_steady(problem, g, weighted=weighted, dtype=dtype,
                           device=device)
    print(f"Steady solve: {info['iters']} iterations, "
          f"residual {info['residual']:.3e}, converged={info['converged']}, "
          f"T in [{u.min():.1f}, {u.max():.1f}] K")

    save_folder = output_folder or os.path.join(os.getcwd(), "sim_outputs",
                                                "steady")
    os.makedirs(save_folder, exist_ok=True)
    save_config(cfg, os.path.join(save_folder, "used_config.yaml"))
    np.save(os.path.join(save_folder, "steady_field.npy"), u)
    if write_xdmf:
        tris, _ = mesh.triangles()
        w = XDMFTimeSeriesWriter(os.path.join(save_folder, "steady.xdmf"),
                                 mesh.node_coords(), tris)
        w.write(u.ravel(), 0.0)
        w.close()

    if not then_transient:
        return u, info
    result = run_transient(problem, dtype=dtype, device=device, u0=u,
                           record_gradient=False)
    if watcher_points:
        write_watcher_csv(os.path.join(save_folder, "watcher_points.csv"),
                          result.times,
                          {n: result.watcher[:, k]
                           for k, n in enumerate(result.watcher_names)})
    print("Transient-from-steady complete.")
    return u, info, result


def main(argv=None):
    p = argparse.ArgumentParser(
        description="heatflow_tpu_torch steady-state solver")
    p.add_argument("--config", required=True)
    p.add_argument("--mesh-folder", required=True)
    p.add_argument("--rebuild-mesh", action="store_true")
    p.add_argument("--output-folder", default=None)
    p.add_argument("--amplitude", type=float, default=None,
                   help="heating level [K]; defaults to the curve at t=0")
    p.add_argument("--weighted", action="store_true",
                   help="use the axisymmetric r-weighted form (the "
                        "reference's steady form is unweighted)")
    p.add_argument("--then-transient", action="store_true")
    p.add_argument("--no-xdmf", action="store_true",
                   help="skip steady.xdmf / steady.h5 (they need h5py)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; fails when "
                        "there is no card; 'cpu' runs in float64)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    run_steady(cfg, args.mesh_folder, rebuild_mesh=args.rebuild_mesh,
               output_folder=args.output_folder, amplitude=args.amplitude,
               weighted=args.weighted, then_transient=args.then_transient,
               watcher_points=coupler_watcher_points(cfg),
               write_xdmf=not args.no_xdmf, device=args.device)


if __name__ == "__main__":
    main()

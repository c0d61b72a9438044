"""1D reduced-model driver (ref run_no_diamond_1d.py:166-823).

    python -m heatflow_tpu_torch.drivers.run1d --config cfgs/X_1d.yaml \
        --mesh-folder-2d meshes/X --output-folder out/X_1d \
        --radial-gradient-path out/X/radial_gradient.csv

Extracts the r=0 axis from a persisted 2D mesh, optionally applies the
radial-correction source interpolated from a 2D run's radial-gradient CSV,
and integrates with exact tridiagonal solves. Same on-disk artifacts as the
reference: used_config.yaml, watcher_points.csv, output.xdmf.

Structured meshes only: an imported non-grid ``.msh`` and
``mesh_style='unstructured'`` (ROADMAP P9) raise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from heatflow_tpu_torch.config import load_config, save_config
from heatflow_tpu_torch.drivers.run2d import (_parse_watchers, _prepare_mesh,
                                              suppress_output)
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.io.csvio import write_watcher_csv
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.reduced1d import (GradientTable, build_problem_1d,
                                              extract_axis_submesh,
                                              make_simulate_fn_1d)
from heatflow_tpu_torch.utils import resolve_device


def _find_gradient_csv(mesh_folder_2d: str,
                       config_name: str | None = None) -> str | None:
    """Auto-search candidate output dirs for a gradient CSV (smoothed first),
    ref run_no_diamond_1d.py:322-342.

    Candidate run-dir names are derived from the config (``config_name``,
    typically the config file stem) first, then the reference's canonical
    workflow name, then any run directory under the output bases that holds
    a gradient CSV — so the correction auto-finds gradients for any config.
    """
    bases = [
        os.path.join(mesh_folder_2d, "..", "outputs"),
        os.path.join(mesh_folder_2d, "..", "..", "outputs"),
        os.path.join(os.getcwd(), "outputs"),
        os.path.join(os.getcwd(), "sim_outputs"),
    ]
    names = [config_name] if config_name else []
    names.append("geballe_no_diamond_read_flux")  # ref hardcoded default
    # named run dirs first — BOTH CSV kinds — so a raw CSV in this config's
    # own run dir always outranks another run's smoothed CSV
    for fname in ("radial_gradient.csv", "radial_gradient_raw.csv"):
        for base in bases:
            for nm in names:
                p = os.path.join(base, nm, fname)
                if os.path.exists(p):
                    return p
    # last resort: any run dir holding a gradient CSV (the caller reports
    # the full path so an unrelated run's gradients are visible)
    for fname in ("radial_gradient.csv", "radial_gradient_raw.csv"):
        for base in bases:
            if os.path.isdir(base):
                for sub in sorted(os.listdir(base)):
                    p = os.path.join(base, sub, fname)
                    if os.path.exists(p):
                        return p
    return None


def run_1d(cfg, mesh_folder_2d, mesh_folder_1d=None, rebuild_mesh=False,
           visualize_mesh=False, output_folder=None, watcher_points=None,
           write_xdmf=True, suppress_print=False, use_radial_correction=True,
           radial_gradient_path=None, *, layout="auto", dtype=None,
           config_name=None, mesh_style="structured", device="cuda"):
    """Run the 1D reduced simulation on ``device`` (the card unless the
    caller passes ``device='cpu'``). Parameter surface mirrors the
    reference's run_1d (ref run_no_diamond_1d.py:166-192). Returns
    (problem, ys) with ys a dict of numpy arrays."""
    with suppress_output(suppress_print):
        t_start = time.time()
        device = resolve_device(device)
        # float64 on either device: the model is a direct solve over a few
        # hundred nodes, and its traces are held to 1e-8 of the reference's
        dtype = dtype or torch.float64
        del mesh_folder_1d  # the 1D mesh is derived, nothing extra persisted

        mesh2d = _prepare_mesh(cfg, mesh_folder_2d, rebuild_mesh, layout,
                               mesh_style)
        z, tags1d = extract_axis_submesh(mesh2d)
        print(f"Extracted 1D axis submesh: {len(z)} nodes, "
              f"{len(tags1d)} cells, z-range [{z.min():.6e}, {z.max():.6e}]")
        uniq, counts = np.unique(tags1d, return_counts=True)
        print("Material tag distribution:",
              {int(t): int(c) for t, c in zip(uniq, counts)})
        if visualize_mesh:
            print(f"1D mesh nodes: {z}")

        gradient = None
        if use_radial_correction:
            path = radial_gradient_path or _find_gradient_csv(
                mesh_folder_2d, config_name=config_name)
            if path is None:
                print("Warning: Could not find radial gradient file. "
                      "Disabling radial heating correction.")
                use_radial_correction = False
            else:
                gradient = GradientTable.from_csv(path)
                print(f"Radial heating correction: ENABLED "
                      f"({path}, Δr={gradient.delta_r:.2e})")
                if (z.min() < gradient.z.min() - 1e-15
                        or z.max() > gradient.z.max() + 1e-15):
                    print("WARNING: 1D mesh extends beyond gradient data "
                          "z-range; coordinates will be clamped.")
        else:
            print("Radial heating correction: DISABLED (user choice)")

        heating = HeatingCurve.from_csv(cfg["heating"]["file"])
        problem = build_problem_1d(mesh2d, heating, cfg, gradient=gradient)

        watcher_z = None
        if watcher_points is not None:
            if isinstance(watcher_points, dict):
                watcher_z = {k: float(v[0]) if np.ndim(v) else float(v)
                             for k, v in watcher_points.items()}
            elif isinstance(watcher_points, list):
                watcher_z = {pt["name"]: float(pt["coords"][0])
                             for pt in watcher_points}
            else:
                raise ValueError(
                    "watcher_points must be a dict or list of dicts")

        fn = make_simulate_fn_1d(
            problem, dtype=dtype,
            use_radial_correction=use_radial_correction,
            record_fields=write_xdmf, watcher_z=watcher_z, device=device)
        print("Beginning 1D simulation loop...")
        t_loop = time.time()
        ys = {k: v.cpu().numpy() for k, v in fn().items()}
        t_end = time.time()

        if output_folder is not None:
            save_folder = output_folder
        else:
            save_folder = os.path.join(os.getcwd(), "sim_outputs",
                                       "1d_simulation")
        os.makedirs(save_folder, exist_ok=True)
        save_config(cfg, os.path.join(save_folder, "used_config.yaml"))

        if watcher_z:
            write_watcher_csv(
                os.path.join(save_folder, "watcher_points.csv"), ys["times"],
                {n: ys["watch"][:, k] for k, n in enumerate(watcher_z)})
        if write_xdmf:
            from heatflow_tpu_torch.io.xdmfio import XDMFTimeSeriesWriter
            nodes = np.stack([z, np.zeros_like(z)], axis=1)
            cells = np.stack([np.arange(len(z) - 1),
                              np.arange(1, len(z))], axis=1)
            w = XDMFTimeSeriesWriter(
                os.path.join(save_folder, "output.xdmf"), nodes, cells)
            w.write(np.full(len(z), problem.ic_temp), 0.0)
            for s, t in enumerate(ys["times"]):
                w.write(ys["field"][s], float(t))
            w.close()

        print("\n--- 1D Simulation Timing Summary ---")
        print(f"Total time: {t_end - t_start:.2f} s")
        print(f"Loop time: {t_end - t_loop:.2f} s")
        print(f"Average time per step: "
              f"{(t_end - t_loop) / max(1, problem.num_steps):.4f} s")
        print("------------------------------------\n")
        return problem, ys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="heatflow_tpu_torch 1D reduced model")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--mesh-folder-2d", type=str, required=True)
    p.add_argument("--rebuild-mesh", action="store_true")
    p.add_argument("--output-folder", type=str, default=None)
    p.add_argument("--write-xdmf", action="store_true")
    p.add_argument("--no-radial-correction", action="store_true")
    p.add_argument("--radial-gradient-path", type=str, default=None)
    p.add_argument("--watcher-points", type=str, default="auto",
                   help="YAML/JSON mapping name -> [z, r]; 'auto' places "
                        "points at the coupler centers")
    p.add_argument("--suppress-print", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; fails when "
                        "there is no card); float64 on either device")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    wp = coupler_watcher_points(cfg) if args.watcher_points == "auto" \
        else _parse_watchers(args.watcher_points)
    run_1d(cfg, args.mesh_folder_2d, rebuild_mesh=args.rebuild_mesh,
           output_folder=args.output_folder, watcher_points=wp,
           write_xdmf=args.write_xdmf, suppress_print=args.suppress_print,
           use_radial_correction=not args.no_radial_correction,
           radial_gradient_path=args.radial_gradient_path,
           config_name=os.path.splitext(os.path.basename(args.config))[0],
           device=args.device)


if __name__ == "__main__":
    main()

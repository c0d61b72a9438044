"""Single transients back to back on an imported gmsh mesh, one client
waiting for each: the forward evaluations of a fit on the upstream
project's own kind of mesh, which has no lattice under it.

The ``transient`` family's unit and record (``forms``, ``iters``,
``watch``) over ``make_simulate_fn_unstructured(problem, **recipe)``.
Set-up hands the program the configuration's triangulation as ``run2d``
loads a mesh folder without a ``mesh_overlay.npz`` sidecar: the mesh
written as ``mesh.msh`` (into a directory under ``build/hfbench/`` of the
checkout, removed after), read back with ``read_msh`` (no grid overlay,
so the program takes the ELL gather), and its problem built from it; then
it makes the module and runs one transient at the configuration's own
coefficients (the graph capture, or the eager loop's first pass).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from hfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_transient = harness.load_module("traffic", "transient", ROOT)
unit = _transient.unit


def imported(run):
    """The program's problem on the configuration's mesh as an imported
    ``.msh``: the nodes, triangles and tags of the harness's mesh, written
    and read back, with no overlay."""
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.mesh.msh_io import read_msh, write_msh
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.unstructured import (
        build_problem_unstructured)
    mesh = run.problem.mesh
    work = os.path.join(run.root, "build", "hfbench")
    os.makedirs(work, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as folder:
        path = os.path.join(folder, "mesh.msh")
        write_msh(path, mesh.nodes, mesh.cells, mesh.cell_tags,
                  mesh.material_tags)
        msh = read_msh(path)
    if msh.grid_overlay is not None or not (
            np.array_equal(msh.nodes, mesh.nodes)
            and np.array_equal(msh.cells, mesh.cells)):
        raise RuntimeError("the mesh read back is not the mesh written")
    cfg = run.cfg
    return build_problem_unstructured(
        msh, HeatingCurve.from_csv(run.heating_csv), cfg,
        watcher_points=coupler_watcher_points(cfg))


def setup(run) -> None:
    from heatflow_tpu_torch.sim.unstructured import (
        make_simulate_fn_unstructured)
    run.problem = imported(run)
    run.entry = make_simulate_fn_unstructured(run.problem, device=run.device,
                                              **run.recipe())
    run.entry()
    run.sync()

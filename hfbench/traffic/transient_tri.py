"""Single transients back to back on an unstructured mesh, one client
waiting for each: the forward evaluations of a fit on the upstream
project's kind of mesh.

The ``transient`` family's unit and record (``forms``, ``adi_solves``,
``iters``, ``watch``) over ``make_simulate_fn_unstructured(problem,
**recipe)``, the program's entry point for a triangulation. Set-up makes
the module and runs one transient at the configuration's own
coefficients (the graph capture, or the eager loop's first pass).
"""

from __future__ import annotations

import os

from hfbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_transient = harness.load_module("traffic", "transient", ROOT)
unit = _transient.unit


def setup(run) -> None:
    from heatflow_tpu_torch.sim.unstructured import (
        make_simulate_fn_unstructured)
    run.entry = make_simulate_fn_unstructured(run.problem, device=run.device,
                                              **run.recipe())
    run.entry()
    run.sync()

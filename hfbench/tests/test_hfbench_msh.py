"""The cell ``msh_flagship.transient``: its files load and agree with
``BENCHMARK.json``; its family hands the program the triangulation as an
imported mesh (no overlay: the ELL gather) and runs the cell's own recipe
at a small size on the CPU (through the one-graph path's plain version,
which the CPU's eager loop does not take), judged correct; the control
fails its comparison; the reader it adds (``k1_roofline.ell``) on a
hand-built profile."""

import os
import time
import types

import numpy as np
import pytest
import torch

from hfbench import control, harness
from hfbench.reference import chipmath

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELL = "msh_flagship.transient"
# the cell at a CPU test's size
SMALL = {"size_scale": 16.0, "draw_set": 2, "trace_units": 1}
# the per-layer metrics the triangulation's cell reports, which the one-graph
# path opens here too, and the roofline of the ELL arrays, with the cell alone
SHARED = ("k1.iters_per_step", "stepper.idle_between_solves_ms",
          "stepper.prepare_ms", "stepper.idle_in_prepare_ms",
          "stepper.idle_in_graph_ms", "device_idle_pct.transient",
          "stepper.reorder_ms")
NEW = ("k1_roofline.ell",)


def doc(kind, name):
    return harness.load_json(os.path.join(ROOT, "hfbench", kind,
                                          f"{name}.json"))


def test_the_cells_files_agree_with_the_benchmark():
    """The triangulation cell's settings, heating, mesh and traffic, with
    the imported-mesh family, the ELL path's recipe ('jacobi', one float64
    pass) and one traced transient."""
    workload, config = harness.find_cell(SPEC, CELL)
    tri = doc("configs", "geballe_with_diamond_tri")
    assert config["mesh"] == {"kind": "triangulation"}
    assert config["config"] == tri["config"]
    assert config["heating_csv"] == tri["heating_csv"]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    assert "imported_mesh" in config["assumed"]
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == workload["config"])
    assert entry["file"] == "hfbench/configs/geballe_with_diamond_msh.json"
    assert entry["source"] == config["source"] and entry["reduced"] == []
    assert workload["traffic"] == "transient_msh"
    params = workload["params"]
    assert params["recipe"] == dict(
        dtype="float32", rtol=1e-4, maxiter=8000, record_gradient=False,
        record_fields=False, rtol_wrt="r0", solver="vmem",
        precondition="jacobi", warm_start="extrapolate", f64_refine=1)
    assert params["trace_units"] == 1 and params["draw_set"] == 12
    assert params["check_samples"] == 1
    assert params["check_hardest"] == ["iters"]
    assert params["box"] == doc("workloads", "tri_flagship.transient")[
        "params"]["box"]
    assert set(params["limits"]) == {"watch_gap_K", "watch_step_gap_K",
                                     "unanswered"}
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    metrics = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("steps_per_s", "transient_p90_ms") + SHARED:
        assert CELL in metrics[name]["workloads"], name
    for name in NEW:
        assert metrics[name]["workloads"] == [CELL], name
        assert metrics[name]["moves"] == "steps_per_s", name
    run = harness.new_run(CELL, 0, overrides=SMALL)
    assert run.mesh == "triangulation"
    assert [m["name"] for m in harness.cell_metrics(run)] == [
        "steps_per_s", "transient_p90_ms", "setup_s"]
    run.trace = True
    assert sorted(m["name"] for m in harness.cell_metrics(run)) == sorted(
        SHARED + NEW + ("setup.device_s", "setup.host_s"))


@pytest.fixture
def graph_path(monkeypatch):
    """The CPU takes the one-graph path, as a call on the card does: its
    plain version (``cuda_step.run_stepwise`` in place of
    ``cuda_step.run``)."""
    from heatflow_tpu_torch.ops import cuda_step
    from heatflow_tpu_torch.sim import unstructured
    monkeypatch.setattr(unstructured.SimulatorUnstructured, "_run",
                        lambda self, *a: self._run_lattice(*a))
    monkeypatch.setattr(cuda_step, "run", cuda_step.run_stepwise)


def test_the_family_imports_the_mesh_without_overlay():
    """Set-up's problem: the harness's triangulation read back from a
    ``.msh`` with no overlay, the same nodes, cells and watchers; the
    module on the kernel path's ELL form, its rows reordered."""
    run = harness.new_run(CELL, 5, 0.0, False, torch.device("cpu"),
                          overrides=SMALL)
    run.problem = harness.build_problem(run)
    family = harness.load_module("traffic", "transient_msh")
    p = family.imported(run)
    assert run.problem.mesh.grid_overlay is not None
    assert p.mesh.grid_overlay is None
    assert np.array_equal(p.mesh.nodes, run.problem.mesh.nodes)
    assert np.array_equal(p.mesh.cells, run.problem.mesh.cells)
    assert np.array_equal(p.watcher_nodes, run.problem.watcher_nodes)
    assert np.array_equal(p.ell.cols, run.problem.ell.cols)
    from heatflow_tpu_torch.sim.unstructured import (
        make_simulate_fn_unstructured)
    fn = make_simulate_fn_unstructured(p, device="cpu", **run.recipe())
    assert fn.use_vmem and not fn.overlay and fn.reordered
    assert fn.form.cols is not None


def cpu_run(seed=2 ** 31 + 29):
    return harness.run_cell(CELL, seed, 0.2, False, "cpu",
                            time.perf_counter(), overrides=SMALL)


def test_the_cell_runs_on_the_cpu_and_is_correct(graph_path):
    line = cpu_run()
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    assert line["attempted"] == 2
    assert {c["name"] for c in line["checks"]} == set(
        doc("workloads", CELL)["params"]["limits"])
    assert set(line["metrics"]) == {"steps_per_s", "transient_p90_ms",
                                    "setup_s"}


def test_a_step_that_keeps_its_state_is_not_correct(graph_path, monkeypatch):
    """Every step of the graph's epilogue ends on the initial field."""
    from heatflow_tpu_torch.ops import cuda_step
    epilogue = cuda_step.step_epilogue_reference
    monkeypatch.setattr(cuda_step, "step_epilogue_reference",
                        lambda *a, **k: torch.full_like(epilogue(*a, **k),
                                                        300.0))
    line = cpu_run()
    missing = next(c for c in line["checks"] if c["name"] == "unanswered")
    assert line["correct"] is False and missing["value"] == 2


def test_the_control_fails_the_cells_comparison():
    limits = harness.find_cell(SPEC, CELL)[0]["params"]["limits"]
    for seed in (1, 2, 3):
        got = control.readings(CELL, seed, SMALL)["readings"]
        assert any(v > limits[k] for k, v in got.items() if k in limits), \
            (seed, got, limits)


def _run(units, profile, cols_shape=(1000, 9), overlay=None):
    run = harness.new_run(CELL, 1, 1.0, True)
    ell = types.SimpleNamespace(cols=np.zeros(cols_shape, np.int32))
    mesh = types.SimpleNamespace(grid_overlay=overlay)
    run.problem = types.SimpleNamespace(mesh=mesh, ell=ell)
    run.units, run.profile, run.window_s = units, profile, 1.0
    return run


def _profile(kernels):
    timeline, t = [], 0.0
    for name, us in kernels:
        timeline.append((t, t + us, name))
        t += us + 1.0
    by = {}
    for s0, s1, name in timeline:
        by.setdefault(name, [0.0, 0])
        by[name][0] += s1 - s0
        by[name][1] += 1
    return dict(timeline=timeline, host=[], kernels=by,
                busy_us=chipmath.merged_busy((a, b) for a, b, _ in timeline))


def test_k1_roofline_ell_counts_the_gather():
    """2 ELL solves launched 96 iterations of which the run performed 90
    (its ``cg_iters``), on 1000 rows of 9 slots. By hand, an iteration:
    the values and column ids as stored, 1000 x 9 x (4 + 4) bytes, the
    scaling and x, r and p read and written (7 planes of 4 bytes a row);
    a row 2 x 9 operations for the gather, 4 for the scaling and the
    <p, Ap> term, 8 for the update, <r, r> and the direction. K1's time is
    every kernel but the step's and the library's."""
    n, k = 1000, 9
    prof = _profile([("k_step_prologue(x)", 5.0), ("k_init(x)", 10.0),
                     ("k_ell_dot(x)", 30.0), ("k_update(x)", 20.0),
                     ("void at::native::index_elementwise_kernel<x>()",
                      7.0)])
    unit = dict(iters=np.array([[50], [40]]), forms={"ell": [2, 96]})
    reader = harness.metric_reader("k1_roofline.ell")
    assert reader.__file__.endswith("k1_roofline.ell.py")
    got = reader.read(_run([unit], prof))
    nbytes = 90 * (n * k * 8 + 7 * n * 4)
    ops = 90 * n * (2 * k + 4 + 8)
    bound_ms = max(nbytes / 3.35e12, ops / 67e12) * 1e3
    assert got == pytest.approx(100.0 * bound_ms / (60.0 / 1e3), rel=1e-12)
    # another form, a lattice overlay or no profile: nothing
    assert reader.read(_run([dict(unit, forms={"identity": [2, 96]})],
                            prof)) is None
    assert reader.read(_run([unit], prof, overlay={"shape": (2, 3)})) is None
    assert reader.read(_run([unit], None)) is None

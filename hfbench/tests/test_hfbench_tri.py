"""The cell ``tri_flagship.transient``: its files load and agree with
``BENCHMARK.json``; its family runs the cell's own recipe at a small size
on the CPU (through the one-graph path's plain version, which the CPU's
eager loop does not take) and is judged correct, and not correct with a
planted fault; the control fails its comparison; the readers it adds
(``k1_roofline.tri``, ``stepper.reorder_ms``) on hand-built profiles."""

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
CELL = "tri_flagship.transient"
# the cell at a CPU test's size: the flagship's overrides
SMALL = {"size_scale": 16.0, "draw_set": 2, "recipe": {"solver": "vmem"},
         "trace_units": 1}
# the per-layer metrics whose reading holds unchanged for the cell
READERS = ("k1.iters_per_step", "stepper.idle_between_solves_ms",
           "stepper.prepare_ms", "stepper.idle_in_prepare_ms",
           "stepper.idle_in_graph_ms", "device_idle_pct.transient",
           "k1_roofline.tri", "stepper.reorder_ms")


def doc(kind, name):
    return harness.load_json(os.path.join(ROOT, "hfbench", kind,
                                          f"{name}.json"))


def test_the_cells_files_agree_with_the_benchmark():
    """The flagship's settings, heating and traffic on the triangulation:
    only the mesh, the family and the limits differ."""
    workload, config = harness.find_cell(SPEC, CELL)
    flag = doc("configs", "geballe_with_diamond")
    assert config["mesh"] == {"kind": "triangulation"}
    assert config["config"] == flag["config"]
    assert config["heating_csv"] == flag["heating_csv"]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    entry = next(c for c in SPEC["configs"]
                 if c["name"] == workload["config"])
    assert entry["file"] == "hfbench/configs/geballe_with_diamond_tri.json"
    assert entry["source"] == config["source"] and entry["reduced"] == []
    assert workload["traffic"] == "transient_tri"
    params = dict(workload["params"])
    want = dict(doc("workloads", "flagship.transient")["params"])
    assert set(params.pop("limits")) == set(want.pop("limits"))
    # a traced run profiles 4 transients, not the flagship's 12: with CUPTI
    # kept between sessions a process traces ~3.4e5 kernels on the card,
    # and the session that crosses that faults, the flagship's own graph
    # too; 12 of these transients launch ~5.3e5 (PERF.md, section 7)
    assert params.pop("trace_units") == 4 and want.pop("trace_units") == 12
    assert params == want
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1
    metrics = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name in ("steps_per_s", "transient_p90_ms") + READERS:
        assert CELL in metrics[name]["workloads"], name
    assert CELL not in metrics["k1_roofline"]["workloads"]
    run = harness.new_run(CELL, 0, overrides=SMALL)
    assert run.mesh == "triangulation"
    assert [m["name"] for m in harness.cell_metrics(run)] == [
        "steps_per_s", "transient_p90_ms", "setup_s"]
    run.trace = True
    assert sorted(m["name"] for m in harness.cell_metrics(run)) == sorted(
        [m for m in metrics if m.startswith(READERS) and m != "k1_roofline"]
        + ["setup.device_s", "setup.host_s"])


@pytest.fixture
def graph_path(monkeypatch):
    """The CPU takes the overlay's one-graph path, as a call on the card
    does: its plain version (``cuda_step.run_stepwise`` in place of
    ``cuda_step.run``)."""
    from heatflow_tpu_torch.ops import cuda_step
    from heatflow_tpu_torch.sim import unstructured
    monkeypatch.setattr(unstructured.SimulatorUnstructured, "_run",
                        lambda self, *a: self._run_lattice(*a))
    monkeypatch.setattr(cuda_step, "run", cuda_step.run_stepwise)


def cpu_run(seed=2 ** 31 + 23):
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


def _run(units, profile, shape=(20, 72)):
    run = harness.new_run(CELL, 1, 1.0, True)
    mesh = types.SimpleNamespace(grid_overlay={"shape": shape})
    run.problem = types.SimpleNamespace(mesh=mesh)
    run.units, run.profile, run.window_s = units, profile, 1.0
    return run


def _profile(kernels, host=()):
    timeline, t = [], 0.0
    for name, us in kernels:
        timeline.append((t, t + us, name))
        t += us + 1.0
    by = {}
    for s0, s1, name in timeline:
        by.setdefault(name, [0.0, 0])
        by[name][0] += s1 - s0
        by[name][1] += 1
    return dict(timeline=timeline, host=sorted(host), kernels=by,
                busy_us=chipmath.merged_busy((a, b) for a, b, _ in timeline))


def test_k1_roofline_tri_counts_nine_planes():
    """1 ADI and 2 r-line solves launched 100 and 90 iterations of which
    the run performed 160 (the 30 empty ones shared by solve: 10 ADI, 20
    r-line). By hand, a lattice point of an iteration: 9 operator planes,
    the scaling, x, r and p read and written (6), and two Thomas factor
    planes a line direction; 29 operations for the 9-point stencil and its
    dot (21), the update (6) and the p update (2), and 12 a line
    direction."""
    nz, nr = 20, 72
    pts = nz * nr
    its = np.array([[90], [40], [30]])
    prof = _profile([("k_step_prologue(x)", 5.0), ("k_init(x)", 10.0),
                     ("k_row_update(x)", 30.0),
                     ("void at::native::index_elementwise_kernel<x>()",
                      7.0)])
    unit = dict(iters=its, forms={"adi": [1, 100], "rline": [2, 90]})
    reader = harness.metric_reader("k1_roofline.tri")
    assert reader.__file__.endswith("k1_roofline.tri.py")
    got = reader.read(_run([unit], prof))
    adi, rline = 100 - 10, 90 - 20
    nbytes = (adi * (9 + 1 + 6 + 4) + rline * (9 + 1 + 6 + 2)) * pts * 4
    ops = (adi * (29 + 24) + rline * (29 + 12)) * pts
    bound_ms = max(nbytes / 3.35e12, ops / 67e12) * 1e3
    assert got == pytest.approx(100.0 * bound_ms / (40.0 / 1e3), rel=1e-12)
    # a form without counts, or no overlay lattice: nothing
    odd = dict(unit, forms={"mgz": [1, 100]})
    assert reader.read(_run([odd], prof)) is None
    run = _run([unit], prof)
    run.problem.mesh = types.SimpleNamespace(shape=(nz, nr))
    assert reader.read(run) is None


def test_reorder_reader():
    """The reorder spans merged over the transients; nothing without
    them."""
    host = [(0.0, 100.0, "transient"), (1.0, 3.0, "transient.reorder"),
            (2.0, 4.0, "transient.reorder"), (90.0, 95.0,
                                              "transient.reorder"),
            (10.0, 20.0, "transient.operands")]
    prof = _profile([("k_init(x)", 10.0)], host)
    reader = harness.metric_reader("stepper.reorder_ms")
    assert reader.read(_run([{}, {}], prof)) == pytest.approx(
        (3.0 + 5.0) / 2 / 1e3)
    bare = _profile([("k_init(x)", 10.0)], host[:1] + host[-1:])
    assert reader.read(_run([{}], bare)) is None


def test_the_triangulation_config_names_runs_defaults():
    """The jitter and seed the configuration assumes are the port's
    generator's defaults, which the harness builds."""
    import inspect
    from heatflow_tpu_torch.mesh.unstructured_gen import (
        build_unstructured_mesh)
    assumed = doc("configs", "geballe_with_diamond_tri")["assumed"]
    defaults = inspect.signature(build_unstructured_mesh).parameters
    assert assumed["triangulation_jitter"] == defaults["jitter"].default
    assert assumed["triangulation_seed"] == defaults["seed"].default

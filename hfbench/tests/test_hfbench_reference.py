"""The plain float64 reference against the port's eager float64 path on
the CPU, on small grids of each configuration's materials; and the
control (the reference with its state in bfloat16) failing each cell's
comparison at a small size; the step residual against the stopping rule
that the reference itself ran."""

import json
import os

import numpy as np
import pytest
import torch

from hfbench import control, harness
from hfbench.reference.fem import Reference, bf16_round

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def port_transient(cfg, csv, size_scale, kappa, fwhm):
    from heatflow_tpu_torch import build_layout, build_structured_mesh
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats, size_scale=size_scale)
    problem = build_problem(mesh, HeatingCurve.from_csv(csv), cfg,
                            watcher_points=coupler_watcher_points(cfg))
    fn = make_simulate_fn(problem, dtype=torch.float64, device="cpu",
                          rtol=1e-13, maxiter=100000, precondition="jacobi",
                          record_gradient=True, proj_rtol=1e-14,
                          proj_maxiter=100000)
    kappas = problem.kappas.copy()
    kappas[mesh.material_tags["p_sample"] - 1] = kappa
    return {k: v.numpy() for k, v in fn(kappas, None, fwhm).items()}


def short(cfg, steps):
    t = cfg["timing"]
    return dict(cfg, timing=dict(
        t_final=t["t_final"] * steps / t["num_steps"], num_steps=steps))


@pytest.mark.parametrize("config,size_scale,steps", [
    ("geballe_no_diamond", 4.0, 8), ("geballe_with_diamond", 8.0, 8)])
def test_reference_matches_the_port_in_float64(config, size_scale, steps):
    doc = harness.load_json(os.path.join(ROOT, "hfbench", "configs",
                                         f"{config}.json"))
    csv = os.path.join(ROOT, doc["heating_csv"])
    cfg = short(json.loads(json.dumps(doc["config"])), steps)
    for kappa, fwhm in ((3.8, 1.32e-5), (57.0, 2.5e-6)):
        got = port_transient(cfg, csv, size_scale, kappa, fwhm)
        want = Reference(cfg, csv, size_scale=size_scale).run(
            kappa, fwhm, record=True)
        assert want["watch"].shape == got["watch"].shape
        rel = lambda k: np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert rel("watch") < 1e-9
        assert rel("axis") < 1e-7
        if want["band"].size:
            assert rel("band") < 1e-7


def test_bf16_round():
    x = np.array([300.0, 301.0, 2155.554616, -1.0e-3, 1.0 + 2 ** -9])
    y = bf16_round(x)
    assert y[0] == 300.0 and y[1] in (300.0, 302.0)
    assert abs(y[2] - 2155.554616) <= 8.0 and y[4] == 1.0
    assert np.array_equal(bf16_round(y), y)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_the_control_fails_the_cells_comparison(cell, small):
    """At a small size on the CPU: the control reads past at least one of
    the cell's limits (on the card it is read at the cell's own size)."""
    limits = harness.find_cell(SPEC, cell)[0]["params"]["limits"]
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, small[cell])["readings"]
        assert any(v > limits[k] for k, v in got.items() if k in limits), \
            (seed, got, limits)


def test_step_residual_reads_the_stopping_rule():
    """The reference's own stopping-rule solve, read back step by step:
    every step within its rtol, and a step that returns its state
    unchanged far from it."""
    doc = harness.load_json(os.path.join(ROOT, "hfbench", "configs",
                                         "geballe_no_diamond.json"))
    csv = os.path.join(ROOT, doc["heating_csv"])
    cfg = short(json.loads(json.dumps(doc["config"])), 6)
    ref = Reference(cfg, csv, size_scale=8.0)
    rule = ref.run_rule(12.0, 8e-6, rtol=1e-4)
    states = np.concatenate([np.full((1, rule["states"].shape[1]), ref.ic),
                             rule["states"]])
    res = ref.step_residuals(12.0, 8e-6, range(1, 7), states[:-1],
                             states[1:])
    assert max(res) <= 1e-4 * (1 + 1e-9) and min(res) > 0
    exact = ref.run(12.0, 8e-6)["watch"]
    assert np.abs(rule["watch"] - exact).max() < 50.0
    stale = ref.step_residuals(12.0, 8e-6, [3], states[2:3], states[2:3])
    assert stale[0] > 5e-4


def test_the_state_only_control_fails_the_step_residual(small):
    """sweep.b1024 at a small size: the recipe's own solve with the state
    kept in bfloat16 reads past the step residual's limit."""
    limits = harness.find_cell(SPEC, "sweep.b1024")[0]["params"]["limits"]
    for seed in (1, 2, 3):
        got = control.readings("sweep.b1024", seed,
                               small["sweep.b1024"])["readings"]
        assert got["state_resid"] > limits["step_resid"], (seed, got)

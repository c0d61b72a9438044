"""The port's steady solve and steady driver against the JAX package's, in
float64 on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.drivers import steady as j_cli
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.sim import steady as j_steady
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu.sim.stepper import run_transient as j_run
from heatflow_tpu_torch.drivers import steady as t_cli
from heatflow_tpu_torch.geometry import coupler_watcher_points as t_watch
from heatflow_tpu_torch.sim import steady as t_steady
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from heatflow_tpu_torch.sim.stepper import run_transient as t_run
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

TOL = 1e-9   # float64, relative to the field's range: the same CG recurrence
             # and preconditioners, the sums in another order


@pytest.fixture(scope="module")
def pair():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    pj = j_build_problem(J.build_structured_mesh(*J.build_layout(cfg)),
                         JHeating(time=t, temp=temp), cfg,
                         watcher_points=j_watch(cfg))
    pt = t_build_problem(T.build_structured_mesh(*T.build_layout(cfg)),
                         THeating(time=t, temp=temp), cfg,
                         watcher_points=t_watch(cfg))
    return pj, pt


@pytest.mark.parametrize("kw", [{}, dict(t=2e-7), dict(amplitude=1234.5)],
                         ids=["t0", "t", "amplitude"])
def test_steady_heating_values_exact(pair, kw):
    pj, pt = pair
    np.testing.assert_array_equal(
        t_steady.steady_heating_values(pt, **kw),
        j_steady.steady_heating_values(pj, **kw))


@pytest.mark.parametrize("precondition", ["adi", "rline", "zline", "jacobi"])
@pytest.mark.parametrize("weighted", [False, True], ids=["flat", "weighted"])
@pytest.mark.parametrize("with_f", [False, True], ids=["nof", "f"])
def test_solve_steady_matches_jax(pair, precondition, weighted, with_f):
    pj, pt = pair
    g = t_steady.steady_heating_values(pt, amplitude=1500.0)
    f = None
    if with_f:
        f = np.random.default_rng(8).uniform(0, 1e13, pt.mesh.shape)
    kw = dict(f=f, weighted=weighted, precondition=precondition)
    uj, info_j = j_steady.solve_steady(pj, g, **kw)
    ut, info_t = t_steady.solve_steady(pt, g, **kw, device="cpu")
    assert ut.shape == uj.shape and ut.dtype == np.float64
    assert np.abs(ut - uj).max() <= TOL * (uj.max() - uj.min())
    assert info_t["converged"] and info_j["converged"]
    # the sums run in another order: a stop may move by a few iterations
    assert abs(info_t["iters"] - info_j["iters"]) <= max(2,
                                                        0.02 * info_j["iters"])
    d = pt.dirichlet_mask
    np.testing.assert_array_equal(ut[d], g[d])


def test_steady_field_seeds_a_transient(pair):
    pj, pt = pair
    g = t_steady.steady_heating_values(pt)
    ut, _ = t_steady.solve_steady(pt, g, device="cpu")
    uj, _ = j_steady.solve_steady(pj, g)
    rt = t_run(pt, u0=ut, rtol=1e-12, record_gradient=False, device="cpu")
    rj = j_run(pj, u0=uj, rtol=1e-12, record_gradient=False)
    assert np.abs(rt.watcher - rj.watcher).max() \
        <= 1e-8 * np.abs(rj.watcher).max()
    assert np.isfinite(rt.final_u).all()


def test_solve_steady_checks_and_default_device(pair):
    _, pt = pair
    g = t_steady.steady_heating_values(pt)
    with pytest.raises(ValueError, match="precondition"):
        t_steady.solve_steady(pt, g, precondition="mg", device="cpu")
    if not torch.cuda.is_available():
        # the entry point runs on the card unless the CPU is asked for
        with pytest.raises(RuntimeError, match="(?i)cuda"):
            t_steady.solve_steady(pt, g)


def test_steady_cli_artifacts_match_jax_driver(tmp_path):
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    heat = tmp_path / "heat.csv"
    synthetic_heating(str(heat))
    cfg["heating"]["file"] = str(heat)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    outs = {}
    for name, cli, extra in (("jax", j_cli, []),
                             ("torch", t_cli, ["--device", "cpu"])):
        out = tmp_path / f"out_{name}"
        cli.main(["--config", str(cfg_path), "--mesh-folder",
                  str(tmp_path / f"mesh_{name}"), "--rebuild-mesh",
                  "--output-folder", str(out), "--amplitude", "1500",
                  "--then-transient", *extra])
        outs[name] = out
    for fname in ("used_config.yaml", "steady_field.npy", "steady.xdmf",
                  "steady.h5", "watcher_points.csv"):
        assert (outs["torch"] / fname).is_file(), fname
        assert (outs["jax"] / fname).is_file(), fname
    uj = np.load(outs["jax"] / "steady_field.npy")
    ut = np.load(outs["torch"] / "steady_field.npy")
    assert np.abs(ut - uj).max() <= TOL * (uj.max() - uj.min())
    wj = np.loadtxt(outs["jax"] / "watcher_points.csv", delimiter=",",
                    skiprows=1)
    wt = np.loadtxt(outs["torch"] / "watcher_points.csv", delimiter=",",
                    skiprows=1)
    assert wt.shape == wj.shape
    assert np.abs(wt - wj).max() <= 1e-8 * np.abs(wj).max()
    assert yaml.safe_load((outs["torch"] / "used_config.yaml").read_text()) \
        == yaml.safe_load((outs["jax"] / "used_config.yaml").read_text())


def test_steady_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        t_cli.run_steady(tiny_no_diamond_cfg(coarse=2.0), str(tmp_path),
                         rebuild_mesh=True)

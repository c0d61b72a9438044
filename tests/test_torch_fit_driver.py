"""The port's gradient-based fit against the JAX package, in float64, on
tests/test_fit.py's problem: ``make_sweep_fn(...).one_config`` values and
gradients (the ``cg_tol`` plain version in the r-line and ADI forms, the
eager ``pcg_solve``), the objective, the Gauss-Newton errors,
``fit_parameters``, the solver rule and the fit CLI."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.drivers import fit as jfit
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.sim import sweepkernel as jsw
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu_torch.drivers import fit as tfit
from heatflow_tpu_torch.geometry import coupler_watcher_points as t_watch
from heatflow_tpu_torch.sim import sweepkernel as tsw
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

GRAD_TOL = 1e-8    # one_config values and gradients (float64)
# the fit (objective, errors, Adam) in float64: the RMSE is a small
# difference of normalized traces (0.01 against traces of 1), so the
# traces' ~1e-10 relative solver differences reach it ~100x enlarged, and
# the two packages' Adam round each update differently
FIT_TOL = 1e-6
K_TRUE, FWHM_TRUE = 5.2, 6.5e-6


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def fit_pair():
    """tests/test_fit.py's problem (tiny no-diamond stack, 5 steps) with an
    o-side trace synthesized by the JAX model at (K_TRUE, FWHM_TRUE), built
    by each package."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 5
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    mesh_j = J.build_structured_mesh(*J.build_layout(cfg))
    pj = j_build_problem(mesh_j, JHeating(time=t, temp=temp), cfg,
                         watcher_points=j_watch(cfg))
    fn = jsw.make_sweep_fn(pj, dtype=jnp.float64, rtol=1e-12)
    tr = np.asarray(fn.one_config(K_TRUE, FWHM_TRUE))
    span = tr[:, 0].max() - tr[:, 0].min()
    target = np.interp(t, fn.times, (tr[:, 1] - tr[:, 1][0]) / span)
    oside = pj.ic_temp + target * (temp.max() - temp.min())
    pj = j_build_problem(mesh_j, JHeating(time=t, temp=temp, oside=oside),
                         cfg, watcher_points=j_watch(cfg))
    pt = t_build_problem(T.build_structured_mesh(*T.build_layout(cfg)),
                         THeating(time=t, temp=temp, oside=oside), cfg,
                         watcher_points=t_watch(cfg))
    return pj, pt


ONE_CONFIG = [dict(solver="vmem", precondition="rline"),
              dict(solver="vmem", precondition="adi"),
              dict(solver="xla", precondition="jacobi"),
              dict(solver="xla", precondition="mg")]


@pytest.mark.parametrize("kw", ONE_CONFIG,
                         ids=lambda kw: "-".join(kw.values()))
def test_one_config_values_and_gradients_match_jax(fit_pair, kw):
    """Traces of one config and the gradient of a weighted sum of them in
    (log k, log fwhm): reverse mode here, jax.grad there."""
    pj, pt = fit_pair
    w = np.random.default_rng(3).uniform(0.5, 1.5, (pt.num_steps, 2))
    lk, lf = np.log(3.1), np.log(8.0e-6)
    fj = jsw.make_sweep_fn(pj, dtype=jnp.float64, rtol=1e-11, **kw)
    ft = tsw.make_sweep_fn(pt, dtype=torch.float64, rtol=1e-11, **kw,
                           device="cpu")
    loss_j = lambda p: jnp.sum(jnp.asarray(w) * fj.one_config(
        jnp.exp(p[0]), jnp.exp(p[1])))
    vj, gj = jax.value_and_grad(loss_j)(jnp.asarray([lk, lf]))
    p = torch.tensor([lk, lf], requires_grad=True)
    tr = ft.one_config(torch.exp(p[0]), torch.exp(p[1]))
    vt = torch.sum(torch.tensor(w) * tr)
    vt.backward()
    assert _rel(tr.detach().numpy(), fj.one_config(np.exp(lk), np.exp(lf))) \
        <= GRAD_TOL
    assert abs(float(vt.detach()) - float(vj)) <= GRAD_TOL * abs(float(vj))
    assert _rel(p.grad.numpy(), gj) <= GRAD_TOL


@pytest.mark.parametrize("solver", ["xla", "vmem"])
def test_objective_value_and_gradient_match_jax(fit_pair, solver):
    pj, pt = fit_pair
    oj = jfit.experimental_objective(pj, rtol=1e-12, solver=solver)
    ot = tfit.experimental_objective(pt, rtol=1e-12, solver=solver,
                                     device="cpu")
    vj, gj = jax.value_and_grad(lambda p: oj(p[0], p[1]))(
        jnp.asarray([4.0, 7.0e-6]))
    p = torch.tensor([4.0, 7.0e-6], requires_grad=True)
    vt = ot(p[0], p[1])
    vt.backward()
    vt = float(vt.detach())
    assert abs(vt - float(vj)) <= FIT_TOL * abs(float(vj))
    assert _rel(p.grad.numpy(), gj) <= FIT_TOL
    assert float(ot(K_TRUE, FWHM_TRUE)) < 1e-7


def test_fit_uncertainty_matches_jax(fit_pair):
    """Gauss-Newton errors from the forward-mode Jacobian (one primal, two
    tangents) against the JAX package's linearize + vmap."""
    pj, pt = fit_pair
    oj = jfit.experimental_objective(pj, rtol=1e-11)
    ot = tfit.experimental_objective(pt, rtol=1e-11, device="cpu")
    k, f = 5.0, 6.8e-6
    want = jfit.fit_uncertainty(oj, k, f)
    got = tfit.fit_uncertainty(ot, k, f)
    np.testing.assert_allclose(got, want, rtol=FIT_TOL)


def test_fit_parameters_matches_jax(fit_pair):
    """A short fit: coarse (3, 2), 2 starts, 3 Adam steps. The coarse RMSE
    within 1e-9 of its scale; the Adam history, k, fwhm and rmse within
    1e-6 relative (FIT_TOL): optax's and torch's Adam round their updates
    differently (the same formula in another order), and each step's
    rounding difference moves the next evaluation point."""
    pj, pt = fit_pair
    kw = dict(k_range=(2.0, 15.0), fwhm_range=(3e-6, 1.3e-5), coarse=(3, 2),
              n_starts=2, adam_steps=3, lr=0.08, rtol=1e-11)
    want = jfit.fit_parameters(pj, **kw)
    got = tfit.fit_parameters(pt, **kw, device="cpu")
    assert _rel(got.sweep_rmse, want.sweep_rmse) <= 1e-9
    np.testing.assert_array_equal(got.sweep_k, want.sweep_k)
    assert np.shape(got.history) == np.shape(want.history) == (2, 4)
    np.testing.assert_allclose(got.history, want.history, rtol=FIT_TOL)
    for name in ("k", "fwhm", "rmse", "k_stderr", "fwhm_stderr"):
        assert getattr(got, name) == pytest.approx(getattr(want, name),
                                                   rel=FIT_TOL), name
    assert set(got.timings) == {"coarse_s", "adam_s", "gauss_newton_s"}


def test_resolve_fit_solver_rule():
    """float32 on a CUDA device → the kernels with r-line; float64 or the
    CPU → the eager PCG with Jacobi; a preconditioner the kernels lack
    keeps 'auto' on the eager path; explicit settings pass through."""
    r = tfit.resolve_fit_solver
    assert r(torch.float64, None, None, "auto", None, device="cuda") == \
        (1e-10, "b", "xla", "jacobi")
    assert r(torch.float32, None, None, "auto", None, device="cpu") == \
        (1e-5, "r0", "xla", "jacobi")
    assert r(torch.float32, None, None, "auto", None, device="cuda") == \
        (1e-5, "r0", "vmem", "rline")
    assert r(torch.float32, None, None, "auto", "adi", device="cuda") == \
        (1e-5, "r0", "vmem", "adi")
    for pre in ("mg", "zline"):
        assert r(torch.float32, None, None, "auto", pre,
                 device="cuda")[2] == "xla"
    assert r(torch.float32, 1e-6, "b", "vmem", "adi") == \
        (1e-6, "b", "vmem", "adi")


def test_unstructured_fit_raises():
    with pytest.raises(NotImplementedError, match="P9"):
        tfit.experimental_objective(object(), device="cpu")


def test_fit_cli_prints_best_fit(tmp_path, monkeypatch, capsys):
    """``python -m heatflow_tpu_torch.drivers.fit --device cpu`` on the tiny
    config prints the JAX CLI's BEST FIT lines."""
    from heatflow_tpu_torch.config import save_config
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 4
    heat_csv = tmp_path / "heat.csv"
    synthetic_heating(heat_csv)
    cfg["heating"]["file"] = str(heat_csv)
    save_config(cfg, str(tmp_path / "cfg.yaml"))
    orig = tfit.fit_parameters
    monkeypatch.setattr(tfit, "fit_parameters", lambda problem, **kw: orig(
        problem, **{**kw, "coarse": (3, 2), "n_starts": 1, "adam_steps": 1}))
    res = tfit.main(["--config", str(tmp_path / "cfg.yaml"), "--mesh-folder",
                     str(tmp_path / "mesh"), "--rebuild-mesh", "--k-range",
                     "2", "12", "--fwhm-range", "4e-6", "1e-5", "--device",
                     "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"^BEST FIT: k = ([0-9.]+) W/m/K, FWHM = ([0-9.e+-]+) m, "
                  r"o-side RMSE = ([0-9.]+)$", out, re.M)
    assert m and np.isfinite([float(g) for g in m.groups()]).all(), out
    assert re.search(r"^ {10}k = [0-9.]+ ± [0-9.]+ W/m/K, FWHM = \S+ ± \S+ m "
                     r"\(1σ Gauss-Newton, corr [+-][0-9.]+\)$", out, re.M)
    assert np.isfinite([res.k_stderr, res.fwhm_stderr]).all()

"""The port's split-normal fits (``analysis.splitnormal``: the batched
Levenberg-Marquardt, the minimax polish, the closed-form passes, the
exports and the CLI) against the JAX package's, in float64 on the CPU, on
the profiles of ``tests/test_analysis.py`` made from the same seeds.

Bounds: fitted parameters within rtol 1e-6 (the amplitude of its own size,
the offset of the data's scale, |amplitude| + |offset|, and center and
sigmas of the radial span); RMSE and max error within rtol 1e-8; the
amplitude-only and generalized fits within 1e-10 (the generalized fit's
closed-form stage from the same split-normal fit; end to end it inherits
the split-normal fit's 1e-6)."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch

from heatflow_tpu.analysis import splitnormal as J
from heatflow_tpu.analysis.radial import RadialGradientPlotter as JPlotter
from heatflow_tpu.io.csvio import write_gradient_csv
from heatflow_tpu_torch.analysis import splitnormal as T
from heatflow_tpu_torch.analysis.radial import RadialGradientPlotter as TPlotter
from heatflow_tpu_torch.io.csvio import read_gradient_csv, read_records

torch.set_num_threads(1)

PARAM_RTOL = 1e-6
ERR_RTOL = 1e-8
CLOSED_FORM_TOL = 1e-10
KEYS = ("amplitudes", "centers", "sigma_lefts", "sigma_rights", "offsets")


def params_close(got, want, span, rtol=PARAM_RTOL):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = np.array([abs(want[0]), span, span, span,
                      abs(want[0]) + abs(want[4])])
    return np.all(np.abs(got - want) <= rtol * scale), np.abs(got - want) / scale


def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture
def gradient_csv(tmp_path):
    """tests/test_analysis.py's 20 x 40 noisy profile table."""
    rng = np.random.default_rng(0)
    times = np.linspace(1e-7, 7.5e-6, 20)
    z = np.linspace(-4e-6, 7e-6, 40)
    amp = -2e6 * np.exp(-((times - 2e-6) / 1.5e-6) ** 2)
    rows = amp[:, None] * np.exp(-0.5 * ((z[None, :] + 1e-6) / 8e-7) ** 2) \
        + 100.0 + rng.standard_normal((20, 40)) * 50.0
    p = tmp_path / "radial_gradient.csv"
    write_gradient_csv(str(p), times, z, rows)
    return str(p), times, z, rows


def plotters(path, times, z, rows):
    """Both packages' plotters of one gradient CSV, holding the same numbers:
    the port reads each value back as written; the JAX package's plotter
    (pandas' default float parser, which misreads some 17-digit values by an
    ulp) is given the written arrays, so that both fits see one input."""
    import pandas as pd
    pj, pt = JPlotter(path), TPlotter(path)
    np.testing.assert_array_equal(pt.grid, rows)
    pj.data = pd.DataFrame(np.column_stack([times, rows]),
                           columns=["time", *map(str, z)])
    return pj, pt


def asymmetric_profiles():
    """tests/test_analysis.py's four asymmetric, heavy-tailed profiles,
    where the RMSE and the minimax optima differ."""
    rng = np.random.default_rng(4)
    out = []
    for trial in range(4):
        r = np.linspace(-5e-6, 5e-6, 70)
        true = (2e6 * (1 + trial), 0.3e-6, 0.8e-6, 2.6e-6, 40.0)
        y = J.split_normal_function(r, *true)
        y = y + 2e4 * np.sign(r - 1e-6) * (1 + np.abs(r) / 5e-6) \
            + rng.standard_normal(len(r)) * 5e3
        out.append((r, y))
    return out


def test_model_and_projection_match_jax():
    """The model, its Jacobian and the projection on a batch of parameter
    sets, against the JAX package's on one set at a time: the same
    expressions in the same order, so within the last bit of ``exp`` (XLA's
    and PyTorch's differ by an ulp on some inputs); the projection exact."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    r = np.linspace(-5e-6, 5e-6, 33)
    ps = np.column_stack([rng.uniform(-3e6, 3e6, 6), rng.uniform(-6e-6, 6e-6, 6),
                          rng.uniform(-1e-6, 4e-6, 6), rng.uniform(1e-7, 2e-5, 6),
                          rng.uniform(-100, 100, 6)])
    f_t, J_t = T._model_and_jac(torch.tensor(ps), torch.tensor(r))
    pr_t = T._project(torch.tensor(ps),
                      torch.full((6,), r.min(), dtype=torch.float64),
                      torch.full((6,), r.max(), dtype=torch.float64))
    for i, p in enumerate(ps):
        f_j, J_j = J._model_and_jac(jnp.asarray(p), jnp.asarray(r))
        np.testing.assert_allclose(f_t[i].numpy(), np.asarray(f_j),
                                   rtol=1e-15, atol=0)
        np.testing.assert_allclose(J_t[i].numpy(), np.asarray(J_j),
                                   rtol=1e-15, atol=0)
        np.testing.assert_array_equal(
            pr_t[i].numpy(), np.asarray(J._project(jnp.asarray(p), r.min(),
                                                   r.max())))


@pytest.mark.parametrize("fit_method", ["rmse", "maxerr"])
def test_recovers_parameters_like_jax(fit_method):
    """The noise-free profile of test_analysis.py: both packages recover the
    generating parameters. The residual there is rounding noise (its size is
    ~1e-9 of the data's), so the errors are held within 1e-8 of the data's
    scale rather than of themselves."""
    r = np.linspace(-5e-6, 5e-6, 80)
    true = (-3e6, -1e-6, 1.2e-6, 2.5e-6, 150.0)
    y = J.split_normal_function(r, *true)
    pj, ej = J.fit_split_normal_to_profile(r, y, fit_method=fit_method)
    pt, et = T.fit_split_normal_to_profile(r, y, fit_method=fit_method,
                                           device="cpu")
    ok, d = params_close(pt, pj, np.ptp(r))
    assert ok, d
    assert abs(et - ej) <= ERR_RTOL * np.abs(y).max(), (et, ej)
    np.testing.assert_allclose(pt, true, rtol=1e-3, atol=1e-9)


@pytest.mark.parametrize("fit_method", ["rmse", "maxerr"])
def test_noise_and_nan_masking_like_jax(fit_method):
    rng = np.random.default_rng(1)
    r = np.linspace(-5e-6, 5e-6, 60)
    y = J.split_normal_function(r, 2e6, 0.5e-6, 1e-6, 1.5e-6, -50.0)
    y = y + rng.standard_normal(60) * 1e4
    y[::13] = np.nan
    pj, ej = J.fit_split_normal_to_profile(r, y, fit_method=fit_method)
    pt, et = T.fit_split_normal_to_profile(r, y, fit_method=fit_method,
                                           device="cpu")
    ok, d = params_close(pt, pj, np.ptp(r))
    assert ok, d
    assert rel(et, ej) <= ERR_RTOL, (et, ej)
    assert pt[0] == pytest.approx(2e6, rel=0.05)


def test_too_few_points_like_jax():
    args = (np.array([0.0, 1.0]), np.array([1.0, np.nan]))
    assert T.fit_split_normal_to_profile(*args, device="cpu") \
        == J.fit_split_normal_to_profile(*args) \
        == ([0.0, 0.0, 1.0, 1.0, 0.0], np.inf)
    assert T.fit_split_normal_amplitude_only(*args, [0, 1, 1, 0]) \
        == J.fit_split_normal_amplitude_only(*args, [0, 1, 1, 0])


@pytest.mark.parametrize("trial", range(4))
def test_asymmetric_profiles_rmse_like_jax(trial):
    r, y = asymmetric_profiles()[trial]
    pj, ej = J.fit_split_normal_to_profile(r, y, fit_method="rmse")
    pt, et = T.fit_split_normal_to_profile(r, y, fit_method="rmse",
                                           device="cpu")
    ok, d = params_close(pt, pj, np.ptp(r))
    assert ok, d
    assert rel(et, ej) <= ERR_RTOL, (et, ej)


# The minimax polish end to end: trial 3's two LM solutions (the polish's
# starting points) sit 2.5e-9 apart in their largest relative parameter
# difference (the summation orders of J^T r and J^T J differ between the
# packages; the LM optimum is flat to that level). The polish carries that
# over, times amplitude / max error (~8e6 / 2e4 = 400): its max error
# agrees to 1.21e-8, above ERR_RTOL. Polished from the same starting point
# (test_minimax_polish_from_the_same_start_matches_jax) every trial agrees
# to 4e-14.
MINIMAX_END_TO_END_RTOL = {0: ERR_RTOL, 1: ERR_RTOL, 2: ERR_RTOL, 3: 2e-8}


@pytest.mark.parametrize("trial", range(4))
def test_asymmetric_profiles_maxerr_like_jax(trial):
    r, y = asymmetric_profiles()[trial]
    pj, ej = J.fit_split_normal_to_profile(r, y, fit_method="maxerr")
    pt, et = T.fit_split_normal_to_profile(r, y, fit_method="maxerr",
                                           device="cpu")
    ok, d = params_close(pt, pj, np.ptp(r))
    assert ok, d
    assert rel(et, ej) <= MINIMAX_END_TO_END_RTOL[trial], (et, ej)
    # a true minimax: no worse under max|err| than the RMSE solution
    p_rmse, _ = T.fit_split_normal_to_profile(r, y, device="cpu")
    assert et == pytest.approx(np.abs(y - T.split_normal_function(
        r, *pt)).max(), rel=1e-12)
    assert et <= np.abs(y - T.split_normal_function(r, *p_rmse)).max() \
        * (1 + 1e-9)


def test_minimax_polish_from_the_same_start_matches_jax():
    """Both polishes from the JAX package's LM solutions of the four
    asymmetric profiles (both guesses): the coordinate search alone."""
    import jax.numpy as jnp
    as_t = lambda a: torch.tensor(np.asarray(a, np.float64))
    for r, y in asymmetric_profiles():
        lo, hi = r.min(), r.max()
        for g in J._initial_guesses(r, y):
            p0, _ = J._lm_fit(jnp.asarray(r), jnp.asarray(y), jnp.asarray(g),
                              lo, hi)
            pj, ej = J._minimax_refine(jnp.asarray(r), jnp.asarray(y), p0,
                                       lo, hi)
            pt, et = T._minimax_refine(as_t(r), as_t(y)[None],
                                       as_t(p0)[None], as_t([lo]),
                                       as_t([hi]))
            ok, d = params_close(pt[0].numpy(), pj, hi - lo, rtol=1e-12)
            assert ok, d
            assert rel(float(et[0]), float(ej)) <= 1e-12


# Rows 17-19 of the 20 x 40 table hold noise only: their true amplitudes
# (-99.8, -18.2, -2.9 K/m) are below the noise (50 K/m; R² of the fits 0.07,
# 0.23, 0.06). There the LM's accept/reject test meets ties, err_new equal to
# err_old to the last digit (row 17, second guess, iteration 16; row 18,
# second guess, iteration 30; row 19, first guess, iteration 50), which the
# two packages' summation orders break differently, and 60 iterations end on
# different paths of a flat objective. Measured, port against JAX
# (largest parameter difference as in params_close; error difference):
#   rmse   row 17: 9.3e-6, 4.0e-7; row 18: 1.6e-8, 1.5e-16;
#          row 19: 1.9e-4, 1.7e-6
#   maxerr row 17: 5.8e-6, 4.9e-10; row 18: 0.198, 8.0e-3 (the polish
#          starts from the diverged LM points); row 19: 1.9e-15, 2.4e-16
# These rows are held to what still holds: each package's error is that of
# its own parameters and the two errors are within 1e-2.
NOISE_ROWS = (17, 18, 19)
# Row 11, second guess, in 'maxerr' mode: polished from the same LM point,
# the JAX package's jitted polish ends at max error 136.15289206446982 and
# the port at 136.1603592132843 (5.5e-5 apart, parameters 6.7e-7). The same
# 200 coordinate steps run as JAX operations one at a time also end at
# 136.1603592132843: the gap is XLA's fused arithmetic inside the reference's
# jit, and test_minimax_polish_follows_jax_operations_step_by_step holds the
# port to the step-by-step replay. Here it is held within 1e-4.
MINIMAX_JIT_ROWS = (11,)


def test_minimax_polish_follows_jax_operations_step_by_step(gradient_csv):
    """The polish of row 11's second LM point (MINIMAX_JIT_ROWS), replayed
    as JAX operations one coordinate step at a time (each probe's max error
    by the JAX package's ``_model_and_jac`` and ``_project``): the port takes
    the same probe at each of the 200 steps and ends at the same max error,
    bit for bit."""
    import jax.numpy as jnp
    path, times, z, rows = gradient_csv
    y, r, lo, hi = rows[11], z, z.min(), z.max()
    g = J._initial_guesses(r, y)[1]
    p0 = np.asarray(J._lm_fit(jnp.asarray(r), jnp.asarray(y),
                              jnp.asarray(g), lo, hi)[0])

    def maxerr(p):
        f, _ = J._model_and_jac(p, jnp.asarray(r))
        return float(jnp.max(jnp.abs(jnp.asarray(y) - f)))

    scale = np.abs(y).max() + 1e-30
    step = 0.5 * np.array([abs(p0[0]) + 0.1 * scale, 0.25 * (hi - lo),
                           abs(p0[2]) + 0.05 * (hi - lo),
                           abs(p0[3]) + 0.05 * (hi - lo),
                           abs(p0[4]) + 0.1 * scale])
    offsets = np.asarray(jnp.linspace(-1.0, 1.0, T.MINIMAX_PROBES))
    p = jnp.asarray(p0)
    for it in range(5 * T.MINIMAX_SWEEPS):
        j = it % 5
        cands = [J._project(p.at[j].add(o * step[j]), lo, hi)
                 for o in offsets]
        errs = [maxerr(c) for c in cands]
        k = int(np.argmin(errs))
        if errs[k] < maxerr(p):
            p = cands[k]
        if j == 4:
            step = step * 0.7
    as_t = lambda a: torch.tensor(np.asarray(a, np.float64))
    pt, et = T._minimax_refine(as_t(r), as_t(y)[None], as_t(p0)[None],
                               as_t([lo]), as_t([hi]))
    assert float(et[0]) == maxerr(p) == 136.1603592132843
    np.testing.assert_allclose(pt[0].numpy(), np.asarray(p), rtol=1e-15)
    pj, ej = J._minimax_refine(jnp.asarray(r), jnp.asarray(y),
                               jnp.asarray(p0), lo, hi)
    assert float(ej) == 136.15289206446982      # the jitted polish


@pytest.mark.parametrize("fit_method", ["rmse", "maxerr"])
def test_analyze_series_like_jax(gradient_csv, fit_method):
    """The 20 x 40 noisy table, every timestep and both guesses in one batch
    (the JAX package: one vmapped call)."""
    path, times, z, rows = gradient_csv
    pj, pt = plotters(path, times, z, rows)
    rj = J.analyze_split_normal_fits(pj, fit_method=fit_method)
    rt = T.analyze_split_normal_fits(pt, fit_method=fit_method, device="cpu")
    np.testing.assert_array_equal(rt["time_values"], rj["time_values"])
    span = np.ptp(z)
    for i in range(len(times)):
        p_t = [rt[k][i] for k in KEYS]
        p_j = [rj[k][i] for k in KEYS]
        e_t, e_j = rt["rmse_values"][i], rj["rmse_values"][i]
        if fit_method == "maxerr" and i in MINIMAX_JIT_ROWS:
            assert rel(e_t, e_j) <= 1e-4, (i, e_t, e_j)
            continue
        if i in NOISE_ROWS:
            resid = np.abs(rows[i] - T.split_normal_function(z, *p_t))
            own = resid.max() if fit_method == "maxerr" else np.sqrt(
                np.mean(resid ** 2))
            assert e_t == pytest.approx(own, rel=1e-12), i
            assert rel(e_t, e_j) <= 1e-2, (i, e_t, e_j)
            continue
        ok, d = params_close(p_t, p_j, span)
        assert ok, (i, d)
        assert rel(e_t, e_j) <= ERR_RTOL, (i, e_t, e_j)
        assert rel(rt["r_squared_values"][i],
                   rj["r_squared_values"][i]) <= ERR_RTOL, i


def test_series_maxerr_mode_like_jax(tmp_path):
    """test_analysis.py's whole-series minimax profile: six timesteps of an
    asymmetric profile, each polished no worse than its RMSE fit."""
    r = np.linspace(-4e-6, 4e-6, 50)
    times = np.linspace(1e-7, 1e-6, 6)
    rows = np.stack([
        J.split_normal_function(r, -1e6 * (1 + t * 1e6), 0.2e-6,
                                0.9e-6, 2.0e-6, 30.0)
        + 1.5e4 * np.sign(r) for t in times])
    path = str(tmp_path / "grad.csv")
    write_gradient_csv(path, times, r, rows)
    pj, pt = plotters(path, times, r, rows)
    rj = J.analyze_split_normal_fits(pj, fit_method="maxerr")
    rt = T.analyze_split_normal_fits(pt, fit_method="maxerr", device="cpu")
    rr = T.analyze_split_normal_fits(pt, device="cpu")
    for i in range(len(times)):
        ok, d = params_close([rt[k][i] for k in KEYS],
                             [rj[k][i] for k in KEYS], np.ptp(r))
        assert ok, (i, d)
        me_r = np.abs(rows[i] - T.split_normal_function(
            r, *[rr[k][i] for k in KEYS])).max()
        assert rt["rmse_values"][i] <= me_r * (1 + 1e-9)
    np.testing.assert_allclose(rt["rmse_values"], rj["rmse_values"],
                               rtol=ERR_RTOL)


def test_amplitude_only_and_exports_like_jax(gradient_csv, tmp_path):
    """The amplitude-only pass on the averaged shape, and both fitted-curve
    CSVs (the gradient format run1d reads), against the JAX package's."""
    path, times, z, rows = gradient_csv
    pj, pt = plotters(path, times, z, rows)
    rj = J.analyze_split_normal_fits(pj)
    rt = T.analyze_split_normal_fits(pt, device="cpu")
    shape = [float(np.mean(rt[k])) for k in KEYS[1:]]
    aj = J.analyze_split_normal_fits_amplitude_only(pj, *shape)
    at = T.analyze_split_normal_fits_amplitude_only(pt, *shape)
    np.testing.assert_allclose(at["amplitudes"], aj["amplitudes"],
                               rtol=CLOSED_FORM_TOL)
    np.testing.assert_allclose(at["rmse_values"], aj["rmse_values"],
                               rtol=CLOSED_FORM_TOL)
    for res_t, res_j, name in ((rt, rj, "full"), (at, aj, "amp")):
        ft, fj = tmp_path / f"t_{name}.csv", tmp_path / f"j_{name}.csv"
        T.save_fitted_curves_csv(res_t, pt.radial_positions, str(ft))
        J.save_fitted_curves_csv(res_j, pj.radial_positions, str(fj))
        tt, zt, vt = read_gradient_csv(str(ft))
        tj, zj, vj = read_gradient_csv(str(fj))
        np.testing.assert_array_equal(tt, times)
        np.testing.assert_array_equal(zt, zj)
        assert vt.shape == rows.shape
        tol = CLOSED_FORM_TOL if name == "amp" else PARAM_RTOL
        assert np.abs(vt - vj).max() <= tol * np.abs(vj).max(), name


def test_closed_form_amplitude_exact():
    r = np.linspace(-4e-6, 4e-6, 50)
    shape = (0.0, 1e-6, 2e-6, 10.0)
    y = T.split_normal_function(r, -5e5, *shape[:3], shape[3])
    amp, rmse = T.fit_split_normal_amplitude_only(r, y, list(shape))
    assert amp == pytest.approx(-5e5, rel=1e-10)
    assert (amp, rmse) == J.fit_split_normal_amplitude_only(r, y,
                                                            list(shape))


def test_generalized_fit_like_jax(monkeypatch):
    rng = np.random.default_rng(5)
    r = np.linspace(-5e-6, 5e-6, 64)
    y = J.generalized_gaussian_function(r, 1.5e6, 0.4e-6, 1.1e-6, 2.2e-6,
                                        2.8, 25.0) \
        + rng.standard_normal(64) * 2e3
    pj, ej = J.fit_generalized_gaussian_to_profile(r, y)
    pt, et = T.fit_generalized_gaussian_to_profile(r, y, device="cpu")
    assert pt[4] == pj[4]          # the same exponent of the scan
    ok, d = params_close(pt[:4] + pt[5:], pj[:4] + pj[5:], np.ptp(r))
    assert ok, d
    assert rel(et, ej) <= ERR_RTOL
    np.testing.assert_array_equal(
        T.generalized_gaussian_function(r, *pt),
        J.generalized_gaussian_function(r, *pt))
    # the exponent scan and the closed-form amplitude from the JAX package's
    # own split-normal fit
    split = J.fit_split_normal_to_profile(r, y)
    monkeypatch.setattr(T, "fit_split_normal_to_profile",
                        lambda *a, **k: (list(split[0]), split[1]))
    pt, et = T.fit_generalized_gaussian_to_profile(r, y, device="cpu")
    np.testing.assert_allclose(pt, pj, rtol=CLOSED_FORM_TOL)
    assert rel(et, ej) <= CLOSED_FORM_TOL


def test_fits_default_to_the_card(gradient_csv):
    """Without a device argument the fits run on the card: with no CUDA
    they raise, naming device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    path, times, z, rows = gradient_csv
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.analyze_split_normal_fits(TPlotter(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.fit_split_normal_to_profile(z, rows[5])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.main([path, "--no-show"])


def test_fit_results_csv_and_plots(gradient_csv, tmp_path):
    """save_fit_results' columns and values (written without pandas) and
    the four plots, each saved under Agg."""
    path, times, z, rows = gradient_csv
    pl = TPlotter(path)
    res = T.analyze_split_normal_fits(pl, device="cpu")
    amp = T.analyze_split_normal_fits_amplitude_only(
        pl, *[float(np.mean(res[k])) for k in KEYS[1:]])
    out = tmp_path / "fit_results.csv"
    T.save_fit_results(res, str(out))
    recs = read_records(str(out))
    assert list(recs[0]) == ["time", "amplitude", "center", "sigma_left",
                             "sigma_right", "offset", "rmse", "r_squared"]
    np.testing.assert_array_equal([rec["time"] for rec in recs], times)
    np.testing.assert_array_equal([rec["amplitude"] for rec in recs],
                                  res["amplitudes"])
    pngs = [tmp_path / f"{k}.png" for k in "abcd"]
    T.plot_split_normal_analysis(res, save_path=str(pngs[0]),
                                 show_plot=False)
    T.plot_fit_comparison(pl, res, [0, 5, 10, 500], save_path=str(pngs[1]),
                          show_plot=False)
    T.plot_comparison_raw_vs_amp_only(pl, res, amp, [0, 5, 10],
                                      save_path=str(pngs[2]),
                                      show_plot=False)
    T.plot_residual_analysis(pl, res, save_path=str(pngs[3]),
                             show_plot=False)
    for png in pngs:
        assert png.exists() and png.stat().st_size > 1000, png


def test_splitnormal_cli_writes_every_file(gradient_csv, tmp_path):
    """The reference's command line (every flag of the JAX package's CLI)
    plus --device: every named file written, the fitted CSVs equal to the
    library calls'."""
    path, times, z, rows = gradient_csv
    arts = {k: tmp_path / f"{k}.{ext}" for k, ext in
            (("results", "csv"), ("analysis", "png"), ("comparison", "png"),
             ("compare", "png"), ("full", "csv"), ("amp", "csv"))}
    T.main([path, "--fit-method", "rmse",
            "--save-results", str(arts["results"]),
            "--save-analysis-plot", str(arts["analysis"]),
            "--save-comparison-plot", str(arts["comparison"]),
            "--time-indices", "0", "3", "7",
            "--compare-steps", "0", "10",
            "--save-compare-plot", str(arts["compare"]),
            "--save-fitted-csv-full", str(arts["full"]),
            "--save-fitted-csv-amp", str(arts["amp"]),
            "--no-show", "--device", "cpu"])
    for k, f in arts.items():
        assert f.exists(), k
    res = T.analyze_split_normal_fits(TPlotter(path), device="cpu")
    want = tmp_path / "want.csv"
    T.save_fitted_curves_csv(res, z, str(want))
    assert arts["full"].read_bytes() == want.read_bytes()
    assert len(read_records(str(arts["results"]))) == len(times)
    # the condensed aliases route the CSV to the amplitude-only pass
    alias = tmp_path / "alias.csv"
    T.main([path, "--amplitude-only", "--save-csv", str(alias),
            "--no-show", "--device", "cpu"])
    assert alias.read_bytes() == arts["amp"].read_bytes()

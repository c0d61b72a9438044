"""Split-normal (two-sided Gaussian) fitting of radial-gradient profiles.

Reference: gaussian_fit_analysis.py:24-201 fits, per timestep, the 5-parameter
model (amplitude, center, sigma_left, sigma_right, offset) with
scipy.curve_fit and a ±amplitude initial-guess race; a second pass re-fits
only the amplitude with shape parameters frozen to their time averages; the
fitted curves export to a gradient-format CSV consumed by the corrected 1D
model (ref no_diamond_1d.py:41-54).

The fits run on the device, in float64, as one batch over every
(timestep × initial guess): a damped Gauss-Newton (Levenberg-Marquardt)
solver with analytic Jacobians, a fixed 60 iterations with per-problem
damping, acceptance and best-so-far by ``torch.where`` and a batched 5 × 5
``torch.linalg.solve``; the minimax polish is the same kind of loop with its
16 probes as one more batch dimension. Neither loop reads the device from
the host: the results come back in one transfer at the end. The
amplitude-only pass is linear least squares, solved in closed form on the
host.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from heatflow_tpu_torch.io.csvio import write_gradient_csv, write_rows
from heatflow_tpu_torch.utils import finish_figure, pyplot, resolve_device

__all__ = [
    "split_normal_function",
    "generalized_gaussian_function",
    "fit_split_normal_to_profile",
    "fit_generalized_gaussian_to_profile",
    "fit_split_normal_amplitude_only",
    "analyze_split_normal_fits",
    "analyze_split_normal_fits_amplitude_only",
    "save_fitted_curves_csv",
    "save_fit_results",
    "plot_split_normal_analysis",
    "plot_fit_comparison",
    "plot_comparison_raw_vs_amp_only",
    "plot_residual_analysis",
]

LM_ITERS = 60          # Levenberg-Marquardt iterations, every problem
MINIMAX_SWEEPS = 40    # cycles over the 5 coordinates of the minimax polish
MINIMAX_PROBES = 16    # probes of one coordinate step
FAILED_FIT = [0.0, 0.0, 1.0, 1.0, 0.0]


def split_normal_function(r, amplitude, center, sigma_left, sigma_right,
                          offset=0.0):
    """Two-sided Gaussian: different widths left/right of center
    (ref gaussian_fit_analysis.py:24-52)."""
    r = np.asarray(r)
    sig = np.where(r < center, sigma_left, sigma_right)
    return amplitude * np.exp(-0.5 * ((r - center) / sig) ** 2) + offset


def generalized_gaussian_function(r, amplitude, center, sigma_left,
                                  sigma_right, power, offset=0.0):
    """Split generalized Gaussian: A·exp(-0.5 |(r-c)/σ±|^p) + offset — the
    6-parameter variant behind the reference's generalized_gaussian_fit_*
    artifacts (power = 2 recovers the split normal)."""
    r = np.asarray(r)
    sig = np.where(r < center, sigma_left, sigma_right)
    u = np.abs((r - center) / sig)
    return amplitude * np.exp(-0.5 * u ** power) + offset


def fit_generalized_gaussian_to_profile(radial_positions, gradient_values,
                                        device="cuda"):
    """Fit the 6-parameter generalized Gaussian: split-normal LM fit first
    (on ``device``), then a scalar search over the exponent with amplitude
    re-solved in closed form. Returns ([amp, center, sl, sr, power, offset],
    rmse)."""
    r = np.asarray(radial_positions, float)
    y = np.asarray(gradient_values, float)
    params, _ = fit_split_normal_to_profile(r, y, device=device)
    amp, c, sl, sr, off = params
    valid = np.isfinite(y) & np.isfinite(r)
    rv, yv = r[valid], y[valid]
    best = (params + [2.0], np.inf)
    for p in np.linspace(0.8, 4.0, 33):
        basis = generalized_gaussian_function(rv, 1.0, c, sl, sr, p, 0.0)
        denom = basis @ basis
        a = float(basis @ (yv - off)) / denom if denom > 0 else 0.0
        rmse = float(np.sqrt(np.mean((yv - (a * basis + off)) ** 2)))
        if rmse < best[1]:
            best = ([a, c, sl, sr, float(p), off], rmse)
    return best


# ----------------------------------------------------------------------
# The batched solvers (device tensors, float64)
# ----------------------------------------------------------------------

def _model_and_jac(p: torch.Tensor, r: torch.Tensor):
    """Model values (..., N) and Jacobian (..., N, 5) of parameters p
    (..., 5) at positions r (N,)."""
    amp, c, sl, sr, off = (v.unsqueeze(-1) for v in p.unbind(-1))
    left = r < c
    sig = torch.where(left, sl, sr)
    u = (r - c) / sig
    e = torch.exp(-0.5 * u * u)
    f = amp * e + off
    d_c = amp * e * u / sig
    d_sig = amp * e * u * u / sig
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    d_sl = torch.where(left, d_sig, zero)
    d_sr = torch.where(left, zero, d_sig)
    J = torch.stack([e, d_c, d_sl, d_sr, torch.ones_like(e)], dim=-1)
    return f, J


def _project(p: torch.Tensor, r_lo: torch.Tensor, r_hi: torch.Tensor):
    """Center into [r_lo, r_hi], sigmas into [1e-12, r_hi - r_lo]; r_lo and
    r_hi have p's leading dims (or broadcast to them)."""
    amp, c, sl, sr, off = p.unbind(-1)
    r_range = r_hi - r_lo
    return torch.stack([amp, torch.clamp(c, r_lo, r_hi),
                        torch.clamp(sl, min=1e-12).minimum(r_range),
                        torch.clamp(sr, min=1e-12).minimum(r_range), off],
                       dim=-1)


def _masked(r: torch.Tensor, y: torch.Tensor):
    valid = torch.isfinite(y) & torch.isfinite(r)
    return valid, valid.to(y.dtype), torch.where(valid, y, 0.0)


def _lm_fit(r, y, p0, r_lo, r_hi, iters: int = LM_ITERS):
    """Levenberg-Marquardt on the 5-parameter model for a batch of problems:
    r (N,), y (B, N) with NaNs masked, p0 (B, 5), r_lo / r_hi (B,). Returns
    the best parameters seen (B, 5) and their RMSE over the valid points
    (B,), both on the device."""
    valid, w, y0 = _masked(r, y)
    eye = torch.eye(5, dtype=y.dtype, device=y.device)
    sq = lambda f: (((y0 - f) * w) ** 2).sum(-1)
    p = best_p = p0
    best_err = sq(_model_and_jac(p0, r)[0])
    lam = torch.full(y.shape[:-1], 1e-3, dtype=y.dtype, device=y.device)
    for _ in range(iters):
        f, J = _model_and_jac(p, r)
        res = (y0 - torch.where(valid, f, 0.0)) * w
        g = (J.transpose(-1, -2) @ res.unsqueeze(-1)).squeeze(-1)
        H = (J * w.unsqueeze(-1)).transpose(-1, -2) @ J
        lhs = (H + lam[..., None, None] * torch.diag_embed(
            torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-30 * eye)
        step = torch.linalg.solve(lhs, g)
        p_new = _project(p + step, r_lo, r_hi)
        err_new = sq(_model_and_jac(p_new, r)[0])
        err_old = (res ** 2).sum(-1)
        improved = err_new < err_old
        p = torch.where(improved.unsqueeze(-1), p_new, p)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 2.5),
                          1e-12, 1e12)
        better = err_new < best_err
        best_p = torch.where(better.unsqueeze(-1), p_new, best_p)
        best_err = torch.where(better, err_new, best_err)
    n = torch.clamp(w.sum(-1), min=1.0)
    return best_p, torch.sqrt(best_err / n)


def _minimax_refine(r, y, p0, r_lo, r_hi, sweeps: int = MINIMAX_SWEEPS,
                    probes: int = MINIMAX_PROBES):
    """True minimax polishing: minimize max|y - f(p)| by cyclic coordinate
    search with a shrinking bracket (the batched equivalent of the
    reference's Powell minimize on max_abs_error,
    ref gaussian_fit_analysis.py:91-96), warm-started from the LM solution.
    Shapes as :func:`_lm_fit`; the probes are one more batch dimension.
    Returns (B, 5) parameters and their max error (B,)."""
    valid, w, y0 = _masked(r, y)

    def maxerr(p, yv, vv, wv):
        f, _ = _model_and_jac(p, r)
        return (torch.abs(yv - torch.where(vv, f, 0.0)) * wv).amax(-1)

    data_scale = torch.abs(y0).amax(-1) + 1e-30
    span = r_hi - r_lo
    a0 = torch.abs(p0)
    base = torch.stack([a0[:, 0] + 0.1 * data_scale, 0.25 * span,
                        a0[:, 2] + 0.05 * span, a0[:, 3] + 0.05 * span,
                        a0[:, 4] + 0.1 * data_scale], dim=-1)
    offsets = torch.linspace(-1.0, 1.0, probes, dtype=y.dtype,
                             device=y.device)
    # the probes' views of the data and bounds: (B, probes, ...)
    yp, vp, wp = y0.unsqueeze(1), valid.unsqueeze(1), w.unsqueeze(1)
    lo_p, hi_p = r_lo.unsqueeze(-1), r_hi.unsqueeze(-1)
    onehot = torch.eye(5, dtype=y.dtype, device=y.device)
    p, step = p0, 0.5 * base
    for it in range(5 * sweeps):
        j = it % 5
        move = (offsets[:, None] * step[:, None, j:j + 1]) * onehot[j]
        cand = _project(p.unsqueeze(1) + move, lo_p, hi_p)
        errs = maxerr(cand, yp, vp, wp)
        k = torch.argmin(errs, dim=-1)
        best = cand.gather(1, k[:, None, None].expand(-1, 1, 5)).squeeze(1)
        improved = errs.gather(1, k[:, None]).squeeze(1) < maxerr(p, y0,
                                                                  valid, w)
        p = torch.where(improved.unsqueeze(-1), best, p)
        if j == 4:   # after a full cycle over the 5 coordinates
            step = step * 0.7
    return p, maxerr(p, y0, valid, w)


def _fit_batch(r, rows, guesses, r_lo, r_hi, fit_method, device):
    """Every (row × guess) problem in one batch on ``device``: rows (T, N),
    guesses (T, G, 5), r_lo / r_hi (T,). Returns numpy (T, G, 5) parameters
    and (T, G) errors (RMSE, or the max error for 'maxerr')."""
    if fit_method not in ("rmse", "maxerr"):
        raise ValueError(f"fit_method {fit_method!r}: 'rmse' or 'maxerr'")
    t, g = guesses.shape[:2]
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                     device=device)
    y = as_t(rows).repeat_interleave(g, dim=0)
    lo = as_t(r_lo).repeat_interleave(g)
    hi = as_t(r_hi).repeat_interleave(g)
    r_t = as_t(r)
    p, err = _lm_fit(r_t, y, as_t(guesses).reshape(t * g, 5), lo, hi)
    if fit_method == "maxerr":
        p, err = _minimax_refine(r_t, y, p, lo, hi)
    out = torch.cat([p, err.unsqueeze(-1)], dim=-1).cpu().numpy()
    return out[:, :5].reshape(t, g, 5), out[:, 5].reshape(t, g)


def _initial_guesses(r, y):
    valid = np.isfinite(y) & np.isfinite(r)
    rv, yv = r[valid], y[valid]
    amp_abs = float(np.abs(yv.max() - yv.min()))
    center = float(rv[np.argmax(np.abs(yv))])
    sigma = float(np.std(rv) / 4) if np.std(rv) > 0 else 1e-6
    offset = float(yv.min())
    return [np.array([amp_abs, center, sigma, sigma, offset]),
            np.array([-amp_abs, center, sigma, sigma, offset])]


def fit_split_normal_to_profile(radial_positions, gradient_values,
                                initial_guess=None, fit_method="rmse",
                                device="cuda"):
    """Fit one profile on ``device``; returns (params list, error) — the
    reference's single-profile API (ref :55-103). The ±amplitude guess race
    is kept, both guesses in one batch.

    fit_method='maxerr' performs a true minimax optimization (coordinate-
    search polish of max|err| warm-started from the LM/RMSE solution),
    matching the reference's Powell minimize on max_abs_error (ref :91-96)
    rather than merely re-scoring the RMSE optimum."""
    device = resolve_device(device)
    r = np.asarray(radial_positions, float)
    y = np.asarray(gradient_values, float)
    valid = np.isfinite(y) & np.isfinite(r)
    if valid.sum() < 4:
        return list(FAILED_FIT), np.inf
    guesses = ([np.asarray(initial_guess, float)] if initial_guess is not None
               else _initial_guesses(r, y))
    r_lo, r_hi = float(r[valid].min()), float(r[valid].max())
    ps, errs = _fit_batch(r, y[None], np.stack(guesses)[None], [r_lo],
                          [r_hi], fit_method, device)
    best = (list(FAILED_FIT), np.inf)
    for p, err in zip(ps[0], errs[0]):
        if err < best[1]:
            best = (list(map(float, p)), float(err))
    return best


def fit_split_normal_amplitude_only(radial_positions, gradient_values,
                                    fixed_params):
    """Amplitude-only refit with frozen shape — linear least squares, solved
    in closed form (ref :106-126 uses curve_fit for the same problem)."""
    center, sigma_left, sigma_right, offset = fixed_params
    r = np.asarray(radial_positions, float)
    y = np.asarray(gradient_values, float)
    valid = np.isfinite(y) & np.isfinite(r)
    if valid.sum() < 4:
        return 0.0, np.inf
    rv, yv = r[valid], y[valid]
    basis = split_normal_function(rv, 1.0, center, sigma_left, sigma_right,
                                  0.0)
    denom = float(basis @ basis)
    amp = float(basis @ (yv - offset)) / denom if denom > 0 else 0.0
    rmse = float(np.sqrt(np.mean((yv - (amp * basis + offset)) ** 2)))
    return amp, rmse


def analyze_split_normal_fits(plotter, fit_method="rmse",
                              device="cuda") -> dict:
    """Fit every timestep of ``plotter`` (a :class:`RadialGradientPlotter`)
    on ``device`` (ref :129-176): all timesteps and both initial guesses in
    one batch."""
    device = resolve_device(device)
    times = np.asarray(plotter.time_values, float)
    r = np.asarray(plotter.radial_positions, float)
    grid = np.asarray(plotter.grid, float)

    guesses = np.stack([np.stack(_initial_guesses(r, row)) for row in grid])
    r_lo, r_hi = float(np.nanmin(r)), float(np.nanmax(r))
    ps, errs_all = _fit_batch(r, grid, guesses, np.full(len(grid), r_lo),
                              np.full(len(grid), r_hi), fit_method, device)
    pick = errs_all.argmin(axis=1)
    params = ps[np.arange(len(times)), pick]
    errs = errs_all[np.arange(len(times)), pick]

    r2 = np.empty(len(times))
    for i, row in enumerate(grid):
        valid = np.isfinite(row)
        f = split_normal_function(r[valid], *params[i])
        ss_res = np.sum((row[valid] - f) ** 2)
        ss_tot = np.sum((row[valid] - row[valid].mean()) ** 2)
        r2[i] = 1 - ss_res / ss_tot if ss_tot > 0 else 0.0

    return {
        "time_values": times,
        "amplitudes": params[:, 0], "centers": params[:, 1],
        "sigma_lefts": params[:, 2], "sigma_rights": params[:, 3],
        "offsets": params[:, 4], "rmse_values": errs,
        "r_squared_values": r2,
    }


def analyze_split_normal_fits_amplitude_only(plotter, avg_center,
                                             avg_sigma_left, avg_sigma_right,
                                             avg_offset) -> dict:
    """Amplitude-only pass with frozen averaged shape (ref :179-201)."""
    times = np.asarray(plotter.time_values, float)
    r = np.asarray(plotter.radial_positions, float)
    amps, rmses = [], []
    for row in np.asarray(plotter.grid, float):
        a, e = fit_split_normal_amplitude_only(
            r, row, [avg_center, avg_sigma_left, avg_sigma_right, avg_offset])
        amps.append(a)
        rmses.append(e)
    return {"time_values": times, "amplitudes": np.asarray(amps),
            "center": avg_center, "sigma_left": avg_sigma_left,
            "sigma_right": avg_sigma_right, "offset": avg_offset,
            "rmse_values": np.asarray(rmses)}


def _fitted_rows(results: dict, r) -> np.ndarray:
    """The fitted curve of every timestep, (T, Z): per-timestep shapes (the
    full fit) or the one frozen shape (the amplitude-only pass)."""
    if "centers" in results:
        return np.stack([
            split_normal_function(r, a, c, sl, sr, o)
            for a, c, sl, sr, o in zip(
                results["amplitudes"], results["centers"],
                results["sigma_lefts"], results["sigma_rights"],
                results["offsets"])])
    return np.stack([
        split_normal_function(r, a, results["center"],
                              results["sigma_left"], results["sigma_right"],
                              results["offset"])
        for a in results["amplitudes"]])


def save_fitted_curves_csv(results: dict, radial_positions, path: str):
    """Write fitted curves in the gradient-CSV format so run_1d can consume
    them as a radial_gradient_path (ref :431-440, no_diamond_1d.py:41)."""
    r = np.asarray(radial_positions, float)
    write_gradient_csv(path, results["time_values"], r,
                       _fitted_rows(results, r))


def save_fit_results(results: dict, output_path: str) -> None:
    """Export the per-timestep fit parameters/quality as a CSV
    (ref gaussian_fit_analysis.py:356-379: columns time, amplitude, center,
    sigma_left, sigma_right, offset, rmse, r_squared)."""
    cols = {"time": "time_values", "amplitude": "amplitudes",
            "center": "centers", "sigma_left": "sigma_lefts",
            "sigma_right": "sigma_rights", "offset": "offsets",
            "rmse": "rmse_values", "r_squared": "r_squared_values"}
    write_rows(output_path, list(cols),
               zip(*(np.asarray(results[k], float) for k in cols.values())))
    print(f"Split Normal fit results saved to: {output_path}")


# ----------------------------------------------------------------------
# Plots (matplotlib at first use)
# ----------------------------------------------------------------------

def plot_split_normal_analysis(results, save_path=None, show_plot=True):
    """Parameter-evolution panel (ref :204-428, condensed)."""
    plt = pyplot(show_plot)
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    t = results["time_values"]
    panels = [("amplitudes", "Amplitude (K/m)"),
              ("centers", "Center (m)"), ("sigma_lefts", "σ_left (m)"),
              ("sigma_rights", "σ_right (m)"), ("offsets", "Offset (K/m)"),
              ("rmse_values", "Fit RMSE (K/m)")]
    for ax, (key, label) in zip(axes.ravel(), panels):
        if key in results:
            ax.plot(t, results[key], "o-", ms=3)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel(label)
        ax.grid(alpha=0.3)
    fig.suptitle("Split-normal fit evolution")
    fig.tight_layout()
    finish_figure(fig, save_path, show_plot)
    return fig, axes


def plot_fit_comparison(plotter, results, time_indices, save_path=None,
                        show_plot=True):
    """Fitted curve vs raw data at chosen timesteps — the visual check
    that a fit is trustworthy at a given time
    (ref gaussian_fit_analysis.py:282-353)."""
    plt = pyplot(show_plot)
    r = np.asarray(plotter.radial_positions, float)
    grid = np.asarray(plotter.grid, float)
    fig, ax = plt.subplots(figsize=(12, 8))
    colors = plt.get_cmap("viridis")(np.linspace(0, 1,
                                                 max(len(time_indices), 1)))
    for i, ti in enumerate(time_indices):
        if ti >= len(results["time_values"]):
            continue
        t = results["time_values"][ti]
        ax.plot(r, grid[ti, :], "o", color=colors[i], markersize=4,
                alpha=0.7, label=f"t={t:.2e}s (data)")
        f = split_normal_function(
            r, results["amplitudes"][ti], results["centers"][ti],
            results["sigma_lefts"][ti], results["sigma_rights"][ti],
            results["offsets"][ti])
        ax.plot(r, f, "-", color=colors[i], linewidth=2, alpha=0.8,
                label=(f"t={t:.2e}s (fit, "
                       f"RMSE={results['rmse_values'][ti]:.2e}, "
                       f"R²={results['r_squared_values'][ti]:.3f})"))
    ax.set_xlabel("Radial Position (m)", fontsize=12)
    ax.set_ylabel("Radial Temperature Gradient (K/m)", fontsize=12)
    ax.set_title("Split Normal Fit Comparison at Selected Time Points",
                 fontsize=14, fontweight="bold")
    ax.grid(True, alpha=0.3)
    ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize=10)
    fig.tight_layout()
    finish_figure(fig, save_path, show_plot)
    if save_path:
        print(f"Fit comparison plot saved to: {save_path}")
    return fig, ax


def plot_comparison_raw_vs_amp_only(plotter, raw_results, amp_only_results,
                                    time_indices, save_path=None,
                                    show_plot=True):
    """Data + full fit + amplitude-only fit side by side at chosen
    timesteps (ref gaussian_fit_analysis.py:382-428). ``amp_only_results``
    carries scalar shape parameters (center/sigma_left/sigma_right/offset)
    as produced by :func:`analyze_split_normal_fits_amplitude_only`."""
    plt = pyplot(show_plot)
    r = np.asarray(plotter.radial_positions, float)
    grid = np.asarray(plotter.grid, float)
    fig, ax = plt.subplots(figsize=(12, 8))
    colors = plt.get_cmap("tab10")(np.linspace(0, 1,
                                               max(len(time_indices), 1)))
    for i, ti in enumerate(time_indices):
        if ti >= len(raw_results["time_values"]):
            continue
        t = raw_results["time_values"][ti]
        ax.scatter(r, grid[ti, :], color=colors[i], s=18, alpha=0.6,
                   label=f"t={t:.2e}s (data)")
        f_raw = split_normal_function(
            r, raw_results["amplitudes"][ti], raw_results["centers"][ti],
            raw_results["sigma_lefts"][ti], raw_results["sigma_rights"][ti],
            raw_results["offsets"][ti])
        ax.plot(r, f_raw, color=colors[i], linestyle="-", linewidth=2,
                alpha=0.8, label=(f"t={t:.2e}s (raw, "
                                  f"RMSE={raw_results['rmse_values'][ti]:.1e})"))
        f_amp = split_normal_function(
            r, amp_only_results["amplitudes"][ti],
            amp_only_results["center"], amp_only_results["sigma_left"],
            amp_only_results["sigma_right"], amp_only_results["offset"])
        ax.plot(r, f_amp, color=colors[i], linestyle="--", linewidth=2,
                alpha=0.8,
                label=(f"t={t:.2e}s (amp-only, "
                       f"RMSE={amp_only_results['rmse_values'][ti]:.1e})"))
    ax.set_xlabel("Radial Position (m)", fontsize=12)
    ax.set_ylabel("Radial Temperature Gradient (K/m)", fontsize=12)
    ax.set_title("Raw vs Amplitude-Only Split Normal Fit Comparison",
                 fontsize=14, fontweight="bold")
    ax.grid(True, alpha=0.3)
    ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left", fontsize=10)
    fig.tight_layout()
    finish_figure(fig, save_path, show_plot)
    if save_path:
        print(f"Raw vs amplitude-only comparison plot saved to: {save_path}")
    return fig, ax


def plot_residual_analysis(plotter, results, save_path=None, show_plot=True):
    plt = pyplot(show_plot)
    r = np.asarray(plotter.radial_positions, float)
    resid = np.asarray(plotter.grid, float) - _fitted_rows(results, r)
    fig, ax = plt.subplots(figsize=(10, 6))
    vmax = np.abs(resid).max()
    im = ax.pcolormesh(r, results["time_values"], resid, cmap="RdBu_r",
                       vmin=-vmax, vmax=vmax, shading="nearest")
    fig.colorbar(im, ax=ax, label="Residual (K/m)")
    ax.set_xlabel("Radial Position (m)")
    ax.set_ylabel("Time (s)")
    ax.set_title("Split-normal fit residuals")
    finish_figure(fig, save_path, show_plot)
    return fig, ax


def main(argv=None):
    """CLI with the reference's full flag surface
    (ref gaussian_fit_analysis.py:481-625), the JAX package's condensed
    aliases, and ``--device`` (default: the card). The flow matches the
    reference: full per-timestep fit → summary stats → amplitude-only pass
    with time-averaged shape → analysis / comparison / raw-vs-amp plots →
    optional results + fitted-curve CSV exports."""
    from heatflow_tpu_torch.analysis.radial import RadialGradientPlotter
    p = argparse.ArgumentParser(
        description="Gaussian fitting analysis for radial gradient data")
    p.add_argument("data_path", type=str)
    p.add_argument("--fit-method", choices=["rmse", "maxerr"],
                   default="rmse")
    p.add_argument("--save-results", type=str, default=None,
                   help="Path to save fitting results CSV")
    p.add_argument("--save-analysis-plot", type=str, default=None)
    p.add_argument("--save-comparison-plot", type=str, default=None,
                   help="Path to save fit comparison plot")
    p.add_argument("--time-indices", type=int, nargs="+",
                   default=[0, 10, 20, 30],
                   help="Time indices for comparison plot")
    p.add_argument("--compare-steps", type=int, nargs="+", default=None,
                   help="Time indices for raw vs amplitude-only comparison "
                        "plot (default: every 5th step)")
    p.add_argument("--save-compare-plot", type=str, default=None,
                   help="Path to save raw vs amplitude-only comparison plot")
    p.add_argument("--save-fitted-csv-full", type=str, default=None,
                   help="full-parameter fitted curves (gradient CSV format)")
    p.add_argument("--save-fitted-csv-amp", type=str, default=None,
                   help="amplitude-only fitted curves (gradient CSV format)")
    p.add_argument("--no-show", action="store_true")
    p.add_argument("--amplitude-only", action="store_true",
                   help="alias: route --save-csv to the amplitude-only pass")
    p.add_argument("--save-csv", type=str, default=None,
                   help="alias for --save-fitted-csv-full "
                        "(--save-fitted-csv-amp with --amplitude-only)")
    p.add_argument("--save-plots", type=str, default=None,
                   help="alias for --save-analysis-plot")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the fits (default cuda; 'cpu' to run "
                        "without a card)")
    args = p.parse_args(argv)
    show = not args.no_show

    plotter = RadialGradientPlotter(args.data_path)
    results = analyze_split_normal_fits(plotter, fit_method=args.fit_method,
                                        device=args.device)

    print("\nSplit Normal Fitting Summary:")
    print(f"  Average RMSE: {np.mean(results['rmse_values']):.2e} K/m")
    print(f"  Average R²: {np.mean(results['r_squared_values']):.3f}")
    t_best = results["time_values"][np.argmax(results["r_squared_values"])]
    t_worst = results["time_values"][np.argmin(results["r_squared_values"])]
    print(f"  Best fit time: t={t_best:.2e}s")
    print(f"  Worst fit time: t={t_worst:.2e}s")
    print("Total RMSE summed across all time steps: "
          f"{np.sum(results['rmse_values']):.2e} K/m")

    avg_center = float(np.mean(results["centers"]))
    avg_sl = float(np.mean(results["sigma_lefts"]))
    avg_sr = float(np.mean(results["sigma_rights"]))
    avg_off = float(np.mean(results["offsets"]))
    print("\nAveraged parameters (excluding amplitude):")
    print(f"  center: {avg_center:.3e}, sigma_left: {avg_sl:.3e}, "
          f"sigma_right: {avg_sr:.3e}, offset: {avg_off:.3e}")
    amp_only = analyze_split_normal_fits_amplitude_only(
        plotter, avg_center, avg_sl, avg_sr, avg_off)
    print("Total RMSE (amplitude-only fit): "
          f"{np.sum(amp_only['rmse_values']):.2e} K/m")

    analysis_path = args.save_analysis_plot or args.save_plots
    if analysis_path or show:
        plot_split_normal_analysis(results, save_path=analysis_path,
                                   show_plot=show)
    if args.save_comparison_plot or show:
        plot_fit_comparison(plotter, results, args.time_indices,
                            save_path=args.save_comparison_plot,
                            show_plot=show)
    compare_idx = (args.compare_steps if args.compare_steps
                   else list(range(0, len(results["time_values"]), 5)))
    if args.save_compare_plot or show:
        plot_comparison_raw_vs_amp_only(plotter, results, amp_only,
                                        compare_idx,
                                        save_path=args.save_compare_plot,
                                        show_plot=show)
    if args.save_results:
        save_fit_results(results, args.save_results)
    csv_full = args.save_fitted_csv_full or (
        None if args.amplitude_only else args.save_csv)
    csv_amp = args.save_fitted_csv_amp or (
        args.save_csv if args.amplitude_only else None)
    if csv_full:
        save_fitted_curves_csv(results, plotter.radial_positions, csv_full)
        print(f"Saved fitted curves to: {csv_full}")
    if csv_amp:
        save_fitted_curves_csv(amp_only, plotter.radial_positions, csv_amp)
        print(f"Saved fitted curves to: {csv_amp}")


if __name__ == "__main__":
    main()

"""Sweep post-processing: per-run RMSE vs experiment and RMSE surfaces.

Covers the reference's sweep_test.py rmse_summary.csv output (:109-113) and
the plotting.ipynb workflow of mapping the o-side RMSE over the (FWHM, κ)
grid from a sweep output directory. Without pandas: the run records are
dicts (``io.csvio.read_records``), the traces dicts of columns.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from heatflow_tpu_torch.analysis.compare import (calculate_rmse,
                                                 normalized_traces)
from heatflow_tpu_torch.io.csvio import (read_records, read_watcher_csv,
                                         write_records)
from heatflow_tpu_torch.utils import finish_figure, pyplot


def score_sweep_outputs(output_dir: str, exp_csv: str, ic_temp: float = 300.0
                        ) -> list[dict]:
    """The normalized o-side RMSE of every successful run in a sweep output
    directory: the run records of ``successful_runs.csv``, each with an
    ``rmse`` (NaN where the run's ``watcher_points.csv`` is missing); also
    written to ``rmse_summary.csv`` next to the runs."""
    runs = read_records(os.path.join(output_dir, "successful_runs.csv"))
    exp = read_watcher_csv(exp_csv)
    rows = []
    for rec in runs:
        watcher = os.path.join(rec["output_dir"], "watcher_points.csv")
        if not os.path.isfile(watcher):
            rows.append({**rec, "rmse": np.nan})
            continue
        sim = read_watcher_csv(watcher)
        tr = normalized_traces(sim, exp, ic_temp)
        rows.append({**rec, "rmse": calculate_rmse(
            exp["time"], tr["exp_oside"], sim["time"], tr["sim_oside"])})
    write_records(os.path.join(output_dir, "rmse_summary.csv"), rows)
    return rows


def _column(records, key) -> np.ndarray:
    return np.array([rec[key] for rec in records], dtype=np.float64)


def plot_rmse_surface(summary: list[dict], *, width: float | None = None,
                      save_path: str | None = None, show_plot: bool = True):
    """Heatmap of RMSE over the (FWHM, κ) plane for one width group: the
    mean RMSE of each (κ, FWHM) cell, NaN RMSEs left out (as a pandas
    ``pivot_table``)."""
    plt = pyplot(show_plot)
    recs = summary
    if width is not None:
        recs = [rec for rec in recs if np.isclose(rec["width"], width)]
    k, fwhm, rmse = (_column(recs, key) for key in ("k", "fwhm", "rmse"))
    ok = ~np.isnan(rmse)
    ks, fs = np.unique(k[ok]), np.unique(fwhm[ok])
    ik, jf = np.searchsorted(ks, k[ok]), np.searchsorted(fs, fwhm[ok])
    total = np.zeros((len(ks), len(fs)))
    count = np.zeros((len(ks), len(fs)))
    np.add.at(total, (ik, jf), rmse[ok])
    np.add.at(count, (ik, jf), 1)
    with np.errstate(invalid="ignore"):
        piv = total / count
    fig, ax = plt.subplots(figsize=(9, 6))
    im = ax.pcolormesh(fs, ks, piv, shading="nearest", cmap="viridis")
    fig.colorbar(im, ax=ax, label="normalized o-side RMSE")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("Laser FWHM (m)")
    ax.set_ylabel("Sample conductivity κ (W/m/K)")
    best = recs[int(np.nanargmin(rmse))]
    ax.plot(best["fwhm"], best["k"], "r*", ms=16,
            label=f"best: k={best['k']:.2f}, rmse={best['rmse']:.4f}")
    ax.legend()
    ax.set_title("Sweep RMSE surface"
                 + (f" (width {width:.2e} m)" if width is not None else ""))
    finish_figure(fig, save_path, show_plot)
    return fig, ax


def main(argv=None):
    p = argparse.ArgumentParser(description="Score + plot sweep results")
    p.add_argument("output_dir")
    p.add_argument("--exp-csv", required=True)
    p.add_argument("--ic-temp", type=float, default=300.0)
    p.add_argument("--save", default=None)
    p.add_argument("--no-show", action="store_true")
    args = p.parse_args(argv)
    summary = score_sweep_outputs(args.output_dir, args.exp_csv,
                                  args.ic_temp)
    ok = [rec for rec in summary if not np.isnan(rec["rmse"])]
    best = min(ok, key=lambda rec: rec["rmse"])
    print(f"Lowest RMSE: {best['rmse']:.6f} at k = {best['k']:.2f}, "
          f"fwhm = {best['fwhm']:.3e}, width = {best['width']:.3e}")
    for w in np.unique(_column(ok, "width")):
        sp = None
        if args.save:
            root, ext = os.path.splitext(args.save)
            sp = f"{root}_w{w:.2e}{ext}"
        plot_rmse_surface(ok, width=w, save_path=sp,
                          show_plot=not args.no_show)


if __name__ == "__main__":
    main()

"""Gradient-data diagnostics (ref check_gradient_data.py:11-172).

Note: the reference's source-term check uses a factor of 3 (check_gradient_
data.py:81,89) while the production 1D loop uses 2 (run_no_diamond_1d.py:743).
This module uses the production factor 2 consistently.
"""

from __future__ import annotations

import argparse

import numpy as np

from heatflow_tpu_torch.io.csvio import read_gradient_csv
from heatflow_tpu_torch.sim.reduced1d import DELTA_R_SMOOTHED
from heatflow_tpu_torch.utils import finish_figure, pyplot


def analyze_gradient_data(path: str) -> dict:
    times, z, vals = read_gradient_csv(path)
    nz = np.count_nonzero(vals)
    return {
        "num_timesteps": len(times),
        "num_positions": len(z),
        "time_range": (float(times.min()), float(times.max())),
        "z_range": (float(z.min()), float(z.max())),
        "min": float(vals.min()), "max": float(vals.max()),
        "mean": float(vals.mean()), "std": float(vals.std()),
        "nonzero_fraction": nz / vals.size,
        "max_abs": float(np.abs(vals).max()),
    }


def test_source_term_magnitude(path: str, kappa: float = 3.8,
                               delta_r: float = DELTA_R_SMOOTHED) -> dict:
    """Magnitude of the radial source S = 2 κ (∂T/∂r)/Δr over the table.
    (The name is the JAX package's; it is not a test: import it under
    another name where pytest collects.)"""
    _times, _z, vals = read_gradient_csv(path)
    S = 2.0 * kappa * vals / delta_r
    return {"max_abs_source": float(np.abs(S).max()),
            "mean_abs_source": float(np.abs(S).mean()),
            "fraction_significant": float(np.mean(np.abs(S) > 1e-6))}


def plot_max_gradient_evolution(path: str, save_path=None, show_plot=True):
    plt = pyplot(show_plot)
    times, _z, vals = read_gradient_csv(path)
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(times, np.abs(vals).max(axis=1), "o-")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("max |∂T/∂r| (K/m)")
    ax.grid(alpha=0.3)
    finish_figure(fig, save_path, show_plot)
    return fig, ax


def main(argv=None):
    p = argparse.ArgumentParser(description="Gradient data diagnostics")
    p.add_argument("data_path", type=str)
    p.add_argument("--kappa", type=float, default=3.8)
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)
    print("Gradient stats:")
    for k, v in analyze_gradient_data(args.data_path).items():
        print(f"  {k}: {v}")
    print("Source-term check:")
    for k, v in test_source_term_magnitude(args.data_path,
                                           kappa=args.kappa).items():
        print(f"  {k}: {v}")
    if args.plot:
        plot_max_gradient_evolution(args.data_path)


if __name__ == "__main__":
    main()

"""Radial-gradient CSV loading, plotting and summaries
(ref plot_radial_gradient.py:22-287), without pandas: the table is read by
``io.csvio.read_gradient_csv`` and kept as arrays."""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from heatflow_tpu_torch.io.csvio import read_gradient_csv
from heatflow_tpu_torch.utils import finish_figure, pyplot


class RadialGradientPlotter:
    """A radial_gradient CSV (time index, z-position columns) and plots of
    its evolution; the JAX package's class with arrays in place of its
    DataFrame: ``time_values`` (T,), ``radial_positions`` (Z,), ``grid``
    (T, Z), ``max_gradient`` and ``min_gradient``."""

    def __init__(self, data_path: str):
        self.data_path = Path(data_path)
        self.time_values: np.ndarray | None = None
        self.radial_positions: np.ndarray | None = None
        self.grid: np.ndarray | None = None
        self.max_gradient: float | None = None
        self.min_gradient: float | None = None
        self.load_data()

    def load_data(self) -> None:
        times, z, grid = read_gradient_csv(str(self.data_path))
        if grid.size == 0:
            raise ValueError("Data file is empty or could not be read")
        self.time_values, self.radial_positions, self.grid = times, z, grid
        self.max_gradient = float(np.max(grid))
        self.min_gradient = float(np.min(grid))

    # ------------------------------------------------------------------
    def plot_gradient_evolution(self, time_indices=None, figsize=(12, 8),
                                save_path=None, show_plot=True):
        plt = pyplot(show_plot)
        if time_indices is None:
            time_indices = range(len(self.time_values))
        time_indices = list(time_indices)
        fig, ax = plt.subplots(figsize=figsize)
        for i in time_indices:
            if i < len(self.time_values):
                ax.plot(self.radial_positions, self.grid[i, :],
                        label=f"t = {self.time_values[i]:.2e} s",
                        linewidth=1.5, alpha=0.8)
        ax.set_xlabel("Radial Position (m)", fontsize=12)
        ax.set_ylabel("Radial Temperature Gradient (K/m)", fontsize=12)
        ax.set_title("Radial Gradient Evolution", fontsize=14)
        ax.grid(True, alpha=0.3)
        if len(time_indices) <= 12:
            ax.legend(fontsize=9)
        finish_figure(fig, save_path, show_plot)
        return fig, ax

    def plot_heatmap(self, figsize=(12, 8), save_path=None, show_plot=True,
                     cmap="RdBu_r"):
        plt = pyplot(show_plot)
        fig, ax = plt.subplots(figsize=figsize)
        vmax = max(abs(self.min_gradient), abs(self.max_gradient))
        im = ax.pcolormesh(self.radial_positions, self.time_values,
                           self.grid, cmap=cmap, vmin=-vmax, vmax=vmax,
                           shading="nearest")
        fig.colorbar(im, ax=ax, label="∂T/∂r (K/m)")
        ax.set_xlabel("Radial Position (m)", fontsize=12)
        ax.set_ylabel("Time (s)", fontsize=12)
        ax.set_title("Radial Gradient (r, t) Heatmap", fontsize=14)
        finish_figure(fig, save_path, show_plot)
        return fig, ax

    def get_data_summary(self) -> dict:
        grid = self.grid
        peak = np.unravel_index(np.argmax(np.abs(grid)), grid.shape)
        return {
            "time_range": (float(self.time_values[0]),
                           float(self.time_values[-1])),
            "radial_range": (float(self.radial_positions[0]),
                             float(self.radial_positions[-1])),
            "gradient_range": (self.min_gradient, self.max_gradient),
            "num_time_points": len(self.time_values),
            "num_radial_points": len(self.radial_positions),
            "peak_time": float(self.time_values[peak[0]]),
            "peak_position": float(self.radial_positions[peak[1]]),
            "peak_gradient": float(grid[peak]),
        }


def heatmap_path(save: str) -> str:
    """Where ``--save`` puts the heatmap of ``--plot-type both``: the
    evolution plot's path with a ``_heatmap`` suffix."""
    root, ext = os.path.splitext(save)
    return f"{root}_heatmap{ext or '.png'}"


def main(argv=None):
    """CLI with the reference's full flag surface
    (ref plot_radial_gradient.py:236-251: --plot-type evolution|heatmap|both,
    --time-indices, --save-evolution/--save-heatmap, --figsize, --no-show)
    plus the condensed aliases of the JAX package's CLI. With
    ``--plot-type both``, ``--save PATH`` names both files: the evolution
    plot at PATH, the heatmap at PATH with a ``_heatmap`` suffix (the JAX
    package's CLI drops the heatmap there)."""
    p = argparse.ArgumentParser(
        description="Plot radial gradient data from parameter sweep")
    p.add_argument("data_path", type=str)
    p.add_argument("--plot-type", type=str,
                   choices=["evolution", "heatmap", "both"],
                   default=None, help="Type of plot to generate")
    p.add_argument("--time-indices", type=int, nargs="+", default=None,
                   help="Specific time indices to plot (evolution plot)")
    p.add_argument("--save-evolution", type=str, default=None)
    p.add_argument("--save-heatmap", type=str, default=None)
    p.add_argument("--figsize", type=float, nargs=2, default=[12, 8],
                   help="Figure size (width height)")
    p.add_argument("--no-show", action="store_true")
    p.add_argument("--heatmap", action="store_true",
                   help="alias for --plot-type heatmap")
    p.add_argument("--save", type=str, default=None,
                   help="save path for the selected plot (with --plot-type "
                        "both: the evolution plot; the heatmap gets a "
                        "_heatmap suffix)")
    p.add_argument("--summary", action="store_true",
                   help="(summary is always printed, as in the reference)")
    args = p.parse_args(argv)

    plot_type = args.plot_type or ("heatmap" if args.heatmap else "evolution")
    figsize = tuple(args.figsize)
    plotter = RadialGradientPlotter(args.data_path)
    print("\nData Summary:")
    for k, v in plotter.get_data_summary().items():
        print(f"  {k}: {v}")
    if plot_type in ("evolution", "both"):
        plotter.plot_gradient_evolution(
            time_indices=args.time_indices, figsize=figsize,
            save_path=args.save_evolution or args.save,
            show_plot=not args.no_show)
    if plot_type in ("heatmap", "both"):
        save = args.save
        if save and plot_type == "both":
            save = heatmap_path(save)
        plotter.plot_heatmap(figsize=figsize,
                             save_path=args.save_heatmap or save,
                             show_plot=not args.no_show)


if __name__ == "__main__":
    main()

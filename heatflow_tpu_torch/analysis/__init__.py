"""Simulation-vs-experiment analysis (numpy). The radial-gradient plots,
split-normal fits and the viewer are not ported yet (ROADMAP P10)."""

from heatflow_tpu_torch.analysis.compare import (calculate_rmse,
                                                 normalized_traces,
                                                 plot_temperature_curves)

__all__ = [
    "calculate_rmse",
    "normalized_traces",
    "plot_temperature_curves",
]

"""Analysis: simulation-vs-experiment comparison, the radial-gradient
plotter and the split-normal fits (on the device); the gradient
diagnostics, the Konopkova converter, the sweep RMSE surface and the viewer
are modules of this package. matplotlib is imported at first use."""

from heatflow_tpu_torch.analysis.compare import (calculate_rmse,
                                                 normalized_traces,
                                                 plot_temperature_curves)
from heatflow_tpu_torch.analysis.radial import RadialGradientPlotter
from heatflow_tpu_torch.analysis.splitnormal import (
    analyze_split_normal_fits, fit_split_normal_to_profile,
    split_normal_function)

__all__ = [
    "calculate_rmse",
    "normalized_traces",
    "plot_temperature_curves",
    "RadialGradientPlotter",
    "split_normal_function",
    "fit_split_normal_to_profile",
    "analyze_split_normal_fits",
]

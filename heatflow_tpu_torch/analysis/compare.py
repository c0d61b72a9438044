"""Simulation-vs-experiment comparison (ref analysis_utils.py:6-93 and the
normalization math of no_diamond.py:65-75 / sweep_test.py:80-86), numpy
only (matplotlib at first use, for the plot). The traces are dicts of
columns, as ``io.read_watcher_csv`` returns them (or anything indexable by
column name)."""

from __future__ import annotations

import numpy as np

from heatflow_tpu_torch.utils import pyplot


def calculate_rmse(exp_time, exp_data, sim_time, sim_data) -> float:
    """RMSE of the simulation interpolated onto the experimental time points
    (ref analysis_utils.py:66-93)."""
    sim_at_exp = np.interp(np.asarray(exp_time), np.asarray(sim_time),
                           np.asarray(sim_data))
    return float(np.sqrt(np.mean((sim_at_exp - np.asarray(exp_data)) ** 2)))


def normalized_traces(df_sim, df_exp, ic_temp: float) -> dict:
    """The normalization every experiment-fit entry script uses (ref
    no_diamond.py:64-75):

      * sim p-side and o-side both normalized by the *p-side* span;
      * experimental p-side normalized by its own span;
      * experimental o-side shifted to start at ic_temp, then normalized by
        the experimental p-side span.

    ``df_sim`` has 'pside' and 'oside' columns, ``df_exp`` 'temp' and
    'oside'. Returns a dict with sim_pside, sim_oside, exp_pside, exp_oside
    arrays."""
    sim_p = np.asarray(df_sim["pside"], float)
    sim_o = np.asarray(df_sim["oside"], float)
    exp_T = np.asarray(df_exp["temp"], float)
    exp_o = np.asarray(df_exp["oside"], float)

    p_span = sim_p.max() - sim_p.min()
    exp_span = exp_T.max() - exp_T.min()
    shifted = exp_o - exp_o[0] + ic_temp
    return {
        "sim_pside": (sim_p - sim_p[0]) / p_span,
        "sim_oside": (sim_o - sim_o[0]) / p_span,
        "exp_pside": (exp_T - exp_T[0]) / exp_span,
        "exp_oside": (shifted - shifted[0]) / exp_span,
    }


def plot_temperature_curves(sim_time, sim_pside, sim_oside, exp_pside,
                            exp_oside, exp_time=None, save_path=None,
                            show_plot=True):
    """Same plot contract as ref analysis_utils.py:6-63."""
    plt = pyplot(show_plot)

    plt.figure(figsize=(12, 8))
    plt.plot(sim_time, sim_pside, "b-", linewidth=2, label="Sim P-side")
    plt.plot(sim_time, sim_oside, "r-", linewidth=2, label="Sim O-side")
    t = exp_time if exp_time is not None else np.arange(len(exp_pside))
    plt.scatter(t, exp_pside, color="blue", marker="o", s=40,
                label="Exp P-side")
    plt.scatter(t, exp_oside, color="red", marker="o", s=40,
                label="Exp O-side")
    plt.xlabel("Time (s)", fontsize=12)
    plt.ylabel("Temperature (K)", fontsize=12)
    plt.title("Temperature: Simulation vs Experiment", fontsize=14,
              fontweight="bold")
    plt.grid(True, alpha=0.3)
    plt.legend(fontsize=11)
    plt.tight_layout()
    if save_path:
        plt.savefig(save_path, dpi=300, bbox_inches="tight")
    if show_plot:
        plt.show()
    else:
        plt.close()

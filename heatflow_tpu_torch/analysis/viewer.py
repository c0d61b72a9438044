"""Interactive radial-gradient viewer: matplotlib slider/buttons stepping
through timesteps (ref smooth_radial_flux.py:9-87).

The figure is built by :func:`build_viewer` (under Agg unless it is to be
shown, so it can be built without a display); :func:`launch_viewer` shows
it. The y-limits pad the data's range by 5 % of its span on each side (the
JAX package's viewer scales both limits by 1.05, which cuts off the low end
of data that is positive throughout).
"""

from __future__ import annotations

import argparse

import numpy as np

from heatflow_tpu_torch.io.csvio import read_gradient_csv
from heatflow_tpu_torch.utils import pyplot


def y_limits(vals) -> tuple[float, float]:
    """The data's range padded by 5 % of its span on each side (by 5 % of
    its magnitude, or 1, where the span is zero)."""
    lo, hi = float(np.nanmin(vals)), float(np.nanmax(vals))
    pad = 0.05 * (hi - lo) or 0.05 * max(abs(lo), abs(hi)) or 1.0
    return lo - pad, hi + pad


def build_viewer(path: str, *, show: bool = False) -> dict:
    """The viewer's figure for the gradient CSV at ``path``: returns its
    parts (``fig``, ``ax``, ``line``, ``slider``, ``buttons``) and ``show(i)``,
    which steps it to timestep i."""
    plt = pyplot(show)
    from matplotlib.widgets import Button, Slider

    times, z, vals = read_gradient_csv(path)
    fig, ax = plt.subplots(figsize=(10, 6))
    fig.subplots_adjust(bottom=0.25)
    (line,) = ax.plot(z, vals[0], "b.-")
    ax.set_xlabel("Radial position (m)")
    ax.set_ylabel("∂T/∂r (K/m)")
    ax.set_ylim(*y_limits(vals))
    title = ax.set_title(f"t = {times[0]:.3e} s  (step 1/{len(times)})")
    ax.grid(alpha=0.3)

    ax_slider = fig.add_axes([0.15, 0.1, 0.6, 0.04])
    slider = Slider(ax_slider, "step", 0, len(times) - 1, valinit=0,
                    valstep=1)
    state = {"i": 0}

    def step_to(i):
        state["i"] = int(i) % len(times)
        line.set_ydata(vals[state["i"]])
        title.set_text(f"t = {times[state['i']]:.3e} s  "
                       f"(step {state['i'] + 1}/{len(times)})")
        fig.canvas.draw_idle()

    slider.on_changed(step_to)
    bp = Button(fig.add_axes([0.80, 0.1, 0.07, 0.05]), "◀")
    bn = Button(fig.add_axes([0.88, 0.1, 0.07, 0.05]), "▶")
    bp.on_clicked(lambda _e: slider.set_val((state["i"] - 1) % len(times)))
    bn.on_clicked(lambda _e: slider.set_val((state["i"] + 1) % len(times)))
    return {"fig": fig, "ax": ax, "line": line, "slider": slider,
            "buttons": (bp, bn), "show": step_to}


def launch_viewer(path: str):
    """Show the viewer for the gradient CSV at ``path``; returns its
    figure."""
    viewer = build_viewer(path, show=True)
    pyplot(True).show()
    return viewer["fig"]


def main(argv=None):
    p = argparse.ArgumentParser(description="Interactive gradient viewer")
    p.add_argument("data_path", type=str)
    args = p.parse_args(argv)
    launch_viewer(args.data_path)


if __name__ == "__main__":
    main()

"""The port's simulation-vs-experiment comparison (``analysis.compare``)
against the JAX package's on the same arrays, its plot, the analysis
package's exports, and the port's independence:
no module of ``heatflow_tpu_torch``, ``chip_smoke.py`` or ``tools/`` imports
JAX or the JAX package."""

import ast
import glob
import os

import numpy as np
import pytest

from heatflow_tpu.analysis import compare as jcmp
from heatflow_tpu_torch.analysis import compare as tcmp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _traces(rng):
    t_sim = np.linspace(0.0, 1e-5, 60)
    t_exp = np.sort(rng.uniform(0.0, 1.1e-5, 25))
    sim = {"time": t_sim,
           "pside": 300 + 900 * np.exp(-((t_sim - 4e-6) / 2e-6) ** 2),
           "oside": 300 + 200 * np.exp(-((t_sim - 5e-6) / 3e-6) ** 2)}
    exp = {"time": t_exp,
           "temp": 2100 + rng.uniform(0, 1500, 25),
           "oside": 2400 + rng.uniform(0, 600, 25)}
    return sim, exp


def test_calculate_rmse_matches_jax():
    sim, exp = _traces(np.random.default_rng(1))
    for col in ("pside", "oside"):
        want = jcmp.calculate_rmse(exp["time"], exp["oside"], sim["time"],
                                   sim[col])
        got = tcmp.calculate_rmse(exp["time"], exp["oside"], sim["time"],
                                  sim[col])
        assert isinstance(got, float) and got == want


def test_normalized_traces_match_jax():
    """Dicts of columns (as read_watcher_csv returns them) in the port; the
    same columns as pandas-style mappings in the JAX package."""
    sim, exp = _traces(np.random.default_rng(2))
    want = jcmp.normalized_traces(sim, exp, 300.0)
    got = tcmp.normalized_traces(sim, exp, 300.0)
    assert set(got) == set(want) == {"sim_pside", "sim_oside", "exp_pside",
                                     "exp_oside"}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert got["sim_pside"][0] == 0.0 and got["exp_oside"][0] == 0.0


def test_plot_temperature_curves_writes_its_figure(tmp_path):
    """The simulation-vs-experiment plot (the JAX package's contract): a PNG
    under Agg, with and without experimental times, the figure closed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    sim, exp = _traces(np.random.default_rng(3))
    tr = tcmp.normalized_traces(sim, exp, 300.0)
    for name, t_exp in (("timed", exp["time"]), ("indexed", None)):
        png = tmp_path / f"{name}.png"
        tcmp.plot_temperature_curves(sim["time"], tr["sim_pside"],
                                     tr["sim_oside"], tr["exp_pside"],
                                     tr["exp_oside"], exp_time=t_exp,
                                     save_path=str(png), show_plot=False)
        assert png.stat().st_size > 1000
    assert not plt.get_fignums()


def test_analysis_package_exports_like_jax():
    import heatflow_tpu.analysis as ja
    import heatflow_tpu_torch.analysis as ta
    assert ta.__all__ == ja.__all__
    assert all(hasattr(ta, name) for name in ta.__all__)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
    # imports inside strings (code run in subprocesses) count as well
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for line in node.value.splitlines():
                words = line.split()
                if len(words) > 1 and words[0] in ("import", "from"):
                    yield words[1].rstrip(",")


@pytest.mark.parametrize("where", ["heatflow_tpu_torch", "chip_smoke.py",
                                   "tools"])
def test_port_imports_neither_jax_nor_the_jax_package(where):
    path = os.path.join(ROOT, where)
    files = ([path] if path.endswith(".py") else
             glob.glob(os.path.join(path, "**", "*.py"), recursive=True))
    assert files
    if where == "heatflow_tpu_torch":
        have = {os.path.relpath(f, path) for f in files}
        assert {"ops/mgz.py", "ops/multigrid.py", "sim/steady.py",
                "drivers/steady.py", "ops/cuda_mg.py", "ops/tridiag.py",
                "sim/reduced1d.py", "drivers/run1d.py",
                "analysis/splitnormal.py", "analysis/radial.py",
                "analysis/gradcheck.py", "analysis/konopkova.py",
                "analysis/sweep_surface.py", "analysis/viewer.py",
                "mesh/viz.py", "native/__init__.py"} <= have
    bad = [(os.path.relpath(f, ROOT), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "heatflow_tpu")]
    assert not bad, bad

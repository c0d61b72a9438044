"""The rest of the port's analysis layer against the JAX package's on the
same files: the radial-gradient plotter and its CLI, the gradient
diagnostics, the Konopkova converter, the sweep RMSE surface (on a tiny
sweep of the port's own driver), the viewer, the mesh plots and
``run2d --visualize-mesh``; and the two reference faults the port does not
copy (the radial CLI's ``--save`` with ``--plot-type both``, the viewer's
y-limits)."""

import matplotlib

matplotlib.use("Agg")

import os

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from heatflow_tpu.analysis import gradcheck as jgrad
from heatflow_tpu.analysis import konopkova as jkon
from heatflow_tpu.analysis import sweep_surface as jsurf
from heatflow_tpu.analysis.radial import RadialGradientPlotter as JPlotter
from heatflow_tpu.io.csvio import write_gradient_csv
from heatflow_tpu_torch.analysis import gradcheck as tgrad
from heatflow_tpu_torch.analysis import konopkova as tkon
from heatflow_tpu_torch.analysis import radial as trad
from heatflow_tpu_torch.analysis import sweep_surface as tsurf
from heatflow_tpu_torch.analysis import viewer as tview
from heatflow_tpu_torch.io.csvio import (read_gradient_csv, read_records,
                                         read_watcher_csv, write_records)
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def table(tmp_path, digits=None, name="radial_gradient.csv"):
    """tests/test_analysis.py's 20 x 40 noisy gradient table, its values
    rounded to ``digits`` significant digits when given (values that
    pandas' default float parser reads back exactly)."""
    rng = np.random.default_rng(0)
    times = np.linspace(1e-7, 7.5e-6, 20)
    z = np.linspace(-4e-6, 7e-6, 40)
    amp = -2e6 * np.exp(-((times - 2e-6) / 1.5e-6) ** 2)
    rows = amp[:, None] * np.exp(-0.5 * ((z[None, :] + 1e-6) / 8e-7) ** 2) \
        + 100.0 + rng.standard_normal((20, 40)) * 50.0
    if digits:
        rows = np.array([[float(f"{v:.{digits}g}") for v in row]
                         for row in rows])
    path = str(tmp_path / name)
    write_gradient_csv(path, times, z, rows)
    return path, times, z, rows


def test_plotter_summary_equals_jax(tmp_path):
    """12-digit values, which both readers parse alike: the summaries are
    equal, key for key."""
    path, times, z, rows = table(tmp_path, digits=12)
    pt, pj = trad.RadialGradientPlotter(path), JPlotter(path)
    np.testing.assert_array_equal(pt.grid, pj.data.iloc[:, 1:].to_numpy())
    assert pt.get_data_summary() == pj.get_data_summary()
    np.testing.assert_array_equal(pt.time_values, pj.time_values)
    np.testing.assert_array_equal(pt.radial_positions, pj.radial_positions)
    assert (pt.min_gradient, pt.max_gradient) == (pj.min_gradient,
                                                  pj.max_gradient)


def test_plotter_reads_back_what_was_written(tmp_path):
    """17-digit values: the port reads back the numbers written, bit for
    bit; pandas' default parser (the JAX package's reader) misreads 125 of
    these 800 by one ulp, the minimum among them, so the two summaries
    differ there by one ulp and agree everywhere else."""
    path, times, z, rows = table(tmp_path)
    pt, pj = trad.RadialGradientPlotter(path), JPlotter(path)
    np.testing.assert_array_equal(pt.grid, rows)
    np.testing.assert_array_equal(pt.time_values, times)
    np.testing.assert_array_equal(pt.radial_positions, z)
    misread = pj.data.iloc[:, 1:].to_numpy() != rows
    assert misread.sum() == 125
    st, sj = pt.get_data_summary(), pj.get_data_summary()
    assert st["peak_gradient"] == rows.min() == st["gradient_range"][0]
    assert set(st) == set(sj)
    for key in st:
        np.testing.assert_allclose(st[key], sj[key], rtol=2.3e-16, atol=0)


def test_plotter_plots(tmp_path):
    path, *_ = table(tmp_path)
    pl = trad.RadialGradientPlotter(path)
    e, h = tmp_path / "e.png", tmp_path / "h.png"
    pl.plot_gradient_evolution(time_indices=[0, 10], show_plot=False,
                               save_path=str(e))
    pl.plot_heatmap(show_plot=False, save_path=str(h))
    assert e.stat().st_size > 1000 and h.stat().st_size > 1000


def test_radial_cli_reference_flags(tmp_path):
    """plot_radial_gradient.py's CLI (ref :236-251) and the JAX package's
    aliases: every named file written."""
    path, *_ = table(tmp_path)
    ev, hm = tmp_path / "ev.png", tmp_path / "hm.png"
    trad.main([path, "--plot-type", "both", "--time-indices", "0", "5", "10",
               "--figsize", "10", "6", "--save-evolution", str(ev),
               "--save-heatmap", str(hm), "--no-show", "--summary"])
    assert ev.exists() and hm.exists()
    s = tmp_path / "alias.png"
    trad.main([path, "--heatmap", "--save", str(s), "--no-show"])
    assert s.exists()


def test_radial_cli_save_names_both_plots(tmp_path):
    """A reference fault not copied (heatflow_tpu/analysis/radial.py:141-144:
    with --plot-type both, --save is dropped for the heatmap): the port
    writes the evolution plot at --save and the heatmap beside it with a
    _heatmap suffix. The JAX CLI writes only the first."""
    from heatflow_tpu.analysis.radial import main as jmain
    path, *_ = table(tmp_path)
    trad.main([path, "--plot-type", "both", "--save",
               str(tmp_path / "t.png"), "--no-show"])
    assert (tmp_path / "t.png").exists()
    assert (tmp_path / "t_heatmap.png").stat().st_size > 1000
    jmain([path, "--plot-type", "both", "--save", str(tmp_path / "j.png"),
           "--no-show"])
    assert (tmp_path / "j.png").exists()
    assert not (tmp_path / "j_heatmap.png").exists()
    assert trad.heatmap_path("a/b.svg") == "a/b_heatmap.svg"


# reductions whose summation order follows the table's memory layout
ORDERED_SUMS = ("mean", "std", "mean_abs_source")


def test_gradcheck_equals_jax(tmp_path):
    """Both packages' diagnostics of one table (12-digit values, read alike
    by both): equal, but for the means and the standard deviation, which
    agree within two ulps. The JAX package's reader returns the table
    column-major (a DataFrame's ``to_numpy``), so numpy's pairwise sums run
    over it in another order; on a column-major copy of the port's table
    the two are equal."""
    path, *_ = table(tmp_path, digits=12)
    pairs = [(tgrad.analyze_gradient_data(path),
              jgrad.analyze_gradient_data(path))]
    pairs += [(tgrad.test_source_term_magnitude(path, kappa=kappa),
               jgrad.test_source_term_magnitude(path, kappa=kappa))
              for kappa in (3.8, 10.0)]
    for got, want in pairs:
        assert set(got) == set(want)
        for key in want:
            if key in ORDERED_SUMS:
                assert got[key] == pytest.approx(want[key], rel=4.5e-16,
                                                 abs=0), key
            else:
                assert got[key] == want[key], key
    vals = np.asfortranarray(read_gradient_csv(path)[2])
    assert (float(vals.mean()), float(vals.std())) == \
        (pairs[0][1]["mean"], pairs[0][1]["std"])
    png = tmp_path / "g.png"
    tgrad.plot_max_gradient_evolution(path, save_path=str(png),
                                      show_plot=False)
    assert png.stat().st_size > 1000
    tgrad.main([path])


def test_konopkova_equals_jax(tmp_path, monkeypatch):
    """The shipped raw traces. The port reads each 17-digit value as the
    nearest double (Python's ``float``); pandas' default parser, the JAX
    package's reader, misreads 106 of the 498 raw values by an ulp, so the
    two heating CSVs (the JAX one is ``experimental_data/
    konopkova_heat_data.csv``, bit for bit) differ in the last bit of 12 /
    42 / 57 of their 146 time / temp / oside values. From the same parsed
    traces the port's conversion writes the JAX package's CSV bit for
    bit."""
    import csv as csvmod
    p = os.path.join(ROOT, "experimental_data", "konopkova_pside.csv")
    o = os.path.join(ROOT, "experimental_data", "konopkova_oside.csv")
    shipped = os.path.join(ROOT, "experimental_data",
                           "konopkova_heat_data.csv")
    ot, oj = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    cols = tkon.convert_konopkova(p, o, ot)
    jkon.convert_konopkova(p, o, oj)
    got, want = read_watcher_csv(ot), read_watcher_csv(oj)
    assert list(got) == list(want) == ["time", "temp", "oside"]
    for key in want:
        np.testing.assert_array_equal(cols[key], got[key])
        np.testing.assert_array_equal(read_watcher_csv(shipped)[key],
                                      want[key])
        scale = np.abs(want[key]).max()
        assert np.abs(got[key] - want[key]).max() <= 2.3e-16 * scale, key
    assert [int((got[k] != want[k]).sum()) for k in want] == [12, 42, 57]
    # the port's reader: the nearest double of each field
    with open(p, newline="") as f:
        text = sorted(((float(a), float(b)) for a, b in csvmod.reader(f)))
    x, y = tkon.load_xy_csv(p)
    np.testing.assert_array_equal(x, [a for a, _ in text])
    np.testing.assert_array_equal(y, [b for _, b in text])
    # the conversion itself, from the JAX package's parse
    monkeypatch.setattr(tkon, "load_xy_csv", jkon.load_xy_csv)
    tkon.convert_konopkova(p, o, ot)
    with open(ot, "rb") as ft, open(oj, "rb") as fj:
        assert ft.read() == fj.read()
    tkon.main(["--pside", p, "--oside", o, "--out", ot])


def test_konopkova_reader_drops_non_numeric_rows(tmp_path):
    """Rows with a field that is not a number (a header, a blank, text) are
    dropped and the rest sorted by x, as the JAX package's pandas reader
    does."""
    raw = tmp_path / "raw.csv"
    raw.write_text("time, temp\n0.5, 2.0\n0.25, 1.5\nabc, 3\n0.75,\n"
                   "\n0.1, 1.25\n")
    x, y = tkon.load_xy_csv(str(raw))
    xj, yj = jkon.load_xy_csv(str(raw))
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)
    np.testing.assert_array_equal(x, [0.1, 0.25, 0.5])


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    """A tiny sweep of the port's own driver (2 x 2 x 1 runs, 3 steps, on
    the CPU), and its heating CSV."""
    from heatflow_tpu_torch.drivers.sweep import run_parameter_sweep
    d = tmp_path_factory.mktemp("surface")
    heat = d / "heat.csv"
    synthetic_heating(heat)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat)
    cfg["timing"]["num_steps"] = 3
    out = str(d / "sweep")
    run_parameter_sweep(cfg, out, (4e-6, 8e-6), (2.0, 6.0), (1.8e-6, 1.8e-6),
                        (2, 2, 1), base_mesh_folder=str(d / "m"),
                        suppress_print=True, device="cpu")
    return out, str(heat)


def test_score_sweep_outputs_equals_jax(sweep_dir, tmp_path):
    """The rmse column of both packages' scores of one port sweep
    directory. The JAX package reads the runs' 17-digit watcher values with
    pandas (an ulp off on some); the port reads them as written."""
    out, heat = sweep_dir
    want = jsurf.score_sweep_outputs(out, heat)
    got = tsurf.score_sweep_outputs(out, heat)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose([rec["rmse"] for rec in got],
                               want["rmse"].to_numpy(), rtol=1e-14, atol=0)
    recs = read_records(os.path.join(out, "rmse_summary.csv"))
    assert [rec["rmse"] for rec in recs] == [rec["rmse"] for rec in got]
    assert list(recs[0]) == list(want.columns)
    for rec, (_, row) in zip(got, want.iterrows()):
        assert (rec["run_name"], rec["k"], rec["fwhm"]) == \
            (row["run_name"], row["k"], row["fwhm"])


def test_score_marks_a_missing_run_nan(sweep_dir, tmp_path):
    """A record whose run folder holds no watcher_points.csv scores NaN."""
    out, heat = sweep_dir
    runs = read_records(os.path.join(out, "successful_runs.csv"))
    runs[0]["output_dir"] = str(tmp_path / "gone")
    write_records(str(tmp_path / "successful_runs.csv"), runs)
    got = tsurf.score_sweep_outputs(str(tmp_path), heat)
    assert np.isnan(got[0]["rmse"])
    assert np.isfinite([rec["rmse"] for rec in got[1:]]).all()
    assert read_records(str(tmp_path / "rmse_summary.csv"))[0]["rmse"] \
        is None


def test_rmse_surface_plot_and_cli(sweep_dir, tmp_path):
    out, heat = sweep_dir
    summary = tsurf.score_sweep_outputs(out, heat)
    png = tmp_path / "surf.png"
    tsurf.plot_rmse_surface(summary, width=1.8e-6, save_path=str(png),
                            show_plot=False)
    assert png.stat().st_size > 1000
    tsurf.main([out, "--exp-csv", heat, "--save", str(tmp_path / "s.png"),
                "--no-show"])
    assert (tmp_path / "s_w1.80e-06.png").exists()


def test_viewer_builds_headless_and_steps(tmp_path):
    path, times, z, rows = table(tmp_path)
    v = tview.build_viewer(path)
    np.testing.assert_array_equal(v["line"].get_ydata(), rows[0])
    v["show"](7)
    np.testing.assert_array_equal(v["line"].get_ydata(), rows[7])
    assert "step 8/20" in v["ax"].get_title()
    v["slider"].set_val(3)
    np.testing.assert_array_equal(v["line"].get_ydata(), rows[3])
    plt.close(v["ax"].figure)      # the viewer's window stays open for a user


def test_viewer_ylim_keeps_positive_data(tmp_path):
    """A reference fault not copied (heatflow_tpu/analysis/viewer.py:21:
    ylim (min·1.05, max·1.05) starts above the minimum of data that is
    positive throughout): the limits pad the data's range by its span."""
    rows = 500.0 + np.arange(12.0).reshape(3, 4)
    path = str(tmp_path / "pos.csv")
    write_gradient_csv(path, np.arange(3.0), np.arange(4.0), rows)
    ax = tview.build_viewer(path)["ax"]
    lo, hi = ax.get_ylim()
    plt.close(ax.figure)
    assert lo < rows.min() and hi > rows.max()
    assert (lo, hi) == pytest.approx((500.0 - 0.55, 511.0 + 0.55))
    # the JAX viewer's lower limit cuts the data off
    assert rows.min() * 1.05 > rows.min()
    for vals in (-rows, np.full((2, 2), 3.0), np.zeros((2, 2))):
        lo, hi = tview.y_limits(vals)
        assert lo < vals.min() and hi > vals.max()


def test_plot_mesh_both_mesh_kinds(tmp_path):
    from heatflow_tpu_torch.geometry import build_layout
    from heatflow_tpu_torch.mesh.structured import build_structured_mesh
    from heatflow_tpu_torch.mesh.unstructured_gen import \
        build_unstructured_mesh
    from heatflow_tpu_torch.mesh.viz import plot_mesh
    layout = build_layout(tiny_no_diamond_cfg(coarse=3.0))
    for name, mesh in (("s", build_structured_mesh(*layout)),
                       ("u", build_unstructured_mesh(*layout, seed=1))):
        png = tmp_path / f"{name}.png"
        fig, ax = plot_mesh(mesh, str(png))
        assert png.stat().st_size > 1000
        assert ax.get_title().startswith("mesh: ")


def test_run2d_visualize_mesh_writes_the_plot(tmp_path):
    from heatflow_tpu_torch.config import save_config
    from heatflow_tpu_torch.drivers import run2d
    heat = tmp_path / "heat.csv"
    synthetic_heating(heat)
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = str(heat)
    cfg["timing"]["num_steps"] = 2
    save_config(cfg, str(tmp_path / "c.yaml"))
    mesh = tmp_path / "mesh"
    run2d.main(["--config", str(tmp_path / "c.yaml"), "--mesh-folder",
                str(mesh), "--rebuild-mesh", "--visualize-mesh",
                "--output-folder", str(tmp_path / "out"), "--device", "cpu",
                "--watcher-points", "auto", "--suppress-print"])
    assert (mesh / "mesh_visualization.png").stat().st_size > 1000
    assert (tmp_path / "out" / "watcher_points.csv").exists()

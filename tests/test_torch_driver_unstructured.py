"""The port's drivers on unstructured meshes against the JAX package's, in
float64 on the CPU: ``run2d --mesh-style unstructured`` (the overlay path),
an imported mesh folder without the sidecar (the ELL path), the sweep over
an unstructured width folder (plain and recording), the steady driver, the
1D model on an unstructured 2D folder and the fit; their CSVs held to the
JAX drivers' CSVs."""

import filecmp
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.drivers import (fit as jfit, run1d as jrun1d, run2d as jrun,
                                  steady as jsteady, sweep as jsweep)
from heatflow_tpu.geometry import coupler_watcher_points
from heatflow_tpu_torch.config import save_config
from heatflow_tpu_torch.drivers import (fit as tfit, run1d as trun1d,
                                        run2d as trun, steady as tsteady,
                                        sweep as tsweep)
from heatflow_tpu_torch.io.csvio import read_watcher_csv
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg
from tests.test_torch_drivers import CSVS, _csv_close, _strip

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("udrivers")
    heat = d / "heat.csv"
    synthetic_heating(heat)
    c = tiny_no_diamond_cfg(coarse=3.0)
    c["heating"]["file"] = str(heat)
    c["timing"]["num_steps"] = 3
    return c


@pytest.fixture(scope="module")
def pair(cfg, tmp_path_factory):
    """``run_simulation(mesh_style='unstructured', rebuild_mesh=True)`` of
    each package: (root, JAX output, port output)."""
    root = tmp_path_factory.mktemp("urun")
    for name, mod, extra in (("j", jrun, {}), ("t", trun,
                                               dict(device="cpu"))):
        mod.run_simulation(cfg, str(root / f"mesh_{name}"), rebuild_mesh=True,
                           mesh_style="unstructured",
                           output_folder=str(root / f"out_{name}"),
                           watcher_points=coupler_watcher_points(cfg),
                           write_xdmf=False, suppress_print=True, **extra)
    return root


def test_run2d_unstructured_matches_jax(pair):
    """The generated mesh folder is the JAX package's byte for byte (mesh,
    config, overlay sidecar) and the run's CSVs and checkpoint agree."""
    oj, ot = pair / "out_j", pair / "out_t"
    assert sorted(os.listdir(ot)) == sorted(os.listdir(oj)) == sorted(
        CSVS + ("used_config.yaml", "checkpoint.npz"))
    for f in CSVS:
        _csv_close(str(ot / f), str(oj / f))
    for f in ("mesh.msh", "mesh_cfg.yaml"):
        assert filecmp.cmp(pair / "mesh_j" / f, pair / "mesh_t" / f,
                           shallow=False), f
    with np.load(pair / "mesh_j" / "mesh_overlay.npz") as a, \
            np.load(pair / "mesh_t" / "mesh_overlay.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["index", "shape"]
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    zj, zt = np.load(oj / "checkpoint.npz"), np.load(ot / "checkpoint.npz")
    assert float(zj["t"]) == float(zt["t"])
    assert np.abs(zt["u"] - zj["u"]).max() <= 1e-9 * np.abs(zj["u"]).max()


def test_imported_folder_without_sidecar_runs_the_ell_path(cfg, pair,
                                                           tmp_path, capsys):
    """Each package on the other's folder, and on a copy without the
    overlay sidecar (an imported gmsh mesh: the ELL gather); a structured
    folder under mesh_style='unstructured' is refused."""
    import shutil
    for src in ("mesh_j", "mesh_t"):
        bare = tmp_path / f"bare_{src}"
        shutil.copytree(pair / src, bare)
        os.remove(bare / "mesh_overlay.npz")
    outs = {}
    for name, mod, mesh, extra in (
            ("t_ov", trun, pair / "mesh_j", dict(device="cpu")),
            ("t_ell", trun, tmp_path / "bare_mesh_j", dict(device="cpu")),
            ("j_ell", jrun, tmp_path / "bare_mesh_t", {})):
        outs[name] = tmp_path / name
        mod.run_simulation(cfg, str(mesh), output_folder=str(outs[name]),
                           watcher_points=coupler_watcher_points(cfg),
                           write_xdmf=False, suppress_print=name != "t_ell",
                           **extra)
    assert "ELL gather operator path" in capsys.readouterr().out
    for f in CSVS:
        _csv_close(str(outs["t_ov"] / f), str(pair / "out_j" / f))
        _csv_close(str(outs["t_ell"] / f), str(outs["j_ell"] / f))
        # the lattice and the gather: the same operator
        _csv_close(str(outs["t_ell"] / f), str(pair / "out_t" / f), 1e-8)
    trun.run_simulation(cfg, str(tmp_path / "s"), rebuild_mesh=True,
                        output_folder=str(tmp_path / "so"), write_xdmf=False,
                        suppress_print=True, device="cpu")
    with pytest.raises(ValueError, match="holds a structured mesh"):
        trun.run_simulation(cfg, str(tmp_path / "s"), device="cpu",
                            mesh_style="unstructured")


def test_run2d_cli_unstructured(cfg, pair, tmp_path):
    """``python -m heatflow_tpu_torch.drivers.run2d --mesh-style
    unstructured --device cpu``: the in-process run's CSVs."""
    cpath = tmp_path / "c.yaml"
    save_config(cfg, str(cpath))
    trun.main(["--config", str(cpath), "--mesh-folder",
               str(tmp_path / "m"), "--rebuild-mesh", "--mesh-style",
               "unstructured", "--output-folder", str(tmp_path / "o"),
               "--watcher-points", "auto", "--device", "cpu",
               "--suppress-print"])
    for f in CSVS:
        _csv_close(str(tmp_path / "o" / f), str(pair / "out_t" / f), 1e-12)


def _unstructured_widths(pkg, cfg, base, widths):
    for w in widths:
        from heatflow_tpu_torch.config import with_parameters
        pkg._prepare_mesh(with_parameters(cfg, sample_z=w),
                          tsweep.mesh_folder_for_width(base, w), True,
                          "auto", "unstructured")


@pytest.mark.parametrize("record", [False, True], ids=["plain", "recording"])
def test_sweep_over_unstructured_folders_matches_jax(cfg, tmp_path, record):
    w = float(cfg["mats"]["p_sample"]["z"])
    res = {}
    for name, mod, pkg, extra in (
            ("j", jsweep, jrun, dict(dtype=jnp.float64)),
            ("t", tsweep, trun, dict(device="cpu"))):
        base = str(tmp_path / f"meshes_{name}")
        _unstructured_widths(pkg, cfg, base, (w,))
        out = str(tmp_path / f"out_{name}")
        res[name] = (out, *mod.run_parameter_sweep(
            cfg, out, (4e-6, 8e-6), (2.0, 6.0), (w, w), (2, 2, 1),
            base_mesh_folder=base, suppress_print=True, rtol=1e-11,
            record_gradient=record, **extra))
    (oj, okj, fj), (ot, okt, ft) = res["j"], res["t"]
    assert _strip(okt) == _strip(okj) and len(okt) == 4
    assert not fj and not ft
    for rec in okt:
        names = CSVS if record else CSVS[:1]
        for f in names:
            _csv_close(os.path.join(ot, rec["run_name"], f),
                       os.path.join(oj, rec["run_name"], f), 1e-8)
    import json
    meta = json.load(open(os.path.join(ot, "sweep_metadata.json")))
    assert set(meta["solver_resolved"].values()) == {"xla"}


def test_steady_driver_refuses_unstructured(cfg, pair):
    """As the JAX driver: the steady workflow needs a structured mesh."""
    for mod, extra in ((jsteady, {}), (tsteady, dict(device="cpu"))):
        with pytest.raises(ValueError, match="structured mesh"):
            mod.run_steady(cfg, str(pair / "mesh_t"), **extra)


def test_run1d_on_unstructured_folder_matches_jax(cfg, pair, tmp_path):
    """The 1D model on the unstructured 2D folder (the facet-scan axis)
    and that run's gradient CSV."""
    grad = str(pair / "out_t" / "radial_gradient.csv")
    wp = {"pside": (float(cfg["mats"]["p_ins"]["z"]), 0.0)}
    outs = {}
    for name, fn, extra in (("j", jrun1d.run_1d, {}),
                            ("t", trun1d.run_1d, dict(device="cpu"))):
        outs[name] = tmp_path / name
        fn(cfg, str(pair / "mesh_t"), output_folder=str(outs[name]),
           watcher_points=wp, write_xdmf=False, suppress_print=True,
           radial_gradient_path=grad, **extra)
    _csv_close(str(outs["t"] / "watcher_points.csv"),
               str(outs["j"] / "watcher_points.csv"), 1e-8)
    w = read_watcher_csv(str(outs["t"] / "watcher_points.csv"))
    assert list(w) == ["time", "pside"] and len(w["time"]) == 3


def test_fit_cli_on_unstructured_folder(cfg, pair, tmp_path, monkeypatch,
                                        capsys):
    """``drivers.fit --device cpu`` on the unstructured folder: the JAX
    fit's answer (coarse grid, one Adam step, Gauss-Newton)."""
    cpath = tmp_path / "c.yaml"
    save_config(cfg, str(cpath))
    small = dict(coarse=(2, 2), n_starts=1, adam_steps=1)
    for mod in (tfit, jfit):
        orig = mod.fit_parameters
        monkeypatch.setattr(
            mod, "fit_parameters",
            lambda problem, _o=orig, **kw: _o(problem, **{**kw, **small}))
    res_t = tfit.main(["--config", str(cpath), "--mesh-folder",
                       str(pair / "mesh_t"), "--k-range", "2", "12",
                       "--fwhm-range", "4e-6", "1e-5", "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"^BEST FIT: k = ([0-9.]+) W/m/K, FWHM = ([0-9.e+-]+) m, "
                  r"o-side RMSE = ([0-9.]+)$", out, re.M)
    assert m, out
    jfit.main(["--config", str(cpath), "--mesh-folder",
               str(pair / "mesh_t"), "--k-range", "2", "12", "--fwhm-range",
               "4e-6", "1e-5"])
    mj = re.search(r"^BEST FIT: k = ([0-9.]+) W/m/K, FWHM = ([0-9.e+-]+) m, "
                   r"o-side RMSE = ([0-9.]+)$", capsys.readouterr().out, re.M)
    assert mj and m.groups() == mj.groups()
    assert np.isfinite([res_t.k_stderr, res_t.fwhm_stderr]).all()

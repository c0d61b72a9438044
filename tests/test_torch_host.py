"""PyTorch port, host modules: config, geometry, mesh, stencil assembly, BC
masks, heating CSV and problem setup are exact against the JAX package."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.geometry import heating_line as j_heating_line
from heatflow_tpu.mesh.axes import graded_axis as j_graded_axis
from heatflow_tpu.ops.stencil import assemble_stencils as j_assemble
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.bc import structured_row_mask as j_row_mask
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu_torch.config import ConfigError, parse_yaml_subset
from heatflow_tpu_torch.geometry import coupler_watcher_points as t_watch
from heatflow_tpu_torch.geometry import heating_line as t_heating_line
from heatflow_tpu_torch.mesh.axes import graded_axis as t_graded_axis
from heatflow_tpu_torch.ops.stencil import stencil_to_coo as t_to_coo
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.bc import structured_row_mask as t_row_mask
from heatflow_tpu_torch.sim.problem import Problem2D, problem_from_arrays
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(ROOT, "cfgs", "*.yaml")))
HEAT_CSVS = sorted(glob.glob(os.path.join(ROOT, "experimental_data",
                                          "*heat_data.csv")))
FLAGSHIP = os.path.join(ROOT, "cfgs", "geballe_with_diamond.yaml")
FLAGSHIP_CSV = os.path.join(ROOT, "experimental_data",
                            "geballe_heat_data.csv")

# (config, mesh size_scale): both tiny no-diamond sizes and a 9-material
# flagship cut to 20 x 72 nodes
CASES = {"tiny2": (lambda: tiny_no_diamond_cfg(coarse=2.0), 1.0),
         "tiny3": (lambda: tiny_no_diamond_cfg(coarse=3.0), 1.0),
         "dac16": (lambda: T.load_config(FLAGSHIP), 16.0)}


def _pair(case):
    """(JAX problem, port problem) built from the same config and heating."""
    make_cfg, scale = CASES[case]
    cfg = make_cfg()
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    out = []
    for pkg, heating, watch, build in (
            (J, JHeating(time=t, temp=temp), j_watch, j_build_problem),
            (T, THeating(time=t, temp=temp), t_watch, t_build_problem)):
        domain, mats = pkg.build_layout(cfg)
        mesh = pkg.build_structured_mesh(domain, mats, size_scale=scale)
        out.append(build(mesh, heating, cfg, watcher_points=watch(cfg),
                         **({"stencils": j_assemble(mesh, backend="numpy")}
                            if pkg is J else {})))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return _pair(request.param)


def test_import_needs_no_jax_pandas_yaml():
    """The package imports, and its main path runs a few steps of the
    flagship recipe, with jax, pandas and yaml blocked."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "pandas", "yaml"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import heatflow_tpu_torch as T
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
from heatflow_tpu_torch.sim.stepper import make_simulate_fn
from heatflow_tpu_torch.ops import cuda_cg, _build
cfg = T.load_config({FLAGSHIP!r})
cfg["timing"]["num_steps"] = 3
domain, mats = T.build_layout(cfg)
mesh = T.build_structured_mesh(domain, mats, size_scale=20.0)
problem = build_problem(mesh, HeatingCurve.from_csv({FLAGSHIP_CSV!r}), cfg,
                        watcher_points=coupler_watcher_points(cfg))
ys = make_simulate_fn(problem, dtype=torch.float32, rtol=1e-4, maxiter=8000,
                      record_gradient=False, solver="vmem",
                      precondition="adaptive", warm_start="extrapolate",
                      f64_refine=1, device="cpu")()
assert torch.isfinite(ys["watch"]).all()
assert _build._lib is None
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "heatflow_tpu", "pandas",
                              "yaml") and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_yaml_subset_parser_matches_pyyaml(path):
    text = open(path).read()
    assert parse_yaml_subset(text, source=path) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, 2]\n", "a:\n- - 1\n", "a: {b: 1}\n", 'a: "x"\n', "a: &x 1\n",
    "a: 1\na: 2\n", "a:\n   b: 1\n  c: 2\n", "--- \na: 1\n", "a: 0x1f\n",
    "just text\n"])
def test_yaml_subset_parser_rejects_the_rest(text):
    with pytest.raises(ConfigError):
        parse_yaml_subset(text)


def test_config_helpers_match():
    from heatflow_tpu.config import mat_float as jm, timing as jt
    from heatflow_tpu.config import validate_config as jv
    from heatflow_tpu_torch.config import mat_float as tm, timing as tt
    from heatflow_tpu_torch.config import validate_config as tv
    cfg = T.load_config(FLAGSHIP)
    assert cfg == J.load_config(FLAGSHIP)
    tv(cfg, require_heating_file=True)
    jv(cfg, require_heating_file=True)
    assert tt(cfg) == jt(cfg)
    assert tm(cfg, "p_sample", "k") == jm(cfg, "p_sample", "k")
    bad = dict(cfg, timing={"t_final": 1.0})
    with pytest.raises(ConfigError):
        tv(bad)


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_and_geometry_exact(case):
    cfg = CASES[case][0]()
    (jd, jm), (td, tm) = J.build_layout(cfg), T.build_layout(cfg)
    assert jd == td
    assert [(m.name, m.bounds, m.rho_cv, m.kappa, m.mesh_size) for m in jm] \
        == [(m.name, m.bounds, m.rho_cv, m.kappa, m.mesh_size) for m in tm]
    assert j_watch(cfg) == t_watch(cfg)
    assert j_heating_line(cfg, jm) == t_heating_line(cfg, tm)
    assert j_heating_line(cfg) == t_heating_line(cfg)


def test_mesh_and_stencils_exact(pair):
    pj, pt = pair
    for name in ("z", "r", "cell_tags"):
        assert np.array_equal(getattr(pj.mesh, name), getattr(pt.mesh, name))
    assert pj.mesh.material_tags == pt.mesh.material_tags
    for name in ("K", "M", "K_flat", "M_flat", "G_r", "G_z", "M_proj"):
        assert np.array_equal(getattr(pj.stencils, name),
                              getattr(pt.stencils, name)), name
    from heatflow_tpu.ops.stencil import stencil_to_coo as j_to_coo
    for a, b in zip(j_to_coo(pj.stencils.M_proj),
                    t_to_coo(pt.stencils.M_proj)):
        assert np.array_equal(a, b)


def test_problem_arrays_exact(pair):
    pj, pt = pair
    for name in ("dirichlet_mask", "heat_mask", "r_sq", "kappas", "rho_cvs",
                 "watcher_idx"):
        assert np.array_equal(getattr(pj, name), getattr(pt, name)), name
    assert (pj.dt, pj.num_steps, pj.ic_temp, pj.fwhm) == \
        (pt.dt, pt.num_steps, pt.ic_temp, pt.fwhm)
    assert pj.watcher_names == pt.watcher_names
    for name in ("band_nodes", "band_bin_ids", "bin_counts", "bin_centers",
                 "axis_z"):
        assert np.array_equal(getattr(pj.radial, name),
                              getattr(pt.radial, name)), name


@pytest.mark.parametrize("loc", ["left", "right", "bottom", "top", "outer",
                                 "x", "y"])
def test_row_masks_exact(loc):
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(-2e-6, 3e-6, 40))
    r = np.sort(rng.uniform(0.0, 5e-6, 30))
    kw = {"coord": z[17], "center": 0.0, "length": 4e-6} if loc == "x" \
        else {"coord": r[11], "length": 2e-6} if loc == "y" \
        else {"length": 3e-6}
    assert np.array_equal(j_row_mask(z, r, loc, **kw),
                          t_row_mask(z, r, loc, **kw))


def test_flagship_axes_exact():
    cfg = T.load_config(FLAGSHIP)
    (jd, jm), (td, tm) = J.build_layout(cfg), T.build_layout(cfg)
    for k in (0, 2):
        spans = [(m.bounds[k], m.bounds[k + 1], m.mesh_size) for m in jm]
        lo = min(m.bounds[k] for m in jm)
        hi = max(m.bounds[k + 1] for m in jm)
        a, b = j_graded_axis(lo, hi, spans), t_graded_axis(lo, hi, spans)
        assert np.array_equal(a, b)
    assert (len(a), len(j_graded_axis(jd[0], jd[1], [
        (m.bounds[0], m.bounds[1], m.mesh_size) for m in jm]))) \
        == (1107, 251)


@pytest.mark.parametrize("path", HEAT_CSVS, ids=os.path.basename)
def test_heating_csv_exact(path):
    hj, ht = JHeating.from_csv(path), THeating.from_csv(path)
    assert np.array_equal(hj.time, ht.time)
    assert np.array_equal(hj.temp, ht.temp)
    assert (hj.oside is None) == (ht.oside is None)
    if hj.oside is not None:
        assert np.array_equal(hj.oside, ht.oside, equal_nan=True)
    assert hj.amplitude_offset(300.0) == ht.amplitude_offset(300.0)


def test_heating_csv_cleaning(tmp_path):
    """Non-numeric rows dropped, rows sorted by time, as the reference."""
    path = tmp_path / "heat.csv"
    path.write_text("time,temp,oside\n3e-7,2100,2400\n1e-7,x,2\n"
                    "2e-7,2000,nan\nfoo,1,1\n\n1.5e-7,1999.5,2300\n")
    hj, ht = JHeating.from_csv(str(path)), THeating.from_csv(str(path))
    assert np.array_equal(ht.time, [1.5e-7, 2e-7, 3e-7])
    for name in ("time", "temp", "oside"):
        assert np.array_equal(getattr(hj, name), getattr(ht, name),
                              equal_nan=True), name


def test_problem_from_arrays_round_trips(pair):
    pj, pt = pair
    back = problem_from_arrays(pt.to_arrays(), pt.mesh, pt.heating,
                               watcher_names=pt.watcher_names)
    ported = Problem2D.from_reference(pj, pt.mesh, pt.heating)
    for other in (back, ported):
        a, b = pt.to_arrays(), other.to_arrays()
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        assert other.watcher_names == pt.watcher_names


def test_device_arrays_types():
    pt = _pair("tiny3")[1]
    d = pt.device_arrays(torch.float32, "cpu")
    assert d["K"].dtype == torch.float32 and d["K"].device.type == "cpu"
    assert d["watch_flat"].dtype == torch.int64
    assert d["band_nodes"].dtype == torch.int64
    assert d["band_bins"].dtype == torch.int64
    nr = pt.mesh.shape[1]
    assert d["watch_flat"].tolist() == (pt.watcher_idx[:, 0] * nr
                                        + pt.watcher_idx[:, 1]).tolist()
    assert torch.equal(d["free"], 1.0 - d["dirichlet"])

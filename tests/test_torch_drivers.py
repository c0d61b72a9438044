"""The port's drivers against the JAX package's, in float64 on the CPU: the 2D
driver (artifacts, mesh folders read across packages, ``--resume``), the
sweep driver (plain, recording, resume, NaN range), the 1D driver on the
gradient CSV of the port's own 2D run, the CLIs with jax, pandas and yaml
blocked, and the options the slice rejects."""

import filecmp
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.drivers import run1d as jrun1d
from heatflow_tpu.drivers import run2d as jrun, sweep as jsweep
from heatflow_tpu.geometry import coupler_watcher_points
from heatflow_tpu_torch.drivers import run1d as trun1d
from heatflow_tpu_torch.drivers import run2d as trun, sweep as tsweep
from heatflow_tpu_torch.io.csvio import read_gradient_csv, read_watcher_csv
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("watcher_points.csv", "radial_gradient.csv",
        "radial_gradient_raw.csv")
F64_TOL = 1e-9


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("drivers")
    heat = d / "heat.csv"
    synthetic_heating(heat)
    c = tiny_no_diamond_cfg(coarse=3.0)
    c["heating"]["file"] = str(heat)
    c["timing"]["num_steps"] = 3
    return c


def _csv_close(a, b, tol=F64_TOL):
    """Same header bytes, values within ``tol`` of their scale."""
    with open(a) as fa, open(b) as fb:
        assert fa.readline() == fb.readline(), (a, b)
    if os.path.basename(a) == "watcher_points.csv":
        va = np.column_stack(list(read_watcher_csv(a).values()))
        vb = np.column_stack(list(read_watcher_csv(b).values()))
    else:
        va, vb = (np.column_stack([t[:, None], v]) for t, _, v in
                  (read_gradient_csv(a), read_gradient_csv(b)))
    assert va.shape == vb.shape and np.isfinite(va).all()
    assert np.abs(va - vb).max() <= tol * np.abs(vb).max(), (a, b)


def _run2d_pair(cfg, tmp_path, **kw):
    out = {}
    for name, mod, extra in (("j", jrun, {}), ("t", trun,
                                               dict(device="cpu"))):
        mod.run_simulation(cfg, str(tmp_path / f"mesh_{name}"),
                           rebuild_mesh=True,
                           output_folder=str(tmp_path / f"out_{name}"),
                           watcher_points=mod.coupler_watcher_points(cfg),
                           suppress_print=True, **kw, **extra)
        out[name] = tmp_path / f"out_{name}"
    return out["j"], out["t"]


def test_run_simulation_matches_jax(cfg, tmp_path):
    oj, ot = _run2d_pair(cfg, tmp_path)
    assert sorted(os.listdir(oj)) == sorted(os.listdir(ot)) == sorted(
        CSVS + ("used_config.yaml", "output.xdmf", "output.h5",
                "checkpoint.npz"))
    for f in CSVS:
        _csv_close(str(ot / f), str(oj / f))
    assert filecmp.cmp(oj / "used_config.yaml", ot / "used_config.yaml",
                       shallow=False)
    for f in ("mesh.msh", "mesh_cfg.yaml"):
        assert filecmp.cmp(tmp_path / "mesh_j" / f, tmp_path / "mesh_t" / f,
                           shallow=False), f
    zj, zt = np.load(oj / "checkpoint.npz"), np.load(ot / "checkpoint.npz")
    assert zj.files == zt.files
    assert float(zj["t"]) == float(zt["t"]) and int(zj["step"]) == 3
    assert np.abs(zt["u"] - zj["u"]).max() <= F64_TOL * np.abs(zj["u"]).max()


def test_run_simulation_with_mg_matches_jax(cfg, tmp_path):
    """``--precondition mg`` through the 2D driver: the V-cycle on the eager
    path, the CSVs within F64_TOL of the JAX driver's."""
    oj, ot = _run2d_pair(cfg, tmp_path, precondition="mg", write_xdmf=False)
    for f in CSVS:
        _csv_close(str(ot / f), str(oj / f))


def test_mesh_folders_read_across_packages_and_resume(cfg, tmp_path):
    """Each package runs on the mesh folder the other wrote, and a run
    resumed from the checkpoint continues as the JAX package's does."""
    oj, ot = _run2d_pair(cfg, tmp_path, write_xdmf=False)
    for name, mod, mesh, extra in (("tj", trun, "mesh_j", dict(device="cpu")),
                                   ("jt", jrun, "mesh_t", {})):
        mod.run_simulation(cfg, str(tmp_path / mesh), rebuild_mesh=False,
                           output_folder=str(tmp_path / name),
                           watcher_points=mod.coupler_watcher_points(cfg),
                           write_xdmf=False, suppress_print=True, **extra)
        for f in CSVS:
            _csv_close(str(tmp_path / name / f), str(oj / f))
    for name, mod, src, extra in (("rj", jrun, oj, {}),
                                  ("rt", trun, ot, dict(device="cpu"))):
        mod.run_simulation(cfg, str(tmp_path / "mesh_t"),
                           output_folder=str(tmp_path / name),
                           watcher_points=mod.coupler_watcher_points(cfg),
                           write_xdmf=False, suppress_print=True,
                           resume_from=str(src), **extra)
    for f in CSVS:
        _csv_close(str(tmp_path / "rt" / f), str(tmp_path / "rj" / f))
    times = read_watcher_csv(str(tmp_path / "rt" / CSVS[0]))["time"]
    np.testing.assert_allclose(times, (np.arange(4, 7)) * 2.5e-6)


def _sweep_pair(cfg, tmp_path, tag, *, k_range=(2.0, 6.0), num_points=(2, 2,
                                                                       2),
                **kw):
    w = float(cfg["mats"]["p_sample"]["z"])
    res = {}
    for name, mod, extra in (("j", jsweep, dict(dtype=jnp.float64)),
                             ("t", tsweep, dict(device="cpu"))):
        out = str(tmp_path / f"{tag}_{name}")
        res[name] = (out, *mod.run_parameter_sweep(
            cfg, out, (4e-6, 8e-6), k_range, (w, 1.5 * w), num_points,
            base_mesh_folder=str(tmp_path / f"meshes_{name}"),
            suppress_print=True, **kw, **extra))
    return res["j"], res["t"]


def _strip(records):
    """Records without runtime and output_dir, NaN read as None (pandas
    reads an empty field back as NaN, the port as None)."""
    nan = lambda v: isinstance(v, float) and np.isnan(v)
    return [{k: None if nan(v) else v for k, v in r.items()
             if k not in ("runtime", "output_dir")} for r in records]


def _same_sweep(j, t, record_gradient):
    (oj, rj, fj), (ot, rt, ft) = j, t
    assert _strip(rt) == _strip(rj) and _strip(ft) == _strip(fj)
    assert sorted(os.listdir(oj)) == sorted(os.listdir(ot))
    mj = json.load(open(os.path.join(oj, "sweep_metadata.json")))
    mt = json.load(open(os.path.join(ot, "sweep_metadata.json")))
    assert mt.keys() == mj.keys()
    for k in ("precondition", "record_gradient", "total_runs",
              "fwhm_values", "k_values", "width_values"):
        assert mt[k] == mj[k], k
    files = CSVS if record_gradient else CSVS[:1]
    for rec in rt:
        d = rec["run_name"]
        assert sorted(os.listdir(os.path.join(ot, d))) == sorted(
            os.listdir(os.path.join(oj, d))) == sorted(files
                                                        + ("used_config.yaml",))
        for f in files:
            _csv_close(os.path.join(ot, d, f), os.path.join(oj, d, f))
        assert filecmp.cmp(os.path.join(ot, d, "used_config.yaml"),
                           os.path.join(oj, d, "used_config.yaml"),
                           shallow=False)
    for f in ("successful_runs.csv", "failed_runs.csv"):
        assert os.path.isfile(os.path.join(ot, f)) == os.path.isfile(
            os.path.join(oj, f))
    return mt


@pytest.mark.parametrize("record_gradient", [False, True],
                         ids=["plain", "recording"])
def test_sweep_matches_jax(cfg, tmp_path, record_gradient):
    j, t = _sweep_pair(cfg, tmp_path, "s", record_gradient=record_gradient)
    assert len(t[1]) == 8 and not t[2]
    meta = _same_sweep(j, t, record_gradient)
    assert set(meta["solver_resolved"].values()) == {"xla"}
    for r in t[1]:
        assert r["runtime"] > 0 and r["output_dir"].startswith(t[0])


def test_sweep_with_mg_matches_jax(cfg, tmp_path):
    """``--precondition mg`` through the sweep driver resolves 'auto' to the
    eager path and matches the JAX driver's records."""
    j, t = _sweep_pair(cfg, tmp_path, "mg", num_points=(1, 2, 1),
                       precondition="mg")
    assert len(t[1]) == 2 and not t[2]
    meta = _same_sweep(j, t, False)
    assert set(meta["solver_resolved"].values()) == {"xla"}
    assert meta["precondition"] == "mg"


def test_sweep_resume_matches_jax(cfg, tmp_path):
    """A sweep resumed after runs were dropped from successful_runs.csv
    re-runs exactly those, as the JAX driver does."""
    j, t = _sweep_pair(cfg, tmp_path, "r", num_points=(2, 1, 1))
    for out, _, _ in (j, t):
        path = os.path.join(out, "successful_runs.csv")
        lines = open(path).read().splitlines(keepends=True)
        open(path, "w").write("".join(lines[:2]))
    j2, t2 = _sweep_pair(cfg, tmp_path, "r", num_points=(2, 1, 1),
                         resume=True)
    assert len(t2[1]) == 2 and _strip(t2[1]) == _strip(j2[1])
    assert t2[1][0]["runtime"] == pytest.approx(t[1][0]["runtime"])
    _same_sweep(j2, t2, False)
    with open(os.path.join(t[0], "successful_runs.csv")) as ft, \
            open(os.path.join(j[0], "successful_runs.csv")) as fj:
        rows_t = [r.split(",") for r in ft.read().splitlines()]
        rows_j = [r.split(",") for r in fj.read().splitlines()]
    keep = [i for i, k in enumerate(rows_j[0]) if k not in ("runtime",
                                                           "output_dir")]
    assert [[r[i] for i in keep] for r in rows_t] == \
        [[r[i] for i in keep] for r in rows_j]


def test_sweep_records_failed_runs(cfg, tmp_path):
    """NaN conductivities land in failed_runs.csv with the JAX driver's
    error strings (ref parameter_sweep.py:447-509)."""
    j, t = _sweep_pair(cfg, tmp_path, "f", k_range=(np.nan, np.nan),
                       num_points=(2, 1, 1))
    assert not t[1] and len(t[2]) == 2
    assert _strip(t[2]) == _strip(j[2])
    assert {r["error"] for r in t[2]} == {"non-finite trace"}
    with open(os.path.join(t[0], "failed_runs.csv")) as ft, \
            open(os.path.join(j[0], "failed_runs.csv")) as fj:
        assert ft.readline() == fj.readline()
    assert not os.path.exists(os.path.join(t[0], "successful_runs.csv"))


@pytest.mark.parametrize("case", ["unstructured", "z-shards", "devices"])
def test_unported_driver_options_raise(cfg, tmp_path, case):
    """The drivers' multi-device options (P11): ``--z-shards`` on an
    unstructured mesh raises as the JAX driver does; ``--z-shards 2`` (two
    gloo ranks; rank 0 writes) and ``devices=['cpu', 'cpu']`` run, their
    artifacts within 1e-9 of (the sweep's: equal to) the one-device run's."""
    d = str(tmp_path)
    if case == "unstructured":
        with pytest.raises(ValueError, match="structured meshes only"):
            trun.run_simulation(cfg, d + "/m", True, mesh_style="unstructured",
                                z_shards=2, device="cpu")
        return
    if case == "z-shards":
        wp = coupler_watcher_points(cfg)
        for tag, zs in (("one", 1), ("two", 2)):
            res = trun.run_simulation(
                cfg, f"{d}/m_{tag}", True, output_folder=f"{d}/{tag}",
                watcher_points=wp, write_xdmf=False, suppress_print=True,
                z_shards=zs, device="cpu")
            assert res.final_u.shape == (14, 51)
        for name in CSVS:
            _csv_close(f"{d}/two/{name}", f"{d}/one/{name}")
        return
    runs = {}
    for tag, devs in (("one", ["cpu"]), ("two", ["cpu", "cpu"])):
        runs[tag] = tsweep.run_parameter_sweep(
            cfg, f"{d}/{tag}", (4e-6, 8e-6), (2.0, 6.0), (1e-6, 1e-6),
            (1, 3, 1), base_mesh_folder=f"{d}/m_{tag}", devices=devs)
    assert _strip(runs["one"][0]) == _strip(runs["two"][0])
    for rec in runs["one"][0]:
        assert filecmp.cmp(f"{d}/one/{rec['run_name']}/watcher_points.csv",
                           f"{d}/two/{rec['run_name']}/watcher_points.csv",
                           shallow=False)


def test_imported_mesh_and_missing_card_raise(cfg, tmp_path):
    """A folder without ``structured_grid`` imports through the unstructured
    path: a gmsh mesh runs (the ELL gather, no sidecar), an empty file is
    no mesh."""
    from heatflow_tpu_torch.mesh.msh_io import write_msh
    from heatflow_tpu_torch.mesh.unstructured_gen import \
        build_unstructured_mesh
    um = build_unstructured_mesh(*trun.build_layout(cfg), seed=2)
    os.makedirs(tmp_path / "g")
    write_msh(str(tmp_path / "g" / "mesh.msh"), um.nodes, um.cells,
              um.cell_tags, um.material_tags)
    open(tmp_path / "g" / "mesh_cfg.yaml", "w").write("timing: {}\n")
    ys = trun.run_simulation(cfg, str(tmp_path / "g"), device="cpu",
                             output_folder=str(tmp_path / "go"),
                             watcher_points=coupler_watcher_points(cfg),
                             write_xdmf=False, suppress_print=True)
    assert ys["watch"].shape == (3, 2) and np.isfinite(ys["watch"]).all()
    os.makedirs(tmp_path / "m")
    open(tmp_path / "m" / "mesh.msh", "w").close()
    open(tmp_path / "m" / "mesh_cfg.yaml", "w").write("material_tags: {}\n")
    with pytest.raises(ValueError, match="MeshFormat"):
        trun.run_simulation(cfg, str(tmp_path / "m"), device="cpu")
    with pytest.raises(FileNotFoundError, match="mesh_cfg.yaml"):
        trun.run_simulation(cfg, str(tmp_path / "none"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trun.run_simulation(cfg, str(tmp_path / "m"), True)
        with pytest.raises(RuntimeError, match="CUDA"):
            tsweep.run_parameter_sweep(cfg, str(tmp_path / "s"),
                                       (4e-6, 4e-6), (2.0, 2.0),
                                       (1e-6, 1e-6), (1, 1, 1))
    assert trun.default_dtype("cpu") == torch.float64
    assert trun.default_dtype("cuda") == torch.float32


def test_clis_run_without_jax_pandas_yaml(cfg, tmp_path):
    """Both CLIs, in a subprocess with jax, jaxlib, pandas and yaml
    blocked: a recording sweep and a 2D run with its checkpoint."""
    cfg_path = tmp_path / "base.yaml"
    from heatflow_tpu_torch.config import save_config
    save_config(cfg, str(cfg_path))
    w = float(cfg["mats"]["p_sample"]["z"])
    code = f"""
import sys
for name in ("jax", "jaxlib", "pandas", "yaml"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from heatflow_tpu_torch.drivers import run2d, sweep
sweep.main(["--config", {str(cfg_path)!r}, "--output-dir",
            {str(tmp_path / "sweep")!r}, "--mesh-folder",
            {str(tmp_path / "meshes")!r}, "--num-points", "1", "2", "1",
            "--width-range", "{w}", "{w}", "--record-gradient",
            "--device", "cpu", "--verbose"])
run2d.main(["--config", {str(cfg_path)!r}, "--mesh-folder",
            {str(tmp_path / "mesh")!r}, "--rebuild-mesh", "--output-folder",
            {str(tmp_path / "run")!r}, "--watcher-points", "auto",
            "--device", "cpu"])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "heatflow_tpu", "pandas",
                              "yaml") and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "PARAMETER SWEEP COMPLETE: 2 ok, 0 failed" in proc.stdout
    assert "artifact writes" in proc.stdout
    runs = [d for d in os.listdir(tmp_path / "sweep") if d.startswith("fwhm")]
    assert len(runs) == 2
    for d in runs:
        assert set(CSVS) <= set(os.listdir(tmp_path / "sweep" / d))
    assert set(CSVS + ("checkpoint.npz", "used_config.yaml")) <= set(
        os.listdir(tmp_path / "run"))
    meta = json.load(open(tmp_path / "sweep" / "sweep_metadata.json"))
    assert meta["precondition"] == "jacobi"     # float64 on the CPU


@pytest.mark.cuda
def test_run2d_on_cuda_launches_the_kernel(cfg, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from heatflow_tpu_torch.ops import cuda_cg
    cuda_cg.reset_counters()
    res = trun.run_simulation(cfg, str(tmp_path / "m"), True,
                              output_folder=str(tmp_path / "o"),
                              watcher_points=trun.coupler_watcher_points(cfg),
                              write_xdmf=False, suppress_print=True,
                              device="cuda")
    assert np.isfinite(res.watcher).all()
    assert cuda_cg.cg_tol.launches_adi == cfg["timing"]["num_steps"]


@pytest.mark.cuda
def test_recording_sweep_on_cuda_launches_the_kernels(cfg, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from heatflow_tpu_torch.ops import cuda_sweep
    cuda_sweep.reset_counters()
    w = float(cfg["mats"]["p_sample"]["z"])
    results, failed = tsweep.run_parameter_sweep(
        cfg, str(tmp_path / "s"), (4e-6, 8e-6), (2.0, 6.0), (w, w),
        (2, 2, 1), base_mesh_folder=str(tmp_path / "m"),
        record_gradient=True, device="cuda")
    assert len(results) == 4 and not failed
    steps = cfg["timing"]["num_steps"]
    assert cuda_sweep.cg_batched_tol.launches_rline == steps
    assert cuda_sweep.cg_batched_tol.launches_no_kv == steps


def test_sweep_solver_routes_by_preconditioner():
    """'auto' sends float32 on a card to the batched kernels for every form
    they have (ADI included) and a preconditioner they lack to the eager
    path; the float64 CPU default stays eager."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    kw = dict(f64_refine=0, record_gradient=False)
    route = lambda pre, dev=cuda, dt=torch.float32: tsweep._resolve_solver(
        "auto", dtype=dt, device=dev, precondition=pre, **kw)
    assert [route(p) for p in ("jacobi", "rline", "adi", "adaptive")] == \
        ["vmem"] * 4
    assert route("mg") == route("zline") == "xla"
    assert route("adi", cpu, torch.float64) == "xla"
    assert tsweep._resolve_solver("vmem", dtype=torch.float64, device=cpu,
                                  precondition="adi", **kw) == "vmem"


def test_sweep_with_adi_on_the_batched_kernel(cfg, tmp_path):
    """``--precondition adi`` with the kernels' solver (their plain versions
    on the CPU): every run succeeds, and its traces are those of the eager
    ADI sweep within the float64 solve tolerance."""
    w = float(cfg["mats"]["p_sample"]["z"])
    runs = {}
    for solver in ("vmem", "xla"):
        out = tmp_path / solver
        results, failed = tsweep.run_parameter_sweep(
            cfg, str(out), (4e-6, 8e-6), (2.0, 6.0), (w, w), (1, 2, 1),
            base_mesh_folder=str(tmp_path / "m"), solver=solver,
            precondition="adi", rtol=1e-10, device="cpu")
        assert len(results) == 2 and not failed
        runs[solver] = {r["run_name"]: read_watcher_csv(
            str(out / r["run_name"] / "watcher_points.csv")) for r in results}
        meta = json.load(open(out / "sweep_metadata.json"))
        assert meta["precondition"] == "adi"
        assert set(meta["solver_resolved"].values()) == {solver}
    for name, cols in runs["vmem"].items():
        for key, v in cols.items():
            want = runs["xla"][name][key]
            assert np.abs(v - want).max() <= 1e-8 * np.abs(want).max()


# ----------------------------------------------------------------------
# the 1D driver: 2D recording run -> gradient CSV -> 1D run
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The fixture of tests/test_pipeline_2d_to_1d.py, its 2D run and its
    gradient CSV made by the port's own ``run2d``."""
    root = tmp_path_factory.mktemp("pipe")
    heat = root / "heat.csv"
    synthetic_heating(heat)
    c = tiny_no_diamond_cfg(coarse=2.0)
    c["heating"]["file"] = str(heat)
    c["timing"]["num_steps"] = 6
    mesh_folder, out2d = str(root / "meshes"), str(root / "out2d")
    wp = coupler_watcher_points(c)
    trun.run_simulation(c, mesh_folder, rebuild_mesh=True,
                        output_folder=out2d, watcher_points=wp,
                        write_xdmf=False, suppress_print=True, device="cpu")
    return c, mesh_folder, out2d, root, wp


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("correction", [True, False])
def test_run_1d_matches_jax(pipeline, correction):
    c, mesh_folder, out2d, root, wp = pipeline
    grad = os.path.join(out2d, "radial_gradient.csv")
    outs = {}
    for tag, fn, kw in (("j", jrun1d.run_1d, {}),
                        ("t", trun1d.run_1d, {"device": "cpu"})):
        out = str(root / f"o1_{tag}_{correction}")
        problem, ys = fn(c, mesh_folder, output_folder=out,
                         watcher_points=wp, write_xdmf=False,
                         suppress_print=True,
                         use_radial_correction=correction,
                         radial_gradient_path=grad, **kw)
        outs[tag] = (out, problem, ys)
    (oj, pj, yj), (ot, pt, yt) = outs["j"], outs["t"]
    assert isinstance(yt["watch"], np.ndarray)
    assert _rel_l2(yt["watch"], yj["watch"]) < 1e-8
    assert _rel_l2(yt["final_u"], yj["final_u"]) < 1e-8
    assert (pt.gradient is not None) == (pj.gradient is not None) \
        == correction
    _csv_close(os.path.join(ot, "watcher_points.csv"),
               os.path.join(oj, "watcher_points.csv"))
    assert os.path.isfile(os.path.join(ot, "used_config.yaml"))
    assert list(read_watcher_csv(os.path.join(ot, "watcher_points.csv"))) \
        == ["time", "pside", "oside"]


def test_run_1d_correction_toggle_and_list_watchers(pipeline):
    c, mesh_folder, out2d, root, wp = pipeline
    grad = os.path.join(out2d, "radial_gradient_raw.csv")
    as_list = [{"name": k, "coords": list(v)} for k, v in wp.items()]
    p_on, on = trun1d.run_1d(c, mesh_folder, watcher_points=as_list,
                             write_xdmf=False, suppress_print=True,
                             output_folder=str(root / "on"),
                             radial_gradient_path=grad, device="cpu")
    _, off = trun1d.run_1d(c, mesh_folder, watcher_points=wp,
                           write_xdmf=False, suppress_print=True,
                           output_folder=str(root / "off"),
                           use_radial_correction=False, device="cpu")
    assert np.abs(on["watch"] - off["watch"]).max() > 1e-6
    assert p_on.gradient.delta_r == 0.07e-6       # the raw CSV's radius
    with pytest.raises(ValueError, match="watcher_points"):
        trun1d.run_1d(c, mesh_folder, watcher_points="pside",
                      write_xdmf=False, suppress_print=True,
                      output_folder=str(root / "bad"), device="cpu")


def test_run_1d_missing_gradient_falls_back(pipeline, tmp_path, monkeypatch):
    """No gradient file anywhere: the correction switches itself off and the
    run equals the uncorrected one."""
    c, mesh_folder, _, root, wp = pipeline
    monkeypatch.chdir(tmp_path)
    _, ys = trun1d.run_1d(c, mesh_folder, watcher_points=wp,
                          write_xdmf=False, suppress_print=True,
                          output_folder=str(tmp_path / "fb"), device="cpu")
    _, off = trun1d.run_1d(c, mesh_folder, watcher_points=wp,
                           write_xdmf=False, suppress_print=True,
                           output_folder=str(tmp_path / "off"),
                           use_radial_correction=False, device="cpu")
    assert np.isfinite(ys["watch"]).all()
    np.testing.assert_array_equal(ys["watch"], off["watch"])


def test_find_gradient_csv_order_matches_jax(tmp_path, monkeypatch):
    """Named run directories first (both CSV kinds, smoothed before raw),
    then any run directory; the same answer as the JAX driver at each
    stage."""
    monkeypatch.chdir(tmp_path)
    mesh = tmp_path / "meshes" / "m"
    os.makedirs(mesh)

    def both():
        got = trun1d._find_gradient_csv(str(mesh), config_name="mine")
        assert got == jrun1d._find_gradient_csv(str(mesh), config_name="mine")
        return got

    assert both() is None
    other = tmp_path / "meshes" / "outputs" / "zzz"
    os.makedirs(other)
    (other / "radial_gradient.csv").write_text("x")
    assert both().endswith(os.path.join("zzz", "radial_gradient.csv"))
    canon = tmp_path / "outputs" / "geballe_no_diamond_read_flux"
    os.makedirs(canon)
    (canon / "radial_gradient_raw.csv").write_text("x")
    assert both().endswith(os.path.join("geballe_no_diamond_read_flux",
                                        "radial_gradient_raw.csv"))
    mine = tmp_path / "sim_outputs" / "mine"
    os.makedirs(mine)
    (mine / "radial_gradient_raw.csv").write_text("x")
    assert "geballe_no_diamond_read_flux" in both()   # an earlier base wins
    (mine / "radial_gradient.csv").write_text("x")
    assert both().endswith(os.path.join("mine", "radial_gradient.csv"))


def test_run_1d_defaults_to_the_card_and_unported_meshes_raise(pipeline,
                                                               tmp_path):
    """An unstructured 2D mesh gives the 1D model its axis by the facet
    scan (as many nodes as the structured mesh of the same stack, its z
    jittered); an empty imported file is no mesh; without a card the
    default raises."""
    c, mesh_folder, _, _, wp = pipeline
    pu, yu = trun1d.run_1d(c, str(tmp_path / "u"), rebuild_mesh=True,
                           mesh_style="unstructured", device="cpu",
                           use_radial_correction=False, watcher_points=wp,
                           output_folder=str(tmp_path / "ou"),
                           write_xdmf=False, suppress_print=True)
    ps, ys = trun1d.run_1d(c, mesh_folder, device="cpu", watcher_points=wp,
                           use_radial_correction=False, write_xdmf=False,
                           output_folder=str(tmp_path / "os"),
                           suppress_print=True)
    assert len(pu.z) == len(ps.z) and not np.array_equal(pu.z, ps.z)
    assert yu["watch"].shape == ys["watch"].shape
    assert np.isfinite(yu["watch"]).all()
    os.makedirs(tmp_path / "m")
    open(tmp_path / "m" / "mesh.msh", "w").close()
    open(tmp_path / "m" / "mesh_cfg.yaml", "w").write("material_tags: {}\n")
    with pytest.raises(ValueError, match="MeshFormat"):
        trun1d.run_1d(c, str(tmp_path / "m"), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun1d.run_1d(c, mesh_folder, watcher_points=wp, write_xdmf=False)


def test_run1d_cli_without_jax_pandas_yaml(pipeline, tmp_path):
    """The 1D CLI in a subprocess with jax, jaxlib, pandas and yaml blocked,
    against the JAX driver's traces; --watcher-points as JSON."""
    c, mesh_folder, out2d, _, wp = pipeline
    from heatflow_tpu_torch.config import save_config
    cfg_path = tmp_path / "one_d.yaml"
    save_config(c, str(cfg_path))
    grad = os.path.join(out2d, "radial_gradient.csv")
    points = json.dumps({k: list(v) for k, v in wp.items()})
    code = f"""
import sys
for name in ("jax", "jaxlib", "pandas", "yaml"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
from heatflow_tpu_torch.drivers import run1d
run1d.main(["--config", {str(cfg_path)!r}, "--mesh-folder-2d",
            {mesh_folder!r}, "--output-folder", {str(tmp_path / "cli")!r},
            "--radial-gradient-path", {grad!r}, "--device", "cpu"])
run1d.main(["--config", {str(cfg_path)!r}, "--mesh-folder-2d",
            {mesh_folder!r}, "--output-folder", {str(tmp_path / "cli_off")!r},
            "--no-radial-correction", "--watcher-points", {points!r},
            "--device", "cpu", "--suppress-print"])
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "heatflow_tpu", "pandas",
                              "yaml") and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "Radial heating correction: ENABLED" in proc.stdout
    _, yj = jrun1d.run_1d(c, mesh_folder, output_folder=str(tmp_path / "j"),
                          watcher_points=wp, write_xdmf=False,
                          suppress_print=True, radial_gradient_path=grad)
    got = read_watcher_csv(str(tmp_path / "cli" / "watcher_points.csv"))
    off = read_watcher_csv(str(tmp_path / "cli_off" / "watcher_points.csv"))
    assert list(got) == list(off) == ["time", "pside", "oside"]
    cols = np.column_stack([got["pside"], got["oside"]])
    assert _rel_l2(cols, yj["watch"]) < 1e-8
    assert np.abs(cols - np.column_stack([off["pside"],
                                          off["oside"]])).max() > 1e-6

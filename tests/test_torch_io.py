"""The port's host I/O against the JAX package: CSV writers and readers,
``save_config`` (with PyYAML and with it blocked), ``load_config`` of a
``mesh_cfg.yaml``, ``write_msh``, checkpoints, ``save_params``, XDMF, the
config and mesh helpers and ``utils``."""

import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu import config as jcfg, utils as jutils
from heatflow_tpu.io import checkpoint as jckpt, csvio as jcsv
from heatflow_tpu.io import runmeta as jmeta, xdmfio as jxdmf
from heatflow_tpu.mesh import msh_io as jmsh
from heatflow_tpu.mesh.structured import mesh_from_meta as j_from_meta
from heatflow_tpu.sim.problem import radial_band_analysis as j_band
from heatflow_tpu_torch import config as tcfg, utils as tutils
from heatflow_tpu_torch.io import checkpoint as tckpt, csvio as tcsv
from heatflow_tpu_torch.io import runmeta as tmeta, xdmfio as txdmf
from heatflow_tpu_torch.mesh import msh_io as tmsh
from heatflow_tpu_torch.mesh.structured import mesh_from_meta as t_from_meta
from heatflow_tpu_torch.sim.problem import radial_band_analysis as t_band
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(os.path.join(ROOT, "cfgs", f)
              for f in os.listdir(os.path.join(ROOT, "cfgs"))
              if f.endswith(".yaml"))


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def _values(dtype):
    rng = np.random.default_rng(1)
    v = rng.standard_normal((7, 4)) * 10.0 ** rng.integers(-9, 9, (7, 4))
    v[2, 1] = np.nan
    v[3, 2], v[4, 0] = np.inf, 300.0
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csv_writers_match_pandas_bytes(tmp_path, dtype):
    v = _values(dtype)
    times = (np.arange(1, 8) * 2.5e-7).astype(dtype)
    traces = {"pside": v[:, 0], "oside": v[:, 1], "a, b": v[:, 2]}
    for mod in (jcsv, tcsv):
        mod.write_watcher_csv(str(tmp_path / f"w_{mod.__name__}.csv"), times,
                              traces)
        mod.write_gradient_csv(str(tmp_path / f"g_{mod.__name__}.csv"),
                               times, np.array([1e-7, 2.5e-7, 3e-6, 1.0]),
                               v)
    for kind in ("w", "g"):
        _same_bytes(tmp_path / f"{kind}_{jcsv.__name__}.csv",
                    tmp_path / f"{kind}_{tcsv.__name__}.csv")
    # read back: the values exactly (the text is their shortest repr), and
    # the JAX readers' (pandas parses to within an ulp)
    got = tcsv.read_gradient_csv(str(tmp_path / f"g_{tcsv.__name__}.csv"))
    want = jcsv.read_gradient_csv(str(tmp_path / f"g_{tcsv.__name__}.csv"))
    for g, w, exact in zip(got, want, (times, [1e-7, 2.5e-7, 3e-6, 1.0], v)):
        np.testing.assert_array_equal(g.astype(dtype),
                                      np.asarray(exact, dtype))
        np.testing.assert_allclose(g, w, rtol=1e-12)
    cols = tcsv.read_watcher_csv(str(tmp_path / f"w_{tcsv.__name__}.csv"))
    df = jcsv.read_watcher_csv(str(tmp_path / f"w_{tcsv.__name__}.csv"))
    assert list(cols) == list(df.columns) == ["time", *traces]
    for name, exact in zip(cols, (times, *traces.values())):
        np.testing.assert_array_equal(cols[name].astype(dtype), exact)
        np.testing.assert_allclose(cols[name], df[name].to_numpy(),
                                   rtol=1e-12)


def _config_cases():
    cases = [yaml.safe_load(open(p)) for p in CFGS]
    cfg = tiny_no_diamond_cfg()
    cfg["heating"]["file"] = "/data/run 1/heat.csv"
    mesh = J.build_structured_mesh(*J.build_layout(cfg))
    cases.append(dict(cfg, material_tags=dict(mesh.material_tags),
                      structured_grid=mesh.to_meta()))
    cases.append({"a": {"e": "", "q": "1.0", "n": "no", "x": "-x",
                        "c": "a:b", "h": "a #b", "s": "it's", "hex": "0x1f",
                        "big": 1e16, "neg": -2.5e-300, "i": -3, "t": True,
                        "z": None, "d": {}, "l": [], "inf": float("inf")}})
    return cases


@pytest.mark.parametrize("block_yaml", [False, True],
                         ids=["pyyaml", "no-pyyaml"])
def test_save_config_matches_jax_bytes(tmp_path, monkeypatch, block_yaml):
    cases = _config_cases()
    for i, cfg in enumerate(cases):
        jcfg.save_config(cfg, str(tmp_path / f"j{i}.yaml"))
    if block_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    for i, cfg in enumerate(cases):
        tcfg.save_config(cfg, str(tmp_path / f"t{i}.yaml"))
        _same_bytes(tmp_path / f"j{i}.yaml", tmp_path / f"t{i}.yaml")
        # and the port reads what it wrote back exactly
        assert tcfg.load_config(str(tmp_path / f"t{i}.yaml")) == cfg


@pytest.mark.parametrize("block_yaml", [False, True],
                         ids=["pyyaml", "no-pyyaml"])
def test_load_config_reads_mesh_cfg_back(tmp_path, monkeypatch, block_yaml):
    """The mesh_cfg.yaml the JAX driver writes (block sequences of floats)
    reads back exactly."""
    from heatflow_tpu.drivers.run2d import _prepare_mesh
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    _prepare_mesh(cfg, str(tmp_path), True, "auto")
    path = str(tmp_path / "mesh_cfg.yaml")
    want = yaml.safe_load(open(path))
    if block_yaml:
        monkeypatch.setitem(sys.modules, "yaml", None)
    got = tcfg.load_config(path)
    assert got == want
    assert isinstance(got["structured_grid"]["z"], list)
    mesh = t_from_meta(got["structured_grid"],
                       T.build_layout(cfg)[1])
    ref = j_from_meta(want["structured_grid"], J.build_layout(cfg)[1])
    for name in ("z", "r", "cell_tags"):
        np.testing.assert_array_equal(getattr(mesh, name), getattr(ref, name))
    assert mesh.material_tags == ref.material_tags


def test_config_helpers_match_jax():
    cfg = tiny_no_diamond_cfg()
    for kw in (dict(fwhm=5e-6), dict(sample_k=2), dict(sample_z=1e-6),
               dict(fwhm=4e-6, sample_k=7.5, sample_z=2e-6)):
        got = tcfg.with_parameters(cfg, **kw)
        assert got == jcfg.with_parameters(cfg, **kw)
        assert got is not cfg and cfg == tiny_no_diamond_cfg()
    other = tcfg.with_parameters(cfg, fwhm=1e-6)
    for a, b in ((cfg, cfg), (cfg, other), ({"a": [1.0]}, {"a": [1.0]}),
                 ({"a": 1}, {"a": 1.0})):
        assert tcfg.config_equal(a, b) == jcfg.config_equal(a, b)


def test_write_msh_and_band_analysis_match_jax(tmp_path):
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    mesh = T.build_structured_mesh(*T.build_layout(cfg))
    tris, tags = mesh.triangles()
    jmsh.write_msh(str(tmp_path / "j.msh"), mesh.node_coords(), tris, tags,
                   mesh.material_tags)
    tmsh.write_msh(str(tmp_path / "t.msh"), mesh.node_coords(), tris, tags,
                   mesh.material_tags)
    _same_bytes(tmp_path / "j.msh", tmp_path / "t.msh")
    back = jmsh.read_msh(str(tmp_path / "t.msh"))
    np.testing.assert_array_equal(back.cells, tris)
    for width in (0.1e-6, 1e-6, 1e-12):
        got, want = t_band(mesh, width), j_band(mesh, width)
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k] == want[k]
                    or (np.isnan(got[k]) and np.isnan(want[k]))), k


def test_checkpoint_and_params_match_jax_bytes(tmp_path, monkeypatch):
    # the .npz is a zip whose entries carry the time they were written
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    u = np.random.default_rng(2).standard_normal((5, 7))
    for name, mod in (("j", jckpt), ("t", tckpt)):
        mod.save_checkpoint(str(tmp_path / name), u, 3.5e-6, step=12,
                            extra={"iters": np.arange(3)})
    _same_bytes(tmp_path / "j" / "checkpoint.npz",
                tmp_path / "t" / "checkpoint.npz")
    got = tckpt.load_checkpoint(str(tmp_path / "j"))
    want = jckpt.load_checkpoint(str(tmp_path / "j"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3] == (3.5e-6, 12)
    np.testing.assert_array_equal(got[3]["iters"], want[3]["iters"])
    tckpt.save_checkpoint(str(tmp_path / "n"), u, 0.0)
    assert tckpt.load_checkpoint(str(tmp_path / "n"))[2] is None
    params = {"k": 3.8, "fwhm": 1e-06, "name": "run", "n": 40}
    jmeta.save_params(str(tmp_path / "j"), params)
    tmeta.save_params(str(tmp_path / "t"), params)
    _same_bytes(tmp_path / "j" / "params.txt", tmp_path / "t" / "params.txt")


def test_xdmf_matches_jax(tmp_path):
    import h5py
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    mesh = T.build_structured_mesh(*T.build_layout(cfg))
    tris, _ = mesh.triangles()
    fields = np.random.default_rng(4).standard_normal((3, mesh.num_nodes))
    for name, mod in (("j", jxdmf), ("t", txdmf)):
        w = mod.XDMFTimeSeriesWriter(str(tmp_path / f"{name}.xdmf"),
                                     mesh.node_coords(), tris)
        for s in range(3):
            w.write(fields[s], 1e-7 * s)
        w.close()
    assert open(tmp_path / "j.xdmf").read().replace("j.h5", "t.h5") == \
        open(tmp_path / "t.xdmf").read()
    with h5py.File(tmp_path / "j.h5") as fj, h5py.File(tmp_path / "t.h5") as ft:
        names = []
        fj.visit(names.append)
        got = []
        ft.visit(got.append)
        assert names == got
        for n in names:
            if isinstance(fj[n], h5py.Dataset):
                np.testing.assert_array_equal(fj[n][()], ft[n][()])
    got = txdmf.read_xdmf_timeseries(str(tmp_path / "j.xdmf"))
    want = jxdmf.read_xdmf_timeseries(str(tmp_path / "t.xdmf"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pts = mesh.node_coords()[[0, 17]]
    for g, w in zip(txdmf.extract_point_timeseries_xdmf(
            str(tmp_path / "t.xdmf"), "Temperature (K)", pts),
            jxdmf.extract_point_timeseries_xdmf(
                str(tmp_path / "t.xdmf"), "Temperature (K)", pts)):
        np.testing.assert_array_equal(g, w)


def test_xdmf_without_h5py_raises_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        txdmf.XDMFTimeSeriesWriter(str(tmp_path / "x.xdmf"),
                                   np.zeros((3, 2)), np.array([[0, 1, 2]]))


def test_utils_match_jax(tmp_path):
    for arr, m in (([1, 2, 3], 4), ([1.5], 1), ([1, 2, 3, 4], 2), ([7], 3)):
        np.testing.assert_array_equal(tutils.pad_to_multiple(arr, m),
                                      jutils.pad_to_multiple(arr, m))
    dtypes = ((torch.float32, jnp.float32), (torch.float64, jnp.float64))
    for rec in (False, True):
        for tdt, jdt in dtypes:
            for kw in (dict(), dict(batched=True), dict(unstructured=True),
                       dict(fixed_iters=50), dict(unstructured_xla=True),
                       dict(f64_refine=1), dict(f64_refine=1,
                                                vmem_single=True),
                       dict(rtol_wrt="b")):
                assert tutils.resolve_recording_precondition(
                    rec, tdt, **kw) == \
                    jutils.resolve_recording_precondition(rec, jdt, **kw), kw
    with tutils.profile_trace(str(tmp_path / "prof")):
        with tutils.span("sweep.chunk"):
            torch.ones(3).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    # the span is in the exported trace by name, as a host operator
    assert [e["cat"] for e in trace["traceEvents"]
            if e.get("name") == "sweep.chunk"] == ["cpu_op"]
    with tutils.profile_trace(None):
        pass

"""Unstructured sweeps sharded over gloo ranks (the twin of the sharding
cases of tests/test_unstructured_sharding.py): the overlay kernel sweep,
the eager sweep, the time-chunked runner and the sweep driver over 'config'
(4 CPU ranks for the makers, the sweep CLI's own for its path), each bit
for bit the port's unsharded run and within 1e-11 of the JAX package's.
A 'z' axis replicates the unstructured engines (each rank of a z group runs
its config shard whole), as in the JAX package."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.mesh.unstructured_gen import \
    build_unstructured_mesh as j_umesh
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.unstructured import \
    build_problem_unstructured as j_build
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

KS8, FS8 = np.linspace(2.0, 8.0, 8), np.linspace(4e-6, 9e-6, 8)
KS5, FS5 = np.linspace(2.0, 8.0, 5), np.linspace(4e-6, 9e-6, 5)
F64 = torch.float64


def _cfg():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 5
    return cfg


def _heating():
    df = synthetic_heating()
    return df["time"].to_numpy(), df["temp"].to_numpy()


def _t_problem():
    import heatflow_tpu_torch as T
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.mesh.unstructured_gen import \
        build_unstructured_mesh
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.unstructured import \
        build_problem_unstructured
    cfg = _cfg()
    t, temp = _heating()
    umesh = build_unstructured_mesh(*T.build_layout(cfg), jitter=0.25,
                                    seed=7)
    return build_problem_unstructured(
        umesh, HeatingCurve(time=t, temp=temp), cfg,
        watcher_points=coupler_watcher_points(cfg))


CASES = {
    "vmem": dict(fixed_iters=12, solver="vmem"),
    "xla": dict(fixed_iters=12),
    "rec": dict(rtol=1e-10, solver="vmem", record_gradient=True),
}


def _rank4() -> dict:
    """One of 4 gloo ranks: the makers over (config 4) and, for the eager
    sweep, over (config 2, z 2); the chunked runner with 5 configs padded
    to 8."""
    from heatflow_tpu_torch.parallel.sharding import config_mesh
    from heatflow_tpu_torch.sim.sweepkernel import run_sweep_time_chunked
    from heatflow_tpu_torch.sim.unstructured import \
        make_sweep_fn_unstructured
    m4 = config_mesh(device="cpu")
    m22 = config_mesh(z_shards=2, device="cpu")
    p = _t_problem()
    out = {}
    for name, kw in CASES.items():
        res = make_sweep_fn_unstructured(p, dtype=F64, mesh=m4,
                                         **kw)(KS8, FS8)
        out[name] = ({k: res[k].numpy() for k in ("watch", "band", "axis")}
                     if isinstance(res, dict) else res.numpy())
    out["xla_z"] = make_sweep_fn_unstructured(
        p, dtype=F64, mesh=m22, **CASES["xla"])(KS8, FS8).numpy()
    out["chunked"] = run_sweep_time_chunked(
        p, KS5, FS5, step_chunk=2, dtype=F64, fixed_iters=8, solver="vmem",
        mesh=m4)
    return out


@pytest.fixture(scope="module")
def ranks():
    from heatflow_tpu_torch.parallel.sharding import spawn
    return spawn(_rank4, 4, device="cpu", timeout=120.0)


@pytest.fixture(scope="module")
def problems():
    cfg = _cfg()
    t, temp = _heating()
    pj = j_build(j_umesh(*J.build_layout(cfg), jitter=0.25, seed=7),
                 JHeating(time=t, temp=temp), cfg,
                 watcher_points=j_watch(cfg))
    return pj, _t_problem()


def _close(got, want, tol=1e-11):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _unsharded(p, name):
    from heatflow_tpu_torch.sim.unstructured import \
        make_sweep_fn_unstructured
    res = make_sweep_fn_unstructured(p, dtype=F64, device="cpu",
                                     **CASES[name])(KS8, FS8)
    return ({k: res[k].numpy() for k in ("watch", "band", "axis")}
            if isinstance(res, dict) else res.numpy())


@pytest.mark.parametrize("name", ["vmem", "xla", "rec"])
def test_unstructured_sweep_sharded_matches_unsharded(ranks, problems,
                                                      name):
    """Each engine over 4 ranks: the same full result on every rank, bitwise
    the port's unsharded run, within 1e-11 of the JAX package's (the
    recording's families within 1e-8, tests/test_multihost.py's bound for
    recordings at rtol 1e-10)."""
    from heatflow_tpu.sim.unstructured import make_sweep_fn_unstructured
    pj, pt = problems
    want = _unsharded(pt, name)
    for r in ranks:
        got = r[name]
        if isinstance(want, dict):
            for k in want:
                assert np.array_equal(got[k], want[k]), k
        else:
            assert np.array_equal(got, want)
    j = make_sweep_fn_unstructured(pj, dtype=jnp.float64,
                                   **CASES[name])(KS8, FS8)
    if isinstance(want, dict):
        for k in ("watch", "band", "axis"):
            _close(ranks[0][name][k], np.asarray(j[k]), 1e-8)
    else:
        _close(ranks[0][name], np.asarray(j))


def test_unstructured_sweep_replicated_over_z(ranks, problems):
    """A (config 2, z 2) mesh: the eager unstructured sweep shards the
    configs and replicates over 'z', bitwise the unsharded run."""
    want = _unsharded(problems[1], "xla")
    for r in ranks:
        assert np.array_equal(r["xla_z"], want)


def test_unstructured_time_chunked_sharded(ranks, problems):
    """The chunked runner over the overlay kernels, 5 configs padded to 8
    and cut back: bitwise its unsharded run, within 1e-11 of the JAX
    package's."""
    from heatflow_tpu.sim.sweepkernel import run_sweep_time_chunked as j_run
    from heatflow_tpu_torch.sim.sweepkernel import run_sweep_time_chunked
    pj, pt = problems
    kw = dict(step_chunk=2, fixed_iters=8, solver="vmem")
    want = run_sweep_time_chunked(pt, KS5, FS5, dtype=F64, device="cpu",
                                  **kw)
    got = ranks[0]["chunked"]
    assert got.shape == want.shape == (5, pt.num_steps, 2)
    assert np.array_equal(got, want)
    _close(got, j_run(pj, KS5, FS5, dtype=jnp.float64, **kw))


def test_driver_unstructured_sharded_honest_metadata(tmp_path):
    """run_parameter_sweep over 2 CPU devices on prepared unstructured width
    folders: the per-run CSVs equal the one-device run's; the metadata
    records the sharding."""
    from heatflow_tpu_torch.config import with_parameters
    from heatflow_tpu_torch.drivers.run2d import _prepare_mesh
    from heatflow_tpu_torch.drivers.sweep import (mesh_folder_for_width,
                                                  run_parameter_sweep)
    cfg = _cfg()
    heat = tmp_path / "heat.csv"
    synthetic_heating(heat)
    cfg["heating"]["file"] = str(heat)
    width = 1.84e-6
    kw = dict(fwhm_range=(4e-6, 9e-6), k_range=(2.0, 8.0),
              width_range=(width, width), num_points=(2, 3, 1),
              suppress_print=True, dtype=F64, save_run_dirs=True)
    for base in ("m1", "m2"):
        _prepare_mesh(with_parameters(cfg, sample_z=width),
                      mesh_folder_for_width(str(tmp_path / base), width),
                      True, "auto", "unstructured")
    out1, out2 = str(tmp_path / "single"), str(tmp_path / "sharded")
    r1, f1 = run_parameter_sweep(cfg, out1, base_mesh_folder=str(
        tmp_path / "m1"), devices=["cpu"], **kw)
    r2, f2 = run_parameter_sweep(cfg, out2, base_mesh_folder=str(
        tmp_path / "m2"), devices=["cpu", "cpu"], **kw)
    assert len(r1) == len(r2) == 6 and not f1 and not f2
    for a, b in zip(r1, r2):
        assert a["run_name"] == b["run_name"]
        with open(f"{out1}/{a['run_name']}/watcher_points.csv") as fa, \
                open(f"{out2}/{b['run_name']}/watcher_points.csv") as fb:
            assert fa.read() == fb.read()
    meta = json.load(open(f"{out2}/sweep_metadata.json"))
    assert "sharded over 2 devices" in meta["engine"]
    assert meta["devices"] == ["cpu", "cpu"]

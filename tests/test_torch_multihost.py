"""The port's multi-process sweep (``parallel.multihost``) against the JAX
package's: two processes join one gloo group through ``initialize`` over
tcp:// on localhost (the twin of tests/test_multihost.py), run the
structured, recording and unstructured sweeps with ``run_sweep_multihost``
and get the full traces back on both. Held to the JAX package's unsharded
runs with its test's bounds and bit for bit to the port's own unsharded
runs."""

import os
import socket

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

WP = {"p": (0.0, 0.0), "o": (1e-6, 0.0)}
KS, FS = np.linspace(2.0, 8.0, 6), np.linspace(4e-6, 9e-6, 6)  # 6 → pad 8
F64 = torch.float64


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfg(heat_csv):
    from tests.fixtures import tiny_no_diamond_cfg
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["heating"]["file"] = heat_csv
    cfg["timing"]["num_steps"] = 4
    return cfg


def _t_problems(heat_csv):
    """(structured, unstructured) problems of the port."""
    import heatflow_tpu_torch as T
    from heatflow_tpu_torch.mesh.unstructured_gen import \
        build_unstructured_mesh
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem
    from heatflow_tpu_torch.sim.unstructured import \
        build_problem_unstructured
    cfg = _cfg(heat_csv)
    domain, mats = T.build_layout(cfg)
    heating = HeatingCurve.from_csv(heat_csv)
    p = build_problem(T.build_structured_mesh(domain, mats), heating, cfg,
                      watcher_points=WP)
    up = build_problem_unstructured(
        build_unstructured_mesh(domain, mats, jitter=0.25, seed=7), heating,
        cfg, watcher_points=WP)
    return p, up


def _runs(run, p, up) -> dict:
    """The module's sweeps through ``run(problem, **kw)``."""
    return dict(
        traces=run(p, fixed_iters=10, dtype=F64),
        rec=run(p, dtype=F64, rtol=1e-10, maxiter=4000,
                record_gradient=True),
        utraces=run(up, fixed_iters=10, dtype=F64),
        rtraces=run(up, dtype=torch.float32, rtol=1e-5, maxiter=4000,
                    solver="vmem", f64_refine=2),
        utruth=run(up, dtype=F64, rtol=1e-11, maxiter=8000, solver="vmem"))


def _rank(port: int, heat_csv: str) -> dict:
    """One of the two processes: the same program on both."""
    from heatflow_tpu_torch.parallel import multihost
    multihost.initialize(f"localhost:{port}", 2, int(os.environ["RANK"]),
                         device="cpu")
    import torch.distributed as dist
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    p, up = _t_problems(heat_csv)
    out = _runs(lambda prob, **kw: multihost.run_sweep_multihost(
        prob, KS, FS, device="cpu", **kw), p, up)
    mesh = multihost.global_config_mesh(device="cpu")
    out["round_trip"] = multihost.gather_to_all(
        mesh, multihost.distribute_batch(mesh, np.arange(8.0)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from heatflow_tpu_torch.parallel.sharding import spawn
    from tests.fixtures import synthetic_heating
    heat_csv = str(tmp_path_factory.mktemp("mh") / "heat.csv")
    synthetic_heating(heat_csv)
    got = spawn(_rank, 2, init=False, device="cpu", timeout=120.0,
                args=(_free_port(), heat_csv))
    return heat_csv, got


def _fields(x):
    return x if isinstance(x, dict) else {"traces": x}


def test_two_process_sweeps_equal_on_both_and_unsharded(runs):
    """Both processes hold the same full results, bitwise the port's
    unsharded runs of the same batch."""
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                    make_sweep_fn_recording)
    heat_csv, got = runs
    p, up = _t_problems(heat_csv)

    def run(prob, record_gradient=False, **kw):
        make = make_sweep_fn_recording if record_gradient else make_sweep_fn
        out = make(prob, device="cpu", **kw)(KS, FS)
        return ({k: out[k].numpy() for k in ("watch", "band", "axis")}
                if isinstance(out, dict) else out.numpy())

    want = _runs(run, p, up)
    for name, w in want.items():
        for r in got:
            g = _fields(r[name])
            for k, v in _fields(w).items():
                assert g[k].shape == v.shape, (name, k)
                assert np.array_equal(g[k], v), (name, k)
    assert got[0]["traces"].shape == (6, 4, 2)
    for r in got:       # each process's shard of a batch, gathered
        assert np.array_equal(r["round_trip"], np.arange(8.0))
    assert got[0]["rec"]["band"].shape[0] == 6
    np.testing.assert_array_equal(got[0]["rec"]["times"],
                                  np.arange(1, 5) * p.dt)


def test_two_process_sweep_matches_jax_single_process(runs):
    """The gathered traces against the JAX package's single-process runs
    (tests/test_multihost.py's bounds: 1e-11 structured and unstructured,
    1e-8 recording), and the refined float32 overlay sweep within 1e-3 K of
    its float64 run."""
    import jax.numpy as jnp
    import heatflow_tpu as J
    from heatflow_tpu.mesh.unstructured_gen import build_unstructured_mesh
    from heatflow_tpu.sim.bc import HeatingCurve
    from heatflow_tpu.sim.problem import build_problem
    from heatflow_tpu.sim.sweepkernel import (make_sweep_fn,
                                              make_sweep_fn_recording)
    from heatflow_tpu.sim.unstructured import (build_problem_unstructured,
                                               make_sweep_fn_unstructured)
    heat_csv, got = runs
    cfg = _cfg(heat_csv)
    domain, mats = J.build_layout(cfg)
    heating = HeatingCurve.from_csv(heat_csv)
    problem = build_problem(J.build_structured_mesh(domain, mats), heating,
                            cfg, watcher_points=WP)
    g = got[0]
    ref = np.asarray(make_sweep_fn(problem, dtype=jnp.float64,
                                   fixed_iters=10)(KS, FS))
    np.testing.assert_allclose(g["traces"], ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())
    rec = make_sweep_fn_recording(problem, dtype=jnp.float64,
                                  rtol=1e-10)(KS, FS)
    for key in ("watch", "band", "axis"):
        r = np.asarray(rec[key])
        np.testing.assert_allclose(g["rec"][key], r, rtol=1e-8,
                                   atol=1e-8 * max(1.0, np.abs(r).max()))
    uproblem = build_problem_unstructured(
        build_unstructured_mesh(domain, mats, jitter=0.25, seed=7), heating,
        cfg, watcher_points=WP)
    uref = np.asarray(make_sweep_fn_unstructured(
        uproblem, dtype=jnp.float64, fixed_iters=10)(KS, FS))
    np.testing.assert_allclose(g["utraces"], uref, rtol=1e-11,
                               atol=1e-11 * np.abs(uref).max())
    assert g["rtraces"].shape == (6, 4, 2)
    assert np.isfinite(g["rtraces"]).all()
    assert np.abs(g["rtraces"] - g["utruth"]).max() < 1e-3

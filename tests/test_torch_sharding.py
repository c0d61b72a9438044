"""The port's multi-device execution (``heatflow_tpu_torch.parallel``) against
the JAX package: twins of tests/test_sharding.py run on gloo ranks (4 CPU
processes, one spawn for the ('config', 'z') cases) instead of 8 virtual
devices. The JAX side runs unsharded (its own tests hold its sharded runs
to that within 1e-11); the config axis is held bit for bit to the port's
own unsharded run, the z axis to the JAX tests' bounds. The rank bodies
live in this module (spawned ranks import it by name)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.ops.stencil import apply_stencil as j_apply
from heatflow_tpu.ops.stencil import assemble_stencils as j_assemble
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu_torch.ops.stencil import apply_stencil, combine_operator
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

WP = {"p": (0.0, 0.0), "o": (1e-6, 0.0)}
KS8, FS8 = np.linspace(2.0, 8.0, 8), np.linspace(4e-6, 9e-6, 8)
KS5, FS5 = np.linspace(2.0, 8.0, 5), np.linspace(4e-6, 9e-6, 5)
F64 = torch.float64
SPAWN_S = 120.0


def _cfg():
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 5
    return cfg


def _t_problem():
    df = synthetic_heating()
    cfg = _cfg()
    return t_build_problem(T.build_structured_mesh(*T.build_layout(cfg)),
                           THeating(time=df["time"].to_numpy(),
                                    temp=df["temp"].to_numpy()), cfg,
                           watcher_points=WP)


def _operator_inputs():
    """test_sharding's stencil system and batched step inputs (numpy): A,
    u for the apply; per-config A, M_op, free, g, u for the step (Nz = 14
    divides by 2)."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    mesh = J.build_structured_mesh(*J.build_layout(cfg))
    pack = j_assemble(mesh, backend="numpy")
    kp = np.array([m.kappa for m in J.build_layout(cfg)[1]])
    rc = np.array([m.rho_cv for m in J.build_layout(cfg)[1]])
    nz, nr = mesh.shape
    A, _ = combine_operator(torch.as_tensor(pack.K), torch.as_tensor(pack.M),
                            torch.as_tensor(kp), torch.as_tensor(rc), 1e-7)
    u = np.random.default_rng(0).standard_normal((nz, nr))
    B = 8
    kb = np.tile(kp, (B, 1))
    kb[:, 2] *= np.linspace(0.5, 2.0, B)
    Ab, Mb = combine_operator(torch.as_tensor(pack.K),
                              torch.as_tensor(pack.M), torch.as_tensor(kb),
                              torch.as_tensor(np.tile(rc, (B, 1))), 1e-7)
    free = np.ones((nz, nr))
    free[0, :] = free[-1, :] = 0.0
    g = np.zeros((B, nz, nr))
    g[:, 0, :] = 350.0
    return dict(A=A.numpy(), u=u,
                step=(Ab.numpy(), Mb.numpy(), free, g,
                      np.full((B, nz, nr), 300.0)))


def _catch(call) -> str:
    try:
        call()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def _rank4() -> dict:
    """One of 4 gloo ranks: every case of the module on a (config 2, z 2)
    mesh, a (config 4, z 1) mesh and a (config 1, z 4) mesh; full results
    as numpy, errors as strings."""
    from heatflow_tpu_torch.parallel.sharding import (ZAxis,
                                                      batch_step_sharded,
                                                      config_mesh)
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                    run_sweep_time_chunked)
    m22 = config_mesh(z_shards=2, device="cpu")
    m41 = config_mesh(z_shards=1, device="cpu")
    m14 = config_mesh(z_shards=4, device="cpu")
    inp = _operator_inputs()
    p = _t_problem()
    out = {}
    A, u = torch.as_tensor(inp["A"]), torch.as_tensor(inp["u"])
    zax = ZAxis(m22, *u.shape)
    out["halo_apply"] = zax.gather(apply_stencil(
        zax.rows(A), zax.rows(u), halo=zax.halo)).numpy()
    out["step"] = batch_step_sharded(m22, iters=6)(*inp["step"]).numpy()
    out["sweep"] = make_sweep_fn(p, dtype=F64, fixed_iters=10,
                                 mesh=m22)(KS8, FS8).numpy()
    out["sweep_mg"] = make_sweep_fn(p, dtype=F64, fixed_iters=6,
                                    precondition="mg",
                                    mesh=m22)(KS8, FS8).numpy()
    its = []
    out["chunked"] = run_sweep_time_chunked(
        p, KS5, FS5, step_chunk=2, fixed_iters=10, dtype=F64, mesh=m41,
        iters_out=its)
    out["chunked_iters"] = torch.stack(its).numpy()
    out["vmem"] = make_sweep_fn(p, dtype=F64, fixed_iters=12, solver="vmem",
                                mesh=m41)(KS8, FS8).numpy()
    for prec in ("jacobi", "rline"):
        ys = make_simulate_fn(p, dtype=F64, rtol=1e-11, record_gradient=True,
                              precondition=prec, mesh=m22)()
        out[f"z_{prec}"] = {k: v.numpy() for k, v in ys.items()}
    out["errors"] = {
        "vmem_z": _catch(lambda: make_sweep_fn(
            p, fixed_iters=12, solver="vmem", mesh=m22)),
        "step_vmem": _catch(lambda: make_simulate_fn(
            p, dtype=torch.float32, solver="vmem", mesh=m22)),
        "step_adaptive": _catch(lambda: make_simulate_fn(
            p, dtype=torch.float32, precondition="adaptive", mesh=m22)),
        "step_mgz": _catch(lambda: make_simulate_fn(
            p, dtype=torch.float32, precondition="mgz", mesh=m22)),
        "step_refine": _catch(lambda: make_simulate_fn(
            p, dtype=torch.float32, f64_refine=1, mesh=m22)),
        "not_divisible": _catch(lambda: make_simulate_fn(
            p, dtype=F64, mesh=m14)),
        "world": _catch(lambda: config_mesh(3, device="cpu")),
    }
    return out


@pytest.fixture(scope="module")
def ranks():
    from heatflow_tpu_torch.parallel.sharding import spawn
    return spawn(_rank4, 4, device="cpu", timeout=SPAWN_S)


@pytest.fixture(scope="module")
def pair():
    """test_sharding's sweep problem (5 steps), built by each package."""
    df = synthetic_heating()
    cfg = _cfg()
    pj = j_build_problem(J.build_structured_mesh(*J.build_layout(cfg)),
                         JHeating(time=df["time"].to_numpy(),
                                  temp=df["temp"].to_numpy()), cfg,
                         watcher_points=WP)
    return pj, _t_problem()


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert np.array_equal(r[key], ranks[0][key]), key


def test_sharded_stencil_apply_matches_single_device(ranks):
    """The halo exchange: the z-sharded apply gathered is the unsharded
    apply bit for bit, and the JAX package's within 1e-12."""
    inp = _operator_inputs()
    want = apply_stencil(torch.as_tensor(inp["A"]),
                         torch.as_tensor(inp["u"])).numpy()
    _same_on_every_rank(ranks, "halo_apply")
    assert np.array_equal(ranks[0]["halo_apply"], want)
    j = np.asarray(j_apply(jnp.asarray(inp["A"]), jnp.asarray(inp["u"])))
    np.testing.assert_allclose(ranks[0]["halo_apply"], j, rtol=1e-12,
                               atol=1e-12 * np.abs(j).max())


def test_batch_step_sharded_matches_unsharded(ranks):
    """batch_step_sharded over (config 2, z 2) against the JAX package's
    building block on one device (test_sharding's bound, 1e-10)."""
    from heatflow_tpu.parallel.sharding import batch_step_sharded, config_mesh
    from heatflow_tpu.parallel.sharding import shard_batch
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax
    A, M_op, free, g, u = _operator_inputs()["step"]
    dmesh = config_mesh(1, z_shards=1)
    with dmesh:
        a1, m1, u1, g1 = shard_batch(dmesh, (A, M_op, u, g))
        f1 = jax.device_put(jnp.asarray(free),
                            NamedSharding(dmesh, P("z", None)))
        ref = np.asarray(batch_step_sharded(dmesh, iters=6)(a1, m1, f1, g1,
                                                            u1))
    _same_on_every_rank(ranks, "step")
    np.testing.assert_allclose(ranks[0]["step"], ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def test_make_sweep_fn_sharded_scan_matches_unsharded(ranks, pair):
    """The multi-step scan with watcher accumulation under (config 2, z 2)
    within 1e-11 of the port's unsharded run and of the JAX package's."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn as j_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn
    pj, pt = pair
    want = make_sweep_fn(pt, dtype=F64, fixed_iters=10,
                         device="cpu")(KS8, FS8).numpy()
    j = np.asarray(j_sweep(pj, dtype=jnp.float64, fixed_iters=10)(KS8, FS8))
    _same_on_every_rank(ranks, "sweep")
    _close(ranks[0]["sweep"], want, 1e-11)
    _close(ranks[0]["sweep"], j, 1e-11)


def test_mg_preconditioned_sweep_sharded_matches_unsharded(ranks, pair):
    """'mg' under z: the V-cycle replicated on the gathered field; within
    1e-11 of the unsharded runs of both packages."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn as j_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn
    pj, pt = pair
    want = make_sweep_fn(pt, dtype=F64, fixed_iters=6, precondition="mg",
                         device="cpu")(KS8, FS8).numpy()
    j = np.asarray(j_sweep(pj, dtype=jnp.float64, fixed_iters=6,
                           precondition="mg")(KS8, FS8))
    _close(ranks[0]["sweep_mg"], want, 1e-11)
    _close(ranks[0]["sweep_mg"], j, 1e-11)


def test_time_chunked_sharded_matches_unsharded(ranks, pair):
    """5 configs padded over a 'config' axis of 4 and cut back: bitwise the
    port's unsharded chunked run (traces and counts), within 1e-11 of the
    JAX package's."""
    from heatflow_tpu.sim.sweepkernel import run_sweep_time_chunked as j_run
    from heatflow_tpu_torch.sim.sweepkernel import run_sweep_time_chunked
    pj, pt = pair
    its = []
    want = run_sweep_time_chunked(pt, KS5, FS5, step_chunk=2,
                                  fixed_iters=10, dtype=F64, device="cpu",
                                  iters_out=its)
    j = j_run(pj, KS5, FS5, step_chunk=2, fixed_iters=10,
              dtype=jnp.float64)
    got = ranks[0]["chunked"]
    assert got.shape == want.shape == (5, pt.num_steps, 2)
    _same_on_every_rank(ranks, "chunked")
    assert np.array_equal(got, want)
    assert np.array_equal(ranks[0]["chunked_iters"], torch.stack(its))
    _close(got, j, 1e-11)


def test_run_parameter_sweep_driver_sharded(tmp_path):
    """The sweep driver over four CPU devices (its own ranks): the per-run
    CSVs equal the one-device run's, and the metadata names the sharding."""
    from heatflow_tpu_torch.drivers.sweep import run_parameter_sweep
    heat = tmp_path / "heat.csv"
    synthetic_heating(heat)
    cfg = _cfg()
    cfg["heating"]["file"] = str(heat)
    kw = dict(fwhm_range=(4e-6, 9e-6), k_range=(2.0, 8.0),
              width_range=(1.84e-6, 1.84e-6), num_points=(2, 3, 1),
              suppress_print=True, dtype=F64, save_run_dirs=True)
    out1, out4 = str(tmp_path / "single"), str(tmp_path / "sharded")
    r1, f1 = run_parameter_sweep(cfg, out1, base_mesh_folder=str(
        tmp_path / "m1"), devices=["cpu"], **kw)
    timings = {}
    r4, f4 = run_parameter_sweep(cfg, out4, base_mesh_folder=str(
        tmp_path / "m4"), devices=["cpu"] * 4, timings=timings, **kw)
    assert len(r1) == len(r4) == 6 and not f1 and not f4
    assert timings["compute_s"] > 0
    for a, b in zip(r1, r4):
        assert a["run_name"] == b["run_name"]
        with open(f"{out1}/{a['run_name']}/watcher_points.csv") as fa, \
                open(f"{out4}/{b['run_name']}/watcher_points.csv") as fb:
            assert fa.read() == fb.read()
    meta = json.load(open(f"{out4}/sweep_metadata.json"))
    assert "sharded over 4 devices" in meta["engine"]
    assert meta["devices"] == ["cpu"] * 4
    assert "sharded" not in json.load(
        open(f"{out1}/sweep_metadata.json"))["engine"]


def test_sweep_vmem_solver_sharded(ranks, pair):
    """The kernel sweep (K3's plain version here) over 'config': bitwise the
    port's unsharded run, within 1e-11 of the JAX package's eager
    fixed-count trajectory; a 'z' axis raises."""
    from heatflow_tpu.sim.sweepkernel import make_sweep_fn as j_sweep
    from heatflow_tpu_torch.sim.sweepkernel import make_sweep_fn
    pj, pt = pair
    want = make_sweep_fn(pt, dtype=F64, fixed_iters=12, solver="vmem",
                         device="cpu")(KS8, FS8).numpy()
    j = np.asarray(j_sweep(pj, dtype=jnp.float64, fixed_iters=12)(KS8, FS8))
    _same_on_every_rank(ranks, "vmem")
    assert np.array_equal(ranks[0]["vmem"], want)
    _close(ranks[0]["vmem"], j, 1e-11)
    assert "config axis only" in ranks[0]["errors"]["vmem_z"]


def test_single_problem_z_sharded_stepper_matches(ranks, pair):
    """make_simulate_fn(mesh=) z-shards one problem: watch, band, axis and
    final_u within 1e-11 of the JAX package's unsharded stepper (Jacobi),
    the r-line watch within 1e-9; the sharded counts equal the unsharded;
    the options the JAX package refuses under a mesh raise with its
    words."""
    from heatflow_tpu.sim.stepper import make_simulate_fn as j_make
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    pj, pt = pair
    ref = j_make(pj, dtype=jnp.float64, rtol=1e-11, record_gradient=True)()
    got = ranks[0]["z_jacobi"]
    for key in ("watch", "band", "axis", "final_u"):
        _close(got[key], np.asarray(ref[key]), 1e-11)
    own = make_simulate_fn(pt, dtype=F64, rtol=1e-11, record_gradient=True,
                           device="cpu")()
    assert np.array_equal(got["cg_iters"], own["cg_iters"].numpy())
    _close(ranks[0]["z_rline"]["watch"], np.asarray(ref["watch"]), 1e-9)
    for r in ranks[1:]:
        for key in ("watch", "band", "axis", "final_u"):
            assert np.array_equal(r["z_jacobi"][key], got[key]), key
    err = ranks[0]["errors"]
    assert "XLA" in err["step_vmem"] and "ValueError" in err["step_vmem"]
    assert "adaptive" in err["step_adaptive"]
    assert "mgz" in err["step_mgz"]
    assert "mesh" in err["step_refine"]
    assert "not divisible" in err["not_divisible"]
    assert "world" in err["world"]


@pytest.mark.parametrize("maker", ["make_simulate_fn", "make_sweep_fn",
                                   "make_sweep_fn_recording",
                                   "run_sweep_time_chunked"])
def test_mesh_must_be_a_device_mesh(pair, maker):
    """A bogus ``mesh=`` raises a TypeError that names what it got."""
    from heatflow_tpu_torch.sim import stepper, sweepkernel
    fn = getattr(stepper if maker == "make_simulate_fn" else sweepkernel,
                 maker)
    args = (KS5, FS5) if maker == "run_sweep_time_chunked" else ()
    with pytest.raises(TypeError, match="DeviceMesh.*object"):
        fn(pair[1], *args, mesh=object(), device="cpu")


def test_dryrun_multichip_cpu():
    """The dry run's eight engines on 4 gloo ranks: the config-axis engines
    bitwise, the z-sharded sweep within 1e-12 and the z-sharded stepper
    within 1e-9 of their unsharded runs."""
    from heatflow_tpu_torch.parallel.dryrun import dryrun_multichip
    err = dryrun_multichip(4, device="cpu", timeout=SPAWN_S)
    assert err["z_shards"] == 2
    for k in ("vmem", "recording", "refined", "vmem_recording",
              "rline_recording", "adi"):
        assert err[k] == 0.0, k
    assert err["xla"] < 1e-12 and err["z_stepper"] < 1e-9

"""The port's 1D reduced model (``ops/tridiag``, the interval elements of
``ops/p1``, ``sim/reduced1d``) against the JAX package's, in float64 on the
CPU, on the same numpy-seeded inputs."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.geometry import coupler_watcher_points
from heatflow_tpu.ops import p1 as jp1
from heatflow_tpu.ops import tridiag as jt
from heatflow_tpu.sim import reduced1d as jr
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu_torch.ops import p1 as tp1
from heatflow_tpu_torch.ops import tridiag as tt
from heatflow_tpu_torch.sim import reduced1d as tr
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

TOL = 1e-13


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("name", ["interval_stiffness", "interval_mass",
                                  "interval_load"])
def test_interval_elements_match_jax(name):
    h = np.random.default_rng(0).random((4, 5)) + 0.1
    got, want = getattr(tp1, name)(h), getattr(jp1, name)(h)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def _tridiag_inputs(batch=()):
    rng = np.random.default_rng(1)
    nz = 41
    C = rng.standard_normal(batch + (3, nz))
    C[..., 0, :] = 3.0 + rng.random(batch + (nz,))
    C[..., 1, -1] = 0.0
    C[..., 2, 0] = 0.0
    return C, rng.standard_normal(batch + (nz,)), rng


def test_assemble_1d_matches_jax():
    rng = np.random.default_rng(2)
    z = np.cumsum(rng.random(30) + 0.05)
    tags = rng.integers(1, 4, 29)
    got, want = tt.assemble_1d(z, tags, 3), jt.assemble_1d(z, tags, 3)
    assert set(got) == set(want) == {"K", "M", "M_unit"}
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_apply_and_combine_tridiag_match_jax():
    C, u, rng = _tridiag_inputs()
    assert close(tt.apply_tridiag(torch.tensor(C), torch.tensor(u)),
                 jt.apply_tridiag(jnp.asarray(C), jnp.asarray(u)))
    K, M = rng.standard_normal((2, 3, 3, 17))
    kp, rc = rng.random((2, 5, 3)) + 0.5
    Aj, Mj = jt.combine_tridiag(jnp.asarray(K), jnp.asarray(M),
                                jnp.asarray(kp), jnp.asarray(rc), 1.5e-7)
    At, Mt = tt.combine_tridiag(torch.tensor(K), torch.tensor(M),
                                torch.tensor(kp), torch.tensor(rc), 1.5e-7)
    assert At.shape == (5, 3, 17)
    assert close(At, Aj) and close(Mt, Mj)


def test_thomas_solve_matches_jax_and_a_dense_solve():
    C, b, _ = _tridiag_inputs()
    x = tt.thomas_solve(torch.tensor(C), torch.tensor(b)).numpy()
    assert close(x, jt.thomas_solve(jnp.asarray(C), jnp.asarray(b)))
    dense = np.diag(C[0]) + np.diag(C[1, :-1], 1) + np.diag(C[2, 1:], -1)
    np.testing.assert_allclose(x, np.linalg.solve(dense, b), rtol=1e-10)


def test_thomas_solve_batches_like_vmap():
    C, b, _ = _tridiag_inputs(batch=(2, 3))
    want = jax.vmap(jax.vmap(jt.thomas_solve))(jnp.asarray(C), jnp.asarray(b))
    assert close(tt.thomas_solve(torch.tensor(C), torch.tensor(b)), want)
    # one operator, a batch of right-hand sides: factored once
    fac = tt.thomas_factor(torch.tensor(C[0, 0]))
    got = tt.thomas_apply(fac, torch.tensor(b))
    want = jax.vmap(jax.vmap(lambda v: jt.thomas_solve(jnp.asarray(C[0, 0]),
                                                       v)))(jnp.asarray(b))
    assert close(got, want)


def test_dirichlet_rows_match_jax():
    C, b, rng = _tridiag_inputs()
    mask = np.zeros(C.shape[-1])
    mask[[0, 7, 8, -1]] = 1.0
    vals = rng.standard_normal(C.shape[-1])
    Cj, bj = jt.dirichlet_rows(jnp.asarray(C), jnp.asarray(b),
                               jnp.asarray(mask), jnp.asarray(vals))
    Ct, bt = tt.dirichlet_rows(torch.tensor(C), torch.tensor(b),
                               torch.tensor(mask), torch.tensor(vals))
    assert close(Ct, Cj) and close(bt, bj)
    assert torch.equal(Ct, tt.dirichlet_operator(torch.tensor(C),
                                                 torch.tensor(mask)))
    x = tt.thomas_solve(Ct, bt).numpy()
    np.testing.assert_array_equal(x[mask > 0], vals[mask > 0])


def _tables(rng):
    T_, Z = 7, 11
    times = np.sort(rng.random(T_))
    zt = np.sort(rng.random(Z))
    vals = rng.standard_normal((T_, Z))
    return (jr.GradientTable(times, zt, vals, jr.DELTA_R_RAW),
            tr.GradientTable(times, zt, vals, tr.DELTA_R_RAW))


def test_source_fn_matches_jax_at_between_and_outside_knots():
    rng = np.random.default_rng(3)
    tj, tt_ = _tables(rng)
    zn = np.linspace(-0.2, 1.2, 23)      # past both ends of the table's z
    zn[3], zn[9] = tj.z[2], tj.z[-1]     # on knots
    kap = rng.random(23) + 1.0
    sj = jr.make_source_fn(tj, zn, kap)
    st = tr.make_source_fn(tt_, zn, kap, device="cpu")
    mid = 0.5 * (tj.times[:-1] + tj.times[1:])
    qs = np.concatenate([tj.times, mid, [tj.times[0] - 1.0,
                                         tj.times[-1] + 1.0]])
    want = np.stack([np.asarray(sj(jnp.asarray(q))) for q in qs])
    assert close(st(qs), want)                       # a batch of times
    assert close(st(float(qs[4])), want[4])          # one time
    assert close(st(torch.tensor(qs[-1])), want[-1])
    # the 0.1x damping acts exactly at the z-clamped nodes
    clamped = (zn < tj.z[0]) | (zn > tj.z[-1])
    assert clamped.any() and not clamped.all()
    assert tr.BOUNDARY_DAMPING == jr.BOUNDARY_DAMPING
    assert (tr.DELTA_R_SMOOTHED, tr.DELTA_R_RAW) == (jr.DELTA_R_SMOOTHED,
                                                     jr.DELTA_R_RAW)


def _meshes(coarse=2.0):
    cfg = tiny_no_diamond_cfg(coarse=coarse)
    dj, mj = J.build_layout(cfg)
    dt_, mt = T.build_layout(cfg)
    return cfg, J.build_structured_mesh(dj, mj), \
        T.build_structured_mesh(dt_, mt)


def test_extract_axis_submesh_matches_jax():
    _, mesh_j, mesh_t = _meshes()
    zj, tj = jr.extract_axis_submesh(mesh_j)
    zt, tt_ = tr.extract_axis_submesh(mesh_t)
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(tt_, tj)
    kap = np.array([m.kappa for m in mesh_t.materials])
    np.testing.assert_array_equal(tr.node_kappas_1d(zt, tt_, kap),
                                  jr.node_kappas_1d(zj, tj, kap))


def test_extract_axis_submesh_unstructured_matches_jax():
    """Duck typed: any object with nodes, cells and cell_tags; here the
    structured mesh's own triangulation with shuffled cells, so that the
    lowest-index-cell rule and the z ordering both act."""
    _, _, mesh_t = _meshes(coarse=3.0)
    tris, tags = mesh_t.triangles()
    perm = np.random.default_rng(4).permutation(len(tris))
    um = SimpleNamespace(nodes=mesh_t.node_coords(), cells=tris[perm],
                         cell_tags=tags[perm])
    zj, tj = jr.extract_axis_submesh_unstructured(um)
    zt, tt_ = tr.extract_axis_submesh_unstructured(um)
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(tt_, tj)
    np.testing.assert_allclose(zt, mesh_t.z, rtol=0, atol=0)
    off_axis = SimpleNamespace(nodes=um.nodes + [0.0, 1.0], cells=um.cells,
                               cell_tags=um.cell_tags)
    with pytest.raises(ValueError, match="No facets"):
        tr.extract_axis_submesh_unstructured(off_axis)


@pytest.fixture(scope="module")
def problems():
    cfg, mesh_j, mesh_t = _meshes()
    cfg["timing"]["num_steps"] = 12
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    rng = np.random.default_rng(5)
    z = mesh_t.z
    # a gradient table that covers part of the axis and part of the run
    gz = np.linspace(z[2], z[-3], 9)
    t_final = float(cfg["timing"]["t_final"])
    gt = np.linspace(0.1 * t_final, 0.8 * t_final, 6)
    gv = 1e7 * rng.standard_normal((6, 9))
    pj = jr.build_problem_1d(mesh_j, JHeating(time=t, temp=temp), cfg,
                             gradient=jr.GradientTable(
                                 gt, gz, gv, jr.DELTA_R_SMOOTHED))
    pt = tr.build_problem_1d(mesh_t, THeating(time=t, temp=temp), cfg,
                             gradient=tr.GradientTable(
                                 gt, gz, gv, tr.DELTA_R_SMOOTHED))
    wz = {k: v[0] for k, v in coupler_watcher_points(cfg).items()}
    return pj, pt, wz


def test_build_problem_1d_matches_jax(problems):
    pj, pt, _ = problems
    for name in ("z", "cell_tags", "kappas", "rho_cvs", "heat_time",
                 "heat_temp"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    for name in ("dt", "num_steps", "ic_temp", "heating_z", "heat_node",
                 "material_tags"):
        assert getattr(pt, name) == getattr(pj, name), name


@pytest.mark.parametrize("correction", [True, False])
def test_simulate_1d_matches_jax(problems, correction):
    pj, pt, wz = problems
    kw = dict(use_radial_correction=correction, record_fields=True,
              watcher_z=wz)
    fj = jr.make_simulate_fn_1d(pj, **kw)
    ft = tr.make_simulate_fn_1d(pt, **kw, device="cpu")
    assert ft.watcher_names == fj.watcher_names == list(wz)
    yj, yt = fj(), ft()
    assert set(yt) == set(yj)
    np.testing.assert_allclose(yt["times"].numpy(), yj["times"], rtol=1e-15)
    for name in ("watch", "field", "final_u"):
        assert yt[name].shape == yj[name].shape
        assert rel_l2(yt[name].numpy(), yj[name]) < 1e-8, name
    assert np.ptp(yt["watch"].numpy()) > 1.0      # the pulse arrives


def test_correction_changes_the_answer(problems):
    _, pt, wz = problems
    on = tr.make_simulate_fn_1d(pt, watcher_z=wz, device="cpu")()
    off = tr.make_simulate_fn_1d(pt, watcher_z=wz, device="cpu",
                                 use_radial_correction=False)()
    assert float((on["watch"] - off["watch"]).abs().max()) > 1e-6
    assert "field" not in on


def test_simulate_1d_with_other_coefficients_and_a_batch(problems):
    pj, pt, wz = problems
    rng = np.random.default_rng(6)
    kps = pj.kappas * (0.5 + rng.random((3,) + pj.kappas.shape))
    rcs = pj.rho_cvs * (0.5 + rng.random((3,) + pj.rho_cvs.shape))
    fj = jr.make_simulate_fn_1d(pj, watcher_z=wz, record_fields=True)
    ft = tr.make_simulate_fn_1d(pt, watcher_z=wz, record_fields=True,
                                device="cpu")
    yj = fj(kps[0], rcs[0])
    yt = ft(kps[0], rcs[0])
    for name in ("watch", "field", "final_u"):
        assert rel_l2(yt[name].numpy(), yj[name]) < 1e-8, name
    base = ft()
    assert float((yt["watch"] - base["watch"]).abs().max()) > 1e-3
    # leading dimensions of the coefficients against jax.vmap
    vj = jax.vmap(fj)(jnp.asarray(kps), jnp.asarray(rcs))
    vt = ft(kps, rcs)
    for name in ("watch", "field", "final_u"):
        assert vt[name].shape == vj[name].shape, name
        assert rel_l2(vt[name].numpy(), vj[name]) < 1e-8, name
    assert torch.equal(vt["watch"][0], yt["watch"])


def test_float32_runs_and_entry_points_default_to_the_card(problems):
    _, pt, wz = problems
    y32 = tr.make_simulate_fn_1d(pt, watcher_z=wz, dtype=torch.float32,
                                 device="cpu")()
    y64 = tr.make_simulate_fn_1d(pt, watcher_z=wz, device="cpu")()
    assert y32["watch"].dtype == torch.float32
    assert rel_l2(y32["watch"].numpy(), y64["watch"].numpy()) < 1e-4
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.make_simulate_fn_1d(pt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.make_source_fn(pt.gradient, pt.z, np.ones_like(pt.z))


@pytest.mark.cuda
def test_simulate_1d_on_the_card_matches_the_cpu(problems):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, pt, wz = problems
    on = tr.make_simulate_fn_1d(pt, watcher_z=wz)()
    cpu = tr.make_simulate_fn_1d(pt, watcher_z=wz, device="cpu")()
    assert on["watch"].device.type == "cuda"
    assert rel_l2(on["watch"].cpu().numpy(), cpu["watch"].numpy()) < 1e-8

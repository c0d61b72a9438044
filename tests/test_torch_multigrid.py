"""The port's geometric multigrid (``ops/multigrid.py``) against the JAX
package's: hierarchy, transfers and the V-cycle, in float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.ops import multigrid as j_mg
from heatflow_tpu.ops.stencil import assemble_stencils as j_assemble
from heatflow_tpu.ops.stencil import combine_operator as j_combine
from heatflow_tpu_torch.ops import multigrid as t_mg
from heatflow_tpu_torch.ops.stencil import assemble_stencils as t_assemble
from heatflow_tpu_torch.ops.stencil import combine_operator as t_combine
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)


def _meshes():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    dj, mj = J.build_layout(cfg)
    dt_, mt = T.build_layout(cfg)
    return (J.build_structured_mesh(dj, mj), T.build_structured_mesh(dt_, mt),
            mj)


@pytest.fixture(scope="module", params=["rap", "rediscretize"])
def hierarchies(request):
    mesh_j, mesh_t, mats = _meshes()
    rng = np.random.default_rng(3)
    dirichlet = np.zeros(mesh_j.shape, bool)
    dirichlet[0, :] = dirichlet[-1, :] = dirichlet[:, -1] = True
    dirichlet |= rng.random(mesh_j.shape) < 0.03
    hj = j_mg.build_hierarchy(mesh_j, dirichlet, coarsening=request.param,
                              stencils=j_assemble(mesh_j, backend="numpy"))
    ht = t_mg.build_hierarchy(mesh_t, dirichlet, coarsening=request.param,
                              stencils=t_assemble(mesh_t))
    return hj, ht, mats, request.param


def test_hierarchy_matches_jax(hierarchies):
    """Shapes, Dirichlet masks, transfer indices and weights, and the RAP
    (9-point) or rediscretised (7-point) coarse stencils: the same numpy and
    scipy operations, so exact."""
    hj, ht, _, coarsening = hierarchies
    assert len(ht) == len(hj) >= 3
    for lj, lt in zip(hj, ht):
        assert lt.mesh.shape == lj.mesh.shape
        np.testing.assert_array_equal(lt.dirichlet, lj.dirichlet)
        np.testing.assert_array_equal(lt.mesh.cell_tags, lj.mesh.cell_tags)
        for name in ("liz", "wz", "lir", "wr"):
            a, b = getattr(lt, name), getattr(lj, name)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        # RAP: the same scipy products, exact. Rediscretised: the JAX
        # package re-assembles with its default (compiled) assembly backend,
        # which rounds otherwise than numpy: 1e-12 of the largest entry
        tol = 0.0 if coarsening == "rap" else 1e-12
        for a, b in ((lt.K, lj.K), (lt.M, lj.M)):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= tol * np.abs(b).max()
    assert ht[1].K.shape[1] == (9 if coarsening == "rap" else 7)


def _device_pair(hj, ht):
    return (j_mg.device_levels(hj, jnp.float64),
            t_mg.device_levels(ht, torch.float64, "cpu"))


def test_transfers_match_jax_and_are_adjoint(hierarchies):
    hj, ht, _, _ = hierarchies
    dj, dt_ = _device_pair(hj, ht)
    rng = np.random.default_rng(4)
    for l in range(1, len(dt_)):
        fine, coarse = dt_[l - 1]["shape"], dt_[l]["shape"]
        xc = rng.standard_normal(coarse)
        rf = rng.standard_normal((2,) + fine)      # a leading lane axis too
        pj = np.asarray(j_mg._prolong(dj[l], jnp.asarray(xc)))
        pt = t_mg._prolong(dt_[l], torch.tensor(xc)).numpy()
        rj = np.asarray(j_mg._restrict(dj[l], jnp.asarray(rf), coarse))
        rt = t_mg._restrict(dt_[l], torch.tensor(rf), coarse).numpy()
        assert pt.shape == fine and rt.shape == (2,) + coarse
        # within 1e-13 of JAX's (which adds each coarse value's two or
        # three contributions in scatter order)
        assert np.abs(pt - pj).max() <= 1e-13 * np.abs(pj).max()
        assert np.abs(rt - rj).max() <= 1e-13 * np.abs(rj).max()
        # R = P^T
        a = float((rt[0] * xc).sum())
        b = float((rf[0] * pt).sum())
        assert abs(a - b) <= 1e-12 * max(abs(a), abs(b))


def test_restriction_is_repeatable_and_has_no_scatter_add(hierarchies):
    """The restriction sums in a fixed order: bitwise equal across runs and
    across batch shapes, and built from gathers alone."""
    import inspect
    _, ht, _, _ = hierarchies
    dt_ = t_mg.device_levels(ht, torch.float32, "cpu")
    rng = np.random.default_rng(5)
    rf = torch.tensor(rng.standard_normal((3,) + dt_[0]["shape"]),
                      dtype=torch.float32)
    first = t_mg._restrict(dt_[1], rf, dt_[1]["shape"])
    again = t_mg._restrict(dt_[1], rf.clone(), dt_[1]["shape"])
    alone = t_mg._restrict(dt_[1], rf[1], dt_[1]["shape"])
    assert torch.equal(first, again) and torch.equal(first[1], alone)
    src = inspect.getsource(t_mg._restrict) \
        + inspect.getsource(t_mg._restrict_axis)
    assert "index_add" not in src and "scatter" not in src


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_vcycle_matches_jax(hierarchies, smoother):
    hj, ht, mats, _ = hierarchies
    dj, dt_ = _device_pair(hj, ht)
    kp = np.array([m.kappa for m in mats])
    rc = np.array([m.rho_cv for m in mats])
    ops_j = [{**lv, "A": j_combine(lv["K"], lv["M"], jnp.asarray(kp),
                                   jnp.asarray(rc), 1.5e-7)[0]} for lv in dj]
    ops_t = [{**lv, "A": t_combine(lv["K"], lv["M"], torch.tensor(kp),
                                   torch.tensor(rc), 1.5e-7)[0]}
             for lv in dt_]
    vj = j_mg.make_vcycle(ops_j, smoother=smoother)
    vt = t_mg.make_vcycle(ops_t, smoother=smoother)
    rng = np.random.default_rng(6)
    free = np.asarray(dj[0]["free"])
    r = rng.standard_normal(free.shape) * free
    zj = np.asarray(vj(jnp.asarray(r)))
    zt = vt(torch.tensor(r)).numpy()
    # the same polynomial smoothers and transfers: 1e-12 of the largest
    assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()
    v = rng.standard_normal(free.shape) * free
    a, b = float((v * zt).sum()), float((r * vt(torch.tensor(v)).numpy()).sum())
    assert abs(a - b) <= 1e-9 * max(abs(a), abs(b))     # SPD preconditioner
    with pytest.raises(ValueError, match="smoother"):
        t_mg.make_vcycle(ops_t, smoother="gauss-seidel")


def test_unknown_coarsening_raises():
    _, mesh_t, _ = _meshes()
    with pytest.raises(ValueError, match="coarsening"):
        t_mg.build_hierarchy(mesh_t, np.zeros(mesh_t.shape, bool),
                             coarsening="aggregate")


@pytest.mark.slow
def test_flagship_cold_first_step_mg_counts_match_jax():
    """The flagship's first implicit step (251 x 1107, 277,857 nodes) from a
    zero seed in float64 at rtol 1e-6 wrt ||b|| through each package's
    V-cycle-preconditioned PCG (the Galerkin hierarchy, Chebyshev degree 4):
    the same right-hand side and scaling for both, counts within 1 of each
    other (395 and 395 when this was written: at the flagship's grading and
    conductivity contrast the point-smoothed cycle is far from the O(10) it
    reaches on small grids). A full-size solve on the CPU (minutes): run by
    hand,

        python -m pytest tests/test_torch_multigrid.py -m slow -s
    """
    import math
    import os
    from heatflow_tpu.ops.cg import pcg as j_pcg
    from heatflow_tpu.ops.stencil import apply_stencil as j_apply
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.ops.cg import pcg as t_pcg
    from heatflow_tpu_torch.ops.stencil import apply_stencil as t_apply
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = T.load_config(os.path.join(root, "cfgs",
                                     "geballe_with_diamond.yaml"))
    csv = os.path.join(root, "experimental_data", "geballe_heat_data.csv")
    dj, mj = J.build_layout(cfg)
    mesh_j = J.build_structured_mesh(dj, mj)
    dt_, mt = T.build_layout(cfg)
    mesh_t = T.build_structured_mesh(dt_, mt)
    assert mesh_t.shape == (251, 1107)
    pt = build_problem(mesh_t, HeatingCurve.from_csv(csv), cfg,
                       watcher_points=coupler_watcher_points(cfg))
    dirichlet = pt.dirichlet_mask
    hj = j_mg.build_hierarchy(mesh_j, dirichlet,
                              stencils=j_assemble(mesh_j, backend="numpy"))
    ht = t_mg.build_hierarchy(mesh_t, dirichlet, stencils=pt.stencils)
    dj_, dt_l = _device_pair(hj, ht)
    kp, rc, dt = pt.kappas, pt.rho_cvs, float(pt.dt)
    ops_j = [{**lv, "A": j_combine(lv["K"], lv["M"], jnp.asarray(kp),
                                   jnp.asarray(rc), dt)[0]} for lv in dj_]
    ops_t = [{**lv, "A": t_combine(lv["K"], lv["M"], torch.tensor(kp),
                                   torch.tensor(rc), dt)[0]} for lv in dt_l]
    # the first step's scaled system, once, in numpy
    A = ops_t[0]["A"].numpy()
    M_op = np.einsum("m,mkij->kij", rc, pt.stencils.M)
    free = (~dirichlet).astype(float)
    s = np.where(free > 0, 1.0 / np.sqrt(np.where(A[0] > 0, A[0], 1.0)), 1.0)
    ic = pt.ic_temp
    heat_t, heat_T = pt.heating.time, pt.heating.temp
    amp = np.interp(dt, heat_t, heat_T) - (heat_T[0] - ic)
    profile = np.exp(-4.0 * math.log(2.0) / pt.fwhm ** 2 * pt.r_sq) \
        * pt.heat_mask
    g = ic * dirichlet + (amp - ic) * profile
    u0 = np.full(mesh_t.shape, ic)
    b = (t_apply(torch.tensor(M_op), torch.tensor(u0))
         - t_apply(torch.tensor(A), torch.tensor(g))).numpy() * s * free
    inv_s = 1.0 / s
    counts = {}
    vt = t_mg.make_vcycle(ops_t)
    st, it_ = torch.tensor(s), torch.tensor(inv_s)
    sol_t = t_pcg(lambda y: st * t_apply(ops_t[0]["A"], st * y),
                  torch.tensor(b), torch.zeros(mesh_t.shape,
                                               dtype=torch.float64),
                  precond=lambda r: it_ * vt(it_ * r),
                  mask=torch.tensor(free), rtol=1e-6, maxiter=2000)
    counts["torch"] = int(sol_t.iters)
    vj = j_mg.make_vcycle(ops_j)
    sj, ij = jnp.asarray(s), jnp.asarray(inv_s)
    sol_j = j_pcg(lambda y: sj * j_apply(ops_j[0]["A"], sj * y),
                  jnp.asarray(b), jnp.zeros(mesh_t.shape),
                  precond=lambda r: ij * vj(ij * r), mask=jnp.asarray(free),
                  rtol=1e-6, maxiter=2000)
    counts["jax"] = int(sol_j.iters)
    print(f"flagship first step from a zero seed, float64, rtol 1e-6 wrt "
          f"||b||, {len(ht)} levels: heatflow_tpu {counts['jax']} "
          f"iterations, heatflow_tpu_torch {counts['torch']}")
    assert abs(counts["torch"] - counts["jax"]) <= 1, counts
    assert counts["torch"] < 2000, counts
    xj = np.asarray(sol_j.x)
    assert np.abs(sol_t.x.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()

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

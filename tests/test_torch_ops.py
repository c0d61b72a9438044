"""PyTorch port, device ops in float64 against the JAX package: stencil
apply/transpose, operator combine, masked PCG, line PCR preconditioners."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.ops import cg as jcg
from heatflow_tpu.ops import linesolve as jls
from heatflow_tpu.ops import stencil as jst
from heatflow_tpu_torch.ops import cg as tcg
from heatflow_tpu_torch.ops import linesolve as tls
from heatflow_tpu_torch.ops import stencil as tst
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

TOL_APPLY = 1e-13
TOL_SOLVE = 1e-12


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def system():
    """The scaled backward-Euler operator of the tiny no-diamond stack with
    a random Dirichlet pattern (the JAX kernel tests' system)."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = T.build_layout(cfg)
    mesh = T.build_structured_mesh(domain, mats)
    pack = jst.assemble_stencils(
        J.build_structured_mesh(*J.build_layout(cfg)), backend="numpy")
    kp = np.array([m.kappa for m in mats])
    rc = np.array([m.rho_cv for m in mats])
    A, _ = jst.combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                                jnp.asarray(kp), jnp.asarray(rc), 1.5e-7)
    A = np.asarray(A)
    rng = np.random.default_rng(0)
    free = (rng.random(mesh.shape) > 0.15).astype(float)
    diag = A[0]
    s = 1.0 / np.sqrt(np.where(diag > 0, diag, 1.0)) * free + (1 - free)
    x_true = rng.standard_normal(mesh.shape) * free
    b = np.asarray((s * free) * jst.apply_stencil(
        jnp.asarray(A), jnp.asarray(s * free * x_true)))
    return dict(A=A, s=s, free=free, b=b, pack=pack, kp=kp, rc=rc,
                shape=mesh.shape)


@pytest.mark.parametrize("npts", [7, 9])
def test_apply_and_transpose(npts):
    rng = np.random.default_rng(npts)
    C = rng.standard_normal((npts, 13, 21))
    u = rng.standard_normal((13, 21))
    for jf, tf in ((jst.apply_stencil, tst.apply_stencil),
                   (jst.stencil_transpose_apply,
                    tst.stencil_transpose_apply)):
        want = np.asarray(jf(jnp.asarray(C), jnp.asarray(u)))
        got = tf(t64(C), t64(u)).numpy()
        assert rel(got, want) < TOL_APPLY
    # A^T is the adjoint of A: <A u, v> == <u, A^T v>
    v = rng.standard_normal((13, 21))
    lhs = float((tst.apply_stencil(t64(C), t64(u)) * t64(v)).sum())
    rhs = float((t64(u) * tst.stencil_transpose_apply(t64(C), t64(v))).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)


def test_stencil_matches_scipy(system):
    import scipy.sparse as sp
    A = system["A"]
    n = A.shape[1] * A.shape[2]
    rows, cols, vals = tst.stencil_to_coo(A)
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    u = np.random.default_rng(1).standard_normal(A.shape[1:])
    got = tst.apply_stencil(t64(A), t64(u)).numpy().ravel()
    assert rel(got, S @ u.ravel()) < TOL_APPLY


def test_combine_operator(system):
    pack = system["pack"]
    rng = np.random.default_rng(2)
    for kp, rc in ((system["kp"], system["rc"]),
                   (system["kp"] * rng.uniform(0.5, 2, (2, 5)),
                    system["rc"] * rng.uniform(0.5, 2, (2, 5)))):
        Aj, Mj = jst.combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                                      jnp.asarray(kp), jnp.asarray(rc), 1.5e-7)
        At, Mt = tst.combine_operator(t64(pack.K), t64(pack.M), t64(kp),
                                      t64(rc), 1.5e-7)
        assert At.shape == Aj.shape
        assert rel(At.numpy(), Aj) < TOL_APPLY
        assert rel(Mt.numpy(), Mj) < TOL_APPLY


def _pcg_pair(system, precond, rtol_wrt):
    A, s, free, b = system["A"], system["s"], system["free"], system["b"]
    Aj, sj, fj = jnp.asarray(A), jnp.asarray(s), jnp.asarray(free)
    At, st, ft = t64(A), t64(s), t64(free)
    pj = {"jacobi": None,
          "rline": jls.line_preconditioner(Aj, sj, fj, axis=-1),
          "zline": jls.line_preconditioner(Aj, sj, fj, axis=-2),
          "adi": jls.adi_preconditioner(Aj, sj, fj)}[precond]
    pt = {"jacobi": None,
          "rline": tls.line_preconditioner(At, st, ft, axis=-1),
          "zline": tls.line_preconditioner(At, st, ft, axis=-2),
          "adi": tls.adi_preconditioner(At, st, ft)}[precond]
    x0 = np.random.default_rng(5).standard_normal(A.shape[1:]) * free * 0.1
    rj = jcg.pcg(lambda y: sj * jst.apply_stencil(Aj, sj * y), jnp.asarray(b),
                 jnp.asarray(x0), precond=pj, mask=fj, rtol=1e-10,
                 maxiter=5000, rtol_wrt=rtol_wrt)
    rt = tcg.pcg(lambda y: st * tst.apply_stencil(At, st * y), t64(b),
                 t64(x0), precond=pt, mask=ft, rtol=1e-10, maxiter=5000,
                 rtol_wrt=rtol_wrt)
    return rj, rt


@pytest.mark.parametrize("precond", ["jacobi", "rline", "zline", "adi"])
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_pcg_matches_jax(system, precond, rtol_wrt):
    rj, rt = _pcg_pair(system, precond, rtol_wrt)
    assert int(rt.iters) == int(rj.iters)
    assert rel(rt.x.numpy(), rj.x) < TOL_SOLVE
    assert bool(rt.converged) and bool(rj.converged)
    assert abs(float(rt.residual) - float(rj.residual)) \
        < 1e-6 * float(rj.residual)


def test_pcg_lane_freeze(system):
    """Batched lanes converge independently: each lane equals its own
    single-problem solve, and a converged lane is frozen."""
    A, s, free, b = system["A"], system["s"], system["free"], system["b"]
    At, st, ft = t64(A), t64(s), t64(free)
    op = lambda y: st * tst.apply_stencil(At, st * y)
    bb = torch.stack([t64(b), 1e-3 * t64(b) + t64(free) * 0.5])
    x0 = torch.zeros_like(bb)
    x0[1] = t64(b)            # a much better seed for lane 1
    both = tcg.pcg(op, bb, x0, mask=ft, rtol=1e-9, maxiter=5000,
                   rtol_wrt="b")
    assert both.iters[0] != both.iters[1]
    for lane in range(2):
        one = tcg.pcg(op, bb[lane], x0[lane], mask=ft, rtol=1e-9,
                      maxiter=5000, rtol_wrt="b")
        assert int(one.iters) == int(both.iters[lane])
        assert torch.equal(one.x, both.x[lane])


def test_pcg_nan_poisons():
    op = lambda y: 2.0 * y
    b = torch.full((4, 5), float("nan"), dtype=torch.float64)
    res = tcg.pcg(op, b, torch.zeros_like(b), rtol=1e-8)
    assert torch.isnan(res.x).all() and int(res.iters) == 0


def test_refine_inner_scale():
    for rn2, floor2 in ((4.0, 1e-3), (1e-40, 1e-30)):
        rj, tj = jcg.refine_inner_scale(jnp.asarray(rn2), jnp.asarray(floor2),
                                        1e-4, jnp.float32)
        rt, tt = tcg.refine_inner_scale(torch.tensor(rn2, dtype=torch.float64),
                                        torch.tensor(floor2,
                                                     dtype=torch.float64),
                                        1e-4, torch.float32)
        assert float(rt) == float(rj) and float(tt) == float(tj)
        assert tt.dtype == torch.float32


@pytest.mark.parametrize("axis", [-1, -2])
def test_line_factors_match_jax(system, axis):
    A, s, free = system["A"], system["s"], system["free"]
    sf = s * free
    lj, uj = jls.line_couplings(jnp.asarray(A), jnp.asarray(sf), axis)
    lt, ut = tls.line_couplings(t64(A), t64(sf), axis)
    assert rel(lt.numpy(), lj) < TOL_SOLVE and rel(ut.numpy(), uj) < TOL_SOLVE
    fj = jls.pcr_factor(lj, uj, axis=axis)
    ft = tls.pcr_factor(lt, ut, axis=axis)
    assert len(ft) == len(fj)
    for a, b in zip(ft, fj):
        for x, y in zip(a, b):
            assert rel(x.numpy(), y) < TOL_SOLVE
    (l2j, gj), (l2t, gt) = jls.pcr_fold(fj, axis=axis), tls.pcr_fold(ft,
                                                                     axis=axis)
    assert rel(gt.numpy(), gj) < TOL_SOLVE
    for (a, b), (c, d) in zip(l2t, l2j):
        assert rel(a.numpy(), c) < TOL_SOLVE and rel(b.numpy(), d) < TOL_SOLVE
    d = np.random.default_rng(7).standard_normal(A.shape[1:])
    assert rel(tls.pcr_apply(ft, t64(d), axis=axis).numpy(),
               jls.pcr_apply(fj, jnp.asarray(d), axis=axis)) < TOL_SOLVE
    assert rel(tls.pcr_apply_folded(l2t, gt, t64(d), axis=axis).numpy(),
               jls.pcr_apply_folded(l2j, gj, jnp.asarray(d), axis=axis)) \
        < TOL_SOLVE


@pytest.mark.parametrize("kind", ["rline", "zline", "adi"])
def test_preconditioners_match_jax(system, kind):
    A, s, free = system["A"], system["s"], system["free"]
    Aj, sj, fj = jnp.asarray(A), jnp.asarray(s), jnp.asarray(free)
    At, st, ft = t64(A), t64(s), t64(free)
    if kind == "adi":
        pj, pt = jls.adi_preconditioner(Aj, sj, fj), \
            tls.adi_preconditioner(At, st, ft)
    else:
        axis = -1 if kind == "rline" else -2
        pj = jls.line_preconditioner(Aj, sj, fj, axis=axis)
        pt = tls.line_preconditioner(At, st, ft, axis=axis)
    r = np.random.default_rng(8).standard_normal(A.shape[1:])
    assert rel(pt(t64(r)).numpy(), pj(jnp.asarray(r))) < TOL_SOLVE


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1107])
def test_pcr_line_solve_matches_banded(n):
    """One diagonally dominant unit-diagonal tridiagonal system solved by
    PCR against scipy.linalg.solve_banded."""
    rng = np.random.default_rng(n)
    l = rng.uniform(-0.45, 0.0, n)
    u = rng.uniform(-0.45, 0.0, n)
    l[0], u[-1] = 0.0, 0.0
    d = rng.standard_normal(n)
    ab = np.zeros((3, n))
    ab[0, 1:] = u[:-1]
    ab[1] = 1.0
    ab[2, :-1] = l[1:]
    want = scipy.linalg.solve_banded((1, 1), ab, d)
    lv, uv = t64(l[None, :]), t64(u[None, :])
    levels = tls.pcr_factor(lv, uv, axis=-1)
    got = tls.pcr_apply(levels, t64(d[None, :]), axis=-1)[0].numpy()
    assert rel(got, want) < TOL_SOLVE
    l2, g = tls.pcr_fold(levels, axis=-1)
    got2 = tls.pcr_apply_folded(l2, g, t64(d[None, :]), axis=-1)[0].numpy()
    assert rel(got2, want) < TOL_SOLVE


def test_material_combine_is_elementwise():
    """No matrix product: the combine is exact against an explicit
    multiply-add chain in float32."""
    rng = np.random.default_rng(9)
    S = torch.tensor(rng.standard_normal((5, 7, 6, 8)), dtype=torch.float32)
    c = torch.tensor(rng.uniform(1, 1e4, (3, 5)), dtype=torch.float32)
    got = tst.material_combine(c, S)
    want = c[:, 0, None, None, None] * S[0]
    for i in range(1, 5):
        want = want + c[:, i, None, None, None] * S[i]
    assert torch.equal(got, want)

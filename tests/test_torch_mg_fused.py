"""The fused passes of the two multigrid preconditioners of ``cg_tol``: the
mgz V-cycle (``ops/cuda_cg.py``) and the multigrid V-cycle of
``mgcg_vmem_tol`` (``ops/cuda_mg.py``). On the CPU each fused pass's plain
version equals, bitwise in float32, the composition of the unfused passes
it replaces; the cycles built from the fused passes equal the plain cycles,
and a whole solve through them agrees with the JAX package's Pallas kernels
in interpret mode. Where a card is present, each new kernel is held to its
plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.geometry import build_layout
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.ops import mgz as j_mgz
from heatflow_tpu.ops import pallas_mg as j_mg
from heatflow_tpu.ops.pallas_cg import cg_vmem_tol
from heatflow_tpu.ops.pallas_cg import pcr_pack as j_pcr_pack
from heatflow_tpu.ops.stencil import (apply_stencil, assemble_stencils,
                                      combine_operator)
from heatflow_tpu_torch.ops import cuda_cg, cuda_mg
from heatflow_tpu_torch.ops import mgz as t_mgz
from heatflow_tpu_torch.ops.linesolve import thomas_apply_lines
from heatflow_tpu_torch.ops.mgz import coarse_apply, prolong, restrict
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

OMEGA = 0.8


def _operator(coarse):
    cfg = tiny_no_diamond_cfg(coarse=coarse)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = jnp.asarray([m.kappa for m in mats])
    rc = jnp.asarray([m.rho_cv for m in mats])
    A, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M), kp, rc,
                            1.5e-7)
    return mesh, A


@pytest.fixture(scope="module")
def mgz_system():
    """The system of tests/test_torch_mgz.py (random Dirichlet mask,
    numpy-seeded right-hand side), its mgz operands from each package, and
    float32 copies for the bitwise checks."""
    rng = np.random.default_rng(0)
    mesh, A = _operator(3.0)
    free = jnp.asarray((rng.random(mesh.shape) > 0.15).astype(float))
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + (1 - free)
    sm = s * free
    x_true = jnp.asarray(rng.standard_normal(mesh.shape)) * free
    b = sm * apply_stencil(A, sm * x_true)
    host = tuple(np.asarray(v) for v in (A, s, free))
    j = dict(A=A, sm=sm, b=b, x0=jnp.zeros_like(b),
             pcr=j_pcr_pack(A, s, free),
             mgz={k: jnp.asarray(v)
                  for k, v in j_mgz.mgz_pack(*host, np.float64).items()})
    t = {k: torch.tensor(np.asarray(v)) for k, v in j.items() if k != "mgz"}
    t["pcr"] = cuda_cg.rline_pack(t["A"], torch.tensor(host[1]),
                                  torch.tensor(host[2]))
    t["mgz"] = {k: torch.tensor(v)
                for k, v in t_mgz.mgz_pack(*host, np.float64).items()}
    f32 = {k: v.float() for k, v in t.items() if k != "mgz"}
    f32["mgz"] = {k: torch.tensor(v)
                  for k, v in t_mgz.mgz_pack(*host).items()}
    f32["free"] = (f32["sm"] != 0).float()
    return j, t, f32


def _field(rng, like, mask=None):
    v = torch.tensor(rng.standard_normal(tuple(like.shape)),
                     dtype=like.dtype)
    return v if mask is None else v * mask


# ----------------------------------------------------------------------
# mgz: each fused pass against the composition of the passes it replaces
# ----------------------------------------------------------------------

def test_mgz_pre_is_the_update_then_the_smoothing_row(mgz_system):
    _, _, t = mgz_system
    rng = np.random.default_rng(1)
    x, r, p, Ap = (_field(rng, t["b"], t["free"]) for _ in range(4))
    alpha = 0.37
    xn, rn, z, rr = cuda_cg.mgz_pre(r, t["pcr"], OMEGA, x=x, p=p, Ap=Ap,
                                    state=dict(alpha=alpha))
    a = torch.tensor(alpha, dtype=torch.float32)
    x_want, r_want = x + a * p, r - a * Ap
    assert torch.equal(xn, x_want) and torch.equal(rn, r_want)
    assert torch.equal(z, OMEGA * thomas_apply_lines(t["pcr"], r_want))
    assert float(rr) == float((r_want.double() ** 2).sum())
    _, r0, z0, rr0 = cuda_cg.mgz_pre(r, t["pcr"], OMEGA)
    assert rr0 is None and r0 is r
    assert torch.equal(z0, OMEGA * thomas_apply_lines(t["pcr"], r))


def test_mgz_coarse_is_residual_restriction_and_coarse_row(mgz_system):
    """The first coarse sweep from the fine residual, restricted: on the
    even rows the composition bitwise; on the odd rows 0, which is what the
    unfused coarse row gave there."""
    _, _, t = mgz_system
    rng = np.random.default_rng(2)
    A, sm, m = t["A"], t["sm"], t["mgz"]
    r, z = _field(rng, t["b"], t["free"]), _field(rng, t["b"])
    yc, rcs = cuda_cg.mgz_coarse(A, sm, r, z, m["aux"], m["pcrc"], OMEGA)
    rc = restrict(m["aux"], r - sm * cuda_cg.apply_stencil(A, sm * z))
    want = OMEGA * thomas_apply_lines(m["pcrc"], rc)
    assert torch.equal(yc, want) and torch.equal(rcs, rc)
    assert torch.equal(yc[0::2], want[0::2])
    assert float(yc[1::2].abs().max()) == 0.0
    assert bool(torch.isfinite(yc).all())


def test_mgz_coarse_res_is_coarse_residual_then_coarse_row(mgz_system):
    _, _, t = mgz_system
    rng = np.random.default_rng(3)
    A, sm, m = t["A"], t["sm"], t["mgz"]
    r, z = _field(rng, t["b"], t["free"]), _field(rng, t["b"])
    rc = restrict(m["aux"], r - sm * cuda_cg.apply_stencil(A, sm * z))
    y = OMEGA * thomas_apply_lines(m["pcrc"], rc)
    out = cuda_cg.mgz_coarse_res(m["Ac9"], rc, y, m["pcrc"], OMEGA)
    want = y + OMEGA * thomas_apply_lines(m["pcrc"],
                                               rc - coarse_apply(m["Ac9"], y))
    assert torch.equal(out, want)


def test_mgz_prolong_res_is_prolongation_then_residual(mgz_system):
    _, _, t = mgz_system
    rng = np.random.default_rng(4)
    A, sm, m = t["A"], t["sm"], t["mgz"]
    r, z, yc = (_field(rng, t["b"]) for _ in range(3))
    zp, r1 = cuda_cg.mgz_prolong_res(A, sm, r, z, yc, m["aux"])
    zw = prolong(m["aux"], z, yc)
    assert torch.equal(zp, zw)
    assert torch.equal(r1, r - sm * cuda_cg.apply_stencil(A, sm * zw))


def test_mgz_post_is_the_masked_row_with_its_dot_and_beta(mgz_system):
    _, _, t = mgz_system
    rng = np.random.default_rng(5)
    r1, zp, r = (_field(rng, t["b"]) for _ in range(3))
    z, rz = cuda_cg.mgz_post(r1, zp, t["pcr"], OMEGA, t["sm"], r)
    want = (zp + OMEGA * thomas_apply_lines(t["pcr"], r1)) * t["free"]
    assert torch.equal(z, want)
    assert float(rz) == float((r.double() * want.double()).sum())
    st = dict(rz=0.7, rr=1.3, stop2=1e-3, alpha=0.4, beta=0.1, k=3, done=0)
    _, _, st_new = cuda_cg.mgz_post(r1, zp, t["pcr"], OMEGA, t["sm"], r,
                                    state=st, rr=2.5, maxiter=9)
    assert st_new == cuda_cg.finalize_reference(st, "beta", rr=2.5, rz=rz,
                                                maxiter=9)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_mgz_fused_cycle_is_the_plain_cycle(mgz_system, sweeps):
    """The cycle as the kernel runs it (pre row with the update's r, coarse
    row with the residual, further sweeps, prolongation with the residual,
    post row) equals the plain V-cycle bitwise in float32."""
    _, _, t = mgz_system
    rng = np.random.default_rng(10 + sweeps)
    r = _field(rng, t["b"], t["free"])
    z, rz = cuda_cg.mgz_cycle_reference(t["A"], t["sm"], r, t["pcr"],
                                        t["mgz"], sweeps)
    want = cuda_cg.mgz_precond_reference(t["A"], t["sm"], t["pcr"], t["mgz"],
                                         sweeps)(r)
    assert torch.equal(z, want)
    assert float(rz) == float((r.double() * want.double()).sum())


@pytest.mark.parametrize("sweeps", [1, 2])
def test_mgz_odd_rows_of_the_coarse_iterate_do_not_reach_z(mgz_system,
                                                          sweeps):
    """z is bitwise the same when the odd rows of the coarse iterate hold
    any finite values (the prolongation weighs them by 0, and a further
    sweep reads the even rows only); and on the odd rows the coarse line
    solve's output is the elementwise omega_c (1/den rc), rc being 0
    there."""
    _, _, t = mgz_system
    rng = np.random.default_rng(20 + sweeps)
    A, sm, pcr, m = t["A"], t["sm"], t["pcr"], t["mgz"]
    r = _field(rng, t["b"], t["free"])
    _, _, z0, _ = cuda_cg.mgz_pre_reference(r, pcr, OMEGA)

    def cycle(scramble):
        yc, rcs = cuda_cg.mgz_coarse_reference(A, sm, r, z0, m["aux"],
                                               m["pcrc"], OMEGA)
        for _ in range(sweeps - 1):
            if scramble:
                yc = yc.clone()
                yc[1::2] = _field(rng, yc[1::2]) * 1e3
            yc = cuda_cg.mgz_coarse_res_reference(m["Ac9"], rcs, yc,
                                                  m["pcrc"], OMEGA)
        if scramble:
            yc = yc.clone()
            yc[1::2] = _field(rng, yc[1::2]) * 1e3
        zp, r1 = cuda_cg.mgz_prolong_res_reference(A, sm, r, z0, yc,
                                                   m["aux"])
        return cuda_cg.mgz_post_reference(r1, zp, pcr, OMEGA, sm, r)[0]

    assert torch.equal(cycle(True), cycle(False))
    rc = restrict(m["aux"], r - sm * cuda_cg.apply_stencil(A, sm * z0))
    assert float(rc[1::2].abs().max()) == 0.0
    pcr_out = OMEGA * thomas_apply_lines(m["pcrc"], rc)
    assert torch.equal(pcr_out[1::2], OMEGA * (m["pcrc"][1][1::2]
                                               * rc[1::2]))


@pytest.fixture
def fused_mgz(monkeypatch):
    """cg_tol's plain version with the mgz cycle built from the fused
    passes."""
    def precond(A, sm, pcr, mgz, sweeps=1, omega=0.8, omega_c=0.8):
        return lambda r: cuda_cg.mgz_cycle_reference(A, sm, r, pcr, mgz,
                                                     sweeps, omega,
                                                     omega_c)[0]
    monkeypatch.setattr(cuda_cg, "mgz_precond_reference", precond)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_mgz_fused_solve_matches_pallas_interpret(mgz_system, fused_mgz,
                                                  sweeps):
    """The tolerances of tests/test_torch_mgz.py: counts +- 2, rel-L2
    <= 1e-5, in float64."""
    j, t, _ = mgz_system
    kw = dict(maxiter=5000, rtol_wrt="r0")
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], 1e-10,
                         interpret=True, merged=False, pcr=j["pcr"],
                         mgz=j["mgz"], mgz_sweeps=sweeps, **kw)
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-10,
                            pcr=t["pcr"], mgz=t["mgz"], mgz_sweeps=sweeps,
                            **kw)
    assert abs(int(it) - int(ij)) <= 2, (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-5 * np.linalg.norm(xj)


# ----------------------------------------------------------------------
# the multigrid cycle of mgcg_vmem_tol
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mg_system():
    """The system of tests/test_torch_mgcg.py and its 3-level setups (JAX
    float64, port float64 and float32)."""
    rng = np.random.default_rng(0)
    mesh, A = _operator(2.0)
    shape = A.shape[1:]
    free = np.ones(shape)
    free[0, :] = free[-1, :] = free[:, -1] = 0.0
    free = jnp.asarray(free)
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + (1 - free)
    sm = s * free
    x_true = jnp.asarray(rng.standard_normal(shape)) * free
    b = sm * apply_stencil(A, sm * x_true)
    args = (np.asarray(A), np.asarray(free), mesh.z, mesh.r)
    want = j_mg.build_mg_setup(*args, n_levels=3, dtype=jnp.float64)
    got = cuda_mg.build_mg_setup(*args, n_levels=3, dtype=torch.float64,
                                 device="cpu")
    got32 = cuda_mg.build_mg_setup(*args, n_levels=3, dtype=torch.float32,
                                   device="cpu")
    return dict(b=b, want=want, got=got, got32=got32)


def _level(setup, l):
    lv = setup["levels"][l]
    theta, coefs = cuda_mg.cheb_coefficients(setup["meta"]["lmaxs"][l], 3,
                                             torch.float32)
    return lv["C"], lv["wz"], lv["wr"], theta, coefs


def test_mg_cheb_update_is_the_update_then_the_first_step(mg_system):
    setup = mg_system["got32"]
    C, _, _, theta, _ = _level(setup, 0)
    rng = np.random.default_rng(30)
    r, x, p, Ap = (_field(rng, C[0]) for _ in range(4))
    xn, rn, xo, d, rr = cuda_mg.mg_cheb_update(C, r, x, p, Ap, theta,
                                               state=dict(alpha=0.37))
    a = torch.tensor(0.37, dtype=torch.float32)
    assert torch.equal(xn, x + a * p) and torch.equal(rn, r - a * Ap)
    xw, dw, _ = cuda_mg.mg_cheb_step_reference(C, r - a * Ap, None, None,
                                               theta)
    assert torch.equal(xo, xw) and torch.equal(d, dw)
    assert float(rr) == float(((r - a * Ap).double() ** 2).sum())


@pytest.mark.parametrize("level", [0, 1])
def test_mg_restrict_res_is_the_residual_then_the_restriction(mg_system,
                                                              level):
    setup = mg_system["got32"]
    C, wz, wr, _, _ = _level(setup, level)
    rng = np.random.default_rng(31 + level)
    b, x = _field(rng, C[0]), _field(rng, C[0])
    shape = setup["meta"]["shapes"][level + 1]
    got = cuda_mg.mg_restrict_res(C, b, x, wz, wr, shape)
    want = cuda_mg.mg_restrict_reference(b - cuda_cg.apply_stencil(C, x), wz,
                                         wr, shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("level", [0, 1])
def test_mg_prolong_cheb_is_the_prolongation_then_the_step(mg_system, level):
    setup = mg_system["got32"]
    C, wz, wr, theta, _ = _level(setup, level)
    rng = np.random.default_rng(33 + level)
    b, x, dot = (_field(rng, C[0]) for _ in range(3))
    mask = (_field(rng, C[0]) > -1.0).float()
    xc = _field(rng, setup["levels"][level + 1]["C"][0])
    xo, d, dsum = cuda_mg.mg_prolong_cheb(C, b, x, xc, wz, wr, theta,
                                          mask=mask, dot=dot)
    xp = cuda_mg.mg_prolong_add_reference(x, xc, wz, wr)
    xw, dw, sw = cuda_mg.mg_cheb_step_reference(C, b, xp, None, theta,
                                                mask=mask, dot=dot)
    assert torch.equal(xo, xw) and torch.equal(d, dw)
    assert float(dsum) == float(sw)


def _fused_vcycle(setup, r, nu=2, nu_coarse=10):
    """The cycle as the kernels run it: level 0's first step with the
    update of an alpha of 0, the other levels' first two steps in one pass,
    each residual fused into its restriction, the coarsest level's
    right-hand side and steps in one pass, each prolongation fused into the
    first post-smoothing step."""
    shapes, lmaxs = setup["meta"]["shapes"], setup["meta"]["lmaxs"]
    last = len(setup["levels"]) - 1
    zero = torch.zeros_like(r)
    pre, bs = [], []
    b = r
    for l in range(last):
        C, wz, wr = (setup["levels"][l][k] for k in ("C", "wz", "wr"))
        theta, coefs = cuda_mg.cheb_coefficients(lmaxs[l], nu, r.dtype)
        if l == 0:
            _, b, x, d, _ = cuda_mg.mg_cheb_update(C, b, zero, zero, zero,
                                                   theta,
                                                   state=dict(alpha=0.0))
            rest = coefs
        elif nu > 1:
            x, d = cuda_mg.mg_cheb_pre(C, b, theta, *coefs[0])
            rest = coefs[1:]
        else:
            x, d, _ = cuda_mg.mg_cheb_step(C, b, None, None, theta)
            rest = coefs
        for c1, c2 in rest:
            x, d, _ = cuda_mg.mg_cheb_step(C, b, x, d, theta, c1, c2)
        pre.append(x)
        bs.append(b)
        if l < last - 1:
            b = cuda_mg.mg_restrict_res(C, b, x, wz, wr, shapes[l + 1])
    xc = cuda_mg.mg_last(setup, bs[-1], pre[-1], nu_coarse=nu_coarse)
    for l in range(last - 1, -1, -1):
        C, wz, wr = (setup["levels"][l][k] for k in ("C", "wz", "wr"))
        theta, coefs = cuda_mg.cheb_coefficients(lmaxs[l], nu, r.dtype)
        x, d, _ = cuda_mg.mg_prolong_cheb(C, bs[l], pre[l], xc, wz, wr,
                                          theta)
        for c1, c2 in coefs:
            x, d, _ = cuda_mg.mg_cheb_step(C, bs[l], x, d, theta, c1, c2)
        xc = x
    return xc


@pytest.mark.parametrize("level", [1, 2])
def test_mg_cheb_pre_is_the_first_two_steps(mg_system, level):
    setup = mg_system["got32"]
    C, _, _, theta, coefs = _level(setup, level)
    b = _field(np.random.default_rng(45 + level), C[0])
    x, d = cuda_mg.mg_cheb_pre(C, b, theta, *coefs[0])
    x1, d1, _ = cuda_mg.mg_cheb_step_reference(C, b, None, None, theta)
    xw, dw, _ = cuda_mg.mg_cheb_step_reference(C, b, x1, d1, theta,
                                               *coefs[0])
    assert torch.equal(x, xw) and torch.equal(d, dw)


def test_mg_last_is_the_restriction_then_the_coarse_steps(mg_system):
    setup = mg_system["got32"]
    rng = np.random.default_rng(47)
    P = setup["levels"][-2]
    b, x = _field(rng, P["C"][0]), _field(rng, P["C"][0])
    q = len(setup["levels"]) - 1
    bq = cuda_mg.mg_restrict_reference(
        b - cuda_cg.apply_stencil(P["C"], x), P["wz"], P["wr"],
        setup["meta"]["shapes"][q])
    want = cuda_mg._vcycle(setup, 2, 10)(q, bq)
    assert torch.equal(cuda_mg.mg_last(setup, b, x), want)


@pytest.mark.parametrize("nu,nu_coarse", [(2, 10), (1, 3), (3, 4)])
def test_mg_fused_cycle_is_the_plain_cycle(mg_system, nu, nu_coarse):
    """The cycle from the fused passes equals the plain V-cycle bitwise in
    float32."""
    setup = mg_system["got32"]
    r = _field(np.random.default_rng(50 + nu), setup["levels"][0]["C"][0])
    assert torch.equal(_fused_vcycle(setup, r, nu, nu_coarse),
                       cuda_mg.vcycle_reference(setup, nu, nu_coarse)(r))


@pytest.mark.parametrize("nu,nu_coarse", [(2, 10), (1, 3)])
def test_mg_fused_solve_matches_pallas_interpret(mg_system, monkeypatch, nu,
                                                 nu_coarse):
    """mgcg_vmem_tol's plain version with the cycle built from the fused
    passes, against the Pallas kernel in interpret mode at the tolerances
    of tests/test_torch_mgcg.py (counts +- 1, 1e-10 of the largest value,
    float64)."""
    want, got = mg_system["want"], mg_system["got"]
    monkeypatch.setattr(
        cuda_mg, "vcycle_reference",
        lambda setup, nu=2, nu_coarse=10: lambda r: _fused_vcycle(
            setup, r, nu, nu_coarse))
    b = torch.tensor(np.asarray(mg_system["b"]))
    xj, ij = j_mg.mgcg_vmem_tol(want, mg_system["b"],
                                jnp.zeros_like(mg_system["b"]), 1e-10,
                                maxiter=2000, nu=nu, nu_coarse=nu_coarse,
                                interpret=True)
    xt, it = cuda_mg.mgcg_vmem_tol(got, b, torch.zeros_like(b), 1e-10,
                                   maxiter=2000, nu=nu, nu_coarse=nu_coarse)
    assert abs(int(it) - int(ij)) <= 1, (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()


# ----------------------------------------------------------------------
# the kernels on the card
# ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want, tol):
    for a, b in zip(got, want, strict=True):
        if a is None and b is None:
            continue
        scale = float(b.double().abs().max())
        assert float((a.double() - b.double()).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_cuda_mgz_passes_match_plain(mgz_system):
    dev = _cuda()
    _, _, t = mgz_system
    g = {k: v.to(dev).contiguous() for k, v in t.items() if k != "mgz"}
    m = {k: v.to(dev).contiguous() for k, v in t["mgz"].items()}
    rng = np.random.default_rng(50)
    x, r, p, Ap = (_field(rng, t["b"], t["free"]).to(dev) for _ in range(4))
    st = dict(rz=0.7, rr=1.3, stop2=1e-30, alpha=0.37, beta=0.1, k=3, done=0)
    _close(cuda_cg.mgz_pre(r, g["pcr"], OMEGA, x=x, p=p, Ap=Ap, state=st),
           cuda_cg.mgz_pre_reference(r, g["pcr"], OMEGA, x=x, p=p, Ap=Ap,
                                     alpha=0.37), 1e-5)
    z = cuda_cg.mgz_pre_reference(r, g["pcr"], OMEGA)[2].contiguous()
    args = (g["A"], g["sm"], r, z, m["aux"], m["pcrc"], OMEGA)
    _close(cuda_cg.mgz_coarse(*args), cuda_cg.mgz_coarse_reference(*args),
           1e-5)
    yc, rcs = (v.contiguous() for v in cuda_cg.mgz_coarse_reference(*args))
    _close((cuda_cg.mgz_coarse_res(m["Ac9"], rcs, yc, m["pcrc"], OMEGA),),
           (cuda_cg.mgz_coarse_res_reference(m["Ac9"], rcs, yc, m["pcrc"],
                                             OMEGA),), 1e-5)
    pargs = (g["A"], g["sm"], r, z, yc, m["aux"])
    _close(cuda_cg.mgz_prolong_res(*pargs),
           cuda_cg.mgz_prolong_res_reference(*pargs), 1e-5)
    zp, r1 = (v.contiguous() for v in
              cuda_cg.mgz_prolong_res_reference(*pargs))
    _close(cuda_cg.mgz_post(r1, zp, g["pcr"], OMEGA, g["sm"], r),
           cuda_cg.mgz_post_reference(r1, zp, g["pcr"], OMEGA, g["sm"], r),
           1e-5)


@pytest.mark.cuda
def test_cuda_mg_passes_match_plain(mg_system):
    dev = _cuda()
    got = mg_system["got32"]
    setup = {"A": got["A"].to(dev), "sm": got["sm"].to(dev),
             "levels": [{k: v.to(dev).contiguous() for k, v in lv.items()}
                        for lv in got["levels"]], "meta": got["meta"]}
    rng = np.random.default_rng(60)
    for l in (0, 1):
        C, wz, wr, theta, _ = _level(setup, l)
        b, x, p, Ap = (_field(rng, C[0].cpu()).to(dev) for _ in range(4))
        xc = _field(rng, setup["levels"][l + 1]["C"][0].cpu()).to(dev)
        shape = setup["meta"]["shapes"][l + 1]
        _close((cuda_mg.mg_restrict_res(C, b, x, wz, wr, shape),),
               (cuda_mg.mg_restrict_res_reference(C, b, x, wz, wr, shape),),
               1e-5)
        _close(cuda_mg.mg_prolong_cheb(C, b, x, xc, wz, wr, theta, dot=b),
               cuda_mg.mg_prolong_cheb_reference(C, b, x, xc, wz, wr, theta,
                                                 dot=b), 1e-5)
        _close(cuda_mg.mg_cheb_update(C, b, x, p, Ap, theta,
                                      state=dict(alpha=0.37)),
               cuda_mg.mg_cheb_update_reference(C, b, x, p, Ap, 0.37, theta),
               1e-5)
        if l == 1:
            _close(cuda_mg.mg_cheb_pre(C, b, theta, *_level(setup, l)[4][0]),
                   cuda_mg.mg_cheb_pre_reference(C, b, theta,
                                                 *_level(setup, l)[4][0]),
                   1e-5)
    P = setup["levels"][-2]
    b = _field(rng, P["C"][0].cpu()).to(dev)
    x = _field(rng, P["C"][0].cpu()).to(dev)
    _close((cuda_mg.mg_last(setup, b, x),),
           (cuda_mg.mg_last_reference(setup, b, x),), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [1, 2])
def test_cuda_mgz_and_mg_launches_an_iteration(mgz_system, mg_system,
                                               sweeps):
    """6 launches an mgz iteration with one coarse sweep, 7 with two; at most
    15 a multigrid iteration; counts within max(3, 5 %) of the plain
    version's."""
    dev = _cuda()
    _, _, t = mgz_system
    g = {k: v.to(dev).contiguous() for k, v in t.items() if k != "mgz"}
    m = {k: v.to(dev).contiguous() for k, v in t["mgz"].items()}
    kw = dict(maxiter=5000, rtol_wrt="r0", pcr=g["pcr"], mgz=m,
              mgz_sweeps=sweeps)
    cuda_cg.reset_counters()
    _, ik = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 1e-5, **kw)
    assert cuda_cg.launches_per_iteration()["mgz"] == 5 + sweeps
    _, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                                     **kw)
    assert abs(int(ik) - int(ip)) <= max(3, int(0.05 * int(ip)))
    got = mg_system["got32"]
    setup = {"A": got["A"].to(dev), "sm": got["sm"].to(dev),
             "levels": [{k: v.to(dev).contiguous() for k, v in lv.items()}
                        for lv in got["levels"]], "meta": got["meta"]}
    b = torch.tensor(np.asarray(mg_system["b"]), dtype=torch.float32,
                     device=dev)
    cuda_cg.reset_counters()
    cuda_mg.mgcg_vmem_tol(setup, b, torch.zeros_like(b), 1e-5)
    assert cuda_cg.launches_per_iteration()["mg"] <= 15

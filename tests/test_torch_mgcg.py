"""The multigrid-preconditioned CG (``ops/cuda_mg``) and the fixed-count CG
(``cuda_cg.cg_vmem``) of the port against the JAX package: the host setup
exactly, the plain versions against the Pallas kernels in interpret mode in
float64; the CUDA kernels against the plain versions where a card is
present."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from heatflow_tpu.geometry import build_layout
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.ops import pallas_cg as j_cg
from heatflow_tpu.ops import pallas_mg as j_mg
from heatflow_tpu.ops.stencil import (apply_stencil, assemble_stencils,
                                      combine_operator)
from heatflow_tpu_torch.ops import cuda_cg, cuda_mg
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)


def _system(coarse, trim=0):
    """The system of tests/test_pallas_mg.py; ``trim`` drops trailing grid
    lines so that a side can be made even."""
    cfg = tiny_no_diamond_cfg(coarse=coarse)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = jnp.asarray([m.kappa for m in mats])
    rc = jnp.asarray([m.rho_cv for m in mats])
    A, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M), kp, rc,
                            1.5e-7)
    z, r = mesh.z, mesh.r
    if trim:
        A, z, r = A[:, :-trim, :-trim], z[:-trim], r[:-trim]
    shape = A.shape[1:]
    free = np.ones(shape)
    free[0, :] = free[-1, :] = free[:, -1] = 0.0
    free = jnp.asarray(free)
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + (1 - free)
    sm = s * free
    rng = np.random.default_rng(0)
    x_true = jnp.asarray(rng.standard_normal(shape)) * free
    b = sm * apply_stencil(A, sm * x_true)
    return dict(A=A, sm=sm, free=free, b=b, x_true=x_true, z=z, r=r, s=s)


@pytest.fixture(scope="module")
def system():
    return _system(2.0)


@pytest.fixture(scope="module")
def setups(system):
    args = (np.asarray(system["A"]), np.asarray(system["free"]), system["z"],
            system["r"])
    want = j_mg.build_mg_setup(*args, n_levels=3, dtype=jnp.float64)
    got = cuda_mg.build_mg_setup(*args, n_levels=3, dtype=torch.float64,
                                 device="cpu")
    return want, got


def _same_setup(want, got):
    assert got["meta"]["shapes"] == [tuple(s) for s in want["meta"]["shapes"]]
    assert got["meta"]["lmaxs"] == want["meta"]["lmaxs"]
    assert got["meta"]["orig"] == want["meta"]["orig"]
    assert got["meta"]["padded"] == want["meta"]["padded"]
    for key in ("A", "sm"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert len(got["levels"]) == len(want["levels"])
    for lg, lw in zip(got["levels"], want["levels"]):
        for key in ("C", "wz", "wr"):
            assert lg[key].shape == lw[key].shape
            np.testing.assert_array_equal(lg[key].numpy(),
                                          np.asarray(lw[key]))


def test_build_mg_setup_equals_jax(setups):
    want, got = setups
    assert len(got["levels"]) == 3
    assert got["levels"][0]["C"].shape[0] == 7
    assert got["levels"][1]["C"].shape[0] == 9
    _same_setup(want, got)


@pytest.mark.parametrize("trim", [1, 2])
def test_build_mg_setup_pads_even_sides(trim):
    """A grid with an even side: the padding path (identity rows, the
    extended axes) on the fine and on the coarse levels."""
    sysm = _system(2.0, trim=trim)
    nz, nr = sysm["b"].shape
    args = (np.asarray(sysm["A"]), np.asarray(sysm["free"]), sysm["z"],
            sysm["r"])
    want = j_mg.build_mg_setup(*args, n_levels=3, dtype=jnp.float64)
    got = cuda_mg.build_mg_setup(*args, n_levels=3, dtype=torch.float64,
                                 device="cpu")
    _same_setup(want, got)
    shapes = got["meta"]["shapes"]
    assert all(a % 2 == 1 and b % 2 == 1 for a, b in shapes)
    padded = got["meta"]["padded"] != got["meta"]["orig"] or any(
        ((a + 1) // 2) % 2 == 0 or ((b + 1) // 2) % 2 == 0
        for a, b in shapes[:-1])
    assert padded, (nz, nr, shapes)
    # and the padded solve agrees with the reference's
    b = torch.tensor(np.asarray(sysm["b"]))
    xj, ij = j_mg.mgcg_vmem_tol(want, sysm["b"], jnp.zeros_like(sysm["b"]),
                                1e-10, interpret=True)
    xt, it = cuda_mg.mgcg_vmem_tol(got, b, torch.zeros_like(b), 1e-10)
    assert abs(int(it) - int(ij)) <= 1
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()


def test_setup_defaults_to_the_card_and_raises_without_one(system):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cuda_mg.build_mg_setup(np.asarray(system["A"]),
                               np.asarray(system["free"]), system["z"],
                               system["r"])


@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_plain_matches_pallas_interpret(system, setups, rtol_wrt):
    want, got = setups
    b = torch.tensor(np.asarray(system["b"]))
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal(b.shape) * np.asarray(system["free"]) * 0.1
    xj, ij = j_mg.mgcg_vmem_tol(want, system["b"], jnp.asarray(x0), 1e-10,
                                maxiter=2000, rtol_wrt=rtol_wrt,
                                interpret=True)
    xt, it = cuda_mg.mgcg_vmem_tol(got, b, torch.tensor(x0), 1e-10,
                                   maxiter=2000, rtol_wrt=rtol_wrt)
    assert it.dtype == torch.int32 and it.shape == ()
    assert xt.shape == b.shape
    # the same loop; the sums run in another order, which may move the stop
    # by one iteration
    assert abs(int(it) - int(ij)) <= 1, (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    x_true = np.asarray(system["x_true"])
    assert np.abs(xt.numpy() - x_true).max() <= 1e-8 * np.abs(x_true).max()


def test_mg_beats_plain_cg(system, setups):
    _, got = setups
    t = {k: torch.tensor(np.asarray(system[k])) for k in ("A", "sm", "b")}
    zero = torch.zeros_like(t["b"])
    _, it = cuda_mg.mgcg_vmem_tol(got, t["b"], zero, 1e-10)
    _, it_cg = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], zero, 1e-10,
                              maxiter=40000)
    assert int(it) < int(it_cg) / 3, (int(it), int(it_cg))


def test_nu_and_maxiter(system, setups):
    want, got = setups
    b = torch.tensor(np.asarray(system["b"]))
    zero = torch.zeros_like(b)
    xj, ij = j_mg.mgcg_vmem_tol(want, system["b"], jnp.zeros_like(system["b"]),
                                1e-9, nu=1, nu_coarse=3, interpret=True)
    xt, it = cuda_mg.mgcg_vmem_tol(got, b, zero, 1e-9, nu=1, nu_coarse=3)
    assert abs(int(it) - int(ij)) <= 1
    assert np.abs(xt.numpy() - np.asarray(xj)).max() \
        <= 1e-9 * np.abs(np.asarray(xj)).max()
    _, it = cuda_mg.mgcg_vmem_tol(got, b, zero, 1e-14, maxiter=3)
    assert int(it) == 3
    with pytest.raises(ValueError, match="nu"):
        cuda_mg.mgcg_vmem_tol(got, b, zero, 1e-6, nu=0)
    with pytest.raises(ValueError, match="rtol_wrt"):
        cuda_mg.mgcg_vmem_tol(got, b, zero, 1e-6, rtol_wrt="x")


def test_vcycle_matches_jax_and_is_symmetric(system, setups):
    """The plain V-cycle against the reference's unrolled one (run outside
    Pallas on plain arrays), and ⟨v, M⁻¹u⟩ = ⟨u, M⁻¹v⟩."""
    want, got = setups
    refs = [{k: lv[k] for k in ("C", "wz", "wr")} for lv in want["levels"]]
    meta = dict(shapes=want["meta"]["shapes"], lmaxs=want["meta"]["lmaxs"])
    vj = j_mg._make_vcycle(refs, meta, jnp.float64, 2, 10)
    rng = np.random.default_rng(3)
    pz, pr = got["meta"]["padded"]
    u, v = rng.standard_normal((2, pz, pr))
    zj = np.asarray(vj(jnp.asarray(u)))
    zt = cuda_mg.vcycle_reference(got, 2, 10)(torch.tensor(u)).numpy()
    assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()
    # as CG applies it: to residuals that vanish at constrained nodes
    fm = (got["sm"] > 0).double()
    u, v = torch.tensor(u) * fm, torch.tensor(v) * fm
    Mu, _ = cuda_mg.mg_vcycle(got, u)
    Mv, rz = cuda_mg.mg_vcycle(got, v)
    a, b = float((v * Mu).sum()), float((u * Mv).sum())
    assert abs(a - b) <= 1e-10 * float(v.norm() * Mu.norm())
    assert float(rz) == pytest.approx(float((v * Mv).sum()), rel=1e-13)
    assert float(rz) > 0


def test_restriction_is_the_transpose_of_prolongation_and_repeatable(setups):
    _, got = setups
    lv = got["levels"][0]
    nz, nr = got["meta"]["shapes"][0]
    mz, mr = (nz + 1) // 2, (nr + 1) // 2
    rng = np.random.default_rng(7)
    f = torch.tensor(rng.standard_normal((nz, nr)))
    c = torch.tensor(rng.standard_normal((mz, mr)))
    Rf = cuda_mg.restrict2d(f, lv["wz"], lv["wr"])
    Pc = cuda_mg.prolong2d(c, lv["wz"], lv["wr"])
    assert Rf.shape == (mz, mr) and Pc.shape == (nz, nr)
    lhs, rhs = float((Rf * c).sum()), float((f * Pc).sum())
    assert abs(lhs - rhs) <= 1e-14 * max(abs(lhs), float(f.norm() * Pc.norm()))
    # against the reference's reshape transfers
    np.testing.assert_allclose(
        Rf.numpy(), np.asarray(j_mg._restrict2d(
            jnp.asarray(f.numpy()), jnp.asarray(lv["wz"].numpy()),
            jnp.asarray(lv["wr"].numpy()))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        Pc.numpy(), np.asarray(j_mg._prolong2d(
            jnp.asarray(c.numpy()), jnp.asarray(lv["wz"].numpy()),
            jnp.asarray(lv["wr"].numpy()))), rtol=0, atol=1e-14)
    assert torch.equal(Rf, cuda_mg.restrict2d(f, lv["wz"], lv["wr"]))
    shape = got["meta"]["shapes"][1]
    out = cuda_mg.mg_restrict(f, lv["wz"], lv["wr"], shape)
    assert out.shape == tuple(shape)
    assert torch.equal(out[:mz, :mr], Rf)
    assert float(out[mz:].abs().sum() + out[:, mr:].abs().sum()) == 0.0
    x = torch.tensor(rng.standard_normal((nz, nr)))
    assert torch.equal(cuda_mg.mg_prolong_add(x, out, lv["wz"], lv["wr"]),
                       x + cuda_mg.prolong2d(out[:mz, :mr], lv["wz"],
                                             lv["wr"]))


def test_cheb_step_wrapper_on_cpu_is_the_plain_smoother(setups):
    """Stepping the level smoother through :func:`mg_cheb_step` gives the
    reference's ``_cheb`` on that level."""
    want, got = setups
    lv, lmax = got["levels"][1], got["meta"]["lmaxs"][1]
    rng = np.random.default_rng(11)
    b, x0 = (torch.tensor(a) for a in rng.standard_normal(
        (2,) + tuple(got["meta"]["shapes"][1])))
    theta, coefs = cuda_mg.cheb_coefficients(lmax, 4, torch.float64)
    x, d, _ = cuda_mg.mg_cheb_step(lv["C"], b, x0, None, theta)
    for c1, c2 in coefs:
        x, d, _ = cuda_mg.mg_cheb_step(lv["C"], b, x, d, theta, c1, c2)
    Cj = want["levels"][1]["C"]
    dinv = jnp.where(Cj[0] != 0, 1.0 / Cj[0], 1.0)
    xj = j_mg._cheb(lambda v: j_cg._apply7(Cj, v), dinv, jnp.asarray(b.numpy()),
                    jnp.asarray(x0.numpy()), lmax, 4, jnp.float64)
    assert np.abs(x.numpy() - np.asarray(xj)).max() \
        <= 1e-13 * np.abs(np.asarray(xj)).max()
    res = cuda_mg.mg_residual(lv["C"], b, x)
    assert torch.equal(res, b - cuda_cg.apply_stencil(lv["C"], x))


def test_cheb_coefficients_round_in_the_working_type():
    t32, c32 = cuda_mg.cheb_coefficients(1.9, 3, torch.float32)
    t64, c64 = cuda_mg.cheb_coefficients(1.9, 3, torch.float64)
    assert len(c32) == len(c64) == 2
    assert t32 == float(np.float32(t32)) and t32 != t64
    assert all(c == float(np.float32(c)) for pair in c32 for c in pair)
    assert abs(t32 - t64) <= 1e-6 and abs(c32[1][0] - c64[1][0]) <= 1e-6


# ----------------------------------------------------------------------
# the fixed-count CG on a baked operator
# ----------------------------------------------------------------------

def _jax_cg_vmem_interpret(C, b, x0, iters):
    """heatflow_tpu's ``_cg_kernel`` under its own ``pallas_call`` in
    interpret mode (``cg_vmem`` has no interpret argument)."""
    return pl.pallas_call(
        functools.partial(j_cg._cg_kernel, iters=iters),
        out_shape=jax.ShapeDtypeStruct(b.shape, b.dtype),
        interpret=True)(C, b, x0)


@pytest.fixture(scope="module")
def baked():
    sysm = _system(3.0)
    rng = np.random.default_rng(1)
    free = jnp.asarray((rng.random(sysm["b"].shape) > 0.15).astype(float))
    Cj, sj = j_cg.masked_scaled_operator(sysm["A"], free)
    b = jnp.asarray(rng.standard_normal(free.shape)) * free
    x0 = jnp.asarray(rng.standard_normal(free.shape)) * free
    return sysm["A"], free, Cj, sj, b, x0


def test_masked_scaled_operator_matches_jax(baked):
    A, free, Cj, sj, _, _ = baked
    At, ft = torch.tensor(np.asarray(A)), torch.tensor(np.asarray(free))
    Ct, st = cuda_cg.masked_scaled_operator(At, ft)
    assert Ct.shape == Cj.shape and st.shape == sj.shape
    assert np.abs(Ct.numpy() - np.asarray(Cj)).max() \
        <= 1e-14 * np.abs(np.asarray(Cj)).max()
    assert np.abs(st.numpy() - np.asarray(sj)).max() \
        <= 1e-14 * np.abs(np.asarray(sj)).max()
    # leading batch dimensions carry through
    Ab = torch.stack([At, 2.0 * At])
    Cb, sb = cuda_cg.masked_scaled_operator(Ab, ft)
    assert Cb.shape == (2,) + tuple(Ct.shape) and torch.equal(Cb[0], Ct)
    C2, _ = cuda_cg.masked_scaled_operator(2.0 * At, ft)
    assert torch.equal(Cb[1], C2) and torch.equal(sb[0], st)


@pytest.mark.parametrize("iters", [1, 64])
def test_cg_vmem_plain_matches_pallas_interpret(baked, iters):
    _, _, Cj, _, b, x0 = baked
    want = np.asarray(_jax_cg_vmem_interpret(Cj, b, x0, iters))
    t = [torch.tensor(np.asarray(a)) for a in (Cj, b, x0)]
    got = cuda_cg.cg_vmem(*t, iters=iters)
    assert torch.equal(got, cuda_cg.cg_vmem_reference(*t, iters=iters))
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_cg_vmem_converges_and_guards(baked):
    _, free, Cj, _, b, x0 = baked
    C, bt = torch.tensor(np.asarray(Cj)), torch.tensor(np.asarray(b))
    x = cuda_cg.cg_vmem(C, bt, torch.zeros_like(bt), iters=400)
    res = bt - cuda_cg.apply_stencil(C, x)
    assert float(res.norm()) <= 1e-8 * float(bt.norm())
    # a zero right-hand side: every guard divides by 1 and x stays x0 = 0
    zero = torch.zeros_like(bt)
    assert torch.equal(cuda_cg.cg_vmem(C, zero, zero, iters=5), zero)


def test_no_fallback_off_cpu(setups):
    _, got = setups
    pz, pr = got["meta"]["orig"]
    b = torch.zeros((pz, pr), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="devices"):
        cuda_mg.mgcg_vmem_tol(got, b, b, 1e-6)
    C = got["levels"][0]["C"]
    with pytest.raises(ValueError, match="devices"):
        cuda_cg.cg_vmem(C, b, b)


@pytest.mark.cuda
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_cuda_mgcg_matches_plain(system, rtol_wrt):
    """The CUDA path in float32 against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    setup = cuda_mg.build_mg_setup(
        np.asarray(system["A"]), np.asarray(system["free"]), system["z"],
        system["r"], n_levels=3)
    b = torch.tensor(np.asarray(system["b"]), dtype=torch.float32,
                     device="cuda")
    cuda_mg.reset_counters()
    xk, ik = cuda_mg.mgcg_vmem_tol(setup, b, torch.zeros_like(b), 1e-5,
                                   rtol_wrt=rtol_wrt)
    assert cuda_mg.mgcg_vmem_tol.launches == 1
    assert cuda_cg.phase_launches()["mg_cheb"] > 0
    xp, ip = cuda_mg.mgcg_tol_reference(setup, b, torch.zeros_like(b), 1e-5,
                                        rtol_wrt=rtol_wrt)
    assert abs(int(ik) - int(ip)) <= max(3, int(0.05 * int(ip)))
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3


@pytest.mark.cuda
def test_cuda_cg_vmem_matches_plain(baked):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, _, Cj, _, b, x0 = baked
    g = [torch.tensor(np.asarray(a), dtype=torch.float32,
                      device="cuda").contiguous() for a in (Cj, b, x0)]
    cuda_mg.reset_counters()
    xk = cuda_cg.cg_vmem(*g, iters=64)
    assert cuda_cg.cg_vmem.launches == 1
    xp = cuda_cg.cg_vmem_reference(*g, iters=64)
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3

"""The CG solve kernel's plain version (``cg_tol`` on CPU tensors) against
the JAX package's Pallas kernel in interpret mode, in float64; the CUDA
kernel against the plain version where a card is present."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.geometry import build_layout
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.ops.pallas_cg import cg_vmem_tol
from heatflow_tpu.ops.pallas_cg import pcr_pack as j_pcr_pack
from heatflow_tpu.ops.stencil import (apply_stencil, assemble_stencils,
                                      combine_operator)
from heatflow_tpu_torch.ops import cuda_cg
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

FORMS = ("identity", "rline", "adi")


@pytest.fixture(scope="module")
def system():
    """The system fixture of the JAX kernel tests (tests/test_pallas_cg.py),
    with both PCR stacks packed by each package, and the port's r-line
    operand (the rows' Thomas factors)."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = jnp.asarray([m.kappa for m in mats])
    rc = jnp.asarray([m.rho_cv for m in mats])
    A, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M), kp, rc,
                            1.5e-7)
    rng = np.random.default_rng(0)
    free = jnp.asarray((rng.random(mesh.shape) > 0.15).astype(float))
    s = jax.lax.rsqrt(jnp.where(A[0] > 0, A[0], 1.0)) * free + (1 - free)
    sm = s * free
    x_true = jnp.asarray(rng.standard_normal(mesh.shape)) * free
    b = sm * apply_stencil(A, sm * x_true)
    x0 = jnp.asarray(rng.standard_normal(mesh.shape)) * free
    j = dict(A=A, sm=sm, b=b, x0=x0, pcr=j_pcr_pack(A, s, free),
             pcr_z=j_pcr_pack(A, s, free, axis=-2))
    t = {k: torch.tensor(np.asarray(v)) for k, v in j.items()}
    t["pcr_stack"] = cuda_cg.pcr_pack(t["A"], torch.tensor(np.asarray(s)),
                                      torch.tensor(np.asarray(free)))
    t["pcr"] = cuda_cg.rline_pack(t["A"], torch.tensor(np.asarray(s)),
                                  torch.tensor(np.asarray(free)))
    t["pcr_z"] = cuda_cg.pcr_pack(t["A"], torch.tensor(np.asarray(s)),
                                  torch.tensor(np.asarray(free)), axis=-2)
    return j, t, np.asarray(x_true)


def _stacks(d, form):
    return {"identity": {}, "rline": {"pcr": d["pcr"]},
            "adi": {"pcr": d["pcr"], "pcr_z": d["pcr_z"]}}[form]


@pytest.mark.parametrize("axis", [-1, -2])
def test_pcr_pack_matches_jax(system, axis):
    j, t, _ = system
    key = "pcr" if axis == -1 else "pcr_z"
    want = np.asarray(j[key])
    got = t["pcr_stack" if axis == -1 else key].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_plain_matches_pallas_interpret(system, form, rtol_wrt):
    j, t, x_true = system
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], 1e-11,
                         maxiter=20000, rtol_wrt=rtol_wrt, interpret=True,
                         merged=False, **_stacks(j, form))
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-11,
                            maxiter=20000, rtol_wrt=rtol_wrt,
                            **_stacks(t, form))
    assert it.dtype == torch.int32 and it.shape == ()
    # the same recurrence; the reductions sum in another order, which may
    # move the stop by one iteration
    assert abs(int(it) - int(ij)) <= 1, (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.abs(xt.numpy() - x_true).max() <= 1e-8 * np.abs(x_true).max()


@pytest.mark.parametrize("form", FORMS)
def test_rtol_two_stops_at_zero_iterations(system, form):
    j, t, _ = system
    zero_j, zero_t = jnp.zeros_like(j["b"]), torch.zeros_like(t["b"])
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], zero_j, 2.0, maxiter=100,
                         rtol_wrt="b", interpret=True, **_stacks(j, form))
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], zero_t,
                            torch.tensor(2.0, dtype=torch.float64),
                            maxiter=100, rtol_wrt="b", **_stacks(t, form))
    assert int(ij) == 0 and int(it) == 0
    assert torch.equal(xt, zero_t)


@pytest.mark.parametrize("form", FORMS)
def test_nan_rhs_poisons_solution(system, form):
    j, t, _ = system
    bj = j["b"].at[3, 4].set(jnp.nan)
    bt = t["b"].clone()
    bt[3, 4] = float("nan")
    xj, ij = cg_vmem_tol(j["A"], j["sm"], bj, j["x0"], 1e-8, maxiter=100,
                         interpret=True, **_stacks(j, form))
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], bt, t["x0"], 1e-8, maxiter=100,
                            **_stacks(t, form))
    assert np.isnan(np.asarray(xj)).all() and torch.isnan(xt).all()
    assert int(it) == int(ij) == 0


def test_maxiter_caps_the_count(system):
    j, t, _ = system
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], 1e-14, maxiter=7,
                         interpret=True, merged=False)
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-14,
                            maxiter=7)
    assert int(it) == int(ij) == 7
    assert np.abs(xt.numpy() - np.asarray(xj)).max() \
        <= 1e-10 * np.abs(np.asarray(xj)).max()


@pytest.mark.parametrize("form", ["rline", "adi"])
def test_phase_wrappers_on_cpu_are_the_plain_phases(system, form):
    _, t, _ = system
    p = torch.tensor(np.random.default_rng(4).standard_normal(
        t["b"].shape)) * (t["sm"] != 0)
    Ap, pap = cuda_cg.stencil_dot(t["A"], t["sm"], p)
    assert torch.equal(Ap, t["sm"] * cuda_cg.apply_stencil(
        t["A"], t["sm"] * p))
    assert float(pap) == pytest.approx(float((p * Ap).sum()), rel=1e-14)
    z, rz = cuda_cg.precond(t["sm"], p, **_stacks(t, form))
    z_ref, rz_ref = cuda_cg.precond_reference(t["sm"], p,
                                              **_stacks(t, form))
    assert torch.equal(z, z_ref) and float(rz) == float(rz_ref)


def _form_kw(d, form):
    """cheb2..cheb4, the merged recurrence over identity, r-line, ADI and
    Chebyshev (K1's forms beside the standard ones)."""
    if form.startswith("merged_"):
        return dict(_form_kw(d, form[len("merged_"):]), merged=True)
    if form.startswith("cheb"):
        return dict(cheb_degree=int(form[4:]))
    return dict(_stacks(d, form))


@pytest.mark.parametrize("form", ["cheb2", "cheb3", "cheb4",
                                  "merged_identity", "merged_rline",
                                  "merged_adi", "merged_cheb3"])
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_cheb_and_merged_plain_match_pallas_interpret(system, form, rtol_wrt):
    """The Chebyshev and merged-dot forms: the plain version against the
    Pallas kernel in interpret mode in float64 (the same recurrence: counts
    within 1, x within 1e-10), and the merged forms against the standard
    recurrence at solve tolerance."""
    j, t, x_true = system
    kw = dict(maxiter=20000, rtol_wrt=rtol_wrt)
    jkw = dict(_form_kw(j, form))
    jkw.setdefault("merged", False)
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], 1e-11,
                         interpret=True, **kw, **jkw)
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-11, **kw,
                            **_form_kw(t, form))
    assert abs(int(it) - int(ij)) <= 1, (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.abs(xt.numpy() - x_true).max() <= 1e-8 * np.abs(x_true).max()
    if form.startswith("merged_"):
        std = dict(_form_kw(t, form), merged=False)
        xs, its = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-11,
                                 **kw, **std)
        assert abs(int(it) - int(its)) <= 3
        assert np.abs(xt.numpy() - xs.numpy()).max() \
            <= 1e-8 * np.abs(xs.numpy()).max()


def test_cheb_cuts_identity_iterations_and_lmax_bounds_the_spectrum(system):
    _, t, _ = system
    args = (t["A"], t["sm"], t["b"], t["x0"], 1e-10)
    it0 = int(cuda_cg.cg_tol(*args)[1])
    it3 = int(cuda_cg.cg_tol(*args, cheb_degree=3)[1])
    assert it3 < 0.6 * it0, (it3, it0)
    lmax = float(cuda_cg.gershgorin_lmax(t["A"], t["sm"]))
    v = torch.tensor(np.random.default_rng(2).standard_normal(t["b"].shape))
    for _ in range(50):          # power iteration from below
        v = t["sm"] * cuda_cg.apply_stencil(t["A"], t["sm"] * v)
        v = v / v.norm()
    lam = float((v * (t["sm"] * cuda_cg.apply_stencil(
        t["A"], t["sm"] * v))).sum())
    assert 0 < lam <= lmax * (1 + 1e-12)


def test_merged_default_is_read_at_call_time(system):
    _, t, _ = system
    args = (t["A"], t["sm"], t["b"], t["x0"], 1e-9)
    want = cuda_cg.cg_tol(*args, pcr=t["pcr"], merged=True)[0]
    std = cuda_cg.cg_tol(*args, pcr=t["pcr"])[0]
    assert cuda_cg.MERGED_DEFAULT is False
    cuda_cg.MERGED_DEFAULT = True
    try:
        got = cuda_cg.cg_tol(*args, pcr=t["pcr"])[0]
        ref = cuda_cg.cg_tol_reference(*args, pcr=t["pcr"])[0]
    finally:
        cuda_cg.MERGED_DEFAULT = False
    assert torch.equal(got, want) and torch.equal(ref, want)
    assert not torch.equal(got, std)


@pytest.mark.parametrize("form", ["cheb3", "merged_rline"])
def test_new_forms_guards(system, form):
    """rtol 2 stops at zero iterations; a NaN rhs poisons x; maxiter caps."""
    _, t, _ = system
    fkw = _form_kw(t, form)
    zero = torch.zeros_like(t["b"])
    x, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], zero, 2.0, maxiter=50,
                           rtol_wrt="b", **fkw)
    assert int(it) == 0 and torch.equal(x, zero)
    bn = t["b"].clone()
    bn[3, 4] = float("nan")
    x, it = cuda_cg.cg_tol(t["A"], t["sm"], bn, t["x0"], 1e-8, maxiter=50,
                           **fkw)
    assert torch.isnan(x).all() and int(it) == 0
    _, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-14,
                           maxiter=5, **fkw)
    assert int(it) == 5


def test_merged_phase_wrappers_on_cpu_are_the_plain_phases(system):
    _, t, _ = system
    rng = np.random.default_rng(9)
    free = (t["sm"] != 0).double()
    u, r, p, q = (torch.tensor(rng.standard_normal(t["b"].shape)) * free
                  for _ in range(4))
    w, delta, rr, gamma = cuda_cg.merged_w(t["A"], t["sm"], u, r)
    assert torch.equal(w, t["sm"] * cuda_cg.apply_stencil(t["A"],
                                                          t["sm"] * u))
    assert float(delta) == pytest.approx(float((w * u).sum()), rel=1e-13)
    assert float(rr) == pytest.approx(float((r * r).sum()), rel=1e-13)
    assert float(gamma) == pytest.approx(float((r * u).sum()), rel=1e-13)
    p_n, q_n = cuda_cg.pq_update(p, q, u, w, 0.25)
    assert torch.equal(p_n, u + 0.25 * p) and torch.equal(q_n, w + 0.25 * q)
    st = dict(rz=2.0, rr=1.0, stop2=1e-3, alpha=0.5, beta=0.0, k=4, done=0)
    nxt = cuda_cg.finalize_merged(st, 3.0, 1.0, 1.0, first=False,
                                  preconditioned=True, maxiter=9,
                                  device="cpu")
    # beta = 1/2, alpha' = 1 / (3 - 0.5 * 1 / 0.5)
    assert nxt["beta"] == 0.5 and nxt["alpha"] == 0.5 and nxt["k"] == 5
    assert nxt["done"] == 0 and nxt["rz"] == 1.0
    first = cuda_cg.finalize_merged(st, 3.0, 1.0, 1.0, 9.0, first=True,
                                    preconditioned=True, rtol=0.5,
                                    maxiter=9, rtol_wrt="b", device="cpu")
    assert first["alpha"] == 1 / 3 and first["stop2"] == 0.25 * 9
    assert first["k"] == 0 and first["done"] == 1


def nine_plane_system(n_lanes: int = 0):
    """An SPD 9-plane operator with a known solution, in numpy: level 1 of
    the multigrid hierarchy of the tiny no-diamond operator (a Galerkin
    product, so both anti-diagonal planes are filled), under a random
    Dirichlet pattern. With ``n_lanes`` also a second 9-plane operator Kv
    (the same level of the hierarchy at another time step, minus the
    first), so that A0 + dk·Kv, dk in [0, 1], is a convex combination of
    the two and SPD, with per-lane scalings, solutions and seeds."""
    from heatflow_tpu.ops.pallas_mg import build_mg_setup
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = jnp.asarray([m.kappa for m in mats])
    rc = jnp.asarray([m.rho_cv for m in mats])
    ones = np.ones(mesh.shape)
    levels = []
    for dt in (1.5e-7, 6.0e-7):
        A7, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                                 kp, rc, dt)
        setup = build_mg_setup(np.asarray(A7), ones, mesh.z, mesh.r,
                               n_levels=2, dtype=jnp.float64)
        levels.append(np.asarray(setup["levels"][1]["C"]))
    A9 = levels[0]
    assert A9.shape[0] == 9 and np.abs(A9[7:]).max() > 1e-3 * np.abs(A9).max()
    shape = A9.shape[1:]
    rng = np.random.default_rng(9)
    free = (rng.random(shape) > 0.15).astype(float)
    if not n_lanes:
        s = 1.0 / np.sqrt(np.where(A9[0] > 0, A9[0], 1.0)) * free + (1 - free)
        sm = s * free
        x_true = rng.standard_normal(shape) * free
        b = sm * np.asarray(apply_stencil(jnp.asarray(A9),
                                          jnp.asarray(sm * x_true)))
        x0 = rng.standard_normal(shape) * free
        return dict(A=A9, s=s, free=free, sm=sm, b=b, x0=x0, x_true=x_true)
    Kv = levels[1] - A9
    dks = np.linspace(0.0, 1.0, n_lanes)
    diag = A9[0][None] + dks[:, None, None] * Kv[0][None]
    s = 1.0 / np.sqrt(np.where(diag > 0, diag, 1.0)) * free + (1 - free)
    sm = s * free
    x_true = rng.standard_normal((n_lanes,) + shape) * free
    b = np.stack([sm[i] * np.asarray(apply_stencil(
        jnp.asarray(A9 + dks[i] * Kv), jnp.asarray(sm[i] * x_true[i])))
        for i in range(n_lanes)])
    x0 = rng.standard_normal((n_lanes,) + shape) * free
    return dict(A0=A9, Kv=Kv, dks=dks, sm=sm, s=s, free=free, b=b, x0=x0,
                x_true=x_true)


@pytest.fixture(scope="module")
def nine():
    d = nine_plane_system()
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.tensor(v) for k, v in d.items()}
    for axis, key in ((-1, "pcr"), (-2, "pcr_z")):
        j[key] = j_pcr_pack(j["A"], j["s"], j["free"], axis=axis)
        t[key] = cuda_cg.pcr_pack(t["A"], t["s"], t["free"], axis=axis)
    t["pcr_stack"] = t["pcr"]
    t["pcr"] = cuda_cg.rline_pack(t["A"], t["s"], t["free"])
    return j, t, d["x_true"]


@pytest.mark.parametrize("axis", [-1, -2])
def test_nine_plane_pcr_pack_drops_the_anti_diagonals_like_jax(nine, axis):
    """The line factors of a 9-plane operator read its planes 1-4 only, in
    both packages: equal stacks, and equal to the stack of the same operator
    with its two anti-diagonal planes zeroed."""
    from heatflow_tpu.ops import linesolve as jls
    from heatflow_tpu_torch.ops import linesolve as tls
    j, t, _ = nine
    key = "pcr" if axis == -1 else "pcr_z"
    tkey = "pcr_stack" if axis == -1 else key
    want, got = np.asarray(j[key]), t[tkey].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    lj, uj = jls.line_couplings(j["A"], j["s"] * j["free"], axis)
    lt, ut = tls.line_couplings(t["A"], t["s"] * t["free"], axis)
    assert np.abs(lt.numpy() - np.asarray(lj)).max() <= 1e-15
    assert np.abs(ut.numpy() - np.asarray(uj)).max() <= 1e-15
    A7 = t["A"].clone()
    A7[7:] = 0.0
    assert torch.equal(cuda_cg.pcr_pack(A7, t["s"], t["free"], axis=axis),
                       t[tkey])


@pytest.mark.parametrize("form", FORMS)
def test_nine_plane_plain_matches_pallas_interpret(nine, form):
    """K1's plain version on a 9-plane system against the Pallas kernel in
    interpret mode in float64: the anti-diagonal planes enter the operator
    (the solve reaches the known solution) and not the line factors."""
    j, t, x_true = nine
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], 1e-11,
                         maxiter=20000, interpret=True, merged=False,
                         **_stacks(j, form))
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-11,
                            maxiter=20000, **_stacks(t, form))
    assert int(it) == int(ij), (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.abs(xt.numpy() - x_true).max() <= 1e-8 * np.abs(x_true).max()
    # a 7-plane reading of the same planes solves another system
    x7, _ = cuda_cg.cg_tol(t["A"][:7].contiguous(), t["sm"], t["b"], t["x0"],
                           1e-11, maxiter=20000)
    assert np.abs(x7.numpy() - x_true).max() > 1e-3 * np.abs(x_true).max()


def test_no_fallback_off_cpu(system):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not computed on the CPU."""
    _, t, _ = system
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="devices"):
        cuda_cg.cg_tol(meta["A"], meta["sm"], meta["b"], meta["x0"], 1e-6)
    with pytest.raises(ValueError, match="devices"):
        cuda_cg.cg_tol(t["A"], t["sm"], meta["b"], t["x0"], 1e-6)


def test_build_is_lazy_and_needs_nvcc():
    from heatflow_tpu_torch.ops import _build
    assert _build._lib is None or torch.cuda.is_available()
    if shutil.which("nvcc") is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.find_nvcc()
    assert _build.library_path().startswith(_build.BUILD_DIR)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_cuda_kernel_matches_plain(system, form):
    """The CUDA kernel in float32 against the plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = system
    dev = torch.device("cuda")
    g = {k: v.to(dev, torch.float32).contiguous() for k, v in t.items()}
    cuda_cg.reset_counters()
    xk, ik = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                            maxiter=5000, **_stacks(g, form))
    assert cuda_cg.cg_tol.launches == 1
    assert getattr(cuda_cg.cg_tol, f"launches_{form}") == 1
    xp, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                                      maxiter=5000, **_stacks(g, form))
    assert abs(int(ik) - int(ip)) <= max(3, int(0.05 * int(ip)))
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["cheb3", "merged_rline", "merged_adi",
                                  "merged_cheb3"])
def test_cuda_kernel_new_forms_match_plain(system, form):
    """The Chebyshev and merged-dot forms of the CUDA kernel in float32
    against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = system
    dev = torch.device("cuda")
    g = {k: v.to(dev, torch.float32).contiguous() for k, v in t.items()}
    cuda_cg.reset_counters()
    fkw = _form_kw(g, form)
    xk, ik = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                            maxiter=5000, **fkw)
    assert cuda_cg.cg_tol.launches == 1
    assert cuda_cg.cg_tol.launches_merged == int("merged" in form)
    assert cuda_cg.cg_tol.launches_cheb == int("cheb" in form)
    xp, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                                      maxiter=5000, **fkw)
    assert abs(int(ik) - int(ip)) <= max(3, int(0.05 * int(ip)))
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_cuda_kernel_nine_plane_matches_plain(nine, form):
    """The CUDA kernel's 9-plane branch in float32 against the plain
    version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = nine
    dev = torch.device("cuda")
    g = {k: v.to(dev, torch.float32).contiguous() for k, v in t.items()}
    xk, ik = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                            maxiter=5000, **_stacks(g, form))
    xp, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                                      maxiter=5000, **_stacks(g, form))
    assert abs(int(ik) - int(ip)) <= max(3, int(0.05 * int(ip)))
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3

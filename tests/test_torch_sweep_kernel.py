"""The batched sweep solves' plain versions (``cg_batched_tol`` and
``cg_batched`` on CPU tensors) and ``pcg_fixed`` against the JAX package:
the Pallas kernels K2/K3 in interpret mode and the XLA ``pcg_fixed``, in
float64 (and float32 where stated); the CUDA kernels against the plain
versions where a card is present."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.geometry import build_layout
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.ops import cg as jcg
from heatflow_tpu.ops import linesolve as jls
from heatflow_tpu.ops.pallas_cg import cg_vmem_batched, cg_vmem_batched_tol
from heatflow_tpu.ops.stencil import (apply_stencil, assemble_stencils,
                                      combine_operator)
from heatflow_tpu_torch.ops import cg as tcg
from heatflow_tpu_torch.ops import cuda_sweep
from heatflow_tpu_torch.ops import linesolve as tls
from heatflow_tpu_torch.ops.stencil import apply_combined
from heatflow_tpu_torch.ops.stencil import apply_stencil as t_apply
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

X_TOL = 1e-10      # float64: the same recurrence, sums in another order
FIXED_TOL = 1e-12  # float64: pcg_fixed, the same operations in order


@pytest.fixture(scope="module")
def batch():
    """Three lanes of the tiny no-diamond operator A0 + dk_b·K_sample with
    a random Dirichlet pattern, a known solution and a random seed per
    lane, in numpy (float64)."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh, backend="numpy")
    kp = np.array([m.kappa for m in mats])
    rc = np.array([m.rho_cv for m in mats])
    dt = 1.5e-7
    A0, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                             jnp.asarray(kp), jnp.asarray(rc), dt)
    A0 = np.asarray(A0)
    Kv = np.asarray(pack.K)[list(mesh.material_tags).index("p_sample")]
    dks = (np.array([2.0, 3.8, 40.0]) - 3.8) * dt
    rng = np.random.default_rng(0)
    free = (rng.random(mesh.shape) > 0.15).astype(float)
    diag = A0[0][None] + dks[:, None, None] * Kv[0][None]
    s = 1.0 / np.sqrt(np.where(diag > 0, diag, 1.0)) * free + (1 - free)
    sm = s * free
    x_true = rng.standard_normal((3,) + mesh.shape) * free
    b = np.stack([sm[i] * np.asarray(apply_stencil(
        jnp.asarray(A0 + dks[i] * Kv), jnp.asarray(sm[i] * x_true[i])))
        for i in range(3)])
    x0 = rng.standard_normal((3,) + mesh.shape) * free
    return dict(A0=A0, Kv=Kv, dks=dks, sm=sm, s=s, free=free, b=b, x0=x0,
                x_true=x_true)


def _t(d, dtype=torch.float64):
    return {k: torch.tensor(v, dtype=dtype) for k, v in d.items()}


def _j(d, dtype=jnp.float64):
    return {k: jnp.asarray(v, dtype) for k, v in d.items()}


def _args(d):
    return d["A0"], d["Kv"], d["dks"], d["sm"], d["b"], d["x0"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("precondition", ["jacobi", "rline"])
def test_pcg_fixed_matches_jax(batch, precondition):
    """Batched over the lanes in the port, one lane at a time in JAX."""
    t, j = _t(batch), _j(batch)
    want = []
    for i in range(3):
        A = j["A0"] + j["dks"][i] * j["Kv"]
        pre = (None if precondition == "jacobi" else
               jls.line_preconditioner(A, j["s"][i], j["free"]))
        want.append(np.asarray(jcg.pcg_fixed(
            lambda y: j["sm"][i] * apply_stencil(A, j["sm"][i] * y),
            j["b"][i], j["x0"][i], precond=pre, mask=j["free"],
            iters=25).x))
    pre = (None if precondition == "jacobi" else tls.line_preconditioner(
        t["A0"], t["s"], t["free"], Kv=t["Kv"], dk=t["dks"]))
    got = tcg.pcg_fixed(
        lambda y: t["sm"] * apply_combined(t["A0"], t["Kv"], t["dks"],
                                           t["sm"] * y),
        t["b"], t["x0"], precond=pre, mask=t["free"], iters=25)
    assert got.iters.tolist() == [25, 25, 25]
    assert _rel(got.x.numpy(), np.stack(want)) <= FIXED_TOL


def test_pcg_fixed_single_problem_and_zero_iterations(batch):
    t = _t(batch)
    op = lambda y: t["sm"][0] * apply_combined(
        t["A0"], t["Kv"], t["dks"][:1], t["sm"][:1] * y)[0]
    res = tcg.pcg_fixed(op, t["b"][0], t["x0"][0], mask=t["free"], iters=0)
    assert torch.equal(res.x, t["x0"][0]) and int(res.iters) == 0
    j = _j(batch)
    A = j["A0"] + j["dks"][0] * j["Kv"]
    want = jcg.pcg_fixed(lambda y: j["sm"][0] * apply_stencil(
        A, j["sm"][0] * y), j["b"][0], j["x0"][0], mask=j["free"], iters=40)
    got = tcg.pcg_fixed(op, t["b"][0], t["x0"][0], mask=t["free"], iters=40)
    assert _rel(got.x.numpy(), want.x) <= FIXED_TOL
    assert float(got.residual) == pytest.approx(float(want.residual),
                                                rel=1e-9)


@pytest.mark.parametrize("rline", [False, True], ids=["identity", "rline"])
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_tol_plain_matches_pallas_interpret(batch, rline, rtol_wrt):
    t, j = _t(batch), _j(batch)
    xj, ij = cg_vmem_batched_tol(*_args(j), 1e-11, maxiter=20000,
                                 rtol_wrt=rtol_wrt, interpret=True,
                                 rline=rline, merged=False)
    xt, it = cuda_sweep.cg_batched_tol(*_args(t), 1e-11, maxiter=20000,
                                       rtol_wrt=rtol_wrt, rline=rline)
    assert it.dtype == torch.int32 and it.shape == (3,)
    # the same recurrence per lane; the sums run in another order, which
    # may move a stop by one iteration
    assert np.abs(it.numpy() - np.asarray(ij)).max() <= 1, (it, ij)
    assert _rel(xt.numpy(), xj) <= X_TOL
    assert _rel(xt.numpy(), batch["x_true"]) <= 1e-8


@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
@pytest.mark.parametrize("form", ["adi", "adaptive"])
def test_tol_adi_forms_match_pallas_interpret(batch, form, rtol_wrt):
    """K2's ADI form (every lane) and adaptive form (lanes 0 and 2 ADI,
    lane 1 r-line): the plain version against the Pallas kernel, per-lane
    counts equal."""
    t, j = _t(batch), _j(batch)
    flags = np.array([1, 0, 1], dtype=np.int32)
    kj = (dict(adi=True) if form == "adi" else
          dict(adi_flags=jnp.asarray(flags)))
    kt = (dict(adi=True) if form == "adi" else
          dict(adi_flags=torch.tensor(flags)))
    xj, ij = cg_vmem_batched_tol(*_args(j), 1e-11, maxiter=20000,
                                 rtol_wrt=rtol_wrt, interpret=True,
                                 merged=False, **kj)
    xt, it = cuda_sweep.cg_batched_tol(*_args(t), 1e-11, maxiter=20000,
                                       rtol_wrt=rtol_wrt, **kt)
    assert it.tolist() == np.asarray(ij).tolist()
    assert _rel(xt.numpy(), xj) <= X_TOL
    assert _rel(xt.numpy(), batch["x_true"]) <= 1e-8


def test_adaptive_lanes_equal_static_lanes_bitwise(batch):
    """A flagged lane of the adaptive form is the ADI solve's lane bitwise,
    an unflagged one the r-line solve's (iterates and counts)."""
    t = _t(batch)
    rtol = torch.tensor([1e-9, 1e-11, 1e-10])
    kw = dict(maxiter=20000, rtol_wrt="r0")
    x_a, i_a = cuda_sweep.cg_batched_tol(
        *_args(t), rtol, adi_flags=torch.tensor([1, 0, 1], dtype=torch.int32),
        **kw)
    x_adi, i_adi = cuda_sweep.cg_batched_tol(*_args(t), rtol, adi=True, **kw)
    x_r, i_r = cuda_sweep.cg_batched_tol(*_args(t), rtol, rline=True, **kw)
    for lane, (x_s, i_s) in ((0, (x_adi, i_adi)), (1, (x_r, i_r)),
                             (2, (x_adi, i_adi))):
        assert torch.equal(x_a[lane], x_s[lane]), lane
        assert int(i_a[lane]) == int(i_s[lane]), lane
    assert i_adi.tolist() != i_r.tolist()


def test_adi_form_checks(batch):
    t = _t(batch)
    with pytest.raises(ValueError, match="exclusive"):
        cuda_sweep.cg_batched_tol(*_args(t), 1e-6, rline=True, adi=True)
    with pytest.raises(ValueError, match="replaces"):
        cuda_sweep.cg_batched_tol(*_args(t), 1e-6, adi=True,
                                  adi_flags=torch.ones(3, dtype=torch.int32))


@pytest.mark.parametrize("rline", [False, True], ids=["identity", "rline"])
def test_tol_per_lane_rtol_and_nan_lane(batch, rline):
    """Lane 1 at rtol 2 stops at 0 iterations with x = x0; lane 2 has a NaN
    coefficient and comes out NaN at 0 iterations; lane 0 is what it is
    without them."""
    t, j = _t(batch), _j(batch)
    dks = batch["dks"].copy()
    dks[2] = np.nan
    b = batch["b"].copy()
    b[2] = np.nan * batch["free"]
    rtol = np.array([1e-10, 2.0, 1e-10])
    jargs = (j["A0"], j["Kv"], jnp.asarray(dks), j["sm"], jnp.asarray(b),
             j["x0"])
    targs = (t["A0"], t["Kv"], torch.tensor(dks), t["sm"], torch.tensor(b),
             t["x0"])
    xj, ij = cg_vmem_batched_tol(*jargs, jnp.asarray(rtol), maxiter=5000,
                                 interpret=True, rline=rline, merged=False)
    xt, it = cuda_sweep.cg_batched_tol(*targs, torch.tensor(rtol),
                                       maxiter=5000, rline=rline)
    assert np.asarray(ij)[1:].tolist() == [0, 0] == it[1:].tolist()
    assert torch.equal(xt[1], t["x0"][1])
    assert np.isnan(np.asarray(xj)[2]).all() and torch.isnan(xt[2]).all()
    assert abs(int(it[0]) - int(ij[0])) <= 1
    assert _rel(xt[0].numpy(), np.asarray(xj)[0]) <= X_TOL
    x1, i1 = cuda_sweep.cg_batched_tol(t["A0"], t["Kv"], t["dks"][:1],
                                       t["sm"][:1], t["b"][:1], t["x0"][:1],
                                       1e-10, maxiter=5000, rline=rline)
    assert torch.equal(x1[0], xt[0]) and int(i1[0]) == int(it[0])


def test_tol_float32_counts_within_two_of_pallas(batch):
    """The float32 recipe's settings (rtol 1e-4 wrt ||b||, identity) on both
    packages in float32."""
    t, j = _t(batch, torch.float32), _j(batch, jnp.float32)
    xj, ij = cg_vmem_batched_tol(*_args(j), 1e-4, maxiter=4000,
                                 interpret=True, merged=False)
    xt, it = cuda_sweep.cg_batched_tol(*_args(t), 1e-4, maxiter=4000)
    assert np.abs(it.numpy() - np.asarray(ij)).max() <= 2
    assert _rel(xt.numpy(), xj) <= 1e-4


def test_maxiter_caps_every_lane(batch):
    t, j = _t(batch), _j(batch)
    xj, ij = cg_vmem_batched_tol(*_args(j), 1e-14, maxiter=7,
                                 interpret=True, merged=False)
    xt, it = cuda_sweep.cg_batched_tol(*_args(t), 1e-14, maxiter=7)
    assert it.tolist() == [7, 7, 7] == np.asarray(ij).tolist()
    assert _rel(xt.numpy(), xj) <= X_TOL


@pytest.mark.parametrize("iters", [0, 1, 40])
def test_fixed_plain_matches_pallas_interpret(batch, iters):
    t, j = _t(batch), _j(batch)
    xj = cg_vmem_batched(*_args(j), iters=iters, interpret=True)
    xt = cuda_sweep.cg_batched(*_args(t), iters=iters)
    assert _rel(xt.numpy(), xj) <= X_TOL


def test_phase_references_match_the_eager_ops(batch):
    """The plain phases: the stencil-and-dot against the eager operator,
    the on-the-fly r-line PCR against the folded line preconditioner."""
    t = _t(batch)
    p = torch.tensor(np.random.default_rng(4).standard_normal(
        batch["b"].shape)) * t["free"]
    Ap, pap = cuda_sweep.stencil_dot(t["A0"], t["Kv"], t["dks"], t["sm"], p)
    for i in range(3):
        A = t["A0"] + t["dks"][i] * t["Kv"]
        want = t["sm"][i] * t_apply(A, t["sm"][i] * p[i])
        assert _rel(Ap[i].numpy(), want.numpy()) <= 1e-13
    assert pap.dtype == torch.float64 and pap.shape == (3,)
    assert np.allclose(pap.numpy(), (p * Ap).sum(dim=(1, 2)).numpy(),
                       rtol=1e-13)
    z, rz = cuda_sweep.pcr_r(t["A0"], t["Kv"], t["dks"], t["sm"], p)
    pre = tls.line_preconditioner(t["A0"], t["s"], t["free"], Kv=t["Kv"],
                                  dk=t["dks"])
    assert _rel(z.numpy(), pre(p).numpy()) <= 1e-12
    assert np.allclose(rz.numpy(), (p * z).sum(dim=(1, 2)).numpy(),
                       rtol=1e-13)


def test_pcr_z_reference_is_the_adi_composition(batch):
    """The plain z-line phase, fed the r-line solve, gives the ADI
    preconditioner R r + Z r − r of the folded line solves, per lane."""
    t = _t(batch)
    p = torch.tensor(np.random.default_rng(9).standard_normal(
        batch["b"].shape)) * t["free"]
    z_r, _ = cuda_sweep.pcr_r(t["A0"], t["Kv"], t["dks"], t["sm"], p)
    z, rz = cuda_sweep.pcr_z(t["A0"], t["Kv"], t["dks"], t["sm"], p, z_r)
    pre = tls.adi_preconditioner(t["A0"], t["s"], t["free"], Kv=t["Kv"],
                                 dk=t["dks"])
    assert _rel(z.numpy(), pre(p).numpy()) <= 1e-12
    assert np.allclose(rz.numpy(), (p * z).sum(dim=(1, 2)).numpy(),
                       rtol=1e-13)


def _nan_lane_batch(batch, dtype=torch.float64):
    """The batch with lane 2's coefficient and rhs NaN (as a NaN kappa
    gives them)."""
    t = _t(batch, dtype)
    t["dks"][2] = float("nan")
    t["b"][2] = float("nan") * t["free"]
    return t


@pytest.mark.parametrize("rline", [False, True], ids=["identity", "rline"])
def test_phases_compose_to_the_solve(batch, rline):
    """The phase wrappers (their plain versions here), chained as the
    kernels chain them, with a done lane's fields frozen: after two
    iterations x and the counts are the plain solve's at maxiter=2 (lane 0
    running, lane 1 at rtol 2, lane 2 NaN). Compaction lists the running
    lanes at each step; finish poisons the NaN lane."""
    t = _nan_lane_batch(batch)
    A0, Kv, dks, sm, b, x0 = _args(t)
    rtol = torch.tensor([1e-12, 2.0, 1e-12], dtype=torch.float32)
    kw = dict(rline=rline, maxiter=2)
    zero = torch.zeros(3, dtype=torch.float64)
    parts = lambda pap=zero, rr=zero, rz=zero, bb=zero: \
        torch.stack([pap, rr, rz, bb])[..., None]
    precond = ((lambda r: cuda_sweep.pcr_r(A0, Kv, dks, sm, r)) if rline
               else (lambda r: (r, zero)))
    x, r, rr, bb = cuda_sweep.init(A0, Kv, dks, sm, b, x0)
    z, rz = precond(r)
    st = cuda_sweep.finalize(cuda_sweep.pack_state(3, "cpu"),
                             parts(rr=rr, rz=rz, bb=bb), "init", rtol, **kw)
    p = z
    for _ in range(2):
        assert cuda_sweep.compact(st).tolist() == [0]
        Ap, pap = cuda_sweep.stencil_dot(A0, Kv, dks, sm, p)
        st = cuda_sweep.finalize(st, parts(pap=pap), "alpha", **kw)
        x_n, r_n, rr = cuda_sweep.update(
            x, r, p, Ap, cuda_sweep.unpack_state(st)["alpha"])
        z_n, rz = precond(r_n)
        st_n = cuda_sweep.finalize(st, parts(rr=rr, rz=rz), "beta", **kw)
        p_n = cuda_sweep.p_update(p, z_n,
                                  cuda_sweep.unpack_state(st_n)["beta"])
        run = (cuda_sweep.unpack_state(st)["done"] == 0)[:, None, None]
        x, r, p = (torch.where(run, x_n, x), torch.where(run, r_n, r),
                   torch.where(run, p_n, p))
        st = st_n
    assert cuda_sweep.compact(st).tolist() == []
    x, iters = cuda_sweep.finish(x, st)
    want_x, want_it = cuda_sweep.cg_batched_tol_reference(
        A0, Kv, dks, sm, b, x0, rtol, **kw)
    assert iters.tolist() == want_it.tolist() == [2, 0, 0]
    assert torch.isnan(x[2]).all() and torch.isnan(want_x[2]).all()
    assert torch.equal(x[1], x0[1])
    assert _rel(x[:2].numpy(), want_x[:2].numpy()) <= 1e-13


def test_finalize_reference_rules():
    """The scalar phase's rules on hand-made states: the guards, the stop
    test against stop², a done lane left alone, the count and maxiter, and
    the fixed mode's stop at maxiter alone."""
    parts = torch.zeros(4, 3, 2, dtype=torch.float64)
    parts[1] = torch.tensor([[1.0, 1.0], [0.5, 0.5], [8.0, 1.0]])  # rr
    parts[3] = 1.0                                               # bb
    st = cuda_sweep.finalize(cuda_sweep.pack_state(3, "cpu"), parts, "init",
                             torch.tensor([0.5, 2.0, 0.1]), rline=False,
                             maxiter=3)
    f = cuda_sweep.unpack_state(st)
    assert f["rz"].tolist() == f["rr"].tolist() == [2.0, 1.0, 9.0]
    assert f["stop2"].tolist() == pytest.approx([0.5, 8.0, 0.02])
    assert f["done"].tolist() == [0, 1, 0] and f["k"].tolist() == [0, 0, 0]
    st = cuda_sweep.finalize(st, torch.zeros(4, 3, 2, dtype=torch.float64),
                             "alpha", rline=False, maxiter=3)
    assert cuda_sweep.unpack_state(st)["alpha"].tolist() == [2.0, 0.0, 9.0]
    beta_parts = torch.zeros(4, 3, 1, dtype=torch.float64)
    beta_parts[1] = torch.tensor([[0.25], [5.0], [0.0]])
    st2 = cuda_sweep.finalize(st, beta_parts, "beta", rline=False, maxiter=3)
    f2 = cuda_sweep.unpack_state(st2)
    assert f2["beta"].tolist() == [0.125, 0.0, 0.0]
    assert f2["k"].tolist() == [1, 0, 1] and f2["done"].tolist() == [1, 1, 1]
    fixed = cuda_sweep.finalize(st, beta_parts, "beta", rline=False,
                                maxiter=3, fixed=True)
    assert cuda_sweep.unpack_state(fixed)["done"].tolist() == [0, 1, 0]
    with pytest.raises(ValueError, match="mode"):
        cuda_sweep.finalize(st, beta_parts, "gamma", rline=False, maxiter=3)


def test_batched_line_couplings_match_jax_per_lane(batch):
    """line_couplings with Kv/dk: lane b's couplings are those of the JAX
    package on A0 + dk_b·Kv, for both axes."""
    t, j = _t(batch), _j(batch)
    for axis in (-1, -2):
        l, u = tls.line_couplings(t["A0"], t["sm"], axis, Kv=t["Kv"],
                                  dk=t["dks"])
        for i in range(3):
            lj, uj = jls.line_couplings(j["A0"] + j["dks"][i] * j["Kv"],
                                        j["sm"][i], axis)
            assert _rel(l[i].numpy(), lj) <= 1e-14
            assert _rel(u[i].numpy(), uj) <= 1e-14


def test_rtol_length_is_checked(batch):
    t = _t(batch)
    with pytest.raises(ValueError, match="rtol"):
        cuda_sweep.cg_batched_tol(*_args(t), torch.tensor([1e-6, 1e-6]))
    with pytest.raises(ValueError, match="rtol_wrt"):
        cuda_sweep.cg_batched_tol(*_args(t), 1e-6, rtol_wrt="x")


def test_kernel_input_checks(batch):
    """What the CUDA wrapper refuses, checked before any pointer is taken
    (the checks run on the operands as given)."""
    t = _t(batch, torch.float32)
    A0, Kv, dks, sm, b, x0 = _args(t)
    ok = cuda_sweep._check_batch(A0, Kv, dks, sm, {"b": b, "x0": x0})
    assert ok == (3,) + batch["b"].shape[1:]
    with pytest.raises(TypeError, match="float32"):
        cuda_sweep._check_batch(A0, Kv, dks, sm, {"b": b.double()})
    with pytest.raises(ValueError, match="shape"):
        cuda_sweep._check_batch(A0, Kv[:, :-1], dks, sm, {})
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sweep._check_batch(A0, Kv, dks, sm,
                                {"b": b.transpose(1, 2).contiguous()
                                 .transpose(1, 2)})
    with pytest.raises(ValueError, match="7\\|9"):
        cuda_sweep._check_batch(A0[:5], Kv, dks, sm, {})


def test_no_fallback_off_cpu(batch):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not computed on the CPU."""
    t = _t(batch, torch.float32)
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="devices"):
        cuda_sweep.cg_batched_tol(*_args(meta), 1e-6)
    with pytest.raises(ValueError, match="devices"):
        cuda_sweep.cg_batched(t["A0"], t["Kv"], t["dks"], t["sm"],
                              meta["b"], t["x0"], iters=3)


def test_counters_do_not_move_on_cpu(batch):
    t = _t(batch)
    cuda_sweep.reset_counters()
    cuda_sweep.cg_batched_tol(*_args(t), 1e-8)
    cuda_sweep.cg_batched(*_args(t), iters=3)
    assert cuda_sweep.cg_batched_tol.launches == 0
    assert cuda_sweep.cg_batched.launches == 0
    assert set(cuda_sweep.phase_launches().values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["identity", "rline", "fixed", "adi",
                                  "adaptive"])
def test_cuda_kernels_match_plain(batch, form):
    """The CUDA kernels in float32 against the plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = {k: v.cuda().contiguous() for k, v in _t(batch, torch.float32)
         .items()}
    cuda_sweep.reset_counters()
    if form == "fixed":
        xk = cuda_sweep.cg_batched(*_args(g), iters=40)
        xp = cuda_sweep.cg_batched_reference(*_args(g), iters=40)
        assert cuda_sweep.cg_batched.launches == 1
    else:
        kw = {"identity": {}, "rline": dict(rline=True),
              "adi": dict(adi=True),
              "adaptive": dict(adi_flags=torch.tensor(
                  [1, 0, 1], dtype=torch.int32, device="cuda"))}[form]
        kw["maxiter"] = 5000
        xk, ik = cuda_sweep.cg_batched_tol(*_args(g), 1e-5, **kw)
        xp, ip = cuda_sweep.cg_batched_tol_reference(*_args(g), 1e-5, **kw)
        assert getattr(cuda_sweep.cg_batched_tol, f"launches_{form}") == 1
        assert (ik - ip).abs().max() <= max(3, int(0.05 * int(ip.max())))
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3


@pytest.mark.cuda
def test_cuda_phase_kernels_match_plain(batch):
    """Each phase kernel alone against its plain version on the card, on the
    same inputs (float32 fields; float64 states and partial sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = {k: v.cuda().contiguous() for k, v in _t(batch, torch.float32)
         .items()}
    rng = np.random.default_rng(6)
    field = lambda: (torch.tensor(rng.standard_normal(batch["b"].shape),
                                  dtype=torch.float32).cuda() * g["free"])
    lane = lambda: torch.tensor(rng.uniform(0.1, 1.0, 3)).cuda()
    x, r, p, Ap = field(), field(), field(), field()
    parts = torch.tensor(rng.uniform(0.5, 1.5, (4, 3, 5))).cuda()
    rtol = lane().float()
    state = cuda_sweep.pack_state(3, "cuda", rz=lane(), rr=lane(),
                                  stop2=lane(), k=[3, 4, 5], done=[0, 1, 0])

    def agree(got, want, tol):
        as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
        for u, v in zip(as_tuple(got), as_tuple(want), strict=True):
            if not v.dtype.is_floating_point:
                assert torch.equal(u, v)
                continue
            assert torch.equal(torch.isnan(u), torch.isnan(v))
            fin = ~torch.isnan(v)
            assert float((u - v)[fin].abs().max()) <= \
                tol * float(v[fin].abs().max())

    cuda_sweep.reset_counters()
    for fn, ref, args in (
            (cuda_sweep.init, cuda_sweep.init_reference, _args(g)),
            (cuda_sweep.update, cuda_sweep.update_reference,
             (x, r, p, Ap, lane())),
            (cuda_sweep.p_update, cuda_sweep.p_update_reference,
             (p, r, lane())),
            (cuda_sweep.compact, cuda_sweep.compact_reference, (state,)),
            (cuda_sweep.finish, cuda_sweep.finish_reference, (x, state))):
        agree(fn(*args), ref(*args), 1e-5)
    z_r, _ = cuda_sweep.pcr_r(g["A0"], g["Kv"], g["dks"], g["sm"], r)
    agree(cuda_sweep.pcr_z(g["A0"], g["Kv"], g["dks"], g["sm"], r, z_r),
          cuda_sweep.pcr_z_reference(g["A0"], g["Kv"], g["dks"], g["sm"], r,
                                     z_r), 1e-4)
    for mode in ("init", "alpha", "beta"):
        kw = dict(rline=True, maxiter=4)
        got = cuda_sweep.finalize(state, parts, mode, rtol, **kw)
        want = cuda_sweep.finalize_reference(state, parts, mode, rtol, **kw)
        agree(tuple(cuda_sweep.unpack_state(got).values()),
              tuple(cuda_sweep.unpack_state(want).values()), 1e-12)
    counts = cuda_sweep.phase_launches()
    assert counts["finalize"] == 3 and counts["update"] == 1
    assert counts["pcr_z"] == 1

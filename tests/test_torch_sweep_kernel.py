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


@pytest.fixture(scope="module")
def nine_batch():
    """Three lanes A0 + dk_b·Kv of 9-plane operators (see
    tests/test_torch_cg_kernel.py::nine_plane_system)."""
    from tests.test_torch_cg_kernel import nine_plane_system
    return nine_plane_system(n_lanes=3)


@pytest.mark.parametrize("form", ["identity", "rline", "adi"])
def test_tol_nine_plane_plain_matches_pallas_interpret(nine_batch, form):
    """K2's plain version on 9-plane lanes against the Pallas kernel in
    interpret mode in float64: equal per-lane counts, x within 1e-10."""
    t, j = _t(nine_batch), _j(nine_batch)
    assert t["A0"].shape[0] == t["Kv"].shape[0] == 9
    kw = dict(rline=form == "rline", adi=form == "adi")
    xj, ij = cg_vmem_batched_tol(*_args(j), 1e-11, maxiter=20000,
                                 rtol_wrt="r0", interpret=True, merged=False,
                                 **kw)
    xt, it = cuda_sweep.cg_batched_tol(*_args(t), 1e-11, maxiter=20000,
                                       rtol_wrt="r0", **kw)
    assert it.tolist() == np.asarray(ij).tolist(), (it, ij)
    assert _rel(xt.numpy(), xj) <= X_TOL
    assert _rel(xt.numpy(), nine_batch["x_true"]) <= 1e-8
    # the lanes differ: Kv's anti-diagonal planes act
    assert np.abs(nine_batch["Kv"][7:]).max() > 0


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
    """The phase wrappers (their plain versions here) and the scalar
    phase's plain version, chained as the kernels chain them, with a done lane's fields frozen: after two
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
    st = cuda_sweep.finalize_reference(cuda_sweep.pack_state(3, "cpu"),
                                       parts(rr=rr, rz=rz, bb=bb), "init",
                                       rtol, **kw)
    p = z
    for _ in range(2):
        assert cuda_sweep.compact(st).tolist() == [0]
        Ap, pap = cuda_sweep.stencil_dot(A0, Kv, dks, sm, p)
        st = cuda_sweep.finalize_reference(st, parts(pap=pap), "alpha",
                                           **kw)
        x_n, r_n, rr = cuda_sweep.update(
            x, r, p, Ap, cuda_sweep.unpack_state(st)["alpha"])
        z_n, rz = precond(r_n)
        st_n = cuda_sweep.finalize_reference(st, parts(rr=rr, rz=rz),
                                             "beta", **kw)
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
    st = cuda_sweep.finalize_reference(cuda_sweep.pack_state(3, "cpu"),
                                       parts, "init",
                                       torch.tensor([0.5, 2.0, 0.1]),
                                       rline=False, maxiter=3)
    f = cuda_sweep.unpack_state(st)
    assert f["rz"].tolist() == f["rr"].tolist() == [2.0, 1.0, 9.0]
    assert f["stop2"].tolist() == pytest.approx([0.5, 8.0, 0.02])
    assert f["done"].tolist() == [0, 1, 0] and f["k"].tolist() == [0, 0, 0]
    st = cuda_sweep.finalize_reference(
        st, torch.zeros(4, 3, 2, dtype=torch.float64), "alpha", rline=False,
        maxiter=3)
    assert cuda_sweep.unpack_state(st)["alpha"].tolist() == [2.0, 0.0, 9.0]
    beta_parts = torch.zeros(4, 3, 1, dtype=torch.float64)
    beta_parts[1] = torch.tensor([[0.25], [5.0], [0.0]])
    st2 = cuda_sweep.finalize_reference(st, beta_parts, "beta", rline=False,
                                        maxiter=3)
    f2 = cuda_sweep.unpack_state(st2)
    assert f2["beta"].tolist() == [0.125, 0.0, 0.0]
    assert f2["k"].tolist() == [1, 0, 1] and f2["done"].tolist() == [1, 1, 1]
    fixed = cuda_sweep.finalize_reference(st, beta_parts, "beta",
                                          rline=False, maxiter=3, fixed=True)
    assert cuda_sweep.unpack_state(fixed)["done"].tolist() == [0, 1, 0]
    with pytest.raises(ValueError, match="mode"):
        cuda_sweep.finalize_reference(st, beta_parts, "gamma", rline=False,
                                      maxiter=3)


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


MERGED_FORMS = {"identity": {}, "rline": dict(rline=True),
                "adi": dict(adi=True), "adaptive": "flags", "no_kv": "no_kv"}


def _merged_kw(form, lib):
    flags = np.array([1, 0, 1], np.int32)
    if form == "adaptive":
        return dict(adi_flags=(jnp.asarray(flags) if lib == "jax"
                               else torch.tensor(flags)))
    return {} if form == "no_kv" else dict(MERGED_FORMS[form])


@pytest.mark.parametrize("form", list(MERGED_FORMS))
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_merged_plain_matches_pallas_interpret(batch, form, rtol_wrt):
    """K2's merged-dot recurrence in each form: the plain version against
    the Pallas kernel (merged=True) in interpret mode in float64 — the same
    recurrence, so counts within 1 and x within X_TOL — and against the
    standard recurrence at solve tolerance."""
    t, j = _t(batch), _j(batch)
    aj, at = list(_args(j)), list(_args(t))
    if form == "no_kv":          # the config-independent operator
        aj[1] = at[1] = at[2] = None     # (the Pallas entry still reads
        aj[2] = jnp.zeros(3)             # the dks operand's shape)
        aj[3], at[3] = j["sm"][:1].repeat(3, 0), t["sm"][:1].repeat(3, 1, 1)
        aj[4], at[4] = aj[4] * (aj[3] != 0), at[4] * (at[3] != 0)
        aj[5], at[5] = aj[5] * (aj[3] != 0), at[5] * (at[3] != 0)
    kw = dict(maxiter=20000, rtol_wrt=rtol_wrt)
    xj, ij = cg_vmem_batched_tol(*aj, 1e-11, interpret=True, merged=True,
                                 **kw, **_merged_kw(form, "jax"))
    xt, it = cuda_sweep.cg_batched_tol(*at, 1e-11, merged=True, **kw,
                                       **_merged_kw(form, "torch"))
    xs, its = cuda_sweep.cg_batched_tol(*at, 1e-11, merged=False, **kw,
                                        **_merged_kw(form, "torch"))
    assert np.abs(it.numpy() - np.asarray(ij)).max() <= 1, (it, ij)
    assert _rel(xt.numpy(), xj) <= X_TOL
    # tolerance-equal, not bitwise, to the standard recurrence
    assert np.abs(it.numpy() - its.numpy()).max() <= 3, (it, its)
    assert _rel(xt.numpy(), xs.numpy()) <= 1e-8


def test_merged_adaptive_lanes_equal_static_merged_lanes_bitwise(batch):
    t = _t(batch)
    flags = torch.tensor([1, 0, 1], dtype=torch.int32)
    kw = dict(maxiter=20000, rtol_wrt="r0", merged=True)
    xa, ia = cuda_sweep.cg_batched_tol(*_args(t), 1e-10, adi_flags=flags,
                                       **kw)
    xd, id_ = cuda_sweep.cg_batched_tol(*_args(t), 1e-10, adi=True, **kw)
    xr, ir = cuda_sweep.cg_batched_tol(*_args(t), 1e-10, rline=True, **kw)
    for i, f in enumerate(flags.tolist()):
        xs, is_ = (xd, id_) if f else (xr, ir)
        assert torch.equal(xa[i], xs[i]) and int(ia[i]) == int(is_[i])


def test_merged_default_is_read_at_call_time(batch):
    from heatflow_tpu_torch.ops import cuda_cg
    t = _t(batch)
    want = cuda_sweep.cg_batched_tol(*_args(t), 1e-9, rline=True,
                                     merged=True)
    std = cuda_sweep.cg_batched_tol(*_args(t), 1e-9, rline=True)
    assert cuda_cg.MERGED_DEFAULT is False
    cuda_cg.MERGED_DEFAULT = True
    try:
        got = cuda_sweep.cg_batched_tol(*_args(t), 1e-9, rline=True)
    finally:
        cuda_cg.MERGED_DEFAULT = False
    assert torch.equal(got[0], want[0]) and not torch.equal(got[0], std[0])


def test_merged_phase_references_and_per_lane_guards(batch):
    """merged_w and pq_update on CPU tensors are their plain versions; a NaN lane is poisoned, a lane at rtol 2 runs no
    iteration, and the scalar phase follows the recurrence's rules."""
    t = _t(batch)
    A0, Kv, dks, sm, b, x0 = _args(t)
    w, delta, rr, gamma = cuda_sweep.merged_w(A0, Kv, dks, sm, x0, b)
    want = sm * apply_combined(A0, Kv, dks, sm * x0)
    assert torch.equal(w, want)
    assert torch.allclose(delta, (want * x0).sum(dim=(-2, -1)), rtol=1e-13)
    assert torch.allclose(gamma, (b * x0).sum(dim=(-2, -1)), rtol=1e-13)
    beta = torch.tensor([0.5, 0.25, 2.0], dtype=torch.float64)
    p_n, q_n = cuda_sweep.pq_update(b, x0, w, b, beta)
    assert torch.equal(p_n, w + beta[:, None, None] * b)
    assert torch.equal(q_n, b + beta[:, None, None] * x0)
    bn = b.clone()
    bn[1, 2, 3] = float("nan")
    rtol = torch.tensor([1e-10, 1e-10, 2.0], dtype=torch.float64)
    x, it = cuda_sweep.cg_batched_tol(A0, Kv, dks, sm, bn, torch.zeros_like(b),
                                      rtol, merged=True, rline=True)
    assert torch.isnan(x[1]).all() and int(it[1]) == 0
    assert int(it[2]) == 0 and int(it[0]) > 0
    st = cuda_sweep.pack_state(2, "cpu", rz=torch.tensor([2.0, 0.0]),
                               alpha=torch.tensor([0.5, 0.0]),
                               stop2=torch.tensor([1e-3, 1e-3]),
                               k=torch.tensor([4, 4]))
    parts = torch.tensor([[[3.0], [3.0]], [[1.0], [1e-6]], [[1.0], [1.0]],
                          [[9.0], [9.0]]], dtype=torch.float64)
    out = cuda_sweep.unpack_state(cuda_sweep.finalize_merged_reference(
        st, parts, False, preconditioned=True, maxiter=9))
    # lane 0: beta = 1/2, alpha' = 1 / (3 - 0.5 * 1 / 0.5); lane 1: guards
    assert out["beta"].tolist() == [0.5, 1.0]
    assert out["alpha"].tolist() == [0.5, 1.0 / (3.0 - 1.0)]
    assert out["k"].tolist() == [5, 5] and out["done"].tolist() == [0, 1]
    first = cuda_sweep.unpack_state(cuda_sweep.finalize_merged_reference(
        st, parts, True, 0.5, preconditioned=True, maxiter=9, rtol_wrt="b"))
    assert first["alpha"].tolist() == [1 / 3, 1 / 3]
    assert first["stop2"].tolist() == [0.25 * 9, 0.25 * 9]
    assert first["k"].tolist() == [0, 0] and first["done"].tolist() == [1, 1]


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
    counts = cuda_sweep.phase_launches()
    assert counts["update"] == 1
    assert counts["pcr_z"] == 1


# ----------------------------------------------------------------------
# The redesigned phases: the fused update and r-line PCR, the lane-blocked
# operator pass and the per-lane tails, on a 12 x 17 grid of five lanes
# (one NaN, one that converges first)
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """Five lanes of a random symmetric 7-point operator A0 + dk_b·Kv on a
    12 x 17 grid (edge conductances and a mass term), a Dirichlet pattern,
    lane 3's coefficient NaN, float64 torch tensors."""
    rng = np.random.default_rng(12)
    nz, nr, B = 12, 17, 5

    def laplacian():
        cz = rng.uniform(0.5, 1.5, (nz - 1, nr))
        cr = rng.uniform(0.5, 1.5, (nz, nr - 1))
        cd = rng.uniform(0.0, 0.2, (nz - 1, nr - 1))
        A = np.zeros((7, nz, nr))
        A[1, :-1], A[2, 1:] = -cz, -cz
        A[3, :, :-1], A[4, :, 1:] = -cr, -cr
        A[5, :-1, :-1], A[6, 1:, 1:] = -cd, -cd
        A[0] = -A[1:].sum(axis=0)
        return A
    A0 = laplacian()
    A0[0] += 0.3
    Kv = laplacian()
    dks = np.array([0.5, 1.0, 2.0, np.nan, 4.0])
    free = (rng.random((nz, nr)) > 0.1).astype(float)
    diag = A0[0][None] + dks[:, None, None] * Kv[0][None]
    sm = np.where(np.isfinite(diag) & (diag > 0),
                  1.0 / np.sqrt(np.abs(diag)), 1.0) * free
    field = lambda: rng.standard_normal((B, nz, nr)) * free
    t = {k: torch.tensor(v) for k, v in dict(
        A0=A0, Kv=Kv, dks=dks, sm=sm, free=np.broadcast_to(free, (B, nz, nr)),
        x=field(), r=field(), p=field(), b=field(), x0=field()).items()}
    t["Ap"] = cuda_sweep.stencil_dot_reference(t["A0"], t["Kv"], t["dks"],
                                               t["sm"], t["p"])[0]
    lanes = lambda lo, hi: torch.tensor(rng.uniform(lo, hi, B))
    t["state"] = cuda_sweep.pack_state(
        B, "cpu", rz=lanes(0.5, 2.0), rr=lanes(0.5, 2.0),
        stop2=torch.tensor([1e-3, 1e-3, 1e-3, 1e-3, 50.0]),
        alpha=lanes(0.1, 1.0), beta=lanes(0.1, 1.0), k=[2, 3, 4, 5, 6],
        done=[0, 1, 0, 0, 0])
    return t


def _same(a, b):
    """Equal values, NaN where NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def _op(t):
    return t["A0"], t["Kv"], t["dks"], t["sm"]


@pytest.mark.parametrize("adi", [False, True], ids=["rline", "adi"])
def test_pcr_r_update_reference_is_update_then_pcr_r(small, adi):
    """The fused phase's plain version is update_reference, then the r-line
    solve (and the z-line phase with adi) on the updated residual."""
    t = small
    alpha = torch.tensor([0.3, 0.7, 1.1, 0.2, 0.9])
    got = cuda_sweep.pcr_r_update_reference(*_op(t), t["x"], t["r"], t["p"],
                                            t["Ap"], alpha, adi=adi)
    x_n, r_n, rr = cuda_sweep.update_reference(t["x"], t["r"], t["p"],
                                               t["Ap"], alpha)
    z, rz = cuda_sweep.pcr_r_reference(*_op(t), r_n)
    if adi:
        z, rz = cuda_sweep.pcr_z_reference(*_op(t), r_n, z)
    for a, b in zip(got, (x_n, r_n, z, rr, rz), strict=True):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("adi", [False, True], ids=["rline", "adi"])
def test_pcr_r_update_with_state_skips_done_lanes_and_takes_beta(small, adi):
    """The fused phase on a per-lane state: alpha from the state, a done
    lane left as it is, and the beta tail of finalize_reference on the
    others."""
    t = small
    st = t["state"]
    x_n, r_n, z, rr, rz, st_n = cuda_sweep.pcr_r_update(
        *_op(t), t["x"], t["r"], t["p"], t["Ap"], st, adi=adi, maxiter=9)
    f = cuda_sweep.unpack_state(st)
    want = cuda_sweep.pcr_r_update_reference(
        *_op(t), t["x"], t["r"], t["p"], t["Ap"], f["alpha"], adi=adi)
    live = [0, 2, 4]
    for a, b in zip((x_n, r_n, z, rr, rz), want):
        assert _same(a[live], b[live])
    assert torch.equal(x_n[1], t["x"][1]) and torch.equal(r_n[1], t["r"][1])
    assert float(rr[1]) == 0.0 and not z[1].any()
    parts = torch.stack([torch.zeros(5), rr, rz, torch.zeros(5)])[..., None]
    fin = cuda_sweep.finalize_reference(st, parts, "beta", rline=True,
                                        maxiter=9)
    assert _same(st_n, fin)
    g = cuda_sweep.unpack_state(st_n)
    assert g["k"].tolist() == [3, 3, 5, 6, 7]
    assert g["done"].tolist()[:3] == [0, 1, 0]


@pytest.mark.parametrize("L", [4, 8, 16])
@pytest.mark.parametrize("lanes", [None, [0, 2, 3, 4], [4, 1]],
                         ids=["all", "four", "two"])
def test_apply_blocked_reference_is_stencil_dot_lane_by_lane(small, L,
                                                             lanes):
    """The lane-blocked pass equals stencil_dot_reference on every listed
    lane; the others stay 0; one partial a tile of TILE, summing to
    <p, Ap>. The lane list cut into groups of L entries (the list not a
    multiple of L) gives the same bits on every lane: a lane's result does
    not depend on the lanes listed with it."""
    t = small
    out, parts = cuda_sweep.apply_blocked_reference(*_op(t), t["p"], lanes)
    Ap, pap = cuda_sweep.stencil_dot_reference(*_op(t), t["p"])
    listed = list(range(5)) if lanes is None else lanes
    for g in range(0, len(listed), L):
        grp = listed[g:g + L]
        o_g, p_g = cuda_sweep.apply_blocked_reference(*_op(t), t["p"], grp)
        assert _same(o_g[grp], out[grp]) and _same(p_g[grp], parts[grp])
    assert parts.shape == (5, cuda_sweep.tiles2d(12, 17)) == (5, 1)
    for i in range(5):
        if i not in listed:
            assert not out[i].any() and not parts[i].any()
        elif i == 3:
            assert torch.isnan(out[i]).any()
        else:
            assert _rel(out[i].numpy(), Ap[i].numpy()) <= 1e-14
            assert float(parts[i].sum()) == pytest.approx(float(pap[i]),
                                                          rel=1e-13)


def test_apply_blocked_reference_tiles_and_kv_free(small):
    """On a grid of several tiles, one partial a (lane, tile) in row-major
    tile order; the Kv-free form with one shared sm plane."""
    rng = np.random.default_rng(3)
    nz, nr = 37, 70
    A0 = torch.tensor(rng.uniform(-1, 1, (7, nz, nr)))
    sm = torch.tensor(rng.uniform(0.5, 1.0, (nz, nr)))
    v = torch.tensor(rng.standard_normal((3, nz, nr)))
    out, parts = cuda_sweep.apply_blocked_reference(A0, None, None, sm, v)
    want = sm * apply_combined(A0, None, None, sm * v)
    assert _rel(out.numpy(), want.numpy()) <= 1e-14
    ty, tx = cuda_sweep.TILE
    assert parts.shape == (3, cuda_sweep.tiles2d(nz, nr)) == (3, 3 * 3)
    prod = (v * want).numpy()
    assert parts[1, 4].item() == pytest.approx(
        prod[1, ty:2 * ty, tx:2 * tx].sum(), rel=1e-12)
    assert parts[2, 8].item() == pytest.approx(
        prod[2, 2 * ty:, 2 * tx:].sum(), rel=1e-12)


@pytest.mark.parametrize("mode", ["init", "alpha", "beta"])
def test_tail_reference_is_finalize_on_the_lanes_it_runs(small, mode):
    """A tail over every lane is finalize_reference; over a lane list, or
    the lanes of one adaptive flag, it leaves the other lanes as they
    were."""
    st = small["state"]
    rng = np.random.default_rng(8)
    parts = torch.tensor(rng.uniform(0.5, 1.5, (4, 5, 3)))
    parts[1, 2] = float("nan")
    kw = dict(rline=True, maxiter=5)
    rtol = torch.tensor([1e-3, 1e-2, 1e-1, 0.5, 2.0])
    whole = cuda_sweep.tail_reference(st, parts, mode, rtol, **kw)
    assert _same(whole, cuda_sweep.finalize_reference(st, parts, mode,
                                                      rtol, **kw))
    some = cuda_sweep.tail_reference(st, parts, mode, rtol, lanes=[0, 2],
                                     **kw)
    assert _same(some[[0, 2]], whole[[0, 2]])
    assert _same(some[[1, 3, 4]], st[[1, 3, 4]])
    flags = torch.tensor([1, 0, 0, 1, 1])
    off = cuda_sweep.tail_reference(st, parts, mode, rtol, flags=flags,
                                    flag_sel=0, **kw)
    assert _same(off[[1, 2]], whole[[1, 2]])
    assert _same(off[[0, 3, 4]], st[[0, 3, 4]])


@pytest.mark.parametrize("first", [True, False])
def test_tail_reference_merged_is_finalize_merged(small, first):
    st = small["state"]
    parts = torch.tensor(np.random.default_rng(9).uniform(0.5, 1.5,
                                                           (4, 5, 2)))
    kw = dict(maxiter=7)
    got = cuda_sweep.tail_reference(
        st, parts, "merged_first" if first else "merged", 0.1, rline=True,
        **kw)
    want = cuda_sweep.finalize_merged_reference(st, parts, first, 0.1,
                                                preconditioned=True, **kw)
    assert _same(got, want)
    with pytest.raises(ValueError, match="tail mode"):
        cuda_sweep.tail_reference(st, parts, "gamma", rline=True, **kw)


@pytest.mark.parametrize("form", ["identity", "rline", "adi", "fixed"])
def test_tail_phases_compose_to_the_solve(small, form):
    """The phase wrappers with their tails (plain versions here), chained as
    an iteration of the redesigned kernels launches them: identity
    stencil + alpha, update + beta, p update; r-line stencil + alpha, the
    fused update and r-line PCR + beta, p update; ADI the same with the
    z-line phase taking beta. After three iterations x and the counts are
    the plain solve's (lane 4 at rtol 2, lane 3 NaN)."""
    t = small
    A0, Kv, dks, sm = _op(t)
    b, x0 = t["b"], t["x0"]
    B = 5
    rline, adi = form in ("rline", "adi"), form == "adi"
    fixed = form == "fixed"
    rtol = torch.tensor([1e-12, 1e-12, 1e-12, 1e-12, 2.0])
    st = cuda_sweep.pack_state(B, "cpu")
    maxiter = 3
    if rline:
        x, r, rr, bb = cuda_sweep.init(A0, Kv, dks, sm, b, x0)
        z, rz = cuda_sweep.pcr_r(A0, Kv, dks, sm, r)
        if adi:
            z, rz = cuda_sweep.pcr_z(A0, Kv, dks, sm, r, z)
        st = cuda_sweep.tail_reference(
            st, torch.stack([rr * 0, rr, rz, bb])[..., None], "init", rtol,
            rline=True, maxiter=maxiter)
    else:
        x, r, rr, bb, st = cuda_sweep.init(A0, Kv, dks, sm, b, x0, st, rtol,
                                           maxiter=maxiter, fixed=fixed)
        z = r
    p = z.clone()
    for _ in range(maxiter):
        Ap, _, st = cuda_sweep.stencil_dot(A0, Kv, dks, sm, p, st)
        if rline:
            x, r, z, _, _, st_n = cuda_sweep.pcr_r_update(
                A0, Kv, dks, sm, x, r, p, Ap, st, adi=adi, maxiter=maxiter)
        else:
            x, r, _, st_n = cuda_sweep.update_beta(x, r, p, Ap, st,
                                                   maxiter=maxiter,
                                                   fixed=fixed)
            z = r
        run = (cuda_sweep.unpack_state(st_n)["done"] == 0)[:, None, None]
        p = torch.where(run, cuda_sweep.p_update(
            p, z, cuda_sweep.unpack_state(st_n)["beta"]), p)
        st = st_n
    x, iters = cuda_sweep.finish(x, st, poison=not fixed)
    if fixed:
        want_x = cuda_sweep.cg_batched_reference(A0, Kv, dks, sm, b, x0,
                                                 iters=maxiter)
        assert iters.tolist() == [3] * 5
    else:
        want_x, want_it = cuda_sweep.cg_batched_tol_reference(
            A0, Kv, dks, sm, b, x0, rtol, rline=form == "rline", adi=adi,
            maxiter=maxiter)
        assert iters.tolist() == want_it.tolist() == [3, 3, 3, 0, 0]
        assert torch.isnan(x[3]).all() and torch.equal(x[4], x0[4])
    live = [0, 1, 2] if not fixed else [0, 1, 2, 4]
    assert _rel(x[live].numpy(), want_x[live].numpy()) <= 1e-12


def test_pcr_r_with_state_is_the_rline_start(small):
    """pcr_r with a state and per-lane <r, r>, <b, b>: z and <r, z> of the
    plain PCR, 0 on the lane the state marks done, which keeps its state;
    the others get the r-line form's first scalars (finalize 'init' with
    rline); without rr and bb it refuses."""
    t = small
    st = t["state"]
    rr = torch.tensor([1.0, 2.0, 0.5, float("nan"), 1e-4])
    bb = torch.tensor([4.0, 3.0, 2.0, 1.0, 1.0])
    rtol = torch.tensor([1e-3, 1e-2, 1e-1, 0.5, 2.0])
    z, rz, st_n = cuda_sweep.pcr_r(*_op(t), t["r"], st, rr, bb, rtol,
                                   maxiter=9)
    z0, rz0 = cuda_sweep.pcr_r(*_op(t), t["r"])
    want = cuda_sweep.finalize_reference(
        st, torch.stack([rr * 0, rr, rz0, bb])[..., None], "init", rtol,
        rline=True, maxiter=9)
    assert not z[1].any() and float(rz[1]) == 0.0
    assert torch.equal(st_n[1], st[1])
    run = [0, 2, 3, 4]
    assert _same(z[run], z0[run]) and _same(rz[run], rz0[run])
    assert _same(st_n[run], want[run])
    f = cuda_sweep.unpack_state(st_n)
    assert f["k"].tolist() == [0, 3, 0, 0, 0]
    assert f["done"].tolist() == [0, 1, 0, 1, 1]    # lane 3 NaN, lane 4 met
    with pytest.raises(ValueError, match="rr and bb"):
        cuda_sweep.pcr_r(*_op(t), t["r"], st)


def test_wrappers_with_state_on_cpu_match_their_references(small):
    """init, stencil_dot, update_beta and merged_w with a state: the
    wrapper's CPU path is the plain version with the tail; a done lane
    reads 0 and keeps its state."""
    t = small
    st = t["state"]
    Ap, pap, st_a = cuda_sweep.stencil_dot(*_op(t), t["p"], st)
    assert not Ap[1].any() and float(pap[1]) == 0.0
    assert torch.equal(st_a[1], st[1])
    f = cuda_sweep.unpack_state(st_a)
    rz = cuda_sweep.unpack_state(st)["rz"]
    assert torch.allclose(f["alpha"][[0, 2, 4]], rz[[0, 2, 4]]
                          / pap[[0, 2, 4]], rtol=1e-14)
    x_n, r_n, rr, st_b = cuda_sweep.update_beta(t["x"], t["r"], t["p"], Ap,
                                                st_a, maxiter=9)
    assert torch.equal(x_n[1], t["x"][1])
    g = cuda_sweep.unpack_state(st_b)
    assert torch.allclose(g["rz"][[0, 2]], rr[[0, 2]], rtol=0)
    w, delta, rr_m, gamma, st_m = cuda_sweep.merged_w(*_op(t), t["x"],
                                                      t["r"], st, maxiter=9)
    assert not w[1].any() and torch.equal(st_m[1], st[1])
    assert _same(st_m, cuda_sweep.tail_reference(
        st, torch.stack([delta, rr_m, gamma, delta * 0])[..., None],
        "merged", rline=True, maxiter=9))
    out = cuda_sweep.init(*_op(t), t["b"], t["x0"], st, 1e-3, maxiter=9)
    assert len(out) == 5
    assert cuda_sweep.unpack_state(out[4])["k"].tolist() == [0] * 5


def _agree(got, want, tol):
    """Kernel outputs against plain ones: fields and sums within tol of
    their largest magnitude, NaN where NaN, integers equal."""
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    for u, v in zip(as_tuple(got), as_tuple(want), strict=True):
        if v.dtype == torch.float64 and v.ndim == 2:          # a lane state
            su, sv = cuda_sweep.unpack_state(u), cuda_sweep.unpack_state(v)
            _agree(tuple(su.values()), tuple(sv.values()), tol)
            continue
        if not v.dtype.is_floating_point:
            assert torch.equal(u.cpu(), v.cpu())
            continue
        assert torch.equal(torch.isnan(u), torch.isnan(v))
        fin = ~torch.isnan(v)
        if fin.any():
            assert float((u - v)[fin].abs().max()) <= \
                tol * max(float(v[fin].abs().max()), 1e-30)


@pytest.mark.cuda
def test_cuda_tail_phases_match_plain(small):
    """The redesigned phase kernels with their tails on the card against
    their plain versions on the same inputs: the first residual with the
    identity form's first scalars, the stencil with alpha, the update with
    beta, the fused update and r-line PCR with beta (and with the z-line
    phase), the merged-dot pass with its scalars, the r-line PCR with the
    r-line form's first scalars; at every lane block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = {k: (v.float() if k != "state" else v).cuda().contiguous()
         for k, v in small.items()}
    op = (g["A0"], g["Kv"], g["dks"], g["sm"])
    st = g["state"]
    rtol = torch.full((5,), 1e-4, dtype=torch.float32, device="cuda")
    sums = torch.linspace(0.5, 2.0, 5, dtype=torch.float64, device="cuda")
    cases = [
        (lambda: cuda_sweep.init(*op, g["b"], g["x0"], st, rtol, maxiter=9),
         lambda: cuda_sweep.init_reference(*op, g["b"], g["x0"], st, rtol,
                                           maxiter=9), 1e-5),
        (lambda: cuda_sweep.stencil_dot(*op, g["p"], st),
         lambda: cuda_sweep.stencil_dot_reference(*op, g["p"], st), 1e-5),
        (lambda: cuda_sweep.update_beta(g["x"], g["r"], g["p"], g["Ap"], st,
                                        maxiter=9),
         lambda: cuda_sweep.update_beta_reference(g["x"], g["r"], g["p"],
                                                  g["Ap"], st, maxiter=9),
         1e-5),
        (lambda: cuda_sweep.merged_w(*op, g["x"], g["r"], st, maxiter=9),
         lambda: cuda_sweep.merged_w_reference(*op, g["x"], g["r"], st,
                                               maxiter=9), 1e-5),
        (lambda: cuda_sweep.pcr_r(*op, g["r"], st, sums, sums * 4, rtol,
                                  maxiter=9),
         lambda: cuda_sweep.pcr_r_reference(*op, g["r"], st, sums, sums * 4,
                                            rtol, maxiter=9), 1e-4)]
    for adi in (False, True):
        cases.append((
            lambda adi=adi: cuda_sweep.pcr_r_update(
                *op, g["x"], g["r"], g["p"], g["Ap"], st, adi=adi,
                maxiter=9),
            lambda adi=adi: cuda_sweep.pcr_r_update_state_reference(
                *op, g["x"], g["r"], g["p"], g["Ap"], st, adi=adi,
                maxiter=9), 1e-4))
    for kernel, plain, tol in cases:
        _agree(kernel(), plain(), tol)


@pytest.mark.cuda
def test_cuda_launches_per_iteration_and_lane_groups(batch):
    """A standard iteration takes 3 launches (identity, r-line) or 4 (ADI,
    adaptive), as does a merged one; each lane of a solve equals, bitwise,
    the same lane solved alone (a lane's arithmetic does not depend on the
    lanes that share its operator-pass block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = {k: v.cuda().contiguous() for k, v in _t(batch, torch.float32)
         .items()}
    flags = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
    want = {"identity": 3, "rline": 3, "adi": 4, "adaptive": 4}
    for merged in (False, True):
        for form, fkw in (("identity", {}), ("rline", dict(rline=True)),
                          ("adi", dict(adi=True)),
                          ("adaptive", dict(adi_flags=flags))):
            cuda_sweep.reset_counters()
            x, it = cuda_sweep.cg_batched_tol(*_args(g), 1e-5, maxiter=5000,
                                              merged=merged, **fkw)
            tag = form + ("_merged" if merged else "")
            assert cuda_sweep.launches_per_iteration() == {tag: want[form]}
            for i in range(3):
                one = {k: (v[i:i + 1].contiguous() if k in ("dks", "sm", "b",
                                                           "x0") else v)
                       for k, v in g.items()}
                kw1 = dict(fkw)
                if form == "adaptive":
                    kw1["adi_flags"] = flags[i:i + 1].contiguous()
                x1, it1 = cuda_sweep.cg_batched_tol(*_args(one), 1e-5,
                                                    maxiter=5000,
                                                    merged=merged, **kw1)
                assert torch.equal(x1[0], x[i]) and int(it1[0]) == int(it[i])


@pytest.mark.cuda
def test_cuda_tall_columns_take_the_tall_z_kernel(small):
    """Columns of more than 256 rows: the z-line phase and an ADI solve
    against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = {k: v.float().cuda() for k, v in small.items() if k != "state"}
    rows = torch.arange(300, device="cuda") % 12
    A0, Kv = g["A0"][:, rows].contiguous(), g["Kv"][:, rows].contiguous()
    sm = g["sm"][:, rows].contiguous()
    r = (g["r"][:, rows] * (sm != 0)).contiguous()
    live = [0, 1, 2, 4]
    dks = g["dks"][live].contiguous()
    sm, r = sm[live].contiguous(), r[live].contiguous()
    z_r, _ = cuda_sweep.pcr_r(A0, Kv, dks, sm, r)
    _agree(cuda_sweep.pcr_z(A0, Kv, dks, sm, r, z_r),
           cuda_sweep.pcr_z_reference(A0, Kv, dks, sm, r, z_r), 1e-4)
    b = (g["b"][live][:, rows] * (sm != 0)).contiguous()
    x0 = torch.zeros_like(b)
    xk, ik = cuda_sweep.cg_batched_tol(A0, Kv, dks, sm, b, x0, 1e-5,
                                       adi=True, maxiter=5000)
    xp, ip = cuda_sweep.cg_batched_tol_reference(A0, Kv, dks, sm, b, x0,
                                                 1e-5, adi=True,
                                                 maxiter=5000)
    assert (ik - ip).abs().max() <= max(3, int(0.05 * int(ip.max())))
    assert float((xk - xp).abs().max() / xp.abs().max()) < 1e-3

"""The port's differentiable solves against the JAX package, in float64:
``pcg_solve`` and ``cg_vmem_solve`` (the JAX kernel in Pallas interpret
mode, the port's plain version) in value, VJP and JVP, and the forward-mode
Jacobian of two tangents over one primal solve. The fit that uses them:
tests/test_torch_fit_driver.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
from heatflow_tpu.ops import cg as jcg
from heatflow_tpu.ops import linesolve as jls
from heatflow_tpu.ops.pallas_cg import cg_vmem_solve as j_vmem_solve
from heatflow_tpu.ops.pallas_cg import pcr_pack as j_pcr_pack
from heatflow_tpu.ops.stencil import (apply_stencil, assemble_stencils,
                                      combine_operator)
from heatflow_tpu_torch.ops import cg as tcg
from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops import linesolve as tls
from heatflow_tpu_torch.ops.stencil import apply_stencil as t_apply
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

SOLVE_TOL = 1e-9   # value, VJP and JVP of a differentiable solve (float64)
THETA = np.array([0.7, 1.3])


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def system():
    """The tiny no-diamond operator with a random Dirichlet pattern, in
    numpy: A0 (7, Nz, Nr), the sample stiffness Kv, a mask, a right-hand
    side and a seed. θ = (θk, θb) enters as A = A0 + θk·dt·Kv (so the
    scaling s depends on θ too) and b = θb·sm·A·(sm·x*)."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = J.build_layout(cfg)
    mesh = J.build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh, backend="numpy")
    dt = 1.5e-7
    A0, _ = combine_operator(jnp.asarray(pack.K), jnp.asarray(pack.M),
                             jnp.asarray([m.kappa for m in mats]),
                             jnp.asarray([m.rho_cv for m in mats]), dt)
    rng = np.random.default_rng(11)
    free = (rng.random(mesh.shape) > 0.15).astype(float)
    return dict(A0=np.asarray(A0), Kv=dt * np.asarray(pack.K)[
        list(mesh.material_tags).index("p_sample")], free=free,
        x_true=rng.standard_normal(mesh.shape) * free,
        x0=rng.standard_normal(mesh.shape) * free,
        g=rng.standard_normal(mesh.shape), tangent=np.array([0.4, -1.1]))


def _operator(xp, apply, d, th):
    """(A, s, sm, b) of θ in the array module ``xp`` (jnp or torch)."""
    A = d["A0"] + th[0] * d["Kv"]
    s = 1.0 / xp.sqrt(xp.where(A[0] > 0, A[0], 1.0 + 0 * A[0])) * d["free"] \
        + (1 - d["free"])
    sm = s * d["free"]
    b = th[1] * sm * apply(A, sm * d["x_true"])
    return A, s, sm, b


def _jax_solve(d, kind, form, rtol_wrt):
    d = {k: jnp.asarray(v) for k, v in d.items()}

    def f(th):
        A, s, sm, b = _operator(jnp, apply_stencil, d, th)
        As, ss = jax.lax.stop_gradient(A), jax.lax.stop_gradient(s)
        if kind == "pcg_solve":
            pre = {"jacobi": None,
                   "rline": jls.line_preconditioner(As, ss, d["free"]),
                   "adi": jls.adi_preconditioner(As, ss, d["free"])}[form]
            return jcg.pcg_solve(lambda y: sm * apply_stencil(A, sm * y), b,
                                 d["x0"], precond=pre, mask=d["free"],
                                 rtol=1e-12, maxiter=5000, rtol_wrt=rtol_wrt)
        stacks = {} if form == "identity" else {
            "pcr": j_pcr_pack(As, ss, d["free"])}
        if form == "adi":
            stacks["pcr_z"] = j_pcr_pack(As, ss, d["free"], axis=-2)
        return j_vmem_solve(A, sm, b, d["x0"], 1e-12, maxiter=5000,
                            rtol_wrt=rtol_wrt, interpret=True, **stacks)
    return f


def _torch_solve(d, kind, form, rtol_wrt):
    d = {k: torch.tensor(v) for k, v in d.items()}

    def f(th):
        A, s, sm, b = _operator(torch, t_apply, d, th)
        As, ss = A.detach(), s.detach()
        if kind == "pcg_solve":
            pre = {"jacobi": None,
                   "rline": tls.line_preconditioner(As, ss, d["free"]),
                   "adi": tls.adi_preconditioner(As, ss, d["free"])}[form]
            return tcg.pcg_solve(lambda y, A, sm: sm * t_apply(A, sm * y), b,
                                 d["x0"], op_args=(A, sm), precond=pre,
                                 mask=d["free"], rtol=1e-12, maxiter=5000,
                                 rtol_wrt=rtol_wrt)
        stacks = {} if form == "identity" else {
            "pcr": cuda_cg.rline_pack(As, ss, d["free"])}
        if form == "adi":
            stacks["pcr_z"] = cuda_cg.zline_pack(As, ss, d["free"])
        return cuda_cg.cg_vmem_solve(A, sm, b, d["x0"], 1e-12, maxiter=5000,
                                     rtol_wrt=rtol_wrt, **stacks)
    return f


@pytest.mark.parametrize("kind, form", [
    ("pcg_solve", "jacobi"), ("pcg_solve", "rline"), ("pcg_solve", "adi"),
    ("cg_vmem_solve", "rline"), ("cg_vmem_solve", "adi")])
@pytest.mark.parametrize("rtol_wrt", ["b", "r0"])
def test_differentiable_solve_matches_jax(system, kind, form, rtol_wrt):
    """Value, VJP (cotangent g) and JVP (tangent t) in θ."""
    fj = _jax_solve(system, kind, form, rtol_wrt)
    ft = _torch_solve(system, kind, form, rtol_wrt)
    thj = jnp.asarray(THETA)
    xj, vjp = jax.vjp(fj, thj)
    (gj,) = vjp(jnp.asarray(system["g"]))
    _, tj = jax.jvp(fj, (thj,), (jnp.asarray(system["tangent"]),))

    th = torch.tensor(THETA, requires_grad=True)
    xt = ft(th)
    (gt,) = torch.autograd.grad(xt, th, torch.tensor(system["g"]))
    _, tt = torch.func.jvp(ft, (torch.tensor(THETA),),
                           (torch.tensor(system["tangent"]),))
    assert _rel(xt.detach().numpy(), xj) <= SOLVE_TOL
    assert _rel(gt.numpy(), gj) <= SOLVE_TOL
    assert _rel(tt.numpy(), tj) <= SOLVE_TOL


@pytest.mark.parametrize("form", ["rline", "adi"])
def test_vmem_solve_gradient_ignores_the_cotangent_at_constrained_dofs(
        system, form):
    """A cotangent's entries at constrained dofs (free = 0) reach no entry
    of the solution: cg_vmem_solve masks the adjoint solve's right-hand side
    there, so the gradient from a cotangent nonzero at those dofs is the
    masked cotangent's bitwise, and each is the JAX package's."""
    fj = _jax_solve(system, "cg_vmem_solve", form, "b")
    ft = _torch_solve(system, "cg_vmem_solve", form, "b")
    _, vjp = jax.vjp(fj, jnp.asarray(THETA))
    g = system["g"]
    masked = g * system["free"]
    assert (g != masked).any()
    grads = []
    for cot in (g, masked):
        (gj,) = vjp(jnp.asarray(cot))
        th = torch.tensor(THETA, requires_grad=True)
        (gt,) = torch.autograd.grad(ft(th), th, torch.tensor(cot))
        assert _rel(gt.numpy(), gj) <= SOLVE_TOL
        grads.append(gt)
    assert torch.equal(*grads)


def test_derivative_solves_are_seeded_at_their_scale(system):
    """The adjoint and tangent solves start from c·x0 with c = ⟨rhs, b⟩ /
    ⟨b, b⟩ (≈ 0 for a derivative-scale rhs): under rtol_wrt='r0' a seed of
    x0 itself would stop them at once and give wrong derivatives. The
    derivative here matches central differences of the value."""
    ft = _torch_solve(system, "pcg_solve", "jacobi", "r0")
    _, tt = torch.func.jvp(ft, (torch.tensor(THETA),),
                           (torch.tensor(system["tangent"]),))
    h = 1e-6
    t = torch.tensor(system["tangent"])
    fd = (ft(torch.tensor(THETA) + h * t) - ft(torch.tensor(THETA) - h * t)) \
        / (2 * h)
    assert _rel(tt.numpy(), fd.numpy()) <= 1e-5


def test_two_tangents_share_one_primal(system, monkeypatch):
    """torch.func.vmap over torch.func.jvp: one primal solve, and both
    tangent solves as one batched solve (two lanes)."""
    calls = []
    pcg = tcg.pcg

    def counting(op, b, x0, **kw):
        calls.append(tuple(b.shape))
        return pcg(op, b, x0, **kw)

    monkeypatch.setattr(tcg, "pcg", counting)
    ft = _torch_solve(system, "pcg_solve", "rline", "b")
    x, J = torch.func.vmap(lambda t: torch.func.jvp(ft, (torch.tensor(
        THETA),), (t,)), out_dims=(None, 0))(torch.eye(2, dtype=torch.float64))
    shape = system["free"].shape
    assert calls == [shape, (2,) + shape]
    for i in range(2):
        _, ti = torch.func.jvp(ft, (torch.tensor(THETA),),
                               (torch.eye(2, dtype=torch.float64)[i],))
        assert _rel(J[i].numpy(), ti.numpy()) <= 1e-12


def test_vmem_solve_reference_is_the_cpu_path(system):
    """On CPU tensors cg_vmem_solve runs the plain version: its value and
    gradients are cg_vmem_solve_reference's bitwise, and no kernel launch
    is counted."""
    d = {k: torch.tensor(v) for k, v in system.items()}
    cuda_cg.reset_counters()
    outs = []
    for solve in (cuda_cg.cg_vmem_solve, cuda_cg.cg_vmem_solve_reference):
        th = torch.tensor(THETA, requires_grad=True)
        A, s, sm, b = _operator(torch, t_apply, d, th)
        x = solve(A, sm, b, d["x0"], 1e-10, rtol_wrt="b",
                  pcr=cuda_cg.rline_pack(A.detach(), s.detach(), d["free"]))
        (g,) = torch.autograd.grad(x, th, d["g"])
        outs.append((x.detach(), g))
    assert all(torch.equal(u, v) for u, v in zip(*outs))
    assert (cuda_cg.cg_vmem_solve.launches_forward,
            cuda_cg.cg_vmem_solve.launches_backward,
            cuda_cg.cg_vmem_solve.launches_jvp) == (0, 0, 0)


@pytest.mark.cuda
def test_cuda_vmem_solve_counts_each_direction(system):
    """On the card: one cg_tol launch for the value, one for a backward pass
    and one for a tangent (plus the jvp's value), near the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    d = {k: torch.tensor(v, dtype=torch.float32, device="cuda")
         for k, v in system.items()}
    th = torch.tensor(THETA, dtype=torch.float32, device="cuda")

    def f(solve, th):
        A, s, sm, b = _operator(torch, t_apply, d, th)
        return solve(A.contiguous(), sm.contiguous(), b.contiguous(),
                     d["x0"], 1e-5, rtol_wrt="b",
                     pcr=cuda_cg.rline_pack(A.detach(), s.detach(),
                                            d["free"]).contiguous())
    cuda_cg.reset_counters()
    thg = th.clone().requires_grad_()
    x = f(cuda_cg.cg_vmem_solve, thg)
    (g,) = torch.autograd.grad(x, thg, d["g"])
    _, t = torch.func.jvp(lambda th: f(cuda_cg.cg_vmem_solve, th), (th,),
                          (d["tangent"].float(),))
    assert (cuda_cg.cg_vmem_solve.launches_forward,
            cuda_cg.cg_vmem_solve.launches_backward,
            cuda_cg.cg_vmem_solve.launches_jvp) == (2, 1, 1)
    thr = th.clone().requires_grad_()
    xr = f(cuda_cg.cg_vmem_solve_reference, thr)
    (gr,) = torch.autograd.grad(xr, thr, d["g"])
    assert float((x - xr).abs().max() / xr.abs().max()) < 1e-3
    assert float((g - gr).abs().max() / gr.abs().max()) < 1e-2


def test_kernel_solves_see_plain_tensors(system, monkeypatch):
    """Every cg_tol call of cg_vmem_solve, primal, adjoint and the batched
    tangents under torch.func.vmap(jvp), gets tensors with storage (the
    autograd and torch.func wrappers taken off), as the CUDA kernel needs
    their pointers."""
    import functools
    kernel = cuda_cg.cg_tol
    calls = []

    @functools.wraps(kernel)
    def spy(*args, **kw):
        ts = [a for a in (*args, *kw.values()) if torch.is_tensor(a)]
        for t in ts:
            t.data_ptr()          # raises on a wrapper without storage
        calls.append(tuple(args[2].shape))
        return kernel(*args, **kw)

    monkeypatch.setattr(cuda_cg, "cg_tol", spy)
    ft = _torch_solve(system, "cg_vmem_solve", "rline", "r0")
    th = torch.tensor(THETA, requires_grad=True)
    torch.autograd.grad(ft(th).sum(), th)
    torch.func.vmap(lambda t: torch.func.jvp(ft, (torch.tensor(THETA),),
                                             (t,)), out_dims=(None, 0))(
        torch.eye(2, dtype=torch.float64))
    shape = system["free"].shape
    assert calls == [shape] * 5       # primal, adjoint, primal, 2 tangents

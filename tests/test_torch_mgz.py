"""The port's z-semicoarsened multigrid (mgz): the operand packing and the
plain V-cycle against the JAX package's, and the mgz form of the CG kernel's
plain version against the Pallas kernel in interpret mode, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.geometry import build_layout
from heatflow_tpu.mesh.structured import build_structured_mesh
from heatflow_tpu.ops import mgz as j_mgz
from heatflow_tpu.ops.pallas_cg import cg_vmem_tol
from heatflow_tpu.ops.pallas_cg import pcr_pack as j_pcr_pack
from heatflow_tpu.ops.stencil import (apply_stencil, assemble_stencils,
                                      combine_operator)
from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops import mgz as t_mgz
from heatflow_tpu_torch.ops.linesolve import thomas_apply_lines
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    """The system of tests/test_torch_cg_kernel.py (random Dirichlet mask,
    numpy-seeded right-hand side) with the mgz operands of each package."""
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
    host = tuple(np.asarray(v) for v in (A, s, free))
    pj = j_mgz.mgz_pack(*host, np.float64)
    pt = t_mgz.mgz_pack(*host, np.float64)
    j = dict(A=A, sm=sm, b=b, x0=x0, pcr=j_pcr_pack(A, s, free),
             mgz={k: jnp.asarray(v) for k, v in pj.items()})
    t = {k: torch.tensor(np.asarray(v)) for k, v in j.items() if k != "mgz"}
    ts, tfree = torch.tensor(np.asarray(s)), torch.tensor(np.asarray(free))
    t["pcr"] = cuda_cg.rline_pack(t["A"], ts, tfree)
    t["pcr_z"] = cuda_cg.zline_pack(t["A"], ts, tfree)
    t["mgz"] = {k: torch.tensor(v) for k, v in pt.items()}
    return j, t, host, pj, pt, rng


@pytest.mark.parametrize("key", ["Ac9", "pcrc", "aux"])
def test_mgz_pack_matches_jax(system, key):
    """Each operand within 1e-12 of the JAX module's, in float64; the
    coarse rows' Thomas factors (the JAX module packs their folded PCR
    stack) by the line solves they give."""
    _, _, host, pj, pt, _ = system
    assert pt[key].dtype == np.float64
    if key == "pcrc":
        assert pt[key].shape == (3,) + pj[key].shape[1:]
        d = torch.tensor(np.random.default_rng(3).standard_normal(
            pj[key].shape[1:]))
        want = cuda_cg.pcr_stack_apply(torch.tensor(pj[key]), d).numpy()
        got = thomas_apply_lines(torch.tensor(pt[key]), d).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    else:
        assert pt[key].shape == pj[key].shape
        assert np.abs(pt[key] - pj[key]).max() \
            <= 1e-12 * np.abs(pj[key]).max()
    p32 = t_mgz.mgz_pack(*host)
    assert p32[key].dtype == np.float32


def test_mgz_offsets_and_inert_odd_rows(system):
    _, _, _, _, pt, _ = system
    assert t_mgz.MGZ_OFFSETS == j_mgz.MGZ_OFFSETS
    sc, pm, pp, e_free = pt["aux"]
    # the kernel relies on these being zero on the rows they do not own
    assert not e_free[1::2].any() and not pm[0::2].any() \
        and not pp[0::2].any()
    assert (pt["Ac9"][0][1::2] == 1).all() and not pt["Ac9"][1:, 1::2].any()


@pytest.mark.parametrize("sweeps", [1, 2, 3])
def test_reference_vcycle_matches_jax_and_is_symmetric(system, sweeps):
    _, t, host, pj, pt, rng = system
    free = host[2]
    vj = j_mgz.mgz_reference_vcycle(*host, pj, sweeps=sweeps)
    vt = t_mgz.mgz_reference_vcycle(*host, pt, sweeps=sweeps)
    u = rng.standard_normal(free.shape) * free
    v = rng.standard_normal(free.shape) * free
    Mu_j, Mu_t = vj(u), vt(u)
    # the same cycle (its line solves by Thomas' algorithm here, by PCR
    # there): 1e-12 of the largest value
    assert np.abs(Mu_t - Mu_j).max() <= 1e-12 * np.abs(Mu_j).max()
    # symmetric by construction: <v, M u> = <u, M v> to float64 rounding
    a, b = float((v * Mu_t).sum()), float((u * vt(v)).sum())
    assert abs(a - b) <= 1e-10 * max(abs(a), abs(b))
    # and it is the preconditioner of the kernel's plain version
    z, rz = cuda_cg.precond_apply(t["A"], t["sm"], torch.tensor(u),
                                  pcr=t["pcr"], mgz=t["mgz"],
                                  mgz_sweeps=sweeps)
    assert np.abs(z.numpy() - Mu_t).max() <= 1e-12 * np.abs(Mu_t).max()
    assert float(rz) == pytest.approx(float((u * Mu_t).sum()), rel=1e-12)


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_mgz_solve_matches_pallas_interpret(system, sweeps, rtol_wrt):
    """Equal counts +- 2, rel-L2 <= 1e-5 (the two run the same recurrence;
    only the sums' order differs), and fewer than half the r-line solve's
    iterations."""
    j, t, *_ = system
    kw = dict(maxiter=5000, rtol_wrt=rtol_wrt)
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], 1e-10,
                         interpret=True, merged=False, pcr=j["pcr"],
                         mgz=j["mgz"], mgz_sweeps=sweeps, **kw)
    xt, it = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-10,
                            pcr=t["pcr"], mgz=t["mgz"], mgz_sweeps=sweeps,
                            **kw)
    _, it_rline = cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-10,
                                 pcr=t["pcr"], **kw)
    assert abs(int(it) - int(ij)) <= 2, (int(it), int(ij))
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-5 * np.linalg.norm(xj)
    assert int(it) < 0.5 * int(it_rline), (int(it), int(it_rline))


def test_mgz_argument_checks(system):
    _, t, *_ = system
    args = (t["A"], t["sm"], t["b"], t["x0"], 1e-6)
    with pytest.raises(ValueError, match="smoother"):
        cuda_cg.cg_tol(*args, mgz=t["mgz"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        cuda_cg.cg_tol(*args, pcr=t["pcr"], pcr_z=t["pcr_z"], mgz=t["mgz"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        cuda_cg.cg_tol(*args, pcr=t["pcr"], mgz=t["mgz"], merged=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        cuda_cg.cg_tol(*args, pcr=t["pcr"], cheb_degree=2)
    with pytest.raises(ValueError, match="7-point"):
        t_mgz.mgz_pack(np.zeros((9, 4, 4)), np.ones((4, 4)), np.ones((4, 4)))


def test_mgz_phase_wrappers_on_cpu_are_the_plain_phases(system):
    """On CPU tensors each phase wrapper of the cycle is its plain version,
    and the phases compose to the cycle."""
    _, t, _, _, _, rng = system
    A, sm, pcr, m = t["A"], t["sm"], t["pcr"], t["mgz"]
    free = (sm != 0).double()
    r = torch.tensor(rng.standard_normal(sm.shape)) * free
    _, _, x, _ = cuda_cg.mgz_pre(r, pcr, 0.8)
    yc, rcs = cuda_cg.mgz_coarse(A, sm, r, x, m["aux"], m["pcrc"], 0.8)
    yc = cuda_cg.mgz_coarse_res(m["Ac9"], rcs, yc, m["pcrc"], 0.8)
    x, r2 = cuda_cg.mgz_prolong_res(A, sm, r, x, yc, m["aux"])
    z, rz = cuda_cg.mgz_post(r2, x, pcr, 0.8, sm, r)
    want, rz_want = cuda_cg.precond_apply_reference(A, sm, r, pcr=pcr, mgz=m,
                                                    mgz_sweeps=2)
    assert torch.equal(z, want) and float(rz) == float(rz_want)

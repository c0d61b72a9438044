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
    with both PCR stacks packed by each package."""
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
    t["pcr"] = cuda_cg.pcr_pack(t["A"], torch.tensor(np.asarray(s)),
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
    want, got = np.asarray(j[key]), t[key].numpy()
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

"""The z-line solve of the single-problem CG's ADI form (K1): every grid
column's line-tridiagonal system factored once by Thomas' elimination
(``cuda_cg.zline_pack``, three planes) and solved from the factors. On the
CPU the plain factor and apply against dense solves of each column and
against the folded PCR stack, on the flagship's operator and on a 9-plane
Galerkin operator of its multigrid hierarchy; a folded PCR stack in the
factors' place raises at every entry point; the flagship's first-step ADI
solve from the factors against the same solve from the stack. On the card
the factor kernel, the z-line kernel (a column of at most 256 rows and a
taller one) and the flagship's first-step ADI solve against their plain
versions.
"""

import numpy as np
import pytest
import torch

from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops.linesolve import (line_couplings,
                                              thomas_apply_lines)
from heatflow_tpu_torch.ops.stencil import OFFSETS
from tests.test_torch_rline import (_cuda, _rel, card_flagship,  # noqa: F401
                                    flagship, tiny)

torch.set_num_threads(1)

UP, LO = OFFSETS.index((1, 0)), OFFSETS.index((-1, 0))   # z+1, z-1


def _columns(free):
    """Columns to solve densely: every column with a Dirichlet point past
    its ends, up to six, and five more spread over the grid."""
    nr = free.shape[1]
    masked = [j for j in range(nr) if bool((free[1:-1, j] == 0).any())]
    spread = np.linspace(1, nr - 2, 5).astype(int).tolist()
    return sorted(set(masked[:3] + masked[-3:] + spread))


def _dense_column(A, s, free, j):
    """Column j's line system as a dense matrix, from the operator's planes:
    the z-tridiagonal part of (s·free)·A·(s·free) on its unit diagonal,
    identity rows at the Dirichlet points."""
    sf = (s * free)[:, j]
    T = torch.eye(sf.shape[0], dtype=sf.dtype)
    T += torch.diag((sf * A[UP, :, j])[:-1] * sf[1:], 1)
    T += torch.diag((sf * A[LO, :, j])[1:] * sf[:-1], -1)
    return T


@pytest.mark.parametrize("npts", [7, 9])
def test_plain_z_factors_solve_each_column_exactly(flagship, npts):
    """The factor and apply of each column against torch.linalg.solve of
    the column's dense tridiagonal system, float64, within 1e-12 of the
    largest value: columns with Dirichlet points inside and columns
    between."""
    A, s, free = flagship[npts]
    F = cuda_cg.zline_pack(A, s, free)
    assert F.shape == (3,) + tuple(s.shape) and F.dtype == torch.float64
    assert F.is_contiguous()
    rng = np.random.default_rng(11)
    d = torch.tensor(rng.standard_normal(tuple(s.shape)))
    x = thomas_apply_lines(F, d, axis=-2)
    cols = _columns(free)
    assert any(bool((free[1:-1, j] == 0).any()) for j in cols)
    for j in cols:
        want = torch.linalg.solve(_dense_column(A, s, free, j), d[:, j])
        err = float((x[:, j] - want).abs().max())
        assert err <= 1e-12 * float(want.abs().max()), (j, err)
    l, u = line_couplings(A, s * free, -2)
    assert float(l[0].abs().max()) == 0.0
    assert float(u[-1].abs().max()) == 0.0


@pytest.mark.parametrize("npts", [7, 9])
def test_plain_z_apply_matches_the_folded_pcr_stack(flagship, npts):
    """The same column solves as the folded z-line PCR stack of the same
    operator, every column: within 1e-12 in float64. In float32 both round
    the operator first (the columns' solves amplify that ~400 times from a
    unit right-hand side on the flagship) and then round in another order:
    the factors' solve no further from the float64 solve than 1.5 times the
    stack's, and the two within 1e-4 of the largest value. The ADI
    preconditioner's plain version is R r + Z r − r on the free points. The
    factors read the z-coupling planes only."""
    A, s, free = flagship[npts]
    F = cuda_cg.zline_pack(A, s, free)
    rng = np.random.default_rng(12)
    d = torch.tensor(rng.standard_normal(tuple(s.shape))) * free
    want = cuda_cg.pcr_stack_apply(cuda_cg.pcr_pack(A, s, free, axis=-2), d,
                                   -2)
    got = thomas_apply_lines(F, d, axis=-2)
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-12 * top
    Fr = cuda_cg.rline_pack(A, s, free)
    z, _ = cuda_cg.precond_reference(s * free, d, pcr=Fr, pcr_z=F)
    assert torch.equal(z, (thomas_apply_lines(Fr, d) + got - d) * free)
    A32, s32, free32, d32 = (t.float() for t in (A, s, free, d))
    got32 = thomas_apply_lines(cuda_cg.zline_pack(A32, s32, free32), d32,
                               axis=-2)
    want32 = cuda_cg.pcr_stack_apply(
        cuda_cg.pcr_pack(A32, s32, free32, axis=-2), d32, -2)
    dist = lambda v: float((v.double() - got).abs().max()) / top
    assert dist(got32) <= 1.5 * dist(want32), (dist(got32), dist(want32))
    assert float((got32 - want32).abs().max()) <= 1e-4 * top
    if npts == 9:
        A7 = A.clone()
        A7[7:] = 0.0
        assert torch.equal(cuda_cg.zline_pack(A7, s, free), F)


ENTRIES = {
    "cg_tol": lambda t, Fz: cuda_cg.cg_tol(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=t["F"], pcr_z=Fz),
    "cg_tol_reference": lambda t, Fz: cuda_cg.cg_tol_reference(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=t["F"], pcr_z=Fz),
    "cg_vmem_solve": lambda t, Fz: cuda_cg.cg_vmem_solve(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=t["F"], pcr_z=Fz),
    "cg_vmem_solve_reference": lambda t, Fz: cuda_cg.cg_vmem_solve_reference(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=t["F"], pcr_z=Fz),
    "precond": lambda t, Fz: cuda_cg.precond(t["sm"], t["b"], t["F"], Fz),
    "update_precond": lambda t, Fz: cuda_cg.update_precond(
        t["x0"], t["b"], t["b"], t["b"], t["sm"], t["F"], Fz,
        state=dict(alpha=0.1, rz=1.0, rr=1.0, stop2=0.0, beta=0.0, k=0,
                   done=0)),
    # the transient's graph path checks its float32 operands this way
    "transient graph (_check_solve)": lambda t, Fz: cuda_cg._check_solve(
        t["A"].float(), t["sm"].float(), pcr=t["F"].float(),
        pcr_z=Fz.float(), cheb_degree=0, merged=False, mgz=None,
        mgz_sweeps=1, rtol_wrt="r0"),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_a_folded_stack_as_the_zline_operand_raises(tiny, entry):
    """A folded z-line PCR stack where an entry point takes the z-line
    factors raises, rather than being read as factors; the factors
    themselves run."""
    A, sm = tiny["A"], tiny["sm"]
    s = torch.rsqrt(torch.where(A[0] > 0, A[0], torch.ones_like(A[0])))
    free = (sm != 0).to(sm.dtype)
    stack = cuda_cg.pcr_pack(A, s, free, axis=-2)
    assert stack.shape[0] > 3
    with pytest.raises(ValueError, match="z-line Thomas factors"):
        ENTRIES[entry](tiny, stack)
    ENTRIES[entry](tiny, cuda_cg.zline_pack(A, s, free))


@pytest.fixture(scope="module")
def first_step(flagship):
    """The flagship's first-step refinement system in float32 on the CPU
    (``chip_smoke.first_step_system``) with its r-line and z-line factors
    and its folded z-line PCR stack."""
    import chip_smoke
    A, sm, s, free, b = chip_smoke.first_step_system(flagship["problem"],
                                                     torch.device("cpu"))
    return dict(A=A, sm=sm, b=b, F=cuda_cg.rline_pack(A, s, free),
                Fz=cuda_cg.zline_pack(A, s, free),
                stack=cuda_cg.pcr_pack(A, s, free, axis=-2))


def test_plain_adi_solve_counts_match_the_stack(first_step, monkeypatch):
    """The flagship's first-step ADI solve at rtol 1e-5 wrt ||b||, float32,
    from the z-line factors and, as the plain version solved it before,
    from the folded z-line PCR stack: the same preconditioner to float32
    rounding, so the counts within 1 of each other and the solutions
    within 1e-4 (rel-L2)."""
    g = first_step
    x0 = torch.zeros_like(g["b"])
    kw = dict(maxiter=20000, rtol_wrt="b", pcr=g["F"], pcr_z=g["Fz"])
    x_f, it_f = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], x0, 1e-5,
                                         **kw)

    def from_stack(A, sm, pcr, pcr_z, *args):
        free = (sm != 0).to(sm.dtype)
        return lambda r: (thomas_apply_lines(pcr, r)
                          + cuda_cg.pcr_stack_apply(g["stack"], r, -2)
                          - r) * free

    monkeypatch.setattr(cuda_cg, "_precond_reference", from_stack)
    x_s, it_s = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], x0, 1e-5,
                                         **kw)
    assert abs(int(it_f) - int(it_s)) <= 1, (int(it_f), int(it_s))
    rel = float(torch.linalg.vector_norm((x_f - x_s).double())
                / torch.linalg.vector_norm(x_s.double()))
    assert rel <= 1e-4, rel


# ----------------------------------------------------------------------
# the kernels on the card
# ----------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_z_factor_kernel_matches_plain(card_flagship):
    """The z-line factor kernel on the flagship's float32 operator against
    the plain factors: the same float32 couplings and the same float64
    sweep, each product and difference rounded alone, so equal to a
    float32 rounding (1e-6 of each plane's largest value), one launch."""
    g = card_flagship
    want = cuda_cg.zline_pack_reference(g["A"], g["s"], g["free"])
    cuda_cg.reset_counters()
    F = cuda_cg.zline_pack(g["A"], g["s"], g["free"])
    assert cuda_cg.zline_pack.launches == 1
    assert F.shape == want.shape and F.dtype == torch.float32
    for k in range(3):
        assert _rel(F[k], want[k]) <= 1e-6, k


def _tall_operator(nz: int, nr: int, dev):
    """A numpy-seeded anisotropic 5-point operator with a Dirichlet row and
    a Dirichlet column stretch, in float32 on the card: (A, s, free)."""
    rng = np.random.default_rng(3)
    az = torch.tensor(rng.uniform(0.5, 1.5, (nz - 1, nr)))
    ar = torch.tensor(rng.uniform(0.5, 1.5, (nz, nr - 1))) * 20.0
    A = torch.zeros((7, nz, nr), dtype=torch.float64)
    A[1, :-1], A[2, 1:] = -az, -az
    A[3, :, :-1], A[4, :, 1:] = -ar, -ar
    A[0] = -A[1:5].sum(dim=0) + 0.1
    free = torch.ones((nz, nr), dtype=torch.float64)
    free[0] = 0.0
    free[nz // 3: nz // 2, nr // 4] = 0.0
    s = torch.rsqrt(A[0]) * free + (1.0 - free)
    return tuple(t.float().to(dev).contiguous() for t in (A, s, free))


# The z-line kernel against its plain version: the kernel composes each
# lane's chunk of a column and scans the chunks, the plain version sweeps
# the column in sequence, so float32 rounds in another order; the
# multipliers and cp are below 1 in magnitude, so the difference does not
# grow along the column: within 1e-5 of the largest value, as the row
# kernel (tests/test_torch_rline.py).
ZLINE_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship", "tall"])
def test_cuda_zline_kernel_matches_plain(card_flagship, shape):
    """The z-line kernel alone (after the r-line row kernel) and in the
    fused phase with its beta tail, against the plain versions: on the
    flagship (251 rows) and on a 600 x 700 operator (600 rows)."""
    g = card_flagship
    dev = g["A"].device
    A, s, free = ((g["A"], g["s"], g["free"]) if shape == "flagship"
                  else _tall_operator(600, 700, dev))
    sm = (s * free).contiguous()
    F = cuda_cg.rline_pack(A, s, free)
    Fz = cuda_cg.zline_pack(A, s, free)
    rng = np.random.default_rng(8)
    field = lambda: (torch.tensor(rng.standard_normal(tuple(s.shape)),
                                  dtype=torch.float32, device=dev)
                     * free).contiguous()
    x, r, p = field(), field(), field()
    z, rz = cuda_cg.precond(sm, r, F, Fz)
    z_p, rz_p = cuda_cg.precond_reference(sm, r, F, Fz)
    assert _rel(z, z_p) <= ZLINE_TOL, _rel(z, z_p)
    assert float(rz) == pytest.approx(float(rz_p), rel=1e-5)
    Ap = cuda_cg.stencil_dot_reference(A, sm, p)[0].contiguous()
    st = dict(rz=0.73, rr=0.5, stop2=1e-12, alpha=0.0137, beta=0.0, k=3,
              done=0)
    got = cuda_cg.update_precond(x, r, p, Ap, sm, F, Fz, state=st)
    want = cuda_cg.update_precond_reference(x, r, p, Ap, st["alpha"], sm, F,
                                            Fz)
    for a, b in zip(got[:3], want[:3], strict=True):
        assert _rel(a, b) <= ZLINE_TOL, _rel(a, b)
    for a, b in zip(got[3:5], want[3:5], strict=True):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    st_p = cuda_cg.finalize_reference(st, "beta", rr=want[3], rz=want[4])
    assert got[5]["k"] == st_p["k"] == 4 and got[5]["done"] == 0
    assert got[5]["beta"] == pytest.approx(st_p["beta"], rel=1e-5)


@pytest.mark.cuda
def test_cuda_flagship_first_step_adi_counts_match_plain(card_flagship):
    """The flagship's first-step refinement system by the ADI form at rtol
    1e-5 wrt ||b||, z-line factors from the kernel: the kernel's count
    within 2 of the plain version's, its solution within 1e-3 (rel-L2);
    three launches an iteration (the stencil pass forms p)."""
    g = card_flagship
    kw = dict(maxiter=20000, rtol_wrt="b",
              pcr=cuda_cg.rline_pack(g["A"], g["s"], g["free"]),
              pcr_z=cuda_cg.zline_pack(g["A"], g["s"], g["free"]))
    b = g["b"]
    x0 = torch.zeros_like(b)
    cuda_cg.reset_counters()
    xk, ik = cuda_cg.cg_tol(g["A"], g["sm"], b, x0, 1e-5, **kw)
    xp, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], b, x0, 1e-5, **kw)
    assert abs(int(ik) - int(ip)) <= 2, (int(ik), int(ip))
    rel = float(torch.linalg.vector_norm((xk - xp).double())
                / torch.linalg.vector_norm(xp.double()))
    assert rel <= 1e-3, rel
    assert cuda_cg.graph_stats()["adi"]["launches_per_iteration"] == 3

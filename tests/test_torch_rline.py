"""The r-line solve of the single-problem CG (K1): every grid row's
line-tridiagonal system factored once by Thomas' elimination
(``cuda_cg.rline_pack``, three planes) and solved from the factors. On the
CPU the plain factor and apply against dense solves of each row and against
the folded PCR stack, on the flagship's operator and on a 9-plane Galerkin
operator of its multigrid hierarchy; the mgz coarse rows' factors against
the coarse lines' dense solves; a folded PCR stack in the factors' place
raises. On the card the factor kernel, the row kernel in its four load
modes and the flagship's first-step solves against their plain versions.
"""

import os

import numpy as np
import pytest
import torch

from heatflow_tpu_torch import (build_layout, build_structured_mesh,
                                load_config)
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops import mgz as t_mgz
from heatflow_tpu_torch.ops.linesolve import (line_couplings,
                                              thomas_apply_lines)
from heatflow_tpu_torch.ops.multigrid import build_hierarchy
from heatflow_tpu_torch.ops.stencil import (OFFSETS, apply_stencil,
                                            assemble_stencils,
                                            combine_operator)
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
from tests.fixtures import tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "geballe_with_diamond.yaml")
CSV = os.path.join(ROOT, "experimental_data", "geballe_heat_data.csv")
UP, LO = OFFSETS.index((0, 1)), OFFSETS.index((0, -1))   # r+1, r-1


def _scaled(A, dirichlet):
    """(A, s, free) of the scaled system: s = rsqrt(diag)·free + dirichlet."""
    free = 1.0 - dirichlet
    s = torch.rsqrt(torch.where(A[0] > 0, A[0], torch.ones_like(A[0]))) \
        * free + dirichlet
    return A, s, free


@pytest.fixture(scope="module")
def flagship():
    """The flagship's first-step operator (251 x 1107, graded in r and z,
    Dirichlet rows and points) in float64, and the 9-plane Galerkin
    operator of level 1 of its multigrid hierarchy (127 x 555)."""
    cfg = load_config(CFG)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    problem = build_problem(mesh, HeatingCurve.from_csv(CSV), cfg,
                            watcher_points=coupler_watcher_points(cfg))
    d = problem.device_arrays(torch.float64, "cpu")
    dt = torch.tensor(problem.dt, dtype=torch.float64)
    A7, _ = combine_operator(d["K"], d["M"], d["kappas"], d["rho_cvs"], dt)
    lv = build_hierarchy(mesh, problem.dirichlet_mask, max_levels=2,
                         stencils=problem.stencils)[1]
    A9, _ = combine_operator(torch.tensor(lv.K), torch.tensor(lv.M),
                             d["kappas"], d["rho_cvs"], dt)
    assert A9.shape[0] == 9 and float(A9[7:].abs().max()) > 0
    return {7: _scaled(A7, d["dirichlet"]),
            9: _scaled(A9, torch.tensor(lv.dirichlet, dtype=torch.float64)),
            "problem": problem}


def _rows(free):
    """Rows to solve densely: every row with a Dirichlet point, up to
    six, and five more spread over the grid."""
    nz = free.shape[0]
    masked = [i for i in range(nz) if bool((free[i] == 0).any())]
    spread = np.linspace(1, nz - 2, 5).astype(int).tolist()
    return sorted(set(masked[:3] + masked[-3:] + spread))


def _dense_row(A, s, free, i):
    """Row i's line system as a dense matrix, from the operator's planes:
    the r-tridiagonal part of (s·free)·A·(s·free) on its unit diagonal
    (s² A[0] = 1 at a free point, to rounding), identity rows at the
    Dirichlet points."""
    sf = (s * free)[i]
    T = torch.eye(sf.shape[0], dtype=sf.dtype)
    T += torch.diag((sf * A[UP, i])[:-1] * sf[1:], 1)
    T += torch.diag((sf * A[LO, i])[1:] * sf[:-1], -1)
    return T


@pytest.mark.parametrize("npts", [7, 9])
def test_plain_factors_solve_each_row_exactly(flagship, npts):
    """The factor and apply of each row against torch.linalg.solve of the
    row's dense tridiagonal system, float64, within 1e-12 of the largest
    value: rows with Dirichlet points and rows between."""
    A, s, free = flagship[npts]
    F = cuda_cg.rline_pack(A, s, free)
    assert F.shape == (3,) + tuple(s.shape) and F.dtype == torch.float64
    rng = np.random.default_rng(1)
    d = torch.tensor(rng.standard_normal(tuple(s.shape)))
    x = thomas_apply_lines(F, d)
    sf = s * free
    assert float((sf * sf * A[0] - 1)[free > 0].abs().max()) <= 1e-14
    rows = _rows(free)
    assert any(bool((free[i] == 0).any()) for i in rows)
    for i in rows:
        want = torch.linalg.solve(_dense_row(A, s, free, i), d[i])
        err = float((x[i] - want).abs().max())
        assert err <= 1e-12 * float(want.abs().max()), (i, err)


@pytest.mark.parametrize("npts", [7, 9])
def test_plain_factors_match_the_folded_pcr_stack(flagship, npts):
    """The same line solves as the folded PCR stack of the same operator,
    every row, within 1e-12; the factors read the r-coupling planes only
    (a 9-plane operator's anti-diagonals do not enter them)."""
    A, s, free = flagship[npts]
    F = cuda_cg.rline_pack(A, s, free)
    rng = np.random.default_rng(2)
    d = torch.tensor(rng.standard_normal(tuple(s.shape))) * free
    want = cuda_cg.pcr_stack_apply(cuda_cg.pcr_pack(A, s, free), d)
    got = thomas_apply_lines(F, d)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())
    z, _ = cuda_cg.precond_reference(s * free, d, pcr=F)
    assert torch.equal(z, got * free)
    if npts == 9:
        A7 = A.clone()
        A7[7:] = 0.0
        assert torch.equal(cuda_cg.rline_pack(A7, s, free), F)
    l, u = line_couplings(A, s * free, -1)
    assert float(l[:, 0].abs().max()) == 0.0
    assert float(u[:, -1].abs().max()) == 0.0


def test_mgz_coarse_factors_solve_the_coarse_lines():
    """mgz_pack's coarse factors against each embedded coarse row's dense
    tridiagonal solve (Ac9's diagonal and r-coupling planes), float64: the
    even rows within 1e-12, the odd (identity) rows exactly."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = torch.tensor([m.kappa for m in mats], dtype=torch.float64)
    rc = torch.tensor([m.rho_cv for m in mats], dtype=torch.float64)
    A, _ = combine_operator(torch.tensor(pack.K), torch.tensor(pack.M), kp,
                            rc, torch.tensor(1.5e-7, dtype=torch.float64))
    rng = np.random.default_rng(0)
    dirichlet = torch.tensor((rng.random(mesh.shape) <= 0.15).astype(float))
    A, s, free = _scaled(A, dirichlet)
    m = t_mgz.mgz_pack(A.numpy(), s.numpy(), free.numpy(), np.float64)
    Ac9, pcrc = torch.tensor(m["Ac9"]), torch.tensor(m["pcrc"])
    assert pcrc.shape == (3,) + tuple(s.shape)
    d = torch.tensor(rng.standard_normal(tuple(s.shape)))
    x = thomas_apply_lines(pcrc, d)
    assert torch.equal(x[1::2], d[1::2])
    for i in range(0, s.shape[0], 2):
        T = (torch.diag(Ac9[0, i]) + torch.diag(Ac9[UP, i, :-1], 1)
             + torch.diag(Ac9[LO, i, 1:], -1))
        want = torch.linalg.solve(T, d[i])
        assert float((x[i] - want).abs().max()) \
            <= 1e-12 * float(want.abs().max()), i


@pytest.fixture(scope="module")
def tiny():
    """A small scaled system (random Dirichlet mask) with its r-line
    factors, its folded r-line PCR stack and its mgz operands."""
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    pack = assemble_stencils(mesh)
    kp = torch.tensor([m.kappa for m in mats], dtype=torch.float64)
    rc = torch.tensor([m.rho_cv for m in mats], dtype=torch.float64)
    A, _ = combine_operator(torch.tensor(pack.K), torch.tensor(pack.M), kp,
                            rc, torch.tensor(1.5e-7, dtype=torch.float64))
    rng = np.random.default_rng(5)
    dirichlet = torch.tensor((rng.random(mesh.shape) <= 0.15).astype(float))
    A, s, free = _scaled(A, dirichlet)
    sm = s * free
    b = sm * apply_stencil(A, sm * torch.tensor(
        rng.standard_normal(mesh.shape)))
    m = {k: torch.tensor(v) for k, v in t_mgz.mgz_pack(
        A.numpy(), s.numpy(), free.numpy(), np.float64).items()}
    return dict(A=A, sm=sm, b=b, x0=torch.zeros_like(b),
                F=cuda_cg.rline_pack(A, s, free),
                stack=cuda_cg.pcr_pack(A, s, free), mgz=m)


ENTRIES = {
    "cg_tol": lambda t, F: cuda_cg.cg_tol(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=F),
    "cg_tol_reference": lambda t, F: cuda_cg.cg_tol_reference(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=F),
    "cg_vmem_solve": lambda t, F: cuda_cg.cg_vmem_solve(
        t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=F),
    "precond": lambda t, F: cuda_cg.precond(t["sm"], t["b"], F),
    "update_precond": lambda t, F: cuda_cg.update_precond(
        t["x0"], t["b"], t["b"], t["b"], t["sm"], F,
        state=dict(alpha=0.1, rz=1.0, rr=1.0, stop2=0.0, beta=0.0, k=0,
                   done=0)),
    "mgz_pre": lambda t, F: cuda_cg.mgz_pre(t["b"], F, 0.8),
    "mgz_coarse": lambda t, F: cuda_cg.mgz_coarse(
        t["A"], t["sm"], t["b"], t["b"], t["mgz"]["aux"], F, 0.8),
    "precond_apply[mgz pcrc]": lambda t, F: cuda_cg.precond_apply(
        t["A"], t["sm"], t["b"], pcr=t["F"], mgz=dict(t["mgz"], pcrc=F)),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_a_folded_stack_as_the_rline_operand_raises(tiny, entry):
    """A folded PCR stack where an entry point takes the r-line factors
    raises, rather than being read as factors; the factors themselves
    run."""
    with pytest.raises(ValueError, match="Thomas factors"):
        ENTRIES[entry](tiny, tiny["stack"])
    ENTRIES[entry](tiny, tiny["F"] if "pcrc" not in entry
                   else tiny["mgz"]["pcrc"])


# ----------------------------------------------------------------------
# the kernels on the card
# ----------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.fixture(scope="module")
def card_flagship(flagship):
    """The flagship operator in float32 on the card, seeded fields, the
    plain float32 factors (the kernels' yardstick), the mgz operands and
    the first step's refinement system (``chip_smoke.first_step_system``:
    the unit-norm float64 residual at the warm-start seed, in float32)."""
    import chip_smoke
    dev = _cuda()
    A, s, free = (t.float().to(dev).contiguous() for t in flagship[7])
    rng = np.random.default_rng(7)
    field = lambda: (torch.tensor(rng.standard_normal(tuple(s.shape)),
                                  dtype=torch.float32, device=dev)
                     * free).contiguous()
    mgz = {k: torch.tensor(v, device=dev).contiguous()
           for k, v in t_mgz.mgz_pack(*(t.numpy() for t in flagship[7])
                                      ).items()}
    b = chip_smoke.first_step_system(flagship["problem"], dev)[-1]
    return dict(A=A, s=s, free=free, sm=(s * free).contiguous(),
                F_plain=cuda_cg.rline_pack_reference(A, s, free),
                fields=[field() for _ in range(4)], mgz=mgz, b=b)


@pytest.mark.cuda
def test_cuda_factor_kernel_matches_plain(card_flagship):
    """The factor kernel on the flagship's float32 operator against the
    plain factors: the same float32 couplings and the same float64 sweep,
    each product and difference rounded alone, so equal to a float32
    rounding (1e-6 of each plane's largest value), one launch."""
    g = card_flagship
    cuda_cg.reset_counters()
    F = cuda_cg.rline_pack(g["A"], g["s"], g["free"])
    assert cuda_cg.rline_pack.launches == 1
    assert F.shape == g["F_plain"].shape and F.dtype == torch.float32
    for k in range(3):
        assert _rel(F[k], g["F_plain"][k]) <= 1e-6, k


# The row kernel against its plain version: the kernel composes each
# thread's chunk of a row and scans the chunks, the plain version sweeps
# the row in sequence, so float32 rounds in another order; the multipliers
# and cp are below 1 in magnitude, so the difference does not grow along
# the row: within 1e-5 of the largest value. Where the row is a residual
# (the mgz coarse rows, from the pre-smoothed iterate), its cancellation
# amplifies that rounding whatever the implementation, as chip_smoke.py's
# phase 14a holds the same passes: the kernel within 1.5 times, and of the
# plain version within 2 times, the plain float32 version's own distance
# from the plain version in float64 on the same inputs, when that is
# larger.
ROW_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "update", "restrict",
                                  "coarse_res"])
def test_cuda_row_kernel_modes_match_plain(card_flagship, mode):
    """k_row_plain (the r-line preconditioner alone), k_row_update (the
    fused CG update and line solve), k_row_restrict and k_row_coarse_res
    (the mgz coarse rows, on the flagship's mgz operands) against their
    plain versions, within ROW_TOL (the coarse rows: see above)."""
    g = card_flagship
    F = cuda_cg.rline_pack(g["A"], g["s"], g["free"])
    x, r, p, q = g["fields"]
    tol = ROW_TOL
    if mode == "plain":
        got = cuda_cg.precond(g["sm"], r, F)
        want = cuda_cg.precond_reference(g["sm"], r, F)
    elif mode == "update":
        Ap = cuda_cg.stencil_dot_reference(g["A"], g["sm"], p)[0]
        st = dict(rz=0.73, rr=0.5, stop2=1e-12, alpha=0.0137, beta=0.0, k=3,
                  done=0)
        got = cuda_cg.update_precond(x, r, p, Ap.contiguous(), g["sm"], F,
                                     state=st)[:5]
        want = cuda_cg.update_precond_reference(x, r, p, Ap, st["alpha"],
                                                g["sm"], F)
    else:
        m = g["mgz"]
        z = (0.8 * thomas_apply_lines(F, r)).contiguous()
        args = (g["A"], g["sm"], r, z, m["aux"], m["pcrc"], 0.8)
        d64 = lambda ts: [t.double() if torch.is_tensor(t) else t
                          for t in ts]
        if mode == "restrict":
            got = cuda_cg.mgz_coarse(*args)
            want = cuda_cg.mgz_coarse_reference(*args)
            truth = cuda_cg.mgz_coarse_reference(*d64(args))
        else:
            yc, rcs = (v.contiguous()
                       for v in cuda_cg.mgz_coarse_reference(*args))
            cargs = (m["Ac9"], rcs, yc, m["pcrc"], 0.8)
            got = (cuda_cg.mgz_coarse_res(*cargs),)
            want = (cuda_cg.mgz_coarse_res_reference(*cargs),)
            truth = (cuda_cg.mgz_coarse_res_reference(*d64(cargs)),)
        floor = max(_rel(a, b) for a, b in zip(want, truth, strict=True))
        for a, b in zip(got, truth, strict=True):
            assert _rel(a, b) <= max(ROW_TOL, 1.5 * floor), \
                (mode, _rel(a, b), floor)
        tol = max(ROW_TOL, 2.0 * floor)
    for a, b in zip(got, want, strict=True):
        assert _rel(a, b) <= tol, (mode, _rel(a, b), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rline", "adi"])
def test_cuda_flagship_first_step_solve_counts_match_plain(card_flagship,
                                                           form):
    """The flagship's first-step refinement system by the r-line and ADI
    forms at rtol 1e-5 wrt ||b||: the kernel's iteration count within 2 of
    the plain version's, its solution within 1e-3 (rel-L2)."""
    g = card_flagship
    F = cuda_cg.rline_pack(g["A"], g["s"], g["free"])
    stacks = dict(pcr=F)
    if form == "adi":
        stacks["pcr_z"] = cuda_cg.pcr_pack(g["A"], g["s"], g["free"],
                                           axis=-2).contiguous()
    b = g["b"]
    x0 = torch.zeros_like(b)
    kw = dict(maxiter=20000, rtol_wrt="b", **stacks)
    xk, ik = cuda_cg.cg_tol(g["A"], g["sm"], b, x0, 1e-5, **kw)
    xp, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], b, x0, 1e-5, **kw)
    assert abs(int(ik) - int(ip)) <= 2, (int(ik), int(ip))
    rel = float(torch.linalg.vector_norm((xk - xp).double())
                / torch.linalg.vector_norm(xp.double()))
    assert rel <= 1e-3, rel

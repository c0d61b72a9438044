"""The single-problem PCG's fused phases, its scalar tails and its solve
workspaces: the plain versions against the plain phases they fuse and
against the JAX package's Pallas kernel in interpret mode (float64, on the
CPU); the CUDA kernels against the plain versions where a card is present.
"""

import math

import numpy as np
import pytest
import torch

from heatflow_tpu.ops.pallas_cg import cg_vmem_tol
from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.ops.stencil import apply_stencil
from tests.test_torch_cg_kernel import system  # noqa: F401  (fixture)

torch.set_num_threads(1)

# exactly representable in float32, as the kernel holds rtol
RTOL = 2.0 ** -36


def _stacks(d, form):
    return {"rline": (d["pcr"], None), "adi": (d["pcr"], d["pcr_z"])}[form]


def _fields(t, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(t["b"].shape)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype)
            * (t["sm"] != 0).to(dtype) for _ in range(3)]


def _operator(t, planes: int):
    """The system's 7-plane operator, or a 9-plane one: the same planes and
    two couplings along the diagonals (offsets (1, -1) and (-1, 1))."""
    if planes == 7:
        return t["A"]
    rng = np.random.default_rng(planes)
    diag = torch.tensor(0.1 * rng.standard_normal((2, *t["A"].shape[1:])),
                        dtype=t["A"].dtype)
    return torch.cat([t["A"], diag * (t["sm"] != 0).to(diag.dtype)])


@pytest.mark.parametrize("planes", [7, 9])
@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_stencil_phase_plain_is_the_p_update_then_the_stencil(
        system, planes, first, dtype):
    """The stencil phase's plain version with the direction folded in,
    against p = z + beta p followed by the plain stencil-and-dot phase: p,
    Ap and <p, Ap> bitwise; on a solve's first iteration p = z, and the
    last p (NaN here) is not read; the wrapper's CPU branch is the same
    phase with the alpha tail on its state."""
    _, t, _ = system
    A, sm = _operator(t, planes).to(dtype), t["sm"].to(dtype)
    z, p, _ = _fields(t, dtype, 17)
    beta = 0.6180339887
    if first:
        p = torch.full_like(p, math.nan)
        p_c = z
    else:
        p_c = z + torch.tensor(beta, dtype=torch.float64).to(dtype) * p
    got = cuda_cg.stencil_dot_p_reference(A, sm, z, p, beta, first)
    want = (p_c, *cuda_cg.stencil_dot_reference(A, sm, p_c))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(torch.isfinite(got[0]).all())
    st = dict(rz=0.9, rr=1.0, stop2=1e-12, alpha=0.0, beta=beta,
              k=0 if first else 5, done=0)
    p_n, Ap, pap, st_n = cuda_cg.stencil_dot_p(A, sm, z, p, st)
    assert torch.equal(p_n, got[0]) and torch.equal(Ap, got[1])
    assert torch.equal(pap, got[2])
    assert st_n == cuda_cg.finalize_reference(st, "alpha", pap=pap)


def test_check_every_is_even():
    """An iteration's slot in the solve graph's loop body gives the parity
    of its count, which picks its plane of p: the body's length is even."""
    assert cuda_cg.CHECK_EVERY >= 2 and cuda_cg.CHECK_EVERY % 2 == 0


@pytest.mark.parametrize("form", ["rline", "adi"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_phase_plain_is_the_composition_of_the_plain_phases(
        system, form, dtype):
    """The fused row phase's plain version against the update followed by
    the plain PCR phase: the fields bitwise in float64 (within 1e-6 in
    float32), the row-wise sums within 1e-12 (1e-6) of the plain sums."""
    _, t, _ = system
    A, sm = t["A"].to(dtype), t["sm"].to(dtype)
    pcr, pcr_z = (None if v is None else v.to(dtype)
                  for v in _stacks(t, form))
    x, r, p = _fields(t, dtype, 11)
    Ap = sm * apply_stencil(A, sm * p)
    alpha = 0.0421
    got = cuda_cg.update_precond_reference(x, r, p, Ap, alpha, sm, pcr,
                                           pcr_z)
    a = torch.tensor(alpha, dtype=dtype)
    x_c, r_c = x + a * p, r - a * Ap
    z_c, rz_c = cuda_cg.precond_reference(sm, r_c, pcr, pcr_z)
    rr_c = (r_c.double() * r_c.double()).sum()
    want = (x_c, r_c, z_c, rr_c, rz_c)
    tol = 0.0 if dtype == torch.float64 else 1e-6
    for g, w in zip(got[:3], want[:3]):
        assert float((g - w).abs().max()) <= tol * float(w.abs().max())
    stol = 1e-12 if dtype == torch.float64 else 1e-6
    for g, w in zip(got[3:], want[3:]):
        assert abs(float(g) - float(w)) <= stol * abs(float(w))


def test_tail_scalars_follow_the_finalize_rules():
    """The tails' scalar steps: the stop target, pAp == 0 -> 1, rz == 0 ->
    1, rr by the form, the count, the stop rule with a NaN and ``fixed``,
    and a done state left alone."""
    fin = cuda_cg.finalize_reference
    rt = float(np.float32(1e-3))
    st = fin({}, "init", rr=4.0, rz=2.0, bb=9.0, rtol=1e-3, maxiter=5)
    assert st == dict(rz=2.0, rr=4.0, alpha=0.0, beta=0.0, k=0, done=0,
                      stop2=rt * rt * 4.0)
    assert fin({}, "init", rr=4.0, rz=2.0, bb=9.0, rtol=1e-3,
               rtol_wrt="b")["stop2"] == rt * rt * 9.0
    assert fin({}, "init", rr=4.0, rtol=1e-3, maxiter=0)["done"] == 1
    assert fin(st, "alpha", pap=0.5)["alpha"] == 4.0
    assert fin(st, "alpha", pap=0.0)["alpha"] == 2.0      # pAp == 0 -> 1
    nxt = fin(st, "beta", rr=1.0, rz=0.5, maxiter=5)
    assert nxt["beta"] == 0.25 and nxt["rz"] == 0.5 and nxt["rr"] == 1.0
    assert nxt["k"] == 1 and nxt["done"] == 0
    # the identity form: rr is <r, z> = <r, r>
    assert fin(st, "beta", rr=1.0, rz=0.5, preconditioned=False)["rr"] == 0.5
    # rz == 0 -> 1
    assert fin(dict(st, rz=0.0), "beta", rr=1.0, rz=0.5)["beta"] == 0.5
    # below the target: stop, unless fixed
    low = fin(st, "beta", rr=1e-9, rz=1e-9, maxiter=5)
    assert low["done"] == 1
    assert fin(st, "beta", rr=1e-9, rz=1e-9, maxiter=5, fixed=True)[
        "done"] == 0
    assert fin(dict(st, k=4), "beta", rr=1e-9, rz=1e-9, maxiter=5,
               fixed=True)["done"] == 1
    # a NaN residual stops the loop; a done state is left as it is
    assert fin(st, "beta", rr=math.nan, rz=1.0)["done"] == 1
    assert fin(low, "beta", rr=7.0, rz=7.0) == low
    assert fin(low, "alpha", pap=3.0) == low
    with pytest.raises(ValueError, match="mode"):
        fin(st, "gamma")


def _phase_solve(t, form, rtol, maxiter, rtol_wrt):
    """The standard loop as the kernels run it, through the plain versions
    of its phases: the start, then an iteration of k_stencil_dot, which
    forms p = z + beta p (z on the first iteration) with the alpha tail,
    and the fused row (and z-line) phase with the beta tail; x is NaN when
    the residual is not finite."""
    A, sm, b, x = t["A"], t["sm"], t["b"], t["x0"]
    pcr, pcr_z = _stacks(t, form)
    r = b - sm * apply_stencil(A, sm * x)
    z, rz = cuda_cg.precond_reference(sm, r, pcr, pcr_z)
    st = cuda_cg.finalize_reference(
        {}, "init", rr=(r * r).sum(), rz=rz, bb=(b * b).sum(), rtol=rtol,
        maxiter=maxiter, rtol_wrt=rtol_wrt)
    p = torch.full_like(z, math.nan)   # not read on the first iteration
    while not st["done"]:
        p, Ap, _, st = cuda_cg.stencil_dot_p(A, sm, z, p, st)
        x, r, z, _, _, st = cuda_cg.update_precond(x, r, p, Ap, sm, pcr,
                                                   pcr_z, state=st,
                                                   maxiter=maxiter)
    if not math.isfinite(st["rr"]):
        x = torch.full_like(x, math.nan)
    return x, st["k"]


@pytest.mark.parametrize("form", ["rline", "adi"])
@pytest.mark.parametrize("rtol_wrt", ["r0", "b"])
def test_phase_solve_matches_pallas_interpret(system, form, rtol_wrt):
    """The whole r-line and ADI solve through the plain versions of the
    redesigned phases and tails against the Pallas kernel in interpret
    mode, float64: the same iteration count, x within 1e-10."""
    j, t, x_true = system
    xj, ij = cg_vmem_tol(j["A"], j["sm"], j["b"], j["x0"], RTOL,
                         maxiter=20000, rtol_wrt=rtol_wrt, interpret=True,
                         merged=False, pcr=j["pcr"],
                         pcr_z=j["pcr_z"] if form == "adi" else None)
    xt, it = _phase_solve(t, form, RTOL, 20000, rtol_wrt)
    assert it == int(ij), (it, int(ij))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert np.abs(xt.numpy() - x_true).max() <= 1e-8 * np.abs(x_true).max()


def test_phase_solve_poisons_and_caps_like_the_plain_solve(system):
    """A NaN right-hand side poisons x at zero iterations; maxiter caps the
    count; both as ``cg_tol_reference``."""
    _, t, _ = system
    bad = dict(t, b=t["b"].clone())
    bad["b"][3, 4] = math.nan
    x, k = _phase_solve(bad, "rline", RTOL, 100, "r0")
    assert torch.isnan(x).all() and k == 0
    x, k = _phase_solve(t, "adi", 1e-14, 7, "r0")
    xr, kr = cuda_cg.cg_tol_reference(t["A"], t["sm"], t["b"], t["x0"],
                                      1e-14, maxiter=7, pcr=t["pcr"],
                                      pcr_z=t["pcr_z"])
    assert k == int(kr) == 7
    assert float((x - xr).abs().max()) <= 1e-12 * float(xr.abs().max())


class _Lib:
    """The one library call a workspace makes."""

    @staticmethod
    def hf_cg_nparts(nz, nr):
        return max((nz * nr + 255) // 256, nz, nr)


def test_workspaces_are_kept_per_shape_form_and_device(monkeypatch):
    """A workspace is reused for an equal shape, form and device, made anew
    for another shape or form, and never shared between devices."""
    monkeypatch.setattr(cuda_cg, "_workspaces", {})
    cpu, meta = torch.device("cpu"), torch.device("meta")
    rline = (True, False, 0, False, False, False)
    adi = (True, True, 0, False, False, False)
    ws = cuda_cg._workspace(_Lib, cpu, 5, 7, rline, 0, "rline")
    assert cuda_cg._workspace(_Lib, cpu, 5, 7, rline, 0, "rline") is ws
    assert ws.b.shape == ws.x.shape == (5, 7) and ws.vecs.shape == (5, 5, 7)
    assert ws.parts.shape == (4, 7) and ws.parts.dtype == torch.float64
    assert ws.extra is None and not ws.graphs
    other = [cuda_cg._workspace(_Lib, cpu, 5, 9, rline, 0, "rline"),
             cuda_cg._workspace(_Lib, cpu, 5, 7, adi, 0, "adi"),
             cuda_cg._workspace(_Lib, meta, 5, 7, rline, 0, "rline")]
    assert all(o is not ws for o in other)
    assert other[2].b.device == meta and ws.b.device == cpu
    assert len(cuda_cg._workspaces) == 4
    with_extra = cuda_cg._workspace(_Lib, cpu, 5, 7, (True,) * 6, 4, "mgz")
    assert with_extra.extra.shape == (4, 5, 7)


def test_plain_entry_points_make_no_workspace(system, monkeypatch):
    """CPU tensors take the plain versions: no workspace, no graph."""
    monkeypatch.setattr(cuda_cg, "_workspaces", {})
    _, t, _ = system
    cuda_cg.cg_tol(t["A"], t["sm"], t["b"], t["x0"], 1e-6, pcr=t["pcr"])
    assert cuda_cg._workspaces == {}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rline", "adi"])
def test_cuda_fused_phases_and_tails_match_plain(system, form):
    """On the card: k_stencil_dot with its alpha tail, the fused row (and
    z-line) phase with its beta tail, against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = system
    dev = torch.device("cuda")
    g = {k: v.to(dev, torch.float32).contiguous() for k, v in t.items()}
    pcr, pcr_z = _stacks(g, form)
    x, r, p0 = (f.to(dev).contiguous() for f in _fields(t, torch.float32, 5))
    z = _fields(t, torch.float32, 6)[0].to(dev).contiguous()
    x_in, r_in = x.clone(), r.clone()
    st0 = dict(rz=0.9, rr=1.0, stop2=1e-12, alpha=0.0, beta=0.3, k=2,
               done=0)
    p, Ap, pap, st = cuda_cg.stencil_dot_p(g["A"], g["sm"], z, p0, st0)
    p_p, Ap_p, pap_p = cuda_cg.stencil_dot_p_reference(g["A"], g["sm"], z,
                                                       p0, 0.3, False)
    assert float((p - p_p).abs().max()) <= 1e-6 * float(p_p.abs().max())
    assert float((Ap - Ap_p).abs().max()) <= 1e-5 * float(Ap_p.abs().max())
    assert st["alpha"] == pytest.approx(0.9 / float(pap_p), rel=1e-5)
    out = cuda_cg.update_precond(x, r, p, Ap, g["sm"], pcr, pcr_z, state=st)
    want = cuda_cg.update_precond_reference(x, r, p, Ap, st["alpha"],
                                            g["sm"], pcr, pcr_z)
    for a, b in zip(out[:3], want[:3]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    for a, b in zip(out[3:5], want[3:5]):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    st_p = cuda_cg.finalize_reference(st, "beta", rr=want[3], rz=want[4])
    assert out[5]["k"] == st_p["k"] == 3 and out[5]["done"] == 0
    assert out[5]["beta"] == pytest.approx(st_p["beta"], rel=1e-5)
    assert float(pap) == pytest.approx(float(pap_p), rel=1e-5)
    # the wrapper leaves its inputs as they are
    assert torch.equal(x, x_in) and torch.equal(r, r_in)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["identity", "rline", "adi"])
def test_cuda_solve_graph_is_reused_and_counted(system, form):
    """A solve is one captured graph, reused by the next solve of the same
    operands; an iteration is 2 launches (3 for ADI), p formed in the
    stencil pass, no p_update launched; the device-counted block runs cover
    the iterations; the counts equal the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = system
    dev = torch.device("cuda")
    g = {k: v.to(dev, torch.float32).contiguous() for k, v in t.items()}
    kw = {"identity": {}, "rline": {"pcr": g["pcr"]},
          "adi": {"pcr": g["pcr"], "pcr_z": g["pcr_z"]}}[form]
    cuda_cg.reset_counters()
    x1, i1 = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                            maxiter=5000, **kw)
    x2, i2 = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                            maxiter=5000, **kw)
    assert torch.equal(x1, x2) and int(i1) == int(i2)
    assert x1.data_ptr() != x2.data_ptr()
    stats = cuda_cg.graph_stats()[form]
    assert stats["graphs"] == 1
    assert stats["launches_per_iteration"] == (3 if form == "adi" else 2)
    counts = cuda_cg.phase_launches()
    k, every = int(i1), cuda_cg.CHECK_EVERY
    assert counts["stencil_dot"] == 2 * every * math.ceil(k / every)
    assert counts["init"] == counts["finish"] == 2
    assert counts["p_update"] == 0
    xp, ip = cuda_cg.cg_tol_reference(g["A"], g["sm"], g["b"], g["x0"], 1e-5,
                                      maxiter=5000, **kw)
    assert abs(k - int(ip)) <= max(3, int(0.05 * int(ip)))
    assert float((x1 - xp).abs().max() / xp.abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [7, 9])
@pytest.mark.parametrize("first", [True, False])
def test_cuda_fused_stencil_phase_matches_plain(system, planes, first):
    """On the card, on the 7- and a 9-plane operator: k_stencil_dot forming
    p = z + beta p (p = z at the state's count 0, the last p unread: NaN
    here) with its alpha tail, against its plain version; its Ap and
    <p, Ap> bitwise those of the pass over the p it wrote."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = system
    dev = torch.device("cuda")
    A = _operator(t, planes).to(dev, torch.float32).contiguous()
    sm = t["sm"].to(dev, torch.float32).contiguous()
    z, p, _ = (f.to(dev).contiguous() for f in _fields(t, torch.float32, 9))
    if first:
        p = torch.full_like(p, math.nan)
    st0 = dict(rz=0.7, rr=1.0, stop2=1e-12, alpha=0.0, beta=0.45,
               k=0 if first else 3, done=0)
    got = cuda_cg.stencil_dot_p(A, sm, z, p, st0)
    want = cuda_cg.stencil_dot_p_reference(A, sm, z, p, 0.45, first)
    assert torch.equal(got[0], want[0]) if first else \
        float((got[0] - want[0]).abs().max()) <= 1e-6 * float(
            want[0].abs().max())
    assert float((got[1] - want[1]).abs().max()) <= 1e-5 * float(
        want[1].abs().max())
    assert float(got[2]) == pytest.approx(float(want[2]), rel=1e-5)
    st_p = cuda_cg.finalize_reference(st0, "alpha", pap=want[2])
    assert got[3]["alpha"] == pytest.approx(st_p["alpha"], rel=1e-5)
    assert got[3]["k"] == st0["k"] and got[3]["beta"] == st0["beta"]
    # the pass that forms p is bitwise the pass over the plane of p it
    # wrote
    Ap, pap = cuda_cg.stencil_dot(A, sm, got[0])
    assert torch.equal(got[1], Ap) and float(got[2]) == float(pap)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["identity", "rline", "adi"])
def test_cuda_solve_stops_mid_body_and_at_its_start(system, form):
    """A solve whose tolerance stop falls inside a loop body has the x and
    the count of the same solve stopped there by maxiter (the body's
    remaining slots change nothing, whichever plane of p they would
    write); a solve done at its start returns x0 and 0 iterations and runs
    no body, and the next solve on the same buffers is unchanged by it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, t, _ = system
    dev = torch.device("cuda")
    g = {k: v.to(dev, torch.float32).contiguous() for k, v in t.items()}
    kw = {"identity": {}, "rline": {"pcr": g["pcr"]},
          "adi": {"pcr": g["pcr"], "pcr_z": g["pcr_z"]}}[form]
    every = cuda_cg.CHECK_EVERY
    solve = lambda rtol, maxiter: cuda_cg.cg_tol(
        g["A"], g["sm"], g["b"], g["x0"], rtol, maxiter=maxiter, **kw)
    for rtol in (1e-5, 2e-5, 5e-5, 1e-4, 3e-4):
        x_a, k_a = solve(rtol, 5000)
        if int(k_a) % every:
            break
    k = int(k_a)
    assert k % every and 0 < k < 5000, k
    x_b, k_b = solve(0.0, k)
    assert int(k_b) == k and torch.equal(x_a, x_b)
    cuda_cg.reset_counters()
    x_0, k_0 = cuda_cg.cg_tol(g["A"], g["sm"], g["b"], g["x0"], 10.0,
                              maxiter=5000, rtol_wrt="b", **kw)
    assert int(k_0) == 0 and torch.equal(x_0, g["x0"])
    counts = cuda_cg.phase_launches()
    assert counts["stencil_dot"] == counts["p_update"] == 0
    assert counts["init"] == counts["finish"] == 1
    x_c, k_c = solve(rtol, 5000)
    assert int(k_c) == k and torch.equal(x_c, x_a)

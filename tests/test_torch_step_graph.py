"""The structured transient's kernel path as one device program
(``heatflow_tpu_torch/ops/cuda_step.py``, ``csrc/step.cu``).

(a) each plain step function against the eager expressions it replaced,
bitwise in float64 and float32; (b) the per-run heating amplitudes against
the per-step interpolation, bitwise; (c) the restructured eager loop against
the JAX ``make_simulate_fn`` (the kernel forms through the plain versions
against the JAX kernel in interpret mode, the float64 eager forms to 1e-8
rel-L2); (e) the graph path's checks of the inner solve's operands, and
each step kernel's wrapper on a CPU workspace (its plain version); (d) on
the card, the graph path against the eager loop, and float64 operands
refused (marked ``cuda``; skipped here).
"""

import math
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu_torch.ops import cuda_step
from heatflow_tpu_torch.ops.cg import refine_inner_scale, refine_inner_seed
from heatflow_tpu_torch.ops.stencil import apply_stencil
from heatflow_tpu_torch.sim.stepper import interp
from heatflow_tpu_torch.sim.stepper import make_simulate_fn as t_make
from tests.test_torch_stepper import (_dac_pair, _interp_tol, _tiny_pair,
                                      j_make, rel_l2)

torch.set_num_threads(1)

WARM = ("previous", "extrapolate", "extrapolate2")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _planes(dtype, seed=0, n=6, shape=(20, 72)):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.uniform(-2.0, 3.0, shape), dtype=dtype)
            for _ in range(n)]


def _stencil(dtype, seed=1, shape=(20, 72)):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 0.0, (7,) + shape)
    A[0] = rng.uniform(4.0, 6.0, shape)
    return torch.as_tensor(A, dtype=dtype)


def _free(dtype, shape=(20, 72)):
    free = np.ones(shape)
    free[0], free[:, -1] = 0.0, 0.0
    return torch.as_tensor(free, dtype=dtype)


# ----------------------------------------------------------------------
# (a) the plain step functions against the expressions they replaced
# ----------------------------------------------------------------------

@pytest.mark.parametrize("source", [False, True], ids=["nosrc", "src"])
@pytest.mark.parametrize("warm", WARM)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prologue_is_the_eager_expressions(dtype, warm, source):
    dt = DTYPES[dtype]
    M_op = _stencil(dt)
    u_prev, u_pp, u_ppp, Ag0, Ag1, src = _planes(dt)
    free = _free(dt)
    s = torch.rsqrt(M_op[0]) * free + (1 - free)
    s[3, 4] = 0.0                     # a guarded divisor
    amp = torch.tensor(812.5, dtype=dt)
    b_src = src if source else 0.0
    b_lift, y0 = cuda_step.step_prologue_reference(
        apply_stencil, M_op, u_prev, u_pp, u_ppp, b_src, Ag0, Ag1, amp, s,
        free, warm)
    # the eager loop's own lines
    b = apply_stencil(M_op, u_prev) + b_src
    want_lift = (b - (Ag0 + amp * Ag1)) * s
    if warm == "extrapolate2":
        u_seed = 3.0 * (u_prev - u_pp) + u_ppp
    else:
        u_seed = 2.0 * u_prev - u_pp if warm == "extrapolate" else u_prev
    want_y0 = (u_seed / torch.where(s > 0, s, torch.ones_like(s))) * free
    assert torch.equal(b_lift, want_lift)
    assert torch.equal(y0, want_y0)


@pytest.mark.parametrize("case", ["first", "second", "degenerate"])
def test_refine_residual_is_the_eager_expressions(case):
    dt = torch.float64
    A = _stencil(dt)
    free = _free(dt)
    s = torch.rsqrt(A[0]) * free + (1 - free)
    bt, y = _planes(dt, n=2)
    bt = bt * free
    floor2 = 1e-30 * torch.sum(bt * bt)
    if case == "degenerate":
        floor2 = torch.tensor(1e300, dtype=dt)
    dy = rn = None
    if case == "second":
        dy = _planes(torch.float32, seed=5, n=1)[0]
        rn = torch.tensor(3.25e-3, dtype=dt)
    y_out, r64, rnorm, rtol_eff = cuda_step.refine_residual_reference(
        apply_stencil, A, s, free, bt, y, floor2, 1e-5, torch.float32, dy,
        rn)
    want_y = y if dy is None else y + dy.to(dt) * rn
    apply_A_s = lambda v: s * apply_stencil(A, s * v)
    want_r = bt - free * apply_A_s(want_y)
    want_rn, want_rt = refine_inner_scale(torch.sum(want_r * want_r), floor2,
                                          1e-5, torch.float32)
    assert torch.equal(y_out, want_y) and torch.equal(r64, want_r)
    assert torch.equal(rnorm, want_rn) and torch.equal(rtol_eff, want_rt)
    assert float(rtol_eff) == (2.0 if case == "degenerate"
                               else float(np.float32(1e-5)))


@pytest.mark.parametrize("case", ["zero", "carry", "carry_degenerate"])
def test_refine_scale_is_the_eager_expressions(case):
    r64 = _planes(torch.float64, n=1)[0]
    rnorm = torch.tensor(7.5, dtype=torch.float64)
    rtol_eff = torch.tensor(2.0 if case == "carry_degenerate" else 1e-5,
                            dtype=torch.float32)
    dy = None if case == "zero" else _planes(torch.float32, seed=3, n=1)[0]
    r32, seed = cuda_step.refine_scale_reference(r64, rnorm, rtol_eff,
                                                 torch.float32, dy)
    assert torch.equal(r32, (r64 / rnorm).to(torch.float32))
    want = torch.zeros(r64.shape, dtype=torch.float32) if dy is None \
        else refine_inner_seed(dy, rtol_eff).contiguous()
    assert torch.equal(seed, want)
    assert seed.abs().sum() == 0 if case != "carry" else seed.abs().sum() > 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_epilogue_is_the_eager_expressions(dtype):
    dt = DTYPES[dtype]
    x, s, g0, g1 = _planes(dt, n=4)
    free = _free(dt)
    amp = torch.tensor(-41.75, dtype=dt)
    dy = rn = None
    if dt == torch.float64:       # the refined path adds the last correction
        dy = _planes(torch.float32, seed=9, n=1)[0]
        rn = torch.tensor(0.125, dtype=dt)
    u = cuda_step.step_epilogue_reference(x, s, free, g0, g1, amp, dy, rn)
    xx = x if dy is None else x + dy.to(dt) * rn
    g = g0 + amp * g1
    assert torch.equal(u, xx * s * free + g)


def _kernel_sum_literal(v: np.ndarray) -> float:
    """The step kernels' sum written out as the kernels run it: each block
    of 256 threads a warp shuffle tree and the warps in turn, then thread t
    of the last block adds partials t, t + 256, ... and the block sums
    those."""
    def block(vals):
        lanes = vals.reshape(8, 32).copy()
        for o in (16, 8, 4, 2, 1):
            lanes = np.concatenate([lanes[:, :32 - o] + lanes[:, o:],
                                    lanes[:, 32 - o:]], axis=1)
        s = 0.0
        for w in range(8):
            s += lanes[w, 0]
        return s
    nb = -(-len(v) // 256)
    vals = np.zeros(nb * 256)
    vals[:len(v)] = v
    parts = [block(vals[b * 256:(b + 1) * 256]) for b in range(nb)]
    acc = np.zeros(256)
    for t in range(256):
        s = 0.0
        for i in range(t, nb, 256):
            s += parts[i]
        acc[t] = s
    return block(acc)


@pytest.mark.parametrize("n", [1, 1000, 70001], ids=["one", "blocks",
                                                     "strided"])
def test_kernel_order_sum_is_the_kernels_order(n):
    """The plain replica of the step kernels' fixed-order sum against the
    kernels' algorithm written out lane by lane, bitwise (70001 values: 274
    blocks, so the last block's threads add partials in strides)."""
    v = np.random.default_rng(n).uniform(0.0, 1.0, n) ** 3
    got = cuda_step.kernel_order_sum(torch.as_tensor(v))
    assert float(got) == _kernel_sum_literal(v)
    assert abs(float(got) - v.sum()) <= 1e-12 * v.sum()


# ----------------------------------------------------------------------
# (b) the heating amplitudes of a run
# ----------------------------------------------------------------------

@pytest.mark.parametrize("t0", [0.0, 3.3e-7, 1.0], ids=["t0", "mid", "late"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_amps_are_the_per_step_interpolation(dtype, t0):
    _, pt = _dac_pair(num_steps=12)
    fn = t_make(pt, dtype=DTYPES[dtype], record_gradient=False, device="cpu")
    d, kp, rc, fw, ic, _, t0_, _ = fn._inputs(None, None, None, None, t0,
                                              None)
    *_, ts, amps = fn._operands(d, kp, rc, fw, ic, t0_, None)
    offset = d["heat_T"][0] - ic
    per_step = torch.stack([interp(ts[n], d["heat_t"], d["heat_T"]) - offset
                            for n in range(len(ts))])
    assert amps.dtype == DTYPES[dtype] and torch.equal(amps, per_step)


# ----------------------------------------------------------------------
# (c) the restructured loop against the JAX stepper
# ----------------------------------------------------------------------

STEPS = 4


@pytest.fixture(scope="module")
def dac():
    pj, pt = _dac_pair(num_steps=STEPS)
    truth = np.asarray(j_make(pj, rtol=1e-11, record_gradient=False)()
                       ["watch"])
    return pj, pt, truth


@pytest.mark.parametrize("warm", WARM)
@pytest.mark.parametrize("refine", [0, 1], ids=["f32", "refined"])
@pytest.mark.parametrize("precondition", ["rline", "adi", "adaptive"])
def test_kernel_path_loop_matches_jax(dac, precondition, refine, warm):
    """solver='vmem' in float32 through the plain versions against the JAX
    stepper with its kernel in interpret mode, with the tolerances of
    tests/test_torch_stepper.py::test_kernel_forms_match_jax_stepper: the
    refined traces (float64 state) within 2e-4 of the range of the JAX
    trace, the unrefined ones held to the float64 truth (within 1.5x the JAX
    trace's error + 0.1 K: float32 traces carry a rounding floor); counts
    within 2 + 10 % a step."""
    pj, pt, truth = dac
    kw = dict(precondition=precondition, f64_refine=refine, warm_start=warm,
              rtol=1e-5, solver="vmem", record_gradient=False, maxiter=4000)
    with mock.patch("heatflow_tpu.ops.pallas_cg.cg_vmem_tol", _interp_tol):
        yj = j_make(pj, dtype=jnp.float32, **kw)()
    yt = t_make(pt, dtype=torch.float32, **kw, device="cpu")()
    wj, wt = np.asarray(yj["watch"]), yt["watch"].numpy()
    assert np.isfinite(wt).all()
    if refine:
        assert np.abs(wt - wj).max() <= 2e-4 * (wj.max() - wj.min())
    else:
        err_j, err_t = np.abs(wj - truth).max(), np.abs(wt - truth).max()
        assert err_t <= 1.5 * err_j + 0.1, (err_t, err_j)
    ij, it = np.asarray(yj["cg_iters"]), yt["cg_iters"].numpy()
    assert (np.abs(it.astype(int) - ij.astype(int))
            <= 2 + 0.1 * ij).all(), (it, ij)


@pytest.mark.parametrize("warm", WARM)
@pytest.mark.parametrize("precondition", ["rline", "adi"])
def test_f64_eager_loop_matches_jax(precondition, warm):
    """The float64 eager forms on the problem of
    tests/test_torch_stepper.py::test_f64_line_preconditioned_paths_match_jax
    (gradient recorded): the same recurrences in both packages, so the
    traces agree to 1e-8 rel-L2 (summation order only) and the counts
    exactly."""
    pj, pt = _tiny_pair()
    kw = dict(precondition=precondition, warm_start=warm, rtol=1e-12,
              record_gradient=True)
    yj = j_make(pj, **kw)()
    yt = t_make(pt, **kw, device="cpu")()
    for name in ("watch", "band", "axis", "final_u"):
        assert rel_l2(yt[name].numpy(), yj[name]) < 1e-8, name
    np.testing.assert_array_equal(yt["cg_iters"].numpy(), yj["cg_iters"])


# ----------------------------------------------------------------------
# (e) the graph path's operand checks and the step wrappers on the CPU
# ----------------------------------------------------------------------

CHECK_CASES = {
    # the inner solve in float64: cg_tol's kernels take float32 only
    "f64_rline": (dict(dtype=torch.float64, precondition="rline"),
                  TypeError, "must be float32"),
    "f64_adaptive": (dict(dtype=torch.float64, precondition="adaptive"),
                     TypeError, "must be float32"),
    "rline_cheb": (dict(precondition="rline", vmem_cheb_degree=2),
                   ValueError, "mutually exclusive"),
    "mgz_no_sweeps": (dict(precondition="mgz", mgz_sweeps=0), ValueError,
                      "mgz_sweeps"),
    "mgz_merged": (dict(precondition="mgz"), ValueError,
                   "mutually exclusive"),
    "rtol_wrt": (dict(precondition="adi"), ValueError, "rtol_wrt"),
}


def _vmem(pt, **kw):
    kw = {"dtype": torch.float32, **kw}
    return t_make(pt, solver="vmem", rtol=1e-5, record_gradient=False,
                  maxiter=4000, device="cpu", **kw)


@pytest.mark.parametrize("name", list(CHECK_CASES))
def test_graph_workspace_runs_the_solve_checks(name, monkeypatch):
    """The graph path's workspace holds the inner solve's form and
    operands to ``cg_tol``'s checks before it is made: float64 operands
    raise the wrapper's TypeError, forms that do not compose its
    ValueError."""
    from heatflow_tpu_torch.ops import cuda_cg
    _, pt = _dac_pair(num_steps=2)
    kw, err, match = CHECK_CASES[name]
    if name == "mgz_merged":
        monkeypatch.setattr(cuda_cg, "MERGED_DEFAULT", True)
    fn = _vmem(pt, **kw)
    if name == "rtol_wrt":
        fn.opts["rtol_wrt"] = "x"
    with pytest.raises(err, match=match):
        fn._step_workspace(*fn._inputs(None, None, None, None, 0.0, None))
    assert not fn._workspaces


@pytest.mark.parametrize("refine", [0, 1, 2], ids=["f32", "one", "two"])
def test_step_wrappers_on_cpu_run_the_plain_versions(refine):
    """Each step kernel's wrapper on a CPU workspace runs its plain version
    on the workspace's planes for the step the state holds: the first step
    of the adaptive form (its solves on ADI, counted by form), with the
    inner solves' outputs stood in by seeded planes."""
    _, pt = _dac_pair(num_steps=3)
    fn = _vmem(pt, precondition="adaptive", f64_refine=refine,
               inner_seed="carry" if refine == 2 else "zero",
               warm_start="extrapolate")
    ws, _ = fn._step_workspace(*fn._inputs(None, None, None, None, 0.0,
                                           None))
    rng = np.random.default_rng(5)
    ws.ring.copy_(torch.as_tensor(rng.uniform(290, 300, ws.ring.shape)))
    ring = [ws.ring[k].clone() for k in (2, 1, 0)]
    f32 = torch.float32
    cuda_step.step_prologue(ws)
    b_lift, y0 = cuda_step.step_prologue_reference(
        apply_stencil, ws.Mop, *ring, 0.0, ws.Ag0, ws.Ag1, ws.amps[0], ws.s,
        ws.free, "extrapolate")
    bt = b_lift * ws.free
    assert torch.equal(ws.bt, bt.to(ws.bt.dtype))
    assert torch.equal(ws.y[0], y0.to(ws.y.dtype))
    dxs = [torch.as_tensor(rng.uniform(-1, 1, ws.dx[0].shape), dtype=f32)
           for _ in range(ws.passes)]
    y, dy, rn = ws.y[0].clone(), None, None
    floor2 = 1e-30 * torch.sum(bt * bt)
    for p in range(ws.passes if ws.refine else 0):
        cuda_step.refine_residual(ws, p)
        y, r64, rnorm, rtol_eff = cuda_step.refine_residual_reference(
            apply_stencil, ws.A, ws.s, ws.free, bt, y, floor2, ws.rtol, f32,
            dy, rn)
        assert torch.equal(ws.r64, r64) and torch.equal(ws.y[p], y)
        assert torch.equal(ws.state[3 + p], rnorm)
        assert torch.equal(ws.rtol32, rtol_eff)
        carried = ws.dx[p].clone() if ws.carry else None
        cuda_step.refine_scale(ws, p)
        r32, seed = cuda_step.refine_scale_reference(r64, rnorm, rtol_eff,
                                                     f32, carried)
        assert torch.equal(ws.b32, r32) and torch.equal(ws.x0, seed)
        ws.dx[p].copy_(dxs[p])
        ws.iters[p] = 30 + p
        dy, rn = ws.dx[p], rnorm
    if not ws.refine:
        ws.dx[0].copy_(dxs[0])
        ws.iters[0] = 30
    solves = ws.state.view(torch.int64)[5:7].tolist()
    assert solves == [0, ws.passes]           # the first step: ADI
    cuda_step.step_epilogue(ws)
    u = cuda_step.step_epilogue_reference(
        y if ws.refine else dxs[0], ws.s, ws.free, ws.g0, ws.g1,
        ws.amps[0], dy, rn)
    assert torch.equal(ws.ring[0], u)
    assert torch.equal(ws.watch[0], u.reshape(-1)[ws.watch_flat])
    its = sum(30 + p for p in range(ws.passes))
    assert int(ws.cg_iters[0]) == its
    assert ws.step_index() == 1 and int(ws._ints()[1]) == its


# ----------------------------------------------------------------------
# (d) on the card
# ----------------------------------------------------------------------

CARD_CASES = {
    "adaptive_refined": dict(precondition="adaptive", f64_refine=1,
                             warm_start="extrapolate"),
    "adaptive_two_carry": dict(precondition="adaptive", f64_refine=2,
                               inner_seed="carry",
                               warm_start="extrapolate2"),
    "rline_fields_source": dict(precondition="rline", record_fields=True),
    "adi": dict(precondition="adi", warm_start="extrapolate"),
    "cheb3": dict(vmem_cheb_degree=3, warm_start="extrapolate"),
    "mgz_refined": dict(precondition="mgz", f64_refine=1,
                        warm_start="extrapolate"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_graph_path_matches_eager_on_cuda(name):
    """The graph path (one launch for the run) against the eager loop on the
    card. Every kernel gets the eager loop's inputs, so with the
    refinement's two sums taken in the step kernels' order the outputs are
    bitwise equal; with torch.sum's order (the eager loop's own) the last
    bits of each pass's rnorm move the inner solves' stops within their
    tolerance: traces within rtol of their range, iteration totals within
    2 %. The graph is reused by a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from heatflow_tpu_torch.ops import cuda_cg
    _, pt = _dac_pair(num_steps=8)
    kw = CARD_CASES[name]
    fn = t_make(pt, dtype=torch.float32, solver="vmem", rtol=1e-5,
                record_gradient=False, maxiter=4000, device="cuda", **kw)
    rng = np.random.default_rng(6)
    src = rng.uniform(0, 1e12, pt.mesh.shape) \
        if name.endswith("source") else None
    yk = fn.forward_eager(source=src,
                          inner_sum=cuda_step.kernel_order_sum)
    ye = fn.forward_eager(source=src)
    cuda_cg.reset_counters()
    cuda_step.reset_counters()
    yg = fn(source=src)
    yg2 = fn(source=src)
    passes = kw.get("f64_refine", 0)
    assert cuda_cg.cg_tol.launches == 2 * pt.num_steps * max(1, passes)
    # the step kernels' launches as the device counted them
    assert [f.launches for f in cuda_step._KERNELS] == [
        2 * pt.num_steps, 2 * pt.num_steps * passes,
        2 * pt.num_steps * passes, 2 * pt.num_steps]
    assert sorted(yk) == sorted(yg)
    for key in yk:
        assert torch.equal(yg[key], yg2[key]), key
        assert torch.equal(yk[key], yg[key]), key
    we, wg = ye["watch"].cpu().numpy(), yg["watch"].cpu().numpy()
    assert np.abs(wg - we).max() <= 1e-5 * (we.max() - we.min())
    ie, ig = ye["cg_iters"].cpu().numpy(), yg["cg_iters"].cpu().numpy()
    assert abs(int(ig.sum()) - int(ie.sum())) <= 0.02 * ie.sum(), (ig, ie)
    assert math.isfinite(float(yg["final_u"].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 1], ids=["f64", "f32_refined"])
def test_graph_path_refuses_float64_solves_on_cuda(refine):
    """solver='vmem' with float64 operands for the inner solve raises
    ``cg_tol``'s TypeError on the card before anything is captured or
    launched, as the eager loop's first solve does; the float32 inner
    solve of the refined path runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    _, pt = _dac_pair(num_steps=2)
    fn = t_make(pt, dtype=torch.float32 if refine else torch.float64,
                solver="vmem", f64_refine=refine, rtol=1e-5,
                record_gradient=False, maxiter=4000, device="cuda",
                precondition="rline")
    if refine:
        assert torch.isfinite(fn()["final_u"]).all()
        return
    with pytest.raises(TypeError, match="must be float32"):
        fn()
    assert not fn._workspaces
    with pytest.raises(TypeError, match="must be float32"):
        fn.forward_eager()

"""The grid-overlay transient on the structured stepper's graph path
(``sim/unstructured.SimulatorUnstructured._run_lattice``, that is
``sim/stepper.GraphPath._run_graph`` over ``ops/cuda_step``).

(a) On the CPU the graph's plain version (``cuda_step.run_stepwise`` in
place of ``cuda_step.run``: each step wrapper's plain version and
``cg_tol``'s) against the eager overlay loop, bitwise; (b) ``precondition='adaptive'``: a threshold that forces one
form gives that form bitwise, a threshold between switches as the counts
say, and every path off the graph refuses it; (c) the cell's float32
recipe on that path against the float64 SciPy FEM of
``tests/reference_fem.py`` on the graded triangulation, which that
reference's backward Euler with its state kept in bfloat16 fails; (d) on the card, one graph launch a transient against
its launches made one at a time (bitwise) and the eager loop (marked
``cuda``; skipped here). No JAX here, so the ``cuda`` tests run on the card
as they are.
"""

import dataclasses
import json
import math
import os
import unittest.mock as mock

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from heatflow_tpu_torch import build_layout
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.mesh.unstructured_gen import build_unstructured_mesh
from heatflow_tpu_torch.ops import cuda_cg, cuda_step
from heatflow_tpu_torch.sim import unstructured as tu
from heatflow_tpu_torch.sim.bc import HeatingCurve
from tests import reference_fem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
WARM = ("previous", "extrapolate")


def _problem(cfg, heating, *, size_scale=1.0, seed=7):
    mesh = build_unstructured_mesh(*build_layout(cfg), size_scale=size_scale,
                                   jitter=0.25, seed=seed)
    return tu.build_problem_unstructured(
        mesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))


@pytest.fixture(scope="module")
def tiny():
    """The 5-material stack's triangulation (1368 nodes on its lattice)."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = STEPS
    df = synthetic_heating()
    return _problem(cfg, HeatingCurve(time=df["time"].to_numpy(),
                                      temp=df["temp"].to_numpy()))


def _make(p, device="cpu", **kw):
    kw = {"dtype": torch.float32, "solver": "vmem", "rtol": 1e-5,
          "record_gradient": False, "maxiter": 4000, **kw}
    return tu.make_simulate_fn_unstructured(p, device=device, **kw)


def _args(fn, kappas=None, fwhm=None, source=None):
    """The step loop's arguments of a call: the buffers, coefficients, u0
    and the source on the lattice."""
    return fn._inputs(kappas, None, fwhm, None, 0.0, source)


def _stepwise(fn, *args):
    """``fn._run_lattice(*args)`` on the graph's plain version, launch by
    launch (the CPU has no graph)."""
    with mock.patch.object(cuda_step, "run", cuda_step.run_stepwise):
        return fn._run_lattice(*args)


def _solves(fn):
    """(r-line or the one form, ADI) solves the last workspace counted."""
    (ws,) = fn._workspaces.values()
    return ws.state.view(torch.int64)[5:7].tolist()


# ----------------------------------------------------------------------
# (a) the graph's plain version is the eager overlay loop
# ----------------------------------------------------------------------

@pytest.mark.parametrize("warm", WARM)
@pytest.mark.parametrize("refine", [0, 1], ids=["f32", "refined"])
@pytest.mark.parametrize("precondition", ["rline", "adi"])
def test_graph_plain_version_is_the_eager_loop(tiny, precondition, refine,
                                               warm):
    """Every plane of a step is computed by the same expressions in the same
    order (the step wrappers' plain versions are the eager expressions; the
    solves are ``cg_tol``'s plain version on the same operands), so the
    traces, counts and final field are bitwise equal."""
    fn = _make(tiny, precondition=precondition, f64_refine=refine,
               warm_start=warm)
    args = _args(fn)
    with torch.no_grad():
        ye = fn._run_eager(*args)
        yg = _stepwise(fn, *args)
    assert sorted(ye) == sorted(yg) == ["cg_iters", "final_u", "times",
                                        "watch"]
    for key in ye:
        assert torch.equal(ye[key], yg[key]), key
    assert _solves(fn) == [STEPS * max(1, refine), 0]


def test_graph_plain_version_with_source_and_fields(tiny):
    """A volumetric source and the recorded fields (flat, in core order),
    against the eager loop, bitwise; ``forward`` brings both back in node
    order."""
    fn = _make(tiny, precondition="rline", f64_refine=1, record_fields=True,
               warm_start="extrapolate")
    n = len(tiny.mesh.nodes)
    src = np.random.default_rng(3).uniform(0.0, 1e12, n)
    args = _args(fn, source=src)
    with torch.no_grad():
        ye = fn._run_eager(*args)
        yg = _stepwise(fn, *args)
    for key in ye:
        assert torch.equal(ye[key], yg[key]), key
    assert yg["field"].shape == (STEPS, n)
    node = fn(source=src)
    assert torch.equal(node["field"], yg["field"][:, fn.to_node])
    assert torch.equal(node["final_u"], yg["final_u"][fn.to_node])


# ----------------------------------------------------------------------
# (b) 'adaptive'
# ----------------------------------------------------------------------

@pytest.mark.parametrize("refine", [0, 1], ids=["f32", "refined"])
@pytest.mark.parametrize("form", ["rline", "adi"])
def test_adaptive_forced_to_one_form_is_that_form(tiny, form, refine):
    """A threshold at maxiter never switches to ADI (the first step counts
    as maxiter, which does not exceed it); a threshold of -1 always does.
    Each run is bitwise the static form's, and the device's counts hold
    every solve on that form."""
    kw = dict(f64_refine=refine, warm_start="extrapolate", maxiter=4000)
    fa = _make(tiny, precondition="adaptive",
               adaptive_thresh=4000 if form == "rline" else -1, **kw)
    fs = _make(tiny, precondition=form, **kw)
    args = _args(fa)
    with torch.no_grad():
        ya = _stepwise(fa, *args)
        ys = fs._run_eager(*args)
    for key in ys:
        assert torch.equal(ya[key], ys[key]), key
    solves = STEPS * max(1, refine)
    assert _solves(fa) == ([solves, 0] if form == "rline" else [0, solves])


def test_adaptive_switches_on_the_previous_count(tiny):
    """A threshold between the forms' counts: the first step runs ADI, each
    later one ADI exactly when the step before it took more than the
    threshold, as the device counted."""
    fn = _make(tiny, precondition="adaptive", adaptive_thresh=45,
               warm_start="extrapolate")
    with torch.no_grad():
        its = _stepwise(fn, *_args(fn))["cg_iters"].tolist()
    adi = 1 + sum(i > 45 for i in its[:-1])
    assert _solves(fn) == [STEPS - adi, adi]
    assert 0 < adi < STEPS, its


def test_adaptive_is_refused_off_the_graph_path(tiny):
    """The eager loop (the CPU, a batch of lanes), the ELL gather, the eager
    solver and a recording run refuse 'adaptive' with a message that says
    where it runs."""
    fn = _make(tiny, precondition="adaptive")
    with pytest.raises(ValueError, match="one CUDA graph"):
        fn()
    with pytest.raises(ValueError, match="one CUDA graph"):
        fn(kappas=np.tile(tiny.kappas, (2, 1)), fwhm=[5e-6, 6e-6])
    with pytest.raises(ValueError, match="gradient"):
        _make(tiny, precondition="adaptive", record_gradient=True)
    with pytest.raises(ValueError, match="kernel path"):
        _make(tiny, precondition="adaptive", solver="xla")
    bare = dataclasses.replace(tiny, extras={}, mesh=dataclasses.replace(
        tiny.mesh, grid_overlay=None))
    with pytest.raises(ValueError, match="grid-overlay"):
        _make(bare, precondition="adaptive")
    with pytest.raises(ValueError, match="not selected"):
        _make(bare, precondition="adaptive", solver="auto")


# ----------------------------------------------------------------------
# (c) the cell's recipe against the float64 FEM
# ----------------------------------------------------------------------

# the cell's recipe (hfbench/workloads/tri_flagship.transient.json) on the
# kernel path's plain version
RECIPE = dict(dtype=torch.float32, rtol=1e-4, maxiter=8000,
              precondition="adaptive", warm_start="extrapolate",
              f64_refine=1, record_gradient=False, solver="vmem")
# seeded draws from the cell's box, log-uniform over [1, 100] W/m/K x
# [1e-6, 1e-4] m
DRAWS = np.exp(np.random.default_rng(19).uniform(
    np.log([1.0, 1e-6]), np.log([100.0, 1e-4]), (3, 2)))
# the watchers' widest gap and that of their step increments, in kelvin.
# One float64 pass around float32 solves stopped at 1e-4 of their
# right-hand side leaves each step a part in ~1e-4 of its increment, which
# the next step's pass mostly corrects: 0.02-0.21 K and 0.04-0.15 K on
# these draws (the pulse lifts the watchers ~500 K in 30 steps). A state
# kept in bfloat16 (8 bits of mantissa: a spacing of 2 K at 256-512 K)
# reads 1.8-1.9 K and 2.3-3.5 K. The limits sit 5x above the sound
# readings and below every control reading.
WATCH_GAP_K = 1.0
WATCH_STEP_GAP_K = 1.0


@pytest.fixture(scope="module")
def tri():
    """The cell's configuration on its triangulation at 1/16 of the
    published mesh density, 30 steps of its heating."""
    doc = json.load(open(os.path.join(
        ROOT, "hfbench", "configs", "geballe_with_diamond_tri.json")))
    cfg = doc["config"]
    t = cfg["timing"]
    cfg["timing"] = dict(t_final=t["t_final"] * 30 / t["num_steps"],
                         num_steps=30)
    heating = HeatingCurve.from_csv(os.path.join(ROOT, doc["heating_csv"]))
    return _problem(cfg, heating, size_scale=16.0, seed=0)


def _terms(p, kappa, fwhm):
    """The draw's per-cell conductivity and heat capacity and its boundary
    values g(t), as the reference takes them."""
    kappas = p.kappas.copy()
    kappas[p.mesh.material_tags["p_sample"] - 1] = kappa
    tags = p.mesh.cell_tags - 1
    profile = np.exp(-4.0 * math.log(2.0) / fwhm ** 2
                     * p.mesh.nodes[:, 1] ** 2) * p.heat_mask
    dirich = p.dirichlet.astype(float)
    off = p.heating.temp[0] - p.ic_temp

    def g_of_t(t):
        amp = np.interp(t, p.heating.time, p.heating.temp) - off
        return p.ic_temp * dirich + (amp - p.ic_temp) * profile

    return kappas[tags], p.rho_cvs[tags], g_of_t


def _reference(p, kappa, fwhm):
    ck, cr, g_of_t = _terms(p, kappa, fwhm)
    return reference_fem.backward_euler(
        p.mesh.nodes, p.mesh.cells, ck, cr, p.dt, p.num_steps, p.dirichlet,
        g_of_t, p.ic_temp, watch_nodes=list(p.watcher_nodes))["watch"]


def _reference_bf16_state(p, kappa, fwhm):
    """The control: ``reference_fem.backward_euler``'s steps (factor-once
    LU, Dirichlet lifting, on its own assembly) with the state rounded to
    bfloat16 after every step."""
    ck, cr, g_of_t = _terms(p, kappa, fwhm)
    K, M = reference_fem.assemble(p.mesh.nodes, p.mesh.cells, ck, cr)
    A = (M + p.dt * K).tocsc()
    dirich = p.dirichlet
    free = ~dirich
    lu = spla.splu(A[free][:, free].tocsc())
    A_fd = A[free][:, dirich]
    u = np.full(len(p.mesh.nodes), float(p.ic_temp))
    rows = []
    for s in range(p.num_steps):
        g = g_of_t((s + 1) * p.dt)
        x = lu.solve((M @ u)[free] - A_fd @ g[dirich])
        u = np.where(dirich, g, 0.0)
        u[free] = x
        u = _bf16(u)
        rows.append(u[list(p.watcher_nodes)])
    return np.array(rows)


def _gaps(got, want, ic):
    steps = lambda w: np.diff(w, axis=0, prepend=np.full((1, w.shape[1]),
                                                         ic))
    return (np.abs(got - want).max(),
            np.abs(steps(got) - steps(want)).max())


def _bf16(u):
    return torch.as_tensor(u).to(torch.bfloat16).double().numpy()


@pytest.mark.parametrize("draw", range(len(DRAWS)))
def test_cell_recipe_matches_the_float64_fem(tri, draw):
    kappa, fwhm = DRAWS[draw]
    fn = tu.make_simulate_fn_unstructured(tri, device="cpu", **RECIPE)
    kappas = tri.kappas.copy()
    kappas[tri.mesh.material_tags["p_sample"] - 1] = kappa
    with torch.no_grad():
        got = _stepwise(fn, *_args(fn, kappas, fwhm))["watch"].numpy()
    want = _reference(tri, kappa, fwhm)
    watch, step = _gaps(got, want, tri.ic_temp)
    assert watch <= WATCH_GAP_K and step <= WATCH_STEP_GAP_K, (watch, step)
    assert np.abs(want - tri.ic_temp).max() > 100.0       # the pulse arrives


def test_a_bfloat16_state_fails_the_limits(tri):
    """The reference's steps with the state rounded to bfloat16 after every
    step, against the reference in float64, read past a limit on every
    draw."""
    for kappa, fwhm in DRAWS:
        want = _reference(tri, kappa, fwhm)
        got = _reference_bf16_state(tri, kappa, fwhm)
        watch, step = _gaps(got, want, tri.ic_temp)
        assert watch > WATCH_GAP_K or step > WATCH_STEP_GAP_K, (watch, step)


# ----------------------------------------------------------------------
# (d) on the card
# ----------------------------------------------------------------------

CARD_CASES = {
    "adaptive_refined": dict(precondition="adaptive", f64_refine=1,
                             warm_start="extrapolate", adaptive_thresh=45),
    "rline": dict(precondition="rline", warm_start="extrapolate"),
    "adi_refined": dict(precondition="adi", f64_refine=1),
    "jacobi_fields_source": dict(precondition="jacobi", record_fields=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_overlay_graph_path_matches_on_cuda(tiny, name):
    """On the card a call runs one graph launch: bitwise the same transient
    launched a kernel at a time (``cuda_step.run_stepwise``: the same
    kernels and solves), and reused by a second call. Against the eager
    loop, whose two refinement sums torch.sum takes in another order, the
    traces stay within rtol of their range and the iteration totals within
    2 %."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    kw = CARD_CASES[name]
    fn = _make(tiny, device="cuda", **kw)
    src = np.random.default_rng(6).uniform(0, 1e12, len(tiny.mesh.nodes)) \
        if name.endswith("source") else None
    args = _args(fn, source=src)
    with mock.patch.object(cuda_step, "run", cuda_step.run_stepwise):
        ys = fn._run_lattice(*args)
    adaptive = kw["precondition"] == "adaptive"
    # the eager loop has no per-step switch
    ye = None if adaptive else fn._run_eager(*args)
    cuda_cg.reset_counters()
    cuda_step.reset_counters()
    yg = fn(source=src)
    yg2 = fn(source=src)
    passes = max(1, kw.get("f64_refine", 0))
    assert cuda_cg.cg_tol.launches == 2 * STEPS * passes
    assert [f.launches for f in cuda_step._KERNELS] == [
        2 * STEPS, 2 * STEPS * kw.get("f64_refine", 0),
        2 * STEPS * kw.get("f64_refine", 0), 2 * STEPS]
    node = lambda v: v[..., fn.to_node]
    for key in yg:
        assert torch.equal(yg[key], yg2[key]), key
        want = node(ys[key]) if key in ("final_u", "field") else ys[key]
        assert torch.equal(yg[key], want), key
    assert math.isfinite(float(yg["final_u"].abs().max()))
    if adaptive:
        return
    we, wg = ye["watch"].cpu().numpy(), yg["watch"].cpu().numpy()
    assert np.abs(wg - we).max() <= 1e-5 * (we.max() - we.min())
    ie, ig = ye["cg_iters"].cpu().numpy(), yg["cg_iters"].cpu().numpy()
    assert abs(int(ig.sum()) - int(ie.sum())) <= 0.02 * ie.sum(), (ig, ie)
    assert math.isfinite(float(yg["final_u"].abs().max()))

"""A mesh without grid overlay (an imported gmsh mesh) on the transient's
kernel path: ``cg_tol``'s ELL form inside the structured stepper's graph
(``sim/stepper.GraphPath._run_graph`` over ``ops/cuda_step``), the nodes in
reverse Cuthill–McKee order (``ops/ell.locality_order``).

(a) On the CPU the graph's plain version (``cuda_step.run_stepwise`` in
place of ``cuda_step.run``) against the eager loop of the same module,
bitwise, and against the eager ELL loop of ``solver='xla'`` (the eager PCG
in node order), counts equal and traces within float32 summation order,
and so the kernel path's eager loop recording gradient rows;
(b) the cell's float32 recipe against the benchmark's float64 reference
(``hfbench/reference/fem.py``, the same triangulation) on seeded draws;
(c) the float64 transient against the JAX package's ELL transient (JAX
imported in that test only); (d) the order: a bijection, the operators
permuted bit for bit, and a run in it against the run in node order;
(e) on the card (marked ``cuda``; skipped here): the ELL pass and the ELL
step kernels against their plain versions, one graph launch a transient
against its launches made one at a time and the eager loop.
"""

import dataclasses
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from heatflow_tpu_torch import build_layout
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.mesh.unstructured_gen import build_unstructured_mesh
from heatflow_tpu_torch.ops import cuda_cg, cuda_step, ell as tell
from heatflow_tpu_torch.sim import unstructured as tu
from heatflow_tpu_torch.sim.bc import HeatingCurve
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6


def _problem(cfg, heating, *, size_scale=1.0, seed=7):
    """The triangulation of ``cfg``'s layout with its overlay dropped: the
    program sees a mesh with no lattice under it, as an imported one."""
    mesh = build_unstructured_mesh(*build_layout(cfg), size_scale=size_scale,
                                   jitter=0.25, seed=seed)
    mesh = dataclasses.replace(mesh, grid_overlay=None)
    return tu.build_problem_unstructured(
        mesh, heating, cfg, watcher_points=coupler_watcher_points(cfg))


def _tiny_cfg():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = STEPS
    return cfg


def _heating():
    df = synthetic_heating()
    return HeatingCurve(time=df["time"].to_numpy(),
                        temp=df["temp"].to_numpy())


@pytest.fixture(scope="module")
def tiny():
    """The 5-material stack's triangulation, 1368 nodes, no overlay."""
    return _problem(_tiny_cfg(), _heating())


def _make(p, device="cpu", **kw):
    kw = {"dtype": torch.float32, "solver": "vmem", "rtol": 1e-5,
          "record_gradient": False, "maxiter": 4000, **kw}
    return tu.make_simulate_fn_unstructured(p, device=device, **kw)


def _args(fn, kappas=None, fwhm=None, source=None):
    return fn._inputs(kappas, None, fwhm, None, 0.0, source)


def _stepwise(fn, *args):
    """The graph's transient on its plain version, launch by launch."""
    with mock.patch.object(cuda_step, "run", cuda_step.run_stepwise):
        return fn._run_lattice(*args)


# ----------------------------------------------------------------------
# (a) the graph's plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize("warm", ["previous", "extrapolate"])
@pytest.mark.parametrize("refine", [0, 1], ids=["f32", "refined"])
def test_graph_plain_version_is_the_eager_loop(tiny, refine, warm):
    """The step wrappers' plain versions are the eager loop's expressions
    on the same (N, K) operators and ``cg_tol``'s plain version its solve,
    so the module's graph path and its eager loop agree bit for bit. The
    eager ELL loop of ``solver='xla'`` (the eager PCG, the nodes in their
    own order) runs the same recurrence with its sums in another order: the
    counts are equal, the traces within 1e-4 of their range (float32
    solves stopped at 1e-5, one part in ~1e-5 of a step's increment, the
    sums' order moving the last bits of each)."""
    fn = _make(tiny, f64_refine=refine, warm_start=warm)
    assert fn.use_vmem and not fn.overlay and fn.reordered
    args = _args(fn)
    with torch.no_grad():
        ye = fn._run_eager(*args)
        yg = _stepwise(fn, *args)
    assert sorted(ye) == sorted(yg) == ["cg_iters", "final_u", "times",
                                        "watch"]
    for key in ye:
        assert torch.equal(ye[key], yg[key]), key
    (ws,) = fn._workspaces.values()
    assert ws.cols is not None and ws.As.shape == tiny.ell.cols.shape
    assert ws.state.view(torch.int64)[5:7].tolist() == [
        STEPS * max(1, refine), 0]
    fx = _make(tiny, f64_refine=refine, warm_start=warm, solver="xla")
    assert not fx.use_vmem and not fx.reordered
    yx, yv = fx(), fn()
    assert torch.equal(yx["cg_iters"], yv["cg_iters"])
    w = yx["watch"]
    span = float(w.max() - w.min())
    assert float((yv["watch"] - w).abs().max()) <= 1e-4 * span
    assert float((yv["final_u"] - yx["final_u"]).abs().max()) <= 1e-4 * span


def test_graph_plain_version_with_source_and_fields(tiny):
    """A volumetric source and the recorded fields (flat, in core order),
    against the eager loop, bitwise; ``forward`` brings both back in node
    order."""
    fn = _make(tiny, f64_refine=1, record_fields=True,
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


@pytest.mark.parametrize("dtype, rtol, tol, grad_tol", [
    (torch.float32, 1e-5, 1e-4, 3e-3), (torch.float64, 1e-11, 1e-12, 1e-10)],
    ids=["f32", "f64"])
def test_gradient_rows_on_the_kernel_path_match_node_order(tiny, dtype, rtol,
                                                           tol, grad_tol):
    """Gradient recording takes the eager loop of the kernel path, the
    nodes in the locality order, with the band slots and axis nodes mapped
    into it (what ``run2d`` runs on an imported mesh in float32 on a card):
    against ``solver='xla'`` in node order the solve and projection counts
    are equal, and the watchers, band values and axis rows agree within
    summation order, as a share of each one's range. In float32 the rows
    read 7e-4 (solves stopped at 1e-5, the projection's right-hand side a
    difference of neighbouring nodes, so rounding in its sums' order weighs
    ~100x more than in the field's), the watchers 5e-6; in float64 6e-13
    and 3e-15."""
    kw = dict(dtype=dtype, rtol=rtol, record_gradient=True,
              warm_start="extrapolate")
    fv, fx = _make(tiny, **kw), _make(tiny, solver="xla", **kw)
    assert fv.use_vmem and fv.reordered and not fx.use_vmem
    yv, yx = fv(), fx()
    assert sorted(yv) == sorted(yx) == ["axis", "band", "cg_iters",
                                        "final_u", "proj_iters", "times",
                                        "watch"]
    for key in ("cg_iters", "proj_iters", "times"):
        assert torch.equal(yv[key], yx[key]), key
    for key, t in (("watch", tol), ("final_u", tol), ("band", grad_tol),
                   ("axis", grad_tol)):
        span = float(yx[key].max() - yx[key].min())
        assert float((yv[key] - yx[key]).abs().max()) <= t * span, key


def test_lines_are_refused_without_an_overlay(tiny):
    """'rline', 'adi' and 'adaptive' solve along a lattice's lines: a mesh
    without overlay refuses them on the kernel path, and 'auto' picks that
    path only on a CUDA device in float32."""
    for prec in ("rline", "adi", "adaptive"):
        with pytest.raises(ValueError, match="grid-overlay"):
            _make(tiny, precondition=prec, f64_refine=1)
    assert not _make(tiny, solver="auto").use_vmem
    assert tu.auto_selects_vmem(tiny.mesh, torch.float32, "cuda")
    assert not tu.sweep_auto_selects_vmem(tiny.mesh, torch.float32, "cuda")


# ----------------------------------------------------------------------
# (b) the cell's recipe against the benchmark's float64 reference
# ----------------------------------------------------------------------

# the cell's recipe (hfbench/workloads/msh_flagship.transient.json) on the
# kernel path's plain version
RECIPE = dict(dtype=torch.float32, rtol=1e-4, maxiter=8000,
              precondition="jacobi", warm_start="extrapolate", f64_refine=1,
              record_gradient=False, solver="vmem")
# seeded draws from the cell's box, log-uniform over [1, 100] W/m/K x
# [1e-6, 1e-4] m
DRAWS = np.exp(np.random.default_rng(23).uniform(
    np.log([1.0, 1e-6]), np.log([100.0, 1e-4]), (3, 2)))
# the watchers' widest gap and that of their step increments, in kelvin.
# One float64 pass around float32 Jacobi solves stopped at 1e-4 of their
# right-hand side leaves each step a part in ~1e-4 of its increment, which
# the next step's pass mostly corrects (the pulse lifts the watchers
# ~500 K in 30 steps): these draws read 0.053-0.124 K and 0.041-0.145 K
# (1440 nodes). The benchmark's control, the reference with its operator
# and state in bfloat16, reads infinite on every draw (its solves do not
# stay finite). The limits sit ~4x above the sound readings.
WATCH_GAP_K = 0.6
WATCH_STEP_GAP_K = 0.6


@pytest.fixture(scope="module")
def msh():
    """The cell's configuration on its triangulation at 1/16 of the
    published density, no overlay, the first 30 of its 100 steps; the
    benchmark's float64 reference of the same mesh and steps."""
    from hfbench.reference.fem import Reference
    from hfbench.reference.triangulation import JITTER, SEED
    doc = json.load(open(os.path.join(
        ROOT, "hfbench", "configs", "geballe_with_diamond_msh.json")))
    cfg = doc["config"]
    t = cfg["timing"]
    cfg["timing"] = dict(t_final=t["t_final"] * 30 / t["num_steps"],
                         num_steps=30)
    csv = os.path.join(ROOT, doc["heating_csv"])
    cfg["heating"] = dict(cfg["heating"], file=csv)
    mesh = build_unstructured_mesh(*build_layout(cfg), size_scale=16.0,
                                   jitter=JITTER, seed=SEED)
    mesh = dataclasses.replace(mesh, grid_overlay=None)
    p = tu.build_problem_unstructured(
        mesh, HeatingCurve.from_csv(csv), cfg,
        watcher_points=coupler_watcher_points(cfg))
    ref = Reference(cfg, csv, size_scale=16.0, mesh="triangulation")
    return p, ref


def _gaps(got, want, ic):
    """The cell's two readings (``hfbench.check.gaps``: a gap that is not
    a number reads as infinite)."""
    from hfbench.check import gaps
    out = gaps({"watch": got}, {"watch": want}, ic)
    return out["watch_gap_K"], out["watch_step_gap_K"]


@pytest.mark.parametrize("draw", range(len(DRAWS)))
def test_cell_recipe_matches_the_float64_reference(msh, draw):
    p, ref = msh
    kappa, fwhm = DRAWS[draw]
    fn = tu.make_simulate_fn_unstructured(p, device="cpu", **RECIPE)
    kappas = p.kappas.copy()
    kappas[p.mesh.material_tags["p_sample"] - 1] = kappa
    with torch.no_grad():
        got = _stepwise(fn, *_args(fn, kappas, fwhm))["watch"].numpy()
    want = ref.run(kappa, fwhm)["watch"]
    watch, step = _gaps(got, want, p.ic_temp)
    assert watch <= WATCH_GAP_K and step <= WATCH_STEP_GAP_K, (watch, step)
    assert np.abs(want - p.ic_temp).max() > 100.0       # the pulse arrives


def test_a_bfloat16_reference_fails_the_limits(msh):
    """The reference with its operators' entries and its state in bfloat16
    (the benchmark's control), against itself in float64, reads past a
    limit on every draw."""
    p, ref = msh
    for kappa, fwhm in DRAWS:
        want = ref.run(kappa, fwhm)["watch"]
        got = ref.run(kappa, fwhm, bf16=True)["watch"]
        watch, step = _gaps(got, want, p.ic_temp)
        assert watch > WATCH_GAP_K or step > WATCH_STEP_GAP_K, (watch, step)


# ----------------------------------------------------------------------
# (c) float64 against the JAX package
# ----------------------------------------------------------------------

def test_float64_transient_matches_the_jax_package(tiny):
    """The port's float64 transient on the kernel path's plain version (the
    ELL form in its locality order) against the JAX package's ELL transient
    (its eager PCG in node order): watchers and final field within 1e-8
    rel-L2 at rtol 1e-11, the counts within one iteration a step (the
    float64 sums in another order decide a solve's last test)."""
    import jax
    from heatflow_tpu.mesh.msh_io import UnstructuredMesh as JMesh
    from heatflow_tpu.sim import bc as jbc, unstructured as ju
    jax.config.update("jax_enable_x64", True)
    m = tiny.mesh
    jmesh = JMesh(nodes=m.nodes.copy(), cells=m.cells.copy(),
                  cell_tags=m.cell_tags.copy(),
                  material_tags=dict(m.material_tags))
    jp = ju.build_problem_unstructured(
        jmesh, jbc.HeatingCurve(time=tiny.heating.time,
                                temp=tiny.heating.temp), _tiny_cfg(),
        watcher_points=coupler_watcher_points(_tiny_cfg()))
    kw = dict(rtol=1e-11, record_gradient=False, warm_start="extrapolate")
    yj = jax.tree.map(np.asarray, ju.make_simulate_fn_unstructured(jp, **kw)())
    fn = _make(tiny, dtype=torch.float64, **kw)
    assert fn.use_vmem and fn.reordered
    yt = {k: v.numpy() for k, v in fn().items()}
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(yt["watch"], yj["watch"]) <= 1e-8
    assert rel(yt["final_u"], yj["final_u"]) <= 1e-8
    assert np.abs(yt["cg_iters"].astype(int)
                  - yj["cg_iters"].astype(int)).max() <= 1


# ----------------------------------------------------------------------
# (d) the locality order
# ----------------------------------------------------------------------

def test_locality_order_is_a_bijection_that_narrows_the_rows(tiny):
    """The order is a permutation; the permuted operators' rows are the old
    rows with their column ids renumbered, so a product in the new order is
    the old product permuted, bit for bit; the mean distance of a row's
    columns from it falls (the generator's numbering is scattered)."""
    ell = tiny.ell
    order = tell.locality_order(ell.cols)
    n = len(order)
    assert np.array_equal(np.sort(order), np.arange(n))
    new = ell.permuted(order)
    spread = lambda c: np.abs(c - np.arange(len(c))[:, None]).mean()
    assert spread(new.cols) < 0.2 * spread(ell.cols)
    u = np.random.default_rng(5).standard_normal(n)
    t = torch.as_tensor
    for vals, new_vals in ((ell.K_vals[2], new.K_vals[2]),
                           (ell.Mp_vals, new.Mp_vals)):
        y = tell.ell_apply(t(ell.cols).long(), t(vals), t(u))
        y_new = tell.ell_apply(t(new.cols).long(), t(new_vals), t(u[order]))
        assert torch.equal(y[order], y_new)
    fn = _make(tiny)
    assert torch.equal(fn.to_core[fn.to_node], torch.arange(n))


def test_a_run_in_the_order_matches_the_run_in_node_order():
    """The same float64 transient with the order replaced by the identity:
    every step's products are the same numbers, only the sums of the CG
    run in another order, so the counts are equal and the traces agree to
    float64 roundoff."""
    runs = []
    for identity in (False, True):
        p = _problem(_tiny_cfg(), _heating())
        with mock.patch.object(tu, "locality_order",
                               lambda cols: np.arange(len(cols))
                               if identity else tell.locality_order(cols)):
            fn = _make(p, dtype=torch.float64, rtol=1e-11,
                       warm_start="extrapolate", record_fields=True)
        runs.append({k: v.numpy() for k, v in fn().items()})
    (a, b) = runs
    assert np.array_equal(a["cg_iters"], b["cg_iters"])
    for key in ("watch", "final_u", "field"):
        assert np.abs(a[key] - b[key]).max() <= 1e-10 * np.abs(b[key]).max()


# ----------------------------------------------------------------------
# (e) on the card
# ----------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_ell_pass_matches_its_plain_version(tiny):
    """``k_ell_dot`` on the ELL operator of a step: p and Ap bitwise the
    plain version's (the same products and sums, rounded alike); <p, Ap>
    within 1e-6 (the kernel rounds each term p·Ap to float32 before its
    float64 sum, as ``k_stencil_dot`` does, the plain version sums the
    float64 products: 1.5e-9 apart on the card); on a later iteration
    (count 1) p formed from z and the last p, the alpha tail's alpha from
    its sum."""
    dev = _card()
    fn = _make(tiny, device="cuda")
    (ws, _) = fn._step_workspace(*_args(fn))
    A, cols, sm = ws.As, ws.cols, ws.sm
    g = torch.Generator(device="cpu").manual_seed(4)
    z = torch.randn(sm.shape, generator=g).to(dev) * (sm != 0)
    p = torch.randn(sm.shape, generator=g).to(dev) * (sm != 0)
    p_n, Ap, pap, _ = cuda_cg.ell_dot(A, cols, sm, z, p)
    want_p, want_ap, want_pap = cuda_cg.stencil_dot_p_reference(
        A, sm, z, p, 0.0, True, cols)
    assert torch.equal(p_n, want_p) and torch.equal(Ap, want_ap)
    assert abs(float(pap) - float(want_pap)) <= 1e-6 * abs(float(want_pap))
    state = dict(k=1, beta=0.37, rz=2.5)
    p_n, Ap, pap, st = cuda_cg.ell_dot(A, cols, sm, z, p, state)
    want_p, want_ap, want_pap = cuda_cg.stencil_dot_p_reference(
        A, sm, z, p, 0.37, False, cols)
    assert torch.equal(p_n, want_p) and torch.equal(Ap, want_ap)
    assert st["alpha"] == pytest.approx(2.5 / float(want_pap), rel=1e-6)


@pytest.mark.cuda
def test_ell_step_kernels_match_their_plain_versions(tiny):
    """The prologue's M u and the refinement's float64 residual through
    the ELL gather: the planes bitwise the plain versions' (ell_apply's
    order, each product and sum rounded), the residual's norm within
    float64 summation order of the kernels' own order."""
    _card()
    fn = _make(tiny, device="cuda", f64_refine=1, warm_start="extrapolate")
    ws, _ = fn._step_workspace(*_args(fn))
    ring = ws.ring.clone()
    b_lift, y0 = cuda_step.step_prologue_reference(
        ws.apply, ws.Mop, ring[2], ring[1], ring[0], 0.0, ws.Ag0, ws.Ag1,
        ws.amps[0], ws.s, ws.free, ws.warm_start)
    cuda_step.step_prologue(ws)
    assert torch.equal(ws.bt, b_lift * ws.free) and torch.equal(ws.y[0], y0)
    floor2 = 1e-30 * cuda_step.kernel_order_sum(ws.bt * ws.bt)
    _, r64, rnorm, _ = cuda_step.refine_residual_reference(
        ws.apply, ws.A, ws.s, ws.free, ws.bt, ws.y[0], floor2, ws.rtol,
        torch.float32, total=cuda_step.kernel_order_sum)
    cuda_step.refine_residual(ws, 0)
    assert torch.equal(ws.r64, r64)
    assert float(ws.state[cuda_step._RNORM]) == pytest.approx(float(rnorm),
                                                              rel=1e-14)


@pytest.mark.cuda
@pytest.mark.parametrize("refine", [0, 1], ids=["f32", "refined"])
def test_ell_graph_path_matches_on_cuda(tiny, refine):
    """A call is one graph launch of 2 K1 launches an iteration: bitwise
    the same transient launched a kernel at a time (the same kernels and
    solves), and again on a second call. Against the eager loop, whose
    refinement sums torch.sum takes in another order, the traces stay
    within 1e-5 of their range and the iteration totals within 2 %."""
    _card()
    fn = _make(tiny, device="cuda", f64_refine=refine,
               warm_start="extrapolate", record_fields=True)
    args = _args(fn)
    ys = _stepwise(fn, *args)
    ye = fn._run_eager(*args)
    cuda_cg.reset_counters()
    cuda_step.reset_counters()
    yg = fn()
    yg2 = fn()
    passes = max(1, refine)
    assert cuda_cg.cg_tol.launches == cuda_cg.cg_tol.launches_ell \
        == 2 * STEPS * passes
    assert cuda_step.step_prologue.launches == 2 * STEPS
    assert cuda_cg.graph_stats()["ell"]["launches_per_iteration"] == 2.0
    node = lambda v: v[..., fn.to_node]
    for key in yg:
        assert torch.equal(yg[key], yg2[key]), key
        want = node(ys[key]) if key in ("final_u", "field") else ys[key]
        assert torch.equal(yg[key], want), key
    we, wg = ye["watch"].cpu().numpy(), yg["watch"].cpu().numpy()
    assert np.abs(wg - we).max() <= 1e-5 * (we.max() - we.min())
    ie, ig = ye["cg_iters"].cpu().numpy(), yg["cg_iters"].cpu().numpy()
    assert abs(int(ig.sum()) - int(ie.sum())) <= 0.02 * ie.sum(), (ig, ie)

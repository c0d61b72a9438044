"""The port's sweep slice against the JAX package: ``make_sweep_fn`` in both
solvers (the JAX 'vmem' path runs its Pallas kernels in interpret mode),
``run_sweep_time_chunked``, the float32 recipe, mixed-precision sweeps, the
fit metric, the host problem of ``geballe_no_diamond``, and the options the
slice rejects."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.ops.stencil import assemble_stencils as j_assemble
from heatflow_tpu.sim import sweepkernel as jsw
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu_torch.geometry import coupler_watcher_points as t_watch
from heatflow_tpu_torch.sim import sweepkernel as tsw
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_DIAMOND = os.path.join(ROOT, "cfgs", "geballe_no_diamond.yaml")
HEAT_CSV = os.path.join(ROOT, "experimental_data", "geballe_heat_data.csv")
KS = np.array([2.0, 3.8, 7.5])
FS = np.array([4e-6, 6e-6, 9e-6])
F64_TOL = 1e-9     # float64 traces, relative to the trace scale


@pytest.fixture(scope="module")
def pair():
    """The JAX sweep tests' problem (tiny no-diamond stack, 5 steps), built
    by each package."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 5
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    pj = j_build_problem(J.build_structured_mesh(*J.build_layout(cfg)),
                         JHeating(time=t, temp=temp), cfg,
                         watcher_points=j_watch(cfg))
    pt = t_build_problem(T.build_structured_mesh(*T.build_layout(cfg)),
                         THeating(time=t, temp=temp), cfg,
                         watcher_points=t_watch(cfg))
    return pj, pt


def _close(got, want, tol=F64_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("kw", [
    dict(solver="xla"), dict(solver="vmem"),
    dict(solver="xla", precondition="rline"),
    dict(solver="vmem", precondition="rline"),
    dict(solver="xla", precondition="zline"),
    dict(solver="xla", precondition="adi", warm_start="extrapolate"),
    dict(solver="vmem", warm_start="extrapolate", rtol_wrt="r0"),
    dict(solver="xla", fixed_iters=30),
    dict(solver="vmem", fixed_iters=30, warm_start="extrapolate"),
    dict(solver="xla", precondition="mg"),
    dict(solver="xla", precondition="mg", warm_start="extrapolate",
         rtol_wrt="r0"),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_make_sweep_fn_matches_jax_f64(pair, kw):
    pj, pt = pair
    want = jsw.make_sweep_fn(pj, dtype=jnp.float64, rtol=1e-10, **kw)(KS, FS)
    got = tsw.make_sweep_fn(pt, dtype=torch.float64, rtol=1e-10, **kw,
                            device="cpu")(KS, FS)
    assert got.dtype == torch.float64
    _close(got, want)


@pytest.mark.parametrize("solver", ["xla", "vmem"])
def test_chunked_extrapolate_is_bitwise_and_matches_jax(pair, solver):
    """Chunks of 2 + 2 + 1 steps (a ragged tail) equal the unchunked run
    bitwise, and the JAX package's chunked run within tolerance."""
    pj, pt = pair
    kw = dict(rtol=1e-10, solver=solver, warm_start="extrapolate")
    its = []
    chunked = tsw.run_sweep_time_chunked(pt, KS, FS, step_chunk=2,
                                         dtype=torch.float64, iters_out=its,
                                         **kw, device="cpu")
    whole = tsw.make_sweep_fn(pt, dtype=torch.float64, **kw,
                              device="cpu")(KS, FS)
    assert isinstance(chunked, np.ndarray)
    assert np.array_equal(chunked, whole.numpy())
    assert len(its) == pt.num_steps and its[0].shape == (3,)
    assert all(int(i.min()) > 0 for i in its)
    want = jsw.run_sweep_time_chunked(pj, KS, FS, step_chunk=2,
                                      dtype=jnp.float64, **kw)
    _close(chunked, want)


def test_segment_threads_history(pair):
    """segment(): the fields returned by one chunk start the next, and the
    first chunk's fields match the JAX package's."""
    pj, pt = pair
    kw = dict(rtol=1e-10, solver="vmem", warm_start="extrapolate",
              num_steps=3)
    fj = jsw.make_sweep_fn(pj, dtype=jnp.float64, **kw)
    ft = tsw.make_sweep_fn(pt, dtype=torch.float64, **kw, device="cpu")
    u0 = np.full((3,) + pt.mesh.shape, pt.ic_temp)
    trj, uj, uppj = fj.segment(KS, FS, u0, 0)
    trt, ut, uppt = ft.segment(KS, FS, u0, 0)
    for got, want in ((trt, trj), (ut, uj), (uppt, uppj)):
        _close(got, want)
    tr2, _, _ = ft.segment(KS, FS, ut, 3, uppt)
    assert tr2.shape == trt.shape and torch.isfinite(tr2).all()
    assert ft.shape == pt.mesh.shape and ft.dt == pt.dt
    np.testing.assert_array_equal(ft.times, fj.times)


def test_f32_recipe_matches_jax(pair, monkeypatch):
    """The float32 kernel path (plain versions here, Pallas in interpret
    mode there): per-step iteration counts within 2 of the JAX package's
    in every lane; traces within 1e-5 of their range at a tight tolerance;
    at the bench tolerance (1e-4 wrt ||b||) no farther from the float64
    traces than 1.5x the JAX package's error + 0.1 K."""
    import jax
    from heatflow_tpu.ops import pallas_cg
    pj, pt = pair
    truth = np.asarray(jsw.make_sweep_fn(pj, dtype=jnp.float64,
                                         rtol=1e-12)(KS, FS))
    # the JAX sweep keeps its per-step counts inside its scan: read them
    # off the kernel's results as the scan runs
    seen = []
    kernel = pallas_cg.cg_vmem_batched_tol

    def counting(*args, **kw):
        x, its = kernel(*args, **kw)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), its,
                           ordered=True)
        return x, its

    monkeypatch.setattr(pallas_cg, "cg_vmem_batched_tol", counting)
    u0 = np.full((3,) + pt.mesh.shape, pt.ic_temp)
    for rtol in (1e-6, 1e-4):
        kw = dict(rtol=rtol, solver="vmem")
        seen.clear()
        wj = np.asarray(jsw.make_sweep_fn(pj, dtype=jnp.float32, **kw)(KS,
                                                                      FS))
        its_t = []
        wt = tsw.make_sweep_fn(pt, dtype=torch.float32, **kw,
                               device="cpu").segment(
            KS, FS, u0, 0, iters_out=its_t)[0].numpy()
        assert np.isfinite(wt).all()
        its_j = np.stack(seen)
        its_t = torch.stack(its_t).numpy()
        assert its_t.shape == its_j.shape == (pt.num_steps, 3)
        assert its_t.min() > 0
        assert np.abs(its_t.astype(int) - its_j).max() <= 2, (its_t, its_j)
        if rtol == 1e-6:
            assert np.abs(wt - wj).max() <= 1e-5 * (wj.max() - wj.min())
        else:
            err_j, err_t = np.abs(wj - truth).max(), np.abs(wt - truth).max()
            assert err_t <= 1.5 * err_j + 0.1, (err_t, err_j)


@pytest.mark.parametrize("precondition", ["jacobi", "rline"])
def test_f64_refine_reaches_f64_and_matches_jax(pair, precondition):
    pj, pt = pair
    kw = dict(rtol=1e-6, maxiter=2000, f64_refine=2, solver="vmem",
              warm_start="extrapolate", precondition=precondition)
    got = tsw.make_sweep_fn(pt, dtype=torch.float32, **kw,
                            device="cpu")(KS, FS)
    assert got.dtype == torch.float64
    truth = np.asarray(jsw.make_sweep_fn(pj, dtype=jnp.float64,
                                         rtol=1e-13)(KS, FS))
    _close(got, truth)
    want = jsw.make_sweep_fn(pj, dtype=jnp.float32, **kw)(KS, FS)
    _close(got, want)


@pytest.mark.parametrize("f64_refine", [0, 1, 2],
                         ids=["f64", "refine1", "refine2"])
@pytest.mark.parametrize("precondition", ["adi", "adaptive"])
def test_vmem_adi_forms_match_jax(pair, precondition, f64_refine):
    """K2's ADI and adaptive forms through make_sweep_fn (their plain
    versions here, the Pallas kernel in interpret mode there): float64
    solves, and float32 solves inside one or two float64 refinement passes.
    Two passes reach float64 (within 1e-9 of JAX); after one, each package
    carries its float32 correction's error (~1e-5 of the trace scale on
    this problem), so the port is held to 1.5x the JAX package's own
    distance from the float64 truth, and to the float32 level of JAX."""
    pj, pt = pair
    kw = dict(solver="vmem", precondition=precondition,
              warm_start="extrapolate", rtol_wrt="r0")
    if f64_refine:
        kw.update(f64_refine=f64_refine, rtol=1e-6, maxiter=2000)
        jdt, tdt = jnp.float32, torch.float32
    else:
        kw.update(rtol=1e-10)
        jdt, tdt = jnp.float64, torch.float64
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # adi with f64_refine warns
        want = np.asarray(jsw.make_sweep_fn(pj, dtype=jdt, **kw)(KS, FS))
        got = tsw.make_sweep_fn(pt, dtype=tdt, **kw, device="cpu")(KS, FS)
    assert got.dtype == torch.float64
    if f64_refine != 1:
        _close(got, want)
        return
    truth = np.asarray(jsw.make_sweep_fn(pj, dtype=jnp.float64,
                                         rtol=1e-13)(KS, FS))
    got = got.numpy()
    err_t, err_j = np.abs(got - truth).max(), np.abs(want - truth).max()
    assert err_t <= 1.5 * err_j, (err_t, err_j)
    _close(got, want, tol=1e-4)


def test_adaptive_flags_follow_the_previous_counts(pair, monkeypatch):
    """The adaptive switch: every lane ADI at the first step (the cold
    start at maxiter), then ADI exactly where the lane's previous step (its
    last refinement pass) took more than adaptive_thresh iterations."""
    from heatflow_tpu_torch.ops import cuda_sweep
    _, pt = pair
    seen = []
    kernel = cuda_sweep.cg_batched_tol

    def spy(*args, **kw):
        x, its = kernel(*args, **kw)
        seen.append((kw["adi_flags"].clone(), its.clone()))
        return x, its

    monkeypatch.setattr(cuda_sweep, "cg_batched_tol", spy)
    ops, base_k, dt, ic, _ = tsw._sweep_ops(pt, "p_sample", torch.float64,
                                            torch.device("cpu"))
    u0 = torch.full((3,) + pt.mesh.shape, pt.ic_temp, dtype=torch.float64)
    for refine, thresh in ((0, 50), (2, 82)):
        seen.clear()
        tsw.vmem_sweep_scan(ops, KS, FS, u0, u0, 0, dtype=torch.float32,
                            ic=ic, dt=dt, num_steps=pt.num_steps,
                            base_k=base_k, fixed_iters=None, rtol=1e-6,
                            maxiter=500, extrapolate=True, adaptive=True,
                            adaptive_thresh=thresh, f64_refine=refine)
        calls = seen[::refine] if refine else seen
        assert len(seen) == pt.num_steps * max(1, refine)
        assert calls[0][0].tolist() == [1, 1, 1]
        for step in range(1, pt.num_steps):
            prev = seen[step * max(1, refine) - 1][1]     # last pass
            assert calls[step][0].tolist() == (prev > thresh).int().tolist()
        flags = torch.stack([f for f, _ in calls[1:]])
        assert 0 < int(flags.sum()) < flags.numel(), flags


def test_entry_points_default_to_the_card(pair):
    """Without a device argument the entry points run on the card: with no
    CUDA they raise, naming device='cpu', and compute nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, pt = pair
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn, run_transient
    calls = (lambda: tsw.make_sweep_fn(pt),
             lambda: tsw.make_sweep_fn_recording(pt),
             lambda: tsw.run_sweep_time_chunked(pt, KS, FS),
             lambda: make_simulate_fn(pt), lambda: run_transient(pt))
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # nothing was built for the card either
    assert not [k for k in pt.extras.get("_fn_cache", {}) if "cuda" in str(k)]


@pytest.mark.parametrize("solver", ["xla", "vmem"])
def test_nan_lane_is_poisoned_and_leaves_the_others(pair, solver):
    _, pt = pair
    fn = tsw.make_sweep_fn(pt, dtype=torch.float64, rtol=1e-8, solver=solver,
                           device="cpu")
    tr = fn(np.array([4.0, np.nan, 7.0]), np.full(3, 6e-6)).numpy()
    assert np.isfinite(tr).all(axis=(1, 2)).tolist() == [True, False, True]
    alone = fn(np.array([4.0, 7.0]), np.full(2, 6e-6)).numpy()
    assert np.array_equal(alone, tr[[0, 2]])


def test_one_config_memo_and_chunk_balance(pair):
    _, pt = pair
    fn = tsw.make_sweep_fn(pt, dtype=torch.float64, rtol=1e-10, device="cpu")
    assert tsw.make_sweep_fn(pt, dtype=torch.float64, rtol=1e-10,
                             device="cpu") is fn
    assert tsw.make_sweep_fn(pt, dtype=torch.float64, rtol=1e-9,
                             device="cpu") is not fn
    one = fn.one_config(KS[1], FS[1])
    assert torch.equal(one, fn(KS, FS)[1])
    for total in (1, 5, 39, 40, 41, 100):
        for chunk in (1, 3, 10, 25, 40, 200):
            assert tsw.balanced_chunk_len(total, chunk) == \
                jsw.balanced_chunk_len(total, chunk)


def test_normalized_oside_rmse_matches_jax(pair):
    pj, _ = pair
    rng = np.random.default_rng(2)
    traces = 300.0 + rng.uniform(0, 50, (4, 5, 2)).cumsum(axis=1)
    traces[3, :, 0] = 310.0      # flat p-side: +inf residuals
    times = np.arange(1, 6) * pj.dt
    exp_time = np.linspace(0.5, 5.5, 9) * pj.dt
    exp_o = rng.uniform(0, 1, 9)
    want_r = np.asarray(jsw.normalized_oside_residuals(
        jnp.asarray(times), jnp.asarray(traces), jnp.asarray(exp_time),
        jnp.asarray(exp_o)))
    got_r = tsw.normalized_oside_residuals(times, torch.tensor(traces),
                                           exp_time, exp_o).numpy()
    assert np.isinf(got_r[3]).all() and np.isinf(want_r[3]).all()
    np.testing.assert_allclose(got_r[:3], want_r[:3], rtol=1e-12, atol=1e-14)
    want = np.asarray(jsw.normalized_oside_rmse(
        jnp.asarray(times), jnp.asarray(traces[:3]), jnp.asarray(exp_time),
        jnp.asarray(exp_o)))
    got = tsw.normalized_oside_rmse(times, traces[:3], exp_time,
                                    exp_o).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_no_diamond_host_problem_exact():
    """The sweep configuration's host problem, at full size (243 x 1001,
    the flagship heating curve), is the JAX package's exactly."""
    cfg = T.load_config(NO_DIAMOND)
    mesh_j = J.build_structured_mesh(*J.build_layout(cfg))
    pj = j_build_problem(mesh_j, JHeating.from_csv(HEAT_CSV), cfg,
                         watcher_points=j_watch(cfg),
                         stencils=j_assemble(mesh_j, backend="numpy"))
    pt = t_build_problem(T.build_structured_mesh(*T.build_layout(cfg)),
                         THeating.from_csv(HEAT_CSV), cfg,
                         watcher_points=t_watch(cfg))
    assert pt.mesh.shape == (243, 1001)
    for name in ("K", "M", "M_proj", "G_r"):
        assert np.array_equal(getattr(pj.stencils, name),
                              getattr(pt.stencils, name)), name
    for name in ("dirichlet_mask", "heat_mask", "r_sq", "kappas", "rho_cvs",
                 "watcher_idx"):
        assert np.array_equal(getattr(pj, name), getattr(pt, name)), name
    assert (pj.dt, pj.num_steps, pj.ic_temp, pj.fwhm) == \
        (pt.dt, pt.num_steps, pt.ic_temp, pt.fwhm)
    assert np.array_equal(pj.heating.time, pt.heating.time)
    assert np.array_equal(pj.heating.temp, pt.heating.temp)


@pytest.mark.parametrize("kw", [dict(mesh=object())], ids=["mesh"])
def test_unported_options_raise(pair, kw):
    """``mesh=`` takes a ``parallel.sharding.DeviceMesh`` (P11:
    tests/test_torch_sharding.py); anything else is a TypeError."""
    _, pt = pair
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsw.make_sweep_fn(pt, **kw, device="cpu")


def test_mg_one_config_matches_the_batch_and_jax(pair):
    """one_config with precondition='mg' (the differentiable single-lane
    path) equals the batch's lane and the JAX one_config within 1e-9."""
    pj, pt = pair
    kw = dict(rtol=1e-10, solver="xla", precondition="mg")
    ft = tsw.make_sweep_fn(pt, dtype=torch.float64, **kw, device="cpu")
    fj = jsw.make_sweep_fn(pj, dtype=jnp.float64, **kw)
    one = ft.one_config(KS[1], FS[1])
    _close(one, ft(KS, FS)[1])
    _close(one, fj.one_config(KS[1], FS[1]))


def test_unported_paths_raise(pair):
    """Sharded sweeps take a ``parallel.sharding.DeviceMesh`` (P11,
    tests/test_torch_sharding.py): another ``mesh=`` is a TypeError, in
    the chunked runner as in the maker; unstructured problems, P9, go to
    their own maker (tests/test_torch_unstructured.py)."""
    _, pt = pair
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsw.run_sweep_time_chunked(pt, KS, FS, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsw.make_sweep_fn(pt, mesh=object(), device="cpu")


@pytest.mark.parametrize("kw, match", [
    (dict(solver="xla", precondition="adaptive"), "adaptive"),
    (dict(solver="vmem", precondition="zline"), "zline|rline"),
    (dict(solver="vmem", precondition="mg"), "jacobi"),
    (dict(solver="vmem", precondition="rline", fixed_iters=5), "fixed"),
    (dict(solver="xla", f64_refine=1), "vmem"),
    (dict(solver="vmem", f64_refine=1, dtype=torch.float64), "float32"),
    (dict(warm_start="extrapolate2"), "warm_start"),
    (dict(solver="tpu"), "solver")])
def test_invalid_options_raise(pair, kw, match):
    _, pt = pair
    with pytest.raises(ValueError, match=match):
        tsw.make_sweep_fn(pt, **kw, device="cpu")


def test_sweep_runs_without_jax():
    """The sweep slice imports and runs with jax, pandas and yaml blocked."""
    code = f"""
import sys
for name in ("jax", "jaxlib", "pandas", "yaml"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)
import heatflow_tpu_torch as T
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.sim import run_sweep_time_chunked
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
cfg = T.load_config({NO_DIAMOND!r})
cfg["timing"]["num_steps"] = 4
mesh = T.build_structured_mesh(*T.build_layout(cfg), size_scale=24.0)
problem = build_problem(mesh, HeatingCurve.from_csv({HEAT_CSV!r}), cfg,
                        watcher_points=coupler_watcher_points(cfg))
tr = run_sweep_time_chunked(problem, np.logspace(0, 2, 3), np.full(3, 1e-5),
                            step_chunk=3, solver="vmem", rtol=1e-4,
                            device="cpu")
assert tr.shape == (3, 4, 2) and np.isfinite(tr).all()
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "heatflow_tpu", "pandas",
                              "yaml") and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.cuda
def test_sweep_on_cuda_launches_the_kernels(pair):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from heatflow_tpu_torch.ops import cuda_sweep
    _, pt = pair
    cuda_sweep.reset_counters()
    tr = tsw.run_sweep_time_chunked(pt, KS, FS, step_chunk=3, solver="vmem",
                                    rtol=1e-4, device="cuda")
    assert np.isfinite(tr).all()
    # 5 steps at step_chunk=3: two chunks of 3 steps, one solve a step
    assert cuda_sweep.cg_batched_tol.launches_identity == 6


def test_lane_sum_is_a_sum_independent_of_the_batch():
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((5, 13, 37)))
    got = tsw.lane_sum(x)
    np.testing.assert_allclose(got.numpy(), x.sum(dim=(1, 2)).numpy(),
                               rtol=1e-13)
    for sub in ([0], [1, 3], [4, 2, 0]):
        assert torch.equal(tsw.lane_sum(x[sub]), got[sub])


def test_sweep_on_a_reloaded_mesh_varies_the_sample(tmp_path):
    """A mesh read back from its folder lists its material tags in the
    YAML's sorted-key order. The port takes the swept material's stencil
    slot by tag value (``material_index``), so a sweep on the reloaded mesh
    is bitwise the sweep on the built one; the JAX package's
    ``list(material_tags).index`` (``heatflow_tpu/sim/sweepkernel.py:360``)
    picks another material's slot there (ROADMAP §3)."""
    from heatflow_tpu.drivers.run2d import _prepare_mesh as j_prepare
    from heatflow_tpu_torch.drivers.run2d import _prepare_mesh as t_prepare
    cfg = tiny_no_diamond_cfg(coarse=3.0)
    cfg["timing"]["num_steps"] = 3
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    runs = {}
    for pkg, prepare, build, heat, sweep, kw in (
            ("t", t_prepare, t_build_problem, THeating, tsw.make_sweep_fn,
             dict(dtype=torch.float64, device="cpu")),
            ("j", j_prepare, j_build_problem, JHeating, jsw.make_sweep_fn,
             dict(dtype=jnp.float64))):
        for rebuild in (True, False):
            mesh = prepare(cfg, str(tmp_path / pkg), rebuild, "auto")
            p = build(mesh, heat(time=t, temp=temp), cfg,
                      watcher_points=t_watch(cfg))
            runs[pkg, rebuild] = np.asarray(sweep(p, fixed_iters=8,
                                                  **kw)(KS, FS))
            if pkg == "t":
                assert tsw.material_index(mesh, "p_sample") == 2
    assert list(mesh.material_tags).index("p_sample") == 4
    assert np.array_equal(runs["t", False], runs["t", True])
    _close(runs["t", True], runs["j", True])
    assert not np.allclose(runs["j", False], runs["j", True])

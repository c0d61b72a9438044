"""The port's transient slice against the JAX package: the float64 default
path (and the golden file), the float32 adaptive refinement recipe against
the Pallas kernel in interpret mode, and the options the stepper rejects."""

import os
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.ops import pallas_cg
from heatflow_tpu.ops.stencil import assemble_stencils as j_assemble
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu.sim.stepper import make_simulate_fn as j_make
from heatflow_tpu.sim.stepper import run_transient as j_run
from heatflow_tpu_torch.geometry import coupler_watcher_points as t_watch
from heatflow_tpu_torch.ops import cuda_cg
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from heatflow_tpu_torch.sim.stepper import make_simulate_fn as t_make
from heatflow_tpu_torch.sim.stepper import run_transient as t_run
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "tiny_no_diamond_f64.npz")
FLAGSHIP = os.path.join(ROOT, "cfgs", "geballe_with_diamond.yaml")
FLAGSHIP_CSV = os.path.join(ROOT, "experimental_data",
                            "geballe_heat_data.csv")
RECIPE = dict(record_gradient=False, rtol_wrt="r0", solver="vmem",
              precondition="adaptive", warm_start="extrapolate",
              f64_refine=1, maxiter=8000)


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _tiny_pair():
    """test_golden's tiny no-diamond problem, built by each package."""
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    df = synthetic_heating()
    t, temp = df["time"].to_numpy(), df["temp"].to_numpy()
    dj, mj = J.build_layout(cfg)
    pj = j_build_problem(J.build_structured_mesh(dj, mj),
                         JHeating(time=t, temp=temp), cfg,
                         watcher_points=j_watch(cfg))
    dt_, mt = T.build_layout(cfg)
    pt = t_build_problem(T.build_structured_mesh(dt_, mt),
                         THeating(time=t, temp=temp), cfg,
                         watcher_points=t_watch(cfg))
    return pj, pt


def _dac_pair(num_steps=12, size_scale=16.0):
    """The 9-material flagship cut to 20 x 72 nodes and ``num_steps``
    steps, with the flagship heating curve."""
    cfg = T.load_config(FLAGSHIP)
    cfg["timing"]["num_steps"] = num_steps
    dj, mj = J.build_layout(cfg)
    mesh_j = J.build_structured_mesh(dj, mj, size_scale=size_scale)
    pj = j_build_problem(mesh_j, JHeating.from_csv(FLAGSHIP_CSV), cfg,
                         watcher_points=j_watch(cfg),
                         stencils=j_assemble(mesh_j, backend="numpy"))
    dt_, mt = T.build_layout(cfg)
    pt = t_build_problem(T.build_structured_mesh(dt_, mt,
                                                 size_scale=size_scale),
                         THeating.from_csv(FLAGSHIP_CSV), cfg,
                         watcher_points=t_watch(cfg))
    return pj, pt


@pytest.fixture(scope="module")
def tiny_runs():
    pj, pt = _tiny_pair()
    return j_run(pj, rtol=1e-13), t_run(pt, rtol=1e-13, device="cpu")


def test_f64_default_path_matches_jax(tiny_runs):
    rj, rt = tiny_runs
    np.testing.assert_array_equal(rt.times, rj.times)
    for name in ("watcher", "band_rows", "axis_rows", "final_u"):
        assert rel_l2(getattr(rt, name), getattr(rj, name)) < 1e-8, name
    np.testing.assert_array_equal(rt.cg_iters, rj.cg_iters)
    assert rt.watcher_names == rj.watcher_names
    np.testing.assert_array_equal(rt.band_centers, rj.band_centers)


def test_f64_default_path_passes_golden(tiny_runs):
    _, rt = tiny_runs
    g = np.load(GOLDEN)
    np.testing.assert_allclose(rt.times, g["times"], rtol=1e-14)
    scale = np.abs(g["watcher"]).max()
    assert np.abs(rt.watcher - g["watcher"]).max() / scale < 1e-9
    np.testing.assert_allclose(rt.band_centers, g["band_centers"],
                               rtol=1e-14)
    np.testing.assert_allclose(rt.axis_z, g["axis_z"], rtol=1e-14)
    assert np.abs(rt.band_rows - g["band"]).max() \
        / np.abs(g["band"]).max() < 1e-6
    assert np.abs(rt.axis_rows - g["axis"]).max() \
        / np.abs(g["axis"]).max() < 1e-6


def test_f64_transient_matches_the_scipy_fem():
    """The port's float64 transient against an independent scipy LU
    backward-Euler P1 FEM on the same triangulation (the pattern of
    tests/test_stepper.py): fields and watcher traces within 1e-8 rel-L2,
    the band rows of the projected radial gradient within 2e-5."""
    import math
    from tests import reference_fem
    _, pt = _tiny_pair()
    res = t_run(pt, rtol=1e-13, record_fields=True, device="cpu")
    mesh = pt.mesh
    nodes = mesh.node_coords()
    tris, tri_tags = mesh.triangles()
    ck, cr = pt.kappas[tri_tags - 1], pt.rho_cvs[tri_tags - 1]
    ic = pt.ic_temp
    dir_f = pt.dirichlet_mask.astype(float).ravel()
    profile = (np.exp(-4.0 * math.log(2.0) / pt.fwhm ** 2 * pt.r_sq)
               * pt.heat_mask.astype(float)).ravel()
    heat_t, heat_T = pt.heating.time, pt.heating.temp
    off = heat_T[0] - ic

    def g_of_t(t):
        amp = np.interp(t, heat_t, heat_T) - off
        return ic * dir_f + (amp - ic) * profile

    watch_nodes = [mesh.nearest_node(*p)
                   for p in t_watch(tiny_no_diamond_cfg(coarse=2.0)).values()]
    ref = reference_fem.backward_euler(
        nodes, tris, ck, cr, pt.dt, pt.num_steps, pt.dirichlet_mask.ravel(),
        g_of_t, ic, watch_nodes=watch_nodes, project_gradient=True)
    ours = res.fields.reshape(res.fields.shape[0], -1)
    assert rel_l2(ours, ref["u"]) < 1e-8
    assert np.abs(ours - ref["u"]).max() / np.abs(ref["u"]).max() < 2e-8
    assert rel_l2(res.watcher, ref["watch"]) < 1e-8
    rad = pt.radial
    vals = ref["grad_r"][:, rad.band_nodes]
    sums = np.zeros((vals.shape[0], len(rad.bin_counts)))
    np.add.at(sums, (slice(None), rad.band_bin_ids), vals)
    band_ref = sums / np.where(rad.bin_counts > 0, rad.bin_counts, 1)
    scale = np.abs(band_ref).max()
    # gradients amplify the solve tolerance by ~1/h (tests/test_stepper.py)
    assert np.abs(res.band_rows - band_ref).max() / scale < 2e-5


@pytest.mark.parametrize("precondition", ["rline", "zline", "adi"])
def test_f64_line_preconditioned_paths_match_jax(precondition):
    pj, pt = _tiny_pair()
    kw = dict(rtol=1e-12, precondition=precondition, record_gradient=True,
              warm_start="extrapolate")
    yj = j_make(pj, **kw)()
    yt = t_make(pt, **kw, device="cpu")()
    for name in ("watch", "band", "axis", "final_u"):
        assert rel_l2(yt[name].numpy(), yj[name]) < 1e-8, name
    np.testing.assert_array_equal(yt["cg_iters"].numpy(), yj["cg_iters"])


def _interp_tol(*a, **kw):
    kw["interpret"] = True
    return _ORIG_TOL(*a, **kw)


_ORIG_TOL = pallas_cg.cg_vmem_tol


@pytest.fixture(scope="module")
def dac_runs():
    """The bench recipe on the small 9-material problem: JAX (Pallas in
    interpret mode) and the port at two tolerances, plus the float64
    reference traces."""
    pj, pt = _dac_pair()
    truth = np.asarray(j_make(pj, rtol=1e-11, record_gradient=False)()
                       ["watch"])
    out = {"truth": truth}
    for rtol in (1e-6, 1e-4):
        with mock.patch("heatflow_tpu.ops.pallas_cg.cg_vmem_tol",
                        _interp_tol):
            yj = j_make(pj, dtype=jnp.float32, rtol=rtol, **RECIPE)()
        forms = []
        orig_ref = cuda_cg.cg_tol_reference

        def spy(*a, **kw):
            forms.append("adi" if kw.get("pcr_z") is not None else "rline")
            return orig_ref(*a, **kw)

        with mock.patch.object(cuda_cg, "cg_tol_reference", spy):
            yt = t_make(pt, dtype=torch.float32, rtol=rtol, **RECIPE,
                        device="cpu")()
        out[rtol] = (yj, yt, forms)
    return out


def test_recipe_tight_tolerance_matches_jax(dac_runs):
    yj, yt, _ = dac_runs[1e-6]
    ij, it = np.asarray(yj["cg_iters"]), yt["cg_iters"].numpy()
    assert np.abs(it.astype(int) - ij.astype(int)).max() <= 2, (it, ij)
    wj, wt = np.asarray(yj["watch"]), yt["watch"].numpy()
    assert np.abs(wt - wj).max() <= 1e-5 * (wj.max() - wj.min())


def test_recipe_bench_tolerance_accuracy(dac_runs):
    yj, yt, _ = dac_runs[1e-4]
    truth = dac_runs["truth"]
    err_j = np.abs(np.asarray(yj["watch"]) - truth).max()
    err_t = np.abs(yt["watch"].numpy() - truth).max()
    assert np.isfinite(yt["watch"].numpy()).all()
    assert err_t <= 1.5 * err_j + 0.1, (err_t, err_j)


def test_recipe_switches_adi_then_rline(dac_runs):
    """Step 1 (cold start) runs the ADI form; a shallow step runs r-line;
    every deep step is followed by an ADI step."""
    for rtol in (1e-6, 1e-4):
        _, yt, forms = dac_runs[rtol]
        iters = yt["cg_iters"].numpy()
        assert len(forms) == len(iters)
        assert forms[0] == "adi"
        assert "rline" in forms[1:]
        want = ["adi"] + ["adi" if i > 100 else "rline" for i in iters[:-1]]
        assert forms == want


def test_auto_resolves_to_eager_on_cpu():
    _, pt = _tiny_pair()
    fn = t_make(pt, dtype=torch.float32, solver="auto", rtol=1e-5,
                record_gradient=False, device="cpu")
    assert fn.use_vmem is False
    with pytest.raises(ValueError, match="adaptive"):
        t_make(pt, dtype=torch.float32, solver="auto",
               precondition="adaptive", device="cpu")
    with pytest.raises(ValueError, match="zline"):
        t_make(pt, dtype=torch.float32, solver="vmem", precondition="zline",
               device="cpu")
    with pytest.raises(ValueError, match="float32"):
        t_make(pt, dtype=torch.float64, f64_refine=1, device="cpu")


@pytest.mark.parametrize("kw", [{"mesh": object()}], ids=["mesh"])
def test_unported_options_raise(kw):
    _, pt = _tiny_pair()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_make(pt, **kw, device="cpu")


@pytest.mark.parametrize("name", ["plot_temperature_curves"])
def test_unported_functions_raise(name):
    from heatflow_tpu_torch.analysis import compare
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(compare, name)(None)


# float64 eager options: the same recurrences in both packages, so the traces
# agree to 1e-8 rel-L2 (summation order only) and the counts exactly
F64_OPTIONS = {
    "mg": dict(precondition="mg", rtol=1e-12),
    "mg_extrapolate": dict(precondition="mg", rtol=1e-12,
                           warm_start="extrapolate"),
    "fixed_iters": dict(fixed_iters=60),
    "fixed_iters_rline": dict(fixed_iters=25, precondition="rline"),
    "extrapolate2": dict(warm_start="extrapolate2", rtol=1e-12),
    "extrapolate2_rline": dict(warm_start="extrapolate2", rtol=1e-12,
                               precondition="rline"),
}


@pytest.mark.parametrize("name", list(F64_OPTIONS))
def test_f64_options_match_jax(name):
    pj, pt = _tiny_pair()
    kw = dict(F64_OPTIONS[name], record_gradient=True)
    yj = j_make(pj, **kw)()
    yt = t_make(pt, **kw, device="cpu")()
    for key in ("watch", "band", "axis", "final_u"):
        assert rel_l2(yt[key].numpy(), yj[key]) < 1e-8, key
    ij, it = np.asarray(yj["cg_iters"]), yt["cg_iters"].numpy()
    # the V-cycle's sums run in another order: a stop may move by one
    assert np.abs(it.astype(int) - ij.astype(int)).max() \
        <= (1 if "mg" in name else 0), (it, ij)
    assert np.array_equal(np.asarray(yj["proj_iters"]),
                          yt["proj_iters"].numpy())


@pytest.mark.parametrize("precondition,solver",
                         [("rline", "xla"), ("rline", "vmem"),
                          ("adaptive", "vmem")])
def test_inner_seed_carry_matches_jax(precondition, solver):
    """float32 + f64_refine=2 with the carried inner seed, eager and through
    the kernel's plain version (JAX: Pallas in interpret mode). The state is
    float64 and each pass's residual is taken in float64, so the two traces
    agree far below the float32 solve's own error: 1e-6 of the trace's
    range; counts within 2 + 2 % a step (two float32 solves of ~150
    iterations each, whose sums run in another order)."""
    pj, pt = _dac_pair(num_steps=6)
    kw = dict(rtol=1e-5, f64_refine=2, inner_seed="carry",
              precondition=precondition, solver=solver,
              record_gradient=False, maxiter=4000)
    with mock.patch("heatflow_tpu.ops.pallas_cg.cg_vmem_tol", _interp_tol):
        yj = j_make(pj, dtype=jnp.float32, **kw)()
    yt = t_make(pt, dtype=torch.float32, **kw, device="cpu")()
    wj, wt = np.asarray(yj["watch"]), yt["watch"].numpy()
    assert np.abs(wt - wj).max() <= 1e-6 * (wj.max() - wj.min())
    ij, it = np.asarray(yj["cg_iters"]), yt["cg_iters"].numpy()
    assert (np.abs(it.astype(int) - ij.astype(int))
            <= 2 + 0.02 * ij).all(), (it, ij)
    # and the carried seed is not the zero seed's trajectory
    y0 = t_make(pt, dtype=torch.float32, **dict(kw, inner_seed="zero"),
                device="cpu")()
    assert not np.array_equal(y0["cg_iters"].numpy(), it)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_make_step_fn_matches_jax(dtype):
    from heatflow_tpu.sim.stepper import make_step_fn as j_step
    from heatflow_tpu_torch.sim.stepper import make_step_fn as t_step
    pj, pt = _tiny_pair()
    sj = j_step(pj, dtype=getattr(jnp, dtype), fixed_iters=40)
    st = t_step(pt, dtype=getattr(torch, dtype), fixed_iters=40,
                device="cpu")
    rng = np.random.default_rng(5)
    u = np.full(pt.mesh.shape, pt.ic_temp) + rng.uniform(0, 3, pt.mesh.shape)
    uj, ut = u, u
    for n in range(3):
        t = (n + 1) * pt.dt
        uj = np.asarray(sj(jnp.asarray(uj, getattr(jnp, dtype)), t))
        ut = st(ut, t).numpy()
    # the same 40 fixed iterations: summation order only (float32: 1e-4)
    assert rel_l2(ut, uj) < (1e-8 if dtype == "float64" else 1e-4)
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        if torch.cuda.is_available():
            raise RuntimeError("cuda present")
        t_step(pt)


MGZ_CASES = {
    "mgz1": dict(precondition="mgz", mgz_sweeps=1),
    "mgz2": dict(precondition="mgz", mgz_sweeps=2),
    "mgz1_refined": dict(precondition="mgz", mgz_sweeps=1, f64_refine=1,
                         warm_start="extrapolate"),
    "cheb3": dict(vmem_cheb_degree=3),
    "cheb2_extrapolate": dict(vmem_cheb_degree=2, warm_start="extrapolate"),
}


@pytest.mark.parametrize("name", list(MGZ_CASES))
def test_kernel_forms_match_jax_stepper(name):
    """precondition='mgz' and vmem_cheb_degree on solver='vmem' in float32:
    the port's plain versions against the JAX stepper with its kernel in
    interpret mode. Unrefined float32 traces carry a rounding floor of
    ~0.1 K whatever the implementation, so each is held to the float64
    truth: the port within 1.5x the JAX trace's error + 0.1 K (the bound of
    test_recipe_bench_tolerance_accuracy); the refined case, whose state is
    float64, to 2e-4 of the trace's range of the JAX trace itself. Counts
    within 2 + 10 % a step (float32 solves near their floor)."""
    pj, pt = _dac_pair(num_steps=5)
    kw = dict(MGZ_CASES[name], rtol=1e-5, solver="vmem",
              record_gradient=False, maxiter=4000)
    with mock.patch("heatflow_tpu.ops.pallas_cg.cg_vmem_tol", _interp_tol):
        yj = j_make(pj, dtype=jnp.float32, **kw)()
    yt = t_make(pt, dtype=torch.float32, **kw, device="cpu")()
    wj, wt = np.asarray(yj["watch"]), yt["watch"].numpy()
    assert np.isfinite(wt).all()
    if kw.get("f64_refine"):
        assert np.abs(wt - wj).max() <= 2e-4 * (wj.max() - wj.min())
    else:
        truth = np.asarray(j_make(pj, rtol=1e-11, record_gradient=False)()
                           ["watch"])
        err_j, err_t = np.abs(wj - truth).max(), np.abs(wt - truth).max()
        assert err_t <= 1.5 * err_j + 0.1, (err_t, err_j)
    ij, it = np.asarray(yj["cg_iters"]), yt["cg_iters"].numpy()
    assert (np.abs(it.astype(int) - ij.astype(int))
            <= 2 + 0.1 * ij).all(), (it, ij)


def test_mgz_cuts_rline_iterations_and_refuses_overrides():
    _, pt = _dac_pair(num_steps=4)
    kw = dict(dtype=torch.float32, rtol=1e-5, solver="vmem",
              record_gradient=False, device="cpu")
    fn = t_make(pt, precondition="mgz", **kw)
    it_mgz = fn()["cg_iters"].numpy().sum()
    it_rline = t_make(pt, precondition="rline", **kw)()["cg_iters"] \
        .numpy().sum()
    assert it_mgz < 0.5 * it_rline, (it_mgz, it_rline)
    for over in (dict(kappas=pt.kappas), dict(rho_cvs=pt.rho_cvs)):
        with pytest.raises(ValueError, match="default coefficients"):
            fn(**over)


@pytest.mark.parametrize("kw,match", [
    (dict(precondition="mgz", solver="xla"), "mgz"),
    (dict(precondition="mgz", solver="vmem", vmem_cheb_degree=2,
          dtype=torch.float32), "cheb"),
    (dict(precondition="adaptive", solver="vmem", vmem_cheb_degree=2,
          dtype=torch.float32), "cheb"),
    (dict(f64_refine=1, dtype=torch.float32, vmem_cheb_degree=2), "cheb"),
    (dict(f64_refine=1, dtype=torch.float32, precondition="mg"), "mg"),
    (dict(f64_refine=1, dtype=torch.float32, fixed_iters=5), "fixed_iters"),
    (dict(precondition="mg", solver="vmem"), "mg"),
    (dict(inner_seed="keep"), "inner_seed"),
    (dict(warm_start="cubic"), "warm_start"),
], ids=["mgz_eager", "mgz_cheb", "adaptive_cheb", "refine_cheb", "refine_mg",
        "refine_fixed", "mg_vmem", "inner_seed", "warm_start"])
def test_option_refusals(kw, match):
    _, pt = _tiny_pair()
    with pytest.raises(ValueError, match=match):
        t_make(pt, **kw, device="cpu")


def test_mg_auto_resolves_to_eager_and_rline_cheb_raises():
    _, pt = _tiny_pair()
    fn = t_make(pt, dtype=torch.float32, solver="auto", precondition="mg",
                rtol=1e-5, record_gradient=False, device="cpu")
    assert fn.use_vmem is False and fn.mg is not None
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_make(pt, dtype=torch.float32, solver="vmem", precondition="rline",
               vmem_cheb_degree=2, record_gradient=False, device="cpu")()


def test_simulate_module_fields_and_overrides():
    """simulate() takes material, FWHM, initial-field and source overrides
    like the JAX function, records fields, and is memoized per problem."""
    pj, pt = _tiny_pair()
    kw = dict(rtol=1e-12, record_gradient=False, record_fields=True)
    fn = t_make(pt, **kw, device="cpu")
    assert isinstance(fn, torch.nn.Module) and t_make(pt, **kw,
                                                      device="cpu") is fn
    assert fn.K.dtype == torch.float64
    rng = np.random.default_rng(11)
    kappas = pt.kappas * rng.uniform(0.8, 1.2, len(pt.kappas))
    u0 = np.full(pt.mesh.shape, pt.ic_temp) + rng.uniform(0, 5,
                                                          pt.mesh.shape)
    source = rng.uniform(0, 1e12, pt.mesh.shape)
    args = (kappas, pt.rho_cvs * 1.1, pt.fwhm * 0.9, u0, 1e-7, source)
    yt = fn(*args)
    yj = j_make(pj, **kw)(*args)
    assert yt["field"].shape == (pt.num_steps,) + pt.mesh.shape
    for name in ("watch", "field", "final_u", "times"):
        assert rel_l2(yt[name].numpy(), yj[name]) < 1e-8, name


@pytest.mark.cuda
def test_recipe_on_cuda_launches_both_forms():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, pt = _dac_pair(num_steps=12)
    fn = t_make(pt, dtype=torch.float32, device="cuda", rtol=1e-4,
                **dict(RECIPE, solver="auto"))
    assert fn.use_vmem
    cuda_cg.reset_counters()
    ys = fn()
    assert torch.isfinite(ys["watch"]).all()
    assert cuda_cg.cg_tol.launches_adi >= 1
    assert cuda_cg.cg_tol.launches_rline >= 1

"""The port's gradient-recording sweeps against the JAX package: the Kv-free
form of the batched tolerance kernel (the mass projection; the JAX Pallas
kernel in interpret mode), ``make_sweep_fn_recording`` in both solvers, in
float64, under ``f64_refine`` and in the sweep driver's float32 recipe, and
the NaN-lane convention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heatflow_tpu as J
import heatflow_tpu_torch as T
from heatflow_tpu.geometry import coupler_watcher_points as j_watch
from heatflow_tpu.ops.pallas_cg import cg_vmem_batched_tol
from heatflow_tpu.sim import sweepkernel as jsw
from heatflow_tpu.sim.bc import HeatingCurve as JHeating
from heatflow_tpu.sim.problem import build_problem as j_build_problem
from heatflow_tpu_torch.geometry import coupler_watcher_points as t_watch
from heatflow_tpu_torch.ops import cuda_sweep
from heatflow_tpu_torch.ops.stencil import apply_stencil
from heatflow_tpu_torch.sim import sweepkernel as tsw
from heatflow_tpu_torch.sim.bc import HeatingCurve as THeating
from heatflow_tpu_torch.sim.problem import build_problem as t_build_problem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

KS = np.array([2.0, 3.8, 7.5])
FS = np.array([4e-6, 6e-6, 9e-6])
FAMS = ("watch", "band", "axis")
F64_TOL = 1e-9     # float64 families, relative to each family's scale


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


def _families(ys):
    return {k: np.asarray(ys[k]) for k in FAMS}


def _close(got, want, tol):
    """Every family within ``tol`` (a float, or a dict by family) of the
    reference's largest magnitude in that family."""
    for k in FAMS:
        t = tol[k] if isinstance(tol, dict) else tol
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.isfinite(g).all(), k
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= t, (k, err, t)


def test_kv_free_plain_version_matches_jax_kernel(pair):
    """The projection system of every lane through the Kv-free form, float64:
    the plain version against the JAX Pallas kernel (interpret mode) with a
    NaN lane, an rtol-2 lane, per-lane rtol and one shared (Nz, Nr) scaling
    plane: x within 1e-10, counts within 1."""
    _, pt = pair
    st = pt.stencils
    nz, nr = pt.mesh.shape
    rng = np.random.default_rng(3)
    Mp, Gr = st.M_proj, st.G_r
    s_mp = 1.0 / np.sqrt(np.where(Mp[0] > 0, Mp[0], 1.0))
    u = 300.0 + rng.uniform(0.0, 500.0, (5, nz, nr)).cumsum(axis=2)
    b = s_mp * np.asarray(apply_stencil(torch.tensor(Gr), torch.tensor(u)))
    x0 = rng.standard_normal((5, nz, nr)) * np.abs(b).mean()
    b[1, 3, 4] = np.nan
    rtol = np.array([1e-11, 1e-10, 1e-9, 2.0, 1e-12])
    want_x, want_it = cg_vmem_batched_tol(
        jnp.asarray(Mp), None, jnp.zeros(5), jnp.broadcast_to(
            jnp.asarray(s_mp), (5, nz, nr)), jnp.asarray(b),
        jnp.asarray(x0), jnp.asarray(rtol), maxiter=400, interpret=True,
        rtol_wrt="b")
    t = lambda a: torch.tensor(np.asarray(a))
    got_x, got_it = cuda_sweep.cg_batched_tol(
        t(Mp), None, None, t(s_mp), t(b), t(x0), t(rtol), maxiter=400,
        rtol_wrt="b")
    want_x, want_it = np.asarray(want_x), np.asarray(want_it)
    got_x, got_it = got_x.numpy(), got_it.numpy()
    assert got_it[1] == 0 and np.isnan(got_x[1]).all()
    assert np.isnan(want_x[1]).all()
    assert got_it[3] == want_it[3] == 0
    assert np.array_equal(got_x[3], x0[3])
    live = [0, 2, 3, 4]
    assert np.abs(got_it[live].astype(int) - want_it[live]).max() <= 1
    assert got_it[0] > got_it[2] > 0      # tighter rtol, more iterations
    scale = np.abs(want_x[live]).max()
    assert np.abs(got_x[live] - want_x[live]).max() <= 1e-10 * scale
    # the same solve with the plane broadcast per lane
    x_b, it_b = cuda_sweep.cg_batched_tol(
        t(Mp), None, None, t(np.broadcast_to(s_mp, (5, nz, nr)).copy()),
        t(b), t(x0), t(rtol), maxiter=400, rtol_wrt="b")
    assert torch.equal(it_b, torch.tensor(got_it))
    np.testing.assert_array_equal(x_b.numpy(), got_x)


@pytest.mark.parametrize("solver, precondition, warm_start", [
    ("vmem", "jacobi", "previous"), ("vmem", "rline", "extrapolate"),
    ("xla", "jacobi", "extrapolate"), ("xla", "rline", "previous")])
def test_recording_matches_jax_f64(pair, solver, precondition, warm_start):
    pj, pt = pair
    kw = dict(rtol=1e-10, solver=solver, precondition=precondition,
              warm_start=warm_start)
    want = jsw.make_sweep_fn_recording(pj, dtype=jnp.float64, **kw)(KS, FS)
    its, pits = [], []
    got = tsw.make_sweep_fn_recording(pt, dtype=torch.float64, **kw,
                                      device="cpu")(
        KS, FS, iters_out=its, proj_iters_out=pits)
    assert all(got[k].dtype == torch.float64 for k in FAMS)
    assert got["band"].shape == (3, pt.num_steps, len(pt.radial.bin_counts))
    assert got["axis"].shape == (3, pt.num_steps, pt.mesh.shape[0])
    _close(_families(got), _families(want), F64_TOL)
    np.testing.assert_array_equal(got["times"], want["times"])
    assert len(its) == len(pits) == pt.num_steps
    assert all(p.shape == (3,) and int(p.min()) > 0 for p in pits)


def test_f64_refine_recording(pair):
    """f64_refine=2 (float32 inner solves, the projection in float32), held
    to the JAX package's refined run and to a converged float64 recording:
    watch within 1e-9 (refined to float64), band within 1e-4 and axis
    within 1e-3 of their scale (the float32 projection's rounding,
    amplified ~1/h; measured here: port vs JAX 1.2e-5 / 3.3e-4, JAX vs
    float64 6.6e-6 / 2.0e-4)."""
    pj, pt = pair
    kw = dict(rtol=1e-6, maxiter=2000, f64_refine=2, solver="vmem",
              warm_start="extrapolate", precondition="rline")
    got = _families(tsw.make_sweep_fn_recording(pt, dtype=torch.float32,
                                                **kw, device="cpu")(KS, FS))
    assert got["watch"].dtype == np.float64
    assert got["band"].dtype == np.float32    # the float32 projection
    want = _families(jsw.make_sweep_fn_recording(pj, dtype=jnp.float32,
                                                 **kw)(KS, FS))
    tol = dict(watch=1e-9, band=1e-4, axis=1e-3)
    _close(got, want, tol)
    truth = _families(tsw.make_sweep_fn_recording(
        pt, dtype=torch.float64, rtol=1e-12, solver="vmem",
        device="cpu")(KS, FS))
    _close(got, truth, tol)


def test_f32_default_recipe_matches_jax(pair):
    """The sweep driver's float32 recording recipe (r-line, 'extrapolate',
    rtol 1e-5 wrt ||b||, projection rtol 1e-11), plain versions here and the
    Pallas kernels in interpret mode there, each held to the float64 run of
    the same recipe (the two packages' float64 runs agree within 1e-9).
    Stopped at 1e-5 ||b||, a float32 run lands a few iterations from the
    float64 one, and the gradient families amplify that difference ~1/h
    (measured here, JAX's float32 run: watch 2.3e-4, band 3.2e-2, axis 0.25
    of each family's largest value). So the port's distance must stay
    within 2x JAX's + a margin on the ladder of
    tests/test_recording_precondition.py:122-131 (watch 1e-3, band 1e-2,
    axis 5e-2), and its watch traces within 1e-3 of JAX's."""
    pj, pt = pair
    kw = dict(rtol=1e-5, solver="vmem", precondition="rline",
              warm_start="extrapolate", proj_rtol=1e-11)
    got = _families(tsw.make_sweep_fn_recording(pt, dtype=torch.float32,
                                                **kw, device="cpu")(KS, FS))
    want = _families(jsw.make_sweep_fn_recording(pj, dtype=jnp.float32,
                                                 **kw)(KS, FS))
    ref = _families(tsw.make_sweep_fn_recording(pt, dtype=torch.float64,
                                                **kw, device="cpu")(KS, FS))
    ref_j = _families(jsw.make_sweep_fn_recording(pj, dtype=jnp.float64,
                                                  **kw)(KS, FS))
    _close(ref, ref_j, F64_TOL)
    margin = dict(watch=1e-3, band=1e-2, axis=5e-2)
    for k in FAMS:
        assert np.isfinite(got[k]).all(), k
        scale = np.abs(ref[k]).max()
        err_t = np.abs(got[k] - ref[k]).max() / scale
        err_j = np.abs(want[k] - ref[k]).max() / scale
        assert err_t <= 2.0 * err_j + margin[k], (k, err_t, err_j)
    watch_gap = np.abs(got["watch"] - want["watch"]).max()
    assert watch_gap <= 1e-3 * np.abs(want["watch"]).max()


@pytest.mark.parametrize("solver", ["vmem", "xla"])
def test_nan_lane_poisons_only_itself(pair, solver):
    _, pt = pair
    fn = tsw.make_sweep_fn_recording(pt, dtype=torch.float64, rtol=1e-8,
                                     solver=solver, device="cpu")
    ys = _families(fn(np.array([4.0, np.nan, 7.0]), np.full(3, 6e-6)))
    for k in FAMS:
        assert np.isnan(ys[k][1]).all(), k
        assert np.isfinite(ys[k][[0, 2]]).all(), k
    alone = _families(fn(np.array([4.0, 7.0]), np.full(2, 6e-6)))
    for k in FAMS:
        np.testing.assert_array_equal(alone[k], ys[k][[0, 2]])


def test_recording_memo_metadata_and_rejections(pair):
    _, pt = pair
    fn = tsw.make_sweep_fn_recording(pt, dtype=torch.float64, rtol=1e-9,
                                     device="cpu")
    assert tsw.make_sweep_fn_recording(pt, dtype=torch.float64,
                                       rtol=1e-9, device="cpu") is fn
    assert tsw.make_sweep_fn_recording(pt, dtype=torch.float64, rtol=1e-9,
                                       solver="vmem", device="cpu") is not fn
    np.testing.assert_array_equal(fn.band_centers, pt.radial.bin_centers)
    np.testing.assert_array_equal(fn.axis_z, pt.radial.axis_z)
    assert fn.watcher_names == list(pt.watcher_names)
    for kw, err, match in (
            (dict(mesh=object()), TypeError, "DeviceMesh"),
            (dict(solver="vmem", precondition="rline", fixed_iters=5),
             ValueError, "tolerance-based"),
            (dict(solver="tpu"), ValueError, "solver")):
        with pytest.raises(err, match=match):
            tsw.make_sweep_fn_recording(pt, **kw, device="cpu")


@pytest.mark.parametrize("precondition", ["adi", "adaptive"])
def test_recording_vmem_adi_forms_match_jax(pair, precondition):
    """Recording sweeps with K2's ADI and adaptive forms (the plain versions
    here, the Pallas kernel in interpret mode there): every family within
    1e-9 of the JAX package's in float64."""
    pj, pt = pair
    kw = dict(rtol=1e-10, solver="vmem", precondition=precondition,
              warm_start="extrapolate")
    want = _families(jsw.make_sweep_fn_recording(pj, dtype=jnp.float64,
                                                 **kw)(KS, FS))
    got = _families(tsw.make_sweep_fn_recording(pt, dtype=torch.float64,
                                                **kw, device="cpu")(KS, FS))
    _close(got, want, 1e-9)


def test_band_average_is_the_binned_mean(pair):
    """The band rows' fixed-order pairwise sums equal the bin means of an
    index_add_, and a lane's rows do not depend on the batch."""
    from heatflow_tpu_torch.sim.problem import band_average
    _, pt = pair
    d = pt.device_arrays(torch.float64, "cpu")
    flat = torch.tensor(np.random.default_rng(6).standard_normal(
        (4, pt.mesh.num_nodes)))
    got = band_average(flat, d["band_slots"], d["band_fill"],
                       d["bin_counts"])
    want = torch.zeros(4, len(pt.radial.bin_counts), dtype=torch.float64)
    want.index_add_(1, d["band_bins"], flat[:, d["band_nodes"]])
    torch.testing.assert_close(got, want / d["bin_counts"], rtol=1e-13,
                               atol=1e-13)
    assert int(d["band_fill"].sum()) == len(pt.radial.band_nodes)
    assert torch.equal(band_average(flat[2], d["band_slots"], d["band_fill"],
                                    d["bin_counts"]), got[2])


def test_kv_free_operand_checks(pair):
    """The batch check takes Kv = dks = None and one shared scaling plane,
    and refuses Kv without dks."""
    _, pt = pair
    nz, nr = pt.mesh.shape
    f32 = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    Mp, plane, b = f32(7, nz, nr), f32(nz, nr), f32(3, nz, nr)
    assert cuda_sweep._check_batch(Mp, None, None, plane, {"b": b}) == \
        (3, nz, nr)
    with pytest.raises(ValueError, match="both or neither"):
        cuda_sweep._check_batch(Mp, Mp, None, plane, {"b": b})
    with pytest.raises(ValueError, match="shape"):
        cuda_sweep._check_batch(Mp, None, None, f32(nz, nr - 1), {"b": b})


@pytest.mark.cuda
def test_cuda_kv_free_kernel_matches_plain(pair):
    """The Kv-free kernel in float32 against its plain version on the card:
    the same per-lane counts, x within 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    _, pt = pair
    d = pt.device_arrays(torch.float32, "cuda")
    Mp = d["M_proj"].contiguous()
    s_mp = torch.rsqrt(torch.where(Mp[0] > 0, Mp[0], torch.ones_like(
        Mp[0]))).contiguous()
    u = torch.rand((4,) + pt.mesh.shape, device="cuda") * 500.0 + 300.0
    b = (s_mp * apply_stencil(d["G_r"], u)).contiguous()
    x0 = torch.zeros_like(b)
    cuda_sweep.reset_counters()
    x_k, it_k = cuda_sweep.cg_batched_tol(Mp, None, None, s_mp, b, x0,
                                          1e-11, maxiter=400)
    x_p, it_p = cuda_sweep.cg_batched_tol_reference(Mp, None, None, s_mp, b,
                                                    x0, 1e-11, maxiter=400)
    assert cuda_sweep.cg_batched_tol.launches_no_kv == 1
    assert torch.equal(it_k, it_p)
    assert float((x_k - x_p).abs().max() / x_p.abs().max()) <= 1e-5

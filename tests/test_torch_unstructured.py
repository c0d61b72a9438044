"""The port's unstructured path against the JAX package's, in float64 on the
CPU: the mesh generator, ``.msh`` I/O, the node masks, the ELL assembly and
its lattice stencils (bitwise), the ELL products, the transient on both
operator forms (the eager path and the kernels' plain versions), its
gradients, the sweeps and the steady solve. The inputs are built once with
numpy (the perturbed triangulation of ``tiny_no_diamond_cfg(coarse=2.0)``,
seed 7, as tests/test_unstructured_firstclass.py builds it) and handed to
both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatflow_tpu.geometry import build_layout, coupler_watcher_points
from heatflow_tpu.mesh import msh_io as jmsh
from heatflow_tpu.mesh.unstructured_gen import (
    build_unstructured_mesh as jbuild, perturb_structured_mesh as jperturb)
from heatflow_tpu.ops import ell as jell, overlay as jov
from heatflow_tpu.sim import bc as jbc, sweepkernel as jsw, unstructured as ju
from heatflow_tpu.mesh.structured import build_structured_mesh as jstruct
from heatflow_tpu_torch import geometry as tgeo
from heatflow_tpu_torch.mesh import msh_io as tmsh
from heatflow_tpu_torch.mesh.structured import build_structured_mesh
from heatflow_tpu_torch.mesh.unstructured_gen import (
    build_unstructured_mesh as tbuild, perturb_structured_mesh as tperturb)
from heatflow_tpu_torch.ops import ell as tell, overlay as tov
from heatflow_tpu_torch.sim import bc as tbc, unstructured as tu
from heatflow_tpu_torch.sim import sweepkernel as tsw
from tests import reference_fem
from tests.fixtures import synthetic_heating, tiny_no_diamond_cfg

torch.set_num_threads(1)

PARITY = 1e-8          # float64 traces, rel-L2 (BASELINE.md:24)
KS = np.array([2.0, 3.8, 9.0, 20.0])
FS = np.array([5e-6, 6e-6, 7e-6, 8e-6])


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _problems(cfg, jmesh, heating):
    """The JAX and the port's problem on the same mesh arrays."""
    tmesh = tmsh.UnstructuredMesh(
        nodes=jmesh.nodes.copy(), cells=jmesh.cells.copy(),
        cell_tags=jmesh.cell_tags.copy(),
        material_tags=dict(jmesh.material_tags),
        grid_overlay=None if jmesh.grid_overlay is None else dict(
            jmesh.grid_overlay))
    wp = coupler_watcher_points(cfg)
    jp = ju.build_problem_unstructured(
        jmesh, jbc.HeatingCurve(time=heating[0], temp=heating[1]), cfg,
        watcher_points=wp)
    tp = tu.build_problem_unstructured(
        tmesh, tbc.HeatingCurve(time=heating[0], temp=heating[1]), cfg,
        watcher_points=wp)
    return jp, tp


@pytest.fixture(scope="module")
def case():
    cfg = tiny_no_diamond_cfg(coarse=2.0)
    cfg["timing"]["num_steps"] = 5
    domain, mats = build_layout(cfg)
    jmesh = jbuild(domain, mats, jitter=0.25, seed=7)
    df = synthetic_heating()
    heating = (df["time"].to_numpy(), df["temp"].to_numpy())
    jp, tp = _problems(cfg, jmesh, heating)
    bare = dataclasses.replace(jmesh, grid_overlay=None)
    jpe, tpe = _problems(cfg, bare, heating)
    return dict(cfg=cfg, domain=domain, mats=mats, jmesh=jmesh,
                heating=heating, overlay=(jp, tp), ell=(jpe, tpe))


# ---------------------------------------------------------------------------
# host side: bitwise the JAX package's arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jitter, seed, shuffle", [
    (0.25, 7, True), (0.25, 3, True), (0.1, 0, False), (0.0, 5, True)])
def test_generator_bitwise(case, jitter, seed, shuffle):
    tdom, tmats = tgeo.build_layout(case["cfg"])
    mj = jperturb(jstruct(case["domain"], case["mats"]), jitter=jitter,
                  seed=seed, shuffle=shuffle)
    mt = tperturb(build_structured_mesh(tdom, tmats), jitter=jitter,
                  seed=seed, shuffle=shuffle)
    for name in ("nodes", "cells", "cell_tags"):
        a, b = getattr(mj, name), getattr(mt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert mj.material_tags == mt.material_tags
    assert tuple(mj.grid_overlay["shape"]) == tuple(mt.grid_overlay["shape"])
    assert np.array_equal(mj.grid_overlay["index"], mt.grid_overlay["index"])
    if jitter == 0.25 and seed == 7:
        mb = tbuild(tdom, tmats, jitter=0.25, seed=7)
        assert np.array_equal(mb.nodes, case["jmesh"].nodes)
    with pytest.raises(ValueError, match="jitter"):
        tperturb(build_structured_mesh(tdom, tmats), jitter=0.4)


def _write_msh41(path, mesh):
    """An MSH 4.1 ASCII file as gmsh writes it: one surface entity a
    material (its physical tag), node and element blocks a material."""
    nodes, cells, tags = mesh.nodes, mesh.cells, mesh.cell_tags
    mats = sorted(mesh.material_tags.items(), key=lambda kv: kv[1])
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$PhysicalNames",
             str(len(mats))]
    lines += [f'2 {t} "{n}"' for n, t in mats]
    lines += ["$EndPhysicalNames", "$Entities", f"0 0 {len(mats)} 0"]
    lines += [f"{t} 0 0 0 1 1 0 1 {t} 0" for _, t in mats]
    lines += ["$EndEntities", "$Nodes", f"1 {len(nodes)} 1 {len(nodes)}",
              f"2 1 0 {len(nodes)}"]
    ids = np.arange(len(nodes))[::-1] + 10      # ids need not be 1..N
    lines += [str(i) for i in ids]
    lines += [f"{z:.16e} {r:.16e} 0" for z, r in nodes]
    lines += ["$EndNodes", "$Elements",
              f"{len(mats)} {len(cells)} 1 {len(cells)}"]
    e = 1
    for _, t in mats:
        sel = np.where(tags == t)[0]
        lines.append(f"2 {t} 2 {len(sel)}")
        for c in sel:
            lines.append(f"{e} " + " ".join(str(ids[v]) for v in cells[c]))
            e += 1
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


@pytest.mark.parametrize("writer", ["jax", "torch", "msh41"])
def test_read_msh_bitwise(case, tmp_path, writer):
    m = case["jmesh"]
    path = str(tmp_path / "m.msh")
    if writer == "msh41":
        _write_msh41(path, m)
    else:
        (jmsh if writer == "jax" else tmsh).write_msh(
            path, m.nodes, m.cells, m.cell_tags, m.material_tags)
    a, b = jmsh.read_msh(path), tmsh.read_msh(path)
    for name in ("nodes", "cells", "cell_tags"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert getattr(a, name).dtype == getattr(b, name).dtype
    assert a.material_tags == b.material_tags == m.material_tags
    assert b.grid_overlay is None and b.dim == 2
    if writer != "msh41":
        assert np.array_equal(b.nodes, m.nodes)
        assert np.array_equal(b.cells, m.cells)


def test_read_msh_lines_and_bad_files(tmp_path):
    z = np.linspace(0.0, 1e-5, 7)
    nodes = np.stack([z, np.zeros_like(z)], axis=1)
    cells = np.stack([np.arange(6), np.arange(1, 7)], axis=1)
    path = str(tmp_path / "l.msh")
    tmsh.write_msh(path, nodes, cells, np.array([1, 1, 2, 2, 3, 3]),
                   {"a": 1, "b": 2, "c": 3})
    a, b = jmsh.read_msh(path), tmsh.read_msh(path)
    assert b.dim == 1 and np.array_equal(a.cells, b.cells)
    assert np.array_equal(a.cell_tags, b.cell_tags)
    (tmp_path / "bad.msh").write_text("$MeshFormat\n3.0 0 8\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="unsupported MSH version"):
        tmsh.read_msh(str(tmp_path / "bad.msh"))
    (tmp_path / "none.msh").write_text("$Nodes\n0\n$EndNodes\n")
    with pytest.raises(ValueError, match="MeshFormat"):
        tmsh.read_msh(str(tmp_path / "none.msh"))


@pytest.mark.parametrize("loc, kw", [
    ("left", {}), ("right", {}), ("top", {}), ("bottom", {}),
    ("outer", {"length": 4e-6}),
    ("x", {"coord": 3.2e-6, "center": 0.0, "length": 8e-6}),
    ("x", {"coord": 3.2e-6, "length": 4e-6}),       # the z-midpoint quirk
    ("y", {"coord": 0.0, "length": 2e-6})])
def test_node_row_mask_bitwise(case, loc, kw):
    nodes = case["jmesh"].nodes
    a = jbc.node_row_mask(nodes, loc, **kw)
    b = tbc.node_row_mask(nodes, loc, **kw)
    assert a.dtype == b.dtype == bool and np.array_equal(a, b)
    if loc == "outer":
        assert b.any()


def test_bc_helpers(case, capsys):
    for f in (2e-6, 6e-6):
        assert tbc.gaussian_coeff(f) == jbc.gaussian_coeff(f)
    jp, tp = case["overlay"]
    masks = {"dirichlet": tp.dirichlet, "heat": tp.heat_mask,
             "none": np.zeros_like(tp.heat_mask)}
    got = tbc.describe_row_bcs(masks, tp.mesh.nodes)
    want = jbc.describe_row_bcs(masks, jp.mesh.nodes)
    assert got == want and got[2].endswith("no DOFs")
    assert capsys.readouterr().out.count("Row BC #") == 6
    with pytest.raises(ValueError, match="coord"):
        tbc.node_row_mask(tp.mesh.nodes, "x")


def test_problem_and_ell_bitwise(case):
    jp, tp = case["overlay"]
    for name in ("cols", "K_vals", "M_vals", "G_vals", "Mp_vals", "Kf_vals",
                 "Mf_vals"):
        a, b = getattr(jp.ell, name), getattr(tp.ell, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("kappas", "rho_cvs", "dirichlet", "heat_mask",
                 "watcher_nodes", "band_nodes", "band_bins", "bin_counts",
                 "bin_centers", "axis_nodes", "axis_z"):
        assert np.array_equal(getattr(jp, name), getattr(tp, name)), name
    for name in ("dt", "num_steps", "ic_temp", "fwhm", "watcher_names"):
        assert getattr(jp, name) == getattr(tp, name), name
    cols, vals, rows = (np.array([1, 0, 2]), np.array([0.5, -1.0, 2.0]),
                        np.array([0, 0, 2]))
    for a, b in zip(jell._coo_to_ell(3, rows, cols, [vals]),
                    tell._coo_to_ell(3, rows, cols, [vals])):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_ell_to_stencils_bitwise(case):
    jp, tp = case["overlay"]
    ov = case["jmesh"].grid_overlay
    a, b = jov.ell_to_stencils(jp.ell, ov), tov.ell_to_stencils(tp.ell, ov)
    assert sorted(a) == sorted(b) == ["G", "K", "Kf", "M", "Mf", "Mp"]
    for name in a:
        assert a[name].dtype == b[name].dtype
        assert np.array_equal(a[name], b[name]), name
    # planes 7 and 8 (the anti-diagonals) carry the mixed diagonals
    assert np.abs(b["K"][:, 7:]).max() > 0
    idx, shape = tov.validate_overlay(len(tp.mesh.nodes), ov)
    v = np.arange(len(idx), dtype=np.float64)
    assert np.array_equal(tov.node_to_lattice(v, idx, shape),
                          jov.node_to_lattice(v, idx, shape))
    bad = {"shape": ov["shape"], "index": np.roll(ov["index"], 7)}
    with pytest.raises(ValueError, match="9-point"):
        tov.ell_to_stencils(tp.ell, bad)
    with pytest.raises(ValueError, match="bijection"):
        tov.validate_overlay(len(idx), {"shape": ov["shape"],
                                        "index": np.zeros_like(idx)})


def test_ell_products_vs_jax(case):
    _, tp = case["overlay"]
    ell = tp.ell
    rng = np.random.default_rng(11)
    n = ell.cols.shape[0]
    u = rng.standard_normal((3, n))
    kap, rc = rng.uniform(1, 10, 5), rng.uniform(1e6, 3e6, 5)
    cols_t = torch.as_tensor(ell.cols, dtype=torch.int64)
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    Aj, Mj = jell.ell_combine(jnp.asarray(ell.K_vals), jnp.asarray(ell.M_vals),
                              jnp.asarray(kap), jnp.asarray(rc), 1e-7)
    At, Mt = tell.ell_combine(t64(ell.K_vals), t64(ell.M_vals), t64(kap),
                              t64(rc), 1e-7)
    assert rel_l2(At.numpy(), Aj) <= 1e-14 and rel_l2(Mt.numpy(), Mj) <= 1e-14
    yj = jell.ell_apply(jnp.asarray(ell.cols), Aj, jnp.asarray(u))
    yt = tell.ell_apply(cols_t, At, t64(u))
    assert yt.shape == (3, n) and rel_l2(yt.numpy(), yj) <= 1e-14
    dj, dt = jell.ell_diag(ell.cols, Aj), tell.ell_diag(ell.cols, At)
    assert rel_l2(dt.numpy(), dj) <= 1e-14
    # a row's sum does not depend on the batch it runs in
    assert torch.equal(tell.ell_apply(cols_t, At, t64(u[1])), yt[1])
    dev = ell.to("cpu", torch.float32)
    assert dev["cols"].dtype == torch.int64 and dev["K"].dtype == torch.float32
    assert torch.equal(dev["own"].bool(), torch.as_tensor(
        ell.cols == np.arange(n)[:, None]))


# ---------------------------------------------------------------------------
# the transient
# ---------------------------------------------------------------------------

def _jax_run(p, **kw):
    return jax.tree.map(np.asarray, ju.make_simulate_fn_unstructured(
        p, **kw)())


def _torch_run(p, **kw):
    fn = tu.make_simulate_fn_unstructured(p, device="cpu", **kw)
    return {k: v.detach().numpy() for k, v in fn().items()}


def _same_run(yj, yt, tol=PARITY, iters=True):
    for key in ("watch", "band", "axis", "final_u", "field"):
        if key in yj:
            assert yt[key].shape == np.shape(yj[key]), key
            assert rel_l2(yt[key], yj[key]) <= tol, (key,
                                                     rel_l2(yt[key], yj[key]))
    assert np.array_equal(yt["times"], yj["times"])
    if iters:
        assert np.array_equal(yt["cg_iters"], yj["cg_iters"])
        assert np.array_equal(yt["proj_iters"], yj["proj_iters"])


@pytest.mark.parametrize("form, kw", [
    ("ell", dict()),
    ("ell", dict(warm_start="extrapolate", record_fields=True)),
    ("ell", dict(fixed_iters=40)),
    ("ell", dict(rtol_wrt="r0", rtol=1e-10)),
    ("overlay", dict()),
    ("overlay", dict(warm_start="extrapolate", record_fields=True)),
    ("overlay", dict(solver="vmem")),
    ("overlay", dict(solver="vmem", precondition="rline",
                     warm_start="extrapolate")),
    ("overlay", dict(solver="vmem", precondition="adi", rtol_wrt="r0",
                     rtol=1e-10))],
    ids=["ell", "ell-extrapolate-fields", "ell-fixed", "ell-r0", "overlay",
         "overlay-extrapolate-fields", "vmem-jacobi", "vmem-rline",
         "vmem-adi-r0"])
def test_transient_vs_jax(case, form, kw):
    """Traces within 1e-8 rel-L2 in float64 and the iteration counts equal
    (the kernel path's plain versions against the JAX package's
    interpret-mode Pallas kernels)."""
    jp, tp = case[form]
    rtol = kw.pop("rtol", 1e-11)
    yj = _jax_run(jp, rtol=rtol, **kw)
    yt = _torch_run(tp, rtol=rtol, **kw)
    _same_run(yj, yt)


@pytest.mark.parametrize("form, kw", [
    ("ell", dict()), ("overlay", dict()),
    ("overlay", dict(solver="vmem", precondition="rline"))],
    ids=["ell", "overlay", "vmem-rline"])
def test_refined_transient_vs_jax(case, form, kw):
    """f64_refine=2 around float32 correction solves. The state and each
    pass's residual are float64, so the traces agree far below the float32
    solves' own error; the counts of two float32 solves whose sums run in
    another order agree within 2 + 6 % a step (the unpreconditioned
    solves of ~300 iterations end 15 apart at most)."""
    jp, tp = case[form]
    yj = _jax_run(jp, dtype=jnp.float32, f64_refine=2, rtol=1e-5, **kw)
    yt = _torch_run(tp, dtype=torch.float32, f64_refine=2, rtol=1e-5, **kw)
    assert rel_l2(yt["watch"], yj["watch"]) <= 1e-8
    assert rel_l2(yt["final_u"], yj["final_u"]) <= 1e-8
    ij, it = yj["cg_iters"].astype(int), yt["cg_iters"].astype(int)
    assert (np.abs(it - ij) <= 2 + 0.06 * ij).all(), (it, ij)


def test_differentiable_and_overrides_vs_jax(case):
    """The differentiable solve, parameter overrides, a source, a warm
    start from a field and t0: the same run as the JAX package's."""
    jp, tp = case["ell"]
    n = len(jp.mesh.nodes)
    kap = jp.kappas * 1.3
    rng = np.random.default_rng(2)
    src = 1e9 * rng.uniform(0.0, 1.0, n)
    u0 = 300.0 + rng.uniform(0.0, 5.0, n)
    kw = dict(kappas=kap, fwhm=5e-6, u0=u0, t0=1e-7, source=src)
    fj = ju.make_simulate_fn_unstructured(jp, rtol=1e-11, differentiable=True,
                                          record_gradient=False)
    ft = tu.make_simulate_fn_unstructured(tp, rtol=1e-11, differentiable=True,
                                          record_gradient=False, device="cpu")
    yj = jax.tree.map(np.asarray, fj(**kw))
    yt = {k: v.detach().numpy() for k, v in ft(**kw).items()}
    assert "cg_iters" not in yt and "cg_iters" not in yj
    assert rel_l2(yt["watch"], yj["watch"]) <= PARITY
    assert rel_l2(yt["final_u"], yj["final_u"]) <= PARITY
    np.testing.assert_allclose(yt["times"], yj["times"], rtol=1e-15)


@pytest.mark.parametrize("form", ["ell", "overlay"])
def test_gradients_vs_jax(case, form):
    """d/d(κ_sample, FWHM) of a watcher loss by implicit differentiation,
    against jax.grad: within 1e-6 relative."""
    jp, tp = case[form]
    m = list(jp.mesh.material_tags).index("p_sample")
    fj = ju.make_simulate_fn_unstructured(jp, rtol=1e-12, differentiable=True,
                                          record_gradient=False)
    base = jnp.asarray(jp.kappas)

    def lj(k, f):
        w = fj(kappas=base.at[m].set(k), fwhm=f)["watch"]
        return jnp.sum(w[:, 1] ** 2) + 0.3 * jnp.sum(w[:, 0])

    gj = jax.grad(lj, argnums=(0, 1))(3.8, 6e-6)
    ft = tu.make_simulate_fn_unstructured(tp, rtol=1e-12, differentiable=True,
                                          record_gradient=False, device="cpu")
    k = torch.tensor(3.8, dtype=torch.float64, requires_grad=True)
    f = torch.tensor(6e-6, dtype=torch.float64, requires_grad=True)
    kp = torch.as_tensor(tp.kappas)
    hot = torch.zeros_like(kp)
    hot[m] = 1.0
    w = ft(kappas=kp * (1 - hot) + hot * k, fwhm=f)["watch"]
    (torch.sum(w[:, 1] ** 2) + 0.3 * torch.sum(w[:, 0])).backward()
    for got, want in ((k.grad, gj[0]), (f.grad, gj[1])):
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_transient_vs_reference_fem(case):
    """The port's float64 transient on the non-grid triangulation against
    the independent scipy FEM (tests/test_unstructured_firstclass.py:71)."""
    _, tp = case["ell"]
    m = tp.mesh
    kappas = np.array([x.kappa for x in case["mats"]])
    rho_cvs = np.array([x.rho_cv for x in case["mats"]])
    ys = _torch_run(tp, rtol=1e-13, record_fields=True)
    ic = tp.ic_temp
    profile = np.exp(tbc.gaussian_coeff(tp.fwhm) * m.nodes[:, 1] ** 2) \
        * tp.heat_mask.astype(float)
    off = tp.heating.amplitude_offset(ic)

    def g_of_t(t):
        amp = np.interp(t, tp.heating.time, tp.heating.temp) - off
        return ic * tp.dirichlet.astype(float) + (amp - ic) * profile

    ref = reference_fem.backward_euler(
        m.nodes, m.cells, kappas[m.cell_tags - 1], rho_cvs[m.cell_tags - 1],
        tp.dt, tp.num_steps, tp.dirichlet, g_of_t, ic,
        watch_nodes=list(tp.watcher_nodes), project_gradient=True)
    assert rel_l2(ys["field"], ref["u"]) < 1e-8
    assert np.abs(ys["watch"] - ref["watch"]).max() \
        / np.abs(ref["watch"]).max() < 2e-8
    grad_ref = ref["grad_r"][:, tp.axis_nodes]
    assert np.abs(ys["axis"] - grad_ref).max() / np.abs(grad_ref).max() < 2e-5


def test_overlay_matches_ell(case):
    """The lattice operators and the ELL gather give the same transient in
    the port itself (tests/test_unstructured_firstclass.py:248)."""
    ov = _torch_run(case["overlay"][1], rtol=1e-12, record_fields=True)
    el = _torch_run(case["ell"][1], rtol=1e-12, record_fields=True)
    scale = np.abs(el["field"]).max()
    assert np.abs(ov["field"] - el["field"]).max() / scale < 1e-10
    np.testing.assert_allclose(ov["watch"], el["watch"], rtol=1e-9)
    np.testing.assert_allclose(ov["final_u"], el["final_u"], rtol=1e-9)


def test_maker_options(case):
    jp, tp = case["overlay"]
    _, tpe = case["ell"]
    mk = tu.make_simulate_fn_unstructured
    fn = mk(tp, device="cpu")
    assert mk(tp, device="cpu") is fn and mk(tp, device="cpu",
                                             rtol=1e-9) is not fn
    assert not fn.use_vmem and fn.overlay and not mk(tpe, device="cpu").overlay
    # 'auto' takes the kernel path only for float32 on a CUDA device
    assert not mk(tp, device="cpu", dtype=torch.float32, solver="auto",
                  rtol=1e-5).use_vmem
    # a transient takes the kernel path on either form: the overlay's
    # lattice, or a mesh without overlay on the ELL gather with 'jacobi'
    assert tu.auto_selects_vmem(tp.mesh, torch.float32, device="cuda")
    assert tu.auto_selects_vmem(tpe.mesh, torch.float32, device="cuda")
    assert not tu.auto_selects_vmem(tpe.mesh, torch.float64, device="cuda")
    ell = mk(tpe, device="cpu", dtype=torch.float32, solver="vmem",
             rtol=1e-5)
    assert ell.use_vmem and not ell.overlay and ell.form.cols is not None
    # a sweep's batched kernels are stencil-form only: the overlay's
    assert tu.sweep_auto_selects_vmem(tp.mesh, torch.float32, device="cuda")
    assert not tu.sweep_auto_selects_vmem(tpe.mesh, torch.float32,
                                          device="cuda")
    assert not tu.sweep_auto_selects_vmem(tp.mesh, torch.float64,
                                          device="cuda")
    for bad, match in ((dict(solver="vmem", problem=tpe,
                             precondition="rline"), "grid-overlay"),
                       (dict(solver="vmem", problem=tpe, precondition="adi",
                             dtype=torch.float32, f64_refine=1),
                        "grid-overlay"),
                       (dict(solver="vmem", problem=tpe,
                             precondition="adaptive", record_gradient=False),
                        "grid-overlay"),
                       (dict(precondition="rline"), "kernel path"),
                       (dict(precondition="rline", solver="auto"),
                        "not selected"),
                       (dict(precondition="mg"), "unknown precondition"),
                       (dict(warm_start="extrapolate2"), "warm_start"),
                       (dict(f64_refine=1), "float32"),
                       (dict(solver="vmem", fixed_iters=5),
                        "not differentiable")):
        p = bad.pop("problem", tp)
        with pytest.raises(ValueError, match=match):
            mk(p, device="cpu", **bad)
    if not torch.cuda.is_available():
        for call in (lambda: mk(tp), lambda: tu.make_sweep_fn_unstructured(tp),
                     lambda: tu.solve_steady_unstructured(
                         tp, np.zeros(len(tp.mesh.nodes)))):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tu.make_sweep_fn_unstructured(tp, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# sweeps and the steady solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form, kw", [
    ("overlay", dict(solver="vmem")),
    ("overlay", dict(solver="vmem", precondition="rline",
                     warm_start="extrapolate")),
    ("overlay", dict(solver="vmem", precondition="adi", rtol_wrt="r0")),
    ("overlay", dict(solver="vmem", fixed_iters=25)),
    ("overlay", dict(solver="vmem", precondition="rline",
                     record_gradient=True)),
    ("ell", dict()),
    ("ell", dict(record_gradient=True, warm_start="extrapolate")),
    ("ell", dict(fixed_iters=25))],
    ids=["vmem", "vmem-rline", "vmem-adi", "vmem-fixed", "vmem-recording",
         "xla", "xla-recording", "xla-fixed"])
def test_sweep_vs_jax_and_lanes(case, form, kw):
    """The batch against the JAX package's, each lane against the single
    run, and B = 2 lanes bitwise the same lanes of the B = 4 batch."""
    jp, tp = case[form]
    rtol = 1e-11
    oj = ju.make_sweep_fn_unstructured(jp, dtype=jnp.float64, rtol=rtol,
                                       **kw)(jnp.asarray(KS), jnp.asarray(FS))
    fn = tu.make_sweep_fn_unstructured(tp, dtype=torch.float64, rtol=rtol,
                                       device="cpu", **kw)
    ot = fn(KS, FS)
    rec = kw.get("record_gradient", False)
    fam = ("watch", "band", "axis") if rec else ("watch",)
    get = (lambda o, f: np.asarray(o[f])) if rec else \
        (lambda o, f: np.asarray(o))
    for f in fam:
        assert rel_l2(get(ot, f), get(oj, f)) <= PARITY, f
    sub = fn(KS[[1, 3]], FS[[1, 3]])
    for f in fam:
        assert np.array_equal(get(sub, f), get(ot, f)[[1, 3]]), f
    if rec:
        np.testing.assert_array_equal(ot["times"], oj["times"])
        assert np.array_equal(fn.band_centers, jp.bin_centers)
    # each lane is the single transient of its parameters
    if kw.get("solver") == "vmem" or rec:
        return
    m = list(tp.mesh.material_tags).index("p_sample")
    single = tu.make_simulate_fn_unstructured(
        tp, device="cpu", rtol=rtol, record_gradient=False,
        fixed_iters=kw.get("fixed_iters"))
    for i in (0, 2):
        kp = tp.kappas.copy()
        kp[m] = KS[i]
        one = single(kappas=kp, fwhm=FS[i])["watch"].numpy()
        assert rel_l2(ot[i].numpy(), one) <= PARITY


def test_vmem_sweep_lanes_match_single_kernel_runs(case):
    """A lane of the batched kernel sweep against the single transient on
    the kernel path (the plain versions of K2 and K1)."""
    _, tp = case["overlay"]
    fn = tu.make_sweep_fn_unstructured(tp, dtype=torch.float64, rtol=1e-11,
                                       device="cpu", solver="vmem",
                                       precondition="rline")
    tr = fn(KS, FS).numpy()
    single = tu.make_simulate_fn_unstructured(
        tp, device="cpu", rtol=1e-11, record_gradient=False, solver="vmem",
        precondition="rline")
    m = list(tp.mesh.material_tags).index("p_sample")
    for i in (0, 3):
        kp = tp.kappas.copy()
        kp[m] = KS[i]
        one = single(kappas=kp, fwhm=FS[i])["watch"].numpy()
        assert rel_l2(tr[i], one) <= PARITY


@pytest.mark.parametrize("warm", ["previous", "extrapolate"])
def test_segments_and_time_chunks(case, warm):
    """``.segment`` chunks bitwise the unchunked run, and
    ``run_sweep_time_chunked`` through the dispatch against the JAX
    package's."""
    jp, tp = case["overlay"]
    kw = dict(solver="vmem", precondition="rline", warm_start=warm)
    whole = tu.make_sweep_fn_unstructured(
        tp, dtype=torch.float64, rtol=1e-10, device="cpu", **kw)(KS, FS)
    seg = tu.make_sweep_fn_unstructured(
        tp, dtype=torch.float64, rtol=1e-10, device="cpu", num_steps=2, **kw)
    assert seg.shape == tp.mesh.grid_overlay["shape"]
    u = torch.full((4,) + seg.shape, tp.ic_temp, dtype=torch.float64)
    t1, u1, p1 = seg.segment(KS, FS, u, 0)
    t2, u2, p2 = seg.segment(KS, FS, u1, 2, u_pp=p1)
    assert torch.equal(torch.cat([t1, t2], dim=1), whole[:, :4])
    tj = np.asarray(jsw.run_sweep_time_chunked(
        jp, KS, FS, step_chunk=2, dtype=jnp.float64, rtol=1e-10,
        solver="vmem", precondition="rline", warm_start=warm))
    tt = tsw.run_sweep_time_chunked(tp, KS, FS, step_chunk=2,
                                    dtype=torch.float64, rtol=1e-10,
                                    solver="vmem", precondition="rline",
                                    warm_start=warm, device="cpu")
    assert rel_l2(tt, tj) <= PARITY
    if warm == "extrapolate":
        assert np.array_equal(tt, whole.numpy())
    with pytest.raises(ValueError, match="solver='vmem'"):
        tsw.run_sweep_time_chunked(tp, KS, FS, solver="xla", device="cpu")


def test_sweepkernel_makers_dispatch(case):
    """``make_sweep_fn`` and ``make_sweep_fn_recording`` take an
    unstructured problem to its own maker."""
    _, tp = case["overlay"]
    a = tsw.make_sweep_fn(tp, dtype=torch.float64, rtol=1e-10, solver="vmem",
                          device="cpu")
    b = tu.make_sweep_fn_unstructured(tp, dtype=torch.float64, rtol=1e-10,
                                      solver="vmem", device="cpu")
    assert a is b
    r = tsw.make_sweep_fn_recording(tp, dtype=torch.float64, rtol=1e-10,
                                    solver="vmem", precondition="rline",
                                    device="cpu")
    assert set(r(KS[:2], FS[:2])) == {"watch", "band", "axis", "times"}
    with pytest.raises(ValueError, match="projection"):
        tsw.make_sweep_fn_recording(tp, proj_rtol=1e-9, device="cpu")
    with pytest.raises(ValueError, match="unknown precondition"):
        tsw.make_sweep_fn(tp, precondition="mg", device="cpu")(KS, FS)


@pytest.mark.parametrize("weighted, with_f", [(False, False), (True, True)])
def test_steady_vs_jax(case, weighted, with_f):
    jp, tp = case["ell"]
    n = len(jp.mesh.nodes)
    g = np.where(jp.dirichlet, 300.0, 0.0)
    g[jp.heat_mask] = 2000.0
    f = np.random.default_rng(4).uniform(0.0, 1e12, n) if with_f else None
    uj, ij = ju.solve_steady_unstructured(jp, g, f=f, weighted=weighted)
    ut, it = tu.solve_steady_unstructured(tp, g, f=f, weighted=weighted,
                                          device="cpu")
    assert ut.shape == (n,) and it["converged"]
    assert np.abs(ut - uj).max() <= 1e-10 * np.abs(uj).max()
    assert it["iters"] == ij["iters"]

"""The mesh a configuration file names: the reference's frozen
triangulation bitwise the port's, the reference on it against the port's
eager float64 unstructured transient, the structured kind the same as no
key, an unknown kind refused, and a whole run of a triangulation cell
through a copy of the benchmark, sound and with planted faults."""

import json
import os
import pickle
import shutil
import time

import numpy as np
import pytest
import torch

from hfbench import harness
from hfbench.reference import geometry
from hfbench.reference import triangulation
from hfbench.reference.fem import MESHES, Reference
from hfbench.reference.triangulation import build_triangulation

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CONFIGS = [c["name"] for c in SPEC["configs"]]


def config_doc(config):
    return harness.load_json(os.path.join(ROOT, "hfbench", "configs",
                                          f"{config}.json"))


def short(cfg, steps):
    t = cfg["timing"]
    return dict(cfg, timing=dict(
        t_final=t["t_final"] * steps / t["num_steps"], num_steps=steps))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("size_scale", [8.0, 1.0])
@pytest.mark.parametrize("config", CONFIGS)
def test_triangulation_is_the_ports(config, size_scale, seed):
    """The frozen copy's nodes, cells and tags are bitwise the port's
    ``build_unstructured_mesh`` (at full size too: only the mesh is built)."""
    from heatflow_tpu_torch import build_layout
    from heatflow_tpu_torch.mesh.unstructured_gen import (
        build_unstructured_mesh)
    cfg = config_doc(config)["config"]
    port = build_unstructured_mesh(*build_layout(cfg), size_scale=size_scale,
                                   jitter=0.25, seed=seed)
    ours = build_triangulation(*geometry.build_layout(cfg),
                               size_scale=size_scale, jitter=0.25, seed=seed)
    for k in ("nodes", "cells", "cell_tags"):
        want, got = getattr(port, k), getattr(ours, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k


def port_transient(cfg, csv, size_scale, kappa, fwhm):
    from heatflow_tpu_torch import build_layout
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.mesh.unstructured_gen import (
        build_unstructured_mesh)
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.unstructured import (
        build_problem_unstructured, make_simulate_fn_unstructured)
    mesh = build_unstructured_mesh(*build_layout(cfg), size_scale=size_scale)
    problem = build_problem_unstructured(
        mesh, HeatingCurve.from_csv(csv), cfg,
        watcher_points=coupler_watcher_points(cfg))
    fn = make_simulate_fn_unstructured(
        problem, dtype=torch.float64, device="cpu", rtol=1e-13,
        maxiter=100000, precondition="jacobi", record_gradient=True,
        proj_rtol=1e-14, proj_maxiter=100000)
    kappas = problem.kappas.copy()
    kappas[mesh.material_tags["p_sample"] - 1] = kappa
    return {k: v.numpy() for k, v in fn(kappas, None, fwhm).items()}


@pytest.mark.parametrize("config,size_scale,steps", [
    ("geballe_no_diamond", 4.0, 8), ("geballe_with_diamond", 8.0, 8)])
def test_triangle_reference_matches_the_port_in_float64(config, size_scale,
                                                        steps):
    doc = config_doc(config)
    csv = os.path.join(ROOT, doc["heating_csv"])
    cfg = short(json.loads(json.dumps(doc["config"])), steps)
    ref = Reference(cfg, csv, size_scale=size_scale, mesh="triangulation")
    for kappa, fwhm in ((3.8, 1.32e-5), (57.0, 2.5e-6)):
        got = port_transient(cfg, csv, size_scale, kappa, fwhm)
        want = ref.run(kappa, fwhm, record=True)
        assert want["watch"].shape == got["watch"].shape
        assert want["axis"].shape == got["axis"].shape
        rel = lambda k: np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert rel("watch") < 1e-9
        assert rel("axis") < 1e-7
        assert want["band"].size and rel("band") < 1e-7


@pytest.mark.parametrize("config", CONFIGS)
def test_the_structured_kind_is_no_key(config):
    """No ``mesh`` key and ``{"kind": "structured"}`` build bitwise the same
    program problem and reference."""
    cell = next(w["name"] for w in SPEC["workloads"] if w["config"] == config)
    runs = [harness.new_run(cell, 0, overrides={"size_scale": 8.0})
            for _ in range(2)]
    assert "mesh" not in runs[0].config
    runs[1].config = dict(runs[1].config, mesh={"kind": "structured"})
    assert [r.mesh for r in runs] == ["structured"] * 2
    # equal pickles: every array, sparse matrix and number bitwise the same
    same = lambda a, b: pickle.dumps(a) == pickle.dumps(b)
    assert same(*(harness.build_problem(r) for r in runs))
    from hfbench import check
    refs = [check.reference_for(r) for r in runs]
    assert same(*refs)
    # the axis rows: the grid's first column, in z order
    nz = len(refs[0].axis_nodes)
    assert np.array_equal(refs[0].axis_nodes,
                          np.arange(nz) * (len(refs[0].r_sq) // nz))


def test_the_triangulation_is_run2ds():
    """The reference's triangulation is the one ``run2d --mesh-style
    unstructured`` builds: the port's defaults."""
    import inspect
    from heatflow_tpu_torch.mesh.unstructured_gen import (
        build_unstructured_mesh)
    defaults = inspect.signature(build_unstructured_mesh).parameters
    assert defaults["jitter"].default == triangulation.JITTER
    assert defaults["seed"].default == triangulation.SEED


def test_an_unknown_mesh_kind_raises():
    """A kind that does not exist, a mesh with no kind, or one with a knob
    beside its kind raises, naming the kinds that exist; every kind has a
    reference."""
    assert set(MESHES) == set(harness.MESH_KINDS)
    run = harness.new_run("flagship.transient", 0,
                          overrides={"size_scale": 16.0})
    for bad in ({"kind": "gmsh"}, {}, {"jitter": 0.25},
                {"kind": "triangulation", "jitter": 0.25, "seed": 0}):
        run.config = dict(run.config, mesh=bad)
        with pytest.raises(ValueError, match=", ".join(harness.MESH_KINDS)):
            run.mesh
        with pytest.raises(ValueError, match="structured, triangulation"):
            harness.build_problem(run)
    doc = config_doc("geballe_no_diamond")
    with pytest.raises(KeyError, match="gmsh"):
        Reference(doc["config"], os.path.join(ROOT, doc["heating_csv"]),
                  size_scale=16.0, mesh="gmsh")


# a traffic family that exists only in these tests: the port's eager
# float64 unstructured transient at rtol 1e-13, units as the transient
# family's
FAMILY = '''
from hfbench import harness


def setup(run):
    from heatflow_tpu_torch.sim.unstructured import (
        make_simulate_fn_unstructured)
    run.entry = make_simulate_fn_unstructured(run.problem, device=run.device,
                                              **run.recipe())
    run.entry()


def unit(run, i):
    return harness.load_module("traffic", "transient", run.root).unit(run, i)
'''
# tight to match: a small fault at a small size still shows
LIMITS = {"watch_gap_K": 1e-6, "watch_step_gap_K": 1e-6,
          "band_gap_rel": 1e-6, "axis_gap_rel": 1e-6, "unanswered": 0}


@pytest.fixture
def tri_root(tmp_path):
    """A copy of the benchmark with a triangulation configuration of the
    flagship's stack and a cell of it at a small size."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "hfbench"), root / "hfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    hb = root / "hfbench"
    doc = config_doc("geballe_with_diamond")
    doc["mesh"] = {"kind": "triangulation"}
    (hb / "configs" / "tri_stack.json").write_text(json.dumps(doc))
    (hb / "traffic" / "tri_transient.py").write_text(FAMILY)
    work = json.loads(
        (hb / "workloads" / "flagship.transient.json").read_text())
    work.update(config="tri_stack", traffic="tri_transient")
    work["params"].update(
        size_scale=16.0, draw_set=2, check_samples=2, check_hardest=[],
        limits=LIMITS, recipe=dict(
            dtype="float64", rtol=1e-13, maxiter=100000,
            precondition="jacobi", solver="xla", record_gradient=True,
            proj_rtol=1e-14, proj_maxiter=100000))
    (hb / "workloads" / "tri.cell.json").write_text(json.dumps(work))
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="tri_stack",
                                file="hfbench/configs/tri_stack.json"))
    spec["workloads"].append(dict(name="tri.cell", config="tri_stack",
                                  traffic="tri_transient", chips=1,
                                  why="a test's cell"))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(root)


def tri_run(root):
    return harness.run_cell("tri.cell", 2 ** 31 + 11, 0.1, False, "cpu",
                            time.perf_counter(), root=root)


def test_a_triangulation_cell_is_correct(tri_root):
    line = tri_run(tri_root)
    assert line["correct"] is True and line["failed"] == 0, line["checks"]
    names = {c["name"] for c in line["checks"]}
    assert names == set(LIMITS)
    assert line["attempted"] == 2


def test_the_programs_mesh_at_another_seed_is_not_correct(tri_root,
                                                          monkeypatch):
    from heatflow_tpu_torch.mesh import unstructured_gen
    build = unstructured_gen.build_unstructured_mesh
    monkeypatch.setattr(unstructured_gen, "build_unstructured_mesh",
                        lambda *a, seed, **k: build(*a, seed=seed + 1, **k))
    line = tri_run(tri_root)
    gap = next(c for c in line["checks"] if c["name"] == "watch_gap_K")
    assert line["correct"] is False and gap["value"] > gap["limit"]


def test_watchers_one_node_off_are_not_correct(tri_root, monkeypatch):
    """Each watcher read at the nearest node to its point but the one the
    program chose."""
    from heatflow_tpu_torch.sim import unstructured
    build = unstructured.build_problem_unstructured

    def one_off(mesh, *a, watcher_points, **k):
        problem = build(mesh, *a, watcher_points=watcher_points, **k)
        pts = np.array(list(watcher_points.values()))
        d2 = ((mesh.nodes[None] - pts[:, None]) ** 2).sum(-1)
        d2[np.arange(len(pts)), problem.watcher_nodes] = np.inf
        problem.watcher_nodes = d2.argmin(axis=1)
        return problem
    monkeypatch.setattr(unstructured, "build_problem_unstructured", one_off)
    line = tri_run(tri_root)
    gap = next(c for c in line["checks"] if c["name"] == "watch_gap_K")
    assert line["correct"] is False and gap["value"] > gap["limit"]

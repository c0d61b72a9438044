#!/usr/bin/env python3
"""The unstructured sweep's float32 recipe against float64, in either
package: how far the lanes of a float32 Jacobi sweep stopped at rtol 1e-4
wrt ||b|| (the sweep recipe of ``chip_smoke.py`` phase 20) lie from the same
lanes solved in float64 to rtol 1e-10. A script for full-width runs, and a
test that holds the two packages' distances together at a small size.

    python tests/test_torch_sweep_f64_distance.py --package torch [--lanes 4]
        [--steps 40] [--out FILE.json]
    JAX_PLATFORMS=cpu python tests/test_torch_sweep_f64_distance.py --package jax
        [--lanes 1] [--steps 10] [--out FILE.json]

The mesh is ``cfgs/geballe_no_diamond.yaml``'s stack as the perturbed
triangulation of ``benchmarks/bench_frontier.py:41-90`` (jitter 0.25, seed
3), at full width unless ``--size-scale`` coarsens it; the lanes are the
first ``--lanes`` of phase 20's four (kappa = logspace(0, 2, 256) at
linspace(0, 255, 4)), at the config's FWHM; ``--steps`` cuts the run to its
first steps at the config's time step. The JAX package runs both
precisions through its XLA path (its Pallas kernels have no compiled CPU
form); the port runs its float64 solve on the eager path and its float32
lanes on the eager path too ('xla', the JAX run's algorithm) and, on the
card, through K2 (``solver='vmem'``, phase 20's path). Prints one JSON
object: for each float32 run, per lane the largest |float32 - float64|
over the steps and watchers, in K, and where.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "cfgs", "geballe_no_diamond.yaml")
CSV = os.path.join(ROOT, "experimental_data", "geballe_heat_data.csv")
RECIPE = dict(precondition="jacobi", rtol=1e-4, rtol_wrt="b")
F64 = dict(precondition="jacobi", rtol=1e-10, rtol_wrt="b", maxiter=40000)


def lanes(n: int) -> np.ndarray:
    ks = np.logspace(0.0, 2.0, 256)
    return ks[np.linspace(0, 255, 4).astype(int)][:n]


def cut(cfg: dict, steps: int | None) -> dict:
    """The config's first ``steps`` steps at its own time step."""
    if steps:
        t = cfg["timing"]
        t["t_final"] = t["t_final"] * steps / t["num_steps"]
        t["num_steps"] = steps
    return cfg


def build(pkg: str, args):
    """The problem and its lanes through package ``pkg``'s entry points
    (the port mirrors the JAX package's module names)."""
    import importlib
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")
    top = importlib.import_module(pkg)
    cfg = cut(top.load_config(CFG), args.steps)
    domain, mats = top.build_layout(cfg)
    mesh = mod("mesh.unstructured_gen").perturb_structured_mesh(
        top.build_structured_mesh(domain, mats, size_scale=args.size_scale),
        jitter=0.25, seed=3)
    problem = mod("sim.unstructured").build_problem_unstructured(
        mesh, mod("sim.bc").HeatingCurve.from_csv(CSV), cfg,
        watcher_points=mod("geometry").coupler_watcher_points(cfg))
    ks = lanes(args.lanes)
    return problem, ks, np.full(len(ks), problem.fwhm)


def run_torch(args) -> dict:
    import torch
    from heatflow_tpu_torch.sim.unstructured import \
        make_sweep_fn_unstructured
    problem, ks, fs = build("heatflow_tpu_torch", args)
    device = torch.device(args.device)
    out = {}
    runs = [("f64", torch.float64, "xla", F64),
            ("f32", torch.float32, "xla", RECIPE)]
    if device.type == "cuda":
        runs.append(("f32_vmem", torch.float32, "vmem", RECIPE))
    for tag, dtype, solver, kw in runs:
        fn = make_sweep_fn_unstructured(problem, dtype=dtype, solver=solver,
                                        device=device, **kw)
        t0 = time.perf_counter()
        tr = fn(ks, fs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        out[tag] = (tr.cpu().numpy().astype(np.float64),
                    time.perf_counter() - t0, solver)
    name = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    return dict(package="heatflow_tpu_torch", device=name,
                shape=list(problem.mesh.grid_overlay["shape"]), **report(
                    out, ks, problem.watcher_names))


def run_jax(args) -> dict:
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from heatflow_tpu.sim.unstructured import make_sweep_fn_unstructured
    problem, ks, fs = build("heatflow_tpu", args)
    out = {}
    for tag, dtype, kw in (("f64", jnp.float64, F64),
                           ("f32", jnp.float32, RECIPE)):
        fn = make_sweep_fn_unstructured(problem, dtype=dtype, solver="xla",
                                        **kw)
        t0 = time.perf_counter()
        tr = np.asarray(jax.block_until_ready(fn(ks, fs)), np.float64)
        out[tag] = (tr, time.perf_counter() - t0, "xla")
    return dict(package="heatflow_tpu", device=str(jax.devices()[0]),
                shape=list(problem.mesh.grid_overlay["shape"]), **report(
                    out, ks, problem.watcher_names))


def report(out: dict, ks, watchers) -> dict:
    """For each float32 run, per lane its largest distance from float64."""
    f64 = out["f64"][0]
    assert np.isfinite(f64).all()
    res = dict(steps=int(f64.shape[1]),
               seconds={t: v[1] for t, v in out.items()},
               solvers={t: v[2] for t, v in out.items()})
    for tag, (f32, _secs, _solver) in out.items():
        if tag == "f64":
            continue
        assert f32.shape == f64.shape, (tag, f32.shape)
        d = np.abs(f32 - f64)                      # (B, S, W)
        per_lane = []
        for b, k in enumerate(ks):
            s, w = np.unravel_index(np.argmax(d[b]), d[b].shape)
            per_lane.append(dict(kappa=float(k), max_K=float(d[b].max()),
                                 step=int(s) + 1, watcher=watchers[w],
                                 f64_K=float(f64[b, s, w])))
        res[tag] = dict(lanes=per_lane, max_K=float(d.max()))
    return res


def test_recipe_distance_matches_jax_at_small_size():
    """Two lanes, 5 steps, the mesh 8 x coarser, on the CPU: the port's
    float32 recipe lies as far from its float64 solve as the JAX package's
    from its own (measured 3.3e-4 apart in relative terms: the float32
    solves round differently), and the two float64 solves agree."""
    import argparse as ap
    import torch
    torch.set_num_threads(1)
    args = ap.Namespace(size_scale=8.0, lanes=2, steps=5, device="cpu")
    got, want = run_torch(args), run_jax(args)
    assert got["shape"] == want["shape"] and got["steps"] == want["steps"]
    for t, j in zip(got["f32"]["lanes"], want["f32"]["lanes"]):
        assert (t["step"], t["watcher"]) == (j["step"], j["watcher"])
        assert abs(t["max_K"] - j["max_K"]) <= 1e-2 * j["max_K"], (t, j)
        assert abs(t["f64_K"] - j["f64_K"]) <= 1e-8 * j["f64_K"], (t, j)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=["torch", "jax"], required=True)
    ap.add_argument("--device", default="cuda",
                    help="the port's device (default cuda)")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=None,
                    help="cut the run to its first steps (default: all)")
    ap.add_argument("--size-scale", type=float, default=1.0,
                    help="coarsen the mesh (1.0: full width)")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    res = (run_torch if args.package == "torch" else run_jax)(args)
    res["size_scale"] = args.size_scale
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()

"""The multi-device dry run: every sharded engine of the package against its
unsharded run, on ``n`` ranks (the twin of the JAX package's
``dryrun_multichip``, ``__graft_entry__.py:42-258``).

    python -m heatflow_tpu_torch.parallel.dryrun [N] [--device cpu|cuda]

Eight engines, each sharded and not, on a coarsened flagship problem
(``cfgs/geballe_with_diamond.yaml`` at ``size_scale=24``: a 16 x 49 grid):

1. the eager sweep (``solver='xla'``, ``fixed_iters=8``) over ('config',
   'z'): z-sharded when N is even and at least 4;
2. the kernel sweep (K3, ``fixed_iters``) over 'config';
3. the eager recording sweep over 'config';
4. the refined kernel sweep (float32 K2, ``f64_refine=2``) over 'config';
5. the kernel recording sweep (K2 and its Kv-free projection);
6. the same with the r-line form;
7. the ADI kernel sweep;
8. the z-sharded stepper (``make_simulate_fn(mesh=)``) with the gradient
   projection, band and axis rows.

The config-axis engines (2-7) run each rank's lanes through the engine a
single device runs, and a lane does not depend on its batch: they must
equal the unsharded run bit for bit. The z-sharded engines add the ranks'
partial sums in the CG dots, so they are held to the JAX package's bounds
(1e-12 for the sweep, 1e-9 for the stepper). On a card the kernel engines
run in float32 (the kernels' type there).
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 4


def tiny_flagship(size_scale: float = 24.0, num_steps: int | None = None):
    """The 9-material flagship problem coarsened by ``size_scale`` (with
    ``num_steps`` steps when given)."""
    from heatflow_tpu_torch.config import load_config
    from heatflow_tpu_torch.geometry import (build_layout,
                                             coupler_watcher_points)
    from heatflow_tpu_torch.mesh.structured import build_structured_mesh
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem
    cfg = load_config(os.path.join(ROOT, "cfgs",
                                   "geballe_with_diamond.yaml"))
    cfg["heating"]["file"] = os.path.join(ROOT, "experimental_data",
                                          "geballe_heat_data.csv")
    if num_steps is not None:
        cfg = copy.deepcopy(cfg)
        cfg["timing"]["num_steps"] = num_steps
    mesh = build_structured_mesh(*build_layout(cfg), size_scale=size_scale)
    heating = HeatingCurve.from_csv(cfg["heating"]["file"])
    return build_problem(mesh, heating, cfg,
                         watcher_points=coupler_watcher_points(cfg))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.all(np.isfinite(a))
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _families(got, want, bitwise: bool, bound: float, what: str) -> float:
    """The largest relative distance over a result's families (a tensor or
    the watch / band / axis of a dict); each family bitwise, or within
    ``bound``."""
    keys = ("watch", "band", "axis")
    pairs = ([(k, got[k], want[k]) for k in keys] if isinstance(got, dict)
             else [(what, got, want)])
    err = 0.0
    for key, a, b in pairs:
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if b.size == 0:
            continue
        e = _rel(a, b)
        if bitwise:
            assert np.array_equal(a, b), f"{what} {key}: not bitwise ({e:.3e})"
        assert e < bound, f"{what} {key}: {e:.3e} >= {bound:g}"
        err = max(err, e)
    return err


def _rank(n: int, device: str) -> dict:
    """One rank of the dry run: every engine sharded and not; returns the
    rel-max distances."""
    from heatflow_tpu_torch.parallel.sharding import config_mesh
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                    make_sweep_fn_recording,
                                                    material_index)
    problem = tiny_flagship()
    problem_r = tiny_flagship(num_steps=STEPS)
    nz = problem.mesh.shape[0]
    zs = 2 if (n % 2 == 0 and n >= 4 and nz % 2 == 0) else 1
    mesh = config_mesh(z_shards=zs, device=device)
    mesh_c = config_mesh(z_shards=1, device=device)
    dev = mesh.device
    f64 = torch.float64
    kdt = f64 if dev.type == "cpu" else torch.float32  # the kernels' type
    base_k = float(problem.kappas[material_index(problem.mesh, "p_sample")])
    B = 2 * max(1, n // zs) * zs
    ks = base_k * np.linspace(0.5, 2.0, B)
    fs = problem.fwhm * np.linspace(0.8, 1.25, B)
    Bc = 2 * n
    ks_c = base_k * np.linspace(0.5, 2.0, Bc)
    fs_c = problem.fwhm * np.linspace(0.8, 1.25, Bc)
    err = {"z_shards": zs, "B": B}

    def pair(maker, prob, k, f, m, **kw):
        return (maker(prob, mesh=m, device=dev, **kw)(k, f),
                maker(prob, device=dev, **kw)(k, f))

    sh, ref = pair(make_sweep_fn, problem, ks, fs, mesh, dtype=f64,
                   fixed_iters=8, num_steps=STEPS)
    err["xla"] = _families(sh, ref, zs == 1, 1e-12, "xla sweep")
    sh, ref = pair(make_sweep_fn, problem, ks_c, fs_c, mesh_c, dtype=kdt,
                   fixed_iters=8, num_steps=STEPS, solver="vmem")
    err["vmem"] = _families(sh, ref, True, 1e-12, "vmem sweep")
    sh, ref = pair(make_sweep_fn_recording, problem_r, ks_c, fs_c, mesh_c,
                   dtype=f64, rtol=1e-10)
    err["recording"] = _families(sh, ref, True, 1e-9, "recording")
    sh, ref = pair(make_sweep_fn, problem, ks_c, fs_c, mesh_c,
                   dtype=torch.float32, rtol=1e-6, maxiter=2000,
                   num_steps=STEPS, f64_refine=2, solver="vmem",
                   warm_start="extrapolate")
    err["refined"] = _families(sh, ref, True, 1e-12, "refined sweep")
    sh, ref = pair(make_sweep_fn_recording, problem_r, ks_c, fs_c, mesh_c,
                   dtype=kdt, rtol=1e-10 if kdt == f64 else 1e-5,
                   solver="vmem")
    err["vmem_recording"] = _families(sh, ref, True, 1e-9,
                                      "vmem recording")
    sh, ref = pair(make_sweep_fn_recording, problem_r, ks_c, fs_c, mesh_c,
                   dtype=kdt, rtol=1e-10 if kdt == f64 else 1e-5,
                   solver="vmem", precondition="rline")
    err["rline_recording"] = _families(sh, ref, True, 5e-6,
                                       "rline vmem recording")
    sh, ref = pair(make_sweep_fn, problem, ks_c, fs_c, mesh_c, dtype=kdt,
                   rtol=1e-10 if kdt == f64 else 1e-5, num_steps=STEPS,
                   solver="vmem", precondition="adi")
    err["adi"] = _families(sh, ref, True, 5e-6, "adi vmem sweep")
    err["z_stepper"] = None
    if zs > 1:
        got = make_simulate_fn(problem_r, dtype=f64, rtol=1e-11,
                               record_gradient=True, mesh=mesh, device=dev)()
        want = make_simulate_fn(problem_r, dtype=f64, rtol=1e-11,
                                record_gradient=True, device=dev)()
        err["z_stepper"] = max(
            _families(got[k], want[k], False, 1e-9, f"z stepper {k}")
            for k in ("watch", "band", "axis", "final_u"))
    return err


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0
                     ) -> dict:
    """Start ``n_devices`` ranks on ``device`` ('cpu': gloo ranks; 'cuda':
    rank r on card r % count, over NCCL when every rank has its own card,
    else gloo), run the eight engines sharded and not in each, and raise
    unless every rank's comparisons hold. Returns rank 0's distances."""
    from heatflow_tpu_torch.parallel.sharding import spawn
    errs = spawn(_rank, n_devices, device=device, args=(n_devices,
                                                        str(device)),
                 timeout=timeout)
    e = errs[0]
    print(f"dryrun_multichip OK: {n_devices} ranks on {device} (config="
          f"{n_devices // e['z_shards']}, z={e['z_shards']}), batch="
          f"{e['B']}, {STEPS}-step scans; rel-max: "
          + ", ".join(f"{k} {v:.2e}" for k, v in e.items()
                      if isinstance(v, float))
          + ("" if e["z_stepper"] is not None
             else " (z=1: engine 8 skipped)"))
    return e


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-device dry run of the "
                                            "sharded engines")
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)


if __name__ == "__main__":
    main()

"""Parameter-sweep driver: the reference's multiprocessing grid search
(ref parameter_sweep.py:289-536) as batched device runs.

    python -m heatflow_tpu_torch.drivers.sweep --config cfgs/X.yaml \
        --output-dir out/sweep --mesh-folder meshes/sweep [--record-gradient]

Grid: FWHM (log-spaced) x sample conductivity (log-spaced) x sample width
(linear). Width changes the geometry, so runs are grouped by width with one
mesh per group (ref :367-373); within a group the (fwhm, k) plane runs as
batches of concurrent transients on one device (the batched CUDA kernels on
a card, their plain versions on the CPU).

Artifacts match the reference: sweep_metadata.json, successful_runs.csv,
failed_runs.csv, per-run directories named fwhm_{:.2e}_k_{:.2f}_width_{:.2e}
with watcher_points.csv + used_config.yaml (and radial_gradient[_raw].csv
with ``--record-gradient``). A run's ``runtime`` is its group's compute time
divided by the group's size; the artifacts are written in a background
thread while the next batch computes, and their CPU time is reported
apart.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import csv
import itertools
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from heatflow_tpu_torch.config import load_config, save_config, with_parameters
from heatflow_tpu_torch.drivers.run2d import (_not_ported, _prepare_mesh,
                                              default_dtype)
from heatflow_tpu_torch.geometry import coupler_watcher_points
from heatflow_tpu_torch.io.csvio import (write_gradient_csv, write_rows,
                                         write_watcher_csv)
from heatflow_tpu_torch.sim.bc import HeatingCurve
from heatflow_tpu_torch.sim.problem import build_problem
from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                make_sweep_fn_recording)
from heatflow_tpu_torch.utils import resolve_device


def create_parameter_grid(fwhm_range, k_range, width_range, num_points):
    """Log x log x linear grid, grouped by width first (ref :195-235)."""
    nf, nk, nw = num_points
    fwhm_vals = np.logspace(np.log10(fwhm_range[0]), np.log10(fwhm_range[1]),
                            nf)
    k_vals = np.logspace(np.log10(k_range[0]), np.log10(k_range[1]), nk)
    width_vals = np.linspace(width_range[0], width_range[1], nw)
    combos = [{"fwhm": f, "k": k, "width": w}
              for w in width_vals
              for f, k in itertools.product(fwhm_vals, k_vals)]
    return combos, fwhm_vals, k_vals, width_vals


def run_name(fwhm, k, width):
    """Reference directory naming incl. its string transforms (ref :145)."""
    return (f"fwhm_{fwhm:.2e}_k_{k:.2f}_width_{width:.2e}"
            .replace("+", "").replace("-0", "-"))


def mesh_folder_for_width(base_mesh_folder, width):
    w = f"{width:.3e}".replace("+", "").replace("-0", "-")
    return os.path.join(base_mesh_folder, f"width_{w}")


# Width-group (mesh, problem, heating) cache across driver calls: repeated
# calls with the same config and width reuse the problem and the sweep
# functions memoized on it. Keyed by the full config content (the swept
# fwhm/k are runtime arguments of the sweep functions), validated against
# the signatures of the files the entry embeds. Bounded LRU.
_GROUP_CACHE: dict = {}
_GROUP_CACHE_MAX = 4


def _file_sig(path):
    """(mtime_ns, size) of a file, or None if absent."""
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


def _group_sigs(cfg_w, mesh_folder):
    """Signatures of the heating CSV and the on-disk mesh pair: a rewrite of
    any of them between calls is a cache miss."""
    return (_file_sig(cfg_w["heating"]["file"]),
            _file_sig(os.path.join(mesh_folder, "mesh.msh")),
            _file_sig(os.path.join(mesh_folder, "mesh_cfg.yaml")))


def _cached_group(cfg_w, mesh_folder):
    """(mesh, problem, heating) for one width group, LRU-cached across
    :func:`run_parameter_sweep` calls. ``cfg_w`` carries the group's width
    and the base config's fwhm/k, so the key does not depend on the sweep
    ranges."""
    key = (json.dumps(cfg_w, sort_keys=True, default=str), mesh_folder)
    hit = _GROUP_CACHE.pop(key, None)
    if hit is not None and hit[1] == _group_sigs(cfg_w, mesh_folder):
        _GROUP_CACHE[key] = hit          # re-insert: most recently used
        return hit[0]
    os.makedirs(mesh_folder, exist_ok=True)
    rebuild = not (os.path.exists(os.path.join(mesh_folder, "mesh.msh"))
                   and os.path.exists(os.path.join(mesh_folder,
                                                   "mesh_cfg.yaml")))
    mesh_w = _prepare_mesh(cfg_w, mesh_folder, rebuild, "auto")
    heating = HeatingCurve.from_csv(cfg_w["heating"]["file"])
    problem = build_problem(mesh_w, heating, cfg_w,
                            watcher_points=coupler_watcher_points(cfg_w))
    entry = (mesh_w, problem, heating)
    _GROUP_CACHE[key] = (entry, _group_sigs(cfg_w, mesh_folder))
    while len(_GROUP_CACHE) > _GROUP_CACHE_MAX:
        _GROUP_CACHE.pop(next(iter(_GROUP_CACHE)))
    return entry


def _resolve_solver(solver, *, dtype, device, precondition, f64_refine,
                    record_gradient):
    """'auto' → 'vmem' (the batched CUDA kernels: Jacobi, r-line, ADI and
    adaptive) for float32 on a CUDA device and for plain f64_refine sweeps
    (the only engine that refines without recording), 'xla' (the eager
    batched PCG) otherwise, and for a preconditioner the kernels lack."""
    if solver != "auto":
        return solver
    if precondition in ("mg", "zline"):
        return "xla"
    if f64_refine and not record_gradient:
        return "vmem"
    return ("vmem" if device.type == "cuda" and dtype == torch.float32
            else "xla")


def _read_records(path: str) -> list[dict]:
    """The rows of a run-record CSV, with numbers parsed back and empty
    fields as None."""
    def value(text):
        if text == "":
            return None
        for cast in (int, float):
            try:
                return cast(text)
            except ValueError:
                pass
        return text

    with open(path, newline="") as f:
        return [{k: value(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def _write_records(path: str, records: list[dict]) -> None:
    keys = list(dict.fromkeys(k for rec in records for k in rec))
    write_rows(path, keys, ([rec.get(k) for k in keys] for rec in records))


def run_parameter_sweep(base_config_path, output_dir, fwhm_range, k_range,
                        width_range, num_points, base_mesh_folder="meshes",
                        write_xdmf=False, suppress_print=True,
                        num_processes=None, *, dtype=None,
                        batch_size: int | None = None,
                        save_run_dirs: bool = True, devices=None,
                        solver: str = "auto",
                        fixed_iters: int | None = None,
                        warm_start: str | None = None,
                        record_gradient: bool = False,
                        rtol: float | None = None,
                        rtol_wrt: str = "b",
                        f64_refine: int = 0,
                        precondition: str | None = None,
                        resume: bool = False, device="cuda",
                        timings: dict | None = None):
    """Run the sweep on ``device``; returns (successful records, failed
    records). ``num_processes`` is accepted for API parity and ignored (the
    parallelism is the batch); ``devices`` may name one device (more is
    ROADMAP P11). ``resume=True`` skips the runs already in the output
    dir's successful_runs.csv and retries failed ones. ``timings``, a dict,
    receives the sweep's wall, compute and write seconds."""
    del write_xdmf  # per-run XDMF in sweeps is supported only via run2d
    if devices is not None:
        devices = list(devices)
        if len(devices) > 1:
            raise _not_ported("sweeps over more than one device", "P11")
        device = devices[0] if devices else device
    device = resolve_device(device)
    if f64_refine and dtype is None:
        dtype = torch.float32   # the mixed mode is f32 around f64
    dtype = dtype or default_dtype(device)
    f32 = dtype == torch.float32
    if f64_refine:
        if solver not in ("vmem", "auto") and not record_gradient:
            raise ValueError("f64_refine sweeps run through solver='vmem' "
                             "(or --record-gradient, whose engines both "
                             "refine)")
        if not f32:
            raise ValueError("f64_refine needs dtype=float32")
    if warm_start is None:
        # extrapolated seeds (solve and projection) for float32 recording
        # sweeps; 'previous' for fixed-budget and plain sweeps
        warm_start = ("extrapolate" if record_gradient
                      and fixed_iters is None and f32 else "previous")
    prec_defaulted = precondition is None
    if prec_defaulted:
        from heatflow_tpu_torch.utils import resolve_recording_precondition
        precondition = resolve_recording_precondition(
            record_gradient, dtype, fixed_iters=fixed_iters, batched=True)
    rtol_kw = {} if rtol is None else {"rtol": rtol}
    if rtol_wrt != "b":
        rtol_kw["rtol_wrt"] = rtol_wrt
    # default tolerances, resolved once before the width loop (they do not
    # depend on the width)
    rec_rtol = rtol_kw
    if f64_refine and "rtol" not in rtol_kw:
        # the refinement's inner correction tolerance
        rtol_kw = rec_rtol = {**rtol_kw, "rtol": 1e-4}
    elif "rtol" not in rtol_kw and fixed_iters is None and f32:
        # the makers' 1e-6 (wrt ||b||) sits below the float32 floor: plain
        # sweeps stop at 1e-4, recording sweeps at 1e-5
        rtol_kw = {**rtol_kw, "rtol": 1e-4}
        rec_rtol = {**rec_rtol,
                    "rtol": 1e-5 if record_gradient else 1e-4}
    if isinstance(base_config_path, dict):
        base_config, base_config_name = base_config_path, "<dict>"
    else:
        base_config = load_config(base_config_path)
        base_config_name = str(base_config_path)

    combos, fwhm_vals, k_vals, width_vals = create_parameter_grid(
        fwhm_range, k_range, width_range, num_points)
    # run_id: the combo's 1-based position in the full grid, stable across
    # resumes
    for _i, _c in enumerate(combos):
        _c["run_id"] = _i + 1
    os.makedirs(output_dir, exist_ok=True)

    prior_records = []
    done_names = set()
    succ_csv = os.path.join(output_dir, "successful_runs.csv")
    if resume and os.path.isfile(succ_csv):
        prior_records = _read_records(succ_csv)
        done_names = {rec["run_name"] for rec in prior_records}
        if not suppress_print:
            print(f"resume: {len(done_names)} runs already recorded, "
                  f"skipping them")

    metadata = {
        "base_config": base_config_name,
        "fwhm_range": list(fwhm_range), "k_range": list(k_range),
        "width_range": list(width_range), "num_points": list(num_points),
        "fwhm_values": fwhm_vals.tolist(), "k_values": k_vals.tolist(),
        "width_values": width_vals.tolist(), "total_runs": len(combos),
        "engine": "heatflow_tpu_torch batched sweep",
        "solver": solver,
        "fixed_iters": fixed_iters,
        "record_gradient": record_gradient,
        "f64_refine": f64_refine,
        "precondition": precondition,
        "devices": [str(device)],
        "timestamp": datetime.now().isoformat(),
        "watcher_points": {
            "description": "Temperature monitoring points positioned halfway "
                           "through the coupler layers",
            "locations": {"pside": "Center of p-side coupler (r=0)",
                          "oside": "Center of o-side coupler (r=0)"},
        },
    }
    with open(os.path.join(output_dir, "sweep_metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)

    results, failed = [], []
    solver_resolved = {}     # width → engine actually used
    t_sweep = time.time()
    compute_s = write_s = 0.0
    writer = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    pending_writes = []

    def write_artifacts(jobs):
        """One chunk's per-run files (in the writer thread); returns the
        thread's CPU seconds (its wall time would also count the waits for
        the interpreter lock while the main thread computes)."""
        t0 = time.thread_time()
        for run_dir, wargs, gargs, used in jobs:
            os.makedirs(run_dir, exist_ok=True)
            write_watcher_csv(os.path.join(run_dir, "watcher_points.csv"),
                              *wargs)
            for name, rows in gargs:
                write_gradient_csv(os.path.join(run_dir, name), *rows)
            save_config(used, os.path.join(run_dir, "used_config.yaml"))
        return time.thread_time() - t0

    try:
        for width in width_vals:
            group = [c for c in combos if c["width"] == width]
            if done_names:
                group = [c for c in group if run_name(
                    c["fwhm"], c["k"], width) not in done_names]
                if not group:
                    continue
            mesh_folder = mesh_folder_for_width(base_mesh_folder, width)
            # width is the only parameter that reaches the problem build:
            # fwhm/k are runtime batch arguments relative to the problem's
            # base values, so the group cache does not depend on the ranges
            cfg_w = with_parameters(base_config, sample_z=width)
            _mesh_w, problem, _heating = _cached_group(cfg_w, mesh_folder)
            solver_w = _resolve_solver(solver, dtype=dtype, device=device,
                                       precondition=precondition,
                                       f64_refine=f64_refine,
                                       record_gradient=record_gradient)
            solver_resolved[f"{width:.6e}"] = solver_w
            if record_gradient:
                # every run also gets the reference's gradient CSVs (ref
                # run_no_diamond.py:602-617 under parameter_sweep.py:157-166)
                sweep_fn = make_sweep_fn_recording(
                    problem, dtype=dtype, fixed_iters=fixed_iters,
                    warm_start=warm_start, solver=solver_w,
                    f64_refine=f64_refine, precondition=precondition,
                    device=device, **rec_rtol)
            else:
                sweep_fn = make_sweep_fn(problem, dtype=dtype,
                                         solver=solver_w,
                                         fixed_iters=fixed_iters,
                                         warm_start=warm_start,
                                         f64_refine=f64_refine,
                                         precondition=precondition,
                                         device=device, **rtol_kw)

            ks = np.array([c["k"] for c in group])
            fs = np.array([c["fwhm"] for c in group])
            B = len(group)
            # chunks of 64 configs (32 when recording), as the JAX driver
            # cuts them, so a run's artifacts do not depend on the engine
            chunk = batch_size or min(B, 64)
            if record_gradient:
                chunk = min(chunk, 32)
            times = sweep_fn.times
            group_compute = 0.0
            group_results, group_failed = [], []
            for s in range(0, B, chunk):
                ks_c, fs_c = ks[s:s + chunk], fs[s:s + chunk]
                t_c = time.perf_counter()
                out = sweep_fn(ks_c, fs_c)
                if record_gradient:
                    traces = out["watch"].cpu().numpy()
                    bands = out["band"].cpu().numpy()
                    axes_rows = out["axis"].cpu().numpy()
                else:
                    traces = out.cpu().numpy()
                group_compute += time.perf_counter() - t_c
                ok = np.all(np.isfinite(traces), axis=(1, 2))
                err_detail = np.where(ok, "",
                                      "non-finite trace").astype(object)
                if record_gradient:
                    # a config whose gradient projection went non-finite
                    # is not a success with NaN-filled radial CSVs
                    ok_grad = (np.all(np.isfinite(bands), axis=(1, 2))
                               & np.all(np.isfinite(axes_rows), axis=(1, 2)))
                    err_detail[ok & ~ok_grad] = \
                        "non-finite gradient projection"
                    ok = ok & ok_grad
                jobs = []
                for i, combo in enumerate(group[s:s + chunk]):
                    name = run_name(combo["fwhm"], combo["k"], width)
                    run_dir = os.path.join(output_dir, name)
                    rec = {"run_id": combo["run_id"], "run_name": name,
                           "fwhm": combo["fwhm"], "k": combo["k"],
                           "width": width, "output_dir": run_dir,
                           "runtime": None,    # the group mean, below
                           "status": "success" if ok[i] else "failed",
                           "error": None if ok[i] else str(err_detail[i])}
                    if not ok[i]:
                        group_failed.append(rec)
                        continue
                    group_results.append(rec)
                    if save_run_dirs:
                        grads = [] if not record_gradient else [
                            ("radial_gradient.csv",
                             (times, sweep_fn.band_centers, bands[i])),
                            ("radial_gradient_raw.csv",
                             (times, sweep_fn.axis_z, axes_rows[i]))]
                        jobs.append((
                            run_dir,
                            (times, {n: traces[i, :, j] for j, n in
                                     enumerate(problem.watcher_names)}),
                            grads,
                            with_parameters(base_config, fwhm=combo["fwhm"],
                                            sample_k=combo["k"],
                                            sample_z=width)))
                if jobs:
                    pending_writes.append(writer.submit(write_artifacts,
                                                        jobs))
            for rec in group_results + group_failed:
                rec["runtime"] = group_compute / B
            results.extend(group_results)
            failed.extend(group_failed)
            compute_s += group_compute
            if not suppress_print:
                print(f"width {width:.2e}: {B} runs, compute "
                      f"{group_compute:.2f}s ({B / group_compute:.1f} "
                      f"configs/s)")
        write_s = sum(f.result() for f in pending_writes)
    finally:
        writer.shutdown(wait=True)

    if solver_resolved:
        # the engine each width group ran ('auto' resolves per group)
        metadata["solver_resolved"] = solver_resolved
        with open(os.path.join(output_dir, "sweep_metadata.json"), "w") as f:
            json.dump(metadata, f, indent=2)

    results = prior_records + results
    if results:
        _write_records(succ_csv, results)
    failed_csv = os.path.join(output_dir, "failed_runs.csv")
    if failed:
        _write_records(failed_csv, failed)
    elif resume and os.path.isfile(failed_csv):
        # every previously failed run succeeded on retry
        os.remove(failed_csv)

    total_time = time.time() - t_sweep
    if timings is not None:
        timings.update(wall_s=total_time, compute_s=compute_s,
                       write_s=write_s)
    if not suppress_print:
        print(f"PARAMETER SWEEP COMPLETE: {len(results)} ok, "
              f"{len(failed)} failed, {total_time:.2f}s total "
              f"({len(combos) / total_time:.1f} configs/s); compute "
              f"{compute_s:.2f}s, artifact writes {write_s:.2f}s of CPU (in "
              "a background thread)")
    return results, failed


def main(argv=None, timings: dict | None = None):
    """The sweep CLI; ``timings``, a dict, receives the sweep's wall, compute
    and write seconds."""
    p = argparse.ArgumentParser(
        description="heatflow_tpu_torch batched parameter sweep")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--fwhm-range", type=float, nargs=2, default=[1e-6, 1e-4])
    p.add_argument("--k-range", type=float, nargs=2, default=[1.0, 100.0])
    p.add_argument("--width-range", type=float, nargs=2,
                   default=[1e-6, 10e-6])
    p.add_argument("--num-points", type=int, nargs=3, default=[5, 5, 3])
    p.add_argument("--mesh-folder", type=str, default="meshes")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-processes", type=int, default=None,
                   help="accepted for reference-CLI parity and ignored "
                        "(parallelism is the batch)")
    p.add_argument("--solver", choices=["auto", "xla", "vmem"],
                   default="auto",
                   help="'vmem': the batched CUDA kernels; 'xla': the eager "
                        "batched PCG; 'auto' (default): the kernels on a "
                        "CUDA device in float32 (sweep_metadata.json records "
                        "what ran)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default cuda; fails when "
                        "there is no card; 'cpu' runs the plain versions)")
    p.add_argument("--fixed-iters", type=int, default=None,
                   help="fixed CG iterations per step")
    p.add_argument("--resume", action="store_true",
                   help="skip runs already in successful_runs.csv; retry "
                        "failed ones")
    p.add_argument("--rtol-wrt", choices=["b", "r0"], default="b",
                   help="CG stopping reference: 'b' or 'r0' "
                        "(increment-relative)")
    p.add_argument("--rtol", type=float, default=None,
                   help="CG stopping tolerance (default at float32: 1e-4, "
                        "1e-5 with --record-gradient)")
    p.add_argument("--record-gradient", action="store_true",
                   help="also write radial_gradient[_raw].csv per run (the "
                        "per-step projection, matching the reference's "
                        "per-run artifacts)")
    p.add_argument("--warm-start", choices=["previous", "extrapolate"],
                   default=None,
                   help="CG seed per step: previous field, or 2u_n - u_{n-1}. "
                        "Default: extrapolate for f32 --record-gradient "
                        "sweeps, previous otherwise")
    p.add_argument("--precondition",
                   choices=["jacobi", "rline", "adi", "mg"],
                   default=None,
                   help="CG preconditioner (default: rline for f32 "
                        "--record-gradient sweeps, jacobi otherwise); "
                        "'adi' runs the batched kernel's ADI form, 'mg' "
                        "the multigrid V-cycle on the eager path")
    p.add_argument("--f64-refine", type=int, default=0, metavar="N",
                   help="mixed-precision sweeps (f32): N passes of "
                        "f64-operator residual refinement per step")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    if any(x <= 0 for x in args.num_points):
        p.error("Number of points must be positive")
    for rng_name in ("fwhm_range", "k_range", "width_range"):
        lo, hi = getattr(args, rng_name)
        if lo <= 0 or hi <= 0:
            p.error(f"{rng_name} must be positive")
    run_parameter_sweep(
        args.config, args.output_dir, tuple(args.fwhm_range),
        tuple(args.k_range), tuple(args.width_range),
        tuple(args.num_points), base_mesh_folder=args.mesh_folder,
        suppress_print=not args.verbose, batch_size=args.batch_size,
        solver=args.solver, fixed_iters=args.fixed_iters,
        warm_start=args.warm_start, record_gradient=args.record_gradient,
        rtol=args.rtol, rtol_wrt=args.rtol_wrt,
        f64_refine=args.f64_refine, precondition=args.precondition,
        resume=args.resume, device=args.device, timings=timings)


if __name__ == "__main__":
    main()

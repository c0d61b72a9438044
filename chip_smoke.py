#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json]

Phases (each raises on failure; nothing is caught):

1. require a CUDA device; print the card's name and power limit and the
   TF32 settings (both switched off: every product here is float32 or
   float64 elementwise work, never a TF32 matrix product);
2. build the CUDA kernels from ``heatflow_tpu_torch/csrc`` through their
   normal first use and print the build time;
3. at the flagship shape (``cfgs/geballe_with_diamond.yaml``, 251 x 1107
   nodes) compare each phase kernel of ``cg_tol`` with its plain PyTorch
   version on numpy-seeded inputs, then one full solve of the first step's
   refinement system in the identity, r-line and ADI forms, timing kernel
   and plain version with CUDA events;
4. run the flagship transient (100 backward-Euler steps, the float32
   adaptive r-line/ADI recipe with one float64 refinement pass) through
   ``make_simulate_fn``: one warm-up run, then one timed run with the
   launch counters reset just before it; check the traces against the
   float64 truth in ``benchmarks/.flagship_truth_f64.npz``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cfgs", "geballe_with_diamond.yaml")
CSV = os.path.join(ROOT, "experimental_data", "geballe_heat_data.csv")
TRUTH = os.path.join(ROOT, "benchmarks", ".flagship_truth_f64.npz")
SOURCE = "heatflow_tpu_torch/csrc/cg_tol.cu"
REPLACES = "heatflow_tpu/ops/pallas_cg.py:308"
RECIPE = dict(rtol=1e-4, maxiter=8000, record_gradient=False,
              record_fields=False, rtol_wrt="r0", solver="auto",
              precondition="adaptive", warm_start="extrapolate",
              f64_refine=1)
TRACE_TOL_K = 1.0


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def require(ok: bool, what) -> None:
    """A check of this script: raises (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_max(a, b) -> float:
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def build_flagship():
    """The flagship problem through the port's entry points."""
    from heatflow_tpu_torch import (build_layout, build_structured_mesh,
                                    load_config)
    from heatflow_tpu_torch.geometry import coupler_watcher_points
    from heatflow_tpu_torch.sim.bc import HeatingCurve
    from heatflow_tpu_torch.sim.problem import build_problem
    cfg = load_config(CFG)
    domain, mats = build_layout(cfg)
    mesh = build_structured_mesh(domain, mats)
    heating = HeatingCurve.from_csv(CSV)
    return build_problem(mesh, heating, cfg,
                         watcher_points=coupler_watcher_points(cfg))


def first_step_system(problem, device):
    """The scaled operator and the first step's refinement system, as the
    stepper builds them: (A32, sm32, s32, free32, b32) with b32 the unit-norm
    float64 residual of the first step at its warm-start seed."""
    import math
    import torch
    from heatflow_tpu_torch.ops.stencil import apply_stencil, combine_operator
    from heatflow_tpu_torch.sim.stepper import interp
    d = problem.device_arrays(torch.float64, device)
    dt = torch.tensor(problem.dt, dtype=torch.float64, device=device)
    A, M_op = combine_operator(d["K"], d["M"], d["kappas"], d["rho_cvs"], dt)
    free, dirich = d["free"], d["dirichlet"]
    s = torch.rsqrt(torch.where(A[0] > 0, A[0], torch.ones_like(A[0]))) \
        * free + dirich
    ic = problem.ic_temp
    coeff = -4.0 * math.log(2.0) / problem.fwhm ** 2
    profile = torch.exp(coeff * d["r_sq"]) * d["heat_profile_base"]
    g0, g1 = ic * (dirich - profile), profile
    amp = interp(dt, d["heat_t"], d["heat_T"]) - (d["heat_T"][0] - ic)
    u0 = torch.full_like(free, ic)
    b_lift = (apply_stencil(M_op, u0)
              - (apply_stencil(A, g0) + amp * apply_stencil(A, g1))) * s
    y0 = (u0 / torch.where(s > 0, s, torch.ones_like(s))) * free
    r64 = b_lift * free - free * (s * apply_stencil(A, s * y0))
    b32 = (r64 / torch.sqrt(torch.sum(r64 * r64))).float()
    f32 = lambda t: t.float().contiguous()
    return f32(A), f32(s * free), f32(s), f32(free), b32


def phase_checks(problem, device, out: dict) -> list[dict]:
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.ops.stencil import apply_stencil

    A32, sm32, s32, free32, b32 = first_step_system(problem, device)
    pcr = cuda_cg.pcr_pack(A32, s32, free32).contiguous()
    pcr_z = cuda_cg.pcr_pack(A32, s32, free32, axis=-2).contiguous()
    nz, nr = b32.shape
    print(f"flagship grid {nz} x {nr}; r-stack {pcr.shape[0]} planes, "
          f"z-stack {pcr_z.shape[0]} planes")
    rng = np.random.default_rng(0)
    p = (torch.tensor(rng.standard_normal((nz, nr)), dtype=torch.float32,
                      device=device) * free32).contiguous()
    rows = []

    # stencil and <p, Ap>
    Ap_k, pap_k = cuda_cg.stencil_dot(A32, sm32, p)
    Ap_p, pap_p = cuda_cg.stencil_dot_reference(A32, sm32, p)
    err = float((Ap_k - Ap_p).abs().max())
    rel = rel_max(Ap_k, Ap_p)
    dot_rel = abs(float(pap_k - pap_p)) / abs(float(pap_p))
    require(rel <= 1e-5 and dot_rel <= 1e-5, ("stencil_dot", rel, dot_rel))
    rows.append(dict(name="cg_tol.stencil_dot", phase="stencil_dot",
                     max_abs_err=err, rel=rel, dot_rel=dot_rel,
                     ms=cuda_ms(lambda: cuda_cg.stencil_dot(A32, sm32, p),
                                50),
                     plain_ms=cuda_ms(
                         lambda: cuda_cg.stencil_dot_reference(A32, sm32, p),
                         50)))

    # r-line PCR, then z-line PCR with the ADI combine
    for name, phase, zst in (("cg_tol.pcr_r", "pcr_r", None),
                             ("cg_tol.pcr_z_adi", "pcr_z", pcr_z)):
        z_k, rz_k = cuda_cg.precond(sm32, p, pcr, zst)
        z_p, rz_p = cuda_cg.precond_reference(sm32, p, pcr, zst)
        err = float((z_k - z_p).abs().max())
        rel = rel_max(z_k, z_p)
        dot_rel = abs(float(rz_k - rz_p)) / abs(float(rz_p))
        require(rel <= 1e-4 and dot_rel <= 1e-5, (name, rel, dot_rel))
        rows.append(dict(
            name=name, phase=phase, max_abs_err=err, rel=rel,
            dot_rel=dot_rel,
            ms=cuda_ms(lambda: cuda_cg.precond(sm32, p, pcr, zst), 50),
            plain_ms=cuda_ms(
                lambda: cuda_cg.precond_reference(sm32, p, pcr, zst), 20)))

    for row in rows:
        print(f"phase {row['name']}: max|err| {row['max_abs_err']:.3e} "
              f"(rel {row['rel']:.3e}, dot rel {row['dot_rel']:.3e}), "
              f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")

    # full solves of the first step's refinement system. Its solution is
    # ~4e3 ||b||, so a float32 solve carries a rounding floor: its true
    # residual stalls near 1e-3 ||b|| and its distance to the float64
    # solution near 5e-4 (r-line/ADI forms), whatever the implementation.
    # The bounds are the stated ones (1e-4 agreement, 1.2 rtol ||b||
    # residual) where float32 reaches them, else the plain version's floor
    # on the same input, measured against the float64 solution.
    rtol = 1e-6
    x0 = torch.zeros_like(b32)
    op64 = lambda y: (sm32.double()
                      * apply_stencil(A32.double(), sm32.double() * y))
    norm = lambda v: float(torch.linalg.vector_norm(v.double()))
    ref = norm(b32)
    solves = {}
    for form, stacks in (("identity", {}), ("rline", {"pcr": pcr}),
                         ("adi", {"pcr": pcr, "pcr_z": pcr_z})):
        kw = dict(maxiter=20000, rtol_wrt="b", **stacks)
        x_k, it_k = cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw)
        x_p, it_p = cuda_cg.cg_tol_reference(A32, sm32, b32, x0, rtol, **kw)
        x64, _ = cuda_cg.cg_tol_reference(
            A32.double(), sm32.double(), b32.double(), x0.double(), rtol,
            maxiter=20000, rtol_wrt="b",
            **{k: v.double() for k, v in stacks.items()})
        it_k, it_p = int(it_k), int(it_p)
        rel_l2 = norm(x_k - x_p) / norm(x_p)
        err_k, err_p = norm(x_k - x64) / norm(x64), norm(x_p - x64) / norm(x64)
        res, res_p = norm(b32 - op64(x_k.double())), \
            norm(b32 - op64(x_p.double()))
        print(f"solve {form}: iters kernel {it_k} plain {it_p}; kernel vs "
              f"plain rel-L2 {rel_l2:.3e}; vs float64 solution kernel "
              f"{err_k:.3e} plain {err_p:.3e}; true residual kernel "
              f"{res / ref:.3e} plain {res_p / ref:.3e} x ||b||")
        require(abs(it_k - it_p) <= max(3, int(0.05 * it_p)),
                (form, it_k, it_p))
        require(rel_l2 <= max(1e-4, 2.0 * err_p), (form, rel_l2, err_p))
        require(err_k <= max(1e-4, 1.5 * err_p), (form, err_k, err_p))
        require(res <= 1.2 * max(rtol * ref, res_p), (form, res, res_p))
        ms = cuda_ms(lambda: cuda_cg.cg_tol(A32, sm32, b32, x0, rtol, **kw),
                     3)
        plain_ms = cuda_ms(
            lambda: cuda_cg.cg_tol_reference(A32, sm32, b32, x0, rtol, **kw),
            1)
        solves[form] = dict(iters=it_k, plain_iters=it_p, rel_l2=rel_l2,
                            err_vs_f64=err_k, plain_err_vs_f64=err_p,
                            true_res_over_ref=res / ref,
                            plain_true_res_over_ref=res_p / ref,
                            max_abs_err=float((x_k - x_p).abs().max()),
                            ms=ms, plain_ms=plain_ms)
        print(f"solve {form}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    out["solves"] = solves
    out["phases"] = rows
    return rows


def run_slice(problem, device, out: dict):
    import numpy as np
    import torch
    from heatflow_tpu_torch.ops import cuda_cg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn

    fn = make_simulate_fn(problem, dtype=torch.float32, device=device,
                          **RECIPE)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    cuda_cg.reset_counters()
    t0 = time.perf_counter()
    ys = fn()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = cuda_cg.phase_launches()
    solves = dict(total=cuda_cg.cg_tol.launches,
                  rline=cuda_cg.cg_tol.launches_rline,
                  adi=cuda_cg.cg_tol.launches_adi,
                  identity=cuda_cg.cg_tol.launches_identity)
    watch = ys["watch"].cpu().numpy()
    iters = ys["cg_iters"].cpu().numpy()
    require(np.isfinite(watch).all()
            and np.isfinite(ys["final_u"].cpu().numpy()).all(),
            "non-finite traces")
    require(solves["rline"] > 0 and solves["adi"] >= 1, solves)
    truth = np.load(TRUTH)["watch"]
    require(watch.shape == truth.shape, (watch.shape, truth.shape))
    peak = np.abs(watch - truth).max(axis=0)
    names = list(problem.watcher_names)
    steps_per_s = problem.num_steps / run_s
    print(f"slice: {problem.num_steps} steps in {run_s:.4f} s = "
          f"{steps_per_s:.2f} steps/s (warm-up run {warm_s:.2f} s); "
          f"cg_iters mean {iters.mean():.2f} max {int(iters.max())}; "
          f"ADI steps {solves['adi']}, r-line steps {solves['rline']}")
    print("slice peak |error| vs f64 truth [K]: "
          + ", ".join(f"{n} {e:.4f}" for n, e in zip(names, peak)))
    print(f"slice phase launches: {counts}")
    out["slice"] = dict(steps=problem.num_steps, run_s=run_s,
                        warm_run_s=warm_s, steps_per_s=steps_per_s,
                        cg_iters=iters.tolist(), solves=solves,
                        phase_launches=counts,
                        peak_err_K=dict(zip(names, peak.tolist())))
    require((peak <= TRACE_TOL_K).all(), f"trace error {peak} K > 1.0 K")
    return fn


def profile_slice(fn, path: str, out: dict) -> None:
    """One more run of the slice under torch.profiler: device time by
    kernel, and the device's busy and idle share of the run (kernel
    intervals merged, over the span from the first kernel's start to the
    last one's end). Writes the kernel table to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    require(spans, "the profiler saw no device time")
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, s1
        else:
            cur_e = max(cur_e, s1)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == cuda:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.end - e.time_range.start
            acc[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(path, "w") as f:
        f.write(f"profiled run: wall {wall_s * 1e3:.3f} ms (profiler on), "
                f"device span {span / 1e3:.3f} ms, device busy "
                f"{busy / 1e3:.3f} ms ({100 * busy / span:.2f}% of span)\n")
        f.write("device_ms  calls  mean_us  kernel\n")
        for name, (us, n) in rows:
            f.write(f"{us / 1e3:9.3f} {n:6d} {us / n:8.2f}  {name}\n")
    print(f"profile: wall {wall_s * 1e3:.1f} ms with the profiler on; "
          f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms span "
          f"(idle {100 * (1 - busy / span):.2f}%); "
          f"{sum(n for _, (_, n) in rows)} kernels; table in {path}")
    for name, (us, n) in rows[:8]:
        print(f"profile: {us / 1e3:8.3f} ms {n:6d} x  {name[:90]}")
    out["profile"] = dict(wall_s=wall_s, device_span_ms=span / 1e3,
                          device_busy_ms=busy / 1e3,
                          kernels={k: v for k, v in rows})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every measurement to this "
                                  "JSON file")
    ap.add_argument("--profile", help="profile one more run of the slice "
                                      "and write its kernel table here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    sys.path.insert(0, ROOT)
    from heatflow_tpu_torch.ops import _build, cuda_cg

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    out = {"card": smi[0], "torch": torch.__version__}

    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"kernel build + load: {build_s:.2f} s (nvcc "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    out["build_s"] = build_s

    t0 = time.perf_counter()
    problem = build_flagship()
    print(f"flagship setup (host): {time.perf_counter() - t0:.2f} s")
    rows = phase_checks(problem, device, out)
    fn = run_slice(problem, device, out)
    if args.profile:
        profile_slice(fn, args.profile, out)

    counts = out["slice"]["phase_launches"]
    solves = out["slice"]["solves"]
    kernels = [dict(name=r["name"], route="cuda", source=SOURCE,
                    replaces=REPLACES, launches=counts[r["phase"]],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"]) for r in rows]
    for form in ("rline", "adi"):
        sv = out["solves"][form]
        kernels.append(dict(name=f"cg_tol[{form}]", route="cuda",
                            source=SOURCE, replaces=REPLACES,
                            launches=solves[form],
                            max_abs_err=sv["max_abs_err"], ms=sv["ms"],
                            plain_ms=sv["plain_ms"]))
    require(all(k["launches"] > 0 for k in kernels), kernels)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(out, kernels=kernels), f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

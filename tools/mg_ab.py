#!/usr/bin/env python3
"""Time two trees' multigrid solves (K5, the mgz form of ``cg_tol``; K6,
``mgcg_vmem_tol``) in turns on one card.

    python3 tools/mg_ab.py [--parent DIR] [--out FILE.json]

DIR holds another checkout of the repo (for example ``git archive`` of the
parent commit, unpacked into an ignored directory). With it, the two trees
run in turns, parent, this tree, this tree, parent, each in a process of its
own (both packages are named ``heatflow_tpu_torch``); without it, this tree
runs once. Each run:

- solves the flagship's first-step system (``chip_smoke.first_step_system``)
  by mgz with one and with two coarse sweeps (rtol 1e-6 wrt ||b||) and by
  ``mgcg_vmem_tol`` (4 levels) at rtol 1e-3 and 1e-5 wrt r0: iterations, ms
  a solve by CUDA events (3 x 3 solves), launches an iteration from the
  phase counters, and one more solve under torch.profiler, split by this
  tree's ``chip_smoke.idle_split`` and ``k1_kernels`` whichever tree runs:
  each kernel's in-solve device time (us an iteration) and the idle time
  between launches;
- runs the flagship transient of ``chip_smoke`` (100 steps) with
  ``precondition='mgz'`` (1 and 2 coarse sweeps, ``f64_refine=1``, as in
  phase 15) alternated with the adaptive recipe ``chip_smoke.RECIPE``, one
  warm-up run each, then five timed turns: steps/s; and one profiled mgz
  run (one sweep): busy share, idle inside and between the solves, in-solve
  time by kernel;
- runs the 10 steps of phase 18's K6 path (every system by
  ``mgcg_vmem_tol`` at rtol 1e-5): seconds and iterations.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _split(split, prof, iters: int) -> dict:
    """A profiled solve (or run): busy share, idle split and in-solve device
    us by K1 kernel, per call and per iteration."""
    return dict(
        span_us=prof["span_us"], busy_us=prof["busy_us"],
        busy_pct=100 * prof["busy_us"] / prof["span_us"],
        **split.idle_split(prof),
        in_solve={k: dict(us=us, calls=c, us_per_iter=us / max(iters, 1))
                  for k, (us, c) in split.k1_kernels(prof).items()})


def worker(root: str, tag: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from heatflow_tpu_torch.ops import _build, cuda_cg, cuda_mg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn, mgz_operands
    if not torch.cuda.is_available():
        raise SystemExit("mg_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    spec = importlib.util.spec_from_file_location(
        "mg_ab_split", os.path.join(HERE, "chip_smoke.py"))
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    # a graph's loop body is traced in full only by profiler sessions that
    # began before the graph was captured: open the process's first one now
    split.kernel_profile(lambda: torch.ones(1, device=dev) + 1)
    _build.load_library()
    problem = cs.build_flagship()
    A32, sm32, s32, free32, b32 = cs.first_step_system(problem, dev)
    pcr = cuda_cg.pcr_pack(A32, s32, free32).contiguous()
    mgz = mgz_operands(problem, torch.float32, dev)
    setup = cuda_mg.build_mg_setup(*cs.flagship_operator(problem),
                                   problem.mesh.z, problem.mesh.r,
                                   n_levels=cs.MG_LEVELS, device=dev)
    x0 = torch.zeros_like(b32)
    res = dict(tag=tag, root=root)

    def measure(name, solve):
        cuda_cg.reset_counters()
        _, it = solve()
        torch.cuda.synchronize()
        it = int(it)
        launches = sum(cuda_cg.phase_launches().values())
        ms = [cs.cuda_ms(solve, 3) for _ in range(3)]
        prof = split.kernel_profile(solve)
        res[name] = dict(iters=it, ms=ms, us_per_iter=1e3 * min(ms) / it,
                         launches_per_iter=launches / it,
                         profile=_split(split, prof, it))
        print(f"{tag} {name}: {it} it., {min(ms):.3f}-{max(ms):.3f} ms, "
              f"{res[name]['us_per_iter']:.1f} us and "
              f"{launches / it:.2f} launches an iteration", flush=True)

    for sw in (1, 2):
        measure(f"mgz{sw}", lambda sw=sw: cuda_cg.cg_tol(
            A32, sm32, b32, x0, 1e-6, maxiter=20000, rtol_wrt="b", pcr=pcr,
            mgz=mgz, mgz_sweeps=sw))
    for rtol in (1e-3, 1e-5):
        measure(f"mg[{rtol:g}]", lambda rtol=rtol: cuda_mg.mgcg_vmem_tol(
            setup, b32, x0, rtol))

    base = dict(maxiter=8000, record_gradient=False, record_fields=False,
                rtol_wrt="r0", solver="auto")
    recipes = {
        "mgz1": dict(base, precondition="mgz", mgz_sweeps=1, f64_refine=1,
                     warm_start="extrapolate", rtol=1e-4),
        "mgz2": dict(base, precondition="mgz", mgz_sweeps=2, f64_refine=1,
                     warm_start="extrapolate", rtol=1e-4),
        "adaptive": dict(cs.RECIPE)}
    fns = {k: make_simulate_fn(problem, dtype=torch.float32, device=dev,
                               **kw) for k, kw in recipes.items()}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    runs = {k: [] for k in fns}
    iters = {}
    for _ in range(5):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            ys = fn()
            torch.cuda.synchronize()
            runs[k].append(problem.num_steps / (time.perf_counter() - t0))
            iters[k] = float(ys["cg_iters"].float().mean())
    res["flagship_steps_per_s"] = runs
    res["flagship_iters_mean"] = iters
    print(f"{tag} flagship steps/s: " + "; ".join(
        f"{k} {min(v):.2f}-{max(v):.2f} ({iters[k]:.2f} it. a step)"
        for k, v in runs.items()), flush=True)
    prof = split.kernel_profile(fns["mgz1"])
    total = int(round(iters["mgz1"] * problem.num_steps))
    res["mgz1_profile"] = _split(split, prof, total)

    mg_solver = lambda A, sm, b, x0_, rtol: cuda_mg.mgcg_vmem_tol(
        setup, b, x0_, rtol, maxiter=2000, rtol_wrt="r0")
    cs._patched_transient(problem, dev, 2, mg_solver, rtol=1e-5)
    _, its, run_s = cs._patched_transient(problem, dev, cs.MG_STEPS,
                                          mg_solver, rtol=1e-5)
    res["k6_path"] = dict(run_s=run_s, iters=its.tolist())
    print(f"{tag} K6 path: {cs.MG_STEPS} steps in {run_s:.4f} s, "
          f"iterations {its.tolist()}", flush=True)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("MGAB " + json.dumps(worker(*args.worker)), flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    order = ([(args.parent, "parent"), (HERE, "new"), (HERE, "new"),
              (args.parent, "parent")] if args.parent else [(HERE, "new")])
    results = []
    for root, tag in order:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker", os.path.abspath(root), tag],
                           capture_output=True, text=True)
        print("\n".join(ln for ln in p.stdout.splitlines()
                        if not ln.startswith("MGAB ")), flush=True)
        if p.returncode != 0:
            raise SystemExit(f"mg_ab: the {tag} run failed:\n{p.stderr}")
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("MGAB ")]
        results.append(json.loads(line[-1][5:]))
    for r in results:
        for name in [k for k in r if k.startswith(("mgz", "mg["))
                     and "profile" in r[k]]:
            pr = r[name]["profile"]
            print(f"{r['tag']} {name} in-solve: idle between launches "
                  f"{pr['idle_in_solves_us']:.1f} us of a "
                  f"{pr['solve_span_us']:.1f} us span; " + ", ".join(
                      f"{k} {v['us_per_iter']:.2f}"
                      for k, v in sorted(pr["in_solve"].items(),
                                         key=lambda kv: -kv[1]["us"]))
                  + " us an iteration", flush=True)
        pr = r["mgz1_profile"]
        print(f"{r['tag']} profiled mgz flagship run: busy "
              f"{pr['busy_pct']:.2f}% of {pr['span_us'] / 1e3:.3f} ms; "
              f"{pr['solves']} solves spanning "
              f"{pr['solve_span_us'] / 1e3:.3f} ms, idle between launches "
              f"in solves {pr['idle_in_solves_us'] / 1e3:.3f} ms, between "
              f"solves {pr['idle_between_solves_us'] / 1e3:.3f} ms",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, runs=results), f, indent=1)


if __name__ == "__main__":
    main()

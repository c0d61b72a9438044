#!/usr/bin/env python3
"""Time two trees' K2 / K3 (``cg_batched_tol``, the sweeps' batched CG) in
turns on one card.

    python3 tools/k2_ab.py --parent DIR [--runs N] [--out FILE.json]

DIR holds another checkout of the repo (for example ``git archive`` of the
parent commit, unpacked into an ignored directory). The two trees run in
turns, parent, this tree, this tree, parent, each in a process of its own
(both packages are named ``heatflow_tpu_torch``), on the sweep config
(``cfgs/geballe_no_diamond.yaml``, 243 x 1001, 40 steps) with the recipes
of ``chip_smoke.py``: the B = 1024 Jacobi sweep, the B = 256 recording
sweep, the B = 64 ADI and adaptive sweeps (one warm-up run each, then N
timed runs, configs/s), then one more run of the B = 1024 sweep and of the
B = 64 ADI sweep under torch.profiler, split by this tree's
``chip_smoke.k2_kernels``: each K2 kernel's device time per lane-iteration
and per call, the device's busy share, and the device time per
lane-iteration. Every figure is printed with its spread over the turns of
each tree.
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


def worker(root: str, tag: str, n_runs: int) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    import chip_smoke as cs
    from heatflow_tpu_torch.ops import _build
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn_recording,
                                                    run_sweep_time_chunked)
    if not torch.cuda.is_available():
        raise SystemExit("k2_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    # this tree's profile split, loaded by path (the other tree's
    # chip_smoke may not have it)
    spec = importlib.util.spec_from_file_location(
        "k2_ab_split", os.path.join(HERE, "chip_smoke.py"))
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    _build.load_library()
    problem = cs.build_flagship(cs.SWEEP_CFG)
    f32 = dict(dtype=torch.float32, device=dev)

    def sweep(B, **kw):
        ks, fs = np.logspace(0.0, 2.0, B), np.full(B, problem.fwhm)
        return lambda **more: run_sweep_time_chunked(problem, ks, fs, **kw,
                                                     **f32, **more)

    def recording(B):
        fn = make_sweep_fn_recording(problem, **{**cs.REC_RECIPE, **f32})
        ks, fs = np.logspace(0.0, 2.0, B), np.full(B, problem.fwhm)
        return lambda **more: fn(ks, fs, **more)

    cells = {
        "sweep_1024": (cs.SWEEP_B, sweep(cs.SWEEP_B, **cs.SWEEP_RECIPE)),
        "recording_256": (cs.REC_B, recording(cs.REC_B)),
        **{f"{name}_{cs.ADI_B}": (cs.ADI_B, sweep(
            cs.ADI_B, **recipe, solver="vmem", step_chunk=problem.num_steps))
           for name, recipe in cs.ADI_RECIPES.items()}}
    res = dict(tag=tag, root=root)
    for name, (B, run) in cells.items():
        run()
        torch.cuda.synchronize()
        cps = []
        for _ in range(n_runs):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            cps.append(B / (time.perf_counter() - t0))
        res[name] = dict(B=B, configs_per_s=cps)
    for name in ("sweep_1024", f"adi_{cs.ADI_B}"):
        its = []
        prof = split.kernel_profile(lambda: cells[name][1](iters_out=its))
        lane_iters = int(torch.stack(its).sum())
        res[name]["profile"] = dict(
            busy_pct=100 * prof["busy_us"] / prof["span_us"],
            lane_iterations=lane_iters,
            us_per_lane_iteration=prof["busy_us"] / lane_iters,
            kernels={k: dict(us_per_lane_iteration=us / lane_iters,
                             us_per_call=us / c, calls=c)
                     for k, (us, c) in split.k2_kernels(prof).items()})
    return res


def spread(vals) -> str:
    lo, hi = min(vals), max(vals)
    return f"{lo:.4f}-{hi:.4f} ({100 * (hi - lo) / lo:.1f} %)"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--runs", type=int, default=2,
                    help="timed runs of each sweep in each turn")
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("K2AB " + json.dumps(worker(*args.worker, args.runs)),
              flush=True)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    results = []
    for root, tag in ((args.parent, "parent"), (HERE, "new"), (HERE, "new"),
                      (args.parent, "parent")):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--parent", args.parent, "--runs",
                            str(args.runs), "--worker",
                            os.path.abspath(root), tag],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"k2_ab: the {tag} run failed:\n{p.stderr}")
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("K2AB ")]
        r = json.loads(line[-1][5:])
        results.append(r)
        cells = [k for k, v in r.items() if isinstance(v, dict)]
        print(f"{tag}: " + "; ".join(
            f"{k} " + ", ".join(f"{c:.4f}" for c in r[k]["configs_per_s"])
            + " configs/s" for k in cells), flush=True)
        for k in cells:
            pr = r[k].get("profile")
            if pr:
                print(f"{tag} {k} profiled: busy {pr['busy_pct']:.2f}%, "
                      f"{pr['us_per_lane_iteration']:.3f} us a "
                      f"lane-iteration; " + ", ".join(
                          f"{n} {v['us_per_lane_iteration']:.4f} us/lane-it "
                          f"({v['us_per_call']:.2f} us x {v['calls']})"
                          for n, v in sorted(pr["kernels"].items())),
                      flush=True)
    print("spread over the turns of each tree (min-max, and max over min "
          "less 1):")
    for tag in ("parent", "new"):
        mine = [r for r in results if r["tag"] == tag]
        cells = [k for k, v in mine[0].items() if isinstance(v, dict)]
        for k in cells:
            print(f"  {tag} {k} configs/s: "
                  + spread([c for r in mine for c in r[k]["configs_per_s"]]))
            if "profile" in mine[0][k]:
                print(f"  {tag} {k} us a lane-iteration: " + spread(
                    [r[k]["profile"]["us_per_lane_iteration"] for r in mine]))
                names = set().union(*(r[k]["profile"]["kernels"]
                                      for r in mine))
                for n in sorted(names):
                    vals = [r[k]["profile"]["kernels"].get(n, {}).get(
                        "us_per_lane_iteration", 0.0) for r in mine]
                    print(f"  {tag} {k} {n} us/lane-it: " + spread(vals)
                          if min(vals) > 0 else
                          f"  {tag} {k} {n} us/lane-it: {vals}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, runs=results), f, indent=1)


if __name__ == "__main__":
    main()

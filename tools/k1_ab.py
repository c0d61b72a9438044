#!/usr/bin/env python3
"""Time two trees' K1 (``cg_tol``) in turns on one card.

    python3 tools/k1_ab.py --parent DIR [--out FILE.json]

DIR holds another checkout of the repo (for example ``git archive`` of the
parent commit, unpacked into an ignored directory). The two trees run in
turns, parent, this tree, this tree, parent, each in a process of its own
(both packages are named ``heatflow_tpu_torch``): the flagship's first-step
refinement system (``chip_smoke.first_step_system``) solved by the r-line,
ADI and identity forms at rtol 1e-6 wrt ||b|| (iterations; ms a solve by
CUDA events, 3 x 5 solves), then the flagship transient of
``chip_smoke.RECIPE`` (one warm-up run, five timed runs, steps/s), then
one more run under torch.profiler, split by this tree's
``chip_smoke.idle_split`` and ``k1_kernels`` whichever tree runs: the
device's busy share, its idle time inside the solves (between launches,
and after host reads of the stop flag) and between them, and the in-solve
device time of each K1 kernel.
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


def worker(root: str, tag: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import chip_smoke as cs
    from heatflow_tpu_torch.ops import _build, cuda_cg
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    # this tree's profile split, loaded by path (the other tree's
    # chip_smoke may not have it)
    spec = importlib.util.spec_from_file_location(
        "k1_ab_split", os.path.join(HERE, "chip_smoke.py"))
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    # a graph's loop body is traced in full only by profiler sessions that
    # began before the graph was captured: open the process's first one now
    split.kernel_profile(lambda: torch.ones(1, device=dev) + 1)
    _build.load_library()
    problem = cs.build_flagship()
    A32, sm32, s32, free32, b32 = cs.first_step_system(problem, dev)
    pcr = cuda_cg.rline_pack(A32, s32, free32)
    pcr_z = cuda_cg.zline_pack(A32, s32, free32)
    x0 = torch.zeros_like(b32)
    res = dict(tag=tag, root=root)
    for form, st in (("rline", dict(pcr=pcr)),
                     ("adi", dict(pcr=pcr, pcr_z=pcr_z)), ("identity", {})):
        kw = dict(maxiter=20000, rtol_wrt="b", **st)
        _, it = cuda_cg.cg_tol(A32, sm32, b32, x0, 1e-6, **kw)
        ms = [cs.cuda_ms(lambda: cuda_cg.cg_tol(A32, sm32, b32, x0, 1e-6,
                                                **kw), 5) for _ in range(3)]
        res[form] = dict(iters=int(it), ms=ms)
    fn = make_simulate_fn(problem, dtype=torch.float32, device=dev,
                          **cs.RECIPE)
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        ys = fn()
        torch.cuda.synchronize()
        runs.append(problem.num_steps / (time.perf_counter() - t0))
    res["flagship_steps_per_s"] = runs
    res["flagship_iters_mean"] = float(ys["cg_iters"].float().mean())
    res["flagship_iters"] = int(ys["cg_iters"].sum())
    prof = split.kernel_profile(fn)
    res["profile"] = dict(
        span_us=prof["span_us"], busy_us=prof["busy_us"],
        busy_pct=100 * prof["busy_us"] / prof["span_us"],
        **split.idle_split(prof),
        in_solve={k: dict(us=us / c, calls=c)
                  for k, (us, c) in split.k1_kernels(prof).items()})
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out")
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "TAG"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print("K1AB " + json.dumps(worker(*args.worker)), flush=True)
        return
    here = HERE
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    results = []
    for root, tag in ((args.parent, "parent"), (here, "new"), (here, "new"),
                      (args.parent, "parent")):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--parent", args.parent, "--worker",
                            os.path.abspath(root), tag],
                           capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"k1_ab: the {tag} run failed:\n{p.stderr}")
        line = [ln for ln in p.stdout.splitlines() if ln.startswith("K1AB ")]
        r = json.loads(line[-1][5:])
        results.append(r)
        print(f"{tag}: r-line {r['rline']['iters']} it. "
              f"{min(r['rline']['ms']):.3f} ms; ADI {r['adi']['iters']} it. "
              f"{min(r['adi']['ms']):.3f} ms; identity "
              f"{r['identity']['iters']} it. {min(r['identity']['ms']):.3f} "
              f"ms; flagship steps/s "
              + ", ".join(f"{v:.2f}" for v in r["flagship_steps_per_s"]),
              flush=True)
        pr = r["profile"]
        print(f"{tag} profiled flagship run: busy {pr['busy_pct']:.2f}% of "
              f"{pr['span_us'] / 1e3:.3f} ms; {pr['solves']} solves, "
              f"{r['flagship_iters']} iterations, span "
              f"{pr['solve_span_us'] / 1e3:.3f} ms; idle between launches "
              f"in solves {pr['idle_in_solves_us'] / 1e3:.3f} ms, after "
              f"{pr['host_reads']} host reads "
              f"{pr['idle_after_host_reads_us'] / 1e3:.3f} ms, between "
              f"solves {pr['idle_between_solves_us'] / 1e3:.3f} ms; in-solve "
              + ", ".join(f"{k} {v['us']:.2f} us x {v['calls']}"
                          for k, v in sorted(pr["in_solve"].items())),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, runs=results), f, indent=1)


if __name__ == "__main__":
    main()

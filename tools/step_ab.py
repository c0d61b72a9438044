#!/usr/bin/env python3
"""Time the flagship transient's two step paths in turns on one card.

    python3 tools/step_ab.py [--rounds N] [--out FILE.json]

The flagship transient of ``chip_smoke.RECIPE`` (100 steps, float32
adaptive r-line/ADI, one float64 refinement pass) through one
``make_simulate_fn`` module two ways, in one process: the kernel path's
CUDA graph (the steps under a conditional WHILE node, one launch a run)
and the eager loop (``forward_eager``: the step's eager work, the K1
wrapper and one host read a step). Each is captured and warmed once, then
timed in turns (graph, eager, eager, graph) ``--rounds`` times: steps/s by
the host's clock around a run that ends in a synchronize. Then one more
run of each under torch.profiler, split by ``chip_smoke.idle_split``: the
device's busy share, its idle time between the solves (and before the
first) and the host reads between them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", help="write the measurements here (JSON)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("step_ab: no CUDA device")
    import chip_smoke as cs
    from heatflow_tpu_torch.ops import _build
    from heatflow_tpu_torch.sim.stepper import make_simulate_fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    dev = torch.device("cuda", 0)
    cs.kernel_profile(lambda: torch.ones(1, device=dev) + 1)
    _build.load_library()
    problem = cs.build_flagship()
    fn = make_simulate_fn(problem, dtype=torch.float32, device=dev,
                          **cs.RECIPE)
    run = {"graph": fn, "eager": fn.forward_eager}
    for kind in run:
        run[kind]()
        torch.cuda.synchronize()
    steps = {k: [] for k in run}
    for _ in range(args.rounds):
        for kind in ("graph", "eager", "eager", "graph"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run[kind]()
            torch.cuda.synchronize()
            steps[kind].append(problem.num_steps
                               / (time.perf_counter() - t0))
    res = dict(card=card, rounds=args.rounds, steps_per_s=steps)
    for kind, v in steps.items():
        print(f"{kind}: steps/s {min(v):.2f}-{max(v):.2f} over {len(v)} "
              f"runs (mean {sum(v) / len(v):.2f})", flush=True)
    for kind in run:
        prof = cs.kernel_profile(run[kind])
        split = cs.idle_split(prof)
        busy = 100 * prof["busy_us"] / prof["span_us"]
        res[f"profile_{kind}"] = dict(busy_pct=busy,
                                      span_ms=prof["span_us"] / 1e3,
                                      split=split)
        print(f"{kind} profiled: busy {busy:.2f}% of "
              f"{prof['span_us'] / 1e3:.3f} ms; {split['solves']} solves, "
              f"idle between solves "
              f"{split['idle_between_solves_us'] / 1e3:.3f} ms (before the "
              f"first {split['idle_before_first_solve_us'] / 1e3:.3f}), "
              f"{split['host_reads_between_solves']} host reads between "
              f"solves", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()

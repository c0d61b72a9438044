"""The benchmark of heatflow_tpu_torch on one NVIDIA GPU.

How to run: from the root of a checkout,
``python3 hfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``: it builds the cell's problem, loads
(or at the first run in the checkout, builds with nvcc) the port's CUDA
library, warms up the cell's own shapes, measures a window of ``--seconds``
(with ``--trace 1``, a fixed number of units under torch.profiler instead),
compares a sample of the answers with the float64 reference, and prints
one JSON line last: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``breakdown`` when traced) and, last, ``checks``, each number
compared beside its limit, as the last lines of standard error too. The
port keeps its compiled library in ``build/heatflow_tpu_torch/`` of the
checkout; the caches this script sets (``TRITON_CACHE_DIR``,
``TORCH_EXTENSIONS_DIR``, ``CUDA_CACHE_PATH``) are fixed directories under
``build/hfbench/``. A later change adds, without editing a file here: a
cell as ``hfbench/workloads/<cell>.json`` (its configuration, traffic
family, parameters and limits) with its entry in ``BENCHMARK.json``; a
configuration as ``hfbench/configs/<config>.json``, which may name its
mesh under a top-level ``mesh`` key (``{"kind": "structured"}``, the
default, or ``{"kind": "triangulation"}``, the graded non-grid
triangulation that ``run2d --mesh-style unstructured`` builds); a traffic
family as
``hfbench/traffic/<family>.py`` (``setup(run)`` and ``unit(run, i)``); a
per-layer metric as ``hfbench/metrics/<metric>.py`` (``read(run)``, None
where it finds nothing) with its entry in ``BENCHMARK.json``, or the entry
alone where the reader of a dotted prefix of its name serves it
(``k2_roofline.record`` is read by ``k2_roofline.py``). A window
runs until ``--seconds`` have passed and its draws make whole sets of the
cell's ``draw_set``.

Exits with another code than 0, and prints no result, without a CUDA
device, and if the process has loaded JAX or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR":
          "torch_extensions", "CUDA_CACHE_PATH": "nv_compute"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, "build", "hfbench", sub)
    # one profiler session a process; CUPTI kept between sessions (a torn
    # down CUPTI can miss a CUDA graph's loop body)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    from hfbench import harness
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next(w["chips"] for w in spec["workloads"]
                 if w["name"] == args.workload)
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", T_PROCESS)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"the run loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for c in line["checks"]:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

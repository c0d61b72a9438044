"""The control of a cell's comparison, read at the cell's own size: the
reference put in the program's place, computed one precision below the
configuration's float32 (the operators' entries, the state after every
step and the rows in bfloat16, ``fem.bf16_round``; each solve exact), and
judged by the cell's numbers against the float64 reference. Where the
cell holds steps to the recipe's stopping rule (a ``step_resid`` limit),
the state-only control is read too: the recipe's own solve to its
tolerance in float64, only the state kept in bfloat16, its residual read
at the ends of the recipe's time chunks (``state_resid``) beside its gaps
(``state_*``).

``python3 hfbench/control.py --workload <cell> --seeds 1 2 3 --jobs 3``
prints one JSON line a seed: the draws it took (``check_samples`` of the
cell's box, at indices drawn from the seed) and each number's reading
(``--device cuda`` runs the stopping rule's iterations on the card).
"""

import argparse
import json
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def chunk_ends(total: int, step_chunk: int) -> list[int]:
    """The steps that end the recipe's ceil-balanced time chunks."""
    n = max(1, -(-total // max(1, step_chunk)))
    size = min(-(-total // n), total)
    return list(range(size, total + 1, size))


def readings(cell: str, seed: int, overrides: dict | None = None,
             root: str = ROOT, device: str = "cpu") -> dict:
    """{seed, kappa, fwhm, readings}: the bfloat16 control's widest
    readings over the seed's ``check_samples`` draws."""
    from hfbench import check, draws, harness
    from hfbench.reference.fem import bf16_round
    run = harness.new_run(cell, seed, root=root, overrides=overrides)
    ref = check.reference_for(run)
    ic = float(run.cfg["heating"]["ic_temp"])
    record = "band_gap_rel" in run.params["limits"]
    n = int(run.params["check_samples"])
    start = int(draws.rng(seed, 2).integers(0, 1000))
    d = run.draws(start, n)
    worst: dict[str, float] = {}
    for kappa, fwhm in zip(d["kappa"], d["fwhm"]):
        want = ref.run(float(kappa), float(fwhm), record=record)
        got = ref.run(float(kappa), float(fwhm), record=record, bf16=True)
        for k, v in check.gaps(got, want, ic).items():
            worst[k] = max(worst.get(k, 0.0), v)
        if "step_resid" in run.params["limits"]:
            recipe = run.params["recipe"]
            rule = ref.run_rule(float(kappa), float(fwhm),
                                rtol=float(recipe["rtol"]),
                                maxiter=int(recipe.get("maxiter", 4000)),
                                state=bf16_round, device=device)
            ends = chunk_ends(ref.num_steps, int(recipe["step_chunk"]))
            states = np.concatenate([np.full((1,) + rule["states"].shape[1:],
                                             ref.ic), rule["states"]])
            res = ref.step_residuals(float(kappa), float(fwhm), ends,
                                     states[[e - 1 for e in ends]],
                                     states[ends])
            one = {"state_resid": min(res)}
            one.update({f"state_{k}": v for k, v in check.gaps(
                {"watch": rule["watch"]}, want, ic).items()})
            for k, v in one.items():
                worst[k] = min(worst.get(k, np.inf), v) \
                    if k == "state_resid" else max(worst.get(k, 0.0), v)
    return dict(seed=seed, kappa=d["kappa"].tolist(),
                fwhm=d["fwhm"].tolist(), readings=worst)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    with ProcessPoolExecutor(
            args.jobs, mp_context=multiprocessing.get_context("spawn")
    ) as pool:
        futures = [pool.submit(readings, args.workload, s,
                               device=args.device)
                   for s in args.seeds]
        for f in futures:
            print(json.dumps(dict(workload=args.workload, **f.result())),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

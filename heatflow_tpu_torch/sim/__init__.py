from heatflow_tpu_torch.sim.problem import Problem2D, build_problem
from heatflow_tpu_torch.sim.stepper import (TransientResult, make_simulate_fn,
                                            run_transient)

__all__ = [
    "Problem2D",
    "build_problem",
    "TransientResult",
    "run_transient",
    "make_simulate_fn",
]

from heatflow_tpu_torch.sim.problem import Problem2D, build_problem
from heatflow_tpu_torch.sim.stepper import (TransientResult, make_simulate_fn,
                                            run_transient)
from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                make_sweep_fn_recording,
                                                run_sweep_time_chunked)

__all__ = [
    "Problem2D",
    "build_problem",
    "TransientResult",
    "run_transient",
    "make_simulate_fn",
    "make_sweep_fn",
    "make_sweep_fn_recording",
    "run_sweep_time_chunked",
]

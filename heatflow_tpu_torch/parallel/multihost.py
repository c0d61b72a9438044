"""Multi-process (multi-host) sweeps over ``torch.distributed``.

The reference's only parallelism is a single-machine process pool (ref
parameter_sweep.py:436-446). Past one host every process runs the same
program: :func:`initialize` joins them into one process group, the global
mesh spans every rank, and a sweep's batch is sharded over its 'config'
axis. Nothing crosses between processes during a solve: each rank
integrates its configs and one ``all_gather`` returns the full traces to
every process (the twin of ``heatflow_tpu/parallel/multihost.py``).
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from heatflow_tpu_torch.parallel.sharding import (DeviceMesh, config_mesh,
                                                  default_backend)
from heatflow_tpu_torch.utils import pad_to_multiple


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, backend: str | None = None,
               device="cuda", timeout: float = 1800.0) -> None:
    """Join this process into a group of ``num_processes`` over
    ``tcp://coordinator_address`` ('host:port'; process 0 listens there).
    ``backend``: 'nccl' for a CUDA ``device``, 'gloo' for the CPU by
    default; 'gloo' on CUDA lets several processes share one card."""
    backend = backend or default_backend(device)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout))


def global_config_mesh(z_shards: int = 1, device="cuda") -> DeviceMesh:
    """A ('config', 'z') mesh over every rank of the process group."""
    return config_mesh(z_shards=z_shards, device=device)


def distribute_batch(mesh: DeviceMesh, full_batch) -> torch.Tensor:
    """This rank's shard of a full batch array that every process holds
    (the batch length a multiple of the 'config' size: pad first), as a
    tensor on the mesh's device."""
    full_batch = np.asarray(full_batch)
    return torch.as_tensor(full_batch[mesh.config_slice(len(full_batch))],
                           device=mesh.device)


def gather_to_all(mesh: DeviceMesh, x) -> np.ndarray:
    """Every rank's shard of a result, gathered along the batch axis into
    rank order on every process, as numpy."""
    return mesh.gather(torch.as_tensor(x, device=mesh.device),
                       "config").cpu().numpy()


def run_sweep_multihost(problem, sample_k, fwhm, *, dtype=None,
                        fixed_iters: int | None = None, rtol: float = 1e-6,
                        maxiter: int = 4000, num_steps: int | None = None,
                        z_shards: int = 1, solver: str = "xla",
                        warm_start: str = "previous",
                        record_gradient: bool = False,
                        rtol_wrt: str = "b", f64_refine: int = 0,
                        precondition: str = "jacobi", device="cuda"):
    """A sweep over every rank of the process group: every process calls it
    with the same arguments and gets the full (B, S, W) traces as numpy, or
    with ``record_gradient=True`` the full artifact dict (watch, band, axis,
    times), the reference's per-run artifacts (ref
    parameter_sweep.py:157-166).

    Dispatches on the problem kind, structured or unstructured (the
    reference's fan-out does not depend on it, ref :436-446): the global
    mesh, the batch padded to its 'config' size, the sweep makers under
    ``mesh=`` (each rank's lanes through K2 / K3 with ``solver='vmem'``),
    and the gather. ``device``: each rank's device type ('cuda': the card
    of its local rank)."""
    from heatflow_tpu_torch.sim.sweepkernel import (make_sweep_fn,
                                                    make_sweep_fn_recording)
    from heatflow_tpu_torch.sim.unstructured import (
        ProblemUnstructured, make_sweep_fn_unstructured)

    dtype = dtype or torch.float32
    mesh = global_config_mesh(z_shards=z_shards, device=device)
    ks = np.atleast_1d(np.asarray(sample_k))
    fs = np.atleast_1d(np.asarray(fwhm))
    B = len(ks)
    ks = pad_to_multiple(ks, mesh.shape["config"])
    fs = pad_to_multiple(fs, mesh.shape["config"])
    kw = dict(dtype=dtype, fixed_iters=fixed_iters, rtol=rtol,
              maxiter=maxiter, warm_start=warm_start, solver=solver,
              rtol_wrt=rtol_wrt, f64_refine=f64_refine,
              precondition=precondition, mesh=mesh)
    if isinstance(problem, ProblemUnstructured):
        if num_steps is not None and solver != "vmem":
            # the eager unstructured maker has no segment API: the full
            # transient would break the (B, num_steps, W) contract
            raise ValueError("num_steps on unstructured multihost sweeps "
                             "needs solver='vmem' (the segmented overlay "
                             "engine)")
        fn = make_sweep_fn_unstructured(problem, num_steps=num_steps,
                                        record_gradient=record_gradient,
                                        **kw)
    elif record_gradient:
        fn = make_sweep_fn_recording(problem, **kw)
    else:
        fn = make_sweep_fn(problem, num_steps=num_steps, **kw)
    out = fn(ks, fs)
    if isinstance(out, dict):
        res = {k: v[:B].cpu().numpy() for k, v in out.items()
               if k in ("watch", "band", "axis")}
        res["times"] = np.asarray(out["times"])
        return res
    return out[:B].cpu().numpy()

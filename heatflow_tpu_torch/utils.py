"""Small shared utilities: the device an entry point runs on, profiling
and the program's spans, batch padding, the drivers' per-regime
preconditioner default and matplotlib at first use."""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch device. The entry points run on the card unless
    the caller asks for the CPU: a CUDA device must exist (there is no quiet
    fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available (pass device='cpu', or --device cpu "
                           "on a command line, to run on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def pyplot(show: bool):
    """``matplotlib.pyplot``, imported at first use (the port has no
    plotting dependency until a figure is asked for). A process whose first
    figure is not to be shown gets the non-interactive Agg backend, so that
    plots are written without a display."""
    if not show and "matplotlib.pyplot" not in sys.modules:
        import matplotlib
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def finish_figure(fig, save_path=None, show: bool = False,
                  dpi: int = 300) -> None:
    """Save ``fig`` (when a path is given), then show it or close it."""
    plt = pyplot(show)
    if save_path:
        fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
    if show:
        plt.show()
    else:
        plt.close(fig)


@contextlib.contextmanager
def profile_trace(outdir: str | None):
    """Record a ``torch.profiler`` trace (CPU and, when a card is present,
    CUDA activity) around the wrapped block and write it into ``outdir`` as
    a Chrome trace (``trace.json``, viewable in Perfetto); no-op when
    ``outdir`` is empty."""
    if not outdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"Profiler trace written to {path}")


def span(name: str) -> _RecordFunctionFast:
    """A named range of the host's timeline, for ``with``: under a running
    ``torch.profiler`` session a host event of kind ``cpu_op``, on the
    clock of the device events (so a reader can lay it against the
    device's gaps) and in :func:`profile_trace`'s ``trace.json``; never a
    device event. With no profiler recording it costs a fraction of a
    microsecond and touches no tensor. The program's span names, and the
    metrics that read them, are listed in PERF.md §3."""
    return _RecordFunctionFast(name)


def pad_to_multiple(arr, m: int):
    """Pad a 1D batch array to a multiple of m by repeating its last element
    (padded lanes recompute the last config and are sliced away by
    callers)."""
    arr = np.asarray(arr)
    pad = (-len(arr)) % m
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad)])
    return arr


def resolve_recording_precondition(record_gradient: bool,
                                   dtype: torch.dtype, *,
                                   unstructured_xla: bool = False,
                                   fixed_iters=None,
                                   batched: bool = False,
                                   unstructured: bool = False,
                                   f64_refine: int = 0,
                                   vmem_single: bool = False,
                                   rtol_wrt: str = "r0") -> str:
    """The drivers' default CG preconditioner for a regime; the JAX
    package's map (its ``utils.resolve_recording_precondition``):

    - float64, a fixed iteration budget, or the unstructured eager path:
      'jacobi';
    - batched sweeps and overlay meshes: 'rline' when recording gradients,
      'jacobi' otherwise;
    - single float32 runs with ``f64_refine``: 'adaptive' when the stepper's
      kernel path will run (``vmem_single``: the per-step r-line/ADI switch
      lives in the ``cg_tol`` kernel path), 'rline' otherwise;
    - single float32 runs stopping wrt ‖b‖: 'rline' when recording, else
      'jacobi';
    - single float32 runs stopping wrt ‖r0‖ (the 2D driver): 'adi'.
    """
    if not (dtype == torch.float32 and fixed_iters is None
            and not unstructured_xla):
        return "jacobi"
    if batched or unstructured:
        return "rline" if record_gradient else "jacobi"
    if f64_refine:
        return "adaptive" if vmem_single else "rline"
    if rtol_wrt != "r0":
        return "rline" if record_gradient else "jacobi"
    return "adi"

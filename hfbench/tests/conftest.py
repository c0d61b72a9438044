"""The benchmark's own tests: ``python -m pytest hfbench/tests -q`` from the
root of the repository (on the CPU; the test marked ``cuda`` runs a cell on
the card and skips elsewhere)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# each cell at a size a CPU test holds: coarser grids, four lanes, the
# kernels' plain versions. On the coarse sweep grid the band rows of a wide
# beam hold a few nodes of weak gradient, and a sound run's band gap reads
# up to 0.8 there (0.25 at full width): the recording sweep's band limit
# is 2 at this size. A traced flagship run profiles one transient: on the
# CPU each of its eager operations is a profiler event, ~6 GB a transient
SMALL = {
    "flagship.transient": {"size_scale": 16.0, "draw_set": 2,
                           "recipe": {"solver": "vmem"}, "trace_units": 1},
    "sweep.b1024": {"size_scale": 8.0, "batch": 4, "draw_set": 4},
    "sweep.record_b256": {"size_scale": 8.0, "batch": 4, "draw_set": 4,
                          "limits": {"band_gap_rel": 2.0}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


@pytest.fixture
def small():
    """Overrides that shrink each cell to a CPU test's size."""
    return SMALL


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

"""Set-up: from the start of the run's process to its first timed call
(imports, the host problem, the library load or build, the module, the
warm-up call)."""


def read(run):
    return run.setup["total_s"]

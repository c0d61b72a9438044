"""Device set-up: the library load (or build), the module's operators and
factorisations, graph capture and the warm-up call, by the host clock,
ending in a synchronize."""


def read(run):
    return run.setup["device_s"]

"""Host set-up: the configuration's layout, mesh, stencils and problem
(``build_layout`` .. ``build_problem``), by the host clock."""


def read(run):
    return run.setup["host_s"]

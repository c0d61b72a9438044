"""Command-line drivers of the port: ``run2d`` (one 2D transient) and
``sweep`` (the parameter sweep)."""

"""Command-line drivers of the port: ``run2d`` (one 2D transient),
``sweep`` (the parameter sweep) and ``fit`` (the gradient-based (κ, FWHM)
fit)."""

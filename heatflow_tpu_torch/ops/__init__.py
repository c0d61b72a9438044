"""Operators: P1 element integrals, stencils, PCG, line PCR, the CUDA CG."""

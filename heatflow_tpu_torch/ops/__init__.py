"""Operators: P1 element integrals, stencils, PCG, line PCR, the CUDA CG
for one problem and for a batch of sweep lanes."""

"""Multi-scalar multiplication: variable-base Pippenger (CUDA kernels) and fixed-base tables."""

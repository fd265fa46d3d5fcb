"""Cholesky / inverse ops and their CUDA kernels."""

"""The least time one NVIDIA H100 could take for a kernel's work, and the
work each kernel of the program's hot path does, counted from its
shapes.

Frozen copy of `chip_smoke.py` (`_bound`, `_tri`, `_kinv_logdet_bound`,
`_chol_linv_bound`, `_ipm_flops`, `_ipm_bound` and the two peaks) at
commit 1797f6cfa163b15fd5c129cc3ad66940ebf95206; the benchmark reads this
copy, so a later change of the program's own arithmetic cannot move a
roofline share.
"""
from __future__ import annotations

# one H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def bound(flops, nbytes):
    """The larger of flops at the f32 peak and bytes at the memory peak:
    (seconds, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def tri(n):
    """Entries of a triangle of order n, its diagonal included."""
    return n * (n + 1) / 2


def kinv_logdet_bound(B, n):
    """Kernel 1, K^-1 and logdet through a Cholesky: factor, triangular
    inverse, Linv^T Linv (n^3 flops); reads K's lower triangle, writes
    K^-1 and the logdet."""
    return bound(B * n ** 3, F32 * B * (tri(n) + n * n + 1))


def chol_linv_bound(B, n):
    """Kernel 2, L and L^-1: factor and triangular inverse."""
    return bound(B * (2 / 3) * n ** 3, F32 * B * (tri(n) + 2 * n * n))


def ipm_flops(B, nx, dims, iters):
    """f32 operations that `iters` IPM iterations on B problems with cones
    of dimensions `dims` need (a multiply-add counts two), on the
    sum(dims) rows each problem has."""
    rows, C = sum(dims), len(dims)
    per_iter = (10 * rows * nx + 2.5 * rows * nx * (nx + 1)
                + (2 / 3) * nx ** 3 + 4 * nx * nx + 120 * rows + 100 * C)
    return B * (iters * per_iter + 4 * rows * nx)


def ipm_bound(B, nx, dims, iters=25):
    """Kernel 3: `iters` iterations' operations on the cones' own rows;
    the bytes of the padded (C, d) blocks, which the kernel reads and
    writes."""
    C, d = len(dims), max(dims)
    return bound(ipm_flops(B, nx, dims, iters),
                 F32 * B * (3 * nx + C * d * nx + 5 * C * d))

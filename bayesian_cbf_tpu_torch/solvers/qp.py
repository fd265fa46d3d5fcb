"""A small QP solved as the epigraph SOCP:

    min ||A u + b||^2  s.t.  c_i^T u + d_i >= 0

has the argmin of min ||A u + b||, lifted with variables x = [u; t] to

    min t   s.t.  ||A u + b|| <= t,   c_i^T u + d_i >= 0,

whose linear rows are cones of dimension 1 (`solvers/socp.solve_socp`).
"""
from __future__ import annotations

import torch

from .socp import solve_socp


def qp_socp(A, b, lin_cs, lin_ds):
    """The lifted SOCP of a batch of QPs (A (B, r, m), b (B, r), lin_cs
    (B, nc, m), lin_ds (B, nc)): (c (m + 1,), G (B, 1 + r + nc, m + 1),
    h (B, 1 + r + nc), dims (1 + r, 1, ..., 1)) over x = [u; t]."""
    B, r, m = A.shape
    nc = lin_cs.shape[1]
    zeros = A.new_zeros
    c = torch.cat([zeros((m,)), A.new_ones((1,))])
    # epigraph cone: s0 = t, s1 = A u + b
    head = torch.cat([zeros((B, 1, m)), -A.new_ones((B, 1, 1))], 2)
    G_epi = torch.cat([head, torch.cat([-A, zeros((B, r, 1))], 2)], 1)
    h_epi = torch.cat([zeros((B, 1)), b], 1)
    # linear constraints as 1-dim cones: s = c_i^T u + d_i >= 0
    G_lin = torch.cat([-lin_cs, zeros((B, nc, 1))], 2)
    return (c, torch.cat([G_epi, G_lin], 1), torch.cat([h_epi, lin_ds], 1),
            (1 + r,) + (1,) * nc)


def solve_qp_active_set(A, b, lin_cs, lin_ds, iters: int = 30):
    """min ||A u + b||^2 s.t. lin_cs @ u + lin_ds >= 0 for a batch: A (B,
    r, m), b (B, r), lin_cs (B, nc, m), lin_ds (B, nc); unbatched inputs
    (no leading B) run as B = 1 and give unbatched outputs.  Returns (u
    (B, m), the SOCPSolution of the lifted problem).

    The lifted problem has nx = m + 1 variables and 1 + nc cones, the
    largest of dimension 1 + r: on a card the IPM kernel must be
    instantiated at (m + 1, 1 + nc, 1 + r), which it is for (3, 3, 4)
    (m = 2, r = 3, nc = 2) and raises ValueError with its list of shapes
    for any other; on the CPU every shape runs."""
    single = A.ndim == 2
    if single:
        A, b, lin_cs, lin_ds = A[None], b[None], lin_cs[None], lin_ds[None]
    m = A.shape[2]
    sol = solve_socp(*qp_socp(A, b, lin_cs, lin_ds), iters=iters)
    if single:
        sol = type(sol)(*(a[0] for a in sol))
    return sol.x[..., :m], sol

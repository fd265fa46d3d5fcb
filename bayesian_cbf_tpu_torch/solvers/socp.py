"""Batched second-order cone programming:

    minimize  c^T x   subject to  G x + s = h,  s in Q_{d_1} x ... x Q_{d_M}

with Q_d = {(s0, s1): s0 >= ||s1||} (d = 1 is the nonnegative ray).  All
cones are zero-padded to a common dimension and the problems of a batch
are solved together by a fixed-iteration Mehrotra predictor-corrector
IPM with Nesterov-Todd scaling (`ops/ipm_kernel.ipm`: the CUDA kernel on a
card, its plain version on the CPU).  Infeasibility does not raise; the
solution carries residual diagnostics.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..observability import tracing
from ..ops.ipm_kernel import gt_mul, g_mul, ipm, score_padded


class SOCPSolution(NamedTuple):
    x: torch.Tensor       # (B, nx)
    s: torch.Tensor       # (B, C, dmax) padded slacks
    z: torch.Tensor       # (B, C, dmax) padded duals
    pres: torch.Tensor    # (B,) primal residual |Gx+s-h| / max(1,|h|)
    dres: torch.Tensor    # (B,) dual residual |c+G^T z| / max(1,|c|)
    gap: torch.Tensor     # (B,) complementarity |s^T z| / nu
    pcost: torch.Tensor   # (B,) c^T x


def _pad_cones(G, h, dims):
    """Zero-pad the cone blocks of G (B, M, nx), h (B, M) to a common
    dimension: (B, C, dmax, nx), (B, C, dmax)."""
    B, _, nx = G.shape
    C, dmax = len(dims), max(dims)
    if all(d == dmax for d in dims):
        return G.reshape(B, C, dmax, nx), h.reshape(B, C, dmax)
    Gp = G.new_zeros((B, C, dmax, nx))
    hp = h.new_zeros((B, C, dmax))
    off = 0
    for i, d in enumerate(dims):
        Gp[:, i, :d] = G[:, off:off + d]
        hp[:, i, :d] = h[:, off:off + d]
        off += d
    return Gp, hp


def _interior_shift(S):
    """Push each cone's head up until s0 - ||s1|| reaches a scale-relative
    floor (warm starts); padded zero coordinates are unaffected."""
    scale = torch.linalg.vector_norm(S, dim=-1)
    floor = 1e-2 * (1.0 + scale)
    margin = S[..., 0] - torch.linalg.vector_norm(S[..., 1:], dim=-1)
    shift = torch.clamp(floor - margin, min=0.0)
    return torch.cat([S[..., :1] + shift[..., None], S[..., 1:]], -1)


@tracing.spanned("socp")
def solve_socp(c, G, h, dims: Tuple[int, ...], iters: int = 30,
               tol: float = 1e-10, warm=None) -> SOCPSolution:
    """Solve a batch of SOCPs with shared cone sizes `dims`.

    c (nx,) or (B, nx); G (B, M, nx); h (B, M).  `warm` (optional) is an
    (x, S, Z) triple from the previous solve of problems with the same
    cone structure: a non-finite warm point, or one whose KKT score on
    today's data is >= 0.05, falls back to the cold start per problem;
    otherwise S and Z are shifted into the cone interior."""
    B, _, nx = G.shape
    c = c.expand(B, nx) if c.ndim == 1 else c
    C, dmax = len(dims), max(dims)
    Gp, hp = _pad_cones(G, h, dims)
    e = torch.zeros((B, C, dmax), dtype=G.dtype, device=G.device)
    e[..., 0] = 1.0
    x0 = torch.zeros((B, nx), dtype=G.dtype, device=G.device)
    if warm is None:
        sx, sS, sZ = x0, e, e
    else:
        wx, wS, wZ = warm
        ok = (torch.isfinite(wx).all(-1) & torch.isfinite(wS).all(-1).all(-1)
              & torch.isfinite(wZ).all(-1).all(-1))
        v, m = ok[:, None], ok[:, None, None]
        wx = torch.where(v, wx, x0)
        wS = torch.where(m, wS, e)
        wZ = torch.where(m, wZ, e)
        ok = ok & (score_padded(c, Gp, hp, wx, wS, wZ) < 0.05)
        v, m = ok[:, None], ok[:, None, None]
        sx = torch.where(v, wx, x0)
        sS = torch.where(m, _interior_shift(wS), e)
        sZ = torch.where(m, _interior_shift(wZ), e)

    x, S, Z = ipm(c.contiguous(), Gp.contiguous(), hp.contiguous(),
                  sx.contiguous(), sS.contiguous(), sZ.contiguous(),
                  iters, tol)

    hnorm = torch.clamp(torch.linalg.vector_norm(hp, dim=(-2, -1)), min=1.0)
    cnorm = torch.clamp(torch.linalg.vector_norm(c, dim=-1), min=1.0)
    pres = torch.linalg.vector_norm(g_mul(Gp, x) + S - hp, dim=(-2, -1)) / hnorm
    dres = torch.linalg.vector_norm(c + gt_mul(Gp, Z), dim=-1) / cnorm
    gap = torch.abs(torch.sum(S * Z, (-2, -1))) / float(C)
    return SOCPSolution(x=x, s=S, z=Z, pres=pres, dres=dres, gap=gap,
                        pcost=torch.sum(c * x, -1))


def socp_residuals(sol: SOCPSolution, tol: float = 1e-6):
    """(B,) bool: both relative residuals of each solution below tol."""
    return (sol.pres < tol) & (sol.dres < tol)


def cones_from_constraints(constraints):
    """(G (B, M, nx), h (B, M), dims) of the constraints
    ||A_k x + b_k|| <= c_k^T x + d_k, each (A_k (B, k, nx), b_k (B, k),
    c_k (B, nx), d_k (B,)): G_k = [-c_k^T; -A_k], h_k = [d_k; b_k]."""
    Gs, hs = [], []
    for A, b, cvec, d in constraints:
        Gs.append(torch.cat([-cvec[:, None], -A], 1))
        hs.append(torch.cat([d[:, None], b], 1))
    return (torch.cat(Gs, 1), torch.cat(hs, 1),
            tuple(G.shape[1] for G in Gs))

"""Fused fit-Gram + solve + logdet as one differentiable op.

The MLL consumes the masked training Gram only through
(Km^{-1} Y, logdet Km).  The forward builds Km without autograd and
inverts it with the fused kernel; the backward forms
    dKm = -Kinv dS S^T + dlogdet Kinv
and pulls it back through a recomputed `km_expr`, so the forward keeps no
Gram intermediates, only Kinv.
"""
from __future__ import annotations

import torch

from .cholinv import batched_kinv_logdet_fit


def km_expr(X, UB, UH, inv_ell, nug, mask):
    """Masked fit-Gram, batched: X (B, k, xd) raw states; UB = UH (s B)
    (B, k, mh); UH (B, k, mh); inv_ell (B, xd); nug (B,); mask (B, k).

    Km = (rbf o UB UH^T) * mask_i mask_j + diag(nug m + 1 - m), with the
    raw-difference distances and the (UH (s B)) UH^T association."""
    d = (X[:, :, None, :] - X[:, None, :, :]) * inv_ell[:, None, None, :]
    rbf = torch.exp(-0.5 * torch.sum(d * d, -1))
    ubu = UB @ UH.transpose(-1, -2)
    outer = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return (rbf * ubu * outer
            + nug[:, None, None] * eye * mask[:, :, None]
            + eye * (1.0 - mask)[:, :, None])


class _GramSolveLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, UB, UH, inv_ell, nug, mask, Y, method, assembly):
        Km = km_expr(X, UB, UH, inv_ell, nug, mask)
        Kinv, logdet = batched_kinv_logdet_fit(Km, method, assembly)
        S = Kinv @ Y
        ctx.save_for_backward(S, Kinv, X, UB, UH, inv_ell, nug, mask)
        return S, logdet

    @staticmethod
    def backward(ctx, dS, dlogdet):
        S, Kinv, *ins = ctx.saved_tensors
        dY = torch.zeros_like(S)
        dKm = torch.zeros_like(Kinv)
        if dS is not None:
            dY = Kinv @ dS
            dKm = -dY @ S.transpose(-1, -2)
        if dlogdet is not None:
            dKm = dKm + dlogdet[..., None, None] * Kinv
        need = ctx.needs_input_grad[:6]
        grads = [None] * 6
        if any(need):
            with torch.enable_grad():
                leaves = [a.detach().requires_grad_(n) for a, n in
                          zip(ins, need)]
                Km = km_expr(*leaves)
                wrt = [a for a, n in zip(leaves, need) if n]
                got = iter(torch.autograd.grad(Km, wrt, dKm))
            grads = [next(got) if n else None for n in need]
        return (*grads, dY if ctx.needs_input_grad[6] else None, None, None)


def gram_solve_logdet(X, UB, UH, inv_ell, nug, mask, Y, method="cholk",
                      assembly="kernel"):
    """(Km^{-1} Y, logdet Km) of the masked fit-Gram, batched, with a
    matmul-only backward through a recomputed `km_expr`; the inverse by
    the fit inverse `method` (`ops/cholinv.batched_kinv_logdet_fit`)."""
    return _GramSolveLogdet.apply(X, UB, UH, inv_ell, nug, mask, Y, method,
                                  assembly)

"""Cholesky-with-explicit-inverse and fused solve+logdet as differentiable
ops, with matmul-only backward passes.

`chol_with_inv(K) -> (L, L^{-1})`.  Backward (no triangular solve):
    dL += -L^{-T} dLinv L^{-T}                 (inverse rule)
    dK  = L^{-T} Phi(L^T dL) L^{-1}            (Murray 2016),
with Phi = tril with halved diagonal, output symmetrized.

`solve_and_logdet(K, Y) -> (K^{-1} Y, logdet K)`.  Backward:
    dY = K^{-1} dS,   dK = -dY S^T + dlogdet K^{-1}.

The forwards route every batch through the kernels of
`ops/chol_kernels.py` (CUDA) or their plain versions (CPU).
"""
from __future__ import annotations

import torch

from .chol_kernels import chol_linv, kinv_logdet as _kinv_logdet_kernel


def _flat(K):
    lead = K.shape[:-2]
    return K.reshape((-1,) + K.shape[-2:]).contiguous(), lead


def chol_inv_fwd(K: torch.Tensor):
    """(L, L^{-1}) for K (..., n, n) without autograd."""
    K3, lead = _flat(K)
    L, Linv = chol_linv(K3)
    return L.reshape(lead + L.shape[-2:]), Linv.reshape(lead + L.shape[-2:])


def batched_kinv_logdet_fit(K3: torch.Tensor):
    """(K^{-1}, logdet K) of a (B, n, n) batch on the fit path: the
    fused factor + inverse kernel on CUDA, its plain version on CPU."""
    return _kinv_logdet_kernel(K3.contiguous())


def kinv_logdet(K: torch.Tensor):
    """(K^{-1}, logdet K) for K (..., n, n)."""
    K3, lead = _flat(K)
    Kinv, ld = batched_kinv_logdet_fit(K3)
    return Kinv.reshape(lead + Kinv.shape[-2:]), ld.reshape(lead)


def _phi(M):
    return torch.tril(M) - 0.5 * torch.diag_embed(
        torch.diagonal(M, dim1=-2, dim2=-1))


class _CholWithInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K):
        L, Linv = chol_inv_fwd(K)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, dL, dLinv):
        L, Linv = ctx.saved_tensors
        LinvT = Linv.transpose(-1, -2)
        dL = torch.zeros_like(L) if dL is None else dL
        if dLinv is not None:
            dL = dL - LinvT @ dLinv @ LinvT
        M = _phi(L.transpose(-1, -2) @ dL)
        dK = LinvT @ M @ Linv
        return 0.5 * (dK + dK.transpose(-1, -2))


def chol_with_inv(K: torch.Tensor):
    """(L, L^{-1}) for PSD K (..., n, n); differentiable, matmul-only VJP."""
    return _CholWithInv.apply(K)


class _SolveAndLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, Y):
        Kinv, logdet = kinv_logdet(K)
        S = Kinv @ Y
        ctx.save_for_backward(S, Kinv)
        return S, logdet

    @staticmethod
    def backward(ctx, dS, dlogdet):
        S, Kinv = ctx.saved_tensors
        dY = torch.zeros_like(S)
        dK = torch.zeros_like(Kinv)
        if dS is not None:
            dY = Kinv @ dS
            dK = -dY @ S.transpose(-1, -2)
        if dlogdet is not None:
            dK = dK + dlogdet[..., None, None] * Kinv
        return dK, dY


def solve_and_logdet(K: torch.Tensor, Y: torch.Tensor):
    """(K^{-1} Y, logdet K) for PD K (..., k, k), Y (..., k, n)."""
    return _SolveAndLogdet.apply(K, Y)

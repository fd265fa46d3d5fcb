"""Cholesky-with-explicit-inverse and fused solve+logdet as differentiable
ops, with matmul-only backward passes.

`chol_with_inv(K) -> (L, L^{-1})`.  Backward (no triangular solve):
    dL += -L^{-T} dLinv L^{-T}                 (inverse rule)
    dK  = L^{-T} Phi(L^T dL) L^{-1}            (Murray 2016),
with Phi = tril with halved diagonal, output symmetrized.

`solve_and_logdet(K, Y) -> (K^{-1} Y, logdet K)`.  Backward:
    dY = K^{-1} dS,   dK = -dY S^T + dlogdet K^{-1}.

The forwards route every batch through the kernels of
`ops/chol_kernels.py` and `ops/sweep_kernels.py` (CUDA) or their plain
versions (CPU), chosen by the two options of the JAX package:

* the fit inverse `method` (`cholinv.FIT_INVERSE`): "cholk" (default,
  the fused factor + inverse kernel), "chol" (the factor and L^{-1} of
  `chol_inv_fwd`, then Linv^T Linv), "sweep" (the recursive Schur/sweep
  kernel), "sweep_full" (one sweep over all pivots);
* the L^{-1} `assembly` (`pallas_chol.LINV_ASSEMBLY`): "kernel"
  (default, assembled inside the Cholesky kernel) or "row" / "col"
  (the blocked factor with diagonal-block inverses, assembled outside).

The JAX package's "xla" fit inverse is not ported: it exists to bypass
the Pallas kernels, and in the port that would send a CUDA tensor to a
plain version.
"""
from __future__ import annotations

import torch

from .chol_kernels import chol_linv, chol_linv_assembled
from .chol_kernels import kinv_logdet as _kinv_logdet_kernel
from .sweep_kernels import batched_kinv_logdet as _sweep_kinv_logdet
from .sweep_kernels import full_base

FIT_METHODS = ("cholk", "chol", "sweep", "sweep_full")
ASSEMBLIES = ("kernel", "row", "col")


def check_options(method: str = "cholk", assembly: str = "kernel") -> None:
    """Raise ValueError for a fit inverse or an assembly the port lacks."""
    if method == "xla":
        raise ValueError(
            "fit inverse 'xla' is not ported: in the JAX package it bypasses "
            "the Pallas kernels for XLA's batched Cholesky; in the port a "
            "CUDA tensor always launches a kernel, never a plain version")
    if method not in FIT_METHODS:
        raise ValueError(f"unknown fit inverse {method!r}; one of "
                         f"{FIT_METHODS}")
    if assembly not in ASSEMBLIES:
        raise ValueError(f"unknown L^-1 assembly {assembly!r}; one of "
                         f"{ASSEMBLIES}")


def _flat(K):
    lead = K.shape[:-2]
    return K.reshape((-1,) + K.shape[-2:]).contiguous(), lead


def chol_inv_fwd(K: torch.Tensor, assembly: str = "kernel"):
    """(L, L^{-1}) for K (..., n, n) without autograd."""
    check_options(assembly=assembly)
    K3, lead = _flat(K)
    if assembly == "kernel":
        L, Linv = chol_linv(K3)
    else:
        L, Linv = chol_linv_assembled(K3, assembly)
    return L.reshape(lead + L.shape[-2:]), Linv.reshape(lead + L.shape[-2:])


def batched_kinv_logdet_fit(K3: torch.Tensor, method: str = "cholk",
                            assembly: str = "kernel"):
    """(K^{-1}, logdet K) of a (B, n, n) batch on the fit path, routed by
    `method` (`cholinv.batched_kinv_logdet_fit`); `assembly` is the
    L^{-1} assembly of "chol"."""
    check_options(method, assembly)
    K3 = K3.contiguous()
    if method == "cholk":
        return _kinv_logdet_kernel(K3)
    if method == "chol":
        L, Linv = chol_inv_fwd(K3, assembly)
        Kinv = Linv.transpose(-1, -2) @ Linv
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        return Kinv, 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-20)),
                                     -1)
    if method == "sweep_full":
        return _sweep_kinv_logdet(K3, base=full_base(K3.shape[-1]))
    return _sweep_kinv_logdet(K3)


def kinv_logdet(K: torch.Tensor, method: str = "cholk",
                assembly: str = "kernel"):
    """(K^{-1}, logdet K) for K (..., n, n)."""
    K3, lead = _flat(K)
    Kinv, ld = batched_kinv_logdet_fit(K3, method, assembly)
    return Kinv.reshape(lead + Kinv.shape[-2:]), ld.reshape(lead)


def _phi(M):
    return torch.tril(M) - 0.5 * torch.diag_embed(
        torch.diagonal(M, dim1=-2, dim2=-1))


class _CholWithInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, assembly):
        L, Linv = chol_inv_fwd(K, assembly)
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
        return 0.5 * (dK + dK.transpose(-1, -2)), None


def chol_with_inv(K: torch.Tensor, assembly: str = "kernel"):
    """(L, L^{-1}) for PSD K (..., n, n); differentiable, matmul-only VJP."""
    return _CholWithInv.apply(K, assembly)


class _SolveAndLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, Y, method, assembly):
        Kinv, logdet = kinv_logdet(K, method, assembly)
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
        return dK, dY, None, None


def solve_and_logdet(K: torch.Tensor, Y: torch.Tensor, method: str = "cholk",
                     assembly: str = "kernel"):
    """(K^{-1} Y, logdet K) for PD K (..., k, k), Y (..., k, n); the
    inverse by the fit inverse `method`."""
    return _SolveAndLogdet.apply(K, Y, method, assembly)

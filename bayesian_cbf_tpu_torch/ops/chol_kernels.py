"""Batched Cholesky kernels (csrc/chol.cu) and their plain versions.

`chol_linv` -> (L, L^{-1}) and `kinv_logdet` -> (K^{-1}, logdet K) for a
batch (B, n, n) of positive definite matrices.  A CPU tensor takes the
plain PyTorch version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

MAX_N = 1024


def chol_linv_plain(K: torch.Tensor):
    """(L, L^{-1}) by `cholesky_ex` + `solve_triangular`.  Like the JAX
    reference, a failed factorization comes back as NaN."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    return L, Linv


def kinv_logdet_plain(K: torch.Tensor):
    """(K^{-1}, logdet K) = (L^{-T} L^{-1}, 2 sum log max(diag L, 1e-20))."""
    L, Linv = chol_linv_plain(K)
    Kinv = Linv.transpose(-1, -2) @ Linv
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-20)), -1)
    return Kinv, logdet


def _check(K: torch.Tensor, what: str):
    if K.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {K.device}")
    if K.dtype != torch.float32:
        raise ValueError(f"{what}: the kernel takes float32, got {K.dtype}")
    if K.ndim != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"{what}: expected (B, n, n), got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    B, n, _ = K.shape
    if not 1 <= n <= MAX_N or B < 1:
        raise ValueError(f"{what}: need B >= 1 and 1 <= n <= {MAX_N}, "
                         f"got B={B}, n={n}")
    return B, n


def _a_scratch(lib, K, B, n):
    if lib.chol_uses_smem(n):
        return torch.empty(0, device=K.device), None
    buf = torch.empty((B, n, n), dtype=K.dtype, device=K.device)
    return buf, buf.data_ptr()


def chol_linv(K: torch.Tensor):
    """(L, L^{-1}) of a batch K (B, n, n).  Replaces the TPU kernel
    `pallas_chol._chol_linv_kernel` on CUDA."""
    if K.device.type == "cpu":
        return chol_linv_plain(K)
    B, n = _check(K, "chol_linv")
    lib = _build.load("chol")
    L = torch.empty_like(K)
    Linv = torch.empty_like(K)
    keep, a_ptr = _a_scratch(lib, K, B, n)
    rc = lib.chol_linv_launch(K.data_ptr(), L.data_ptr(), Linv.data_ptr(),
                              a_ptr, B, n,
                              torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "chol_linv_launch")
    chol_linv.launches += 1
    del keep
    return L, Linv


chol_linv.launches = 0


def kinv_logdet(K: torch.Tensor):
    """(K^{-1}, logdet K) of a batch K (B, n, n).  Replaces the TPU kernel
    `pallas_chol._cholkinv_kernel` on CUDA."""
    if K.device.type == "cpu":
        return kinv_logdet_plain(K)
    B, n = _check(K, "kinv_logdet")
    lib = _build.load("chol")
    Kinv = torch.empty_like(K)
    logdet = torch.empty((B,), dtype=K.dtype, device=K.device)
    X = torch.empty_like(K)
    keep, a_ptr = _a_scratch(lib, K, B, n)
    rc = lib.kinv_logdet_launch(
        K.data_ptr(), Kinv.data_ptr(), logdet.data_ptr(), X.data_ptr(),
        a_ptr, B, n, torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "kinv_logdet_launch")
    kinv_logdet.launches += 1
    del keep
    return Kinv, logdet


kinv_logdet.launches = 0

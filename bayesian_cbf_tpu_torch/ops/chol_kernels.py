"""Batched Cholesky kernels (csrc/chol.cu, csrc/chol_blocked.cu) and
their plain versions.

`chol_linv` -> (L, L^{-1}), `kinv_logdet` -> (K^{-1}, logdet K) and
`chol_dinv` -> (L, diagonal-block inverses) for a batch (B, n, n) of
positive definite matrices; `assemble_linv` builds L^{-1} from the last
with matmuls.  A CPU tensor takes the plain PyTorch version; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build

MAX_N = 1024


def _cholesky_nan(K: torch.Tensor):
    """`cholesky_ex`, with a failed factorization marked NaN as the JAX
    reference marks it."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L,
                       torch.full_like(L, float("nan")))


def chol_linv_plain(K: torch.Tensor):
    """(L, L^{-1}) by `cholesky_ex` + `solve_triangular`.  Like the JAX
    reference, a failed factorization comes back as NaN."""
    L = _cholesky_nan(K)
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


def check_batch(K: torch.Tensor, what: str):
    """Raise ValueError unless K is a contiguous f32 CUDA batch (B, n, n)
    with 1 <= n <= MAX_N; return (B, n)."""
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
    B, n = check_batch(K, "chol_linv")
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
    B, n = check_batch(K, "kinv_logdet")
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


# ---- blocked factor with diagonal-block inverses (csrc/chol_blocked.cu) ----

NB_BLK = 32
MAX_NB = 64


def padded_order(n: int, nb: int) -> int:
    """n rounded up to a multiple of nb, at least nb: the order of the
    identity-padded matrix of the JAX package's blocked kernels."""
    return max(-(-n // nb) * nb, nb)


def chol_dinv_plain(K: torch.Tensor, nb: int = NB_BLK):
    """(L (B, N, N), Dinv (B, N, nb)) by `cholesky_ex` of the identity-
    padded K and `solve_triangular` on L's diagonal blocks; a failed
    factorization comes back as NaN."""
    B, n, _ = K.shape
    N = padded_order(n, nb)
    Kp = torch.eye(N, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    Kp[:, :n, :n] = K
    L = _cholesky_nan(Kp)
    nblk = N // nb
    D = torch.diagonal(L.reshape(B, nblk, nb, nblk, nb), dim1=1, dim2=3)
    D = D.permute(0, 3, 1, 2)                                 # (B, nblk, nb, nb)
    eye = torch.eye(nb, dtype=K.dtype, device=K.device)
    Dinv = torch.linalg.solve_triangular(D, eye.expand_as(D), upper=False)
    return L, Dinv.reshape(B, N, nb)


def chol_dinv(K: torch.Tensor, nb: int = NB_BLK):
    """Blocked Cholesky factor of the identity-padded batch K (B, n, n):
    L (B, N, N) and the inverses of its nb x nb diagonal blocks
    Dinv (B, N, nb), N = n rounded up to nb.  Replaces the TPU kernel
    `pallas_chol._chol_kernel` on CUDA."""
    if K.device.type == "cpu":
        return chol_dinv_plain(K, nb)
    B, n = check_batch(K, "chol_dinv")
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"chol_dinv: need 1 <= nb <= {MAX_NB}, got {nb}")
    N = padded_order(n, nb)
    lib = _build.load("chol_blocked")
    L = torch.empty((B, N, N), dtype=K.dtype, device=K.device)
    Dinv = torch.empty((B, N, nb), dtype=K.dtype, device=K.device)
    scratch = None
    if not lib.chol_dinv_uses_smem(N, nb):
        scratch = torch.empty((B, N, N), dtype=K.dtype, device=K.device)
    rc = lib.chol_dinv_launch(
        K.data_ptr(), L.data_ptr(), Dinv.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, n, N, nb,
        torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "chol_dinv_launch")
    chol_dinv.launches += 1
    return L, Dinv


chol_dinv.launches = 0


def assemble_linv(L: torch.Tensor, Dinv: torch.Tensor, nb: int,
                  assembly: str) -> torch.Tensor:
    """L^{-1} (B, N, N) from the blocked factor, with batched matmuls
    (`pallas_chol._batched_chol_with_inv_jit`).  "row": block row r is
    -Dinv_r (L[r, :r] L^{-1}[:r, :r]), two large matmuls per row (valid
    because L^{-1} is zero above its diagonal); "col": the per-block
    substitution L^{-1}[r, j] = -Dinv_r sum_{j<=k<r} L[r, k] L^{-1}[k, j].
    A single block (N = nb) takes the "col" form, as in the JAX package."""
    B, N, _ = L.shape
    nblocks = N // nb
    if assembly == "row" and nblocks > 1:
        top = Dinv[:, :nb, :]
        for r in range(1, nblocks):
            o = r * nb
            Dr = Dinv[:, o:o + nb, :]
            new = -(Dr @ (L[:, o:o + nb, :o] @ top))
            zero = torch.zeros((B, o, nb), dtype=L.dtype, device=L.device)
            top = torch.cat([torch.cat([top, zero], 2),
                             torch.cat([new, Dr], 2)], 1)
        return top
    if assembly not in ("row", "col"):
        raise ValueError(f"unknown L^-1 assembly {assembly!r}")
    blocks = [[None] * nblocks for _ in range(nblocks)]
    for j in range(nblocks):
        blocks[j][j] = Dinv[:, j * nb:(j + 1) * nb, :]
    for r in range(nblocks):
        for j in range(r - 1, -1, -1):
            acc = 0.0
            for k in range(j, r):
                acc = acc + (L[:, r * nb:(r + 1) * nb, k * nb:(k + 1) * nb]
                             @ blocks[k][j])
            blocks[r][j] = -(blocks[r][r] @ acc)
    zero = torch.zeros((B, nb, nb), dtype=L.dtype, device=L.device)
    return torch.cat([torch.cat([blocks[r][j] if j <= r else zero
                                 for j in range(nblocks)], 2)
                      for r in range(nblocks)], 1)


def chol_linv_assembled(K: torch.Tensor, assembly: str, nb: int = NB_BLK):
    """(L, L^{-1}) of a batch K (B, n, n) from `chol_dinv` and the "row"
    or "col" assembly."""
    n = K.shape[-1]
    L, Dinv = chol_dinv(K, nb)
    Linv = assemble_linv(L, Dinv, nb, assembly)
    return L[:, :n, :n], Linv[:, :n, :n]

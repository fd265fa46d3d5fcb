"""Small linear-algebra helpers, batched over leading axes.

Counterpart of `bayesian_cbf_tpu/utils/linalg.py`: the Kronecker product,
the Cholesky factorization with a jitter ladder (also of a masked Gram),
the eigenvalue clamp to the PSD cone, and the statically-unrolled
Cholesky factorizations of small matrices (the 3x3 task matrix A of the
MLL and the 3x3 posterior row covariance Bk of the cones).  Unrolled,
each factorization is a short chain of elementwise ops over the whole
batch instead of a batched LAPACK call.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..observability import tracing


def kron(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kronecker product of the trailing two axes: (p, q) x (r, s) ->
    (p*r, q*s), with matching leading axes."""
    p, q = a.shape[-2], a.shape[-1]
    r, s = b.shape[-2], b.shape[-1]
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(*a.shape[:-2], p * r, q * s)


def psd_cholesky(K: torch.Tensor, init_jitter: float = 1e-6,
                 num_tries: int = 8, growth: float = 10.0):
    """Cholesky of each symmetrized K (..., n, n) at the first of the
    jitters 0, init_jitter scale, ..., init_jitter growth^(num_tries-1)
    scale (scale = max(mean |diag K|, 1) per matrix) whose factorization
    succeeds and is finite.  Returns (K + jitter I, L) for that rung; where
    no rung succeeds, the unjittered K and L = 0.

    All rungs are factored at once without autograd, and the chosen
    rung's factor is taken from that batch.  When K needs a gradient, the
    batch is factored once more with every rung but the chosen one
    replaced by the identity, so the gradient flows through the chosen
    rung only (a failed rung's factor is unspecified, and a gradient
    through it would be too) and the chosen rung is factored by the same
    batched routine that accepted it (on a card the batched and the
    single-matrix Cholesky may disagree on a matrix at the edge of
    definiteness); a matrix whose chosen rung fails there counts as
    factored by no rung.  While a recording is open
    (`observability.tracing`), each call counts its matrices per accepted
    rung in `psd_cholesky.rung0` .. `psd_cholesky.rung<num_tries>`, and
    those no rung factored in `psd_cholesky.rung<num_tries + 1>`."""
    K, diag_scale = _sym_scale(K)
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    jit = torch.cat([K.new_zeros(1), init_jitter * growth ** torch.arange(
        num_tries, dtype=K.dtype, device=K.device)])
    jit = jit.reshape((-1,) + (1,) * diag_scale.ndim)
    Ks = K + (jit * diag_scale)[..., None, None] * eye      # (R, ..., n, n)
    with torch.no_grad():
        Ls, info = torch.linalg.cholesky_ex(Ks)
        ok = (info == 0) & torch.isfinite(Ls).all(-1).all(-1)
        first = torch.argmax(ok.to(torch.int8), dim=0)      # first ok rung
        found = ok.any(0)
    if torch.is_grad_enabled() and K.requires_grad:
        rungs = torch.arange(num_tries + 1, device=K.device).reshape(jit.shape)
        chosen = (rungs == first) & found
        Ls, info = torch.linalg.cholesky_ex(
            torch.where(chosen[..., None, None], Ks, eye))
        found = found & ((info == 0) & torch.isfinite(
            Ls.detach()).all(-1).all(-1) | ~chosen).all(0)
    idx = first[None, ..., None, None].expand((1,) + Ks.shape[1:])
    if tracing.enabled():
        rung = torch.where(found, first, num_tries + 1)
        counts = (rung.reshape(-1, 1) == torch.arange(
            num_tries + 2, device=K.device)).sum(0)
        for i in range(num_tries + 2):
            tracing.count(f"psd_cholesky.rung{i}", counts[i])
    found = found[..., None, None]
    L = torch.gather(Ls, 0, idx)[0]
    return (torch.where(found, torch.gather(Ks, 0, idx)[0], K),
            torch.where(found, L, torch.zeros_like(L)))


def psd_clamp_eigh(K: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """The symmetrized K (..., n, n) with its eigenvalues clamped from
    below at eps."""
    K = 0.5 * (K + K.transpose(-1, -2))
    w, v = torch.linalg.eigh(K)
    w = torch.clamp(w, min=eps)
    return (v * w[..., None, :]) @ v.transpose(-1, -2)


def masked_cholesky(K: torch.Tensor, mask: torch.Tensor,
                    init_jitter: float = 1e-6):
    """`psd_cholesky` of the Gram K (..., n, n) restricted to the rows and
    columns where mask (..., n) is nonzero: the others become identity
    rows, so a solve against the factor is exact on the valid block when
    the right-hand side is zero on the invalid rows.  Returns
    (K_masked + jitter I, L)."""
    m = mask.to(K.dtype)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    Km = K * (m[..., :, None] * m[..., None, :]) + eye * (1.0 - m)[..., :,
                                                                    None]
    return psd_cholesky(Km, init_jitter=init_jitter)


def _sym_scale(K: torch.Tensor):
    K = 0.5 * (K + K.transpose(-1, -2))
    diag_scale = torch.clamp(
        torch.mean(torch.abs(torch.diagonal(K, dim1=-2, dim2=-1)), dim=-1),
        min=1.0)
    return K, diag_scale


def _stack_lower(L, n, like):
    zero = torch.zeros_like(like)
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)],
                        dim=-1) for i in range(n)]
    return torch.stack(rows, dim=-2)


def chol_small_unrolled(K: torch.Tensor, jitter: float = 0.0):
    """Unrolled Cholesky of small (..., n, n) matrices: symmetrize, add
    `jitter * scale * I`, clamp pivots at a relative floor of
    (jitter + eps^2) * scale (never NaN).  Returns the lower factor."""
    n = K.shape[-1]
    K, diag_scale = _sym_scale(K)
    eps = torch.finfo(K.dtype).eps
    floor = (max(jitter, 0.0) + eps * eps) * diag_scale
    if jitter:
        K = K + (jitter * diag_scale)[..., None, None] * torch.eye(
            n, dtype=K.dtype, device=K.device)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = K[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.maximum(acc, floor))
            else:
                L[i][j] = acc / L[j][j]
    return _stack_lower(L, n, K[..., 0, 0])


def cho_solve_small_unrolled(L: torch.Tensor, B: torch.Tensor):
    """Solve (L L^T) X = B by unrolled substitution; L (..., n, n),
    B (..., n, m)."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[..., i, k, None] * y[k]
        y[i] = acc / L[..., i, i, None]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[..., k, i, None] * x[k]
        x[i] = acc / L[..., i, i, None]
    return torch.stack(x, dim=-2)


@lru_cache(maxsize=32)
def _ladder_jitters(init_jitter, num_tries, growth, dtype, device):
    jitters = [0.0] + [init_jitter * growth ** r for r in range(num_tries)]
    return torch.tensor(jitters, dtype=dtype, device=device)


def psd_chol_small_ladder(K: torch.Tensor, init_jitter: float = 1e-6,
                          num_tries: int = 8, growth: float = 10.0):
    """Scale-aware jitter ladder over unrolled Cholesky attempts: the
    first rung whose pivots are all positive wins, the last rung is the
    unconditional fallback.  Returns the lower factor of K + jitter I for
    the selected rung (NaN-free by construction).  All rungs are factored
    at once, stacked on a leading axis."""
    n = K.shape[-1]
    K, diag_scale = _sym_scale(K)
    tiny = torch.finfo(K.dtype).tiny
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    jit = _ladder_jitters(init_jitter, num_tries, growth, K.dtype, K.device)
    jit = jit.reshape((-1,) + (1,) * diag_scale.ndim)
    Kj = K + (jit * diag_scale)[..., None, None] * eye          # (R, ..., n, n)
    L = [[None] * n for _ in range(n)]
    ok = None
    for i in range(n):
        for j in range(i + 1):
            acc = Kj[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                good = acc > 0
                ok = good if ok is None else (ok & good)
                # guard the sqrt / divisions so failed rungs stay finite
                L[i][j] = torch.sqrt(torch.clamp(acc, min=tiny))
            else:
                L[i][j] = acc / L[j][j]
    Ls = _stack_lower(L, n, Kj[..., 0, 0])
    ok = torch.cat([ok[:-1], torch.ones_like(ok[-1:])])       # last: fallback
    first = torch.argmax(ok.to(torch.int8), dim=0)             # first ok rung
    idx = first[None, ..., None, None].expand((1,) + Ls.shape[1:])
    return torch.gather(Ls, 0, idx)[0]

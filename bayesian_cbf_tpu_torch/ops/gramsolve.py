"""Fused fit-Gram + solve + logdet as one differentiable op.

The MLL consumes the masked training Gram only through
(Km^{-1} Y, logdet Km).  The forward builds Km without autograd and
inverts it with the fused kernel; the backward forms
    dKm = -Kinv dS S^T + dlogdet Kinv
and pulls it back to (UB, inv_ell, nug), so the forward keeps no Gram
intermediates, only Kinv.

Two routes, chosen by what the inputs show:

* no gradient wanted for X, UH or mask (every `MVGP.fit`): Km by
  `fit_gram` and the pull-back by `fit_gram_backward`, which form each
  entry of Km and of dKm on the fly; each is one kernel
  (csrc/fit_gram.cu) for CUDA float32 tensors with widths x_dim, 1+m and
  Y's n in [1, 16], and its plain version (`km_expr`,
  `km_backward_plain`) otherwise;
* a gradient for X, UH or mask (the parity tests that differentiate all
  seven inputs): the pull-back by autograd through a recomputed
  `km_expr`.  A CUDA backward on this route counts `gramsolve.recompute`.
"""
from __future__ import annotations

import torch

from ..observability import tracing
from . import _build
from . import gram
from .cholinv import batched_kinv_logdet_fit

MAX_DIM = gram.MAX_DIM
WARP = 32  # threads of a row group: csrc/fit_gram.cu makes a row per warp


def km_expr(X, UB, UH, inv_ell, nug, mask):
    """Masked fit-Gram, batched: X (B, k, xd) raw states; UB = UH (s B)
    (B, k, mh); UH (B, k, mh); inv_ell (B, xd); nug (B,); mask (B, k).

    Km = (rbf o UB UH^T) * mask_i mask_j + diag(nug m + 1 - m), with the
    raw-difference distances and the (UH (s B)) UH^T association.  The
    plain version of `fit_gram`."""
    d = (X[:, :, None, :] - X[:, None, :, :]) * inv_ell[:, None, None, :]
    rbf = torch.exp(-0.5 * torch.sum(d * d, -1))
    ubu = UB @ UH.transpose(-1, -2)
    outer = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return (rbf * ubu * outer
            + nug[:, None, None] * eye * mask[:, :, None]
            + eye * (1.0 - mask)[:, :, None])


def km_backward_plain(X, UB, UH, inv_ell, mask, Kinv, dY, S, dlogdet):
    """The pull-back of dKm = dlogdet Kinv - dY S^T through `km_expr`, in
    closed form: (dUB (B, k, mh), d inv_ell (B, xd), d nug (B,)) with
    T = dKm o rbf o m m^T,
        dUB = T UH,
        d inv_ell_a = -inv_ell_a sum_ij T_ij ubu_ij (X_ia - X_ja)^2,
        d nug = sum_i dKm_ii m_i.
    The plain version of `fit_gram_backward`."""
    W = dlogdet[:, None, None] * Kinv - dY @ S.transpose(-1, -2)
    diff = X[:, :, None, :] - X[:, None, :, :]
    d = diff * inv_ell[:, None, None, :]
    rbf = torch.exp(-0.5 * torch.sum(d * d, -1))
    T = W * rbf * (mask[:, :, None] * mask[:, None, :])
    ubu = UB @ UH.transpose(-1, -2)
    dil = -inv_ell * torch.einsum('bij,bija->ba', T * ubu, diff * diff)
    dnug = torch.sum(torch.diagonal(W, dim1=-2, dim2=-1) * mask, -1)
    return T @ UH, dil, dnug


_PER_SM: dict = {}


def _plan(X, backward: int, xd: int, mh: int, n: int):
    """Kernel 4's cut (`gram.gram_plan`) with row groups of one warp:
    (R, grid); the blocks one SM holds are read once per device, kernel,
    widths and K (the instance's columns a lane holds follow K)."""
    B, K = X.shape[:2]
    key = (gram.device_index(X.device), backward, xd, mh, n, K)
    if key not in _PER_SM:
        with torch.cuda.device(key[0]):
            _PER_SM[key] = _build.load("fit_gram").fit_gram_blocks_per_sm(
                backward, xd, mh, n, K)
        if _PER_SM[key] < 1:
            raise RuntimeError(f"fit_gram: no block of the kernel fits for "
                               f"x_dim={xd}, 1+m={mh}, n={n}")
    R, _, grid = gram.gram_plan(B, K, 1, gram.device_sms(X.device),
                                _PER_SM[key], group=WARP)
    return R, grid


def _kernel_takes(tensors, dims) -> bool:
    """Whether csrc/fit_gram.cu takes these: float32 tensors on one CUDA
    device, every width in [1, MAX_DIM]."""
    device = tensors[0].device
    return (device.type == "cuda"
            and all(t.dtype == torch.float32 and t.device == device
                    for t in tensors)
            and all(1 <= d <= MAX_DIM for d in dims))


def _check(what: str, shaped) -> None:
    """Raise ValueError unless every (tensor, shape) has that shape."""
    for t, shape in shaped:
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: expected {shape}, got "
                             f"{tuple(t.shape)}")


def fit_gram(X, UB, UH, inv_ell, nug, mask):
    """The masked fit-Gram Km (B, K, K) of `km_expr`: one launch of
    csrc/fit_gram.cu where the kernel takes the tensors (`_kernel_takes`),
    else that plain version."""
    B, K, xd = X.shape
    mh = UB.shape[-1]
    ins = (X, UB, UH, inv_ell, nug, mask)
    if not _kernel_takes(ins, (xd, mh)):
        return km_expr(*ins)
    _check("fit_gram", zip(ins, ((B, K, xd), (B, K, mh), (B, K, mh),
                                 (B, xd), (B,), (B, K))))
    X, UB, UH, inv_ell, nug, mask = (t.contiguous() for t in ins)
    R, grid = _plan(X, 0, xd, mh, xd)
    out = torch.empty((B, K, K), dtype=X.dtype, device=X.device)
    rc = _build.load("fit_gram").fit_gram_launch(
        X.data_ptr(), UB.data_ptr(), UH.data_ptr(), inv_ell.data_ptr(),
        nug.data_ptr(), mask.data_ptr(), out.data_ptr(), B, K, xd, mh, R,
        grid, torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(rc, "fit_gram_launch")
    tracing.count("launches.fit_gram")
    return out


def fit_gram_backward(X, UB, UH, inv_ell, mask, Kinv, dY, S, dlogdet):
    """(dUB, d inv_ell, d nug) of `km_backward_plain`: one launch of
    csrc/fit_gram.cu where the kernel takes the tensors (`_kernel_takes`;
    dKm formed entry by entry, the bands' partial sums added here in band
    order), else that plain version."""
    B, K, xd = X.shape
    mh, n = UB.shape[-1], S.shape[-1]
    ins = (X, UB, UH, inv_ell, mask, Kinv, dY, S, dlogdet)
    if not _kernel_takes(ins, (xd, mh, n)):
        return km_backward_plain(*ins)
    _check("fit_gram_backward",
           zip(ins, ((B, K, xd), (B, K, mh), (B, K, mh), (B, xd), (B, K),
                     (B, K, K), (B, K, n), (B, K, n), (B,))))
    X, UB, UH, inv_ell, mask, Kinv, dY, S, dlogdet = (t.contiguous()
                                                       for t in ins)
    R, grid = _plan(X, 1, xd, mh, n)
    bands = -(-K // R)
    dUB = torch.empty_like(UB)
    part = torch.empty((B, bands, xd + 1), dtype=X.dtype, device=X.device)
    rc = _build.load("fit_gram").fit_gram_backward_launch(
        X.data_ptr(), UB.data_ptr(), UH.data_ptr(), inv_ell.data_ptr(),
        mask.data_ptr(), Kinv.data_ptr(), dY.data_ptr(), S.data_ptr(),
        dlogdet.data_ptr(), dUB.data_ptr(), part.data_ptr(), B, K, xd, mh, n,
        R, grid, torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(rc, "fit_gram_backward_launch")
    tracing.count("launches.fit_gram_backward")
    sums = part.sum(1)
    return dUB, -inv_ell * sums[:, :xd], sums[:, xd]


class _GramSolveLogdet(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, UB, UH, inv_ell, nug, mask, Y, method, assembly):
        ins = (X, UB, UH, inv_ell, nug, mask)
        need = ctx.needs_input_grad
        # the pull-back gives no gradient for X, UH or mask
        ctx.pullback = not (need[0] or need[2] or need[5])
        Km = fit_gram(*ins)
        Kinv, logdet = batched_kinv_logdet_fit(Km, method, assembly)
        S = Kinv @ Y
        ctx.save_for_backward(S, Kinv, *ins)
        return S, logdet

    @staticmethod
    def backward(ctx, dS, dlogdet):
        S, Kinv, *ins = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        dY = torch.zeros_like(S) if dS is None else Kinv @ dS
        grads = [None] * 6
        if ctx.pullback:
            if any(need):
                X, UB, UH, inv_ell, nug, mask = ins
                dl = torch.zeros_like(nug) if dlogdet is None else dlogdet
                dUB, dil, dnug = fit_gram_backward(
                    X, UB, UH, inv_ell, mask, Kinv, dY, S, dl)
                grads = [None, dUB if need[1] else None, None,
                         dil if need[3] else None, dnug if need[4] else None,
                         None]
        elif any(need):
            if Kinv.device.type == "cuda":
                tracing.count("gramsolve.recompute")
            dKm = torch.zeros_like(Kinv)
            if dS is not None:
                dKm = -dY @ S.transpose(-1, -2)
            if dlogdet is not None:
                dKm = dKm + dlogdet[..., None, None] * Kinv
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
    matmul-and-kernel backward (see the module docstring for its two
    routes); the inverse by the fit inverse `method`
    (`ops/cholinv.batched_kinv_logdet_fit`)."""
    return _GramSolveLogdet.apply(X, UB, UH, inv_ell, nug, mask, Y, method,
                                  assembly)

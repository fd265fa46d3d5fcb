"""Fused masked MVGP Gram (csrc/gram.cu) and its plain version.

    Kb = [s exp(-1/2 |Xs_i - Xs_j|^2)] o [UHB_i . UHB_j], masked to valid
         rows and columns, identity on invalid diagonal entries, + jitter

for Xs = X / lengthscale and UHB = UH chol(B), batched over episodes.  A
CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  Distances use the exact per-dimension differences (the
dot-product form cancels for nearby points, see `MVGP.k_xx`).
"""
from __future__ import annotations

import torch

from . import _build

MAX_DIM = 16


def fused_gram_kb_plain(Xs, UHB_half, mask, outputscale, jitter: float):
    """Xs (B, K, n), UHB_half (B, K, 1+m), mask (B, K), outputscale (B,)
    -> (B, K, K); `gram.fused_gram_kb_reference` of the JAX package,
    batched."""
    d = Xs[:, :, None, :] - Xs[:, None, :, :]
    rbf = outputscale[:, None, None] * torch.exp(-0.5 * torch.sum(d * d, -1))
    K = rbf * (UHB_half @ UHB_half.transpose(-1, -2))
    outer = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return (K * outer + eye * (1.0 - mask)[:, :, None]
            + jitter * eye * mask[:, :, None])


def fused_gram_kb(Xs, UHB_half, mask, outputscale, jitter: float):
    """The masked Gram (B, K, K).  Replaces the TPU kernel
    `gram._gram_kernel` (`fused_gram_kb`) on CUDA."""
    if Xs.device.type == "cpu":
        return fused_gram_kb_plain(Xs, UHB_half, mask, outputscale, jitter)
    if Xs.device.type != "cuda":
        raise ValueError(f"fused_gram_kb: no kernel for device {Xs.device}")
    B, K, n = Xs.shape
    mh = UHB_half.shape[-1]
    shapes = ((Xs, (B, K, n)), (UHB_half, (B, K, mh)), (mask, (B, K)),
              (outputscale, (B,)))
    for t, shape in shapes:
        if t.device != Xs.device or t.dtype != torch.float32:
            raise ValueError("fused_gram_kb: the kernel takes float32 "
                             "tensors on one CUDA device")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"fused_gram_kb: expected a contiguous {shape}, "
                             f"got {tuple(t.shape)}")
    if not (1 <= n <= MAX_DIM and 1 <= mh <= MAX_DIM and K >= 1):
        raise ValueError(f"fused_gram_kb: need 1 <= n, 1+m <= {MAX_DIM}, "
                         f"got n={n}, 1+m={mh}")
    lib = _build.load("gram")
    out = torch.empty((B, K, K), dtype=Xs.dtype, device=Xs.device)
    rc = lib.gram_launch(Xs.data_ptr(), UHB_half.data_ptr(), mask.data_ptr(),
                         outputscale.data_ptr(), float(jitter),
                         out.data_ptr(), B, K, n, mh,
                         torch.cuda.current_stream(Xs.device).cuda_stream)
    _build.check(rc, "gram_launch")
    fused_gram_kb.launches += 1
    return out


fused_gram_kb.launches = 0

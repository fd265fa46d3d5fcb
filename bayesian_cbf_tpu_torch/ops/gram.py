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

from ..observability import tracing
from . import _build

MAX_DIM = 16
THREADS = 256          # threads of one block of csrc/gram.cu
ROWS_PER_THREAD = 8    # rows of a band that one thread makes


def row_chunks(K: int) -> int:
    """Chunks of 4 columns in one output row, aligned to the row's
    16-byte alignment: a misaligned row (K % 4 != 0) has a partial chunk
    at each end."""
    return -(-(K + (0 if K % 4 == 0 else 3)) // 4)


def band_rows(K: int, P: int, rows_per_thread: int = ROWS_PER_THREAD,
              group: int = 0):
    """(R, G): the rows R of a band, in G groups of threads that own P
    chunks each (G a multiple of 4 where rows are misaligned, so that a
    thread's rows share their alignment), each thread making
    `rows_per_thread` rows; with `group`, G groups of that many threads
    (the fit-Gram kernels: one warp a row, P unused)."""
    if group:
        G = max(1, THREADS // group)
    else:
        G = max(1, THREADS // -(-row_chunks(K) // P))
        if K % 4 and G >= 4:
            G -= G % 4
    return min(K, G * rows_per_thread), G


def gram_plan(B: int, K: int, P: int, sms: int, per_sm: int,
              rows_per_thread: int = ROWS_PER_THREAD, group: int = 0):
    """The kernel's cut into work items: (R, G, grid).  An item is a band
    of R consecutive rows of one matrix (`band_rows`); `grid` persistent
    blocks, at most `sms` x `per_sm`, walk the B ceil(K / R) items, block
    g the items [g N / grid, (g + 1) N / grid) of N."""
    R, G = band_rows(K, P, rows_per_thread, group)
    items = B * -(-K // R)
    return R, G, max(1, min(items, sms * per_sm))


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


_SMS: dict = {}
_SHAPES: dict = {}


def device_index(device) -> int:
    """The CUDA device index of `device` (the current one if unnumbered)."""
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def device_sms(device) -> int:
    """The SM count of a CUDA device, read once per device."""
    index = device_index(device)
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index) \
            .multi_processor_count
    return _SMS[index]


def _plan(device, B: int, K: int, n: int, mh: int, rows_per_thread: int):
    """`gram_plan` for this device and shape: the SM count is read once per
    device; the blocks one SM holds and the chunks each thread owns (the
    kernel's instance for (n, 1+m)) once per (n, 1+m)."""
    index = device_index(device)
    sms = device_sms(device)
    key = (index, n, mh)
    if key not in _SHAPES:
        lib = _build.load("gram")
        with torch.cuda.device(index):
            _SHAPES[key] = (lib.gram_blocks_per_sm(n, mh),
                            lib.gram_thread_chunks(n, mh))
        if _SHAPES[key][0] < 1:
            raise RuntimeError(f"fused_gram_kb: no block of the kernel fits "
                               f"for n={n}, 1+m={mh}")
    per_sm, P = _SHAPES[key]
    return gram_plan(B, K, P, sms, per_sm, rows_per_thread)


def _launch(Xs, UHB_half, mask, outputscale, jitter: float,
            rows_per_thread: int = ROWS_PER_THREAD):
    """One launch of the kernel on checked CUDA tensors, not counted."""
    B, K, n = Xs.shape
    mh = UHB_half.shape[-1]
    R, G, grid = _plan(Xs.device, B, K, n, mh, rows_per_thread)
    out = torch.empty((B, K, K), dtype=Xs.dtype, device=Xs.device)
    rc = _build.load("gram").gram_launch(
        Xs.data_ptr(), UHB_half.data_ptr(), mask.data_ptr(),
        outputscale.data_ptr(), float(jitter), out.data_ptr(), B, K, n, mh,
        R, G, grid, torch.cuda.current_stream(Xs.device).cuda_stream)
    _build.check(rc, "gram_launch")
    return out


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
    out = _launch(Xs, UHB_half, mask, outputscale, jitter)
    tracing.count("launches.fused_gram_kb")
    return out

"""Batched inverse + logdet by recursive Schur complements over
symmetric-sweep base blocks (csrc/sweep.cu), and its plain version.

`batched_kinv_logdet(K, base)` -> (K^{-1}, logdet K) for a batch K
(B, n, n) of positive definite matrices.  A CPU tensor takes the plain
PyTorch version; a CUDA tensor launches one of the two kernels of
csrc/sweep.cu or raises.  `sweep_route` picks the kernel from the
schedule's shape: a schedule that is one sweep of all n pivots with n
within an instance's limit (the `"sweep_full"` fit inverse at n = 50 and
200) runs `sweep_regs_kernel`, which holds the matrix in registers; every
other schedule runs the event kernel `sweep_kernel`.  Both give the same
bits on a one-sweep schedule.

The recursion is that of the JAX package (`ops/pallas_sweep.py`): K is
padded with an identity tail to N, the smallest multiple of `base` >= n,
and each diagonal block of size s > base is split at
h = (s // (2 base)) base into

    inv([[A, B], [B^T, C]]) = [[Ainv + W Sinv W^T, -W Sinv],
                               [-(W Sinv)^T,        Sinv  ]],
    W = Ainv B,  S = C - B^T W,  logdet K = logdet A + logdet S;

a block of size `base` is inverted by sweeping its pivots, each pivot
floored at 1e-12, with logdet the sum of the log pivots.  The identity
tail never couples to the n x n block (every product with it is an exact
zero), so neither version materializes it: `schedule` walks the
recursion on the padded size, which fixes the split points and with them
the rounding, and keeps only the parts that touch the first n rows.

The recursion is NON-FINITE on near-singular trajectory Grams (kappa
~1e6 in f32) whenever it actually splits, as in the JAX package
(tests/test_fit_inverse.py pins it); `full_base(n)` gives the one-sweep
`"sweep_full"` variant, which stays finite there.
"""
from __future__ import annotations

import functools

import torch

from ..observability import tracing
from . import _build
from .chol_kernels import check_batch, padded_order

BASE_SMALL, BASE_LARGE, BASE_SWITCH_N = 8, 16, 256
SWEEP, PRE, POST = 0, 1, 2
PIVOT_FLOOR = 1e-12


def pick_base(n: int) -> int:
    """The JAX package's size-dependent base block: 8 up to n = 256,
    16 above (`pallas_sweep._pick_base`)."""
    return BASE_SMALL if n <= BASE_SWITCH_N else BASE_LARGE


def full_base(n: int) -> int:
    """Base of the one-sweep `"sweep_full"` fit inverse: a single block
    covering all n pivots (`cholinv.batched_kinv_logdet_fit`)."""
    return max(256, -(-n // 256) * 256)


def schedule(n: int, base: int):
    """The in-place recursion as a list of events (kind, o, a, b):

    (SWEEP, o, r, 0)  sweep the r x r block at (o, o), then negate it;
    (PRE, o, h, rc)   with A = rows [o, o+h) holding Ainv and
                      C = [o+h, o+h+rc): W = Ainv B, C -= B^T W, B <- W;
    (POST, o, h, rc)  with C holding Sinv: WS = W Sinv,
                      A += WS W^T, B <- -WS, B^T <- -WS^T.

    Blocks of the padded recursion that hold only identity padding are
    dropped; a split whose second half is all padding is its first half."""
    events = []

    def rec(o, s):
        r = min(max(n - o, 0), s)
        if r == 0:
            return
        if s == base:
            events.append((SWEEP, o, r, 0))
            return
        h = (s // (2 * base)) * base
        rec(o, h)
        rc = min(max(n - o - h, 0), s - h)
        if rc == 0:
            return
        events.append((PRE, o, h, rc))
        rec(o + h, s - h)
        events.append((POST, o, h, rc))

    rec(0, padded_order(n, base))
    return events


# The largest n of each instance of csrc/sweep.cu's `sweep_regs_kernel`,
# smallest first (`sweep_regs_limit` there returns the same).
REGS_LIMITS = (64, 224)


def sweep_route(n: int, events):
    """Which kernel runs a schedule: ("regs", instance) for one SWEEP of
    all n pivots with n within an instance's limit (the smallest that
    holds it), else ("events", None)."""
    if list(events) == [(SWEEP, 0, n, 0)]:
        for instance, limit in enumerate(REGS_LIMITS):
            if n <= limit:
                return "regs", instance
    return "events", None


@functools.lru_cache(maxsize=None)
def _route(n: int, base: int):
    return sweep_route(n, schedule(n, base))


def temp_size(events) -> int:
    """Floats of scratch per matrix: the largest h x rc panel."""
    return max([a * b for kind, o, a, b in events if kind != SWEEP] + [0])


def _rank1_update(blk, col, srow):
    """blk - col srow^T with one rounding per entry in f32, as the kernels'
    FMA (and XLA's contraction of the TPU kernel's update) rounds it: the
    product of two f32 values is exact in f64, so only the f64 sum is
    rounded before f32 (twice only where that sum falls on a tie of f32).
    Other dtypes round product and difference each."""
    if blk.dtype != torch.float32:
        return blk - col[:, :, None] * srow[:, None, :]
    return (blk.double() - col.double()[:, :, None]
            * srow.double()[:, None, :]).float()


def _sweep_block(M, o, r, ld):
    """Sweep all pivots of the block M[:, o:o+r, o:o+r] in place and
    negate it; accumulate the log pivots into ld (B,)."""
    blk = M[:, o:o + r, o:o + r]
    for p in range(r):
        d = torch.clamp(blk[:, p, p], min=PIVOT_FLOOR)
        idv = 1.0 / d
        ld += torch.log(d)
        srow = blk[:, p, :] * idv[:, None]
        col = blk[:, :, p].clone()
        blk.copy_(_rank1_update(blk, col, srow))
        blk[:, p, :] = srow
        blk[:, :, p] = col * idv[:, None]
        blk[:, p, p] = -idv
    blk.neg_()


def batched_kinv_logdet_plain(K: torch.Tensor, base: int = 0):
    """(K^{-1}, logdet K) by the same recursion in batched PyTorch (any
    float dtype, any device)."""
    n = K.shape[-1]
    base = int(base) or pick_base(n)
    M = K.clone()
    ld = torch.zeros(K.shape[:-2], dtype=K.dtype, device=K.device)
    for kind, o, a, b in schedule(n, base):
        if kind == SWEEP:
            _sweep_block(M, o, a, ld)
            continue
        h, rc = a, b
        A = slice(o, o + h)
        C = slice(o + h, o + h + rc)
        if kind == PRE:
            Bm = M[:, A, C]
            W = M[:, A, A] @ Bm
            M[:, C, C] -= Bm.transpose(-1, -2) @ W
            M[:, A, C] = W
        else:
            W = M[:, A, C]
            WS = W @ M[:, C, C]
            M[:, A, A] += WS @ W.transpose(-1, -2)
            M[:, A, C] = -WS
            M[:, C, A] = -WS.transpose(-1, -2)
    return M, ld


_EVENTS: dict = {}


def _device_events(n, base, device):
    key = (n, base, str(device))
    got = _EVENTS.get(key)
    if got is None:
        ev = schedule(n, base)
        got = (torch.tensor(ev, dtype=torch.int32, device=device)
               .contiguous(), len(ev), temp_size(ev))
        _EVENTS[key] = got
    return got


def _launch_events(K: torch.Tensor, base: int):
    """`sweep_kernel` on the schedule of (n, base); no launch counted."""
    B, n = check_batch(K, "batched_kinv_logdet")
    lib = _build.load("sweep")
    events, n_events, tsize = _device_events(n, base, K.device)
    Kinv = torch.empty_like(K)
    logdet = torch.empty((B,), dtype=K.dtype, device=K.device)
    scratch = None
    if not lib.sweep_uses_smem(n, tsize):
        scratch = torch.empty((B, max(tsize, 1)), dtype=K.dtype,
                              device=K.device)
    rc = lib.sweep_launch(
        K.data_ptr(), Kinv.data_ptr(), logdet.data_ptr(), events.data_ptr(),
        n_events, None if scratch is None else scratch.data_ptr(), B, n,
        tsize, torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "sweep_launch")
    return Kinv, logdet


def _launch_regs(K: torch.Tensor, instance: int):
    """`sweep_regs_kernel` (one sweep of all n pivots) through instance
    `instance`; no launch counted."""
    B, n = check_batch(K, "batched_kinv_logdet")
    lib = _build.load("sweep")
    Kinv = torch.empty_like(K)
    logdet = torch.empty((B,), dtype=K.dtype, device=K.device)
    rc = lib.sweep_regs_launch(
        K.data_ptr(), Kinv.data_ptr(), logdet.data_ptr(), B, n, instance,
        torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "sweep_regs_launch")
    return Kinv, logdet


def batched_kinv_logdet(K: torch.Tensor, base: int = 0):
    """(K^{-1}, logdet K) of a batch K (B, n, n).  Replaces the TPU kernel
    `pallas_sweep.batched_kinv_logdet` (`_kernel` / `_inv_logdet` /
    `_sweep_block`) on CUDA.  base=0 picks the size-dependent default."""
    if K.device.type == "cpu":
        return batched_kinv_logdet_plain(K, base)
    _, n = check_batch(K, "batched_kinv_logdet")
    base = int(base) or pick_base(n)
    kernel, instance = _route(n, base)
    if kernel == "regs":
        out = _launch_regs(K, instance)
    else:
        out = _launch_events(K, base)
    tracing.count("launches.batched_kinv_logdet")
    return out

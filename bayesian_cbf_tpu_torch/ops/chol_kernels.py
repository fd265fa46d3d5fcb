"""Batched Cholesky kernels (csrc/chol.cu, csrc/chol_blocked.cu,
csrc/cholsolve.cu) and their plain versions.

`chol_linv` -> (L, L^{-1}), `kinv_logdet` -> (K^{-1}, logdet K) and
`chol_dinv` -> (L, diagonal-block inverses) for a batch (B, n, n) of
positive definite matrices; `assemble_linv` builds L^{-1} from the last
with matmuls.  `cholsolve_logdet` -> (K^{-1} RHS, L, Dinv, logdet K) and
`solve_with_factor` (K^{-1} RHS against a saved L, Dinv) solve without
forming any inverse.  A CPU tensor takes the plain PyTorch version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ..observability import tracing
from . import _build

MAX_N = 1024
NB_BLK = 32   # block size of the blocked factor (`chol_dinv` and the solves)
# Block size of the fit inverse `kinv_logdet`, the JAX package's own
# (`cholinv.CHOLK_NB`).  The factor multiplies each panel by the explicit
# inverse of an nb x nb diagonal block, so a larger block is a less
# accurate inverse: on an H100, on trajectory Grams at (256, 200) with the
# fit's conditioning (7.7e5), 16 is within 4.7e-3 of the f64 inverse
# (relative to its largest entry) in 0.323 ms, 32 within 1.0e-2 in
# 0.281 ms, 8 within 2.1e-3 in 0.70 ms (`chip_smoke.py` prints them).  A
# larger block also turns non-finite at a lower condition number, where
# the plain version still returns a finite (and useless) inverse: 16 from
# between 1.0e7 and 2.0e7, 32 from 6.5e6 (`probe_kinv_logdet.py`).
KINV_NB = 16
# Block size of the cache refresh `chol_linv`.  Every posterior is a matmul
# against its L^{-1}, and it runs 12 to 72 times a rollout, so accuracy
# decides and the time only has to beat the plain version's: of 8, 16 and
# 32, the most accurate block size that is faster on the card than
# `chol_linv_plain`.  On an NVIDIA H100 80GB HBM3 at 700 W, trajectory
# Grams (256, 200) at the refresh's conditioning (7.7e5): ms / largest
# distance of L^{-1} from the f64 L^{-1}, relative to its largest entry /
# max|Linv L - I| (`probe_chol_linv.py`; `chip_smoke.py` prints the same
# table):
#     nb 8     0.688 ms   1.5e-3   4.7e-4      <- chosen
#     nb 16    0.316 ms   2.8e-3   4.4e-4
#     nb 32    0.273 ms   5.8e-3   4.7e-4
#     plain    1.027 ms   2.9e-3   4.1e-4
# (the column-at-a-time kernel this one replaced: 3.975 ms, 7.0e-4,
# 3.9e-4).  The residual does not see the difference.  The JAX package
# refreshes at 32 (`pallas_chol.NB_BLK`); here 32 also turns non-finite
# from a condition number of 6.5e6 (8: from 2e7; 16: 1e7 to 2e7), and on
# the reference-schedule pendulum's own refresh Grams it sends 65 of 6144
# episode refreshes to a higher rung of the jitter ladder (16: one), where
# 8, the plain version and the replaced kernel all accept the first rung.
LINV_NB = 8
MAX_NB = 64


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


def padded_order(n: int, nb: int) -> int:
    """n rounded up to a multiple of nb, at least nb: the order of the
    identity-padded matrix of the JAX package's blocked kernels."""
    return max(-(-n // nb) * nb, nb)


def _check_nb(nb: int, what: str):
    if not 1 <= nb <= MAX_NB:
        raise ValueError(f"{what}: need 1 <= nb <= {MAX_NB}, got {nb}")


def _scratch(need: bool, shape, like: torch.Tensor):
    return torch.empty(shape, dtype=like.dtype, device=like.device) \
        if need else None


def _check_blocked_nb(nb: int, what: str):
    """The kernels that assemble L^{-1} in place read float4 along a block."""
    _check_nb(nb, what)
    if nb % 4:
        raise ValueError(f"{what}: nb must be a multiple of 4, got {nb}")


def _launch_per_matrix(entry: str, K: torch.Tensor, nb: int, out0, out1):
    """Launch `entry` of csrc/chol.cu (one thread block per matrix of the
    contiguous f32 CUDA batch K, on the blocked factor of the identity-
    padded K at block size nb) into its two outputs."""
    B, n, _ = K.shape
    N = padded_order(n, nb)
    lib = _build.load("chol")
    dinv = torch.empty((B, N, nb), dtype=K.dtype, device=K.device)
    a = _scratch(not lib.chol_matrix_in_smem(N, nb), (B, N, N), K)
    rc = getattr(lib, f"{entry}_launch")(
        K.data_ptr(), out0.data_ptr(), out1.data_ptr(), dinv.data_ptr(),
        None if a is None else a.data_ptr(), B, n, N, nb,
        torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, f"{entry}_launch")


def chol_linv(K: torch.Tensor, nb: int = LINV_NB):
    """(L, L^{-1}) of a batch K (B, n, n), both exactly lower triangular.
    Replaces the TPU kernel `pallas_chol._chol_linv_kernel` on CUDA: the
    blocked factor of the identity-padded K at block size nb (a multiple
    of 4), L copied out, L^{-1} assembled in place over L by block rows
    and copied out, in one launch."""
    if K.device.type == "cpu":
        return chol_linv_plain(K)
    check_batch(K, "chol_linv")
    _check_blocked_nb(nb, "chol_linv")
    L, Linv = torch.empty_like(K), torch.empty_like(K)
    _launch_per_matrix("chol_linv", K, nb, L, Linv)
    tracing.count("launches.chol_linv")
    return L, Linv


def kinv_logdet(K: torch.Tensor, nb: int = KINV_NB):
    """(K^{-1}, logdet K) of a batch K (B, n, n).  Replaces the TPU kernel
    `pallas_chol._cholkinv_kernel` on CUDA: the blocked factor of the
    identity-padded K at block size nb (a multiple of 4), L^{-1} assembled
    in place over L by block rows, and L^{-T} L^{-1}, in one launch."""
    if K.device.type == "cpu":
        return kinv_logdet_plain(K)
    check_batch(K, "kinv_logdet")
    _check_blocked_nb(nb, "kinv_logdet")
    Kinv = torch.empty_like(K)
    logdet = torch.empty(K.shape[:1], dtype=K.dtype, device=K.device)
    _launch_per_matrix("kinv_logdet", K, nb, Kinv, logdet)
    tracing.count("launches.kinv_logdet")
    return Kinv, logdet


# ---- blocked factor with diagonal-block inverses (csrc/chol_blocked.cu) ----

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
    _check_nb(nb, "chol_dinv")
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
    tracing.count("launches.chol_dinv")
    return L, Dinv


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


def kinv_logdet_blocked_plain(K: torch.Tensor, nb: int = KINV_NB):
    """(K^{-1}, logdet K) by the steps of the `kinv_logdet` kernel: the
    blocked factor of the identity-padded K with its diagonal-block
    inverses, the "row" assembly of L^{-1}, L^{-T} L^{-1} cut to (n, n),
    and the logdet over the rows below n."""
    n = K.shape[-1]
    L, Dinv = chol_dinv_plain(K, nb)
    Linv = assemble_linv(L, Dinv, nb, "row")
    Kinv = (Linv.transpose(-1, -2) @ Linv)[:, :n, :n]
    diag = torch.diagonal(L, dim1=-2, dim2=-1)[:, :n]
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-20)), -1)
    return Kinv, logdet


def chol_linv_blocked_plain(K: torch.Tensor, nb: int = LINV_NB):
    """(L, L^{-1}) by the steps of the `chol_linv` kernel: the blocked
    factor of the identity-padded K with its diagonal-block inverses and
    the "row" assembly of L^{-1}, both cut to (n, n)."""
    n = K.shape[-1]
    L, Dinv = chol_dinv_plain(K, nb)
    Linv = assemble_linv(L, Dinv, nb, "row")
    return L[:, :n, :n].contiguous(), Linv[:, :n, :n].contiguous()


def chol_linv_assembled(K: torch.Tensor, assembly: str, nb: int = NB_BLK):
    """(L, L^{-1}) of a batch K (B, n, n) from `chol_dinv` and the "row"
    or "col" assembly."""
    n = K.shape[-1]
    L, Dinv = chol_dinv(K, nb)
    Linv = assemble_linv(L, Dinv, nb, assembly)
    return L[:, :n, :n], Linv[:, :n, :n]


# ---- factor + solve + logdet; solve with a saved factor (csrc/cholsolve.cu)

MAX_R = 64


def block_sweeps(L: torch.Tensor, Dinv: torch.Tensor, X: torch.Tensor,
                 nb: int) -> torch.Tensor:
    """K^{-1} X for X (B, N, r) against the blocked factor (L L^T = K):
    forward  y_j = Dinv_j (x_j - L[j, :j] y[:j]), backward
    x_j = Dinv_j^T (y_j - L[j+1:, j]^T x[j+1:]), by nb-row blocks, as the
    TPU kernels' `_solve_sweeps` does.  Dinv_j = L_jj^{-1}, so the two
    sweeps are the block forms of L y = X and L^T x = y."""
    N = L.shape[-1]
    nblk = N // nb
    ys = []
    for j in range(nblk):
        o = j * nb
        acc = X[:, o:o + nb]
        if j:
            acc = acc - L[:, o:o + nb, :o] @ torch.cat(ys, 1)
        ys.append(Dinv[:, o:o + nb] @ acc)
    xs = [None] * nblk
    for j in reversed(range(nblk)):
        o = j * nb
        acc = ys[j]
        if j + 1 < nblk:
            acc = acc - (L[:, o + nb:, o:o + nb].transpose(-1, -2)
                         @ torch.cat(xs[j + 1:], 1))
        xs[j] = Dinv[:, o:o + nb].transpose(-1, -2) @ acc
    return torch.cat(xs, 1)


def _pad_rows(RHS: torch.Tensor, N: int) -> torch.Tensor:
    """RHS (B, n, r) with zero rows appended up to N: the right-hand side
    of the identity-padded system."""
    B, n, r = RHS.shape
    return torch.cat([RHS, RHS.new_zeros((B, N - n, r))], 1)


def solve_with_factor_plain(L: torch.Tensor, Dinv: torch.Tensor,
                            RHS: torch.Tensor, nb: int = NB_BLK):
    """K^{-1} RHS (B, n, r) by `block_sweeps` against a saved factor."""
    n = RHS.shape[1]
    return block_sweeps(L, Dinv, _pad_rows(RHS, L.shape[-1]), nb)[:, :n]


def cholsolve_logdet_plain(K: torch.Tensor, RHS: torch.Tensor,
                           nb: int = NB_BLK):
    """(sol, L, Dinv, logdet) by `chol_dinv_plain` (`cholesky_ex` of the
    identity-padded K; the factor is unique, so it is the kernel's L up to
    roundoff), `block_sweeps` with its diagonal-block inverses, and
    logdet = 2 sum log max(diag L, 1e-20) (the padding adds log 1 = 0)."""
    L, Dinv = chol_dinv_plain(K, nb)
    sol = solve_with_factor_plain(L, Dinv, RHS, nb)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-20)), -1)
    return sol, L, Dinv, logdet


def _check_rhs(RHS: torch.Tensor, B: int, n_max: int, like: torch.Tensor,
               what: str) -> int:
    """Raise ValueError unless RHS is a contiguous f32 (B, n, r) batch on
    like's device with n <= n_max and 1 <= r <= MAX_R; return r."""
    if RHS.device != like.device or RHS.dtype != torch.float32:
        raise ValueError(f"{what}: RHS must be float32 on {like.device}, got "
                         f"{RHS.dtype} on {RHS.device}")
    if RHS.ndim != 3 or RHS.shape[0] != B or RHS.shape[1] > n_max:
        raise ValueError(f"{what}: expected RHS (B={B}, n<={n_max}, r), got "
                         f"{tuple(RHS.shape)}")
    if not RHS.is_contiguous():
        raise ValueError(f"{what}: RHS must be contiguous")
    r = RHS.shape[-1]
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{what}: need 1 <= r <= {MAX_R}, got r={r}")
    return r


def cholsolve_logdet(K: torch.Tensor, RHS: torch.Tensor, nb: int = NB_BLK):
    """(K^{-1} RHS (B, n, r), L (B, N, N), Dinv (B, N, nb), logdet K (B,))
    for a batch K (B, n, n) and RHS (B, n, r): the blocked factor of the
    identity-padded K (the arrays `chol_dinv` returns), two block sweeps
    and the logdet, in one launch.  Replaces the TPU kernel
    `pallas_chol._cholsolve_kernel` on CUDA."""
    if K.device.type == "cpu":
        return cholsolve_logdet_plain(K, RHS, nb)
    B, n = check_batch(K, "cholsolve_logdet")
    _check_nb(nb, "cholsolve_logdet")
    r = _check_rhs(RHS, B, n, K, "cholsolve_logdet")
    if RHS.shape[1] != n:
        raise ValueError(f"cholsolve_logdet: RHS has {RHS.shape[1]} rows, "
                         f"K has {n}")
    N = padded_order(n, nb)
    lib = _build.load("cholsolve")
    plan = lib.cholsolve_plan(N, nb, r)
    kw = dict(dtype=K.dtype, device=K.device)
    sol = torch.empty((B, n, r), **kw)
    L = torch.empty((B, N, N), **kw)
    Dinv = torch.empty((B, N, nb), **kw)
    logdet = torch.empty((B,), **kw)
    a = _scratch(not plan & 1, (B, N, N), K)
    x = _scratch(not plan & 2, (B, N, -(-r // 4) * 4), K)
    rc = lib.cholsolve_logdet_launch(
        K.data_ptr(), RHS.data_ptr(), sol.data_ptr(), L.data_ptr(),
        Dinv.data_ptr(), logdet.data_ptr(),
        None if a is None else a.data_ptr(),
        None if x is None else x.data_ptr(), B, n, N, nb, r,
        torch.cuda.current_stream(K.device).cuda_stream)
    _build.check(rc, "cholsolve_logdet_launch")
    tracing.count("launches.cholsolve_logdet")
    return sol, L, Dinv, logdet


def solve_groups(B: int, r: int, sms: int, width: int):
    """(groups, cols): the r columns of each right-hand side cut into
    `groups` blocks of `cols` columns (the last takes the rest), cols a
    multiple of 4 and at most `width` (what one block holds).  As few
    groups as fit; more, down to 4 columns a group, while the batch alone
    gives fewer blocks than the card's `sms` SMs.  The cut changes no bit
    of the solution: each entry's sums run in one thread in a fixed order."""
    quads = -(-r // 4)
    groups = -(-quads // max(1, width // 4))
    if B * groups < sms:
        groups = min(quads, max(groups, -(-sms // B)))
    cols = 4 * -(-quads // groups)
    return -(-r // cols), cols


_SMS: dict = {}


def _sm_count(device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index) \
            .multi_processor_count
    return _SMS[index]


_SOLVE_PLANS: dict = {}


def _launch_solve(L, Dinv, RHS, nb: int, groups: int | None = None):
    """One launch of kernel 7 on checked CUDA tensors, not counted: the
    columns cut as `solve_groups` cuts them (kept per library, shape and
    device), or into about `groups` blocks per matrix of a multiple of 4
    columns each."""
    B, N = L.shape[0], L.shape[-1]
    n, r = RHS.shape[1:]
    lib = _build.load("cholsolve")
    if groups is None:
        key = (lib, B, N, nb, r, L.device)
        if key not in _SOLVE_PLANS:
            _SOLVE_PLANS[key] = solve_groups(
                B, r, _sm_count(L.device), lib.solve_with_factor_width(N, nb))
        groups, cols = _SOLVE_PLANS[key]
    else:
        cols = 4 * -(-r // (4 * groups))
        groups = -(-r // cols)
    sol = torch.empty((B, n, r), dtype=L.dtype, device=L.device)
    rc = lib.solve_with_factor_launch(
        L.data_ptr(), Dinv.data_ptr(), RHS.data_ptr(), sol.data_ptr(), B, n,
        N, nb, r, groups, cols,
        torch.cuda.current_stream(L.device).cuda_stream)
    _build.check(rc, "solve_with_factor_launch")
    return sol


def solve_with_factor(L: torch.Tensor, Dinv: torch.Tensor,
                      RHS: torch.Tensor, nb: int = NB_BLK):
    """K^{-1} RHS (B, n, r) against a factor saved by `cholsolve_logdet`
    (L (B, N, N) padded, Dinv (B, N, nb)).  Replaces the TPU kernel
    `pallas_chol._solve_with_factor_kernel` on CUDA."""
    if L.device.type == "cpu":
        return solve_with_factor_plain(L, Dinv, RHS, nb)
    B, N = check_batch(L, "solve_with_factor")
    _check_nb(nb, "solve_with_factor")
    if N % nb:
        raise ValueError(f"solve_with_factor: N={N} is not a multiple of "
                         f"nb={nb}")
    if (Dinv.device != L.device or Dinv.dtype != L.dtype
            or tuple(Dinv.shape) != (B, N, nb) or not Dinv.is_contiguous()):
        raise ValueError(f"solve_with_factor: expected a contiguous float32 "
                         f"Dinv {(B, N, nb)} on {L.device}, got "
                         f"{Dinv.dtype} {tuple(Dinv.shape)} on {Dinv.device}")
    _check_rhs(RHS, B, N, L, "solve_with_factor")
    sol = _launch_solve(L, Dinv, RHS, nb)
    tracing.count("launches.solve_with_factor")
    return sol

"""Whole-batch SOCP interior-point kernel (csrc/ipm.cu) and its plain
version.

`ipm` runs `iters` Mehrotra predictor-corrector iterations of the
Nesterov-Todd scaled IPM on a batch of zero-padded cone problems
    min c^T x  s.t.  G x + s = h,  s in Q_d x ... x Q_d  (C cones)
from a start point (x, S, Z), and returns the best iterate.  A CPU tensor
takes `ipm_plain`; a CUDA tensor launches the kernel or raises.

Shapes: c (B, nx), Gp (B, C, d, nx), hp (B, C, d), sx (B, nx),
sS / sZ (B, C, d), all contiguous; the results x (B, nx), S / Z (B, C, d)
come back contiguous in the same layout.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_EPS = 1e-14
_BIG = 1e10

# the kernel's two builds: csrc/ipm.cu, and csrc/ipm_exact.cu (the same
# kernel at other shapes, built without contracted multiply-adds)
SOURCES = ("ipm", "ipm_exact")


def source_of(nx: int, C: int, d: int):
    """The source whose build instantiates (nx, C, d), or None.  Builds the
    kernel's libraries at first use."""
    for name in SOURCES:
        if _build.load(name).ipm_group_width(nx, C, d):
            return name
    return None


def group_width(nx: int, C: int, d: int) -> int:
    """Lanes per problem of the kernel instantiated at (nx, C, d): the
    smaller of 4 and 8 that holds the C cones, one lane each (a 32-thread
    block holds 32 // width problems); 0 where no build instantiates it."""
    name = source_of(nx, C, d)
    return _build.load(name).ipm_group_width(nx, C, d) if name else 0


def instantiated_shapes() -> tuple:
    """The (nx, C, d) that the builds instantiate, in the order of SOURCES
    and of each source's list."""
    cap = 16
    out = ()
    for name in SOURCES:
        buf = (ctypes.c_int * (3 * cap))()
        n = _build.load(name).ipm_shapes(ctypes.addressof(buf), cap)
        out += tuple(tuple(buf[3 * i:3 * i + 3]) for i in range(min(n, cap)))
    return out


# ---- batched cone algebra on (..., C, d) blocks --------------------------

def _jdot(U):
    return U[..., 0] ** 2 - torch.sum(U[..., 1:] ** 2, -1)


def _jflip(U):
    return torch.cat([U[..., :1], -U[..., 1:]], -1)


def _jmul(U, V):
    head = torch.sum(U * V, -1, keepdim=True)
    tail = U[..., :1] * V[..., 1:] + V[..., :1] * U[..., 1:]
    return torch.cat([head, tail], -1)


def _jinv_mul(L, V):
    det = _jdot(L)
    det = torch.where(torch.abs(det) < _EPS, torch.full_like(det, _EPS), det)
    L0 = L[..., 0]
    l0 = torch.where(torch.abs(L0) < _EPS, torch.full_like(L0, _EPS), L0)
    u0 = (L0 * V[..., 0] - torch.sum(L[..., 1:] * V[..., 1:], -1)) / det
    u1 = (V[..., 1:] - u0[..., None] * L[..., 1:]) / l0[..., None]
    return torch.cat([u0[..., None], u1], -1)


def _nt_scaling(S, Z):
    ss = torch.sqrt(torch.clamp(_jdot(S), min=_EPS))
    zz = torch.sqrt(torch.clamp(_jdot(Z), min=_EPS))
    Sb, Zb = S / ss[..., None], Z / zz[..., None]
    gam = torch.sqrt(torch.clamp((1.0 + torch.sum(Sb * Zb, -1)) * 0.5,
                                 min=_EPS))
    Wb = (Sb + _jflip(Zb)) / (2.0 * gam[..., None])
    eta = torch.sqrt(ss / zz)
    return Wb, eta


def _w_mul(Wb, eta, V):
    w0, w1 = Wb[..., :1], Wb[..., 1:]
    dot = torch.sum(w1 * V[..., 1:], -1, keepdim=True)
    head = w0 * V[..., :1] + dot
    tail = V[..., :1] * w1 + V[..., 1:] + w1 * (dot / (1.0 + w0))
    return eta[..., None] * torch.cat([head, tail], -1)


def _winv_mul(Wb, eta, V):
    U = _w_mul(Wb, torch.ones_like(eta), _jflip(V))
    return _jflip(U) / eta[..., None]


def _winv2_mul(Wb, eta, V):
    Jw = _jflip(Wb)
    dots = torch.sum(Jw * V, -1, keepdim=True)
    return (2.0 * Jw * dots - _jflip(V)) / (eta ** 2)[..., None]


def _max_step(P, D):
    """Per-cone largest t in [0, BIG] with P + t D in the cone."""
    a = _jdot(D)
    b = 2.0 * (P[..., 0] * D[..., 0]
               - torch.sum(P[..., 1:] * D[..., 1:], -1))
    cq = torch.clamp(_jdot(P), min=_EPS)
    disc = b * b - 4.0 * a * cq
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    big = torch.full_like(a, _BIG)
    denom = torch.where(torch.abs(a) > _EPS, 2.0 * a, torch.full_like(a, _EPS))
    r1 = (-b - sq) / denom
    r2 = (-b + sq) / denom
    lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
    root = torch.where(lo > 0, lo, torch.where(hi > 0, hi, big))
    lin_root = torch.where(b < 0, -cq / torch.where(b < 0, b, -torch.ones_like(b)),
                           big)
    t_quad = torch.where(torch.abs(a) > _EPS,
                         torch.where(disc > 0, root, big), lin_root)
    D0 = D[..., 0]
    t_head = torch.where(D0 < 0, -P[..., 0] / torch.where(
        D0 < 0, D0, -torch.ones_like(D0)), big)
    return torch.clamp(torch.minimum(t_quad, t_head), 0.0, _BIG)


def _chol_unrolled(H):
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            acc = H[..., i, j]
            for k in range(j):
                acc = acc - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(acc, min=_EPS))
            else:
                L[i][j] = acc / L[j][j]
    return L


def _chol_solve_unrolled(L, b):
    n = len(L)
    y = [None] * n
    for i in range(n):
        acc = b[..., i]
        for k in range(i):
            acc = acc - L[i][k] * y[k]
        y[i] = acc / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for k in range(i + 1, n):
            acc = acc - L[k][i] * x[k]
        x[i] = acc / L[i][i]
    return torch.stack(x, -1)


def g_mul(Gp, x):
    return torch.einsum('bcdn,bn->bcd', Gp, x)


def gt_mul(Gp, Z):
    return torch.einsum('bcdn,bcd->bn', Gp, Z)


def score_padded(c, Gp, hp, x, S, Z):
    """Scale-relative KKT score (B,) of a point of the padded problems."""
    nu = float(Gp.shape[-3])
    hnorm = torch.clamp(torch.linalg.vector_norm(hp, dim=(-2, -1)), min=1.0)
    cnorm = torch.clamp(torch.linalg.vector_norm(c, dim=-1), min=1.0)
    rx = c + gt_mul(Gp, Z)
    rz = g_mul(Gp, x) + S - hp
    mu = torch.abs(torch.sum(S * Z, (-2, -1))) / nu
    return torch.maximum(torch.maximum(
        torch.linalg.vector_norm(rz, dim=(-2, -1)) / hnorm,
        torch.linalg.vector_norm(rx, dim=-1) / cnorm), mu)


def ipm_plain(c, Gp, hp, sx, sS, sZ, iters: int, tol: float):
    """Batched port of `solvers/socp._solve_padded_plain`: fixed-iteration
    Mehrotra IPM from an interior start; returns the best iterate."""
    B, C, d, nx = Gp.shape
    nu = float(C)
    e = torch.zeros((B, C, d), dtype=c.dtype, device=c.device)
    e[..., 0] = 1.0
    eye = torch.eye(nx, dtype=c.dtype, device=c.device)
    x, S, Z = sx, sS, sZ
    bx, bS, bZ = torch.zeros_like(sx), e, e
    bscore = torch.full((B,), float("inf"), dtype=c.dtype, device=c.device)

    def sel(m, a, b):
        return torch.where(m.reshape(m.shape + (1,) * (a.ndim - 1)), a, b)

    for _ in range(iters):
        score = score_padded(c, Gp, hp, x, S, Z)
        better = score < bscore
        bx, bS, bZ = sel(better, x, bx), sel(better, S, bS), sel(better, Z, bZ)
        bscore = torch.minimum(score, bscore)
        done = score < tol

        rx = c + gt_mul(Gp, Z)
        rz = g_mul(Gp, x) + S - hp
        mu = torch.sum(S * Z, (-2, -1)) / nu

        Wb, eta = _nt_scaling(S, Z)
        lam = _w_mul(Wb, eta, Z)
        Jw = _jflip(Wb)
        dots = torch.einsum('bcd,bcdn->bcn', Jw, Gp)
        JG = torch.cat([Gp[..., :1, :], -Gp[..., 1:, :]], -2)
        Winv2G = ((2.0 * Jw[..., None] * dots[..., None, :] - JG)
                  / (eta ** 2)[..., None, None])
        H = torch.einsum('bcdn,bcdm->bnm', Gp, Winv2G)
        trH = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        H = H + 1e-12 * trH[:, None, None] * eye
        Lun = _chol_unrolled(H)

        def kkt_solve(Dscaled):
            rhs_cd = rz - _w_mul(Wb, eta, Dscaled)
            rhs = -rx - gt_mul(Gp, _winv2_mul(Wb, eta, rhs_cd))
            dx = _chol_solve_unrolled(Lun, rhs)
            Gdx = g_mul(Gp, dx)
            dS = -rz - Gdx
            dZ = _winv2_mul(Wb, eta, Gdx + rhs_cd)
            return dx, dS, dZ

        dx_a, dS_a, dZ_a = kkt_solve(lam)
        alpha_a = torch.clamp(torch.minimum(
            torch.amin(_max_step(S, dS_a), -1),
            torch.amin(_max_step(Z, dZ_a), -1)), max=1.0)
        mu_a = torch.sum((S + alpha_a[:, None, None] * dS_a)
                         * (Z + alpha_a[:, None, None] * dZ_a), (-2, -1)) / nu
        sigma = torch.clamp((mu_a / torch.clamp(mu, min=_EPS)) ** 3, 0.0, 1.0)

        corr = _jmul(_winv_mul(Wb, eta, dS_a), _w_mul(Wb, eta, dZ_a))
        rs = _jmul(lam, lam) + corr - (sigma * mu)[:, None, None] * e
        Dcomb = _jinv_mul(lam, rs)

        dx, dS, dZ = kkt_solve(Dcomb)
        alpha = 0.99 * torch.minimum(torch.amin(_max_step(S, dS), -1),
                                     torch.amin(_max_step(Z, dZ), -1))
        alpha = torch.clamp(alpha, max=1.0)

        x_new = x + alpha[:, None] * dx
        S_new = S + alpha[:, None, None] * dS
        Z_new = Z + alpha[:, None, None] * dZ
        finite = (torch.isfinite(x_new).all(-1)
                  & torch.isfinite(S_new).all((-2, -1))
                  & torch.isfinite(Z_new).all((-2, -1)))
        keep = done | ~finite
        x, S, Z = sel(keep, x, x_new), sel(keep, S, S_new), sel(keep, Z, Z_new)

    score = score_padded(c, Gp, hp, x, S, Z)
    better = score < bscore
    return sel(better, x, bx), sel(better, S, bS), sel(better, Z, bZ)


def check_ipm_args(c, Gp, hp, sx, sS, sZ):
    """(B, C, d, nx) of a batch of padded cone problems and a start point,
    or ValueError.  The one rule for both devices: six tensors of one
    floating dtype (float32 on a card: the kernel's) on one device, of the
    shapes c, sx (B, nx), Gp (B, C, d, nx), hp, sS, sZ (B, C, d) with
    B >= 1, each contiguous: the kernel reads the callers' layout as it
    stands, and no copy is made here."""
    if Gp.ndim != 4:
        raise ValueError(f"ipm: Gp must be (B, C, d, nx), got "
                         f"{tuple(Gp.shape)}")
    B, C, d, nx = Gp.shape
    if min(B, C, d, nx) < 1:
        raise ValueError(f"ipm: empty problem batch {tuple(Gp.shape)}")
    if not c.dtype.is_floating_point or (c.device.type == "cuda"
                                         and c.dtype != torch.float32):
        raise ValueError(f"ipm: no solver for dtype {c.dtype} on {c.device}")
    shapes = (("c", c, (B, nx)), ("Gp", Gp, (B, C, d, nx)),
              ("hp", hp, (B, C, d)), ("sx", sx, (B, nx)),
              ("sS", sS, (B, C, d)), ("sZ", sZ, (B, C, d)))
    for name, a, shp in shapes:
        if a.dtype != c.dtype or tuple(a.shape) != shp \
                or a.device != c.device:
            raise ValueError(f"ipm: expected {name} {c.dtype} {shp} on "
                             f"{c.device}, got {a.dtype} {tuple(a.shape)} "
                             f"on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"ipm: {name} must be contiguous")
    return B, C, d, nx


def ipm(c, Gp, hp, sx, sS, sZ, iters: int, tol: float):
    """Dispatch by device: `ipm_plain` on the CPU, the CUDA kernel (which
    replaces the TPU kernel `pallas_ipm._ipm_kernel`) on a card.  Inputs as
    `check_ipm_args` wants them; returns contiguous x (B, nx), S and Z
    (B, C, d).  The kernel takes and gives the callers' layout: one lane per
    cone reads its (d, nx) block of Gp, which is contiguous there."""
    B, C, d, nx = check_ipm_args(c, Gp, hp, sx, sS, sZ)
    if c.device.type == "cpu":
        return ipm_plain(c, Gp, hp, sx, sS, sZ, iters, tol)
    if c.device.type != "cuda":
        raise ValueError(f"ipm: no kernel for device {c.device}")
    name = source_of(nx, C, d)
    if name is None:
        raise ValueError(f"ipm: no kernel instantiation for (nx, C, d)="
                         f"({nx}, {C}, {d}); instantiated: "
                         f"{instantiated_shapes()}")
    lib = _build.load(name)
    x, S, Z = torch.empty_like(sx), torch.empty_like(sS), torch.empty_like(sZ)
    rc = lib.ipm_launch(c.data_ptr(), Gp.data_ptr(), hp.data_ptr(),
                        sx.data_ptr(), sS.data_ptr(), sZ.data_ptr(),
                        x.data_ptr(), S.data_ptr(), Z.data_ptr(),
                        B, nx, C, d, int(iters), float(tol),
                        torch.cuda.current_stream(c.device).cuda_stream)
    _build.check(rc, "ipm_launch")
    ipm.launches += 1
    return x, S, Z


ipm.launches = 0

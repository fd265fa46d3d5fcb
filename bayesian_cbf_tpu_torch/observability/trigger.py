"""Self-triggered control intervals.

Given each step's kernel hyperparameters (sf, ls, A, B), the applied
control and the state's velocity, bound the Lipschitz constant of the GP
sample paths (Eq. 11 of the paper) on a grid around the state and turn
it into the interval

    tau = (1 / Lfh) log(1 + Lfh zeta / ((Lfh + L_alpha) Lh |xdot|))

for which the held control stays provably safe.  Every function is
vectorized over leading step axes: a whole trajectory's intervals are one
set of batched tensor expressions.

Two quirks of the reference are kept on purpose: `r` is the Frobenius
norm of all the grid's pairwise differences, not the grid's diameter;
and Lh is the per-step signed maximum entry of grad_cbf over the local
grid, not its norm.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _rbf(X, Xp, sf, ls):
    """sf^2 exp(-1/2 |(x - x') / ls|^2) on pairs: X (..., N, E),
    Xp (..., N', E), sf (...), ls (..., E) -> (..., N, N')."""
    d = (X[..., :, None, :] - Xp[..., None, :, :]) / ls[..., None, None, :]
    return sf[..., None, None] ** 2 * torch.exp(-0.5 * torch.sum(d * d, -1))


def _d2k_dxi_dxpi(X, Xp, i, sf, ls):
    """d^2 k / dx_i dx'_i on pairs (diagonal pairs X == Xp allowed)."""
    k = _rbf(X, Xp, sf, ls)
    li2 = ls[..., i, None, None] ** 2
    di = (X[..., :, None, i] - Xp[..., None, :, i]) / li2
    return (1.0 / li2 - di * di) * k


def _d3k(X, Xp, i, sf, ls):
    """The reference's d^3 k / dx_i^2 dx'_i: -2 ls_i^-2 dk/dx_i (its
    cubic term is never added there)."""
    k = _rbf(X, Xp, sf, ls)
    li2 = ls[..., i, None, None] ** 2
    di = (X[..., :, None, i] - Xp[..., None, :, i]) / li2
    dk = -di * k
    return -2.0 * dk / li2


def _local_grid(x, grid_half_width, grid_pts):
    """The grid_pts^E lattice of offsets within +-grid_half_width (ij
    order) around each state x (..., E): (..., grid_pts^E, E)."""
    E = x.shape[-1]
    axes = [torch.linspace(-w, w, grid_pts, dtype=x.dtype, device=x.device)
            for w in grid_half_width]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1,
                                                                         E)
    return grid + x[..., None, :]


def lipschitz_bound_f(x, sf, ls, A_diag, uBu,
                      generator: Optional[torch.Generator] = None,
                      grid_half_width=(0.1, 0.1, math.pi / 100),
                      grid_pts=10, deltaL=1e-4,
                      draws: Optional[torch.Tensor] = None):
    """The high-probability Lipschitz bound Lfh of the GP dynamics around
    each state x (..., E) (Eq. 11) and its numerical sample estimate
    Lfh_num, each (...).  sf (...), ls (..., E), A_diag (..., E),
    uBu (...).  The sample estimate's Gaussian draws (..., E, N), N =
    grid_pts^E, come from `generator` on x's device, or are `draws`.

    `r` is the Frobenius norm of the full (N, N, E) tensor of pairwise
    differences, about N times the mean pair distance (the reference's
    `pdist`), not the grid's diameter."""
    E = x.shape[-1]
    Xtest = _local_grid(x, grid_half_width, grid_pts)          # (..., N, E)
    N = Xtest.shape[-2]
    r2 = 0
    for e in range(E):
        de = Xtest[..., :, None, e] - Xtest[..., None, :, e]
        r2 = r2 + torch.sum(de * de, (-2, -1))
    r = torch.sqrt(r2)
    uBu_ = uBu[..., None, None]
    d2max, cols = [], []
    for j in range(E):
        d2max.append(torch.amax(_d2k_dxi_dxpi(Xtest, Xtest, j, sf, ls),
                                (-2, -1)))
        maxk_per_ei = A_diag * uBu[..., None] * d2max[j][..., None]  # (..., E)
        Lkd_j = torch.amax(uBu_ * _d3k(Xtest, Xtest, j, sf, ls), (-2, -1))
        term = 12.0 * math.sqrt(6.0 * E) * torch.maximum(
            maxk_per_ei, torch.sqrt(torch.clamp(
                r[..., None] * A_diag * Lkd_j[..., None], min=0.0)))
        cols.append(math.sqrt(2.0 * math.log(2.0 * E * E / deltaL))
                    * maxk_per_ei + term)
    Lfs = torch.stack(cols, -1)                                # (..., E, E)
    Lfh = torch.linalg.matrix_norm(Lfs) / E

    if draws is None:
        draws = torch.randn(x.shape[:-1] + (E, N), generator=generator,
                            dtype=x.dtype, device=x.device)
    diag_d2 = torch.stack([torch.diagonal(
        _d2k_dxi_dxpi(Xtest, Xtest, j, sf, ls), dim1=-2, dim2=-1)
        for j in range(E)], -2)                                # (..., E, N)
    grad_sigma = (A_diag[..., :, None, None] * uBu_[..., None]
                  * diag_d2[..., None, :, :])                  # (..., E, E, N)
    samples = torch.abs(draws[..., None, :, :] * grad_sigma)
    Lfh_num = torch.linalg.matrix_norm(torch.amax(samples, -1)) / E
    return Lfh, Lfh_num


def per_step_cbf_grad_max(X_traj, cbfs,
                          grid_half_width=(0.1, 0.1, math.pi / 100),
                          grid_pts=6):
    """The reference's per-step Lh: the signed maximum entry of grad_cbf
    over the local grid around each state of X_traj (T, E), maximized
    over the barriers: (T,)."""
    Xtest = _local_grid(X_traj, grid_half_width, grid_pts)     # (T, N, E)
    return torch.stack([torch.amax(cbf.grad_cbf(Xtest), (-2, -1))
                        for cbf in cbfs]).amax(0)


def trigger_intervals(X_traj, Xdot_traj, U_traj, sf_traj, ls_traj,
                      A_traj, B_traj, cbf_grads_max,
                      generator: Optional[torch.Generator] = None,
                      zeta=1e-2, L_alpha=1.0, deltaL=1e-4, grid_pts=6,
                      draws: Optional[torch.Tensor] = None):
    """Self-triggered intervals of a trajectory of T steps: X_traj,
    Xdot_traj (T, E), U_traj (T, m), sf_traj (T,), ls_traj (T, E), A_traj
    (T, E, E), B_traj (T, 1+m, 1+m); cbf_grads_max (Lh) a scalar or (T,)
    (`per_step_cbf_grad_max`).  The Gaussian draws of Lfh_num (T, E, N)
    come from `generator` or are `draws`.  Returns (tau, tau_num, Lfh,
    Lfh_num, |xdot|), each (T,)."""
    T = X_traj.shape[0]
    UH = torch.cat([torch.ones_like(U_traj[:, :1]), U_traj], 1)
    Lh = torch.as_tensor(cbf_grads_max, dtype=X_traj.dtype,
                         device=X_traj.device).reshape(-1).expand(T)
    uBu = torch.einsum('ti,tij,tj->t', UH, B_traj, UH)
    Lfh, Lfh_num = lipschitz_bound_f(
        X_traj, sf_traj, ls_traj, torch.diagonal(A_traj, dim1=-2, dim2=-1),
        uBu, generator, grid_pts=grid_pts, deltaL=deltaL, draws=draws)
    xvel = torch.linalg.vector_norm(Xdot_traj, dim=-1)

    def tau_of(L):
        return (1.0 / L) * torch.log1p(L * zeta / ((L + L_alpha) * Lh * xvel))

    return tau_of(Lfh), tau_of(Lfh_num), Lfh, Lfh_num, xvel

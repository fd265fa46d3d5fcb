"""Chance-constraint safety factors, the relative-degree-2 control
barrier condition (CBC2) of a learned model, and its second-order cone.

The CBC2 has two routes to the same terms: as a GP expression at one
state (`cbc2_gp`), whose u-structure `cbc2_quadratic_terms` extracts by
differentiating in u (`cbc2_gp_terms` vectorizes both over a batch of
episodes), and in closed form from the posterior's moment derivatives
(`cbc2_closed_form_terms`).
"""
from __future__ import annotations

import math

import torch

from ..gp.algebra import EPS, DeterministicGP, GP, GradientGP
from ..utils.func import affine_terms, quadratic_terms
from ..utils.linalg import psd_chol_small_ladder


def cbc1_safety_factor(delta: float) -> float:
    """Gaussian bound sqrt(2) erfinv(1 - 2 delta), for delta < 0.5."""
    if not delta < 0.5:
        raise ValueError("require more than 50% safety (delta < 0.5)")
    e = torch.special.erfinv(torch.tensor(1.0 - 2.0 * delta,
                                          dtype=torch.float64))
    return math.sqrt(2.0) * float(e)


def cbc2_safety_factor(delta: float) -> float:
    """Cantelli bound sqrt((1 - delta) / delta), for delta < 0.5."""
    if not delta < 0.5:
        raise ValueError("require more than 50% safety (delta < 0.5)")
    return math.sqrt((1.0 - delta) / delta)


def cbc2_gp(h, grad_h, pair_fn, x_dim: int, k_alpha, u) -> GP:
    """The relative-degree-2 CBC as a GP at one state, for control u (m,):

        CBC2 = L2h + k_alpha[0] h + k_alpha[1] L1h,
        L1h = grad_h^T f,   L2h = grad(L1h)^T (F u).

    h, grad_h: the barrier and its gradient at one state x (n,).
    pair_fn(u) returns the model's (f, Fu) GPs at u with their
    cross-covariance registered (the JAX package's cbc2_gp takes the two
    as separate callbacks)."""
    f_gp, fu_gp = pair_fn(u)
    h_gp = DeterministicGP(lambda x: h(x).reshape(1), dim=1, name="h")
    grad_h_gp = DeterministicGP(grad_h, dim=x_dim, name="grad_h")
    L1h = grad_h_gp.t() @ f_gp
    L2h = GradientGP(L1h, x_dim=x_dim).t() @ fu_gp
    return L2h + h_gp * k_alpha[0] + L1h * k_alpha[1]


def cbc2_quadratic_terms(cbc_of_u, x, u0):
    """The u-structure of a family of scalar GPs u -> cbc_of_u(u) at one
    state x (n,): ((bfe (m,), e), (V (m, m), bfv (m,), v), mean, var) with

        mean(x; u) = bfe^T u + e              (affine in u)
        var(x; u)  = u^T V u + bfv^T u + v    (quadratic in u),

    extracted by differentiating at u0 (m,), and the two at u0 from the
    terms (each family is evaluated once)."""
    mean_fn = lambda u: cbc_of_u(u).mean(x).reshape(())
    knl_fn = lambda u: cbc_of_u(u).knl(x, x).reshape(())
    bfe, e = affine_terms(mean_fn, u0)
    V, bfv, v = quadratic_terms(knl_fn, u0)
    return (bfe, e), (V, bfv, v), bfe @ u0 + e, u0 @ V @ u0 + bfv @ u0 + v


def cbc2_gp_terms(cbf, k_alpha, pair_fn, state, x, u0):
    """`cbc2_quadratic_terms(cbc2_gp(...))` for a batch: the CBC2 terms of
    barrier `cbf` (batch-first cbf and grad_cbf) at states x (B, n),
    extracted at u0 (B, m), each episode with the (f, Fu) pair
    pair_fn(state_b, u) of its own learner state (`state`: a tree of
    tensors with the episode axis in front, e.g. a LearnedDynState and
    `LearnedShiftInvariantDynamics.f_gp_and_fu_gp`).  Vectorized with
    `torch.func.vmap`; returns the terms with the episode axis in front,
    as `cbc2_closed_form_terms` does."""
    n = x.shape[-1]
    h = lambda x1: cbf.cbf(x1[None])[0]
    grad_h = lambda x1: cbf.grad_cbf(x1[None])[0]

    def one(x1, u01, st):
        return cbc2_quadratic_terms(
            lambda u: cbc2_gp(h, grad_h, lambda v: pair_fn(st, v), n,
                              k_alpha, u), x1, u01)

    return torch.func.vmap(one)(x, u0, state)


def _clamp_small_negative_eigs(K):
    """K (B, n, n) symmetric with its eigenvalues in (-EPS, 0) set to zero.
    For n = 2 in closed form: with eigenvalues l1 <= l2, the projector on
    l1's eigenvector is (K - l2 I) / (l1 - l2), and the two differ whenever
    exactly one is clamped; other n go through `torch.linalg.eigh`."""
    if K.shape[-1] != 2:
        w, v = torch.linalg.eigh(K)
        w = torch.where((w < 0) & (w > -EPS), torch.zeros_like(w), w)
        return (v * w[..., None, :]) @ v.transpose(-1, -2)
    a, b, c = K[:, 0, 0], K[:, 0, 1], K[:, 1, 1]
    mid = 0.5 * (a + c)
    rad = torch.sqrt((0.5 * (a - c)) ** 2 + b * b)
    l1, l2 = mid - rad, mid + rad
    c1 = (l1 < 0) & (l1 > -EPS)
    c2 = (l2 < 0) & (l2 > -EPS)
    eye = torch.eye(2, dtype=K.dtype, device=K.device)
    gap = torch.where(rad > 0, l1 - l2, -torch.ones_like(rad))
    P1 = (K - l2[:, None, None] * eye) / gap[:, None, None]
    drop = (torch.where(c1, l1, torch.zeros_like(l1))[:, None, None] * P1
            + torch.where(c2, l2, torch.zeros_like(l2))[:, None, None]
            * (eye - P1))
    return torch.where((c1 & c2)[:, None, None], torch.zeros_like(K),
                       K - drop)


def cbc2_closed_form_terms(cbf, k_alpha, mder, x, u0):
    """The CBC2 of barrier `cbf` (value, gradient and Hessian in x) under
    the posterior moment derivatives mder = (M, dM, Bk, D1, D2, A)
    (`LearnedShiftInvariantDynamics.moment_derivatives`), at states x
    (B, n):

        CBC2 = G^T (F uh) + ka0 h + ka1 L1h,   L1h = grad_h^T f,
        G = grad L1h,   uh = [1; u],

    whose mean is affine and variance quadratic in uh (vec F(x) ~
    N(vec M^T, Bk kron A), exact Isserlis algebra; the JAX package's
    `cbc2_closed_form_moments`, with the same EPS clamp on the covariance
    K_G of G).  The coefficients are written out here instead of being
    extracted by differentiating in u.  Returns ((bfe (B, m), e (B,)),
    (V (B, m, m), bfv (B, m), v (B,)), mean (B,), var (B,)) with
    mean(u) = bfe^T u + e, var(u) = u^T V u + bfv^T u + v, the last two
    evaluated at u0 (B, m)."""
    M, dM, Bk, D1, D2, A = mder
    ka0, ka1 = k_alpha
    g1 = cbf.grad_cbf(x)                                      # (B, n)
    Hh = cbf.hess_cbf(x)
    Hh = 0.5 * (Hh + Hh.transpose(-1, -2))
    mv = lambda P, v: (P @ v[..., None])[..., 0]
    dot = lambda a, b: torch.sum(a * b, -1)
    mu_f = M[..., 0]
    mu_G = mv(Hh, mu_f) + mv(dM[:, :, 0, :].transpose(-1, -2), g1)
    Ag = mv(A, g1)
    s = dot(g1, Ag)
    HA = Hh @ A
    HAg = mv(Hh, Ag)
    b00 = Bk[:, 0, 0]
    d1 = D1[:, :, 0, 0]
    K_G = (D2[..., 0, 0] * s[:, None, None] + d1[..., None] * HAg[:, None]
           + HAg[..., None] * d1[:, None] + b00[:, None, None] * (HA @ Hh))
    K_G = _clamp_small_negative_eigs(0.5 * (K_G + K_G.transpose(-1, -2)))
    P = D1[:, :, 0, :]                  # cov(G, F uh) = sum_j uh_j C_j,
    beta = Bk[:, 0, :]                  # C_j = P_j Ag^T + beta_j HA
    Mt = M.transpose(-1, -2)
    trHA = torch.diagonal(HA, dim1=-2, dim2=-1).sum(-1)
    # mean = w^T uh + const
    w = mv(Mt, mu_G) + mv(P.transpose(-1, -2), Ag) + beta * trHA[:, None]
    const = ka0 * cbf.cbf(x) + ka1 * dot(g1, mu_f)
    # var = uh^T Q uh + l^T uh + c0
    PtHAg = mv(P.transpose(-1, -2), mv(HA, Ag))
    cross = (mv(P.transpose(-1, -2), mu_G)[..., None] * mv(Mt, Ag)[:, None]
             + beta[..., None] * mv(Mt, mv(HA.transpose(-1, -2), mu_G))
             [:, None])
    CC = (P.transpose(-1, -2) @ P * dot(Ag, Ag)[:, None, None]
          + PtHAg[..., None] * beta[:, None] + beta[..., None] * PtHAg[:, None]
          + beta[..., None] * beta[:, None]
          * torch.sum(HA * HA, (-2, -1))[:, None, None])
    Q = (Bk * (dot(mu_G, mv(A, mu_G)) + torch.sum(K_G * A, (-2, -1)))
         [:, None, None] + Mt @ K_G @ M + cross + cross.transpose(-1, -2)
         + CC)
    Q = 0.5 * (Q + Q.transpose(-1, -2))
    lin = 2.0 * ka1 * (beta * dot(mu_G, Ag)[:, None]
                       + mv(Mt, d1 * s[:, None] + b00[:, None] * HAg))
    c0 = ka1 ** 2 * b00 * s
    bfe, e = w[:, 1:], w[:, 0] + const
    V = Q[:, 1:, 1:]
    bfv = 2.0 * Q[:, 0, 1:] + lin[:, 1:]
    v = Q[:, 0, 0] + lin[:, 0] + c0
    mean = dot(bfe, u0) + e
    var = dot(u0, mv(V, u0)) + dot(bfv, u0) + v
    return (bfe, e), (V, bfv, v), mean, var


def cbc_to_socp_cone(bfe, e, V, bfv, v, extravars: int = 2,
                     relax_col: int = -1):
    """Second-order cone data (A (B, m+1, nvar), b (B, m+1), bfc (B, nvar),
    d (B,)) of mean - rho sqrt(var) >= 0 for the terms above:
    [1, u] Asq [1; u] = var(u) with Asq = [[v, bfv^T/2], [bfv/2, V]], and
    with the jitter-laddered factor Asq = L L^T, sqrt(var) = ||L^T [1; u]||,
    so the constraint is bfc^T [u; extras] + d >= rho ||A [u; extras] + b||.
    `extravars` trailing variables follow u; relax_col >= 0 gives that
    extra variable coefficient 1 in bfc (a slack)."""
    B, m = bfe.shape
    nvar = m + extravars
    Asq = torch.cat([torch.cat([v[:, None, None], 0.5 * bfv[:, None]], 2),
                     torch.cat([0.5 * bfv[..., None], V], 2)], 1)
    Lt = psd_chol_small_ladder(Asq, init_jitter=1e-12).transpose(-1, -2)
    A = torch.cat([Lt[..., 1:], bfe.new_zeros((B, m + 1, extravars))], -1)
    bfc = torch.cat([bfe, bfe.new_zeros((B, extravars))], -1)
    if relax_col >= 0:
        bfc[:, m + relax_col] = 1.0
    return A, Lt[..., 0], bfc, e

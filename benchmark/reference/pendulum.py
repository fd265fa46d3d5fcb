"""Plain reference of the pendulum online-learning study: the reference's
`run_pendulum_control_online_learning` (`Bayesian_CBF`
`bayes_cbf/pendulum.py:1041-1048`) batched over episodes.

The pendulum's drift and actuation are learned from scratch by a
full-rank matrix-variate GP (zero prior mean).  Each step of each
episode: the posterior of F(x) with its x-derivatives -> an LQR gain on
the posterior mean's linearization -> an epsilon-greedy perturbation of
the LQR control (the exploration uniforms are inputs) -> the Cantelli
chance constraint of the relative-degree-2 barrier that keeps theta out
of the wedge around pi / 4, as one relaxed second-order cone -> a small
SOCP, 25 cold interior-point iterations -> its control, or the clean LQR
control where the solve's primal residual misses the gate -> an Euler
step of the true pendulum (theta wrapped).  Each step also records the
previous pair's finite-difference derivative into a K-row reservoir;
after every `train_every_n_steps`-th step the GP is refit by Adam,
starting from the previous fit, and its posterior cache rebuilt.

`replay` follows a batch of the program's episodes from their recorded
states, as `unicycle.replay` does; `true_next` and `first_fit_moments`
read every episode.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from .common import (GPLearner, GPParams, Precision, chol_ladder,
                     empty_cache, empty_data, fit_steps, pad_cones, refit,
                     reservoir, solve_socp)

EIG_EPS = 2e-3   # eigenvalues in (-EIG_EPS, 0) of K_G are roundoff


def wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


def clamp_small_negative_eigs(K):
    """2 x 2 symmetric K (N, 2, 2) with eigenvalues in (-EIG_EPS, 0) set
    to zero, in closed form."""
    a, b, c = K[:, 0, 0], K[:, 0, 1], K[:, 1, 1]
    mid = 0.5 * (a + c)
    rad = torch.sqrt((0.5 * (a - c)) ** 2 + b * b)
    l1, l2 = mid - rad, mid + rad
    c1 = (l1 < 0) & (l1 > -EIG_EPS)
    c2 = (l2 < 0) & (l2 > -EIG_EPS)
    eye = torch.eye(2, dtype=K.dtype, device=K.device)
    gap = torch.where(rad > 0, l1 - l2, -torch.ones_like(rad))
    P1 = (K - l2[:, None, None] * eye) / gap[:, None, None]
    drop = (torch.where(c1, l1, torch.zeros_like(l1))[:, None, None] * P1
            + torch.where(c2, l2, torch.zeros_like(l2))[:, None, None]
            * (eye - P1))
    return torch.where((c1 & c2)[:, None, None], torch.zeros_like(K),
                       K - drop)


class Pendulum:
    """The configuration's constants, in the reference's precision."""

    def __init__(self, cfg: dict, P: Precision, device):
        self.cfg, self.P, self.dev = cfg, P, device
        self.kw = dict(dtype=P.dtype, device=device)
        self.T, self.dt, self.K = cfg["numSteps"], cfg["dt"], cfg["max_train"]
        self.learner = GPLearner(jitter=cfg["gp_jitter"],
                                 gamma_prior=tuple(cfg["gamma_prior"]))
        p = cfg["pendulum"]
        self.mass, self.grav, self.length = p["mass"], p["gravity"], \
            p["length"]
        self.factor = math.sqrt((1.0 - cfg["max_unsafe_prob"])
                                / cfg["max_unsafe_prob"])

    # ---------------------------------------------------------- dynamics

    def reservoir(self, X, U, draws, upto: int):
        """The training set after the records of steps 0..upto: kernel
        input the previous state, observation the finite-difference
        derivative."""
        return reservoir(X, U, draws, upto, self.K, self.P,
                         lambda xp, up, xn: (xn - xp) / self.dt,
                         lambda a: a)

    def step(self, x, u):
        """The true pendulum's Euler step, theta wrapped to [-pi, pi):
        xdot = f(x) + g u, the actuation a matrix product."""
        th, w = x[:, 0], x[:, 1]
        f = torch.stack([w, -(self.grav / self.length) * torch.sin(th)], -1)
        g = x.new_zeros((x.shape[0], 2, 1))
        g[:, 1, 0] = 1.0 / (self.mass * self.length)
        xn = x + (f + self.P.mm(g, u[..., None])[..., 0]) * self.dt
        return torch.stack([wrap(xn[:, 0]), xn[:, 1]], -1)

    # ------------------------------------------------------ the barrier

    def cbf(self, x):
        """h = cos(delta) - cos(theta - theta_c), its gradient and Hessian."""
        c = self.cfg["cbf"]
        d = x[:, 0] - c["theta"]
        h = math.cos(c["delta"]) - torch.cos(d)
        g = torch.stack([torch.sin(d), torch.zeros_like(d)], -1)
        H = x.new_zeros((x.shape[0], 2, 2))
        H[:, 0, 0] = torch.cos(d)
        return h, g, H

    def cbc2_terms(self, x, M, dM, Bk, D1, D2, A):
        """The relative-degree-2 chance constraint's moments under the
        posterior vec F ~ N(vec M^T, Bk kron A): mean(u) = bfe u + e and
        var(u) = u V u + bfv u + v (m = 1), by the exact Isserlis algebra
        of CBC2 = G^T (F uh) + k0 h + k1 grad_h^T f, G = grad(grad_h^T
        f)."""
        P = self.P
        mm = P.mm
        ka0, ka1 = self.cfg["k_alpha"]
        h, g1, Hh = self.cbf(x)
        mv = lambda Pm, v: mm(Pm, v[..., None])[..., 0]
        dot = lambda a, b: (a * b).sum(-1)
        mu_f = M[..., 0]
        mu_G = mv(Hh, mu_f) + mv(dM[:, :, 0, :].transpose(-1, -2), g1)
        Ag = mv(A, g1)
        s = dot(g1, Ag)
        HA = mm(Hh, A)
        HAg = mv(Hh, Ag)
        b00 = Bk[:, 0, 0]
        d1 = D1[:, :, 0, 0]
        K_G = (D2[..., 0, 0] * s[:, None, None] + d1[..., None] * HAg[:, None]
               + HAg[..., None] * d1[:, None] + b00[:, None, None]
               * mm(HA, Hh))
        K_G = clamp_small_negative_eigs(0.5 * (K_G + K_G.transpose(-1, -2)))
        Pc = D1[:, :, 0, :]
        beta = Bk[:, 0, :]
        Mt = M.transpose(-1, -2)
        trHA = torch.diagonal(HA, dim1=-2, dim2=-1).sum(-1)
        w = mv(Mt, mu_G) + mv(Pc.transpose(-1, -2), Ag) + beta * trHA[:, None]
        const = ka0 * h + ka1 * dot(g1, mu_f)
        PtHAg = mv(Pc.transpose(-1, -2), mv(HA, Ag))
        cross = (mv(Pc.transpose(-1, -2), mu_G)[..., None]
                 * mv(Mt, Ag)[:, None]
                 + beta[..., None] * mv(Mt, mv(HA.transpose(-1, -2), mu_G))
                 [:, None])
        CC = (mm(Pc.transpose(-1, -2), Pc) * dot(Ag, Ag)[:, None, None]
              + PtHAg[..., None] * beta[:, None]
              + beta[..., None] * PtHAg[:, None]
              + beta[..., None] * beta[:, None]
              * (HA * HA).sum((-2, -1))[:, None, None])
        Q = ((Bk * (dot(mu_G, mv(A, mu_G)) + (K_G * A).sum((-2, -1)))
              [:, None, None]) + mm(mm(Mt, K_G), M) + cross
             + cross.transpose(-1, -2) + CC)
        Q = 0.5 * (Q + Q.transpose(-1, -2))
        lin = 2.0 * ka1 * (beta * dot(mu_G, Ag)[:, None]
                           + mv(Mt, d1 * s[:, None] + b00[:, None] * HAg))
        c0 = ka1 ** 2 * b00 * s
        return (w[:, 1:], w[:, 0] + const, Q[:, 1:, 1:],
                2.0 * Q[:, 0, 1:] + lin[:, 1:], Q[:, 0, 0] + lin[:, 0] + c0)

    # -------------------------------------------------- secondary control

    def lqr(self, dfdx, gx, x):
        """The last gain of `horizon` Riccati steps on x+ = x + dt (f + g
        u) linearized at x, applied to x - x_goal and clipped; an episode
        whose recursion leaves the stated type's range gets u = 0."""
        c = self.cfg["lqr"]
        mm = self.P.mm
        n = x.shape[-1]
        Q = torch.tensor(c["Q"], **self.kw)
        R = torch.tensor(c["R"], **self.kw)
        xg = torch.tensor(c["x_goal"], **self.kw)
        A = torch.eye(n, **self.kw) + self.dt * dfdx
        B = self.dt * gx
        Bt, At = B.transpose(-1, -2), A.transpose(-1, -2)
        Pm = Q.expand(x.shape[0], n, n)
        big = torch.finfo(self.P.stated).max
        ok = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        for _ in range(c["horizon"]):
            BtP = mm(Bt, Pm)
            Kg = torch.linalg.solve(R + mm(BtP, B), mm(BtP, A))
            Pm = Q + mm(mm(At, Pm), A - mm(B, Kg))
            ok = ok & (Pm.abs().flatten(1).amax(-1) < big)
        u = -mm(Kg, (x - xg)[..., None])[..., 0]
        ok = ok & torch.isfinite(u).all(-1)
        u = torch.where(ok[:, None], u, torch.zeros_like(u))
        lo, hi = self.cfg["ctrl_range"]
        return torch.clamp(u, lo, hi)

    def explore(self, u, t, uni):
        """u + eps(t) uniform(ctrl_range), clipped; eps log-interpolated
        from the scheme's first value at step 0 to its last at T."""
        e0, e1 = self.cfg["egreedy_scheme"]
        eps = torch.exp(t.to(self.P.dtype) / self.T
                        * (math.log(e1) - math.log(e0)) + math.log(e0))
        lo, hi = self.cfg["ctrl_range"]
        return torch.clamp(u + eps[:, None] * (uni * (hi - lo) + lo), lo, hi)

    # --------------------------------------------------------- controller

    def control(self, x, t, uni, M, dM, Bk, D1, D2, A):
        """u (N, 1) at states x (N, 2), steps t (N,), exploration uniforms
        uni (N, 1), under the posterior moments and derivatives."""
        P, cfg = self.P, self.cfg
        N = x.shape[0]
        u_lqr = self.lqr(dM[:, :, 0, :], M[:, :, 1:], x)
        u_ref = self.explore(u_lqr, t, uni)
        bfe, e, V, bfv, v = self.cbc2_terms(x, M, dM, Bk, D1, D2, A)
        # [u, delta, y, s]: minimize y + w_s s
        m, nvar = 1, 4
        Asq = torch.cat([torch.cat([v[:, None, None], 0.5 * bfv[:, None]], 2),
                         torch.cat([0.5 * bfv[..., None], V], 2)], 1)
        Lt = chol_ladder(Asq, 1e-12).transpose(-1, -2)
        A_c = torch.cat([Lt[..., 1:], x.new_zeros((N, m + 1, 3))], -1)
        bfc = torch.cat([bfe, x.new_zeros((N, 3))], -1)
        bfc[:, m + 2] = 1.0
        Gk = torch.cat([-bfc[:, None], -self.factor * A_c], 1)
        hk = torch.cat([e[:, None], self.factor * Lt[..., 0]], 1)
        scale = torch.clamp(torch.maximum(Gk.abs().flatten(1).amax(-1),
                                          hk.abs().amax(-1)), min=1.0)
        Gk, hk = Gk / scale[:, None, None], hk / scale[:, None]
        sq_r = math.sqrt(cfg["ctrl_reg"])
        Gobj = torch.zeros((m + 2, nvar), **self.kw)
        Gobj[0, m + 1] = -1.0
        Gobj[1, 0] = -sq_r
        Gobj[m + 1, m] = -math.sqrt(cfg["clf_relax_weight"])
        hobj = torch.cat([x.new_zeros((N, 1)), -sq_r * u_ref,
                          x.new_zeros((N, 1))], 1)
        Gs = torch.zeros((1, nvar), **self.kw)
        Gs[0, m + 2] = -1.0
        Gp, hp = pad_cones([Gobj.expand(N, -1, -1), Gk, Gs.expand(N, -1, -1)],
                           [hobj, hk, x.new_zeros((N, 1))], [3, 3, 1])
        cobj = torch.zeros(nvar, **self.kw)
        cobj[m + 1] = 1.0
        cobj[m + 2] = cfg["cbc_relax_weight"]
        sol = solve_socp(cobj, Gp, hp, cfg["socp_iters"], P)
        ok = (sol.pres < P.feas_tol(cfg["feas_tol"])) & torch.isfinite(
            sol.x).all(-1)
        return torch.where(ok[:, None], sol.x[:, :m], u_lqr)


def replay(cfg, P: Precision, x0s, params0: GPParams, draws, noise, X, U,
           device):
    """Follow episodes from their recorded states.

    x0s (E, 2), params0 (E, ...), draws (T, E), noise (T, E, 1), X (E, T,
    2), U (E, T, 1): the benchmark's inputs and the program's records.
    Returns u (E, T, 1), the controls of every step."""
    pend = Pendulum(cfg, P, device)
    X, U = P.cast(X), P.cast(U)
    noise = P.cast(noise)
    p = GPParams(*(P.cast(a) for a in params0))
    E, T = X.shape[:2]
    K = pend.K
    data = empty_data(E, K, 2, 2, P.dtype, device)
    Linv, alpha = empty_cache(E, K, 2, P.dtype, device)
    fits = fit_steps(cfg)
    us = torch.zeros((E, T, 1), dtype=P.dtype, device=device)
    seg_start = 0
    for seg_end in fits + [T - 1]:
        S = seg_end + 1 - seg_start
        xs = X[:, seg_start:seg_end + 1]
        fT, dfT, Bk, D1, D2 = pend.learner.derivatives(p, data, Linv, alpha,
                                                       xs, P)
        flat = lambda a: a.reshape((E * S,) + a.shape[2:])
        A = p.A(P).repeat_interleave(S, 0)
        t = torch.arange(seg_start, seg_end + 1, device=device).repeat(E)
        uni = noise[seg_start:seg_end + 1].transpose(0, 1)
        us[:, seg_start:seg_end + 1] = pend.control(
            flat(xs), t, flat(uni), flat(fT), flat(dfT), flat(Bk),
            flat(D1), flat(D2), A).reshape(E, S, 1)
        if seg_end in fits:
            buf = pend.reservoir(X, U, draws, seg_end)
            p, data, Linv, alpha = refit(pend.learner, p, buf,
                                         cfg["training_iter"], P,
                                         (p, data, Linv, alpha))
        seg_start = seg_end + 1
    return us


def true_next(cfg, P: Precision, X, U, device):
    """x_next (E, T - 1, 2): the true pendulum's step of each recorded
    (x, u) but the last."""
    pend = Pendulum(cfg, P, device)
    X, U = P.cast(X), P.cast(U)
    E, T = X.shape[:2]
    return pend.step(X[:, :-1].reshape(-1, 2),
                     U[:, :-1].reshape(-1, 1)).reshape(E, T - 1, 2)


def first_fit_window(cfg):
    """(first, last) step whose control reads the first refit's
    posterior."""
    te = fit_steps(cfg)[0]
    return te + 1, min(2 * te, cfg["numSteps"] - 1)


def first_fit_moments(cfg, P: Precision, params0: GPParams, draws, X, U,
                      device):
    """The chance constraint's mean and variance at u = cfg["report_u"],
    (E, S) each, at the recorded states of the S steps whose control reads
    the first refit's posterior (`first_fit_window`), of every episode:
    the first refit from params0 on the reservoir rebuilt from X, U and
    draws, its posterior and derivatives at those states, and the CBC2
    moments under them.  The refit's product read directly, before the
    chained refits drift apart."""
    pend = Pendulum(cfg, P, device)
    X, U = P.cast(X), P.cast(U)
    p = GPParams(*(P.cast(a) for a in params0))
    E = X.shape[0]
    K = pend.K
    old = (p, empty_data(E, K, 2, 2, P.dtype, device)) + empty_cache(
        E, K, 2, P.dtype, device)
    t0, t1 = first_fit_window(cfg)
    buf = pend.reservoir(X, U, draws, t0 - 1)
    p, data, Linv, alpha = refit(pend.learner, p, buf, cfg["training_iter"],
                                 P, old)
    xs = X[:, t0:t1 + 1]
    S = xs.shape[1]
    fT, dfT, Bk, D1, D2 = pend.learner.derivatives(p, data, Linv, alpha, xs,
                                                   P)
    flat = lambda a: a.reshape((E * S,) + a.shape[2:])
    bfe, e, V, bfv, v = pend.cbc2_terms(
        flat(xs), flat(fT), flat(dfT), flat(Bk), flat(D1), flat(D2),
        p.A(P).repeat_interleave(S, 0))
    u = cfg["report_u"]
    mean = bfe[:, 0] * u + e
    var = V[:, 0, 0] * u * u + bfv[:, 0] * u + v
    return mean.reshape(E, S), var.reshape(E, S)

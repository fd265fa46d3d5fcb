"""Plain reference of the unicycle Monte-Carlo study: the Bayes-CBF
controller of the `Bayesian_CBF` reference (`unicycle_move_to_pose.py`,
`unicycle_learning_helps_avoid_getting_stuck`) on an Ackermann drive
whose actuation is learned online by a matrix-variate GP.

Each step of each episode: the posterior of F(x) (the prior mean
dynamics plus the learned residual, with x and y zeroed before the
kernel) -> the CLF tracking cone and one chance-constraint cone per
obstacle -> a small SOCP, 25 cold interior-point iterations -> the
control, or the reference control (0, 0) where the solve's primal
residual misses the gate -> an Euler step of the true drive.  Each step
also records the previous pair's finite-difference residual into a
K-row reservoir; after every `train_every_n_steps`-th step the GP is
refit by Adam on the reservoir and its posterior cache rebuilt.

`replay` follows a batch of the program's episodes step by step from
their own recorded states: it rebuilds each reservoir from the recorded
states, controls and the benchmark's draws, refits, and works out every
step's control again.  `true_next` gives the true next state of each
recorded (x, u), and `refits` each refit's hyperparameters, of every
episode.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from .common import (GPData, GPParams, GPLearner, Precision, chol_ladder,
                     empty_cache, empty_data, fit_steps, pad_cones, refit,
                     reservoir, solve_socp)


def wrap(a):
    return (a + math.pi) % (2 * math.pi) - math.pi


class Unicycle:
    """The configuration's constants, in the reference's precision."""

    def __init__(self, cfg: dict, P: Precision, device):
        self.cfg, self.P, self.dev = cfg, P, device
        kw = dict(dtype=P.dtype, device=device)
        self.kw = kw
        self.x0 = torch.tensor(cfg["x0"], **kw)
        self.goal = torch.tensor(cfg["x_goal"], **kw)
        self.T, self.dt = cfg["numSteps"], cfg["dt"]
        self.K = cfg["max_train"]
        self.learner = GPLearner(jitter=cfg["gp_jitter"],
                                 gamma_prior=tuple(cfg["gamma_prior"]))
        # two obstacles flanking the start-goal segment's midpoint
        s, g = self.x0[:2], self.goal[:2]
        mid = (s + g) / 2.0
        R90 = torch.tensor([[0.0, -1.0], [1.0, 0.0]], **kw)
        off = R90 @ (s - g) / 3.0
        self.radius = float(torch.linalg.vector_norm(s - g) / 4.0)
        self.centers = torch.stack([mid + off, mid - off])
        # the piecewise-linear plan in (x, y, cos th, sin th)
        T = self.T
        self.t2 = float(min(int(T * cfg["frac_time_to_reach_goal"]), T - 1))
        xd = (g - s) / torch.linalg.vector_norm(g - s)
        th0, thg = self.x0[2:], self.goal[2:]
        self.p0 = torch.cat([s, torch.cos(th0), torch.sin(th0)])
        self.cp1 = torch.cat([g, xd])
        self.cp2 = torch.cat([g, torch.cos(thg), torch.sin(thg)])
        self.rho = math.sqrt(2.0) * float(torch.special.erfinv(torch.tensor(
            1.0 - 2.0 * cfg["max_risk"], dtype=torch.float64)))

    # ---------------------------------------------------------------- plan

    def plan(self, t):
        """(goal (N, 3), goal rate (N, 3)) at steps t (N,) int."""
        look = max(int(0.1 * self.T), 1)
        ts = torch.clamp(t + look, max=self.T).to(self.P.dtype)[:, None]
        first = ts <= self.t2
        prev_t = torch.where(first, 0.0, self.t2)
        cp_t = torch.where(first, self.t2, float(self.T))
        prev = torch.where(first, self.p0, self.cp1)
        cp = torch.where(first, self.cp1, self.cp2)
        xp = (cp - prev) * (ts - prev_t) / (cp_t - prev_t) + prev
        goal = torch.cat([xp[:, :2], torch.atan2(xp[:, 3:4], xp[:, 2:3])], -1)
        xdiff = (cp - prev) / ((cp_t - prev_t) * self.dt)
        w = (xdiff[:, 2:3] - xdiff[:, 3:4]) / (xdiff[:, 2:4] ** 2).sum(
            -1, keepdim=True)
        return goal, torch.cat([xdiff[:, :2], w], -1)

    # ------------------------------------------------------ CLF and CBFs

    def clf(self, x, xg):
        """V, dV/dx, dV/dgoal of 1/2 k0 rho^2 + k1 (1 - cos a) + k2 (1 -
        cos b) in the polar coordinates of x about the goal."""
        k0, k1, k2 = self.cfg["Kp"]
        dx, dy = xg[:, 0] - x[:, 0], xg[:, 1] - x[:, 1]
        rho2 = dx * dx + dy * dy
        phi = torch.atan2(dy, dx)
        a, b = wrap(x[:, 2] - phi), wrap(xg[:, 2] - phi)
        V = 0.5 * k0 * rho2 + k1 * (1 - torch.cos(a)) + k2 * (1 - torch.cos(b))
        ang = (k1 * torch.sin(a) + k2 * torch.sin(b)) / rho2
        gx = torch.stack([-k0 * dx - ang * dy, -k0 * dy + ang * dx,
                          k1 * torch.sin(a)], -1)
        gg = torch.stack([k0 * dx + ang * dy, k0 * dy - ang * dx,
                          k2 * torch.sin(b)], -1)
        return V, gx, gg

    def cbf(self, x, k):
        """h and dh/dx of w0 (|p - c|^2 - r^2) + w1 cos(heading, p - c)."""
        w0, w1 = self.cfg["term_weights"]
        d = x[:, :2] - self.centers[k]
        nrm = torch.linalg.vector_norm(d, dim=-1)
        c, s = torch.cos(x[:, 2]), torch.sin(x[:, 2])
        ca = (c * d[:, 0] + s * d[:, 1]) / nrm
        h = w0 * ((d * d).sum(-1) - self.radius ** 2) + w1 * ca
        ud = ca / (nrm * nrm)
        g = torch.stack([2 * w0 * d[:, 0] + w1 * (c / nrm - ud * d[:, 0]),
                         2 * w0 * d[:, 1] + w1 * (s / nrm - ud * d[:, 1]),
                         w1 * (-s * d[:, 0] + c * d[:, 1]) / nrm], -1)
        return h, g

    # ---------------------------------------------------------- dynamics

    def F(self, x, L):
        """[f | g] (N, 3, 3) of the Ackermann drive of wheelbase L."""
        th = x[:, 2]
        z = torch.zeros_like(th)
        return torch.stack([torch.stack([z, torch.cos(th), z], -1),
                            torch.stack([z, torch.sin(th), z], -1),
                            torch.stack([z, z, torch.full_like(th, 1.0 / L)],
                                        -1)], -2)

    def xdot(self, x, u, L):
        uh = torch.cat([torch.ones_like(u[:, :1]), u], -1)
        return self.P.mm(self.F(x, L), uh[..., None])[..., 0]

    @staticmethod
    def shift(x):
        return torch.cat([torch.zeros_like(x[..., :2]), x[..., 2:]], -1)

    # --------------------------------------------------------- controller

    def control(self, x, t, FT, Bk, A):
        """u (N, 2) of the Bayes-CBF SOCP at states x (N, 3), steps t (N,),
        posterior moments FT (N, 3, 3), Bk (N, 3, 3), A (N, 3, 3)."""
        P, cfg = self.P, self.cfg
        N, m = x.shape[0], 2
        goal, dgoal = self.plan(t)
        V, gclf, ggoal = self.clf(x, goal)
        ws = [gclf]
        consts = [cfg["clf_gamma"] * V + (ggoal * dgoal).sum(-1)]
        for k, gam in enumerate(cfg["cbf_gammas"]):
            h, gh = self.cbf(x, k)
            ws.append(gh)
            consts.append(gam * h)
        W = torch.stack(ws, 1)                                # (N, C, 3)
        C = W.shape[1]
        sgn = torch.tensor([-1.0] + [1.0] * (C - 1), **self.kw)
        const = torch.stack(consts, 1)
        m_aff = P.mm(W, FT)                                   # (N, C, 3)
        s = (P.mm(W, A) * W).sum(-1)
        LbT = chol_ladder(Bk, 1e-10).transpose(-1, -2)
        sq = torch.sqrt(torch.clamp(s, min=0.0))
        rho = self.rho
        nvar = m + 2
        wc = [math.sqrt(w) for w in cfg["cost_weights"]]
        Gobj = torch.zeros((nvar, nvar), **self.kw)
        Gobj[0, m + 1] = -1.0
        for i in range(m):
            Gobj[1 + i, i] = -wc[i]
        Gobj[m + 1, m] = -wc[m]
        uref = torch.tensor(cfg["ctrl_ref"], **self.kw)
        hobj = torch.cat([torch.zeros(1, **self.kw), -torch.tensor(
            wc[:m], **self.kw) * uref, torch.zeros(1, **self.kw)])
        rows_G, rows_h = [Gobj.expand(N, -1, -1)], [hobj.expand(N, -1)]
        for ci in range(C):
            a_norm = torch.zeros((N, m + 1, nvar), **self.kw)
            a_norm[..., :m] = rho * sq[:, ci, None, None] * LbT[:, :, 1:]
            b_norm = rho * sq[:, ci, None] * LbT[:, :, 0]
            bfc = torch.zeros((N, nvar), **self.kw)
            bfc[:, :m] = sgn[ci] * m_aff[:, ci, 1:]
            if ci == 0:
                bfc[:, m] = 1.0
            d = sgn[ci] * (m_aff[:, ci, 0] + const[:, ci])
            rows_G.append(torch.cat([-bfc[:, None], -a_norm], 1))
            rows_h.append(torch.cat([d[:, None], b_norm], 1))
        Gp, hp = pad_cones(rows_G, rows_h, [nvar] * (C + 1))
        cobj = torch.zeros(nvar, **self.kw)
        cobj[m + 1] = 1.0
        sol = solve_socp(cobj, Gp, hp, cfg["socp_iters"], P)
        ok = (sol.pres < P.feas_tol(cfg["feas_tol"])) & torch.isfinite(
            sol.x).all(-1)
        return torch.where(ok[:, None], sol.x[:, :m], uref.expand(N, m))

    # ------------------------------------------------------------ learner

    def prior_moments(self, p: GPParams, x):
        """Moments under a learner with an empty training set."""
        P = self.P
        FT = self.F(x, self.cfg["mean_L"]) + p.mean_M.transpose(-1, -2)
        Bk = p.outputscale()[:, None, None] * p.B(P)
        return FT, Bk, p.A(P)

    def reservoir(self, X, U, draws, upto: int):
        """The training set after the records of steps 0..upto: kernel
        input the previous state with x and y zeroed, observation the
        finite-difference derivative minus the prior mean's."""
        L = self.cfg["mean_L"]

        def resid(xp, up, xn):
            E, S = xp.shape[:2]
            return (xn - xp) / self.dt - self.xdot(
                self.shift(xp).reshape(-1, 3), up.reshape(-1, 2),
                L).reshape(E, S, 3)
        return reservoir(X, U, draws, upto, self.K, self.P, resid,
                         self.shift)


def replay(cfg, P: Precision, x0s, params0: GPParams, draws, X, U,
           device):
    """Follow episodes from their recorded states.

    x0s (E, 3), params0 (E, ...), draws (T, E), X (E, T, 3), U (E, T, 2):
    the benchmark's inputs and the program's records.  Returns u (E, T,
    2), the controls of every step."""
    uni = Unicycle(cfg, P, device)
    X, U = P.cast(X), P.cast(U)
    params0 = GPParams(*(P.cast(a) for a in params0))
    E, T = X.shape[:2]
    fits = fit_steps(cfg)
    learner = uni.learner
    us = torch.zeros((E, T, 2), dtype=P.dtype, device=device)
    p, data, Linv, alpha = params0, None, None, None
    seg_start = 0
    for seg_end in fits + [T - 1]:
        ts = torch.arange(seg_start, seg_end + 1, device=device)
        n = len(ts)
        xb = X[:, seg_start:seg_end + 1].reshape(E * n, 3)
        tb = ts.repeat(E)
        rep = lambda a: a.repeat_interleave(n, 0)
        pr = GPParams(*(rep(a) for a in p))
        if data is None:
            FT, Bk, A = uni.prior_moments(pr, xb)
        else:
            fT, Bk = learner.moments(pr, GPData(*(rep(a) for a in data)),
                                     rep(Linv), rep(alpha), uni.shift(xb), P)
            FT = uni.F(xb, cfg["mean_L"]) + fT
            A = pr.A(P)
        us[:, seg_start:seg_end + 1] = uni.control(xb, tb, FT, Bk, A
                                                   ).reshape(E, n, 2)
        if seg_end in fits:
            buf = uni.reservoir(X, U, draws, seg_end)
            if data is None:
                data = empty_data(E, uni.K, 3, 3, P.dtype, device)
                Linv, alpha = empty_cache(E, uni.K, 3, P.dtype, device)
            p, data, Linv, alpha = refit(learner, p, buf,
                                         cfg["training_iter"], P,
                                         (p, data, Linv, alpha))
        seg_start = seg_end + 1
    return us


def true_next(cfg, P: Precision, X, U, device):
    """x_next (E, T - 1, 3): the true drive's Euler step of each recorded
    (x, u) but the last."""
    uni = Unicycle(cfg, P, device)
    X, U = P.cast(X), P.cast(U)
    E, T = X.shape[:2]
    return X[:, :-1] + uni.dt * uni.xdot(
        X[:, :-1].reshape(-1, 3), U[:, :-1].reshape(-1, 2),
        cfg["true_L"]).reshape(E, T - 1, 3)


def refits(cfg, P: Precision, params0: GPParams, draws, X, U, device):
    """The hyperparameters after each refit, [(lengthscale, outputscale,
    A, B)], of every episode: the reservoirs rebuilt from the recorded
    states X (E, >= last refit + 2, 3), controls U and draws (T, E), each
    refit chained from the last, the first from params0.  The controls
    do not enter, so this needs no replay of the steps."""
    uni = Unicycle(cfg, P, device)
    X, U = P.cast(X), P.cast(U)
    p = GPParams(*(P.cast(a) for a in params0))
    E = X.shape[0]
    data = empty_data(E, uni.K, 3, 3, P.dtype, device)
    Linv, alpha = empty_cache(E, uni.K, 3, P.dtype, device)
    out = []
    for te in fit_steps(cfg):
        buf = uni.reservoir(X, U, draws, te)
        p, data, Linv, alpha = refit(uni.learner, p, buf,
                                     cfg["training_iter"], P,
                                     (p, data, Linv, alpha))
        out.append((p.lengthscale(), p.outputscale(), p.A(P), p.B(P)))
    return out

"""Secondary and reference controllers, batched over episodes: a
finite-horizon LQR on a model's linearization, the epsilon-greedy
exploration wrapper (both in the pendulum loop), and the zero, one-step
greedy, polar P (the unicycle's PID baseline) and iLQR controllers.

A controller that takes a model's f_func and g_func reads them as batched
functions of x (B, n): f (B, n), g (B, n, m), each row depending on its
own state only; their Jacobians come from `torch.func.jacfwd`."""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from ..utils.func import epsilon_interp
from ..utils.linalg import cho_solve_small_unrolled, chol_small_unrolled
from .clf_cbf import cartesian2polar


def _solve_pd(A, b):
    """Solve A X = b for small positive definite A (..., n, n), b (..., n, k)
    by the unrolled Cholesky factorization."""
    return cho_solve_small_unrolled(chol_small_unrolled(A), b)


def batched_jacobian(fn, x):
    """d fn(x)[b, i] / d x[b, j], (B, n_out, n): fn maps x (B, n) row by
    row, so the Jacobian of the sum over rows holds every row's."""
    return torch.func.jacfwd(lambda z: fn(z).sum(0))(x).movedim(1, 0)


@lru_cache(maxsize=16)
def _lqr_constants(Q, R, x_goal, dtype, device):
    kw = dict(dtype=dtype, device=device)
    return torch.tensor(Q, **kw), torch.tensor(R, **kw), torch.tensor(
        x_goal, **kw)


class LQRController(NamedTuple):
    """Linearize the model at x, x+ = x + dt (f + g u) => A = I + dt df/dx,
    B = dt g; run `horizon` steps of the discrete Riccati recursion
    P <- Q + A^T P (A - B K), K = (R + B^T P B)^{-1} B^T P A from P = Q,
    and apply the last gain: u = -K (x - x_goal), clipped.  An episode
    whose u is not finite (an f32 Riccati overflow on a large learned
    Jacobian) gets u = 0.  Q, R, x_goal are nested tuples of floats."""
    Q: tuple
    R: tuple
    x_goal: tuple
    horizon: int
    dt: float
    ctrl_range: Tuple[float, float] = (-15.0, 15.0)

    def control_with_model(self, dfdx, gx, x):
        """dfdx (B, n, n): the model's drift Jacobian at x; gx (B, n, m):
        its actuation at x.  Returns u (B, m)."""
        n = x.shape[-1]
        Q, R, xg = _lqr_constants(self.Q, self.R, self.x_goal, x.dtype,
                                  x.device)
        A = torch.eye(n, dtype=x.dtype, device=x.device) + self.dt * dfdx
        B = self.dt * gx
        Bt, At = B.transpose(-1, -2), A.transpose(-1, -2)
        P = Q.expand(x.shape[0], n, n)
        for _ in range(self.horizon):
            BtP = Bt @ P
            K = _solve_pd(R + BtP @ B, BtP @ A)
            P = Q + At @ P @ (A - B @ K)
        u = -(K @ (x - xg)[..., None])[..., 0]
        u = torch.where(torch.isfinite(u).all(-1, keepdim=True), u,
                        torch.zeros_like(u))
        return torch.clamp(u, *self.ctrl_range)


class EpsilonGreedyController(NamedTuple):
    """Exploration wrapper: u + eps(t) * uniform(ctrl_range), clipped,
    with eps log-interpolated from egreedy_scheme[0] at step 0 to
    egreedy_scheme[1] at numSteps."""
    numSteps: int
    egreedy_scheme: Tuple[float, float] = (1.0, 0.01)
    ctrl_range: Tuple[float, float] = (-15.0, 15.0)

    def perturb(self, u, t: int, uniform):
        """uniform (B, m): draws on [0, 1), scaled here to ctrl_range."""
        eps = epsilon_interp(t, (0, self.egreedy_scheme[0]),
                             (self.numSteps, self.egreedy_scheme[1]))
        lo, hi = self.ctrl_range
        return torch.clamp(u + eps * (uniform * (hi - lo) + lo), lo, hi)


class ZeroController(NamedTuple):
    """u = 0."""
    u_dim: int = 1

    def control(self, x, t):
        return x.new_zeros((x.shape[0], self.u_dim))


class GreedyController(NamedTuple):
    """One-step greedy quadratic control: the u that minimizes
    (x + dt xdot(u) - x_goal)^T Q (...) + u^T R u, in closed form, clipped.
    Q, R, x_goal are nested tuples of floats."""
    Q: tuple
    R: tuple
    x_goal: tuple
    dt: float
    ctrl_range: Tuple[float, float] = (-15.0, 15.0)

    def control_with_model(self, f_func, g_func, x, t):
        Q, R, xg = _lqr_constants(self.Q, self.R, self.x_goal, x.dtype,
                                  x.device)
        xt = x + self.dt * f_func(x) - xg
        Gs = self.dt * g_func(x)
        Gt = Gs.transpose(-1, -2)
        H = Gt @ Q @ Gs + R
        rhs = -(Gt @ Q @ xt[..., None])
        eye = torch.eye(H.shape[-1], dtype=x.dtype, device=x.device)
        u = _solve_pd(H + 1e-9 * eye, rhs)[..., 0]
        return torch.clamp(u, *self.ctrl_range)


class PIDController(NamedTuple):
    """The unicycle's polar P controller: v = Kp_rho rho, reversed when the
    goal is behind (|alpha| > pi / 2), omega = Kp_alpha alpha + Kp_beta
    beta."""
    Kp_rho: float = 9.0
    Kp_alpha: float = -15.0
    Kp_beta: float = -3.0

    def control(self, x, state_goal):
        polar = cartesian2polar(x, state_goal)
        rho, alpha, beta = polar[..., 0], polar[..., 1], polar[..., 2]
        v = self.Kp_rho * rho
        w = self.Kp_alpha * alpha + self.Kp_beta * beta
        v = torch.where(torch.abs(alpha) > math.pi / 2, -v, v)
        return torch.stack([v, w], -1)


class ILQRController(NamedTuple):
    """Finite-horizon iLQR by affine backpropagation on the cost
    sum_t u^T R u + 2 z^T u + x^T Q x + 2 s^T x, s = -Q x_goal, z = 0,
    with the value function x^T P x + 2 o^T x:

        G = R + B^T P B,   K = G^-1 B^T P A,   k = G^-1 (z + B^T o),
        P' = Q + A^T P A - A^T P B K,   o' = s + A^T o - K^T (z + B^T o);

    u_t = -K_t x_t - k_t, clipped.  The first backward pass linearizes every
    step at (x0, u = 1); each of `lqr_iter` rounds rolls the nonlinear
    model forward under the current policy and linearizes again along the
    new trajectory.  Returns the first step's control.  Q, R, x_goal are
    nested tuples of floats."""
    Q: tuple
    R: tuple
    x_goal: tuple
    horizon: int
    dt: float
    lqr_iter: int = 3
    ctrl_range: Tuple[float, float] = (-15.0, 15.0)

    def control_with_model(self, f_func, g_func, x0, t):
        B, n = x0.shape
        H = self.horizon
        Q, R, xg = _lqr_constants(self.Q, self.R, self.x_goal, x0.dtype,
                                  x0.device)
        m = R.shape[0]
        s = -(Q @ xg)

        def dyn(x, u):
            xdot = f_func(x) + (g_func(x) @ u[..., None])[..., 0]
            return x + self.dt * xdot

        def backward(xs, us):
            fx, fu = xs.reshape(H * B, n), us.reshape(H * B, m)
            As = batched_jacobian(lambda z: dyn(z, fu), fx).reshape(H, B, n, n)
            Bs = (self.dt * g_func(fx)).reshape(H, B, n, m)
            P, o = Q.expand(B, n, n), s.expand(B, n)
            Ks, ks = [None] * H, [None] * H
            for i in reversed(range(H)):
                A, Bm = As[i], Bs[i]
                At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
                BtP = Bt @ P
                G = R + BtP @ Bm
                Bto = (Bt @ o[..., None])[..., 0]
                K = _solve_pd(G, BtP @ A)
                k = _solve_pd(G, Bto[..., None])[..., 0]
                P = Q + At @ P @ A - At @ P @ Bm @ K
                o = s + (At @ o[..., None])[..., 0] \
                    - (K.transpose(-1, -2) @ Bto[..., None])[..., 0]
                Ks[i], ks[i] = K, k
            return Ks, ks

        def forward(Ks, ks):
            x, xs, us = x0, [], []
            for K, k in zip(Ks, ks):
                u = torch.clamp(-(K @ x[..., None])[..., 0] - k,
                                *self.ctrl_range)
                xs.append(x)
                us.append(u)
                x = dyn(x, u)
            return torch.stack(xs), torch.stack(us)

        Ks, ks = backward(x0.expand(H, B, n),
                          x0.new_ones((H, B, m)))
        for _ in range(self.lqr_iter):
            Ks, ks = backward(*forward(Ks, ks))
        return torch.clamp(-(Ks[0] @ x0[..., None])[..., 0] - ks[0],
                           *self.ctrl_range)

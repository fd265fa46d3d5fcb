"""Reference controllers of the pendulum loop: a finite-horizon LQR on
the learned model's linearization and the epsilon-greedy exploration
wrapper, batched over episodes."""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from ..utils.func import epsilon_interp
from ..utils.linalg import cho_solve_small_unrolled, chol_small_unrolled


def _solve_pd(A, b):
    """Solve A X = b for small positive definite A (..., n, n), b (..., n, k)
    by the unrolled Cholesky factorization."""
    return cho_solve_small_unrolled(chol_small_unrolled(A), b)


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

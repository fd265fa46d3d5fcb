"""Reference planners: piecewise-linear, a cubic spline through seven
knots, and the constant goal.

The step index t is a Python int (the rollout's static loop counter), so
the checkpoint selection happens on the host and `plan(t)` / `dot_plan(t)`
cost a few tensor ops with no device synchronisation.  A tensor of step
indices (T,) gives the plan of one start at every one of them at once,
(T, 3): the post-hoc audit of a whole episode.  A piecewise-linear plan
made from a batch of starts (B, 3) gives (B, 3) at an int step.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PiecewiseLinearPlanner(NamedTuple):
    """Two-checkpoint piecewise-linear plan in (x, y, cos th, sin th)
    space with a 10%-of-horizon lookahead."""
    p0: torch.Tensor       # (..., 4) start in embedded space
    cps_t: tuple           # (2,) checkpoint steps
    cps_x: torch.Tensor    # (..., 2, 4) checkpoint embedded states
    numSteps: int
    dt: float

    @classmethod
    def create(cls, x0, x_goal, numSteps, dt, frac_time_to_reach_goal=0.7):
        if numSteps < 3:
            raise ValueError("numSteps must be >= 3")
        x0, x_goal = torch.broadcast_tensors(x0, x_goal)
        xdiff = x_goal[..., :2] - x0[..., :2]
        xdiff_n = xdiff / torch.linalg.vector_norm(xdiff, dim=-1,
                                                   keepdim=True)
        t2 = min(int(numSteps * frac_time_to_reach_goal), numSteps - 1)
        cp1 = torch.cat([x_goal[..., :2], xdiff_n], -1)
        cp2 = torch.cat([x_goal[..., :2], torch.cos(x_goal[..., 2:]),
                         torch.sin(x_goal[..., 2:])], -1)
        p0 = torch.cat([x0[..., :2], torch.cos(x0[..., 2:]),
                        torch.sin(x0[..., 2:])], -1)
        return cls(p0=p0, cps_t=(float(t2), float(numSteps)),
                   cps_x=torch.stack([cp1, cp2], -2), numSteps=numSteps,
                   dt=dt)

    def _target_step(self, t):
        look = max(int(0.1 * self.numSteps), 1)
        if isinstance(t, torch.Tensor):
            return torch.clamp(t + look, max=self.numSteps
                               ).to(self.p0.dtype)[..., None]
        return min(t + look, self.numSteps)

    def _interval(self, ts):
        if isinstance(ts, torch.Tensor):
            first = ts <= self.cps_t[0]
            f = first.to(ts.dtype)
            return ((1.0 - f) * self.cps_t[0],
                    torch.where(first, self.p0, self.cps_x[0]),
                    f * self.cps_t[0] + (1.0 - f) * self.cps_t[1],
                    torch.where(first, self.cps_x[0], self.cps_x[1]))
        first, second = self.cps_x[..., 0, :], self.cps_x[..., 1, :]
        if ts <= self.cps_t[0]:
            return 0.0, self.p0, self.cps_t[0], first
        return self.cps_t[0], first, self.cps_t[1], second

    def plan(self, t):
        ts = self._target_step(t)
        prev_t, prev_x, cp_t, cp_x = self._interval(ts)
        xp = (cp_x - prev_x) * (ts - prev_t) / (cp_t - prev_t) + prev_x
        return torch.cat([xp[..., :2], torch.atan2(xp[..., 3:4],
                                                   xp[..., 2:3])], -1)

    def dot_plan(self, t):
        """Keeps the reference's angular-rate expression, including its
        (cdot - sdot) numerator, for trajectory parity."""
        ts = self._target_step(t)
        prev_t, prev_x, cp_t, cp_x = self._interval(ts)
        xdiff = (cp_x - prev_x) / ((cp_t - prev_t) * self.dt)
        wterm = (xdiff[..., 2:3] - xdiff[..., 3:4]) / torch.sum(
            xdiff[..., 2:4] ** 2, -1, keepdim=True)
        return torch.cat([xdiff[..., :2], wterm], -1)


def _natural_cubic_coeffs(ts: np.ndarray, ys: np.ndarray):
    """The natural cubic spline through (ts, ys), in f64 on the host: its
    per-segment (b, c, d) with y = ys[i] + b u + c u^2 + d u^3 on segment
    i, u = t - ts[i]."""
    n = len(ts)
    h = np.diff(ts)
    A = np.zeros((n, n))
    rhs = np.zeros(n)
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, n - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        rhs[i] = 3 * ((ys[i + 1] - ys[i]) / h[i]
                      - (ys[i] - ys[i - 1]) / h[i - 1])
    c = np.linalg.solve(A, rhs)
    b = (np.diff(ys) / h) - h * (2 * c[:-1] + c[1:]) / 3
    d = np.diff(c) / (3 * h)
    return b, c[:-1], d


class SplinePlanner(NamedTuple):
    """A cubic-spline plan through seven knots (the reference's
    planner.py:66-110, with a natural cubic spline in place of scipy's
    splrep): hold the start, turn towards the goal, cross to it, turn to
    the goal's heading.  The spline is solved once, in f64 on the host, at
    `create`."""
    knots_t: torch.Tensor    # (K,)
    knots_y: torch.Tensor    # (K, 3) values at the knots
    coef_b: torch.Tensor     # (K-1, 3)
    coef_c: torch.Tensor
    coef_d: torch.Tensor
    numSteps: int
    dt: float

    @classmethod
    def create(cls, x0, x_goal, numSteps, dt, device="cuda",
               dtype=torch.float32):
        """The plan from x0 (3,) to x_goal (3,) over numSteps steps, its
        tensors on `device` in `dtype` (the card unless the caller asks
        for the CPU)."""
        x0 = np.asarray(torch.as_tensor(x0).cpu(), dtype=np.float64)
        x_goal = np.asarray(torch.as_tensor(x_goal).cpu(), dtype=np.float64)
        xdiff = x_goal[:2] - x0[:2]
        desired_theta = np.arctan2(xdiff[1], xdiff[0])
        t1 = max(int(numSteps * 0.1), 1)
        t2 = min(int(numSteps * 0.9), numSteps - 1)
        dx = (x_goal - x0) / (t2 - t1)
        tmid = (t1 + t2) / 2
        xmid = (x0 + x_goal) / 2
        knots = np.array([
            [0, x0[0], x0[1], x0[2]],
            [t1, x0[0], x0[1], desired_theta],
            [t1 + 1, x0[0] + dx[0], x0[1] + dx[1], desired_theta],
            [tmid, xmid[0], xmid[1], desired_theta],
            [t2 - 1, x_goal[0] - dx[0], x_goal[1] - dx[1], desired_theta],
            [t2, x_goal[0], x_goal[1], desired_theta],
            [numSteps, x_goal[0], x_goal[1], x_goal[2]]])
        ts, ys = knots[:, 0], knots[:, 1:]
        coefs = [_natural_cubic_coeffs(ts, ys[:, j]) for j in range(3)]
        kw = dict(dtype=dtype, device=device)
        b, c, d = (torch.tensor(np.stack([cf[i] for cf in coefs], -1), **kw)
                   for i in range(3))
        return cls(knots_t=torch.tensor(ts, **kw),
                   knots_y=torch.tensor(ys, **kw), coef_b=b, coef_c=c,
                   coef_d=d, numSteps=numSteps, dt=dt)

    def _segment(self, t):
        t = torch.as_tensor(t, dtype=self.knots_y.dtype,
                            device=self.knots_y.device)
        idx = torch.clamp(torch.searchsorted(self.knots_t, t, right=True) - 1,
                          0, self.knots_t.shape[0] - 2)
        return idx, (t - self.knots_t[idx])[..., None]

    def plan(self, t):
        """The plan at step t: a number (3,) or a tensor of steps
        (..., 3)."""
        i, u = self._segment(t)
        return (self.knots_y[i] + self.coef_b[i] * u
                + self.coef_c[i] * u ** 2 + self.coef_d[i] * u ** 3)

    def dot_plan(self, t):
        """The plan's derivative in the step index at t, as `plan`."""
        i, u = self._segment(t)
        return (self.coef_b[i] + 2 * self.coef_c[i] * u
                + 3 * self.coef_d[i] * u ** 2)


class NoPlanner(NamedTuple):
    """The constant goal: plan(t) = x_goal, dot_plan(t) = 0."""
    x_goal: torch.Tensor   # (3,)

    @classmethod
    def create(cls, x_goal, *args, **kwargs):
        """Any further arguments (a start, a horizon) are ignored."""
        return cls(x_goal=x_goal)

    def plan(self, t):
        return self.x_goal

    def dot_plan(self, t):
        return torch.zeros_like(self.x_goal)

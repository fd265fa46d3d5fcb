"""Reference planners: piecewise-linear, and the constant goal.

The step index t is a Python int (the rollout's static loop counter), so
the checkpoint selection happens on the host and `plan(t)` / `dot_plan(t)`
cost a few tensor ops with no device synchronisation.  A tensor of step
indices (T,) gives the plan of one start at every one of them at once,
(T, 3): the post-hoc audit of a whole episode.  A piecewise-linear plan
made from a batch of starts (B, 3) gives (B, 3) at an int step.
"""
from __future__ import annotations

from typing import NamedTuple

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

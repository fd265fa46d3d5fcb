"""The classic move-to-pose demos of the unicycle, with no learning: the
mean-CLF QP in cartesian coordinates toward a fixed goal or along a
piecewise-linear plan, in polar coordinates, and the polar P controller.

Each runs a Python step loop over a batch of starts: x0 (3,) gives one
episode, outputs (T, ...); x0 (B, 3) gives B episodes, outputs
(B, T, ...).  The CLF-QP demos solve one batch of SOCPs a step (one IPM
launch), returning (X states before each step, U, pres the solves'
relative primal residuals); the P controller returns (X, U).
"""
from __future__ import annotations

import torch

from ..control.bayes_controller import (MeanCLFControllerConfig,
                                        mean_clf_control)
from ..control.clf_cbf import CLFCartesian, CLFPolar, cartesian2polar
from ..control.planner import NoPlanner, PiecewiseLinearPlanner
from ..control.secondary import PIDController
from ..models.dynamics import CartesianDynamics, PolarDynamics
from ..sim.rollout import _stack_steps, first_episode


def _starts(x0, x_goal, device, dtype):
    """(starts (B, 3), goal (3,), whether x0 was one start)."""
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    goal = torch.as_tensor(x_goal, dtype=dtype, device=device)
    return (x0[None] if x0.ndim == 1 else x0), goal, x0.ndim == 1


def _episodes(ys, single):
    out = _stack_steps(ys)
    return first_episode(out) if single else out


def _clf_cartesian(x0, x_goal, numSteps, dt, planner_of, cbfs, cbf_gammas,
                   Kp, socp_iters, device, dtype):
    X, goal, single = _starts(x0, x_goal, device, dtype)
    dyn = CartesianDynamics()
    clf = CLFCartesian(Kp=tuple(Kp))
    planner = planner_of(X, goal)
    cfg = MeanCLFControllerConfig(cbf_gammas=tuple(cbf_gammas),
                                  socp_iters=socp_iters)
    ys = []
    for t in range(numSteps):
        u, sol = mean_clf_control(cfg, clf, cbfs, planner, dyn.f_func,
                                  dyn.g_func, X, t)
        X_next, _ = dyn.step(X, u, dt)
        ys.append((X, u, sol.pres))
        X = X_next
    return _episodes(ys, single)


def move_to_pose_clf_cartesian(x0, x_goal, numSteps=400, dt=0.01, cbfs=(),
                               cbf_gammas=(), Kp=(0.9, 1.5, 0.0),
                               socp_iters=20, device="cuda",
                               dtype=torch.float32):
    """The mean-CLF QP on the cartesian unicycle toward the fixed goal."""
    return _clf_cartesian(x0, x_goal, numSteps, dt,
                          lambda X, goal: NoPlanner.create(goal), cbfs,
                          cbf_gammas, Kp, socp_iters, device, dtype)


def track_trajectory_clf_cartesian(x0, x_goal, numSteps=400, dt=0.01,
                                   cbfs=(), cbf_gammas=(),
                                   Kp=(0.9, 1.5, 0.0), socp_iters=20,
                                   frac_time_to_reach_goal=0.7,
                                   device="cuda", dtype=torch.float32):
    """The mean-CLF QP on the cartesian unicycle along each start's
    piecewise-linear plan to the goal."""
    return _clf_cartesian(
        x0, x_goal, numSteps, dt,
        lambda X, goal: PiecewiseLinearPlanner.create(
            X, goal, numSteps, dt,
            frac_time_to_reach_goal=frac_time_to_reach_goal),
        cbfs, cbf_gammas, Kp, socp_iters, device, dtype)


def move_to_pose_clf_polar(x0, x_goal, numSteps=400, dt=0.01,
                           Kp=(0.6, 1.5, 4.0, 0.0), socp_iters=20,
                           device="cuda", dtype=torch.float32):
    """The mean-CLF QP in polar coordinates: the controller works on the
    polar state about the goal (PolarDynamics, CLFPolar) while the world
    integrates the cartesian unicycle."""
    X, goal, single = _starts(x0, x_goal, device, dtype)
    world, polar_dyn = CartesianDynamics(), PolarDynamics()
    clf = CLFPolar(Kp=tuple(Kp))
    planner = NoPlanner.create(goal)
    cfg = MeanCLFControllerConfig(socp_iters=socp_iters)
    ys = []
    for t in range(numSteps):
        u, sol = mean_clf_control(cfg, clf, (), planner, polar_dyn.f_func,
                                  polar_dyn.g_func,
                                  cartesian2polar(X, goal), t)
        X_next, _ = world.step(X, u, dt)
        ys.append((X, u, sol.pres))
        X = X_next
    return _episodes(ys, single)


def move_to_pose_pid(x0, x_goal, numSteps=400, dt=0.01, device="cuda",
                     dtype=torch.float32):
    """The polar P controller on the cartesian unicycle."""
    X, goal, single = _starts(x0, x_goal, device, dtype)
    world, pid = CartesianDynamics(), PIDController()
    ys = []
    for _ in range(numSteps):
        u = pid.control(X, goal)
        X_next, _ = world.step(X, u, dt)
        ys.append((X, u))
        X = X_next
    return _episodes(ys, single)

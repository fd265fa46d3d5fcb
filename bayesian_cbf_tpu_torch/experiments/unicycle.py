"""The unicycle / Ackermann tracking experiment: start [-3, -1, -pi/4],
goal [0, 0, pi/4], two obstacles flanking the midpoint, CLF tracking of a
piecewise-linear plan under Bayes-CBF chance constraints, with the
dynamics residual learned online.
"""
from __future__ import annotations

import math

import torch

from ..control.bayes_controller import BayesCLFControllerConfig
from ..control.clf_cbf import (CLFCartesian,
                               obstacles_at_mid_from_start_and_goal)
from ..control.planner import PiecewiseLinearPlanner
from ..models.dynamics import AckermannDrive, LearnedShiftInvariantDynamics
from ..models.mvgp import make_mvgp_rank1
from ..sim.rollout import RolloutOutputs, UnicycleSim

STATE_START = (-3.0, -1.0, -math.pi / 4)
STATE_GOAL = (0.0, 0.0, math.pi / 4)


def make_ackermann_tracking_sim(
        x0=STATE_START, x_goal=STATE_GOAL,
        dt: float = 0.001, numSteps: int = 2000,
        true_L: float = 1.0, mean_L: float = 12.0,
        kernel_diag_A=(1.0, 1.0, 1.0),
        max_risk: float = 0.01,
        enable_learning: bool = True,
        train_every_n_steps: int = 400,
        max_train: int = 200,
        training_iter: int = 100,
        term_weights=(0.7, 0.3),
        cbf_gammas=(5.0, 5.0),
        Kp=(0.9, 1.5, 0.0),
        frac_time_to_reach_goal: float = 0.95,
        socp_iters: int = 25,
        warm_start: bool = False,
        socp_iters_warm: int = 15,
        training_iter_warm: int = 0,
        first_fit_coarse_stride: int = 0,
        first_fit_refine_iter: int = 15,
        device="cuda", dtype=torch.float32) -> UnicycleSim:
    """Build the tracking experiment; obstacle centers and plan
    checkpoints live on `device` in `dtype` (by default the card, in its
    working type f32; tests pass device="cpu", dtype=torch.float64)."""
    x0 = torch.tensor(x0, dtype=dtype, device=device)
    x_goal = torch.tensor(x_goal, dtype=dtype, device=device)
    cbfs = tuple(obstacles_at_mid_from_start_and_goal(
        x0, x_goal, term_weights=term_weights))
    planner = PiecewiseLinearPlanner.create(
        x0, x_goal, numSteps, dt,
        frac_time_to_reach_goal=frac_time_to_reach_goal)
    learned = LearnedShiftInvariantDynamics(
        gp=make_mvgp_rank1(3, 2),
        mean_dynamics=AckermannDrive(L=mean_L, kernel_diag_A=kernel_diag_A),
        max_train=max_train, training_iter=training_iter,
        shift_invariant=True, train_every_n_steps=train_every_n_steps,
        enable_learning=enable_learning, dt=dt,
        training_iter_warm=training_iter_warm,
        first_fit_coarse_stride=first_fit_coarse_stride,
        first_fit_refine_iter=first_fit_refine_iter)
    controller = BayesCLFControllerConfig(
        u_dim=2, clf_gamma=10.0, cost_weights=(0.33, 0.33, 0.33),
        ctrl_ref=(0.0, 0.0), max_risk=max_risk, cbf_gammas=cbf_gammas,
        socp_iters=socp_iters, warm_start=warm_start,
        socp_iters_warm=socp_iters_warm)
    return UnicycleSim(
        true_dynamics=AckermannDrive(L=true_L),
        learned_dynamics=learned, controller=controller,
        clf=CLFCartesian(Kp=Kp), cbfs=cbfs, planner=planner,
        dt=dt, numSteps=numSteps)


def min_obstacle_clearance(sim: UnicycleSim, out: RolloutOutputs):
    """(B, n_obstacles) minimum over time of the radial clearance to each
    obstacle (negative: the trajectory entered the obstacle)."""
    ds = []
    for cbf in sim.cbfs:
        d = torch.linalg.vector_norm(out.X[..., :2] - cbf.center, dim=-1)
        ds.append(torch.amin(d - cbf.radius, -1))
    return torch.stack(ds, -1)


def goal_distance(out: RolloutOutputs, x_goal=STATE_GOAL):
    """(B,) final distance to the goal position."""
    xg = torch.tensor(x_goal[:2], dtype=out.X.dtype, device=out.X.device)
    return torch.linalg.vector_norm(out.X[:, -1, :2] - xg, dim=-1)

"""The unicycle / Ackermann tracking experiment: start [-3, -1, -pi/4],
goal [0, 0, pi/4], two obstacles flanking the midpoint, CLF tracking of a
piecewise-linear plan under Bayes-CBF chance constraints, with the
dynamics residual learned online.

The four README experiments (single episodes, dt 0.001, 2000 steps):
  * unicycle_mean_cbf_collides_obstacle -- max_risk 0.4999 (the mean
    CBF), no learning, true L 12 / prior L 1, kernel_diag_A 1e-2: collides;
  * unicycle_bayes_cbf_safe_obstacle -- the same at max_risk 0.01: safe;
  * unicycle_learning_helps_avoid_getting_stuck -- max_risk 0.01, a refit
    every 400 steps, true L 1 / prior L 12: reaches the goal;
  * unicycle_no_learning_gets_stuck -- the same with a refit every 2000
    steps, none within the horizon: stuck.
"""
from __future__ import annotations

import math

import torch

from ..control.bayes_controller import (BayesCLFControllerConfig,
                                        chance_constraint_margins)
from ..control.clf_cbf import (CLFCartesian,
                               obstacles_at_mid_from_start_and_goal)
from ..control.planner import PiecewiseLinearPlanner
from ..models.dynamics import (AckermannDrive, LearnedShiftInvariantDynamics,
                               _map)
from ..models.mvgp import make_mvgp_rank1
from ..sim.rollout import RolloutOutputs, UnicycleSim, simulate_unicycle

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


# the factory's keywords of the four README experiments
EXPERIMENTS = {
    "mean_cbf": dict(max_risk=0.4999, enable_learning=False, true_L=12.0,
                     mean_L=1.0, kernel_diag_A=(1e-2, 1e-2, 1e-2)),
    "bayes_cbf": dict(max_risk=0.01, enable_learning=False, true_L=12.0,
                      mean_L=1.0, kernel_diag_A=(1e-2, 1e-2, 1e-2)),
    "learning": dict(max_risk=0.01, enable_learning=True,
                     train_every_n_steps=400, true_L=1.0, mean_L=12.0,
                     kernel_diag_A=(1.0, 1.0, 1.0)),
    "no_learning": dict(max_risk=0.01, enable_learning=True,
                        train_every_n_steps=2000, true_L=1.0, mean_L=12.0,
                        kernel_diag_A=(1.0, 1.0, 1.0)),
}


def _run(sim: UnicycleSim, x0=STATE_START, seed: int = 0, state0=None,
         draws=None) -> RolloutOutputs:
    """One episode from x0 with a generator seeded with `seed` on the
    sim's device (or the initial learner state `state0` and the reservoir
    draws `draws` (T,))."""
    gen = torch.Generator(device=sim.planner.p0.device).manual_seed(seed)
    return simulate_unicycle(sim, x0, gen, state0, draws)


def _experiment(name, kw):
    run = {k: kw.pop(k) for k in ("seed", "state0", "draws") if k in kw}
    sim = make_ackermann_tracking_sim(**{**EXPERIMENTS[name], **kw})
    return sim, _run(sim, **run)


def unicycle_mean_cbf_collides_obstacle(**kw):
    """The mean CBF (risk 0.4999) with a wrong prior: collides.  Keywords
    override the factory's (device, dtype among them); `seed`, `state0`
    and `draws` go to the episode.  Returns (sim, outputs (T, ...))."""
    return _experiment("mean_cbf", kw)


def unicycle_bayes_cbf_safe_obstacle(**kw):
    """The Bayes CBF (risk 0.01) with the same wrong prior: stays safe.
    Keywords as `unicycle_mean_cbf_collides_obstacle`."""
    return _experiment("bayes_cbf", kw)


def unicycle_learning_helps_avoid_getting_stuck(**kw):
    """Learning on (a refit every 400 steps), true L 1 against a prior L
    12: reaches the goal.  Keywords as
    `unicycle_mean_cbf_collides_obstacle`."""
    return _experiment("learning", kw)


def unicycle_no_learning_gets_stuck(**kw):
    """A refit every 2000 steps, none within the horizon: gets stuck.
    Keywords as `unicycle_mean_cbf_collides_obstacle`."""
    return _experiment("no_learning", kw)


def min_obstacle_clearance(sim: UnicycleSim, out: RolloutOutputs):
    """Minimum over time of the radial clearance to each obstacle
    (negative: the trajectory entered the obstacle): (n_obstacles,) for
    one episode's (T, n) outputs, (B, n_obstacles) for a batch's."""
    ds = []
    for cbf in sim.cbfs:
        d = torch.linalg.vector_norm(out.X[..., :2] - cbf.center, dim=-1)
        ds.append(torch.amin(d - cbf.radius, -1))
    return torch.stack(ds, -1)


def goal_distance(out: RolloutOutputs, x_goal=STATE_GOAL):
    """Final distance to the goal position: a scalar for one episode,
    (B,) for a batch."""
    xg = torch.tensor(x_goal[:2], dtype=out.X.dtype, device=out.X.device)
    return torch.linalg.vector_norm(out.X[..., -1, :2] - xg, dim=-1)


def realized_cbc_margins(sim: UnicycleSim, out: RolloutOutputs, seed=0,
                         state0=None):
    """Post-hoc audit of one episode (T, ...): the CBC chance-constraint
    margins (T, n_cbfs) at every applied control, in one batched call
    over the T steps.  A step the solver marked feasible must satisfy
    each cone at the applied u: the cross-check of the controller's f32
    feasibility gate.  The margins are evaluated under the initial
    learner state (`state0`, episode axis 1, or a fresh one from a
    generator seeded with `seed` on the outputs' device: the state the
    episode of that seed started from), so they are exact only without
    learning, where that state is the one the controller used."""
    X, U = out.X, out.U
    T = X.shape[0]
    lrn = sim.learned_dynamics
    if state0 is None:
        gen = torch.Generator(device=X.device).manual_seed(seed)
        state0 = lrn.init_state(1, gen, X.device, X.dtype)
    state = _map(lambda a: a.expand((T,) + a.shape[1:]), state0)
    mg = chance_constraint_margins(
        sim.controller, sim.clf, sim.cbfs, sim.planner,
        lrn.moments(state, X), X, torch.arange(T, device=X.device), U)
    return mg[:, 1:]                            # the relaxed CLC row dropped

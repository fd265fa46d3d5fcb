"""The pendulum online-learning experiment, batched over episodes or as
one episode: start near theta = 7 pi / 12, an epsilon-greedy LQR
reference on the learned model, a learned relative-degree-2 CBC SOCP
keeping theta out of the wedge around pi / 4, and the dynamics (drift
and actuation) learned from scratch by a full-rank MVGP.  Also the
ground-truth CLF-CBF QP controller and its episode (start 5 pi / 12, the
true model), the data samplers of the dynamics-learning experiments and
their error measure.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from ..control.learned_socp_controller import (LearnedSOCPControllerConfig,
                                               learned_socp_control)
from ..control.pendulum_safety import EnergyCLF, RadialCBFRelDegree2
from ..control.secondary import EpsilonGreedyController, LQRController
from ..models.dynamics import (LearnedDynState, LearnedShiftInvariantDynamics,
                               PendulumDynamics, ZeroDynamics, where_tree)
from ..models.mvgp import make_mvgp
from ..sim.rollout import _stack_steps, first_episode, fit_segments
from ..solvers.socp import solve_socp

THETA0 = 7 * math.pi / 12
THETA0_GROUND_TRUTH = 5 * math.pi / 12


class PendulumOnlineSim(NamedTuple):
    true_dynamics: PendulumDynamics
    learned: LearnedShiftInvariantDynamics
    controller: LearnedSOCPControllerConfig
    cbf: RadialCBFRelDegree2
    lqr: LQRController
    egreedy: EpsilonGreedyController
    dt: float
    numSteps: int
    device: torch.device = torch.device("cuda")
    dtype: torch.dtype = torch.float32


def make_pendulum_online_sim(
        numSteps=250, dt=2e-3, max_train=40, training_iter=25,
        train_every_n_steps=10, max_unsafe_prob=0.01,
        k_alpha=(1.0, 3.0), ctrl_range=(-15.0, 15.0),
        egreedy_scheme=(1.0, 0.01), socp_iters=25,
        training_iter_warm=0, continuous_updates=False,
        first_fit_coarse_stride=0, first_fit_refine_iter=15,
        device="cuda", dtype=torch.float32) -> PendulumOnlineSim:
    """Build the experiment.  continuous_updates=True appends every
    accepted sample to the posterior the step it is recorded (pair it
    with a sparser train_every_n_steps).  The episodes run on `device` in
    `dtype`: by default the card, in its working type f32 (tests pass
    device="cpu", dtype=torch.float64)."""
    pend = PendulumDynamics()
    learned = LearnedShiftInvariantDynamics(
        gp=make_mvgp(2, 1, gamma_prior=(math.pi / 100, math.pi / 100)),
        mean_dynamics=ZeroDynamics(state_size=2, ctrl_size=1),
        max_train=max_train, training_iter=training_iter,
        shift_invariant=False, train_every_n_steps=train_every_n_steps,
        enable_learning=True, dt=dt,
        training_iter_warm=training_iter_warm,
        continuous_updates=continuous_updates,
        continuous_full_refresh=not continuous_updates,
        first_fit_coarse_stride=first_fit_coarse_stride,
        first_fit_refine_iter=first_fit_refine_iter)
    controller = LearnedSOCPControllerConfig(
        u_dim=1, x_dim=2, ctrl_reg=1.0, clf_relax_weight=100.0,
        max_unsafe_prob=max_unsafe_prob, k_alpha=k_alpha,
        socp_iters=socp_iters)
    lqr = LQRController(Q=((1.0, 0.0), (0.0, 1.0)), R=((1.0,),),
                        x_goal=(0.0, 0.0), horizon=20, dt=dt,
                        ctrl_range=ctrl_range)
    egreedy = EpsilonGreedyController(numSteps=numSteps,
                                      egreedy_scheme=egreedy_scheme,
                                      ctrl_range=ctrl_range)
    cbf = RadialCBFRelDegree2(model=pend, k_alpha=k_alpha,
                              max_unsafe_prob=max_unsafe_prob)
    return PendulumOnlineSim(true_dynamics=pend, learned=learned,
                             controller=controller, cbf=cbf, lqr=lqr,
                             egreedy=egreedy, dt=dt, numSteps=numSteps,
                             device=torch.device(device), dtype=dtype)


class PendulumOutputs(NamedTuple):
    X: torch.Tensor          # (B, T, 2) states before each step
    U: torch.Tensor          # (B, T, 1) applied controls
    Xdot: torch.Tensor       # (B, T, 2)
    info: NamedTuple         # LearnedSOCPInfo, each field (B, T, ...)


def run_pendulum_online_batch(sim: PendulumOnlineSim, x0s,
                              generator: Optional[torch.Generator] = None,
                              state0: Optional[LearnedDynState] = None,
                              draws: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None
                              ) -> PendulumOutputs:
    """Run B episodes from x0s (B, 2) (moved to sim.device in sim.dtype).

    Each step, for all episodes at once: moment derivatives of the learned
    model -> LQR reference on its linearization -> epsilon-greedy
    perturbation -> CBC2 SOCP (one IPM launch; an infeasible solve falls
    back to the clean LQR reference) -> reservoir record (with
    continuous_updates, a rank-1 cache append) -> Euler step of the true
    pendulum.  With sim.controller.closed_form False the CBC2 cones come
    from the GP expression path, each episode's (f, Fu) pair made per u
    from its learner state by `f_gp_and_fu_gp`; the LQR still reads the
    moment derivatives.  The rollout is cut at the refit steps of
    `fit_segments` (after every step t > 0 with t % train_every_n_steps
    == 0); the first
    event runs `fit_now_first`, later ones `fit_now_warm`, each for the
    episodes with a non-empty reservoir.

    generator: the source of the initial weights, the reservoir draws and
    the exploration uniforms.  state0: an initial learner state instead
    of a fresh one.  draws (T, B): reservoir draws; noise (T, B, 1): the
    exploration uniforms on [0, 1); each replaces the generator's."""
    lrn = sim.learned
    X = torch.as_tensor(x0s, dtype=sim.dtype, device=sim.device)
    B = X.shape[0]
    states = state0 if state0 is not None else lrn.init_state(
        B, generator, X.device, X.dtype)
    ys = []
    fit_event = 0
    for (s, e, do_fit) in fit_segments(sim.numSteps, lrn.train_every_n_steps,
                                       lrn.enable_learning):
        for t in range(s, e):
            mder = lrn.moment_derivatives(states, X)
            M, dM = mder[0], mder[1]
            u_lqr = sim.lqr.control_with_model(dM[:, :, 0, :], M[:, :, 1:],
                                               X)
            uni = noise[t] if noise is not None else torch.rand(
                u_lqr.shape, generator=generator, dtype=X.dtype,
                device=X.device)
            u_ref = sim.egreedy.perturb(u_lqr, t, uni)
            u, info = learned_socp_control(
                sim.controller, (sim.cbf,), mder, u_ref, X, u_fallback=u_lqr,
                pair_fn=lrn.f_gp_and_fu_gp, state=states)
            states = lrn.record(states, X, u,
                                j=None if draws is None else draws[t],
                                generator=generator)
            X_next, xdot = sim.true_dynamics.step(X, u, sim.dt)
            ys.append((X, u, xdot, info))
            X = X_next
        if do_fit:
            fit = lrn.fit_now_first if fit_event == 0 else lrn.fit_now_warm
            states = where_tree(states.count_res > 0, fit(states), states)
            fit_event += 1
    return PendulumOutputs(*_stack_steps(ys))


def run_pendulum_online_learning(sim: PendulumOnlineSim, theta0=THETA0,
                                 omega0=0.0,
                                 generator: Optional[torch.Generator] = None,
                                 state0: Optional[LearnedDynState] = None,
                                 draws: Optional[torch.Tensor] = None,
                                 noise: Optional[torch.Tensor] = None
                                 ) -> PendulumOutputs:
    """One episode from (theta0, omega0), run as
    `run_pendulum_online_batch` at B = 1: outputs (T, ...) without the
    batch axis (X, U, Xdot and the info fields).

    generator: the initial weights, the reservoir draws and the
    exploration uniforms (default: a generator seeded with 0 on
    sim.device).  state0: an initial learner state (episode axis 1).
    draws (T,): reservoir draws; noise (T, 1): exploration uniforms on
    [0, 1); each replaces the generator's."""
    if generator is None:
        generator = torch.Generator(device=sim.device).manual_seed(0)
    return first_episode(run_pendulum_online_batch(
        sim, [[theta0, omega0]], generator, state0,
        None if draws is None else draws[:, None],
        None if noise is None else noise[:, None]))


@lru_cache(maxsize=16)
def _ground_truth_constants(margin_weight, ctrl_range, dtype, device):
    """(objective vector (3,), the epigraph cone's rows G (3, 3) and h (3,),
    the box rows G (2, 3) and h (2,)) over the variables [u, slack, y]."""
    sw = math.sqrt(margin_weight)
    lo, hi = ctrl_range
    kw = dict(dtype=dtype, device=device)
    # ||[u; sw slack]|| <= y, as rows h - G x = [y; u; sw slack]
    return (torch.tensor([0.0, 0.0, 1.0], **kw),
            torch.tensor([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0],
                          [0.0, -sw, 0.0]], **kw),
            torch.zeros(3, **kw),
            torch.tensor([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], **kw),
            torch.tensor([-lo, hi], **kw))


def ground_truth_socp(x, clf, cbf2, ctrl_range=(-15.0, 15.0),
                      margin_weight=100.0):
    """The CLF-CBF QP on the true pendulum for states x (B, 2): the
    constraints A(x) u <= b(x) of `clf` (an EnergyCLF, relaxed by a slack)
    and `cbf2` (a RadialCBFRelDegree2, hard) and the box, minimizing
    ||u||^2 + w slack^2, in its norm-epigraph form over [u, slack, y]:
    ||[u; sqrt(w) slack]|| <= y, minimize y (the same minimizer; the
    epigraph of the squared cost puts a variable of ~5e3 beside data of
    ~1-20, on which the f32 IPM stalls from the cold start).  Returns
    (cobj (3,), G (B, 7, 3), h (B, 7), dims (3, 1, 1, 1, 1))."""
    batch = x.shape[0]
    cobj, G_obj, h_obj, G_box, h_box = _ground_truth_constants(
        margin_weight, tuple(ctrl_range), x.dtype, x.device)
    zero, one = x.new_zeros((batch, 1)), x.new_ones((batch, 1))
    G = torch.cat([G_obj.expand(batch, -1, -1),
                   torch.cat([clf.A(x), -one, zero], -1)[:, None],
                   torch.cat([cbf2.A(x), zero, zero], -1)[:, None],
                   G_box.expand(batch, -1, -1)], 1)
    h = torch.cat([h_obj.expand(batch, -1), clf.b(x)[:, None],
                   cbf2.b(x)[:, None], h_box.expand(batch, -1)], 1)
    return cobj, G, h, (3, 1, 1, 1, 1)


def ground_truth_cbf_clf_control(x, clf, cbf2, ctrl_range=(-15.0, 15.0),
                                 margin_weight=100.0, socp_iters=25):
    """`ground_truth_socp` solved cold at `socp_iters` iterations.  A solve
    whose relative primal residual is not below 5e-3 (f32; 1e-6 in f64) or
    whose solution is not finite gives u = 0, else u is the solution's,
    clipped to ctrl_range.  Returns (u (B, 1), the SOCPSolution)."""
    sol = solve_socp(*ground_truth_socp(x, clf, cbf2, ctrl_range,
                                        margin_weight), iters=socp_iters)
    feas_tol = 1e-6 if x.dtype == torch.float64 else 5e-3
    ok = (sol.pres < feas_tol) & torch.isfinite(sol.x).all(-1)
    u = torch.where(ok[:, None], torch.clamp(sol.x[:, :1], *ctrl_range),
                    torch.zeros_like(sol.x[:, :1]))
    return u, sol


def run_pendulum_ground_truth_batch(x0s, numSteps=400, dt=0.01,
                                    device="cuda", dtype=torch.float32):
    """B episodes of the true pendulum under `ground_truth_cbf_clf_control`
    (EnergyCLF and RadialCBFRelDegree2 at their defaults) from x0s (B, 2),
    moved to `device` in `dtype`: (X (B, T, 2) states before each step,
    U (B, T, 1), pres (B, T) the solves' relative primal residuals).  One
    IPM launch a step."""
    pend = PendulumDynamics()
    clf, cbf2 = EnergyCLF(model=pend), RadialCBFRelDegree2(model=pend)
    X = torch.as_tensor(x0s, dtype=dtype, device=device)
    ys = []
    for _ in range(numSteps):
        u, sol = ground_truth_cbf_clf_control(X, clf, cbf2)
        X_next, _ = pend.step(X, u, dt)
        ys.append((X, u, sol.pres))
        X = X_next
    return _stack_steps(ys)


def run_pendulum_ground_truth(numSteps=400, dt=0.01,
                              theta0=THETA0_GROUND_TRUTH, omega0=0.0,
                              device="cuda", dtype=torch.float32):
    """One episode from (theta0, omega0), run as
    `run_pendulum_ground_truth_batch` at B = 1: (X (T, 2), U (T, 1),
    pres (T,))."""
    return first_episode(run_pendulum_ground_truth_batch(
        [[theta0, omega0]], numSteps, dt, device, dtype))


def pendulum_damage_fraction(theta):
    """Fraction of steps (over the last axis) with 0 < theta < pi / 4,
    theta wrapped to [-pi, pi): the damage indicator of the reference
    experiment."""
    th = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
    return ((th > 0) & (th < math.pi / 4)).to(theta.dtype).mean(-1)


def pendulum_wedge_fraction(theta, theta_c=math.pi / 4,
                            delta_col=math.pi / 8):
    """Fraction of steps (over the last axis) inside the radial CBF's
    unsafe wedge |theta - theta_c| < delta_col (h < 0): a stricter
    diagnostic than the damage indicator, since the chance constraint
    admits a per-step violation probability."""
    d = torch.abs(theta - theta_c)
    d = torch.minimum(d, 2 * math.pi - d)
    return (d < delta_col).to(theta.dtype).mean(-1)


def _uniform(u, lo, hi):
    """Uniforms on [0, 1) mapped to [lo, hi) as jax.random.uniform maps
    its own."""
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def sample_iid_pendulum(generator: Optional[torch.Generator], n: int,
                        x_range=(-math.pi, math.pi), w_range=(-3.0, 3.0),
                        u_range=(-10.0, 10.0), dtype=torch.float32,
                        uniforms: Optional[torch.Tensor] = None):
    """n i.i.d. samples (X (n, 2), U (n, 1), Xdot (n, 2)) of the true
    pendulum: theta, omega and u uniform on their ranges, xdot exact.
    uniforms (n, 3) on [0, 1) (theta, omega, u) replace the generator's
    draws, on the generator's device."""
    if uniforms is None:
        uniforms = torch.rand((n, 3), generator=generator, dtype=dtype,
                              device=generator.device)
    X = torch.stack([_uniform(uniforms[:, 0], *x_range),
                     _uniform(uniforms[:, 1], *w_range)], -1)
    U = _uniform(uniforms[:, 2:], *u_range)
    pend = PendulumDynamics()
    return X, U, pend.f_func(X) + (pend.g_func(X) @ U[..., None])[..., 0]


def sample_pendulum_data(numSteps=2000, dt=1e-2, theta0=3 * math.pi / 4,
                         omega0=-0.01,
                         generator: Optional[torch.Generator] = None,
                         uniforms: Optional[torch.Tensor] = None,
                         device="cuda", dtype=torch.float32):
    """A rollout of the random controller u = m g sin(theta) (0.6 + 0.8 v),
    v uniform on [0, 1), collected as (X (T, 2), U (T, 1), Xdot (T, 2))
    with the exact xdot.  uniforms (T,) replace the generator's v
    (default: a generator seeded with 0 on `device`)."""
    if uniforms is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        uniforms = torch.rand((numSteps,), generator=generator, dtype=dtype,
                              device=device)
    pend = PendulumDynamics()
    x = torch.tensor([[theta0, omega0]], dtype=uniforms.dtype,
                     device=uniforms.device)
    X, U, Xdot = [], [], []
    for t in range(numSteps):
        u = (pend.mass * pend.gravity * torch.sin(x[:, :1])
             * (uniforms[t] * 0.8 + 0.6))
        x_next, xdot = pend.step(x, u, dt)
        X.append(x)
        U.append(u)
        Xdot.append(xdot)
        x = x_next
    return torch.cat(X), torch.cat(U), torch.cat(Xdot)


def variance_weighted_error(mean_flat, var_flat, true_flat):
    """sqrt of the mean over a test batch of (F_hat - F)^T Var^{-1}
    (F_hat - F): mean_flat (N D,), var_flat (N, D, D), true_flat (N, D)."""
    N, D = true_flat.shape
    diff = mean_flat.reshape(N, D) - true_flat
    L = torch.linalg.cholesky(var_flat)
    sols = torch.cholesky_solve(diff[..., None], L)[..., 0]
    return torch.sqrt(torch.sum(diff * sols) / N)

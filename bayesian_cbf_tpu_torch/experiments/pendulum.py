"""The pendulum online-learning experiment, batched over episodes or as
one episode: start near theta = 7 pi / 12, an epsilon-greedy LQR
reference on the learned model, a learned relative-degree-2 CBC SOCP
keeping theta out of the wedge around pi / 4, and the dynamics (drift
and actuation) learned from scratch by a full-rank MVGP.  Also the
ground-truth CLF-CBF QP controller and its episode (start 5 pi / 12, the
true model), the data samplers of the dynamics-learning experiments,
their error measure, and the MVGP-against-CoGP experiments: the learning
error (`learn_dynamics_matrix_vector`) and the posterior's speed
(`speed_test_matrix_vector`).
"""
from __future__ import annotations

import math
import time
from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..control.learned_socp_controller import (LearnedSOCPControllerConfig,
                                               learned_socp_control)
from ..control.pendulum_safety import EnergyCLF, RadialCBFRelDegree2
from ..control.secondary import EpsilonGreedyController, LQRController
from ..models.dynamics import (LearnedDynState, LearnedShiftInvariantDynamics,
                               PendulumDynamics, ZeroDynamics, where_tree)
from ..models.cogp import CoGP, make_cogp, make_cogp_diag
from ..models.mvgp import make_mvgp, make_mvgp_diag
from ..observability import tracing
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
    # (state, u) -> one episode's CLC GP for the controller's stability
    # cone (`learned_socp_controller.norm2_clc`); None: no such cone
    clc_fn: Optional[Callable] = None


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
    moment derivatives.  With sim.clc_fn the SOCP gains the stability
    cone of that CLC (its terms through the GP expression path).  The
    rollout is cut at the refit steps of
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
            with tracing.span("step"):
                mder = lrn.moment_derivatives(states, X)
                M, dM = mder[0], mder[1]
                u_lqr = sim.lqr.control_with_model(dM[:, :, 0, :],
                                                   M[:, :, 1:], X)
                uni = noise[t] if noise is not None else torch.rand(
                    u_lqr.shape, generator=generator, dtype=X.dtype,
                    device=X.device)
                u_ref = sim.egreedy.perturb(u_lqr, t, uni)
                u, info = learned_socp_control(
                    sim.controller, (sim.cbf,), mder, u_ref, X,
                    u_fallback=u_lqr, pair_fn=lrn.f_gp_and_fu_gp,
                    state=states, clc_fn=sim.clc_fn)
                states = lrn.record(states, X, u,
                                    j=None if draws is None else draws[t],
                                    generator=generator)
                X_next, xdot = sim.true_dynamics.step(X, u, sim.dt)
            ys.append((X, u, xdot, info))
            X = X_next
        if do_fit:
            fit = lrn.fit_now_first if fit_event == 0 else lrn.fit_now_warm
            with tracing.span("fit"):
                states = where_tree(states.count_res > 0, fit(states),
                                    states)
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
    (F_hat - F): mean_flat (N D,), var_flat (N, D, D), true_flat (N, D).
    NaN when a block of var_flat is not positive definite."""
    N, D = true_flat.shape
    diff = mean_flat.reshape(N, D) - true_flat
    L, info = torch.linalg.cholesky_ex(var_flat)
    sols = torch.cholesky_solve(diff[..., None], L)[..., 0]
    errs = torch.where(info == 0, torch.sum(diff * sols, -1), math.nan)
    return torch.sqrt(torch.sum(errs) / N)


_REGRESSORS = {
    "matrix": make_mvgp,
    "matrixdiag": make_mvgp_diag,
    "vector": make_cogp,
    "vectordiag": make_cogp_diag,
}


def _block_diag_vars(var_full, b):
    """The (b, D, D) diagonal blocks of a (b D, b D) covariance, each plus
    1e-9 I (f64) or 1e-4 I (f32: posteriors there have a ~1e-6 noise floor
    on near-collapsed variances) for the weighted-error solve."""
    D = var_full.shape[0] // b
    blocks = torch.diagonal(var_full.reshape(b, D, b, D), dim1=0, dim2=2)
    jit = 1e-9 if var_full.dtype == torch.float64 else 1e-4
    return blocks.permute(2, 0, 1) + jit * torch.eye(
        D, dtype=var_full.dtype, device=var_full.device)


def _init_params(gp, name, params0, seed, device, dtype):
    """Initial hyperparameters of regressor `name`: params0[name] when
    given, else drawn from a generator seeded with `seed`; an MVGP's with
    the episode axis of 1."""
    if params0 is not None:
        return params0[name]
    generator = torch.Generator(device=device).manual_seed(seed)
    if isinstance(gp, CoGP):
        return gp.init_params(generator, device, dtype)
    return gp.init_params(1, generator, device, dtype)


def _fit(gp, X, U, Xdot, params, training_iter):
    """(fitted params, training data) of one regressor on rows (k, ...);
    an MVGP's carry the episode axis of 1."""
    if isinstance(gp, CoGP):
        data = gp.make_data(X, U, Xdot)
    else:
        data = gp.make_data(X[None], U[None], Xdot[None])
    return gp.fit(params, data, training_iter=training_iter), data


def _posterior(gp, params, data, Xtest, cache=None):
    """predict_fullmat at Xtest (b, n) without the episode axis, after
    `refresh_cache` unless a cache is given."""
    with torch.no_grad():
        if cache is None:
            cache = gp.refresh_cache(params, data)
        if isinstance(gp, CoGP):
            return gp.predict_fullmat(params, data, cache, Xtest)
        mean, var = gp.predict_fullmat(params, data, cache, Xtest[None])
        return mean[0], var[0]


def _pendulum_F_true(Xtest):
    """vec F^T of the true pendulum at states (b, 2): (b, (1+m) n)."""
    return PendulumDynamics().F_func(Xtest).transpose(-1, -2).reshape(
        Xtest.shape[0], -1)


def _synchronize(t):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def speed_test_matrix_vector(max_train_list=(256, 320, 384, 512),
                             grid=21, ntimes=10, repeat=5,
                             training_iter=50, seed=0,
                             regressors=("matrix", "vector",
                                         "matrixdiag", "vectordiag"),
                             data=None, Xtest=None, Ftrue=None,
                             x_dim=2, u_dim=1, params0=None,
                             params_out=None, device="cuda",
                             dtype=torch.float32):
    """The posterior's speed, MVGP O(k^3) against CoGP O(k^3 n^3): for
    each regressor and training size k, fit on k random rows, then time
    `refresh_cache` + `predict_fullmat` over a test set, `repeat` times
    `ntimes` calls, each repeat ending with a device synchronize.
    Returns {regressor: {k: {"elapsed": best s per call, "error": the
    variance-weighted error of the last call}}}.

    By default on a 2048-step pendulum trajectory (`sample_pendulum_data`
    from a generator seeded with `seed`) over a grid x grid lattice of the
    visited (theta, omega); pass data=(X, U, Xdot), Xtest, Ftrue (b,
    (1+m) n), x_dim and u_dim for another system (moved to `device` in
    `dtype`).  Rows come from np.random.default_rng(seed), one
    permutation per (regressor, k) in that order.  Each fit starts from
    hyperparameters drawn from a generator seeded with `seed`, or from
    params0[regressor]; a dict passed as params_out receives
    params_out[regressor][k] = (initial, fitted)."""
    if data is None:
        X, U, Xdot = sample_pendulum_data(
            numSteps=2048, generator=torch.Generator(device=device)
            .manual_seed(seed), device=device, dtype=dtype)
        Xn = X.cpu().numpy()
        th = np.linspace(Xn[:, 0].min(), Xn[:, 0].max(), grid)
        om = np.linspace(Xn[:, 1].min(), Xn[:, 1].max(), grid)
        Xtest = torch.tensor(np.stack(np.meshgrid(th, om), -1).reshape(-1, 2),
                             dtype=dtype, device=device)
        Ftrue = _pendulum_F_true(Xtest)
    else:
        X, U, Xdot, Xtest, Ftrue = (
            torch.as_tensor(a).to(device=device, dtype=dtype)
            for a in (*data, Xtest, Ftrue))
    rng = np.random.default_rng(seed)
    results = {}
    for name in regressors:
        gp = _REGRESSORS[name](x_dim, u_dim)
        results[name] = {}
        for k in max_train_list:
            idx = torch.as_tensor(rng.permutation(X.shape[0])[:k],
                                  device=X.device)
            params = _init_params(gp, name, params0, seed, device, dtype)
            fitted, d = _fit(gp, X[idx], U[idx], Xdot[idx], params,
                             training_iter)
            if params_out is not None:
                params_out.setdefault(name, {})[k] = (params, fitted)
            mean, var = _posterior(gp, fitted, d, Xtest)     # warm-up
            _synchronize(var)
            times = []
            for _ in range(repeat):
                t0 = time.perf_counter()
                for _ in range(ntimes):
                    mean, var = _posterior(gp, fitted, d, Xtest)
                _synchronize(var)
                times.append((time.perf_counter() - t0) / ntimes)
            err = float(variance_weighted_error(
                mean, _block_diag_vars(var, Xtest.shape[0]), Ftrue))
            results[name][k] = {"elapsed": min(times), "error": err}
    return results


def learn_dynamics_matrix_vector(max_train=120, training_iter=50,
                                 n_test=128, tries=8, seed=0, data=None,
                                 params0=None, params_out=None,
                                 device="cuda", dtype=torch.float32):
    """The MVGP-against-CoGP learning error: fit "matrix" and "vector" on
    `max_train` random rows of a 2048-step pendulum trajectory and return
    {"matrix": err, "vector": err}, each the median variance-weighted
    error over `tries` random subsets of `n_test` held-out rows.

    The rows come from np.random.default_rng(seed); the trajectory from
    `sample_pendulum_data` with a generator seeded with `seed`, or
    data=(X, U, Xdot) (moved to `device` in `dtype`).  Each fit starts
    from hyperparameters drawn from a generator seeded with `seed`, or
    from params0[regressor]; a dict passed as params_out receives each
    regressor's (initial, fitted) hyperparameters."""
    if data is None:
        X, U, Xdot = sample_pendulum_data(
            numSteps=2048, generator=torch.Generator(device=device)
            .manual_seed(seed), device=device, dtype=dtype)
    else:
        X, U, Xdot = (torch.as_tensor(a).to(device=device, dtype=dtype)
                      for a in data)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(X.shape[0])
    tr = torch.as_tensor(idx[:max_train], device=X.device)
    te = idx[max_train:]
    out = {}
    for name in ("matrix", "vector"):
        gp = _REGRESSORS[name](2, 1)
        params = _init_params(gp, name, params0, seed, device, dtype)
        fitted, d = _fit(gp, X[tr], U[tr], Xdot[tr], params, training_iter)
        if params_out is not None:
            params_out[name] = (params, fitted)
        with torch.no_grad():
            cache = gp.refresh_cache(fitted, d)
        errs = []
        for _ in range(tries):
            sub = torch.as_tensor(rng.choice(te, size=n_test, replace=False),
                                  device=X.device)
            Xtest = X[sub]
            mean, var = _posterior(gp, fitted, d, Xtest, cache)
            errs.append(float(variance_weighted_error(
                mean, _block_diag_vars(var, n_test), _pendulum_F_true(Xtest))))
        out[name] = float(np.median(errs))
    return out

"""Parity of the port's deterministic controllers against the JAX package
on the CPU, f64: the pendulum's ground-truth CLF-CBF QP and its episode,
the mean-CLF QP and the four move-to-pose demos, the unicycle's cartesian
and polar models, CLFPolar, NoPlanner, polar2cartesian, the zero, greedy,
P, LQR and iLQR controllers, the plain IPM at the kernel's new shapes,
and the obstacle-free unicycle loop.

Inputs come from numpy seeds.  Where an episode's distance from JAX
exceeds roundoff (every IPM solve ends at a floor that roundoff moves),
the bar is twice JAX's own sensitivity: the largest change of JAX's
episode when one start coordinate moves by +-1e-14, measured on the
same configuration (quoted beside each bar).
"""
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_cbf_tpu.control import bayes_controller as jbc
from bayesian_cbf_tpu.control import clf_cbf as jcc
from bayesian_cbf_tpu.control import pendulum_safety as jps
from bayesian_cbf_tpu.control import planner as jpl
from bayesian_cbf_tpu.control import secondary as jsec
from bayesian_cbf_tpu.experiments import move_to_pose as jm
from bayesian_cbf_tpu.experiments import pendulum as jp
from bayesian_cbf_tpu.experiments import unicycle as ju
from bayesian_cbf_tpu.models import dynamics as jd
from bayesian_cbf_tpu.sim.rollout import simulate_unicycle as j_simulate
from bayesian_cbf_tpu.solvers.socp import _solve_padded_plain
from bayesian_cbf_tpu_torch import interop
from bayesian_cbf_tpu_torch.control import bayes_controller as tbc
from bayesian_cbf_tpu_torch.control import clf_cbf as tcc
from bayesian_cbf_tpu_torch.control import pendulum_safety as tps
from bayesian_cbf_tpu_torch.control import planner as tpl
from bayesian_cbf_tpu_torch.control import secondary as tsec
from bayesian_cbf_tpu_torch.experiments import move_to_pose as tm
from bayesian_cbf_tpu_torch.experiments import pendulum as tp
from bayesian_cbf_tpu_torch.experiments import unicycle as tu
from bayesian_cbf_tpu_torch.models import dynamics as td
from bayesian_cbf_tpu_torch.ops import ipm_kernel as ik
from bayesian_cbf_tpu_torch.sim.rollout import simulate_unicycle

F64 = torch.float64
STARTS = np.array([(-2.0, -0.5, -math.pi / 4), (-1.5, 0.8, 0.3)])
GOAL = (0.0, 0.0, math.pi / 4)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _pendulum_states(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.9, 2.4, n), rng.uniform(-1.5, 1.5, n)],
                    -1)


def _per_state(fn, xs):
    """JAX's fn of each row of xs, one row at a time, as one program."""
    return jax.jit(lambda a: jax.lax.map(fn, a))(jnp.asarray(xs))


def _unicycle_states(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-3.0, -0.5, n), rng.uniform(-2.0, 2.0, n),
                     rng.uniform(-math.pi, math.pi, n)], -1)


# ---- the IPM at the kernel's new instantiations (plain version) ---------

@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("nx,dims", [(3, (3, 1, 1, 1, 1)),
                                     (4, (4, 1, 1, 1, 1, 1)), (4, (4, 4))])
def test_ipm_plain_new_shapes_match_jax_plain(nx, dims, iters):
    """(3, 5, 3), (4, 6, 4), (4, 2, 4): f64, the same operations, so the
    iterates agree to roundoff amplified by the steps taken: 1e-7 (at 3
    iterations slacks of ~2e-2 sit up to 2.3e-8 apart)."""
    rng = np.random.default_rng(len(dims))
    B, C, d = 6, len(dims), max(dims)
    c = rng.normal(size=(B, nx))
    G, h = np.zeros((B, C, d, nx)), np.zeros((B, C, d))
    for ci, dd in enumerate(dims):
        G[:, ci, 0] = -rng.normal(size=(B, nx)) * 0.2
        G[:, ci, 1:dd] = -rng.normal(size=(B, dd - 1, nx)) * 0.5
        h[:, ci, 0] = 1.5 + rng.uniform(size=B)
        h[:, ci, 1:dd] = rng.normal(size=(B, dd - 1)) * 0.1
    e = np.zeros((B, C, d))
    e[..., 0] = 1.0
    args = (c, G, h, np.zeros((B, nx)), e, e)
    got = ik.ipm_plain(*(_t(a) for a in args), iters, 1e-10)
    want = jax.vmap(lambda *a: _solve_padded_plain(*a, iters, 1e-10))(
        *(jnp.asarray(a) for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-7,
                                   atol=1e-7)


# ---- the pendulum's ground-truth QP -------------------------------------

def test_ground_truth_control_matches_jax_per_state():
    """u, the solution x and its primal residual of a batch of states
    against JAX's unbatched solve of each: both solve to the f64 floor
    (pres ~1e-12), where the 25th iterate of two roundings agrees to
    1e-7 in x and u."""
    xs = _pendulum_states(8, 0)
    pend = jd.PendulumDynamics()
    jclf, jcbf = jps.EnergyCLF(model=pend), jps.RadialCBFRelDegree2(model=pend)
    tpend = td.PendulumDynamics()
    u, sol = tp.ground_truth_cbf_clf_control(
        _t(xs), tps.EnergyCLF(model=tpend),
        tps.RadialCBFRelDegree2(model=tpend))
    assert u.shape == (8, 1) and sol.x.shape == (8, 3)
    ju_, jsol = _per_state(lambda x: jp.ground_truth_cbf_clf_control(
        x, jclf, jcbf), xs)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju_), atol=1e-7)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=1e-7,
                               atol=1e-7)
    assert float(sol.pres.max()) < 1e-9 and float(jsol.pres.max()) < 1e-9


def test_ground_truth_episode_matches_jax():
    """The JAX test's episode (150 steps, dt 0.01, theta0 5 pi / 12) and
    its assertions: finite, pres < 1e-4, no damage.  JAX's own episode
    moves by up to 3.92e-3 in X and 0.483 in U (the control chatters at
    the IPM's floor near the wedge edge) when theta0 or omega0 moves by
    +-1e-14, and by 6.1e-9 in X over the first 5 states and 6.1e-7 in U
    over the first 4 controls: the bars are twice that."""
    X, U, pres = (np.asarray(a) for a in jp.run_pendulum_ground_truth(
        numSteps=150))
    Xt, Ut, pt = tp.run_pendulum_ground_truth(numSteps=150, device="cpu",
                                              dtype=F64)
    assert Xt.shape == (150, 2) and Ut.shape == (150, 1)
    assert pt.shape == (150,)
    assert bool(torch.isfinite(Xt).all())
    assert float(pt.max()) < 1e-4
    assert float(tp.pendulum_damage_fraction(Xt[:, 0])) == 0.0
    np.testing.assert_allclose(Xt[:5].numpy(), X[:5], atol=1.2e-8)
    np.testing.assert_allclose(Ut[:4].numpy(), U[:4], atol=1.2e-6)
    np.testing.assert_allclose(Xt.numpy(), X, atol=7.8e-3)
    np.testing.assert_allclose(Ut.numpy(), U, atol=0.97)


def test_ground_truth_batch_rows_are_episodes():
    """Two starts in one batch: each row is that start's episode."""
    x0s = [[5 * math.pi / 12, 0.0], [1.2, -0.3]]
    X, U, pres = tp.run_pendulum_ground_truth_batch(x0s, numSteps=6,
                                                    device="cpu", dtype=F64)
    assert X.shape == (2, 6, 2) and U.shape == (2, 6, 1)
    for b, (th, om) in enumerate(x0s):
        one = tp.run_pendulum_ground_truth(6, theta0=th, omega0=om,
                                           device="cpu", dtype=F64)
        for got, want in zip((X, U, pres), one):
            np.testing.assert_allclose(got[b].numpy(), want.numpy(),
                                       rtol=1e-9, atol=1e-11)


# ---- models, CLFPolar, planners, coordinates ----------------------------

def test_unicycle_models_match_jax():
    xs = _unicycle_states(5, 1)
    us = np.random.default_rng(2).normal(size=(5, 2))
    polar = np.abs(xs) + 0.2
    for jmod, tmod, pts in ((jd.CartesianDynamics(), td.CartesianDynamics(),
                             xs), (jd.PolarDynamics(), td.PolarDynamics(),
                                   polar)):
        names = ("f_func", "g_func") + (
            ("F_func",) if hasattr(jmod, "F_func") else ())
        for name in names:
            got = getattr(tmod, name)(_t(pts)).numpy()
            want = np.stack([np.asarray(getattr(jmod, name)(jnp.asarray(p)))
                             for p in pts])
            np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)
        xn, xdot = tmod.step(_t(pts), _t(us), 0.01)
        for b in range(5):
            jxn, jxdot = jmod.step(jnp.asarray(pts[b]), jnp.asarray(us[b]),
                                   0.01)
            np.testing.assert_allclose(xn[b].numpy(), np.asarray(jxn),
                                       rtol=1e-13)
            np.testing.assert_allclose(xdot[b].numpy(), np.asarray(jxdot),
                                       rtol=1e-13, atol=1e-15)


def test_clf_polar_and_polar2cartesian_match_jax():
    rng = np.random.default_rng(3)
    polar = np.stack([rng.uniform(0.1, 3.0, 6), rng.uniform(-3, 3, 6),
                      rng.uniform(-3, 3, 6)], -1)
    goal = np.array([0.3, -0.2, 0.7])
    Kp = (0.6, 1.5, 4.0, 0.7)
    jclf, tclf = jcc.CLFPolar(Kp=Kp), tcc.CLFPolar(Kp=Kp)
    V, gx, gg = tclf.value_and_grads(_t(polar), _t(goal))
    for b, p in enumerate(polar):
        args = (jnp.asarray(p), jnp.asarray(goal))
        np.testing.assert_allclose(float(V[b]), float(jclf.clf(*args)),
                                   rtol=1e-13)
        np.testing.assert_allclose(gx[b].numpy(),
                                   np.asarray(jclf.grad_clf(*args)),
                                   rtol=1e-12, atol=1e-14)
        assert not np.any(gg[b].numpy())
        np.testing.assert_allclose(
            tcc.polar2cartesian(_t(p), _t(goal)).numpy(),
            np.asarray(jcc.polar2cartesian(*args)), rtol=1e-13, atol=1e-15)
    # the round trip through cartesian2polar
    cart = tcc.polar2cartesian(_t(polar), _t(goal))
    back = tcc.polar2cartesian(tcc.cartesian2polar(cart, _t(goal)), _t(goal))
    np.testing.assert_allclose(back.numpy(), cart.numpy(), atol=1e-12)


def test_no_planner_matches_jax():
    goal = np.array([1.0, -2.0, 0.5])
    jpln, tpln = jpl.NoPlanner.create(jnp.asarray(goal), 7, dt=0.1), \
        tpl.NoPlanner.create(_t(goal), 7, dt=0.1)
    for t in (0, 3):
        np.testing.assert_array_equal(tpln.plan(t).numpy(),
                                      np.asarray(jpln.plan(t)))
        np.testing.assert_array_equal(tpln.dot_plan(t).numpy(),
                                      np.asarray(jpln.dot_plan(t)))


@pytest.mark.parametrize("t", [0, 40, 95])
def test_batched_piecewise_plan_matches_each_start(t):
    """A plan made from a batch of starts gives each start's plan."""
    goal = _t(GOAL)
    both = tpl.PiecewiseLinearPlanner.create(_t(STARTS), goal, 100, 0.02)
    for b, x0 in enumerate(STARTS):
        one = jpl.PiecewiseLinearPlanner.create(jnp.asarray(x0),
                                                jnp.asarray(GOAL), 100, 0.02)
        np.testing.assert_allclose(both.plan(t)[b].numpy(),
                                   np.asarray(one.plan(t)), rtol=1e-14)
        np.testing.assert_allclose(both.dot_plan(t)[b].numpy(),
                                   np.asarray(one.dot_plan(t)), rtol=1e-14)


# ---- the mean-CLF QP and the move-to-pose demos -------------------------

@pytest.mark.parametrize("case", ["cartesian", "track_obstacles", "polar"])
def test_mean_clf_control_matches_jax_per_state(case):
    """u, x and pres of a batch of states against JAX's solve of each:
    the fixed goal, the plan with two obstacle CBFs (8 cones: the CPU's
    plain version; no kernel instance), and the polar model."""
    xs = _unicycle_states(6, 4)
    jcfg = jbc.MeanCLFControllerConfig(socp_iters=20)
    tcfg = tbc.MeanCLFControllerConfig(socp_iters=20)
    if case == "polar":
        jdyn, tdyn = jd.PolarDynamics(), td.PolarDynamics()
        jclf, tclf = jcc.CLFPolar(), tcc.CLFPolar()
        jpln = jpl.NoPlanner.create(jnp.asarray(GOAL))
        tpln = tpl.NoPlanner.create(_t(GOAL))
        states = np.stack([np.asarray(jcc.cartesian2polar(
            jnp.asarray(x), jnp.asarray(GOAL))) for x in xs])
        jcbfs = tcbfs = ()
    else:
        jdyn, tdyn = jd.CartesianDynamics(), td.CartesianDynamics()
        jclf, tclf = jcc.CLFCartesian(), tcc.CLFCartesian()
        states = xs
        if case == "cartesian":
            jpln = jpl.NoPlanner.create(jnp.asarray(GOAL))
            tpln = tpl.NoPlanner.create(_t(GOAL))
            jcbfs = tcbfs = ()
        else:
            x0 = STARTS[0]
            jpln = jpl.PiecewiseLinearPlanner.create(
                jnp.asarray(x0), jnp.asarray(GOAL), 100, 0.02)
            tpln = tpl.PiecewiseLinearPlanner.create(_t(x0), _t(GOAL), 100,
                                                     0.02)
            jcbfs = jcc.obstacles_at_mid_from_start_and_goal(
                jnp.asarray(x0), jnp.asarray(GOAL))
            tcbfs = tcc.obstacles_at_mid_from_start_and_goal(_t(x0),
                                                             _t(GOAL))
            jcfg = jcfg._replace(cbf_gammas=(5.0, 5.0))
            tcfg = tcfg._replace(cbf_gammas=(5.0, 5.0))
    u, sol = tbc.mean_clf_control(tcfg, tclf, tcbfs, tpln, tdyn.f_func,
                                  tdyn.g_func, _t(states), 10)
    assert sol.s.shape[1] == 6 + len(tcbfs)
    ju_, jsol = _per_state(lambda x: jbc.mean_clf_control(
        jcfg, jclf, jcbfs, jpln, jdyn.f_func, jdyn.g_func, x, 10), states)
    # the 20th iterate of two roundings at the f64 floor
    np.testing.assert_allclose(u.numpy(), np.asarray(ju_), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sol.x.numpy(), np.asarray(jsol.x), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sol.pres.numpy(), np.asarray(jsol.pres),
                               atol=1e-8)


# demo: (size, twice JAX's largest change over the two starts at that size
# when one start coordinate moves by +-1e-14: X, U)
DEMOS = {
    "move_to_pose_clf_cartesian": (dict(numSteps=30, dt=0.02),
                                   2.4e-6, 1.1e-4),  # 1.18e-6, 5.50e-5
    "track_trajectory_clf_cartesian": (dict(numSteps=30, dt=0.02),
                                       1.6e-5, 7.8e-4),  # 7.72e-6, 3.86e-4
    "move_to_pose_clf_polar": (dict(numSteps=20, dt=0.01),
                               1.3e-6, 7.1e-5),  # 6.10e-7, 3.53e-5
    "move_to_pose_pid": (dict(numSteps=500, dt=0.01),
                         2.1e-14, 3e-13),  # 1.02e-14, 1.47e-13
}


@pytest.mark.parametrize("name", list(DEMOS))
def test_move_to_pose_demo_matches_jax(name):
    """Two starts in one batch against JAX's episode from each; one start
    alone gives the episode's shapes without the batch axis."""
    size, x_bar, u_bar = DEMOS[name]
    out = getattr(tm, name)(STARTS, GOAL, **size, device="cpu", dtype=F64)
    T = size["numSteps"]
    assert out[0].shape == (2, T, 3) and out[1].shape == (2, T, 2)
    assert all(bool(torch.isfinite(a).all()) for a in out)
    for b, x0 in enumerate(STARTS):
        want = getattr(jm, name)(tuple(x0), GOAL, **size)
        np.testing.assert_allclose(out[0][b].numpy(), np.asarray(want[0]),
                                   atol=x_bar)
        np.testing.assert_allclose(out[1][b].numpy(), np.asarray(want[1]),
                                   atol=u_bar)
    one = getattr(tm, name)(STARTS[1], GOAL, numSteps=3, dt=size["dt"],
                            device="cpu", dtype=F64)
    assert one[0].shape == (3, 3) and one[1].shape == (3, 2)


def test_pid_demo_meets_the_jax_test():
    """move_to_pose_pid at the JAX test's size: within 0.3 of the goal."""
    X, _ = tm.move_to_pose_pid(STARTS[0], GOAL, numSteps=500, dt=0.01,
                               device="cpu", dtype=F64)
    assert float(torch.linalg.vector_norm(X[-1, :2] - _t(GOAL[:2]))) < 0.3


# ---- the secondary controllers ------------------------------------------

def _pendulum_fg():
    jpend, tpend = jd.PendulumDynamics(), td.PendulumDynamics()
    return jpend, tpend


def test_zero_and_pid_controllers_match_jax():
    xs = _unicycle_states(5, 5)
    z = tsec.ZeroController(u_dim=2).control(_t(xs), 0)
    assert z.shape == (5, 2) and not z.any()
    u = tsec.PIDController().control(_t(xs), _t(GOAL))
    np.testing.assert_allclose(u.numpy(), np.asarray(_per_state(
        lambda x: jsec.PIDController().control(x, jnp.asarray(GOAL)), xs)),
        rtol=1e-13, atol=1e-14)


def test_greedy_controller_matches_jax():
    jpend, tpend = _pendulum_fg()
    xs = _pendulum_states(5, 6)
    jg = jsec.GreedyController(Q=jnp.eye(2), R=jnp.eye(1) * 0.5,
                               x_goal=jnp.zeros(2), dt=0.01)
    tg = tsec.GreedyController(Q=((1.0, 0.0), (0.0, 1.0)), R=((0.5,),),
                               x_goal=(0.0, 0.0), dt=0.01)
    u = tg.control_with_model(tpend.f_func, tpend.g_func, _t(xs), 0)
    assert u.shape == (5, 1)
    np.testing.assert_allclose(u.numpy(), np.asarray(_per_state(
        lambda x: jg.control_with_model(jpend.f_func, jpend.g_func, x, 0),
        xs)), rtol=1e-12)


def test_ilqr_controller_matches_jax():
    """A 15-step horizon with two refinement rounds, on the pendulum and
    the cartesian unicycle (whose g depends on the state)."""
    rng = np.random.default_rng(8)
    cases = (
        (jd.PendulumDynamics(), td.PendulumDynamics(), _pendulum_states(3, 9),
         np.eye(2), np.eye(1) * 0.1, np.zeros(2)),
        (jd.CartesianDynamics(), td.CartesianDynamics(),
         _unicycle_states(3, 10), np.diag([1.0, 1.0, 0.1]), np.eye(2) * 0.2,
         rng.normal(size=3)))
    for jmod, tmod, xs, Q, R, xg in cases:
        kw = dict(horizon=15, dt=0.02, lqr_iter=2, ctrl_range=(-20.0, 20.0))
        jc = jsec.ILQRController(Q=jnp.asarray(Q), R=jnp.asarray(R),
                                 x_goal=jnp.asarray(xg), **kw)
        tc = tsec.ILQRController(Q=tuple(map(tuple, Q)),
                                 R=tuple(map(tuple, R)), x_goal=tuple(xg),
                                 **kw)
        u = tc.control_with_model(tmod.f_func, tmod.g_func, _t(xs), 0)
        assert u.shape == (3, R.shape[0])
        np.testing.assert_allclose(u.numpy(), np.asarray(_per_state(
            lambda x: jc.control_with_model(jmod.f_func, jmod.g_func, x, 0),
            xs)), rtol=1e-9, atol=1e-11)


# ---- the obstacle-free main path ----------------------------------------

NO_OBSTACLES = dict(numSteps=30, dt=0.01, max_train=8, training_iter=2,
                    train_every_n_steps=10, socp_iters=10)


def _key_chain_draws(lrn, key, steps):
    """The reservoir draws of `record`'s key chain from `key`."""
    cr, draws = 0, []
    for t in range(steps):
        key, kslot = jax.random.split(key)
        j = int(jax.random.randint(kslot, (), 0, max(cr + 1, 1)))
        draws.append(j)
        cr += int(t > 0 and (cr < lrn.max_train or j < lrn.max_train))
    return draws


def test_obstacle_free_main_path_matches_jax():
    """The JAX test's obstacle-free configuration (`sim._replace(cbfs=())`:
    objective and CLC cones only, the kernel's (4, 2, 4)) from JAX's
    initial parameters and reservoir draws, with that test's assertions
    (finite, feasible fraction > 0.9).  Bars: tests/test_torch_e2e.py's
    (2e-3 in X, 1e-2 relative in U, the reference's roundoff
    sensitivity)."""
    jsim = ju.make_ackermann_tracking_sim(**NO_OBSTACLES)._replace(cbfs=())
    jout = j_simulate(jsim, ju.STATE_START)
    lrn = jsim.learned_dynamics
    st = lrn.init_state(jax.random.PRNGKey(0), dtype=jnp.float64)
    params = {f: np.asarray(getattr(st.params, f))[None]
              for f in st.params._fields}
    draws = _key_chain_draws(lrn, st.key, NO_OBSTACLES["numSteps"])
    sim = tu.make_ackermann_tracking_sim(**NO_OBSTACLES, device="cpu",
                                         dtype=F64)._replace(cbfs=())
    state0 = interop.learned_state_from_numpy(sim.learned_dynamics, params,
                                              "cpu", F64)
    out = simulate_unicycle(sim, tu.STATE_START, state0=state0,
                            draws=torch.tensor(draws))
    assert out.info.cbc_means.shape == (30, 0)
    assert bool(torch.isfinite(out.X).all() and torch.isfinite(out.U).all())
    assert float(out.info.feasible.to(F64).mean()) > 0.9
    Xw, Uw = np.asarray(jout.X), np.asarray(jout.U)
    np.testing.assert_allclose(out.X.numpy(), Xw, atol=2e-3)
    u_rel = (np.abs(out.U.numpy() - Uw).max(-1)
             / (1.0 + np.abs(Uw).max(-1)))
    assert float(u_rel.max()) < 1e-2
    np.testing.assert_array_equal(out.info.feasible.numpy(),
                                  np.asarray(jout.info.feasible))


def test_obstacle_free_warm_start_state_has_two_cones():
    """With warm starts the step-0 solve and the carried (x, S, Z) have
    the objective and CLC cones: (B, 2, 4)."""
    sim = tu.make_ackermann_tracking_sim(**NO_OBSTACLES, warm_start=True,
                                         device="cpu",
                                         dtype=F64)._replace(cbfs=())
    x0s = _t([tu.STATE_START, tu.STATE_START])
    gen = torch.Generator().manual_seed(0)
    _, _, warm = sim.init_state(x0s, gen)
    assert warm[0].shape == (2, 4) and warm[1].shape == (2, 2, 4)
    assert bool(torch.isfinite(warm[1]).all())
    out = simulate_unicycle(sim._replace(numSteps=5), tu.STATE_START)
    assert bool(torch.isfinite(out.X).all())


# ---- entry-point defaults -----------------------------------------------

@pytest.mark.parametrize("fn", [
    tp.run_pendulum_ground_truth, tp.run_pendulum_ground_truth_batch,
    tm.move_to_pose_clf_cartesian, tm.track_trajectory_clf_cartesian,
    tm.move_to_pose_clf_polar, tm.move_to_pose_pid])
def test_entry_points_default_to_the_card_in_f32(fn):
    params = inspect.signature(fn).parameters
    assert params["device"].default == "cuda"
    assert params["dtype"].default is torch.float32
